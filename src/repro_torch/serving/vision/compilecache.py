"""The kernel build cache and its process-wide counters.

Port of ``repro.serving.vision.compilecache``.  What a serving process
compiles before it is servable is, here, the hand-written CUDA kernels:
one ``nvcc`` run per source (``kernels/_build.py``), each library named
by a hash of its source and flags.  Pointing the build at one directory
that outlives the process makes a restart load the libraries instead of
compiling them, as the reference's persistent XLA cache does for its
executables.  This module is the one place that moves the directory and
reads what the build did:

* :func:`enable_compilation_cache` resolves the directory (explicit
  argument > ``REPRO_TORCH_KERNEL_CACHE_DIR``), creates it and points the
  kernel build there.  Without either, the default ``build/kernels``
  stays.
* :func:`persistent_cache_counters` reads the build's counters under the
  reference's keys: ``requests`` (libraries asked for), ``hits`` (found
  built), ``misses`` (an nvcc run: a miss IS a compile), and
  ``compile_s``, the seconds those compilers ran.  The reference's
  ``time_saved_s`` and ``retrieval_s`` have no counterpart here and are
  left out.

Counters are monotonic for the life of the process, so callers that want
per-phase numbers snapshot before and after and diff
(:func:`counters_delta`).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from repro_torch.kernels import _build

ENV_CACHE_DIR = "REPRO_TORCH_KERNEL_CACHE_DIR"


def persistent_cache_counters() -> Dict[str, float]:
    """Snapshot of this process's kernel build counters."""
    return _build.counters()


def counters_delta(before: Dict[str, float],
                   after: Optional[Dict[str, float]] = None
                   ) -> Dict[str, float]:
    """``after - before`` per counter (``after`` defaults to now)."""
    if after is None:
        after = persistent_cache_counters()
    return {k: after.get(k, 0) - before.get(k, 0) for k in after}


def enable_compilation_cache(cache_dir: Optional[str] = None
                             ) -> Optional[str]:
    """Build and load the kernel libraries in ``cache_dir`` (or
    ``$REPRO_TORCH_KERNEL_CACHE_DIR``); returns the resolved directory,
    created if missing, or None when neither is given (the default
    ``build/kernels`` stays).

    Must run before the process loads its first kernel library: once one
    is loaded from another directory, ``_build.set_build_dir`` raises.
    Re-enabling with the same directory is a no-op."""
    resolved = cache_dir or os.environ.get(ENV_CACHE_DIR) or None
    if not resolved:
        return None
    return str(_build.set_build_dir(resolved))
