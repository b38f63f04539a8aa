"""Process-environment setup for the port's serving entry points.

Port of ``repro.launch.env``.  This module imports neither torch nor
anything of the serving stack, so a ``__main__`` can call
:func:`configure` first and a spawned child inherits what it exported.
It exports three things:

* ``virtual_devices > 0`` sets ``REPRO_TORCH_VIRTUAL_DEVICES``, which
  ``launch.mesh.make_data_mesh`` reads: that many logical devices, mapped
  round-robin onto the physical ones (``cpu`` on the CPU, the cards on
  CUDA), each with a CUDA stream of its own.  It is the counterpart of
  the reference's ``--xla_force_host_platform_device_count`` in
  ``XLA_FLAGS`` (``merged_xla_flags``), which only virtualises a CPU; here
  the variable applies on either device, and a mesh asks for it
  explicitly (with the variable unset, a mesh of N needs N physical
  devices).
* ``compilation_cache_dir`` exports ``REPRO_TORCH_KERNEL_CACHE_DIR``, the
  directory the kernel libraries are built in and loaded from
  (``serving/vision/compilecache.py``).  nvcc has no persistence floors,
  so the reference's ``JAX_PERSISTENT_CACHE_*`` settings have no
  counterpart.
* the multi-process trio (``coordinator_address`` / ``num_processes`` /
  ``process_id``) exports the variables ``launch.distributed`` resolves,
  under the reference's names, so one set of shell exports drives both
  launchers and a spawned worker joins the same mesh.

The reference's TPU step markers (``LIBTPU_INIT_ARGS``) and its TF log
level have no counterpart: nothing here reads them.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

ENV_VIRTUAL_DEVICES = "REPRO_TORCH_VIRTUAL_DEVICES"
ENV_CACHE_DIR = "REPRO_TORCH_KERNEL_CACHE_DIR"
ENV_COORDINATOR = "JAX_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"


def configure(virtual_devices: int = 0, *,
              compilation_cache_dir: Optional[str] = None,
              coordinator_address: Optional[str] = None,
              num_processes: Optional[int] = None,
              process_id: Optional[int] = None,
              env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Prepare the process environment for a serving entry point.

    ``virtual_devices > 0`` asks for that many logical devices (see the
    module docstring); ``compilation_cache_dir`` exports the kernel build
    directory; the topology trio exports what ``launch.distributed``
    resolves.  ``env`` defaults to ``os.environ`` (tests pass a dict to
    check without mutating the process).  Returns a copy of the mapping
    that was changed."""
    if env is None:
        env = os.environ  # type: ignore[assignment]
    if coordinator_address:
        env[ENV_COORDINATOR] = coordinator_address
    if num_processes is not None:
        env[ENV_NUM_PROCESSES] = str(num_processes)
    if process_id is not None:
        env[ENV_PROCESS_ID] = str(process_id)
    if virtual_devices > 0:
        env[ENV_VIRTUAL_DEVICES] = str(virtual_devices)
    if compilation_cache_dir:
        env[ENV_CACHE_DIR] = compilation_cache_dir
    return dict(env)
