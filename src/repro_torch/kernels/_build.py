"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -shared``)
under the build directory, ``build/kernels/`` at the repository root
unless ``set_build_dir`` moved it (the serving stack's compilation cache
does, ``serving/vision/compilecache.py``).  The file name carries a hash
of the source and the flags, so an edited source never loads a stale
library and a directory can be shared by processes and restarts.  Builds
happen at first use, never at import: importing the kernel modules needs
neither ``nvcc`` nor a card.  ``build()`` starts one ``nvcc`` per missing
library, all at once, and keeps each compiler's ``-Xptxas -v`` report
(registers, shared memory, spills).

``counters()`` counts what ``build()`` found for this process: a library
already in the directory is a hit, an nvcc run a miss, and the seconds
the misses' compilers ran.

Every exported C function launches on the stream it is handed and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("matmul", "fuse1d", "fused")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

PTR = ctypes.c_void_p
INT = ctypes.c_int
# The kernels index with 32-bit ints; every tensor they touch stays below.
MAX_NUMEL = 1 << 30

_lock = threading.RLock()      # library() holds it while build() runs
_libs: Dict[str, ctypes.CDLL] = {}
_dir = BUILD_DIR
_counters: Dict[str, float] = {"requests": 0, "hits": 0, "misses": 0,
                               "compile_s": 0.0}


@dataclasses.dataclass
class BuildInfo:
    name: str
    path: Path
    seconds: float          # wall time of this process's nvcc (0 if cached)
    ptxas: str              # the compiler's -Xptxas -v report ("" if cached)


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from src/repro_torch/kernels/csrc")
    return found


def build_dir() -> Path:
    """Where ``build()`` puts and looks for the libraries."""
    with _lock:
        return _dir


def set_build_dir(path) -> Path:
    """Build and load the libraries in ``path`` (created if missing) from
    now on.  Raises ``RuntimeError`` once this process has loaded a
    library from another directory: a loaded library stays loaded, so a
    later move could not take effect for it."""
    global _dir
    new = Path(path).expanduser().resolve()
    with _lock:
        stale = sorted(n for n, lib in _libs.items()
                       if Path(lib._name).parent != new)
        if stale:
            raise RuntimeError(
                f"kernel build directory: {stale} already loaded from "
                f"{_dir}; it cannot move to {new} in this process")
        new.mkdir(parents=True, exist_ok=True)
        _dir = new
    return new


def counters() -> Dict[str, float]:
    """This process's build counters: ``requests`` (libraries asked of
    ``build()``), ``hits`` (found built), ``misses`` (nvcc runs) and
    ``compile_s`` (their wall seconds)."""
    with _lock:
        return dict(_counters)


def _target(name: str, where: Path) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return where / f"{name}-{digest[:16]}.so"


def _count(**add) -> None:
    with _lock:
        for key, n in add.items():
            _counters[key] += n


def build(names: Sequence[str] = SOURCES) -> Dict[str, BuildInfo]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    per source, all started together.  Raises with the compiler's output
    when any of them fails."""
    where = build_dir()
    where.mkdir(parents=True, exist_ok=True)
    infos: Dict[str, BuildInfo] = {}
    procs = {}
    for name in names:
        out = _target(name, where)
        _count(requests=1)
        if out.exists():
            _count(hits=1)
            infos[name] = BuildInfo(name, out, 0.0, "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        _count(misses=1, compile_s=seconds)
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        infos[name] = BuildInfo(name, out, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return infos


def library(name: str, signatures: Dict[str, Iterable]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built at first use), with
    ``argtypes``/``restype`` declared for every function in ``signatures``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name].path))
            for fn, args in signatures.items():
                getattr(lib, fn).argtypes = list(args)
                getattr(lib, fn).restype = INT
            _libs[name] = lib
    return lib


def launch(what: str, fn, device: torch.device, *args) -> None:
    """Call C entry point ``fn(*args, stream)`` on ``device`` with PyTorch's
    current stream there, and raise if it reported a CUDA error."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_size(what: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.numel() > MAX_NUMEL:
            raise ValueError(f"{what}: {tuple(t.shape)} exceeds the kernels' "
                             f"{MAX_NUMEL} elements (32-bit indexing)")


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (``torch.distributed.tensor``; none can
    exist before that module is imported, so this imports nothing)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def check_inputs(what: str, *tensors: torch.Tensor,
                 dtypes: Sequence[torch.dtype] = (torch.float32,)
                 ) -> torch.device:
    """The checks every wrapper makes before it dispatches: one dtype for
    all tensors, among the kernel's ``dtypes`` (float32 for every kernel;
    float32 or bfloat16 for the 1-D ``fuse1d`` forms), contiguous, within
    ``MAX_NUMEL``, all on one CPU or CUDA device, and, on CUDA, none
    requiring grad while grad mode is on (a kernel writes a fresh tensor
    autograd cannot see into, so every gradient above it would be lost).
    A DTensor is refused: a kernel runs on one rank's local shard, which
    the caller hands it (``ops.fuse_conv1d_temporal`` through
    ``local_map``).  Returns that device."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"{what}: a DTensor reached the kernel's wrapper; "
                        f"pass each rank's local shard")
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {dev}")
    if dev.type == "cuda" and torch.is_grad_enabled() and any(
            t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward pass; "
                           f"its input requires grad while grad mode is on")
    dtype = tensors[0].dtype
    for t in tensors:
        if t.dtype not in dtypes or t.dtype != dtype:
            names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            got = ", ".join(str(u.dtype).replace("torch.", "")
                            for u in tensors)
            raise ValueError(f"{what}: needs {names}, all tensors of one "
                             f"dtype; got {got}")
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: needs contiguous tensors")
    check_size(what, *tensors)
    return dev
