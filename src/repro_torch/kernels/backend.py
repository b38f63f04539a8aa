"""Execution-backend selection for the port's vision/serving stack.

Three keys, threaded through ``repro_torch.vision.zoo.apply_network`` as a
frozen ``Backend`` so one flag flips a whole network between paths:

  * ``torch``        — plain PyTorch ops (``repro_torch.core.fuseconv``);
                       the oracle for the others.
  * ``cuda``         — the hand-written CUDA kernels
                       (``repro_torch.kernels``), with the fused FuSeConv
                       kernel on for non-SE FuSe blocks.
  * ``cuda_nofused`` — the same kernels with fusion off: the decomposed
                       banks + BN + act + pointwise, for differential
                       testing and bisection.

Every kernel wrapper dispatches on the device of the tensor it is given: on
a CPU tensor it runs its plain PyTorch version, on a CUDA tensor it launches
the kernel.  So ``cuda`` on CPU inputs exercises the kernel path's layout
plumbing (padding, transposes, fusion) with plain arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Union


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str                 # "torch" | "cuda"
    fused: bool = True        # cuda only: use the fused FuSeConv kernel

    def __post_init__(self):
        if self.name not in ("torch", "cuda"):
            raise ValueError(f"unknown backend name {self.name!r}")

    @property
    def use_kernels(self) -> bool:
        return self.name == "cuda"

    @property
    def key(self) -> str:
        """Stable string form (cache keys, CLI round-trips)."""
        if self.name == "cuda":
            return "cuda" if self.fused else "cuda_nofused"
        return "torch"


TORCH = Backend("torch")
CUDA = Backend("cuda")
CUDA_NOFUSED = Backend("cuda", fused=False)

_BY_KEY = {"torch": TORCH, "cuda": CUDA, "cuda_nofused": CUDA_NOFUSED}

BACKEND_KEYS = tuple(_BY_KEY)


def resolve_backend(spec: Union[str, Backend, None]) -> Backend:
    """Accepts a Backend, one of BACKEND_KEYS, or None (-> plain torch)."""
    if spec is None:
        return TORCH
    if isinstance(spec, Backend):
        return spec
    try:
        return _BY_KEY[spec]
    except KeyError:
        raise ValueError(
            f"unknown backend {spec!r}; expected one of {BACKEND_KEYS}")
