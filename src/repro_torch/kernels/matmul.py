"""The pointwise matmul kernel: ``y = a @ b`` in fp32.

Port of ``repro.kernels.matmul.matmul``.  ``matmul`` launches the CUDA
SGEMM of ``csrc/matmul.cu`` for CUDA tensors and runs ``matmul_plain``
(the port of ``repro.kernels.ref.matmul_ref``) for CPU tensors.
``matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_SIGNATURES = {"repro_matmul_f32": (_build.PTR,) * 3 + (_build.INT,) * 3
               + (_build.PTR,)}


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: fp32 product."""
    return (a.float() @ b.float()).to(a.dtype)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y = a @ b.  a: (M, K), b: (K, N), float32, contiguous, one device."""
    dev = _build.check_inputs("matmul", a, b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if dev.type == "cpu":
        return matmul_plain(a, b)
    m, k = a.shape
    n = b.shape[1]
    y = torch.empty((m, n), device=dev, dtype=torch.float32)
    if y.numel() == 0:
        return y
    _build.check_size("matmul", y)
    lib = _build.library("matmul", _SIGNATURES)
    _build.launch("matmul", lib.repro_matmul_f32, dev, a.data_ptr(),
                  b.data_ptr(), y.data_ptr(), m, n, k)
    matmul.launches += 1
    return y


matmul.launches = 0
