"""The pointwise matmul kernel: ``y = a @ b`` in fp32.

Port of ``repro.kernels.matmul.matmul``.  ``matmul`` launches the CUDA
SGEMM of ``csrc/matmul.cu`` for CUDA tensors, with the tiling that
``matmul_tiling`` fits to the shape, and runs ``matmul_plain`` (the port of
``repro.kernels.ref.matmul_ref``) for CPU tensors.  ``matmul.launches``
counts kernel launches.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused import SMS, _vec, smem_optin

_SIGNATURES = {"repro_matmul_f32": (_build.PTR,) * 3 + (_build.INT,) * 10
               + (_build.PTR,)}

MAX_THREADS = 256
MAX_STAGES = 8
MAX_SPLIT = 8          # blocks of one cluster (the portable cluster size)


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: fp32 product."""
    return (a.float() @ b.float()).to(a.dtype)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return getattr(torch.cuda.get_device_properties(index),
                   "multi_processor_count", SMS)


def _column_tile(n: int, cap: int) -> int:
    """The fewest column tiles of at most ``cap`` columns (a multiple of
    4) that leave at most an eighth of the grid's columns idle; the least
    idle where none does."""
    best = None
    for nt in range(-(-n // cap), n + 1):
        bn = -(-(-(-n // nt)) // 4) * 4
        idle = nt * bn - n
        if 8 * idle <= nt * bn:
            return bn
        if best is None or idle * best[1] < best[0] * nt * bn:
            best = (idle, nt * bn, bn)
        if bn == 4:
            break
    return best[2]


def matmul_smem_bytes(bm: int, bn: int, bk: int, stages: int,
                      ks: int) -> int:
    """Dynamic shared memory of ``csrc/matmul.cu::sgemm_kernel`` at this
    tiling (the layout ``repro_matmul_f32`` computes): a ring of stages,
    each a bm x (bk + 4) slice of a and a bk x bn slice of b; with a K
    split, the block's bm x bn partial tile reuses it."""
    ring = stages * (bm * (bk + 4) + bk * bn)
    return 4 * max(ring, bm * bn if ks > 1 else 0)


def _threads_ok(threads: int) -> bool:
    """At least two warps, at most 256 threads, and at most a fifth of the
    last warp's lanes idle across the block."""
    return 64 <= threads <= MAX_THREADS and 5 * threads >= 4 * 32 * -(
        -threads // 32)


@functools.lru_cache(maxsize=None)
def matmul_tiling(m: int, n: int, k: int, vec: int, sms: int, smem: int
                  ) -> Tuple[int, int, int, int, int, int]:
    """(bm, bn, bk, tm, stages, ks) for ``csrc/matmul.cu::sgemm_kernel``
    within ``smem`` bytes of shared memory, on a device with ``sms`` SMs.

    A block's (bm / tm) x (bn / 4) threads each keep a tm x 4 register
    tile.  bn is fitted to N: the fewest column tiles of at most 128
    columns (64 where N > 512; then 64 and 40) with at most an eighth of
    them idle.  A block has 8 rows of threads (16 where bn <= 24, 32 where
    bn <= 16); tm = 8 where K > 16 and that still gives two blocks per SM,
    else 4.  K steps are 32 deep where K >= 120, else 16.

    Narrow K (bk = 16) is bound by device memory: the first tiling with
    two blocks per SM is taken, halving the rows of threads where that
    keeps the block whole (``_threads_ok``), then narrowing bn.  Wide K
    (bk = 32) splits K over ks = 2, 4 or 8 blocks of a cluster where the
    tiles leave SMs idle, the least that gives 1.4 blocks per SM, and the
    first tiling with a block per SM is taken.  Failing that, the largest
    block among the tilings with a block per SM (rows and columns stepping
    down further for the smallest products), else the one with most
    blocks.  The ring holds every K step of a block's split plus one
    (all of a narrow K in flight at once), up to 8 stages and half of
    ``smem``, at least 2.  Raises ``ValueError`` when no tiling fits in
    ``smem``.  The rules and thresholds come from timing the alternatives
    at every main-path shape on an H100."""
    bk = 32 if k >= 120 else 16
    steps = max(1, -(-k // bk))

    def tiling(bm: int, bn: int, tm: int):
        """(tiling, blocks launched), None where it does not fit."""
        tiles = -(-m // bm) * -(-n // bn)
        ks = 1
        if bk == 32 and tiles < sms:
            while ks < min(MAX_SPLIT, steps) and 10 * tiles * ks < 14 * sms:
                ks *= 2
            ks = min(ks, steps)
        stages = min(MAX_STAGES, -(-steps // ks) + 1)
        while stages > 2 and 2 * matmul_smem_bytes(bm, bn, bk, stages,
                                                   ks) > smem:
            stages -= 1
        if matmul_smem_bytes(bm, bn, bk, stages, ks) > smem:
            return None
        return (bm, bn, bk, tm, stages, ks), tiles * ks

    cands = []                 # (tiling, blocks, one of the preferred)
    for cap in (128 if n <= 512 else 64, 64, 40, 16, 4):
        bn = _column_tile(n, cap)
        txn = bn // 4
        tyn0 = 32 if txn <= 4 else 16 if txn <= 6 else 8
        tm = 8 if k > 16 and -(-m // (8 * tyn0)) * -(-n // bn) >= 2 * sms \
            else 4
        for tyn in (tyn0 >> i for i in range(tyn0.bit_length())):
            t = tiling(tm * tyn, bn, tm)
            if t is not None:
                cands.append(t + (cap >= 40 and (tyn == tyn0 or (
                    bk == 16 and tm == 4 and tyn == tyn0 // 2
                    and _threads_ok(txn * tyn))),))
    if not cands:
        raise ValueError(f"matmul: ({m}, {k}) @ ({k}, {n}) needs more than "
                         f"{smem} bytes of shared memory in every tiling")
    preferred = [(c, blocks) for c, blocks, pref in cands if pref]
    goal = sms if bk == 32 else 2 * sms
    for c, blocks in preferred:
        if blocks >= goal:
            return c
    full = [cb for cb in preferred if cb[1] >= sms]
    if full:
        return max(full, key=lambda cb: cb[1])[0]
    # the largest block that still gives every SM one; blocks of a few
    # threads (a 4 x 4 tile is one) leave most of each warp idle
    spread = [(c, blocks) for c, blocks, _ in cands if blocks >= sms]
    if spread:
        return max(spread, key=lambda cb: (cb[0][0] // cb[0][3])
                   * (cb[0][1] // 4))[0]
    return max(((c, blocks) for c, blocks, _ in cands),
               key=lambda cb: cb[1])[0]


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
    vec = _vec(a, b, y, dims=(k, n))
    tiling = matmul_tiling(m, n, k, vec, sm_count(dev.index),
                           smem_optin(dev.index))
    lib = _build.library("matmul", _SIGNATURES)
    _build.launch("matmul", lib.repro_matmul_f32, dev, a.data_ptr(),
                  b.data_ptr(), y.data_ptr(), m, n, k, *tiling, vec)
    matmul.launches += 1
    return y


matmul.launches = 0
