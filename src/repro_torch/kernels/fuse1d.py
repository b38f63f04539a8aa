"""FuSeConv's primitive, a bank of independent 1-D convolutions, and the
FuSe spatial stage built from it.

Port of ``repro.kernels.fuse1d.fuse1d`` and of the stage that
``repro.kernels.ops.fuse_conv2d_half``/``full`` compose from it on the TPU:

``fuse1d``
    ``y[n, t, c] = sum_k x_pad[n, t + k, c] * w[k, c]`` with x_pad
    (N, T + K - 1, C) already padded by the caller and w (K, C).
``fuse_temporal``
    The LM stack's temporal form (``repro.kernels.ops.fuse_conv1d_temporal``):
    x (B, T, C), w (K, C), zero padding K-1 on the left (causal) or the
    centred split, y (B, T, C).
``fuse_stage``
    A whole FuSe spatial stage over x (B, H, W, C) NHWC: the Kx1 row bank
    along H and the 1xK column bank along W, XLA-SAME padding, stride 1 or
    2.  ``fuse_half`` gives the row bank channels [0, c_r) and the column
    bank [c_r, C) (c_r = w_row's width); ``fuse_full`` runs both on every
    channel into 2C outputs, rows first.

All three launch ``csrc/fuse1d.cu`` for CUDA tensors, one launch per call,
with no pad, transpose or concat around it (``fuse1d`` is the kernel's row
bank over (N, T + K - 1, 1, C) with no halo, ``fuse_temporal`` the row
bank over (B, T, 1, C) with the causal or centred halo); for CPU tensors
they run their plain versions.  The two 1-D forms take float32 or
bfloat16 (fp32 accumulation, output in the input's dtype, as the Pallas
kernel); the stage takes float32.  ``fuse_stage_plain`` is the TPU path's
composition: the rows/cols reduction onto ``fuse1d_plain`` (transpose,
SAME pad, 1-D bank at full resolution, strided subsample) and the concat.
``fuse1d.launches`` counts the launches of all three wrappers;
``fuse1d.by_shape`` counts them by (dtype, x as (B, H, W, C), K, stride,
leading pad along H, leading pad along W), x being (B, T, 1, C) for the
1-D forms.
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from repro_torch.core.fuseconv import temporal_pad
from repro_torch.kernels import _build
from repro_torch.kernels.fused import _bank_split, _vec, same_pad

Tensor = torch.Tensor

_P, _I = _build.PTR, _build.INT
_ENTRY = {torch.float32: "repro_fuse_stage_f32",
          torch.bfloat16: "repro_fuse_stage_bf16"}
_SIGNATURES = {fn: (_P,) * 4 + (_I,) * 14 + (_P,) for fn in _ENTRY.values()}
# the 1-D forms' element types; the stage's is float32 alone
ONE_D_DTYPES = tuple(_ENTRY)


def fuse1d_plain(x_pad: Tensor, w: Tensor) -> Tensor:
    """Plain PyTorch version: K shifted multiply-adds in fp32."""
    k = w.shape[0]
    t = x_pad.shape[1] - k + 1
    acc = torch.zeros((x_pad.shape[0], t, x_pad.shape[2]),
                      dtype=torch.float32, device=x_pad.device)
    for tap in range(k):
        acc = acc + x_pad[:, tap:tap + t, :].float() * w[tap].float()
    return acc.to(x_pad.dtype)


def _launch(x: Tensor, w_row: Tensor, w_col: Tensor, y: Tensor, k: int,
            stride: int, lo_h: int, lo_w: int, col_src0: int) -> None:
    """One launch of ``repro_fuse_stage_f32`` (or ``_bf16``) on x
    (B, H, W, C) into y (B, Ho, Wo, c_r + c_c)."""
    b, h, wd, c = x.shape
    oh, ow = y.shape[1], y.shape[2]
    c_r, c_c = w_row.shape[1], w_col.shape[1]
    vec = _vec(x, w_row, w_col, y, dims=(c, c_r, c_c, col_src0))
    lib = _build.library("fuse1d", _SIGNATURES)
    _build.launch("fuse1d", getattr(lib, _ENTRY[x.dtype]), y.device,
                  x.data_ptr(), w_row.data_ptr(), w_col.data_ptr(),
                  y.data_ptr(), b, h, wd, c, k, stride, lo_h, lo_w, oh, ow,
                  c_r, c_c, col_src0, vec)
    fuse1d.launches += 1
    fuse1d.by_shape[(x.dtype, tuple(x.shape), k, stride, lo_h, lo_w)] += 1


def fuse1d(x_pad: Tensor, w: Tensor) -> Tensor:
    """Bank of independent 1-D convolutions.  x_pad: (N, T + K - 1, C),
    w: (K, C); returns (N, T, C) in x_pad's dtype."""
    dev = _build.check_inputs("fuse1d", x_pad, w, dtypes=ONE_D_DTYPES)
    if x_pad.ndim != 3 or w.ndim != 2 or w.shape[1] != x_pad.shape[2]:
        raise ValueError(f"fuse1d: x_pad {tuple(x_pad.shape)}, "
                         f"w {tuple(w.shape)}")
    n, tp, c = x_pad.shape
    k = w.shape[0]
    t = tp - k + 1
    if k < 1 or t < 1:
        raise ValueError(f"fuse1d: {k} taps over a padded length of {tp}")
    if dev.type == "cpu":
        return fuse1d_plain(x_pad, w)
    y = torch.empty((n, t, c), device=dev, dtype=x_pad.dtype)
    if y.numel():
        _build.check_size("fuse1d", y)
        _launch(x_pad.view(n, tp, 1, c), w, w[:, :0], y.view(n, t, 1, c), k,
                1, 0, 0, 0)
    return y


def fuse_temporal_plain(x: Tensor, w: Tensor, *, causal: bool = True
                        ) -> Tensor:
    """Plain PyTorch version of ``fuse_temporal``: the reference wrapper's
    zero pad, then ``fuse1d_plain``."""
    lo, hi = temporal_pad(w.shape[0], causal)
    return fuse1d_plain(F.pad(x, (0, 0, lo, hi)), w)


def fuse_temporal(x: Tensor, w: Tensor, *, causal: bool = True) -> Tensor:
    """Depthwise temporal conv.  x: (B, T, C), w: (K, C); returns (B, T, C)
    in x's dtype, y[b, t, c] = sum_k x[b, t + k - lo, c] * w[k, c] with
    lo = K-1 (causal) or (K-1)//2 and zeros outside [0, T)."""
    dev = _build.check_inputs("fuse_temporal", x, w, dtypes=ONE_D_DTYPES)
    if x.ndim != 3 or w.ndim != 2 or w.shape[1] != x.shape[2] \
            or w.shape[0] < 1:
        raise ValueError(f"fuse_temporal: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if dev.type == "cpu":
        return fuse_temporal_plain(x, w, causal=causal)
    b, t, c = x.shape
    k = w.shape[0]
    y = torch.empty_like(x)
    if y.numel():
        _launch(x.view(b, t, 1, c), w, w[:, :0], y.view(b, t, 1, c), k, 1,
                temporal_pad(k, causal)[0], 0, 0)
    return y


def _rows_plain(x: Tensor, w_row: Tensor, *, stride: int = 1) -> Tensor:
    """Kx1 (vertical) bank through ``fuse1d_plain``: W folded into the
    problem axis, H SAME-padded, every row computed, then subsampled.
    x: (B, H, W, C), w_row: (K, C)."""
    b, h, wdim, c = x.shape
    k = w_row.shape[0]
    xt = x.permute(0, 2, 1, 3).reshape(b * wdim, h, c)
    out_h, lo, hi = same_pad(h, k, stride)
    y = fuse1d_plain(F.pad(xt, (0, 0, lo, hi)), w_row)     # (B*W, T, C)
    y = y.reshape(b, wdim, y.shape[1], c).permute(0, 2, 1, 3)
    return y[:, ::stride, ::stride][:, :out_h]


def _cols_plain(x: Tensor, w_col: Tensor, *, stride: int = 1) -> Tensor:
    """1xK (horizontal) bank through ``fuse1d_plain``.  x: (B, H, W, C),
    w_col: (K, C)."""
    b, h, wdim, c = x.shape
    k = w_col.shape[0]
    out_w, lo, hi = same_pad(wdim, k, stride)
    y = fuse1d_plain(F.pad(x.reshape(b * h, wdim, c), (0, 0, lo, hi)), w_col)
    y = y.reshape(b, h, y.shape[1], c)
    return y[:, ::stride, ::stride][:, :, :out_w]


def fuse_stage_plain(x: Tensor, w_row: Tensor, w_col: Tensor, *,
                     variant: str = "fuse_half", stride: int = 1) -> Tensor:
    """Plain PyTorch version of ``fuse_stage``: both banks through
    ``fuse1d_plain``, then the concat."""
    c_r, _ = _bank_split(variant, x, w_row, w_col)
    x_row, x_col = (x, x) if variant == "fuse_full" else (x[..., :c_r],
                                                          x[..., c_r:])
    return torch.cat([_rows_plain(x_row, w_row, stride=stride),
                      _cols_plain(x_col, w_col, stride=stride)], dim=-1)


def fuse_stage(x: Tensor, w_row: Tensor, w_col: Tensor, *,
               variant: str = "fuse_half", stride: int = 1) -> Tensor:
    """FuSe spatial stage in one launch.  x: (B, H, W, C) NHWC; w_row
    (K, c_r), w_col (K, c_c) with c_r = c_c = C for ``fuse_full`` (2C
    outputs) and c_r + c_c = C for ``fuse_half`` (either may be 0: one
    bank alone).  Returns (B, Ho, Wo, c_r + c_c), SAME padding."""
    c_r, c_sp = _bank_split(variant, x, w_row, w_col)
    if x.ndim != 4 or w_row.ndim != 2 or w_col.shape[0] != w_row.shape[0] \
            or w_row.shape[0] < 1:
        raise ValueError(f"fuse_stage: x {tuple(x.shape)}, w_row "
                         f"{tuple(w_row.shape)}, w_col {tuple(w_col.shape)}")
    dev = _build.check_inputs("fuse_stage", x, w_row, w_col)
    if dev.type == "cpu":
        return fuse_stage_plain(x, w_row, w_col, variant=variant,
                                stride=stride)
    b, h, wd, _ = x.shape
    k = w_row.shape[0]
    out_h, lo_h, _ = same_pad(h, k, stride)
    out_w, lo_w, _ = same_pad(wd, k, stride)
    y = torch.empty((b, out_h, out_w, c_sp), device=dev, dtype=torch.float32)
    if y.numel():
        _build.check_size("fuse_stage", y)
        _launch(x, w_row, w_col, y, k, stride, lo_h, lo_w,
                c_r if variant == "fuse_half" else 0)
    return y


fuse1d.launches = 0
fuse1d.by_shape = collections.Counter()
