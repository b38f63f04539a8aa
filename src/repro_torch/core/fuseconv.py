"""FuSeConv: Fully-Separable Convolutions (Ganesan & Kumar, 2021), in PyTorch.

The plain-op reference path of the port (counterpart of
``repro.core.fuseconv``):

  * FuSe-Full (D=1): every input channel is convolved with BOTH a Kx1 row
    filter and a 1xK column filter -> 2C output channels.
  * FuSe-Half (D=2, the default drop-in): the first C/2 channels get Kx1 row
    filters, the remaining C/2 get 1xK column filters -> C output channels.

Everything here is NHWC at the public functions, as in the JAX package.
``w_row`` has shape (K, C_r) — a Kx1 filter per channel (convolves along
H); ``w_col`` has shape (K, C_c) — a 1xK filter per channel (convolves
along W).  Convolution weights keep the JAX layouts: HWIO for a dense conv,
(K, K, C) for a depthwise one.

``padding="SAME"`` follows XLA's split (the low side gets
``pad_total // 2``), applied by an explicit ``F.pad``: PyTorch's own
``padding="same"`` is refused at stride 2, and symmetric padding differs
from XLA on even extents.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _same_pad(extent: int, k: int, stride: int) -> Tuple[int, int, int]:
    """XLA 'SAME' split: (out_len, pad_lo, pad_hi)."""
    out_len = -(-extent // stride)
    pad_total = max(0, (out_len - 1) * stride + k - extent)
    lo = pad_total // 2
    return out_len, lo, pad_total - lo


def _conv_nhwc(x: Tensor, w_oihw: Tensor, *, stride: int, padding: str,
               groups: int = 1) -> Tensor:
    """NHWC in, NHWC out; ``w_oihw`` in PyTorch's (O, I/groups, kh, kw)."""
    kh, kw = w_oihw.shape[2], w_oihw.shape[3]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        _, lo_h, hi_h = _same_pad(x.shape[1], kh, stride)
        _, lo_w, hi_w = _same_pad(x.shape[2], kw, stride)
        xc = F.pad(xc, (lo_w, hi_w, lo_h, hi_h))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    y = F.conv2d(xc, w_oihw, stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Primitive convolutions (NHWC).
# ---------------------------------------------------------------------------

def conv2d(x: Tensor, w: Tensor, *, stride: int = 1,
           padding: str = "SAME") -> Tensor:
    """Standard convolution.  x: (B,H,W,Cin), w: (Kh,Kw,Cin,Cout) HWIO."""
    return _conv_nhwc(x, w.permute(3, 2, 0, 1), stride=stride,
                      padding=padding)


def depthwise_conv2d(x: Tensor, w: Tensor, *, stride: int = 1,
                     padding: str = "SAME") -> Tensor:
    """Depthwise convolution.  x: (B,H,W,C), w: (K,K,C)."""
    c = w.shape[2]
    return _conv_nhwc(x, w.permute(2, 0, 1).unsqueeze(1), stride=stride,
                      padding=padding, groups=c)


def pointwise_conv2d(x: Tensor, w: Tensor) -> Tensor:
    """1x1 convolution == per-pixel matmul.  x: (B,H,W,Cin), w: (Cin,Cout)."""
    return torch.einsum("bhwi,io->bhwo", x, w)


def fuse_conv1d_rows(x: Tensor, w_row: Tensor, *, stride: int = 1,
                     padding: str = "SAME") -> Tensor:
    """Bank of independent Kx1 (vertical) 1-D convolutions.

    x: (B,H,W,C), w_row: (K, C).  The W axis is subsampled by ``stride``
    as well, so the op stays a drop-in for a strided depthwise conv.
    """
    k, c = w_row.shape
    w4 = w_row.t().reshape(c, 1, k, 1)
    return _conv_nhwc(x, w4, stride=stride, padding=padding, groups=c)


def fuse_conv1d_cols(x: Tensor, w_col: Tensor, *, stride: int = 1,
                     padding: str = "SAME") -> Tensor:
    """Bank of independent 1xK (horizontal) 1-D convolutions."""
    k, c = w_col.shape
    w4 = w_col.t().reshape(c, 1, 1, k)
    return _conv_nhwc(x, w4, stride=stride, padding=padding, groups=c)


def fuse_conv2d_half(x: Tensor, w_row: Tensor, w_col: Tensor, *,
                     stride: int = 1, padding: str = "SAME") -> Tensor:
    """FuSe-Half: row filters on channels [:C_r], column filters on [C_r:].

    x: (B,H,W,C); w_row: (K, C//2); w_col: (K, C - C//2).
    Output: (B,H',W',C) — same channel count, a drop-in for depthwise KxK.
    """
    c = x.shape[-1]
    c_r = w_row.shape[-1]
    if c_r + w_col.shape[-1] != c:
        raise ValueError(f"fuse_half banks {tuple(w_row.shape)} + "
                         f"{tuple(w_col.shape)} do not cover {c} channels")
    y_r = fuse_conv1d_rows(x[..., :c_r], w_row, stride=stride,
                           padding=padding)
    y_c = fuse_conv1d_cols(x[..., c_r:], w_col, stride=stride,
                           padding=padding)
    return torch.cat([y_r, y_c], dim=-1)


def fuse_conv2d_full(x: Tensor, w_row: Tensor, w_col: Tensor, *,
                     stride: int = 1, padding: str = "SAME") -> Tensor:
    """FuSe-Full: every channel gets both a row and a column filter -> 2C.

    x: (B,H,W,C); w_row: (K, C); w_col: (K, C).  Output: (B,H',W',2C).
    """
    c = x.shape[-1]
    if w_row.shape[-1] != c or w_col.shape[-1] != c:
        raise ValueError(f"fuse_full banks {tuple(w_row.shape)}, "
                         f"{tuple(w_col.shape)} need {c} channels each")
    y_r = fuse_conv1d_rows(x, w_row, stride=stride, padding=padding)
    y_c = fuse_conv1d_cols(x, w_col, stride=stride, padding=padding)
    return torch.cat([y_r, y_c], dim=-1)


# ---------------------------------------------------------------------------
# Temporal (sequence) form: the operator's natural primitive, used by the
# LM stack's RG-LRU conv front-end.
# ---------------------------------------------------------------------------

def temporal_pad(k: int, causal: bool) -> Tuple[int, int]:
    """(left, right) zero padding of the temporal form: causal pads K-1 on
    the left, so position t sees x[t-K+1 .. t]; otherwise ((K-1)//2,
    K//2), the reference's split."""
    return (k - 1, 0) if causal else ((k - 1) // 2, k // 2)


def fuse_conv1d_temporal(x: Tensor, w: Tensor, *, causal: bool = True
                         ) -> Tensor:
    """Bank of independent temporal 1-D convolutions (depthwise over time).

    x: (B, T, C), w: (K, C): B*C independent length-T 1-D convolutions,
    y[b, t, c] = sum_k x_pad[b, t + k, c] * w[k, c].  The taps accumulate
    in fp32 in order and the result is cast back to x's dtype.
    """
    k = w.shape[0]
    t = x.shape[1]
    lo, hi = temporal_pad(k, causal)
    xp = F.pad(x, (0, 0, lo, hi)).float()
    w32 = w.float()
    acc = xp[:, 0:t] * w32[0]
    for tap in range(1, k):
        acc = acc + xp[:, tap:tap + t] * w32[tap]
    return acc.to(x.dtype)


def fuse_conv1d_temporal_step(state: Tensor, x_t: Tensor, w: Tensor
                              ) -> Tuple[Tensor, Tensor]:
    """Single decode step of the causal temporal conv.

    state: (B, K-1, C) last K-1 inputs; x_t: (B, C).  Returns (new_state,
    y_t), y_t accumulated in fp32 and cast back.
    """
    window = torch.cat([state, x_t[:, None, :]], dim=1)      # (B, K, C)
    y_t = (window.float() * w.float()).sum(1).to(x_t.dtype)
    return window[:, 1:, :], y_t


# ---------------------------------------------------------------------------
# Parameter containers + init.
# ---------------------------------------------------------------------------

VARIANTS = ("depthwise", "fuse_half", "fuse_full", "scaffold")


# ---------------------------------------------------------------------------
# NOS weight derivation (paper §4.1): FuSe filters are linear projections of
# the depthwise teacher kernel through a shared KxK adapter:
#   row filter (Kx1, channel c) = A @ T_w[:, mid, c]   (middle column)
#   col filter (1xK, channel c) = A @ T_w[mid, :, c]   (middle row)
# One adapter per layer, shared across row/col and across all channels
# (only K^2 extra trainable params per scaffolded layer).
# ---------------------------------------------------------------------------

def derive_fuse_from_teacher(dw: Tensor, adapter: Tensor,
                             variant: str = "fuse_half") -> dict:
    """dw: (K,K,C) teacher depthwise kernel; adapter: (K,K)."""
    mid = dw.shape[0] // 2
    r_full = adapter @ dw[:, mid, :]    # (K, C): middle column per channel
    c_full = adapter @ dw[mid, :, :]    # (K, C): middle row per channel
    if variant == "fuse_half":
        c_r = dw.shape[-1] // 2
        return {"row": r_full[:, :c_r], "col": c_full[:, c_r:]}
    return {"row": r_full, "col": c_full}


@dataclasses.dataclass(frozen=True)
class SpatialOpSpec:
    """Which operator realizes the KxK spatial stage of a separable block."""
    variant: str           # one of VARIANTS
    kernel: int            # K
    channels: int          # C (input channels of the spatial stage)
    stride: int = 1

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown variant {self.variant!r}; the port "
                             f"has {VARIANTS}")

    @property
    def out_channels(self) -> int:
        return 2 * self.channels if self.variant == "fuse_full" else self.channels

    def param_count(self) -> int:
        k, c = self.kernel, self.channels
        if self.variant == "depthwise":
            return k * k * c
        if self.variant == "fuse_half":
            return k * c           # K per channel (C/2 rows + C/2 cols)
        if self.variant == "scaffold":
            return k * k * c + k * k   # teacher kernel + shared adapter
        return 2 * k * c           # fuse_full

    def macs(self, out_h: int, out_w: int) -> int:
        k, c = self.kernel, self.channels
        if self.variant == "depthwise":
            return out_h * out_w * c * k * k
        if self.variant == "fuse_half":
            return out_h * out_w * c * k
        return out_h * out_w * 2 * c * k


def randn_scaled(generator: torch.Generator, shape, scale: float,
                 device, dtype) -> Tensor:
    """``scale`` times standard normals drawn from ``generator`` on its own
    device, then moved to ``device``."""
    t = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=dtype)
    return (t * scale).to(device)


def init_spatial_op(generator: torch.Generator, spec: SpatialOpSpec, *,
                    device="cuda", dtype=torch.float32) -> dict:
    """He-normal spatial-stage weights drawn from ``generator`` (the port's
    own init: the numbers differ from ``jax.random`` for the same seed).
    A ``scaffold`` stage holds a depthwise kernel, an identity adapter and
    a 0-d ``choice`` (0 = depthwise, 1 = FuSe-Half)."""
    k, c = spec.kernel, spec.channels
    fan_in = k * k if spec.variant in ("depthwise", "scaffold") else k
    scale = float(np.sqrt(2.0 / fan_in))
    if spec.variant == "depthwise":
        return {"dw": randn_scaled(generator, (k, k, c), scale, device, dtype)}
    if spec.variant == "scaffold":
        return {"dw": randn_scaled(generator, (k, k, c), scale, device, dtype),
                "adapter": torch.eye(k, device=device, dtype=dtype),
                "choice": torch.zeros((), device=device, dtype=dtype)}
    c_r = c // 2 if spec.variant == "fuse_half" else c
    c_c = c - c_r if spec.variant == "fuse_half" else c
    return {"row": randn_scaled(generator, (k, c_r), scale, device, dtype),
            "col": randn_scaled(generator, (k, c_c), scale, device, dtype)}


def apply_spatial_op(params: dict, spec: SpatialOpSpec, x: Tensor,
                     padding: str = "SAME") -> Tensor:
    if spec.variant == "depthwise":
        return depthwise_conv2d(x, params["dw"], stride=spec.stride,
                                padding=padding)
    if spec.variant == "scaffold":
        # NOS scaffolded stage: both the teacher (depthwise) and the
        # adapter-derived FuSe-Half paths, blended by the runtime choice,
        # so that gradients reach the kernel and the adapter either way.
        y_dw = depthwise_conv2d(x, params["dw"], stride=spec.stride,
                                padding=padding)
        derived = derive_fuse_from_teacher(params["dw"], params["adapter"],
                                           "fuse_half")
        y_fuse = fuse_conv2d_half(x, derived["row"], derived["col"],
                                  stride=spec.stride, padding=padding)
        choice = params["choice"].to(y_dw.dtype)
        return choice * y_fuse + (1.0 - choice) * y_dw
    if spec.variant == "fuse_half":
        return fuse_conv2d_half(x, params["row"], params["col"],
                                stride=spec.stride, padding=padding)
    return fuse_conv2d_full(x, params["row"], params["col"],
                            stride=spec.stride, padding=padding)
