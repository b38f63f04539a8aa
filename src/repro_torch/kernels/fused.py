"""The fused FuSeConv kernel and the depthwise KxK kernel.

Port of ``repro.kernels.fused``:

``fuseconv_fused``
    A whole FuSeConv block in one launch: the Kx1 row bank, the 1xK column
    bank, the (inference) BatchNorm affine, the activation and the 1x1
    channel mix.  The spatial intermediate stays in shared memory and
    registers (``csrc/fused.cu``).
``depthwise_kxk``
    The baseline KxK depthwise convolution.

Both use XLA's SAME split (``same_pad``: the low side gets
``pad_total // 2``).  The TPU kernels' row-window fold and 128-channel
padding are VMEM schedule, not semantics: the CUDA kernels compute their
own offsets and mask their edges, and the outputs stay identical.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
PyTorch version (the port of the matching ``repro.kernels.ref`` oracle) for
CPU tensors; ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

Tensor = torch.Tensor

# In-kernel activations (fp32): must mirror repro_torch.vision.layers.ACTS.
ACTS = {
    "linear": lambda x: x,
    "relu": lambda x: torch.clamp(x, min=0.0),
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "hswish": lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0,
}
# Activation codes understood by csrc/fused.cu::apply_act.
_ACT_CODES = {"linear": 0, "relu": 1, "relu6": 2, "hswish": 3}

_P, _I = _build.PTR, _build.INT
_SIGNATURES = {
    "repro_fuseconv_fused_f32": (_P,) * 7 + (_I,) * 16 + (_P,),
    "repro_depthwise_kxk_f32": (_P,) * 3 + (_I,) * 10 + (_P,),
}


def same_pad(extent: int, k: int, stride: int) -> Tuple[int, int, int]:
    """XLA 'SAME' padding for a strided conv: (out_len, pad_lo, pad_hi).

    XLA puts ``pad_total // 2`` on the low side; for stride > 1 over an
    even extent that differs from stride-1 centering, so every kernel that
    pads-then-subsamples must use THIS split to match the reference.
    """
    out_len = -(-extent // stride)
    pad_total = max(0, (out_len - 1) * stride + k - extent)
    lo = pad_total // 2
    return out_len, lo, pad_total - lo


def _bank_split(variant: str, x: Tensor, w_row: Tensor, w_col: Tensor
                ) -> Tuple[int, int]:
    """(c_r, c_sp) for a FuSe variant, checking the bank shapes."""
    c = x.shape[-1]
    c_r = w_row.shape[1]
    if variant == "fuse_full":
        if c_r != c or w_col.shape[1] != c:
            raise ValueError(f"fuse_full banks {tuple(w_row.shape)}, "
                             f"{tuple(w_col.shape)} need {c} channels")
        return c_r, 2 * c
    if variant == "fuse_half":
        if c_r + w_col.shape[1] != c:
            raise ValueError(f"fuse_half banks {tuple(w_row.shape)} + "
                             f"{tuple(w_col.shape)} do not cover {c}")
        return c_r, c
    raise ValueError(f"fuseconv_fused: variant {variant!r}")


# ---------------------------------------------------------------------------
# Fused FuSeConv kernel: 1-D banks + affine + act + pointwise mix.
# ---------------------------------------------------------------------------

def fuseconv_fused_plain(x: Tensor, w_row: Tensor, w_col: Tensor,
                         w_pw: Tensor, *, variant: str = "fuse_full",
                         stride: int = 1, scale: Optional[Tensor] = None,
                         bias: Optional[Tensor] = None,
                         act: str = "linear") -> Tensor:
    """Plain PyTorch version: row bank + col bank (SAME padding, stride via
    subsample) -> concat -> per-channel affine -> activation -> mix."""
    n, h, wd, c = x.shape
    k = w_row.shape[0]
    c_r, _ = _bank_split(variant, x, w_row, w_col)
    if variant == "fuse_full":
        x_row, x_col = x, x
    else:
        x_row, x_col = x[..., :c_r], x[..., c_r:]
    out_h, lo_h, hi_h = same_pad(h, k, stride)
    out_w, lo_w, hi_w = same_pad(wd, k, stride)

    def bank(xb: Tensor, wb: Tensor, axis: int) -> Tensor:
        """Strided 1-D conv along ``axis`` with SAME padding, fp32."""
        lo, hi = (lo_h, hi_h) if axis == 1 else (lo_w, hi_w)
        pads = (0, 0, 0, 0, lo, hi) if axis == 1 else (0, 0, lo, hi)
        xp = F.pad(xb.float(), pads)
        out_len = out_h if axis == 1 else out_w
        acc = 0.0
        for tap in range(k):
            win = xp.narrow(axis, tap, (out_len - 1) * stride + 1)
            win = win[:, ::stride] if axis == 1 else win[:, :, ::stride]
            acc = acc + win * wb[tap].float()
        return acc

    # Each bank convolves one axis; the other axis is subsampled from 0.
    y_r = bank(x_row, w_row, 1)[:, :, ::stride][:, :, :out_w]
    y_c = bank(x_col, w_col, 2)[:, ::stride][:, :out_h]
    y_sp = torch.cat([y_r, y_c], dim=-1)
    if scale is not None:
        y_sp = y_sp * scale.float()
    if bias is not None:
        y_sp = y_sp + bias.float()
    y_sp = ACTS[act](y_sp)
    y = torch.einsum("nhwc,cd->nhwd", y_sp, w_pw.float())
    return y.to(x.dtype)


def fuseconv_fused(x: Tensor, w_row: Tensor, w_col: Tensor, w_pw: Tensor,
                   *, variant: str = "fuse_full", stride: int = 1,
                   scale: Optional[Tensor] = None,
                   bias: Optional[Tensor] = None,
                   act: str = "linear") -> Tensor:
    """FuSeConv block in one kernel: 1-D banks -> affine -> act -> 1x1 mix.

    x: (B, H, W, C) NHWC.  w_row: (K, C_row), w_col: (K, C_col) with
    C_row = C_col = C for ``fuse_full`` (c_sp = 2C) and C_row + C_col = C
    for ``fuse_half`` (c_sp = C).  w_pw: (c_sp, Cout).  ``scale``/``bias``
    (each (c_sp,), optional) fold an inference-mode BatchNorm between the
    banks and the mix.  Output: (B, H', W', Cout), SAME padding.
    """
    c_r, c_sp = _bank_split(variant, x, w_row, w_col)
    if act not in _ACT_CODES:
        raise ValueError(f"fuseconv_fused: activation {act!r}")
    if x.ndim != 4 or w_pw.ndim != 2 or w_pw.shape[0] != c_sp \
            or w_col.shape[0] != w_row.shape[0]:
        raise ValueError(f"fuseconv_fused: x {tuple(x.shape)}, w_row "
                         f"{tuple(w_row.shape)}, w_col {tuple(w_col.shape)},"
                         f" w_pw {tuple(w_pw.shape)}")
    g = torch.ones(c_sp, device=x.device) if scale is None else scale
    bb = torch.zeros(c_sp, device=x.device) if bias is None else bias
    if g.shape != (c_sp,) or bb.shape != (c_sp,):
        raise ValueError(f"fuseconv_fused: scale/bias must be ({c_sp},)")
    dev = _build.check_inputs("fuseconv_fused", x, w_row, w_col, w_pw, g, bb)
    if dev.type == "cpu":
        return fuseconv_fused_plain(x, w_row, w_col, w_pw, variant=variant,
                                    stride=stride, scale=scale, bias=bias,
                                    act=act)
    b, h, wd, c = x.shape
    k = w_row.shape[0]
    cout = w_pw.shape[1]
    out_h, lo_h, _ = same_pad(h, k, stride)
    out_w, lo_w, _ = same_pad(wd, k, stride)
    y = torch.empty((b, out_h, out_w, cout), device=dev, dtype=torch.float32)
    if y.numel() == 0:
        return y
    _build.check_size("fuseconv_fused", y)
    col_src0 = c_r if variant == "fuse_half" else 0
    lib = _build.library("fused", _SIGNATURES)
    _build.launch("fuseconv_fused", lib.repro_fuseconv_fused_f32, dev,
                  x.data_ptr(), w_row.data_ptr(), w_col.data_ptr(),
                  g.data_ptr(), bb.data_ptr(), w_pw.data_ptr(), y.data_ptr(),
                  b, h, wd, c, k, stride, lo_h, lo_w, out_h, out_w,
                  c_r, w_col.shape[1], col_src0, c_sp, cout, _ACT_CODES[act])
    fuseconv_fused.launches += 1
    return y


fuseconv_fused.launches = 0


# ---------------------------------------------------------------------------
# Depthwise KxK kernel.
# ---------------------------------------------------------------------------

def depthwise_kxk_plain(x: Tensor, w: Tensor, *, stride: int = 1) -> Tensor:
    """Plain PyTorch version: K*K taps over the padded input, then a
    strided subsample.  x: (N,H,W,C), w: (K,K,C)."""
    n, h, wd, c = x.shape
    kh, kw = w.shape[0], w.shape[1]
    out_h, lo_h, hi_h = same_pad(h, kh, stride)
    out_w, lo_w, hi_w = same_pad(wd, kw, stride)
    x_pad = F.pad(x.float(), (0, 0, lo_w, hi_w, lo_h, hi_h))
    acc = torch.zeros((n, out_h, out_w, c), dtype=torch.float32,
                      device=x.device)
    for th in range(kh):
        for tw in range(kw):
            win = x_pad[:, th:th + (out_h - 1) * stride + 1:stride,
                        tw:tw + (out_w - 1) * stride + 1:stride, :]
            acc = acc + win * w[th, tw].float()
    return acc.to(x.dtype)


def depthwise_kxk(x: Tensor, w: Tensor, *, stride: int = 1) -> Tensor:
    """Depthwise KxK conv.  x: (B, H, W, C), w: (K, K, C); SAME padding,
    stride 1 or 2.  Matches ``repro_torch.core.fuseconv.depthwise_conv2d``."""
    dev = _build.check_inputs("depthwise_kxk", x, w)
    if x.ndim != 4 or w.ndim != 3 or w.shape[0] != w.shape[1] \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"depthwise_kxk: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    if dev.type == "cpu":
        return depthwise_kxk_plain(x, w, stride=stride)
    b, h, wd, c = x.shape
    k = w.shape[0]
    out_h, lo_h, _ = same_pad(h, k, stride)
    out_w, lo_w, _ = same_pad(wd, k, stride)
    y = torch.empty((b, out_h, out_w, c), device=dev, dtype=torch.float32)
    if y.numel() == 0:
        return y
    _build.check_size("depthwise_kxk", y)
    lib = _build.library("fused", _SIGNATURES)
    _build.launch("depthwise_kxk", lib.repro_depthwise_kxk_f32, dev,
                  x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, c, k,
                  stride, lo_h, lo_w, out_h, out_w)
    depthwise_kxk.launches += 1
    return y


depthwise_kxk.launches = 0
