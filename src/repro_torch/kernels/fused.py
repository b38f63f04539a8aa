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

import functools
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
    "repro_fuseconv_fused_f32": (_P,) * 7 + (_I,) * 24 + (_P,),
    "repro_depthwise_kxk_f32": (_P,) * 3 + (_I,) * 16 + (_P,),
}

# Grid-fill target of the tilings below: the H100 SXM's streaming
# multiprocessors.
SMS = 132
# Dynamic shared memory one block may opt into, where the device does not
# say (the H100's 227 KB).
SMEM_OPTIN = 227 * 1024


@functools.lru_cache(maxsize=None)
def smem_optin(index: int) -> int:
    """Bytes of dynamic shared memory a block may opt into on CUDA device
    ``index``."""
    props = torch.cuda.get_device_properties(index)
    return getattr(props, "shared_memory_per_block_optin", SMEM_OPTIN)


def _vec(*tensors: Tensor, dims: Tuple[int, ...] = ()) -> int:
    """The kernels' vector width: 16 bytes of the element type (4 fp32, 8
    bf16) when every dim is a multiple of it and every tensor 16-byte
    aligned (the kernels' 16-byte copies and stores), else 1."""
    wide = 16 // tensors[0].element_size()
    ok = all(d % wide == 0 for d in dims) and all(
        t.data_ptr() % 16 == 0 for t in tensors)
    return wide if ok else 1


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def fused_smem_bytes(th: int, tw: int, nt: int, px: int, stages: int,
                     ksplit: int, fk: int, k: int, stride: int, c_sp: int,
                     vec: int) -> int:
    """Dynamic shared memory of ``csrc/fused.cu::fuseconv_kernel`` at this
    tiling (the layout ``repro_fuseconv_fused_f32`` computes): per split a
    ring of chunk stages (the banks' boxes, taps, scale, bias and the w_pw
    slice) and the bank tile S; the splits' partial sums reuse it."""
    rh, cw = (th - 1) * stride + k, (tw - 1) * stride + k
    region = _round_up(vec * max(rh * tw, th * cw), 32) + (
        8 if vec == 4 else 2)
    stage = fk // vec * region + (k + 2) * fk + fk * nt
    walk = -(-c_sp // (fk * ksplit))
    split = min(walk, stages) * stage + fk * (_round_up(px * 4, 4) + 4)
    parts = (ksplit - 1) * nt // 4 * px * 16
    return 4 * max(ksplit * split, parts)


@functools.lru_cache(maxsize=None)
def fused_tiling(b: int, oh: int, ow: int, c_sp: int, cout: int, k: int,
                 stride: int, vec: int, smem: int
                 ) -> Tuple[int, int, int, int, int, int, int]:
    """(th, tw, nt, px, stages, ksplit, fk) for
    ``csrc/fused.cu::fuseconv_kernel``, within ``smem`` bytes of shared
    memory.

    A block owns a th x tw output tile (tw a power of two) and nt output
    channels: nt is the largest multiple of 4 from 16 to 128 that divides
    Cout, so no mix lane idles (else Cout rounded up to 4, else 32).  nt / 4 x px
    threads (a multiple of 32, at most twice the tile's pixels / 4) each
    mix 4 pixels x 4 channels.  The tile is the largest whose grid has two
    blocks per SM, else the smallest allowed.  A chunk is fk = 32 spatial
    channels (128 bytes of a pixel per copy) where c_sp >= 128, else 16.
    ``ksplit`` such thread groups (up to 3, at least two chunks each) split
    the walk over the chunks, so that a small grid still puts enough warps
    on every SM; each walks its chunks through a ring of up to 3 stages.
    Where that does not fit in ``smem``, the ring, then the split, then the
    tile step down."""
    nts = [n for n in range(128, 15, -4) if cout % n == 0]
    for nt in nts + [min(128, -(-cout // 4) * 4), 32]:
        nx = nt // 4
        tiles = []
        for th, tw in ((16, 16), (8, 16), (8, 8), (8, 4), (4, 4), (2, 8),
                       (2, 4)):
            px = -(-th * tw // 4)
            while (nx * px) % 32:
                px += 1
            if nx * px <= 512 and px * 4 <= 2 * th * tw:
                tiles.append((th, tw, nt, px))
        if tiles:                 # nt = 32 always has one: 2 x 8, px 4
            break
    pick = next((i for i, (th, tw, nt, _) in enumerate(tiles)
                 if b * -(-oh // th) * -(-ow // tw) * -(-cout // nt)
                 >= 2 * SMS), len(tiles) - 1)
    fk = 32 if c_sp >= 128 else 16
    chunks = -(-c_sp // fk)
    for th, tw, nt, px in tiles[pick:]:   # then the smaller ones
        ksplit = max(1, min(3, chunks // 2, 512 // (nt // 4 * px)))
        stages = max(2, min(3, -(-chunks // ksplit) + 1))
        while True:
            if fused_smem_bytes(th, tw, nt, px, stages, ksplit, fk, k,
                                stride, c_sp, vec) <= smem:
                return th, tw, nt, px, stages, ksplit, fk
            if stages > 2:
                stages -= 1
            elif ksplit > 1:
                ksplit -= 1
            else:
                break
    raise ValueError(f"fuseconv_fused: K {k} stride {stride} needs more "
                     f"than {smem} bytes of shared memory in every tiling")


def depthwise_smem_bytes(th: int, tw: int, cc: int, stages: int, k: int,
                         stride: int) -> int:
    """Dynamic shared memory of ``csrc/fused.cu::depthwise_kernel``: a ring
    of ``stages`` halo boxes with their K x K x cc weights."""
    ih, iw = (th - 1) * stride + k, (tw - 1) * stride + k
    return 4 * stages * (ih * iw + k * k) * cc


@functools.lru_cache(maxsize=None)
def depthwise_tiling(b: int, oh: int, ow: int, c: int, k: int, stride: int,
                     vec: int, smem: int) -> Tuple[int, int, int, int, int]:
    """(th, tw, cc, threads, stages) for
    ``csrc/fused.cu::depthwise_kernel``, within ``smem`` bytes of shared
    memory.

    A work item is an 8 x 8 output tile and cc = 32 channels (fewer where
    C is smaller); a thread owns vec channels and 4 outputs along W, and
    the persistent grid walks the items through a ring of 2 stages.  A
    stride-2 layer with at least 4 such items per SM takes 8 x 4 tiles and
    a ring of 3: its halo box is twice the bytes of its outputs' input, so
    more copies have to be in flight per block.  Where a large K does not
    fit in ``smem``, the ring, then cc, then the tile step down."""
    cc = 32
    if vec == 4:
        cc = min(cc, -(-c // 4) * 4)
        while cc & (cc - 1):
            cc += 4            # cc / 4 must be a power of two
    th, tw, stages = 8, 8, 2
    if stride == 2 and b * -(-oh // 8) * -(-ow // 8) * -(-c // cc) >= 4 * SMS:
        tw, stages = 4, 3
    tiles = [(8, 8), (8, 4), (4, 4), (2, 4), (1, 4)]
    for th, tw in tiles[tiles.index((th, tw)):]:
        while depthwise_smem_bytes(th, tw, cc, stages, k, stride) > smem:
            if stages > 2:
                stages -= 1
            elif cc > 4:
                cc //= 2
            else:
                break
        else:
            threads = min(256, cc // vec * th * tw // 4)
            return th, tw, cc, threads, stages
    raise ValueError(f"depthwise_kxk: K {k} stride {stride} needs more than "
                     f"{smem} bytes of shared memory in every tiling")


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
    c_c = w_col.shape[1]
    vec = _vec(x, w_row, w_col, g, bb, w_pw, y,
               dims=(c, c_r, c_c, col_src0, cout))
    tiling = fused_tiling(b, out_h, out_w, c_sp, cout, k, stride, vec,
                          smem_optin(dev.index))
    lib = _build.library("fused", _SIGNATURES)
    _build.launch("fuseconv_fused", lib.repro_fuseconv_fused_f32, dev,
                  x.data_ptr(), w_row.data_ptr(), w_col.data_ptr(),
                  g.data_ptr(), bb.data_ptr(), w_pw.data_ptr(), y.data_ptr(),
                  b, h, wd, c, k, stride, lo_h, lo_w, out_h, out_w,
                  c_r, c_c, col_src0, c_sp, cout, _ACT_CODES[act],
                  *tiling, vec)
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
    vec = _vec(x, w, y, dims=(c,))
    tiling = depthwise_tiling(b, out_h, out_w, c, k, stride, vec,
                              smem_optin(dev.index))
    lib = _build.library("fused", _SIGNATURES)
    _build.launch("depthwise_kxk", lib.repro_depthwise_kxk_f32, dev,
                  x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, c, k,
                  stride, lo_h, lo_w, out_h, out_w, *tiling, vec)
    depthwise_kxk.launches += 1
    return y


depthwise_kxk.launches = 0
