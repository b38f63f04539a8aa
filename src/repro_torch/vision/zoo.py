"""The paper's evaluation networks: MobileNet V1/V2/V3-S/V3-L, MnasNet-B1.

Port of ``repro.vision.zoo``.  Each network is a list of block specs.
Blocks lower to the operator IR (``repro_torch.core.layerir.OpSpec``) for
counting/simulation, and carry init/apply for real execution.  The KxK
spatial stage of every separable block is pluggable: ``depthwise``
(baseline) | ``fuse_half`` | ``fuse_full`` — ``variant`` may be a single
string or a per-stage list (hybrid networks).  Parameters are a list of
dicts of tensors in the JAX package's layouts (HWIO, (K,C), (K,K,C),
(Cin,Cout)); this slice ports inference only.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import torch

from repro_torch.core import fuseconv as fc
from repro_torch.core.layerir import OpSpec
from repro_torch.kernels import backend as kb
from repro_torch.kernels import ops as kops
from repro_torch.vision import layers as L

Tensor = torch.Tensor


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


# ---------------------------------------------------------------------------
# Block specs.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Stem:
    cout: int
    stride: int = 2
    kernel: int = 3
    act: str = "relu"


@dataclasses.dataclass(frozen=True)
class DWSep:
    """MobileNetV1-style block: spatial stage + pointwise."""
    kernel: int
    cout: int
    stride: int = 1
    act: str = "relu"


@dataclasses.dataclass(frozen=True)
class MBConv:
    """Inverted residual: expand pw -> spatial stage -> (SE) -> project pw."""
    kernel: int
    exp: int            # expanded channels (absolute)
    cout: int
    stride: int = 1
    se: bool = False
    act: str = "relu"


@dataclasses.dataclass(frozen=True)
class ConvBN:
    kernel: int
    cout: int
    stride: int = 1
    act: str = "relu"


@dataclasses.dataclass(frozen=True)
class Head:
    classes: int
    hidden: Optional[int] = None   # V3-style pooled 1x1 conv before classifier
    act: str = "relu"


Block = Union[Stem, DWSep, MBConv, ConvBN, Head]


@dataclasses.dataclass(frozen=True)
class NetworkDef:
    name: str
    blocks: tuple
    resolution: int = 224
    in_channels: int = 3

    @property
    def num_spatial_stages(self) -> int:
        return sum(1 for b in self.blocks if isinstance(b, (DWSep, MBConv)))


def _variant_list(net: NetworkDef, variant) -> List[str]:
    n = net.num_spatial_stages
    if isinstance(variant, str):
        return [variant] * n
    variant = list(variant)
    assert len(variant) == n, (len(variant), n)
    return variant


# ---------------------------------------------------------------------------
# Lowering to operator IR.
# ---------------------------------------------------------------------------

def _spatial_ops(name: str, variant: str, k: int, c: int, stride: int,
                 h: int, w: int) -> List[OpSpec]:
    if variant == "depthwise":
        return [OpSpec("depthwise", name + "/dw", h, w, c, c, k, stride)]
    if variant == "fuse_half":
        c_r = c // 2
        return [OpSpec("fuse_row", name + "/fuse_row", h, w, c_r, c_r, k, stride),
                OpSpec("fuse_col", name + "/fuse_col", h, w, c - c_r, c - c_r,
                       k, stride)]
    if variant == "fuse_full":
        return [OpSpec("fuse_row", name + "/fuse_row", h, w, c, c, k, stride),
                OpSpec("fuse_col", name + "/fuse_col", h, w, c, c, k, stride)]
    raise ValueError(variant)


def lower_to_ir(net: NetworkDef, variant="depthwise") -> List[OpSpec]:
    variants = _variant_list(net, variant)
    ops: List[OpSpec] = []
    h = w = net.resolution
    c = net.in_channels
    vi = 0
    for bi, b in enumerate(net.blocks):
        nm = f"b{bi}"
        if isinstance(b, Stem):
            ops.append(OpSpec("conv", nm + "/stem", h, w, c, b.cout, b.kernel,
                              b.stride))
            h, w = ops[-1].out_h, ops[-1].out_w
            c = b.cout
        elif isinstance(b, DWSep):
            v = variants[vi]; vi += 1
            sp = _spatial_ops(nm, v, b.kernel, c, b.stride, h, w)
            ops.extend(sp)
            h, w = sp[-1].out_h, sp[-1].out_w
            c_sp = 2 * c if v == "fuse_full" else c
            ops.append(OpSpec("pointwise", nm + "/pw", h, w, c_sp, b.cout))
            c = b.cout
        elif isinstance(b, MBConv):
            v = variants[vi]; vi += 1
            if b.exp != c:
                ops.append(OpSpec("pointwise", nm + "/expand", h, w, c, b.exp))
            sp = _spatial_ops(nm, v, b.kernel, b.exp, b.stride, h, w)
            ops.extend(sp)
            h, w = sp[-1].out_h, sp[-1].out_w
            c_sp = 2 * b.exp if v == "fuse_full" else b.exp
            if b.se:
                cr = L.se_channels(c_sp)
                ops.append(OpSpec("se_reduce", nm + "/se_r", 1, 1, c_sp, cr))
                ops.append(OpSpec("se_expand", nm + "/se_e", 1, 1, cr, c_sp))
            ops.append(OpSpec("pointwise", nm + "/project", h, w, c_sp, b.cout))
            c = b.cout
        elif isinstance(b, ConvBN):
            kind = "pointwise" if b.kernel == 1 else "conv"
            ops.append(OpSpec(kind, nm + "/conv", h, w, c, b.cout, b.kernel,
                              b.stride))
            h, w = ops[-1].out_h, ops[-1].out_w
            c = b.cout
        elif isinstance(b, Head):
            ops.append(OpSpec("pool", nm + "/pool", h, w, c, c))
            if b.hidden:
                ops.append(OpSpec("dense", nm + "/hidden", 1, 1, c, b.hidden))
                c = b.hidden
            ops.append(OpSpec("dense", nm + "/fc", 1, 1, c, b.classes))
            c = b.classes
        else:
            raise TypeError(b)
    return ops


# ---------------------------------------------------------------------------
# Init / apply.
# ---------------------------------------------------------------------------

def init_network(generator: torch.Generator, net: NetworkDef,
                 variant="depthwise", *, device="cuda",
                 dtype=torch.float32) -> list:
    """He-normal params drawn from ``generator`` (the port's own init; the
    numbers differ from ``jax.random`` — load the JAX package's params with
    ``repro_torch.vision.convert.params_from_numpy`` to compare)."""
    variants = _variant_list(net, variant)
    kw = dict(device=device, dtype=dtype)
    params: list = []
    c = net.in_channels
    vi = 0
    for b in net.blocks:
        if isinstance(b, Stem):
            params.append({"w": L.init_conv(generator, b.kernel, c, b.cout,
                                            **kw),
                           "bn": L.init_bn(b.cout, **kw)})
            c = b.cout
        elif isinstance(b, DWSep):
            v = variants[vi]; vi += 1
            spec = fc.SpatialOpSpec(v, b.kernel, c, b.stride)
            c_sp = spec.out_channels
            params.append({"sp": fc.init_spatial_op(generator, spec, **kw),
                           "bn1": L.init_bn(c_sp, **kw),
                           "pw": L.init_pointwise(generator, c_sp, b.cout,
                                                  **kw),
                           "bn2": L.init_bn(b.cout, **kw)})
            c = b.cout
        elif isinstance(b, MBConv):
            v = variants[vi]; vi += 1
            p = {}
            if b.exp != c:
                p["expand"] = L.init_pointwise(generator, c, b.exp, **kw)
                p["bn0"] = L.init_bn(b.exp, **kw)
            spec = fc.SpatialOpSpec(v, b.kernel, b.exp, b.stride)
            c_sp = spec.out_channels
            p["sp"] = fc.init_spatial_op(generator, spec, **kw)
            p["bn1"] = L.init_bn(c_sp, **kw)
            if b.se:
                p["se"] = L.init_se(generator, c_sp, **kw)
            p["project"] = L.init_pointwise(generator, c_sp, b.cout, **kw)
            p["bn2"] = L.init_bn(b.cout, **kw)
            params.append(p)
            c = b.cout
        elif isinstance(b, ConvBN):
            if b.kernel == 1:
                w = L.init_pointwise(generator, c, b.cout, **kw)
            else:
                w = L.init_conv(generator, b.kernel, c, b.cout, **kw)
            params.append({"w": w, "bn": L.init_bn(b.cout, **kw)})
            c = b.cout
        elif isinstance(b, Head):
            p = {}
            if b.hidden:
                p["hidden"] = L.init_dense(generator, c, b.hidden, **kw)
                c = b.hidden
            p["fc"] = L.init_dense(generator, c, b.classes, **kw)
            params.append(p)
        else:
            raise TypeError(b)
    return params


def _apply_spatial(p: dict, spec: fc.SpatialOpSpec, x: Tensor,
                   backend: kb.Backend) -> Tensor:
    """Spatial stage on the selected backend: the decomposed 1-D banks
    through ``fuse1d`` for FuSe variants and ``depthwise_kxk`` for the
    baseline on ``cuda``; plain ops on ``torch``."""
    if backend.use_kernels and spec.variant in ("fuse_half", "fuse_full"):
        f = (kops.fuse_conv2d_half if spec.variant == "fuse_half"
             else kops.fuse_conv2d_full)
        return f(x, p["row"], p["col"], stride=spec.stride)
    if backend.use_kernels and spec.variant == "depthwise":
        return kops.depthwise_kxk(x.contiguous(), p["dw"], stride=spec.stride)
    return fc.apply_spatial_op(p, spec, x)


def _fusable(bk: kb.Backend, variant: str, *, se: bool = False) -> bool:
    """True when the block's spatial stage + bn1 + act + pointwise mix can
    run as one ``fuseconv_fused`` kernel: kernel backend with fusion on, a
    FuSe variant, and no SE block (its global pooling sits between the
    spatial stage and the mix)."""
    return (bk.use_kernels and bk.fused and not se
            and variant in ("fuse_half", "fuse_full"))


def _pointwise(x: Tensor, w: Tensor, backend: kb.Backend) -> Tensor:
    if backend.use_kernels:
        return kops.pointwise(x, w)
    return fc.pointwise_conv2d(x, w)


def _fused_block(x: Tensor, sp: dict, bn1: dict, w_pw: Tensor, variant: str,
                 stride: int, act: str) -> Tensor:
    g, bb = L.bn_inference_affine(bn1)
    return kops.fuseconv_fused(x.contiguous(), sp["row"], sp["col"], w_pw,
                               variant=variant, stride=stride, scale=g,
                               bias=bb, act=act)


def apply_network(params: list, net: NetworkDef, x: Tensor,
                  variant="depthwise", *, backend=None) -> Tensor:
    """Inference logits (BN on running statistics).  x: (B, H, W, C).

    ``backend`` selects the execution path for the spatial stages and all
    1x1 pointwise convs: None/"torch" (plain ops), "cuda" (the kernels,
    fused on) or "cuda_nofused".  On ``cuda`` a fusable block (FuSe
    variant, no SE) runs its spatial stage + bn1 + act + pointwise mix as
    one ``fuseconv_fused`` launch.
    """
    bk = kb.resolve_backend(backend)
    variants = _variant_list(net, variant)
    vi = 0
    c = net.in_channels
    for b, p in zip(net.blocks, params):
        if isinstance(b, Stem):
            x = fc.conv2d(x, p["w"], stride=b.stride)
            x, _ = L.apply_bn(p["bn"], x, train=False)
            x = L.ACTS[b.act](x)
            c = b.cout
        elif isinstance(b, DWSep):
            v = variants[vi]; vi += 1
            spec = fc.SpatialOpSpec(v, b.kernel, c, b.stride)
            if _fusable(bk, v):
                x = _fused_block(x, p["sp"], p["bn1"], p["pw"], v, b.stride,
                                 b.act)
            else:
                x = _apply_spatial(p["sp"], spec, x, bk)
                x, _ = L.apply_bn(p["bn1"], x, train=False)
                x = L.ACTS[b.act](x)
                x = _pointwise(x, p["pw"], bk)
            x, _ = L.apply_bn(p["bn2"], x, train=False)
            x = L.ACTS[b.act](x)
            c = b.cout
        elif isinstance(b, MBConv):
            v = variants[vi]; vi += 1
            shortcut = x
            cin = c
            if b.exp != cin:
                x = _pointwise(x, p["expand"], bk)
                x, _ = L.apply_bn(p["bn0"], x, train=False)
                x = L.ACTS[b.act](x)
            spec = fc.SpatialOpSpec(v, b.kernel, b.exp, b.stride)
            if _fusable(bk, v, se=b.se):
                x = _fused_block(x, p["sp"], p["bn1"], p["project"], v,
                                 b.stride, b.act)
            else:
                x = _apply_spatial(p["sp"], spec, x, bk)
                x, _ = L.apply_bn(p["bn1"], x, train=False)
                x = L.ACTS[b.act](x)
                if b.se:
                    x = L.apply_se(p["se"], x)
                x = _pointwise(x, p["project"], bk)
            x, _ = L.apply_bn(p["bn2"], x, train=False)
            if b.stride == 1 and cin == b.cout:
                x = x + shortcut
            c = b.cout
        elif isinstance(b, ConvBN):
            if b.kernel == 1:
                x = _pointwise(x, p["w"], bk)
            else:
                x = fc.conv2d(x, p["w"], stride=b.stride)
            x, _ = L.apply_bn(p["bn"], x, train=False)
            x = L.ACTS[b.act](x)
            c = b.cout
        elif isinstance(b, Head):
            x = x.mean(dim=(1, 2))
            if b.hidden:
                x = L.ACTS[b.act](L.apply_dense(p["hidden"], x))
            x = L.apply_dense(p["fc"], x)
        else:
            raise TypeError(b)
    return x


# ---------------------------------------------------------------------------
# Model factories (official configurations).
# ---------------------------------------------------------------------------

def mobilenet_v1(num_classes: int = 1000, width_mult: float = 1.0,
                 resolution: int = 224) -> NetworkDef:
    d = lambda c: _make_divisible(c * width_mult)
    cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
           (1024, 1)]
    blocks: List[Block] = [Stem(d(32), 2, 3, "relu")]
    blocks += [DWSep(3, d(c), s, "relu") for c, s in cfg]
    blocks += [Head(num_classes)]
    return NetworkDef("mobilenet_v1", tuple(blocks), resolution)


def mobilenet_v2(num_classes: int = 1000, width_mult: float = 1.0,
                 resolution: int = 224) -> NetworkDef:
    d = lambda c: _make_divisible(c * width_mult)
    # (expansion t, cout, repeats, first stride)
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    blocks: List[Block] = [Stem(d(32), 2, 3, "relu6")]
    cin = d(32)
    for t, cout, n, s in cfg:
        for i in range(n):
            blocks.append(MBConv(3, cin * t, d(cout), s if i == 0 else 1,
                                 False, "relu6"))
            cin = d(cout)
    blocks += [ConvBN(1, d(1280) if width_mult > 1.0 else 1280, 1, "relu6"),
               Head(num_classes)]
    return NetworkDef("mobilenet_v2", tuple(blocks), resolution)


def mobilenet_v3_large(num_classes: int = 1000, width_mult: float = 1.0,
                       resolution: int = 224) -> NetworkDef:
    d = lambda c: _make_divisible(c * width_mult)
    # (k, exp, out, se, act, stride)
    cfg = [
        (3, 16, 16, False, "relu", 1),
        (3, 64, 24, False, "relu", 2),
        (3, 72, 24, False, "relu", 1),
        (5, 72, 40, True, "relu", 2),
        (5, 120, 40, True, "relu", 1),
        (5, 120, 40, True, "relu", 1),
        (3, 240, 80, False, "hswish", 2),
        (3, 200, 80, False, "hswish", 1),
        (3, 184, 80, False, "hswish", 1),
        (3, 184, 80, False, "hswish", 1),
        (3, 480, 112, True, "hswish", 1),
        (3, 672, 112, True, "hswish", 1),
        (5, 672, 160, True, "hswish", 2),
        (5, 960, 160, True, "hswish", 1),
        (5, 960, 160, True, "hswish", 1),
    ]
    blocks: List[Block] = [Stem(d(16), 2, 3, "hswish")]
    blocks += [MBConv(k, d(e), d(c), s, se, a) for k, e, c, se, a, s in cfg]
    blocks += [ConvBN(1, d(960), 1, "hswish"),
               Head(num_classes, hidden=1280, act="hswish")]
    return NetworkDef("mobilenet_v3_large", tuple(blocks), resolution)


def mobilenet_v3_small(num_classes: int = 1000, width_mult: float = 1.0,
                       resolution: int = 224) -> NetworkDef:
    d = lambda c: _make_divisible(c * width_mult)
    cfg = [
        (3, 16, 16, True, "relu", 2),
        (3, 72, 24, False, "relu", 2),
        (3, 88, 24, False, "relu", 1),
        (5, 96, 40, True, "hswish", 2),
        (5, 240, 40, True, "hswish", 1),
        (5, 240, 40, True, "hswish", 1),
        (5, 120, 48, True, "hswish", 1),
        (5, 144, 48, True, "hswish", 1),
        (5, 288, 96, True, "hswish", 2),
        (5, 576, 96, True, "hswish", 1),
        (5, 576, 96, True, "hswish", 1),
    ]
    blocks: List[Block] = [Stem(d(16), 2, 3, "hswish")]
    blocks += [MBConv(k, d(e), d(c), s, se, a) for k, e, c, se, a, s in cfg]
    blocks += [ConvBN(1, d(576), 1, "hswish"),
               Head(num_classes, hidden=1024, act="hswish")]
    return NetworkDef("mobilenet_v3_small", tuple(blocks), resolution)


def mnasnet_b1(num_classes: int = 1000, width_mult: float = 1.0,
               resolution: int = 224) -> NetworkDef:
    d = lambda c: _make_divisible(c * width_mult)
    blocks: List[Block] = [Stem(d(32), 2, 3, "relu")]
    blocks.append(DWSep(3, d(16), 1, "relu"))          # SepConv k3 -> 16
    # (expansion t, k, cout, repeats, first stride)
    cfg = [(3, 3, 24, 3, 2), (3, 5, 40, 3, 2), (6, 5, 80, 3, 2),
           (6, 3, 96, 2, 1), (6, 5, 192, 4, 2), (6, 3, 320, 1, 1)]
    cin = d(16)
    for t, k, cout, n, s in cfg:
        for i in range(n):
            blocks.append(MBConv(k, cin * t, d(cout), s if i == 0 else 1,
                                 False, "relu"))
            cin = d(cout)
    blocks += [ConvBN(1, 1280, 1, "relu"), Head(num_classes)]
    return NetworkDef("mnasnet_b1", tuple(blocks), resolution)


def tiny_net(num_classes: int = 10, resolution: int = 32,
             width: int = 16) -> NetworkDef:
    """Reduced same-family config for CPU smoke tests / NOS experiments."""
    w = width
    blocks: List[Block] = [
        Stem(w, 1, 3, "relu"),
        MBConv(3, w * 2, w, 1, False, "relu"),
        MBConv(3, w * 4, w * 2, 2, True, "hswish"),
        MBConv(5, w * 4, w * 2, 1, True, "hswish"),
        MBConv(3, w * 8, w * 4, 2, False, "hswish"),
        ConvBN(1, w * 8, 1, "hswish"),
        Head(num_classes),
    ]
    return NetworkDef("tiny_net", tuple(blocks), resolution)


ZOO = {
    "mobilenet_v1": mobilenet_v1,
    "mobilenet_v2": mobilenet_v2,
    "mobilenet_v3_small": mobilenet_v3_small,
    "mobilenet_v3_large": mobilenet_v3_large,
    "mnasnet_b1": mnasnet_b1,
}
