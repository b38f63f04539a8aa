"""The port's four kernel modules against the JAX package's Pallas kernels.

For each kernel — ``matmul``, ``fuse1d``, ``depthwise_kxk`` and
``fuseconv_fused`` — the port's plain PyTorch version and its wrapper (on a
CPU tensor the wrapper runs the plain version) are held against the Pallas
kernel in interpret mode and against its ``repro.kernels.ref`` oracle, on
the same numpy inputs.  Block overrides push the Pallas side through its
tail blocks and multi-tile paths.  Tolerance: the reference's own
``rtol=atol=1e-4`` (tests/test_backend_conformance.py).

``test_kernels_match_plain_on_gpu`` (marker ``gpu``) compares each CUDA
kernel with its plain version on the card; ``test_fused_kernels_on_gpu``
and ``test_matmul_on_gpu`` hold ``depthwise_kxk``, ``fuseconv_fused`` and
``matmul`` (and ``test_fuse_stage_on_gpu`` the FuSe stage) to their plain
versions at every kernel shape that the paper networks launch in
``fuse_half``, ``fuse_full`` and ``depthwise`` (buckets 8 and 1) and at
every edge of their tilings, with a bitwise repeat and one launch per
call.  They skip where there is no card.
``test_matmul_tiling_fits_the_card`` checks the SGEMM's tile picker on the
CPU.
"""
import numpy as np
import pytest
import torch

from repro.kernels import fuse1d as jfuse1d
from repro.kernels import fused as jfused
from repro.kernels import matmul as jmatmul
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import backend as tkb
from repro_torch.kernels import fuse1d as tfuse1d
from repro_torch.kernels import fused as tfused
from repro_torch.kernels import matmul as tmatmul
from repro_torch.kernels import ops as tops
from repro_torch.vision import zoo as tzoo

RTOL = ATOL = 1e-4


def _x(shape, seed=0, scale=1.0):
    return np.asarray(np.random.default_rng(seed).standard_normal(shape)
                      * scale, np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _all_close(port_fns, refs):
    """Every port output (a tensor) matches every reference (jax/numpy)."""
    for got in port_fns:
        for ref in refs:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(37, 19, 23), (130, 129, 5), (1, 16, 64)])
def test_matmul_matches_pallas_and_ref(m, k, n):
    a, b = _x((m, k)), _x((k, n), seed=1, scale=0.3)
    pallas = jmatmul.matmul(a, b, block_m=32, block_n=16, block_k=32,
                            interpret=True)
    _all_close([tmatmul.matmul_plain(_t(a), _t(b)),
                tmatmul.matmul(_t(a), _t(b))],
               [pallas, jref.matmul_ref(a, b)])


# ---------------------------------------------------------------------------
# fuse1d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,t,c,k", [(3, 11, 5, 3), (2, 7, 37, 5),
                                     (4, 2, 3, 5)])
def test_fuse1d_matches_pallas_and_ref(n, t, c, k):
    x_pad, w = _x((n, t + k - 1, c)), _x((k, c), seed=1, scale=0.5)
    pallas = jfuse1d.fuse1d(x_pad, w, block_c=16, interpret=True)
    _all_close([tfuse1d.fuse1d_plain(_t(x_pad), _t(w)),
                tfuse1d.fuse1d(_t(x_pad), _t(w))],
               [pallas, jref.fuse1d_ref(x_pad, w)])


@pytest.mark.parametrize("h,w,c,k,stride", [(8, 8, 4, 3, 1), (13, 7, 6, 5, 1),
                                            (16, 10, 4, 3, 2),
                                            (11, 13, 5, 5, 2)])
def test_fuse_conv2d_ops_match_pallas_ops(h, w, c, k, stride):
    """The rows/cols reduction onto fuse1d (ops.py) against the JAX ops
    wrappers (Pallas in interpret mode)."""
    x = _x((2, h, w, c))
    w_row, w_col = _x((k, c), seed=1, scale=0.5), _x((k, c), seed=2, scale=0.5)
    _all_close([tops.fuse_conv2d_full(_t(x), _t(w_row), _t(w_col),
                                      stride=stride)],
               [jops.fuse_conv2d_full(x, w_row, w_col, stride=stride,
                                      interpret=True)])
    c_r = c // 2
    _all_close([tops.fuse_conv2d_half(_t(x), _t(w_row[:, :c_r]),
                                      _t(w_col[:, c_r:]), stride=stride)],
               [jops.fuse_conv2d_half(x, w_row[:, :c_r], w_col[:, c_r:],
                                      stride=stride, interpret=True)])


# (h, w, c, k, stride): even and odd extents at stride 1 and 2, K 3, 5, 7
# and a K with no instantiation of its own (4), H or W below K, an odd row
# bank (c_r = C // 2 odd), C not a multiple of 4, and a 1x1 image.
STAGE_GRID = [(8, 8, 8, 3, 1), (13, 7, 6, 5, 1), (16, 10, 12, 3, 2),
              (11, 13, 5, 5, 2), (9, 12, 14, 7, 2), (3, 9, 10, 5, 1),
              (6, 2, 7, 7, 2), (10, 11, 16, 4, 2), (1, 1, 4, 3, 2)]


@pytest.mark.parametrize("h,w,c,k,stride", STAGE_GRID)
def test_fuse_stage_matches_pallas_ops(h, w, c, k, stride):
    """The FuSe stage (``fuse1d.fuse_stage``, its plain version, and the
    ``ops`` wrappers on the CPU) against the JAX ops wrappers, which run
    the Pallas ``fuse1d`` in interpret mode: fuse_half and fuse_full, and
    each bank alone."""
    x = _x((2, h, w, c))
    w_row, w_col = _x((k, c), seed=1, scale=0.5), _x((k, c), seed=2, scale=0.5)
    tx, tr, tc = _t(x), _t(w_row), _t(w_col)
    full = jops.fuse_conv2d_full(x, w_row, w_col, stride=stride,
                                 interpret=True)
    _all_close([tfuse1d.fuse_stage_plain(tx, tr, tc, variant="fuse_full",
                                         stride=stride),
                tfuse1d.fuse_stage(tx, tr, tc, variant="fuse_full",
                                   stride=stride),
                tops.fuse_conv2d_full(tx, tr, tc, stride=stride)], [full])
    c_r = c // 2
    half = jops.fuse_conv2d_half(x, w_row[:, :c_r], w_col[:, c_r:],
                                 stride=stride, interpret=True)
    hr, hc = _t(w_row[:, :c_r]), _t(w_col[:, c_r:])
    _all_close([tfuse1d.fuse_stage_plain(tx, hr, hc, stride=stride),
                tfuse1d.fuse_stage(tx, hr, hc, variant="fuse_half",
                                   stride=stride),
                tops.fuse_conv2d_half(tx, hr, hc, stride=stride)], [half])
    # each bank alone is the first or second half of fuse_full's output
    _all_close([tops.fuse_conv2d_rows(tx, tr, stride=stride)],
               [np.asarray(full)[..., :c]])
    _all_close([tops.fuse_conv2d_cols(tx, tc, stride=stride)],
               [np.asarray(full)[..., c:]])


def test_fuse_stage_checks_its_banks():
    x = torch.zeros(1, 5, 5, 6)
    with pytest.raises(ValueError):      # banks do not cover C
        tfuse1d.fuse_stage(x, torch.zeros(3, 3), torch.zeros(3, 2))
    with pytest.raises(ValueError):      # fuse_full needs C in each bank
        tfuse1d.fuse_stage(x, torch.zeros(3, 3), torch.zeros(3, 3),
                           variant="fuse_full")
    with pytest.raises(ValueError):      # taps differ between the banks
        tfuse1d.fuse_stage(x, torch.zeros(3, 3), torch.zeros(5, 3))
    with pytest.raises(ValueError):
        tfuse1d.fuse_stage(x.double(), torch.zeros(3, 3), torch.zeros(3, 3))


def _stage_shapes(batch):
    """(b, oh, ow, c_sp, k, stride) of the FuSe stages MobileNetV3-Large
    (224 px, width 1.0) runs at ``batch``."""
    net = tzoo.mobilenet_v3_large()
    return sorted({(sh["b"], -(-sh["h"] // sh["stride"]),
                    -(-sh["w"] // sh["stride"]), sh["c"], sh["k"],
                    sh["stride"])
                   for name, sh in tzoo.kernel_launches(net, "fuse_half",
                                                        batch)
                   if name == "fuse1d"})


@pytest.mark.parametrize("vec", [4, 1])
@pytest.mark.parametrize("batch", [8, 1])
def test_stage_launches_fill_the_card(batch, vec):
    """Every main-path stage at bucket 8 starts at least a block per SM:
    the stage kernel's grid is one thread per output vector, 256 threads
    (csrc/fuse1d.cu::THREADS) a block."""
    shapes = _stage_shapes(batch)
    assert shapes
    for b, oh, ow, c_sp, k, stride in shapes:
        assert c_sp % 4 == 0
        blocks = -(-b * oh * ow * (c_sp // vec) // 256)
        assert blocks >= (tfused.SMS if batch == 8 else 1)


# ---------------------------------------------------------------------------
# depthwise_kxk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,c,k,stride", [(8, 8, 5, 3, 1), (13, 7, 9, 5, 2),
                                            (16, 10, 6, 3, 2),
                                            (11, 17, 7, 5, 1),
                                            # K = 7 with C = 37 and H < K;
                                            # a 1x1 image
                                            (3, 9, 37, 7, 2),
                                            (1, 1, 6, 3, 2)])
def test_depthwise_kxk_matches_pallas_and_ref(h, w, c, k, stride):
    x, wt = _x((2, h, w, c)), _x((k, k, c), seed=9, scale=0.5)
    pallas = jfused.depthwise_kxk(x, wt, stride=stride, block_c=4,
                                  block_h=4, interpret=True)
    _all_close([tfused.depthwise_kxk_plain(_t(x), _t(wt), stride=stride),
                tfused.depthwise_kxk(_t(x), _t(wt), stride=stride)],
               [pallas, jref.depthwise_kxk_ref(x, wt, stride=stride)])


# ---------------------------------------------------------------------------
# fuseconv_fused
# ---------------------------------------------------------------------------

FUSED_GRID = [
    # (h, w, c, k, stride, variant, cout, act): odd, even and prime
    # extents, K 3 and 5, both variants, every activation, and channel /
    # Cout counts that divide no block (Pallas block_cout=8 below, CUDA 64)
    (8, 8, 6, 3, 1, "fuse_full", 10, "linear"),
    (13, 7, 5, 5, 2, "fuse_half", 7, "relu"),
    (16, 10, 6, 3, 2, "fuse_full", 12, "relu6"),
    (11, 13, 7, 5, 1, "fuse_half", 9, "hswish"),
    (7, 7, 3, 3, 2, "fuse_half", 5, "hswish"),
    (5, 17, 4, 5, 2, "fuse_full", 3, "relu"),
    # K = 7 with C = 37, H < K and fuse_full at Cout > 64; a 1x1 image
    (3, 9, 37, 7, 2, "fuse_full", 72, "hswish"),
    (1, 1, 6, 3, 2, "fuse_full", 7, "relu"),
]


@pytest.mark.parametrize("h,w,c,k,stride,variant,cout,act", FUSED_GRID)
def test_fuseconv_fused_matches_pallas_and_ref(h, w, c, k, stride, variant,
                                               cout, act):
    x = _x((2, h, w, c))
    c_r = c if variant == "fuse_full" else c // 2
    c_c = c if variant == "fuse_full" else c - c_r
    c_sp = c_r + c_c
    w_row, w_col = _x((k, c_r), 1, 0.5), _x((k, c_c), 2, 0.5)
    w_pw = _x((c_sp, cout), 3, 0.3)
    g, b = _x((c_sp,), 4, 0.2) + 1.0, _x((c_sp,), 5, 0.1)
    kw = dict(variant=variant, stride=stride, act=act)
    pallas = jfused.fuseconv_fused(x, w_row, w_col, w_pw, scale=g, bias=b,
                                   block_cout=8, block_h=4, interpret=True,
                                   **kw)
    ref = jref.fuseconv_fused_ref(x, w_row, w_col, w_pw, scale=g, bias=b,
                                  **kw)
    targs = (_t(x), _t(w_row), _t(w_col), _t(w_pw))
    _all_close([tfused.fuseconv_fused_plain(*targs, scale=_t(g), bias=_t(b),
                                            **kw),
                tfused.fuseconv_fused(*targs, scale=_t(g), bias=_t(b), **kw)],
               [pallas, ref])


def test_fuseconv_fused_default_affine_is_identity():
    x = _x((1, 6, 5, 4))
    w_row, w_col, w_pw = _x((3, 2), 1), _x((3, 2), 2), _x((4, 3), 3)
    ref = jref.fuseconv_fused_ref(x, w_row, w_col, w_pw, variant="fuse_half")
    _all_close([tfused.fuseconv_fused(_t(x), _t(w_row), _t(w_col), _t(w_pw),
                                      variant="fuse_half")], [ref])


# ---------------------------------------------------------------------------
# Wrapper contract: checks, CPU dispatch, launch counters, backends
# ---------------------------------------------------------------------------

def test_wrappers_check_inputs():
    a = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        tmatmul.matmul(a.double(), torch.zeros(3, 2).double())
    with pytest.raises(ValueError):
        tmatmul.matmul(a, torch.zeros(2, 3).t())        # not contiguous
    with pytest.raises(ValueError):
        tmatmul.matmul(a, torch.zeros(4, 2))            # shapes
    with pytest.raises(ValueError):
        tfuse1d.fuse1d(torch.zeros(2, 2, 3), torch.zeros(3, 3))  # T < 1
    with pytest.raises(ValueError):
        tfused.depthwise_kxk(torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 2))
    with pytest.raises(ValueError):
        tfused.fuseconv_fused(torch.zeros(1, 4, 4, 4), torch.zeros(3, 2),
                              torch.zeros(3, 2), torch.zeros(4, 2),
                              variant="fuse_half", act="gelu")


def test_cpu_dispatch_launches_nothing():
    tops.reset_launch_counts()
    x = torch.randn(1, 6, 6, 4)
    tops.pointwise(x, torch.randn(4, 3))
    tops.fuse_conv2d_half(x, torch.randn(3, 2), torch.randn(3, 2))
    tops.depthwise_kxk(x, torch.randn(3, 3, 4))
    tops.fuseconv_fused(x, torch.randn(3, 2), torch.randn(3, 2),
                        torch.randn(4, 5), variant="fuse_half")
    assert tops.launch_counts() == {"fuseconv_fused": 0, "fuse1d": 0,
                                    "matmul": 0, "depthwise_kxk": 0}


def test_backend_keys():
    assert tkb.BACKEND_KEYS == ("torch", "cuda", "cuda_nofused")
    for key in tkb.BACKEND_KEYS:
        assert tkb.resolve_backend(key).key == key
    assert tkb.resolve_backend(None) is tkb.TORCH
    assert not tkb.CUDA_NOFUSED.fused and tkb.CUDA.use_kernels
    with pytest.raises(ValueError):
        tkb.resolve_backend("triton")


# (b, oh, ow, c, k, stride): the main path's widest and narrowest output
# extents, and K up to the largest that any tiling fits.
TILING_SHAPES = [(8, 112, 112, 192, 3, 1), (8, 56, 56, 72, 5, 2),
                 (1, 7, 7, 960, 7, 1), (2, 20, 20, 32, 15, 2),
                 (8, 56, 56, 64, 31, 2), (1, 1, 1, 37, 51, 1)]


@pytest.mark.parametrize("b,oh,ow,c,k,stride", TILING_SHAPES)
@pytest.mark.parametrize("vec", [4, 1])
def test_tilings_fit_shared_memory(b, oh, ow, c, k, stride, vec):
    """The tile pickers keep a launch's dynamic shared memory within the
    H100's opt-in and every tiling within what the C entry points accept;
    a K that fits in no tiling is refused."""
    smem = tfused.SMEM_OPTIN
    for cout in (8, 16, 24, 45, 80, 160):
        th, tw, nt, px, stages, ksplit, fk = t = tfused.fused_tiling(
            b, oh, ow, c, cout, k, stride, vec, smem)
        assert tfused.fused_smem_bytes(*t, k, stride, c, vec) <= smem
        assert tw & (tw - 1) == 0 and nt % 4 == 0 and fk in (16, 32)
        assert (nt // 4 * px) % 32 == 0 and nt // 4 * px * ksplit <= 512
        assert px * 4 >= th * tw and 2 <= stages <= 8 and 1 <= ksplit <= 3
    th, tw, cc, threads, stages = tfused.depthwise_tiling(
        b, oh, ow, c, k, stride, vec, smem)
    assert tfused.depthwise_smem_bytes(th, tw, cc, stages, k, stride) <= smem
    assert tw % 4 == 0 and cc % 4 == 0 and cc // vec & (cc // vec - 1) == 0
    assert threads <= 256 and threads % (cc // vec) == 0 and 2 <= stages <= 4
    with pytest.raises(ValueError):
        tfused.depthwise_tiling(b, oh, ow, c, 61, stride, vec, smem)
    with pytest.raises(ValueError):
        tfused.fused_tiling(b, oh, ow, c, 24, 199, stride, vec, smem)


@pytest.mark.gpu
def test_kernels_match_plain_on_gpu():
    """Each CUDA kernel against its plain version on the card, at a ragged
    shape and a MobileNetV3-Large shape (the kernels build at first use)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def check(got, ref):
        torch.cuda.synchronize()
        tol = 1e-4 * max(1.0, ref.abs().max().item())
        assert got.shape == ref.shape
        assert (got - ref).abs().max().item() <= tol

    before = tops.launch_counts()
    for m, k, n in [(1001, 37, 75), (8 * 56 * 56, 24, 72)]:
        a, b = r(m, k), r(k, n)
        check(tmatmul.matmul(a, b), tmatmul.matmul_plain(a, b))
    for n, t, c, k in [(7, 13, 5, 3), (8 * 28, 28, 60, 5)]:
        x, w = r(n, t + k - 1, c), r(k, c)
        check(tfuse1d.fuse1d(x, w), tfuse1d.fuse1d_plain(x, w))
    for shape, k, s in [((3, 13, 10, 37), 5, 2), ((8, 56, 56, 72), 3, 1)]:
        x, w = r(*shape), r(k, k, shape[-1])
        check(tfused.depthwise_kxk(x, w, stride=s),
              tfused.depthwise_kxk_plain(x, w, stride=s))
    for shape, k, s, variant, cout, act in [
            ((2, 13, 11, 37), 5, 2, "fuse_full", 45, "hswish"),
            ((8, 56, 56, 72), 3, 1, "fuse_half", 24, "relu")]:
        c = shape[-1]
        c_r = c if variant == "fuse_full" else c // 2
        c_sp = 2 * c if variant == "fuse_full" else c
        args = (r(*shape), r(k, c_r), r(k, c_sp - c_r), r(c_sp, cout))
        kw = dict(variant=variant, stride=s, scale=r(c_sp), bias=r(c_sp),
                  act=act)
        check(tfused.fuseconv_fused(*args, **kw),
              tfused.fuseconv_fused_plain(*args, **kw))
    after = tops.launch_counts()
    assert all(after[name] == before[name] + 2 for name in after)


def _main_path_cases(names=("fuseconv_fused", "depthwise_kxk"),
                     batches=(8, 1)):
    """Distinct (kernel, shape) of the launches of the kernels ``names``
    that every paper network (224 px, width 1.0) makes at ``batches`` in
    ``fuse_half``, ``fuse_full`` and ``depthwise``."""
    seen = {}
    for batch in batches:
        for factory in tzoo.ZOO.values():
            net = factory()
            for variant in ("fuse_half", "fuse_full", "depthwise"):
                for name, shape in tzoo.kernel_launches(net, variant,
                                                        batch):
                    if name in names:
                        seen.setdefault((name, tuple(shape.items())),
                                        (name, shape))
    return list(seen.values())


def _dw(b, h, w, c, k, stride, **extra):
    return ("depthwise_kxk", dict(b=b, h=h, w=w, c=c, k=k, stride=stride,
                                  **extra))


def _fu(b, h, w, c, k, stride, variant, cout, act, **extra):
    return ("fuseconv_fused", dict(b=b, h=h, w=w, c=c, k=k, stride=stride,
                                   variant=variant, cout=cout, act=act,
                                   **extra))


# Edges of the tilings: tiles straddling every border, extents below one
# tile and below K, a 1x1 image, C % 4 != 0, Cout 45 and 160 (fuse_full)
# and 124 (31 lanes of 4, no thread count divisible by a warp),
# K = 7 and a K the kernels have no instantiation for, stride 2 on odd and
# even extents, every activation, an input that is not 16-byte aligned,
# and shapes whose first-choice tiling exceeds the shared-memory opt-in.
GPU_EDGES = [
    _dw(2, 37, 29, 64, 3, 1), _dw(2, 37, 29, 64, 3, 2),
    _dw(2, 38, 30, 64, 3, 2), _dw(3, 5, 3, 32, 3, 1),
    _dw(2, 2, 9, 16, 5, 1), _dw(2, 1, 1, 24, 3, 2), _dw(2, 1, 1, 24, 7, 1),
    _dw(3, 13, 10, 37, 5, 2), _dw(2, 9, 11, 37, 3, 1),
    _dw(2, 20, 17, 40, 7, 1), _dw(2, 21, 18, 40, 7, 2),
    _dw(2, 9, 9, 16, 1, 2), _dw(2, 15, 14, 36, 3, 2, offset=1),
    _fu(2, 37, 29, 64, 3, 1, "fuse_half", 24, "relu"),
    _fu(2, 37, 29, 64, 3, 2, "fuse_half", 24, "relu6"),
    _fu(2, 38, 30, 64, 3, 2, "fuse_full", 16, "hswish"),
    _fu(2, 2, 9, 16, 5, 1, "fuse_half", 16, "relu6"),
    _fu(2, 1, 1, 32, 3, 2, "fuse_full", 16, "hswish"),
    _fu(3, 5, 3, 32, 3, 1, "fuse_half", 8, "linear"),
    _fu(2, 13, 11, 37, 5, 2, "fuse_full", 45, "hswish"),
    _fu(2, 13, 11, 40, 3, 1, "fuse_full", 160, "linear"),
    _fu(2, 20, 17, 32, 7, 2, "fuse_half", 24, "relu"),
    _fu(2, 19, 12, 38, 3, 1, "fuse_half", 20, "relu"),
    _fu(2, 12, 12, 24, 4, 2, "fuse_half", 12, "hswish"),
    _fu(2, 9, 9, 16, 3, 1, "fuse_half", 124, "relu"),
    _fu(2, 15, 14, 36, 3, 2, "fuse_half", 24, "relu", offset=1),
    # tilings the shared-memory limit cuts down: the ring, the split, cc
    _fu(8, 112, 112, 192, 3, 1, "fuse_half", 16, "relu"),
    _fu(8, 112, 112, 192, 3, 1, "fuse_half", 8, "linear"),
    _dw(2, 40, 40, 32, 15, 2), _dw(2, 23, 21, 40, 31, 1),
]


def _case_id(case):
    name, sh = case
    extra = f"-v{sh['variant']}-o{sh['cout']}-{sh['act']}" \
        if name == "fuseconv_fused" else ""
    off = "-unaligned" if sh.get("offset") else ""
    return (f"{name}-b{sh['b']}-{sh['h']}x{sh['w']}x{sh['c']}-k{sh['k']}"
            f"s{sh['stride']}{extra}{off}")


@pytest.mark.gpu
@pytest.mark.parametrize("case", _main_path_cases() + GPU_EDGES,
                         ids=_case_id)
def test_fused_kernels_on_gpu(case):
    """``depthwise_kxk`` / ``fuseconv_fused`` against the plain version at
    ``1e-4 * max(1, max|plain|)``; a second call on the same input must be
    bitwise equal, and each call adds exactly one launch."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    name, sh = case
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def r(*shape, scale=1.0, offset=0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        buf = torch.empty(a.size + offset, device=dev)
        t = buf[offset:].view(shape)
        t.copy_(torch.from_numpy(a))
        return t

    x = r(sh["b"], sh["h"], sh["w"], sh["c"], offset=sh.get("offset", 0))
    k, c = sh["k"], sh["c"]
    if name == "depthwise_kxk":
        w = r(k, k, c, scale=0.3)
        fn = tfused.depthwise_kxk
        args, kw = (x, w), dict(stride=sh["stride"])
        plain = tfused.depthwise_kxk_plain(*args, **kw)
    else:
        c_r = c if sh["variant"] == "fuse_full" else c // 2
        c_sp = 2 * c if sh["variant"] == "fuse_full" else c
        args = (x, r(k, c_r, scale=0.5), r(k, c_sp - c_r, scale=0.5),
                r(c_sp, sh["cout"], scale=0.2))
        kw = dict(variant=sh["variant"], stride=sh["stride"],
                  scale=r(c_sp, scale=0.5), bias=r(c_sp), act=sh["act"])
        fn = tfused.fuseconv_fused
        plain = tfused.fuseconv_fused_plain(*args, **kw)
    before = fn.launches
    got = fn(*args, **kw)
    again = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert got.shape == plain.shape
    tol = 1e-4 * max(1.0, plain.abs().max().item())
    assert (got - plain).abs().max().item() <= tol
    assert torch.equal(got, again)


# The H100's shared-memory opt-in and SM count, for the CPU tiling tests.
H100_SMEM, H100_SMS = 232448, 132


@pytest.mark.parametrize("vec", [4, 1])
@pytest.mark.parametrize("batch", [8, 4, 2, 1])
def test_matmul_tiling_fits_the_card(batch, vec):
    """At every main-path matmul shape the picked tiling is one
    ``repro_matmul_f32`` accepts, fits the H100's shared-memory opt-in,
    leaves at most an eighth of the tile columns idle where N % 8 == 0,
    launches at least one block per SM (counting the K split) wherever
    16 x 16 tiles would, and at bucket 8 gives each block half a warp or
    more."""
    for _, sh in _main_path_cases(("matmul",), (batch,)):
        m, k, n = sh["m"], sh["k"], sh["n"]
        bm, bn, bk, tm, stages, ks = tmatmul.matmul_tiling(
            m, n, k, vec, H100_SMS, H100_SMEM)
        assert bk in (16, 32) and tm in (4, 8) and bm % tm == 0
        assert bn % 4 == 0 and (bm // tm) * (bn // 4) <= tmatmul.MAX_THREADS
        assert 2 <= stages <= tmatmul.MAX_STAGES
        assert 1 <= ks <= min(tmatmul.MAX_SPLIT, max(1, -(-k // bk)))
        assert tmatmul.matmul_smem_bytes(bm, bn, bk, stages, ks) <= H100_SMEM
        cols = -(-n // bn) * bn
        if n % 8 == 0:
            assert 8 * (cols - n) <= cols, (sh, bn)
        blocks = -(-m // bm) * -(-n // bn) * ks
        if -(-m // 16) * -(-n // 16) >= H100_SMS:
            assert blocks >= H100_SMS, (sh, (bm, bn, ks), blocks)
        if batch == 8:
            # the fallback once took 4 x 4 tiles, blocks of one thread, at
            # MobileNetV3-Small's (6272, 88) @ (88, 24): 9x the library
            assert (bm // tm) * (bn // 4) >= 16, (sh, (bm, bn, tm))


def test_matmul_tiling_refuses_what_does_not_fit():
    """A shared-memory budget no tiling fits raises ``ValueError``; a
    small one that some tiling fits is kept to."""
    with pytest.raises(ValueError):
        tmatmul.matmul_tiling(1568, 112, 672, 4, H100_SMS, 1024)
    bm, bn, bk, _, stages, ks = t = tmatmul.matmul_tiling(
        1568, 112, 672, 4, H100_SMS, 8192)
    assert tmatmul.matmul_smem_bytes(bm, bn, bk, stages, ks) <= 8192, t


# Edges of the SGEMM: M below one tile and M = 1, M and N that no tile
# divides (K = 37, N = 75), K = 0 and 1, N = 1, K % 4 != 0, an a whose base
# is one float off 16-byte alignment, and a deep K that the split walks.
MATMUL_EDGES = [(7, 16, 8), (1, 16, 64), (1001, 37, 75), (5, 1, 3),
                (5, 0, 3), (300, 1, 1), (33, 20, 1), (130, 129, 5),
                (2000, 12, 36), (64, 4096, 64), (999, 401, 117)]
MATMUL_GPU_CASES = (
    [(sh["m"], sh["k"], sh["n"], 0)
     for _, sh in _main_path_cases(("matmul",))]
    + [(m, k, n, 0) for m, k, n in MATMUL_EDGES]
    + [(1001, 36, 72, 1), (392, 960, 160, 1)])


@pytest.mark.gpu
@pytest.mark.parametrize(
    "m,k,n,offset", MATMUL_GPU_CASES,
    ids=[f"{m}x{k}x{n}" + ("-unaligned" if o else "")
         for m, k, n, o in MATMUL_GPU_CASES])
def test_matmul_on_gpu(m, k, n, offset):
    """``matmul`` against ``matmul_plain`` at ``1e-4 * max(1, max|plain|)``;
    a second call on the same input must be bitwise equal, and each call
    adds exactly one launch."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((m, k)).astype(np.float32)
    buf = torch.empty(a_np.size + offset, device=dev)
    a = buf[offset:].view(m, k)
    a.copy_(torch.from_numpy(a_np))
    b = torch.from_numpy(
        (rng.standard_normal((k, n)) * 0.25).astype(np.float32)).to(dev)
    plain = tmatmul.matmul_plain(a, b)
    before = tmatmul.matmul.launches
    got = tmatmul.matmul(a, b)
    again = tmatmul.matmul(a, b)
    torch.cuda.synchronize()
    assert tmatmul.matmul.launches == before + 2
    assert got.shape == plain.shape
    tol = 1e-4 * max(1.0, plain.abs().max().item())
    assert (got - plain).abs().max().item() <= tol
    assert torch.equal(got, again)


def _st(b, h, w, c, k, stride, variant, **extra):
    return dict(b=b, h=h, w=w, c=c, k=k, stride=stride, variant=variant,
                **extra)


# Edges of the stage kernel: C and c_r not multiples of 4 (the 4-byte
# instantiation), an odd row bank, H or W below K, a 1x1 image, K = 4, 31
# and 61 (the runtime-K instantiation), stride 2 over even and odd extents,
# and an input that is not 16-byte aligned.
STAGE_EDGES = [
    _st(2, 13, 11, 37, 5, 2, "fuse_full"), _st(2, 13, 11, 37, 5, 2,
                                               "fuse_half"),
    _st(2, 9, 7, 38, 3, 1, "fuse_half"), _st(2, 2, 9, 16, 5, 1, "fuse_half"),
    _st(2, 9, 3, 16, 7, 2, "fuse_half"), _st(2, 1, 1, 24, 3, 2, "fuse_full"),
    _st(2, 12, 12, 24, 4, 2, "fuse_half"),
    _st(2, 38, 30, 64, 3, 2, "fuse_full"),
    _st(2, 37, 29, 64, 5, 1, "fuse_half"),
    _st(2, 15, 14, 36, 3, 2, "fuse_half", offset=1),
    _st(1, 20, 20, 32, 31, 1, "fuse_half"),
    _st(64, 24, 24, 64, 61, 2, "fuse_half"),
]
STAGE_GPU_CASES = [sh for _, sh in _main_path_cases(("fuse1d",))] \
    + STAGE_EDGES


def _stage_id(sh):
    off = "-unaligned" if sh.get("offset") else ""
    return (f"b{sh['b']}-{sh['h']}x{sh['w']}x{sh['c']}-k{sh['k']}"
            f"s{sh['stride']}-{sh['variant']}{off}")


@pytest.mark.gpu
@pytest.mark.parametrize("sh", STAGE_GPU_CASES, ids=_stage_id)
def test_fuse_stage_on_gpu(sh):
    """``fuse_stage`` against ``fuse_stage_plain`` at
    ``1e-4 * max(1, max|plain|)``, at every main-path FuSe stage of buckets
    8 and 1 and at the kernel's edges; a second call must be bitwise equal
    to the first, and each call is one launch."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    b, h, w, c, k = (sh[key] for key in "bhwck")
    off = sh.get("offset", 0)
    buf = torch.empty(b * h * w * c + off, device=dev)
    x = buf[off:].view(b, h, w, c)
    x.copy_(torch.from_numpy(rng.standard_normal((b, h, w, c))
                             .astype(np.float32)))
    full = sh["variant"] == "fuse_full"
    c_r = c if full else c // 2
    w_row, w_col = (torch.from_numpy(
        (rng.standard_normal((k, n)) * 0.5).astype(np.float32)).to(dev)
        for n in (c_r, c if full else c - c_r))
    kw = dict(variant=sh["variant"], stride=sh["stride"])
    plain = tfuse1d.fuse_stage_plain(x, w_row, w_col, **kw)
    before = tfuse1d.fuse1d.launches
    got = tfuse1d.fuse_stage(x, w_row, w_col, **kw)
    again = tfuse1d.fuse_stage(x, w_row, w_col, **kw)
    torch.cuda.synchronize()
    assert tfuse1d.fuse1d.launches == before + 2
    assert got.shape == plain.shape
    tol = 1e-4 * max(1.0, plain.abs().max().item())
    assert (got - plain).abs().max().item() <= tol
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("n,t,c,k", [(448, 59, 36, 5), (7, 15, 5, 3),
                                     (3, 4, 8, 4), (2, 9, 3, 1)])
def test_fuse1d_on_gpu(n, t, c, k):
    """The 1-D form (the stage kernel's row bank with no halo) against
    ``fuse1d_plain``, with a bitwise repeat and one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, t, c, generator=gen).cuda()
    w = torch.randn(k, c, generator=gen).cuda()
    plain = tfuse1d.fuse1d_plain(x, w)
    before = tfuse1d.fuse1d.launches
    got, again = tfuse1d.fuse1d(x, w), tfuse1d.fuse1d(x, w)
    torch.cuda.synchronize()
    assert tfuse1d.fuse1d.launches == before + 2
    tol = 1e-4 * max(1.0, plain.abs().max().item())
    assert (got - plain).abs().max().item() <= tol
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["fuse_half", "fuse_full"])
def test_fuse_stage_is_one_device_kernel(variant):
    """``ops.fuse_conv2d_half``/``full`` on CUDA tensors run one device
    kernel (the stage kernel) and no copy, pad or concat, as the profiler
    sees it, and count one ``fuse1d`` launch."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 56, 56, 72, generator=gen).cuda()
    c_r = 72 if variant == "fuse_full" else 36
    w_row = torch.randn(5, c_r, generator=gen).cuda()
    w_col = torch.randn(5, 72 - c_r if c_r == 36 else 72,
                        generator=gen).cuda()
    op = (tops.fuse_conv2d_full if variant == "fuse_full"
          else tops.fuse_conv2d_half)
    op(x, w_row, w_col, stride=2)
    torch.cuda.synchronize()
    before = tfuse1d.fuse1d.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        op(x, w_row, w_col, stride=2)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    assert tfuse1d.fuse1d.launches == before + 1
    assert sum(e.count for e in rows) == 1, [e.key for e in rows]
    assert "stage_direct_kernel" in rows[0].key
