"""The port's four kernel modules against the JAX package's Pallas kernels.

For each kernel — ``matmul``, ``fuse1d``, ``depthwise_kxk`` and
``fuseconv_fused`` — the port's plain PyTorch version and its wrapper (on a
CPU tensor the wrapper runs the plain version) are held against the Pallas
kernel in interpret mode and against its ``repro.kernels.ref`` oracle, on
the same numpy inputs.  Block overrides push the Pallas side through its
tail blocks and multi-tile paths.  Tolerance: the reference's own
``rtol=atol=1e-4`` (tests/test_backend_conformance.py).

``test_kernels_match_plain_on_gpu`` (marker ``gpu``) compares each CUDA
kernel with its plain version on the card; it skips where there is none.
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


# ---------------------------------------------------------------------------
# depthwise_kxk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,c,k,stride", [(8, 8, 5, 3, 1), (13, 7, 9, 5, 2),
                                            (16, 10, 6, 3, 2),
                                            (11, 17, 7, 5, 1)])
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
