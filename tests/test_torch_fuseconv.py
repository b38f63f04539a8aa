"""The port's plain FuSeConv ops (``repro_torch.core.fuseconv``) against the
JAX reference (``repro.core.fuseconv``) on the same numpy inputs.

Tolerance: the reference's own ``rtol=atol=1e-4``
(tests/test_backend_conformance.py).  The grid is the conformance
harness's ``FAST_GRID`` plus stride-2 cases on even extents, where XLA's
SAME split (low side ``pad_total // 2``) differs from symmetric padding.
The harness's ``SLOW_GRID`` (48 cases, marked ``slow`` as the reference
marks it) holds the port's FuSe 2-D ops, plain and through the kernel
wrappers' CPU dispatch, to the JAX package's ops (the Pallas wrappers in
interpret mode) and to its lax reference.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import fuseconv as jfc
from repro.kernels import ops as jops
from repro_torch.core import fuseconv as tfc
from repro_torch.kernels import ops as tops

RTOL = ATOL = 1e-4

FAST_GRID = [
    # (h, w, c, k, stride) — tests/test_backend_conformance.py FAST_GRID
    (8, 8, 4, 3, 1),
    (13, 7, 6, 5, 1),
    (16, 10, 4, 3, 2),
]
EVEN_STRIDE2 = [(16, 10, 4, 3, 2), (8, 8, 3, 5, 2), (12, 6, 5, 3, 2)]
SLOW_GRID = [
    # tests/test_backend_conformance.py SLOW_GRID
    (h, w, c, k, s)
    for (h, w) in [(7, 7), (8, 8), (11, 13), (16, 16), (20, 12), (5, 17)]
    for c in (3, 8)
    for k in (3, 5)
    for s in (1, 2)
]


def _x(shape, seed=0):
    return np.asarray(
        np.random.default_rng(seed).standard_normal(shape), np.float32)


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("h,w,c,k,stride", FAST_GRID)
def test_fuse_banks_match_jax(h, w, c, k, stride):
    x = _x((2, h, w, c))
    w_row = _x((k, c), seed=1) * 0.5
    w_col = _x((k, c), seed=2) * 0.5
    _close(tfc.fuse_conv1d_rows(_t(x), _t(w_row), stride=stride),
           jfc.fuse_conv1d_rows(x, w_row, stride=stride))
    _close(tfc.fuse_conv1d_cols(_t(x), _t(w_col), stride=stride),
           jfc.fuse_conv1d_cols(x, w_col, stride=stride))
    _close(tfc.fuse_conv2d_full(_t(x), _t(w_row), _t(w_col), stride=stride),
           jfc.fuse_conv2d_full(x, w_row, w_col, stride=stride))
    c_r = c // 2
    _close(tfc.fuse_conv2d_half(_t(x), _t(w_row[:, :c_r]),
                                _t(w_col[:, c_r:]), stride=stride),
           jfc.fuse_conv2d_half(x, w_row[:, :c_r], w_col[:, c_r:],
                                stride=stride))


@pytest.mark.slow
@pytest.mark.parametrize("h,w,c,k,stride", SLOW_GRID)
def test_fuse_ops_match_jax_grid(h, w, c, k, stride):
    """``fuse_conv2d_full`` and ``fuse_conv2d_half`` (the split of the
    reference's grid: ``c // 2`` row channels), plain and through the
    kernel wrappers, against ``repro.kernels.ops`` and
    ``repro.core.fuseconv`` on the same inputs."""
    x = _x((2, h, w, c))
    w_row = _x((k, c), seed=1) * 0.5
    w_col = _x((k, c), seed=2) * 0.5
    c_r = c // 2
    for name, args in (("fuse_conv2d_full", (w_row, w_col)),
                       ("fuse_conv2d_half", (w_row[:, :c_r],
                                             w_col[:, c_r:]))):
        targs = [_t(a) for a in (x,) + args]
        refs = (getattr(jops, name)(x, *args, stride=stride, interpret=True),
                getattr(jfc, name)(x, *args, stride=stride))
        for got in (getattr(tfc, name)(*targs, stride=stride),
                    getattr(tops, name)(*targs, stride=stride)):
            for ref in refs:
                _close(got, ref)


@pytest.mark.parametrize("h,w,c,k,stride", FAST_GRID + EVEN_STRIDE2)
def test_conv2d_and_depthwise_match_jax(h, w, c, k, stride):
    x = _x((2, h, w, c))
    w_conv = _x((k, k, c, 5), seed=3) * 0.3
    w_dw = _x((k, k, c), seed=4) * 0.3
    _close(tfc.conv2d(_t(x), _t(w_conv), stride=stride),
           jfc.conv2d(x, w_conv, stride=stride))
    _close(tfc.depthwise_conv2d(_t(x), _t(w_dw), stride=stride),
           jfc.depthwise_conv2d(x, w_dw, stride=stride))
    _close(tfc.conv2d(_t(x), _t(w_conv), stride=stride, padding="VALID"),
           jfc.conv2d(x, w_conv, stride=stride, padding="VALID"))


def test_same_split_differs_from_symmetric_on_even_extent():
    """Stride 2 over an even extent: XLA pads (0, 1) for K=3, so a
    symmetric pad of 1 would shift every output; the port must not."""
    assert tfc._same_pad(16, 3, 2) == (8, 0, 1)
    x = _x((1, 16, 10, 4))
    w = _x((3, 3, 4), seed=1)
    sym = torch.nn.functional.conv2d(
        _t(x).permute(0, 3, 1, 2), _t(w).permute(2, 0, 1).unsqueeze(1),
        stride=2, padding=1, groups=4).permute(0, 2, 3, 1)
    ref = np.asarray(jfc.depthwise_conv2d(x, w, stride=2))
    assert np.abs(sym.numpy() - ref).max() > 1e-2
    _close(tfc.depthwise_conv2d(_t(x), _t(w), stride=2), ref)


@pytest.mark.parametrize("shape,cout", [((2, 8, 8, 4), 6), ((1, 13, 7, 5), 3)])
def test_pointwise_matches_jax(shape, cout):
    x = _x(shape)
    w = _x((shape[-1], cout), seed=3) * 0.3
    _close(tfc.pointwise_conv2d(_t(x), _t(w)), jfc.pointwise_conv2d(x, w))


@pytest.mark.parametrize("variant", tfc.VARIANTS)
@pytest.mark.parametrize("stride", [1, 2])
def test_spatial_op_spec_and_apply_match_jax(variant, stride):
    c, k = 6, 3
    tspec = tfc.SpatialOpSpec(variant, k, c, stride)
    jspec = jfc.SpatialOpSpec(variant, k, c, stride)
    assert tspec.out_channels == jspec.out_channels
    assert tspec.param_count() == jspec.param_count()
    assert tspec.macs(7, 5) == jspec.macs(7, 5)
    jp = jfc.init_spatial_op(jax.random.PRNGKey(0), jspec)
    tp = tfc.init_spatial_op(torch.Generator().manual_seed(0), tspec,
                             device="cpu")
    assert {n: tuple(v.shape) for n, v in tp.items()} == \
        {n: tuple(v.shape) for n, v in jp.items()}
    x = _x((2, 10, 9, c))
    tp = {n: _t(v) for n, v in jp.items()}
    _close(tfc.apply_spatial_op(tp, tspec, _t(x)),
           jfc.apply_spatial_op(jp, jspec, x))


def test_unported_variant_and_padding_refused():
    # ``scaffold`` is ported now (tests/test_torch_nos.py); an unknown
    # variant is still refused
    assert tfc.SpatialOpSpec("scaffold", 3, 4).variant == "scaffold"
    with pytest.raises(ValueError):
        tfc.SpatialOpSpec("fuse_quarter", 3, 4)
    with pytest.raises(ValueError):
        tfc.conv2d(torch.zeros(1, 4, 4, 1), torch.zeros(3, 3, 1, 1),
                   padding="same")
