"""Every paper network in every variant: the port's zoo against
``zoo.apply_network`` of the JAX package (backend ``xla``).

Cases: MobileNet V1, V2, V3-Small and MnasNet-B1, each in ``depthwise``,
``fuse_half``, ``fuse_full`` and a hybrid per-stage list (cycling
``depthwise``, ``fuse_half``, ``fuse_full`` over the spatial stages, as
tests/test_backend_conformance.py does for ``tiny_net``), and
MobileNetV3-Large in ``fuse_full`` and the hybrid (its ``fuse_half`` and
``depthwise`` are in tests/test_torch_zoo.py).  CPU size: width 0.25,
32 px, 16 classes, batch 2, params from ``_torch_params.numpy_params``.
The port runs backends ``torch``, ``cuda`` and ``cuda_nofused`` (on CPU
tensors the kernel wrappers run their plain versions).  Tolerance: the
reference's own ``rtol=atol=1e-4``.

MobileNetV3-Large ``fuse_full`` is badly conditioned at this size: with
``numpy_params`` its logits reach a scale near 76, and float32 summation
order alone (XLA against PyTorch) moves them past the elementwise 1e-4.
It is held two ways, neither looser than 1e-4:

(a) against XLA at ``rtol=atol=1e-4`` on the reference's own parameter
    draw (``zoo.init_network``), as the conformance harness draws them;
(b) on ``numpy_params``, the port's three backends and XLA alike against
    a float64 run of the port's plain ops on the same parameters, at
    ``max|d| <= 1e-4 * max(1, max|f64|)``.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from _torch_params import jax_logits, numpy_params

from repro.vision import zoo as jzoo
from repro_torch.vision import zoo as tzoo
from repro_torch.vision.convert import params_from_numpy

RTOL = ATOL = 1e-4
BACKENDS = ("torch", "cuda", "cuda_nofused")
SMALL = dict(num_classes=16, width_mult=0.25, resolution=32)
NETS = ("mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small", "mnasnet_b1")

CASES = [(name, v) for name in NETS
         for v in ("depthwise", "fuse_half", "fuse_full", "hybrid")] \
    + [("mobilenet_v3_large", "hybrid")]


def _nets(name):
    return jzoo.ZOO[name](**SMALL), tzoo.ZOO[name](**SMALL)


def _variant(net, variant):
    if variant != "hybrid":
        return variant
    cycle = ("depthwise", "fuse_half", "fuse_full")
    return tuple(cycle[i % 3] for i in range(net.num_spatial_stages))


def _input(net, seed=0, batch=2):
    return np.asarray(np.random.default_rng(seed + 7).standard_normal(
        (batch, net.resolution, net.resolution, net.in_channels)),
        np.float32)


def _port_logits(params, tnet, x, variant):
    tparams = params_from_numpy(params, "cpu")
    return {bk: tzoo.apply_network(tparams, tnet, torch.from_numpy(x),
                                   variant, backend=bk).numpy()
            for bk in BACKENDS}


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("name,variant", CASES)
def test_logits_match_jax(name, variant):
    jnet, tnet = _nets(name)
    v = _variant(jnet, variant)
    params = numpy_params(jnet, v)
    x = _input(jnet)
    ref = jax_logits(params, jnet, x, v)
    got = _port_logits(params, tnet, x, v)
    for bk, logits in got.items():
        assert logits.shape == ref.shape and np.all(np.isfinite(logits)), bk
        np.testing.assert_allclose(logits, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=bk)
    # fused on and fused off: same logits, same top-1
    np.testing.assert_allclose(got["cuda"], got["cuda_nofused"],
                               rtol=RTOL, atol=ATOL)
    assert np.array_equal(got["cuda"].argmax(-1),
                          got["cuda_nofused"].argmax(-1))


@pytest.mark.parametrize("name,variant",
                         CASES + [("mobilenet_v3_large", "fuse_full")])
def test_ir_and_param_shapes_match_jax(name, variant):
    jnet, tnet = _nets(name)
    v = _variant(jnet, variant)
    assert [dataclasses.astuple(o) for o in tzoo.lower_to_ir(tnet, v)] \
        == [dataclasses.astuple(o) for o in jzoo.lower_to_ir(jnet, v)]
    jp = jax.eval_shape(
        lambda: jzoo.init_network(jax.random.PRNGKey(0), jnet, v))
    tp = tzoo.init_network(torch.Generator().manual_seed(0), tnet, v,
                           device="cpu")
    assert _shapes(tp) == _shapes(jp)


@functools.lru_cache(maxsize=None)
def _jitted_init(net, variant):
    return jax.jit(lambda key: jzoo.init_network(key, net, variant))


@pytest.mark.parametrize("seed", [0, 1])
def test_v3_large_fuse_full_on_the_reference_draw(seed):
    """(a): the reference's own parameter draw, elementwise 1e-4 against
    XLA on every backend."""
    jnet, tnet = _nets("mobilenet_v3_large")
    params = jax.tree_util.tree_map(
        np.asarray, _jitted_init(jnet, "fuse_full")(jax.random.PRNGKey(seed)))
    x = _input(jnet, seed)
    ref = jax_logits(params, jnet, x, "fuse_full")
    for bk, logits in _port_logits(params, tnet, x, "fuse_full").items():
        assert logits.shape == ref.shape and np.all(np.isfinite(logits)), bk
        np.testing.assert_allclose(logits, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=bk)


@pytest.mark.parametrize("seed", [0, 1])
def test_v3_large_fuse_full_against_float64(seed):
    """(b): on ``numpy_params``, the port's three backends and XLA each
    within 1e-4 of the scale of a float64 run of the port's plain ops."""
    jnet, tnet = _nets("mobilenet_v3_large")
    params = numpy_params(jnet, "fuse_full", seed)
    x = _input(jnet, seed)
    p64 = params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), params), "cpu")
    # one thread: PyTorch's float64 CPU convolutions run OpenMP loops that
    # take minutes instead of 50 ms when the test workers oversubscribe
    # the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        f64 = tzoo.apply_network(p64, tnet, torch.from_numpy(x).double(),
                                 "fuse_full", backend="torch").numpy()
    finally:
        torch.set_num_threads(threads)
    tol = 1e-4 * max(1.0, float(np.abs(f64).max()))
    got = _port_logits(params, tnet, x, "fuse_full")
    got["xla"] = jax_logits(params, jnet, x, "fuse_full")
    for who, logits in got.items():
        assert logits.shape == f64.shape and np.all(np.isfinite(logits))
        err = float(np.abs(logits.astype(np.float64) - f64).max())
        assert err <= tol, (who, err, tol)
