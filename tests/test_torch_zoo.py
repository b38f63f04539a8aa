"""Network-level parity: the port's zoo against ``zoo.apply_network`` of the
JAX package (backend ``xla``) on the same params and inputs.

Params have the structure of ``repro.vision.zoo.init_network`` and numpy
values from a seed (``_torch_params.numpy_params``, with non-trivial BN
statistics); the port gets them through
``repro_torch.vision.convert.params_from_numpy``.  Inputs are numpy from a
seed.  The port runs on the CPU with backends ``torch`` (plain
ops), ``cuda`` (the kernel wrappers' CPU dispatch: plain versions behind
the kernel path's padding, transposes and fusion) and ``cuda_nofused``.
Tolerance: the reference's own ``rtol=atol=1e-4``.
"""
import dataclasses

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


def _nets():
    return {
        "tiny_net": (jzoo.tiny_net(num_classes=8, resolution=16, width=8),
                     tzoo.tiny_net(num_classes=8, resolution=16, width=8)),
        "mobilenet_v3_large": (
            jzoo.mobilenet_v3_large(num_classes=16, width_mult=0.25,
                                    resolution=32),
            tzoo.mobilenet_v3_large(num_classes=16, width_mult=0.25,
                                    resolution=32)),
    }


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


CASES = [("tiny_net", v) for v in ("depthwise", "fuse_half", "fuse_full")] \
    + [("mobilenet_v3_large", v) for v in ("fuse_half", "depthwise")]


def _logits(name, variant, seed=0, batch=2):
    jnet, tnet = _nets()[name]
    params = numpy_params(jnet, variant, seed)
    x = np.asarray(np.random.default_rng(seed + 7).standard_normal(
        (batch, jnet.resolution, jnet.resolution, jnet.in_channels)),
        np.float32)
    ref = jax_logits(params, jnet, x, variant)
    tparams = params_from_numpy(params, "cpu")
    got = {bk: tzoo.apply_network(tparams, tnet, torch.from_numpy(x),
                                  variant, backend=bk).numpy()
           for bk in BACKENDS}
    return ref, got


@pytest.mark.parametrize("name,variant", CASES)
def test_logits_match_jax(name, variant):
    ref, got = _logits(name, variant)
    for bk, logits in got.items():
        assert logits.shape == ref.shape and np.all(np.isfinite(logits)), bk
        np.testing.assert_allclose(logits, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=bk)
    # fused on and fused off: same logits, same top-1
    np.testing.assert_allclose(got["cuda"], got["cuda_nofused"],
                               rtol=RTOL, atol=ATOL)
    assert np.array_equal(got["cuda"].argmax(-1),
                          got["cuda_nofused"].argmax(-1))


@pytest.mark.parametrize("name,variant", CASES)
def test_ir_and_param_shapes_match_jax(name, variant):
    jnet, tnet = _nets()[name]
    assert [dataclasses.astuple(o) for o in tzoo.lower_to_ir(tnet, variant)] \
        == [dataclasses.astuple(o) for o in jzoo.lower_to_ir(jnet, variant)]
    jp = jax.eval_shape(
        lambda: jzoo.init_network(jax.random.PRNGKey(0), jnet, variant))
    tp = tzoo.init_network(torch.Generator().manual_seed(0), tnet, variant,
                           device="cpu")
    assert _shapes(tp) == _shapes(jp)


def test_full_width_mbv3_large_is_the_published_config():
    """The slice's model at full published width: same block list as the
    JAX package's factory (224 px, width 1.0, 1000 classes)."""
    jnet, tnet = jzoo.mobilenet_v3_large(), tzoo.mobilenet_v3_large()
    assert (tnet.resolution, tnet.blocks[-1].classes) == (224, 1000)
    assert [dataclasses.astuple(b) for b in tnet.blocks] == \
        [dataclasses.astuple(b) for b in jnet.blocks]
    se = [b.se for b in tnet.blocks if isinstance(b, tzoo.MBConv)]
    assert (se.count(True), se.count(False)) == (8, 7)


@pytest.mark.parametrize("train", [False, True])
def test_layers_match_jax(train):
    """Functional BN (both modes, biased variance, momentum 0.9, eps 1e-5),
    its folded affine, SE and the activations against repro.vision.layers."""
    from repro.vision import layers as JL
    from repro_torch.vision import layers as TL
    rng = np.random.default_rng(3)
    x = np.asarray(rng.standard_normal((2, 5, 4, 6)) * 2, np.float32)
    p = {"scale": 1 + 0.1 * rng.standard_normal(6), "bias":
         rng.standard_normal(6), "mean": rng.standard_normal(6),
         "var": rng.uniform(0.5, 1.5, 6)}
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    tp = params_from_numpy(p, "cpu")
    ty, tnew = TL.apply_bn(tp, torch.from_numpy(x), train=train)
    jy, jnew = JL.apply_bn(p, x, train=train)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    for k in p:
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                   rtol=RTOL, atol=ATOL)
    for t, j in zip(TL.bn_inference_affine(tp), JL.bn_inference_affine(p)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                                   atol=ATOL)
    for name in TL.ACTS:
        np.testing.assert_allclose(TL.ACTS[name](torch.from_numpy(x)).numpy(),
                                   np.asarray(JL.ACTS[name](x)), rtol=RTOL,
                                   atol=ATOL)
    se = {"reduce": {"w": rng.standard_normal((6, 8)) * 0.3,
                     "b": rng.standard_normal(8) * 0.1},
          "expand": {"w": rng.standard_normal((8, 6)) * 0.3,
                     "b": rng.standard_normal(6) * 0.1}}
    se = {k: {n: np.asarray(v, np.float32) for n, v in d.items()}
          for k, d in se.items()}
    np.testing.assert_allclose(
        TL.apply_se(params_from_numpy(se, "cpu"), torch.from_numpy(x)).numpy(),
        np.asarray(JL.apply_se(se, x)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", ["fuse_half", "depthwise"])
def test_kernel_launches_lists_the_calls_apply_network_makes(
        monkeypatch, variant):
    """``zoo.kernel_launches`` (the shapes chip_smoke.py times per launch)
    against the kernel calls one forward really makes, recorded on the
    CPU."""
    from repro_torch.kernels import fuse1d as kf1
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops as kops

    calls = []

    def record(name, fn, shape_of):
        def wrapped(*args, **kw):
            calls.append((name, shape_of(*args, **kw)))
            return fn(*args, **kw)
        return wrapped

    def fused_shape(x, w_row, w_col, w_pw, *, variant, stride, act, **_):
        b, h, w, c = x.shape
        return dict(b=b, h=h, w=w, c=c, k=w_row.shape[0], stride=stride,
                    variant=variant, cout=w_pw.shape[1], act=act)

    def dw_shape(x, w, *, stride=1):
        b, h, wd, c = x.shape
        return dict(b=b, h=h, w=wd, c=c, k=w.shape[0], stride=stride)

    monkeypatch.setattr(kops, "fuseconv_fused", record(
        "fuseconv_fused", kops.fuseconv_fused, fused_shape))
    monkeypatch.setattr(kops, "depthwise_kxk", record(
        "depthwise_kxk", kops.depthwise_kxk, dw_shape))
    def stage_shape(x, w_row, w_col, *, variant, stride, **_):
        b, h, w, c = x.shape
        return dict(b=b, h=h, w=w, c=c, k=w_row.shape[0], stride=stride,
                    variant=variant)

    monkeypatch.setattr(kf1, "fuse1d", record(
        "fuse1d (1-D)", kf1.fuse1d, lambda x, w: dict(x=tuple(x.shape))))
    monkeypatch.setattr(kf1, "fuse_stage", record(
        "fuse1d", kf1.fuse_stage, stage_shape))
    monkeypatch.setattr(kmm, "matmul", record(
        "matmul", kmm.matmul, lambda a, b: dict(
            m=a.shape[0], k=a.shape[1], n=b.shape[1])))
    net = tzoo.mobilenet_v3_large(num_classes=16, width_mult=0.25,
                                  resolution=40)
    params = tzoo.init_network(torch.Generator().manual_seed(0), net,
                               variant, device="cpu")
    x = torch.randn(3, 40, 40, 3, generator=torch.Generator().manual_seed(1))
    tzoo.apply_network(params, net, x, variant, backend="cuda")
    assert calls == tzoo.kernel_launches(net, variant, 3)
