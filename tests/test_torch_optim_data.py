"""The port's optimizers, schedules and data pipeline against the JAX
package's, on the CPU.

Each optimizer runs 5 steps on one tree with 0-, 1- and 2-D leaves (the
shapes of a NOS ``choice``, a BN scale and a weight) and a leaf with no
gradient, on the same numpy gradients as the reference, with a schedule
for the learning rate; every update and state leaf is compared at the
reference's ``rtol=atol=1e-4``.  ``render`` turns the reference's own
draws into the reference's images.  Port of the optimizer, prefetch and
vision-data parts of tests/test_data_optim.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.data.vision_synth import SynthVisionConfig as JSynthConfig
from repro.data.vision_synth import synth_image_batch as jsynth
from repro_torch import optim as topt
from repro_torch.data import Prefetcher, SynthVisionConfig, synth_image_batch
from repro_torch.data.vision_synth import render
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.vision.convert import params_from_numpy

RTOL = ATOL = 1e-4


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w": f(3, 4), "adapter": f(3, 3), "scale": f(5),
            "choice": np.float32(0.5), "stats": {"mean": f(5)}}


def _close_trees(ref, got):
    r, g = jax.tree_util.tree_leaves(ref), tree_leaves(got)
    assert len(r) == len(g)
    for a, b in zip(r, g):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)


OPTS = {
    "sgd": lambda m, lr: m.sgd_momentum(lr, 0.9, weight_decay=0.1),
    "sgd_nesterov": lambda m, lr: m.sgd_momentum(lr, 0.8, weight_decay=0.1,
                                                 nesterov=True),
    "rmsprop": lambda m, lr: m.rmsprop(lr, weight_decay=0.1),
    "adamw": lambda m, lr: m.adamw(lr, weight_decay=0.1),
}
SCHEDS = {
    "const": lambda m: 0.05,
    "exp": lambda m: m.exponential_decay(0.1, 0.5, 2.0),
    "cosine": lambda m: m.cosine_schedule(0.1, 4),
    "warmup_cosine": lambda m: m.warmup_cosine(0.1, 2, 6),
}


@pytest.mark.parametrize("sched", list(SCHEDS))
@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_matches_reference(name, sched):
    """5 steps; the ``mean`` leaf has no gradient (``None`` on the port's
    side, zeros on the reference's, as ``jax.grad`` gives a stat)."""
    jo = OPTS[name](jopt, SCHEDS[sched](jopt))
    to = OPTS[name](topt, SCHEDS[sched](topt))
    jp = _tree()
    tp = params_from_numpy(jp, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for s in range(5):
        g = _tree(seed=s + 1)
        g["stats"]["mean"] = np.zeros(5, np.float32)
        tg = params_from_numpy(g, "cpu")
        tg["stats"]["mean"] = None
        jg, _ = jopt.clip_by_global_norm(g, 1.0)
        tg, _ = topt.clip_by_global_norm(tg, 1.0)
        ju, js = jo.update(jg, js, jp, jnp.asarray(s))
        with torch.no_grad():
            tu, ts = to.update(tg, ts, tp, s)
        _close_trees(ju, tu)
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
    _close_trees(jp, tp)
    _close_trees(js, ts)


def test_decay_mask_by_rank():
    """Decay reaches the 2-D leaves (a weight, the NOS adapter) and skips
    the 1-D (BN) and 0-D (``choice``) ones, with no gradient at all."""
    opt = topt.sgd_momentum(1.0, 0.0, weight_decay=1.0)
    p = params_from_numpy(_tree(), "cpu")
    upd, _ = opt.update(tree_map(lambda _: None, p), opt.init(p), p, 0)
    assert torch.equal(upd["w"], -p["w"])
    assert torch.equal(upd["adapter"], -p["adapter"])
    for leaf in (upd["scale"], upd["choice"], upd["stats"]["mean"]):
        assert not leaf.abs().any()


@pytest.mark.parametrize("name", ["adamw", "sgd", "rmsprop"])
def test_optimizers_converge(name):
    """As tests/test_data_optim.py's convergence checks, on the port."""
    opt = {"adamw": topt.adamw(1e-1), "sgd": topt.sgd_momentum(
        1e-1, momentum=0.5), "rmsprop": topt.rmsprop(1e-2)}[name]
    bound = {"adamw": 1e-2, "sgd": 1e-2, "rmsprop": 0.15}[name]
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor([[1.5]])}
    state = opt.init(params)
    with torch.no_grad():
        for s in range(300):
            grads = tree_map(lambda p: 2 * p, params)
            upd, state = opt.update(grads, state, params, s)
            params = topt.apply_updates(params, upd)
    assert float(topt.global_norm(params)) < bound


def test_clip_and_global_norm_match_reference():
    g = _tree(3)
    jc, jn = jopt.clip_by_global_norm(g, 1.0)
    tc, tn = topt.clip_by_global_norm(params_from_numpy(g, "cpu"), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close_trees(jc, tc)
    assert float(topt.global_norm(tc)) <= 1.0 + 1e-5
    small = {"a": torch.full((4,), 0.1)}
    same, _ = topt.clip_by_global_norm(small, 1.0)
    assert torch.equal(same["a"], small["a"])


def test_schedules_match_reference():
    for name, make in SCHEDS.items():
        if name == "const":
            continue
        jf, tf = make(jopt), make(topt)
        for s in range(0, 9):
            np.testing.assert_allclose(tf(s), float(jf(jnp.asarray(s))),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
    s = topt.warmup_cosine(1.0, 10, 100)
    assert s(0) < s(9)
    assert s(10) == pytest.approx(1.0, abs=0.02)
    assert s(99) < 0.1
    assert topt.exponential_decay(1.0, 0.5, 10)(10) == pytest.approx(0.5)
    assert topt.cosine_schedule(1.0, 100)(100) == pytest.approx(0.0,
                                                                abs=1e-6)


def test_ema_matches_reference():
    p, q = _tree(0), _tree(1)
    je = jopt.ema_update(jopt.ema_init(p), q, decay=0.9)
    te = topt.ema_update(topt.ema_init(params_from_numpy(p, "cpu")),
                         params_from_numpy(q, "cpu"), decay=0.9)
    _close_trees(je, te)


# ---------------------------------------------------------------------------
# Synthetic vision data.
# ---------------------------------------------------------------------------

def _reference_draws(step, batch, cfg):
    """The draws the reference's ``synth_image_batch`` makes, key by key."""
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), step)
    kl, ki = jax.random.split(key)
    labels = jax.random.randint(kl, (batch,), 0, cfg.num_classes)
    jitter, phase, noise = [], [], []
    for k in jax.random.split(ki, batch):
        k1, k2, k3 = jax.random.split(k, 3)
        jitter.append(jax.random.normal(k1, ()))
        phase.append(jax.random.uniform(k2, (), minval=0.0,
                                        maxval=2 * jnp.pi))
        noise.append(jax.random.normal(k3, (cfg.resolution,
                                            cfg.resolution, 3)))
    return [torch.tensor(np.asarray(a)) for a in
            (labels, np.stack(jitter), np.stack(phase), np.stack(noise))]


@pytest.mark.parametrize("res,classes,noise", [(16, 5, 0.35), (28, 8, 0.5),
                                               (9, 1000, 0.0)])
def test_render_matches_reference_images(res, classes, noise):
    cfg = JSynthConfig(resolution=res, num_classes=classes, noise=noise,
                       seed=2)
    ref = jsynth(jnp.asarray(7), 6, cfg)
    labels, jitter, phase, eps = _reference_draws(7, 6, cfg)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref["label"]))
    img = render(labels, jitter, phase, eps, num_classes=classes,
                 noise_scale=noise)
    assert img.dtype == torch.float32 and img.shape == (6, res, res, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref["image"]),
                               rtol=RTOL, atol=ATOL)


def test_vision_batch_deterministic():
    cfg = SynthVisionConfig(resolution=16, num_classes=5, seed=1)
    b1 = synth_image_batch(3, 8, cfg, device="cpu")
    b2 = synth_image_batch(3, 8, cfg, device="cpu")
    assert torch.equal(b1["image"], b2["image"])
    assert torch.equal(b1["label"], b2["label"])
    assert b1["image"].shape == (8, 16, 16, 3)
    assert int(b1["label"].max()) < 5 and int(b1["label"].min()) >= 0
    assert not torch.equal(synth_image_batch(4, 8, cfg, device="cpu")
                           ["image"], b1["image"])
    other = SynthVisionConfig(resolution=16, num_classes=5, seed=2)
    assert not torch.equal(synth_image_batch(3, 8, other, device="cpu")
                           ["image"], b1["image"])


def test_prefetcher_order_and_close():
    pf = Prefetcher(lambda s: {"s": s}, start_step=4, depth=2)
    for expect in (4, 5, 6):
        step, item = pf.next()
        assert step == expect and item["s"] == expect
    pf.close()


def test_prefetcher_surfaces_errors():
    def fn(step):
        if step == 2:
            raise ValueError("bad step")
        return step
    pf = Prefetcher(fn)
    assert pf.next() == (0, 0) and pf.next() == (1, 1)
    with pytest.raises(ValueError, match="bad step"):
        pf.next()
    pf.close()
