"""The port's vision training path against the JAX package's, on the CPU.

``repro_torch.vision.zoo.apply_network_train`` against
``repro.vision.zoo.apply_network(..., train=True)`` (logits and the new BN
statistics), the gradients of ``train.vision._loss_fn`` and
``core.nos.nos_loss_fn`` against ``jax.grad`` of the reference's, and three
steps of ``train_step``/``nos_step`` against the same steps of the JAX loop
(``_loss_fn``/``nos_loss_fn``, ``clip_by_global_norm``, ``sgd_momentum``,
``_merge_bn``), each driven with the reference's own ``synth_image_batch``
and NOS choices.  Size: ``tiny_net(width=8, resolution=16)``, batch 8,
params from ``_torch_params.numpy_params``.  Tolerance: the reference's
``rtol=atol=1e-4``.

Gradients are compared per leaf at 1e-4 of that leaf's max.  A leaf whose
gradient is zero analytically (a BN bias whose output feeds the next
train-mode BN, which subtracts the batch mean) carries only float32
round-off on both sides, about 1e-7 of the largest gradient, with no
common digits; such a leaf, found by a float64 run of the port's plain
ops (below 1e-12 of the largest gradient there), is held to zero within
1e-6 of the largest gradient on both sides instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_params import numpy_params

from repro.core import nos as jnos
from repro.data.vision_synth import SynthVisionConfig as JSynthConfig
from repro.data.vision_synth import synth_image_batch as jsynth
from repro.optim import apply_updates as japply_updates
from repro.optim import clip_by_global_norm as jclip
from repro.optim import sgd_momentum as jsgd
from repro.train import vision as jtv
from repro.vision import zoo as jzoo
from repro_torch.core import nos as tnos
from repro_torch.data.vision_synth import SynthVisionConfig
from repro_torch.optim import sgd_momentum
from repro_torch.train import vision as ttv
from repro_torch.tree import tree_leaves
from repro_torch.vision import zoo as tzoo
from repro_torch.vision.convert import params_from_numpy, params_to_numpy

RTOL = ATOL = 1e-4
SMALL = dict(num_classes=4, resolution=16, width=8)
JNET, TNET = jzoo.tiny_net(**SMALL), tzoo.tiny_net(**SMALL)
N_STAGES = JNET.num_spatial_stages
DCFG = JSynthConfig(resolution=16, num_classes=4, noise=0.5)
BATCH = 8


def _hybrid(n):
    cycle = ("depthwise", "fuse_half", "fuse_full")
    return [cycle[i % 3] for i in range(n)]


def _jbatch(step):
    b = jsynth(jnp.asarray(step), BATCH, DCFG)
    return {"image": np.asarray(b["image"]), "label": np.asarray(b["label"])}


def _tbatch(b):
    return {"image": torch.tensor(b["image"]),
            "label": torch.tensor(b["label"]).long()}


def _flat(tree):
    """(path string, leaf) of a JAX-side tree, in ``tree_leaves`` order."""
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def assert_trees_close(ref, got, rtol=RTOL, atol=ATOL):
    """Every leaf of the port's tree ``got`` against the reference's."""
    ref_leaves, got_leaves = _flat(ref), tree_leaves(got)
    assert len(ref_leaves) == len(got_leaves)
    for (path, r), g in zip(ref_leaves, got_leaves):
        r = np.asarray(r)
        g = np.zeros(r.shape, r.dtype) if g is None else np.asarray(g)
        assert g.shape == r.shape, path
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=path)


def _scaffold_params(choices):
    """A scaffold student from a ``numpy_params`` teacher, with ``choices``
    set (numpy, as both packages load it)."""
    teacher = numpy_params(JNET, "depthwise")
    student = jnos.set_choices(jnos.scaffold_from_teacher(teacher, JNET),
                               JNET, jnp.asarray(choices, jnp.float32))
    return jax.tree_util.tree_map(np.asarray, student)


TRAIN_VARIANTS = {
    "depthwise": "depthwise", "fuse_half": "fuse_half",
    "fuse_full": "fuse_full", "scaffold0": "scaffold",
    "scaffold1": "scaffold", "scaffold_mixed": "scaffold",
    "hybrid": "hybrid",
}
CHOICES = {"scaffold0": [0.0] * N_STAGES, "scaffold1": [1.0] * N_STAGES,
           "scaffold_mixed": [float(i % 2) for i in range(N_STAGES)]}


def _case(name):
    v = TRAIN_VARIANTS[name]
    if v == "scaffold":
        return _scaffold_params(CHOICES[name]), v
    if v == "hybrid":
        v = _hybrid(N_STAGES)
    return numpy_params(JNET, v), v


@pytest.mark.parametrize("name", list(TRAIN_VARIANTS))
def test_train_forward_matches_reference(name):
    """Logits and the new params (BN running stats moved by the batch
    statistics, everything else as it was) of one train-mode forward."""
    params, v = _case(name)
    x = np.random.default_rng(1).standard_normal(
        (4, 16, 16, 3)).astype(np.float32)
    ref_logits, ref_state = jzoo.apply_network(params, JNET, x, v,
                                               train=True)
    logits, state = tzoo.apply_network_train(params_from_numpy(params, "cpu"),
                                             TNET, torch.from_numpy(x), v)
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits,
                               rtol=RTOL, atol=ATOL)
    assert_trees_close(ref_state, state)


def test_train_forward_never_fuses_and_never_launches():
    """The train path runs plain ops, so it moves no launch counter."""
    from repro_torch.kernels import ops as kops
    params, v = _case("fuse_half")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 16, 16, 3)).astype(np.float32))
    before = kops.launch_counts()
    logits, _ = tzoo.apply_network_train(params_from_numpy(params, "cpu"),
                                         TNET, x, v)
    assert kops.launch_counts() == before
    assert logits.shape == (2, 4) and torch.isfinite(logits).all()


def _assert_grads_close(ref_grads, grads, grads64):
    """Per leaf at 1e-4 of the reference leaf's max; analytically zero
    leaves (float64 max below 1e-12 of its largest) held to zero within
    1e-6 of the largest gradient on both sides (module docstring)."""
    ref_leaves = _flat(ref_grads)
    got, got64 = tree_leaves(grads), tree_leaves(grads64)
    assert len(ref_leaves) == len(got) == len(got64)

    def arr(g, shape):
        return np.zeros(shape) if g is None else g.detach().numpy()

    big = max(float(np.abs(np.asarray(r)).max()) for _, r in ref_leaves)
    big64 = max(float(np.abs(arr(g, ())).max()) for g in got64)
    n_zero = 0
    for (path, r), g, g64 in zip(ref_leaves, got, got64):
        r = np.asarray(r)
        g, g64 = arr(g, r.shape), arr(g64, r.shape)
        assert g.shape == r.shape, path
        if float(np.abs(g64).max()) <= 1e-12 * big64:
            n_zero += 1
            assert float(np.abs(r).max()) <= 1e-6 * big, path
            assert float(np.abs(g).max()) <= 1e-6 * big, path
            continue
        tol = 1e-4 * float(np.abs(r).max())
        assert float(np.abs(g - r).max()) <= tol, path
    return n_zero


def _to64(tree):
    return params_from_numpy(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), tree), "cpu")


@pytest.mark.parametrize("name", ["depthwise", "fuse_half", "hybrid"])
def test_loss_grads_match_jax(name):
    params, v = _case(name)
    batch = _jbatch(0)
    vg = jax.jit(jax.value_and_grad(jtv._loss_fn, has_aux=True),
                 static_argnums=(1, 2))
    (ref_loss, _), ref_grads = vg(params, JNET, v if isinstance(v, str)
                                  else tuple(v), batch)
    tb = _tbatch(batch)
    (loss, _), grads = ttv.value_and_grad(
        ttv._loss_fn, params_from_numpy(params, "cpu"), TNET, v, tb)
    (_, _), grads64 = ttv.value_and_grad(
        ttv._loss_fn, _to64(params), TNET, v,
        dict(tb, image=tb["image"].double()))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=RTOL)
    _assert_grads_close(ref_grads, grads, grads64)


def test_nos_loss_grads_match_jax():
    teacher = numpy_params(JNET, "depthwise")
    student = jax.tree_util.tree_map(
        np.asarray, jnos.scaffold_from_teacher(teacher, JNET))
    # a student away from its teacher, so that the KD term has a gradient
    rng = np.random.default_rng(3)
    student = jax.tree_util.tree_map(
        lambda a: a + np.asarray(0.05 * rng.standard_normal(a.shape),
                                 a.dtype) if a.ndim >= 2 else a, student)
    choices = np.asarray([1.0, 0.0, 1.0, 0.0], np.float32)
    batch = _jbatch(1)
    cfg = jnos.NOSConfig()
    vg = jax.jit(jax.value_and_grad(jnos.nos_loss_fn, has_aux=True),
                 static_argnums=(1, 5))
    (ref_loss, (_, ref_m)), ref_grads = vg(student, JNET, teacher, batch,
                                           jnp.asarray(choices), cfg)
    tb = _tbatch(batch)
    tcfg = tnos.NOSConfig()
    (loss, (_, m)), grads = ttv.value_and_grad(
        tnos.nos_loss_fn, params_from_numpy(student, "cpu"), TNET,
        params_from_numpy(teacher, "cpu"), tb, torch.from_numpy(choices),
        tcfg)
    (_, _), grads64 = ttv.value_and_grad(
        tnos.nos_loss_fn, _to64(student), TNET, _to64(teacher),
        dict(tb, image=tb["image"].double()),
        torch.from_numpy(choices).double(), tcfg)
    for k in ("loss", "ce", "kd", "acc"):
        np.testing.assert_allclose(float(m[k].detach()), float(ref_m[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=RTOL)
    # the choice leaves are replaced by set_choices, so they get no gradient
    assert all(g is None for g in (b["sp"]["choice"] for b, blk in
                                   zip(grads, TNET.blocks)
                                   if isinstance(blk, tzoo.MBConv)))
    _assert_grads_close(ref_grads, grads, grads64)


def _jax_step(loss_fn, opt):
    """One step of the reference's loop, from its own pieces."""
    def step(params, opt_state, step, *loss_args):
        (_, (new_state, _)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, *loss_args)
        grads, _ = jclip(grads, 1.0)
        updates, opt_state = opt.update(grads, opt_state, params, step)
        params = japply_updates(params, updates)
        return jtv._merge_bn(params, new_state), opt_state
    return step


@pytest.mark.parametrize("name", ["depthwise", "fuse_half"])
def test_train_steps_match_jax_loop(name):
    params, v = _case(name)
    cfg = jtv.VisionTrainConfig(steps=3, batch=BATCH)
    jopt = jsgd(cfg.lr, cfg.momentum, cfg.weight_decay)
    jstep = jax.jit(_jax_step(jtv._loss_fn, jopt), static_argnums=(3, 4))
    jp, js = params, jopt.init(params)
    topt = sgd_momentum(cfg.lr, cfg.momentum, cfg.weight_decay)
    tp = params_from_numpy(params, "cpu")
    ts = topt.init(tp)
    for s in range(3):
        batch = _jbatch(s)
        jp, js = jstep(jp, js, jnp.asarray(s), JNET, v, batch)
        tp, ts, loss, acc = ttv.train_step(tp, ts, s, _tbatch(batch),
                                           net=TNET, variant=v, opt=topt)
        assert np.isfinite(float(loss)) and 0.0 <= float(acc) <= 1.0
    assert_trees_close(jp, tp)
    assert_trees_close(js, ts)


def test_nos_steps_match_jax_loop():
    teacher = numpy_params(JNET, "depthwise")
    student = jax.tree_util.tree_map(
        np.asarray, jnos.scaffold_from_teacher(teacher, JNET))
    cfg = jtv.VisionTrainConfig(steps=3, batch=BATCH)
    ncfg = jnos.NOSConfig()
    jopt = jsgd(cfg.lr, cfg.momentum, cfg.weight_decay)
    jstep = jax.jit(_jax_step(jnos.nos_loss_fn, jopt),
                    static_argnums=(3, 7))
    jp, js = student, jopt.init(student)
    topt = sgd_momentum(cfg.lr, cfg.momentum, cfg.weight_decay)
    tp = params_from_numpy(student, "cpu")
    ts = topt.init(tp)
    tteacher = params_from_numpy(teacher, "cpu")
    for s in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 1), s)
        choices = jnos.sample_choices(key, N_STAGES, ncfg.fuse_prob)
        batch = _jbatch(s)
        jp, js = jstep(jp, js, jnp.asarray(s), JNET, teacher, batch,
                       choices, ncfg)
        tp, ts, metrics = ttv.nos_step(
            tp, ts, s, _tbatch(batch), torch.tensor(np.asarray(choices)),
            net=TNET, teacher_params=tteacher, nos_cfg=tnos.NOSConfig(),
            opt=topt)
        assert all(np.isfinite(float(x)) for x in metrics.values())
    assert_trees_close(jp, tp)
    assert_trees_close(js, ts)
    # the student's own choices stay 0: set_choices replaces them per step
    assert all(float(b["sp"]["choice"]) == 0.0 for b in tp
               if "sp" in b)


def test_end_to_end_nos_pipeline():
    """A few steps of each phase on the CPU (port of
    tests/test_system.py::test_end_to_end_nos_pipeline): wiring, shapes,
    finiteness, the collapse's variants, the latency win."""
    from repro_torch.systolic.simulator import simulate_network
    net = TNET
    dcfg = SynthVisionConfig(resolution=16, num_classes=4, noise=0.5)
    cfg = ttv.VisionTrainConfig(steps=6, batch=16, eval_batches=1)

    teacher = ttv.train_vision(net, "depthwise", cfg, dcfg, device="cpu")
    assert 0.0 <= teacher["eval_acc"] <= 1.0
    assert len(teacher["losses"]) == 6
    assert np.all(np.isfinite(teacher["losses"]))

    out = ttv.train_nos(net, teacher["params"], cfg, dcfg, device="cpu")
    assert 0.0 <= out["eval_acc"] <= 1.0
    assert all(v == "fuse_half" for v in out["variants"])
    assert np.all(np.isfinite(out["losses"]))
    for tree in (out["scaffold_params"], out["collapsed_params"]):
        assert all(np.all(np.isfinite(a)) for a in
                   tree_leaves(params_to_numpy(tree)))
    # the teacher is frozen: NOS left its tensors as they were
    again = ttv.evaluate(teacher["params"], net, "depthwise", cfg, dcfg,
                         device="cpu")
    assert again == teacher["eval_acc"]

    base_sim = simulate_network(tzoo.lower_to_ir(net, "depthwise"))
    fuse_sim = simulate_network(tzoo.lower_to_ir(net, "fuse_half"))
    assert fuse_sim.cycles < base_sim.cycles


def test_train_vision_is_seekable():
    """Same config, same result: the seeded init, the step-indexed data
    and the NOS choices make a run repeatable."""
    dcfg = SynthVisionConfig(resolution=16, num_classes=4)
    cfg = ttv.VisionTrainConfig(steps=2, batch=4, eval_batches=1)
    a = ttv.train_vision(TNET, "fuse_half", cfg, dcfg, device="cpu")
    b = ttv.train_vision(TNET, "fuse_half", cfg, dcfg, device="cpu")
    assert a["losses"] == b["losses"]
    assert torch.equal(ttv.nos_choices(cfg, 5, 9, 0.5),
                       ttv.nos_choices(cfg, 5, 9, 0.5))
    assert not torch.equal(ttv.nos_choices(cfg, 5, 64, 0.5),
                           ttv.nos_choices(cfg, 6, 64, 0.5))


def test_kernel_backend_refuses_grad():
    """On a kernel backend a forward with grad-requiring parameters (or
    input) raises while grad mode is on: the kernels have no backward pass
    and would drop every gradient above them.  Under ``no_grad`` it runs,
    and the ``torch`` backend differentiates as usual."""
    params, v = _case("fuse_half")
    tp = params_from_numpy(params, "cpu")
    x = torch.zeros(1, 16, 16, 3)
    grad_params = [dict(b) for b in tp]
    grad_params[1] = dict(grad_params[1], project=grad_params[1]["project"]
                          .clone().requires_grad_(True))
    for backend in ("cuda", "cuda_nofused"):
        with pytest.raises(RuntimeError, match="backward"):
            tzoo.apply_network(grad_params, TNET, x, v, backend=backend)
        with pytest.raises(RuntimeError, match="backward"):
            tzoo.apply_network(tp, TNET, x.clone().requires_grad_(True), v,
                               backend=backend)
        with torch.no_grad():
            tzoo.apply_network(grad_params, TNET, x, v, backend=backend)
    y = tzoo.apply_network(grad_params, TNET, x, v, backend="torch")
    y.sum().backward()
    assert grad_params[1]["project"].grad is not None
