"""NOS scaffolding, OFA elastic stages and the hybrid search: the port
against the JAX package, on the CPU.

The port's versions of tests/test_nos_search.py and tests/test_ofa.py, of
tests/test_system.py::test_hybrid_search_end_to_end, each also held to the
reference on the same inputs: ``collapse`` (all-FuSe and hybrid) and
``derive_fuse_from_teacher`` at the reference's ``rtol=atol=1e-4``, the
OFA elastic stage on the reference's parameters, and the evolutionary
search's history equal to the reference's for the same ``accuracy_fn``
(both seed ``np.random.default_rng(cfg.seed)``).  Also the train-mode
forward of MobileNetV3-Large at width 0.25 and 32 px (the wide network's
counterpart of tests/test_torch_train.py's ``tiny_net`` cases).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_params import numpy_params

from repro.core import fuseconv as jfc
from repro.core import nos as jnos
from repro.core import ofa as jofa
from repro.core import search as jsearch
from repro.vision import zoo as jzoo
from repro_torch.core import fuseconv as tfc
from repro_torch.core import nos as tnos
from repro_torch.core import ofa as tofa
from repro_torch.core import search as tsearch
from repro_torch.tree import tree_leaves
from repro_torch.vision import zoo as tzoo
from repro_torch.vision.convert import params_from_numpy, params_to_numpy

RTOL = ATOL = 1e-4
SMALL = dict(num_classes=4, resolution=16, width=8)
JNET, TNET = jzoo.tiny_net(**SMALL), tzoo.tiny_net(**SMALL)
N = TNET.num_spatial_stages


def _teacher():
    return numpy_params(JNET, "depthwise")


def _student_numpy():
    """The reference's scaffold of ``_teacher()``, as numpy."""
    return jax.tree_util.tree_map(
        np.asarray, jnos.scaffold_from_teacher(_teacher(), JNET))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _trees_close(ref, got):
    ref_leaves = jax.tree_util.tree_leaves(ref)
    got_leaves = tree_leaves(got)
    assert len(ref_leaves) == len(got_leaves)
    for r, g in zip(ref_leaves, got_leaves):
        assert np.shape(g) == np.shape(r)
        _close(g, r)


# ---------------------------------------------------------------------------
# The scaffold variant.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["fuse_half", "fuse_full"])
@pytest.mark.parametrize("k,c", [(3, 8), (5, 7)])
def test_derive_fuse_from_teacher_matches_reference(k, c, variant):
    dw, adapter = _x((k, k, c)), _x((k, k), seed=1)
    ref = jfc.derive_fuse_from_teacher(dw, adapter, variant)
    got = tfc.derive_fuse_from_teacher(torch.from_numpy(dw),
                                       torch.from_numpy(adapter), variant)
    assert set(got) == {"row", "col"}
    for key in ("row", "col"):
        _close(got[key], ref[key])


@pytest.mark.parametrize("choice", [0.0, 1.0, 0.3])
@pytest.mark.parametrize("stride", [1, 2])
def test_scaffold_stage_matches_reference(stride, choice):
    spec_args = ("scaffold", 5, 6, stride)
    jspec, tspec = jfc.SpatialOpSpec(*spec_args), tfc.SpatialOpSpec(*spec_args)
    assert tspec.param_count() == jspec.param_count() == 5 * 5 * 6 + 25
    assert tspec.out_channels == jspec.out_channels == 6
    p = {"dw": _x((5, 5, 6)), "adapter": _x((5, 5), seed=1),
         "choice": np.float32(choice)}
    x = _x((2, 11, 10, 6), seed=2)
    _close(tfc.apply_spatial_op(params_from_numpy(p, "cpu"), tspec,
                                torch.from_numpy(x)),
           jfc.apply_spatial_op(p, jspec, x))


def test_scaffold_init_is_identity_adapter_and_zero_choice():
    spec = tfc.SpatialOpSpec("scaffold", 3, 8)
    p = tfc.init_spatial_op(torch.Generator().manual_seed(0), spec,
                            device="cpu")
    assert set(p) == {"dw", "adapter", "choice"}
    assert p["dw"].shape == (3, 3, 8)
    assert torch.equal(p["adapter"], torch.eye(3))
    assert p["choice"].shape == () and float(p["choice"]) == 0.0
    jshapes = jax.eval_shape(lambda: jfc.init_spatial_op(
        jax.random.PRNGKey(0), jfc.SpatialOpSpec("scaffold", 3, 8)))
    assert {k: tuple(v.shape) for k, v in jshapes.items()} == \
        {k: tuple(v.shape) for k, v in p.items()}


def test_scaffold_stages_launch_no_spatial_kernel():
    """``kernel_launches`` lists no spatial launch for a scaffold stage
    (plain ops on every backend) and a ``matmul`` for each of its
    pointwise convs; on CPU tensors the ``cuda`` backend's scaffold
    forward equals ``torch``'s."""
    launches = tzoo.kernel_launches(TNET, "scaffold", 8)
    assert {name for name, _ in launches} == {"matmul"}
    assert len(launches) == len(tzoo.kernel_launches(TNET, "depthwise", 8)) \
        - N
    student = params_from_numpy(_student_numpy(), "cpu")
    x = torch.from_numpy(_x((2, 16, 16, 3)))
    with torch.no_grad():
        ref = tzoo.apply_network(student, TNET, x, "scaffold")
        got = tzoo.apply_network(student, TNET, x, "scaffold",
                                 backend="cuda")
    _close(got, ref)


# ---------------------------------------------------------------------------
# NOS (port of tests/test_nos_search.py), each against the reference.
# ---------------------------------------------------------------------------

def test_scaffold_from_teacher_matches_reference():
    teacher = _teacher()
    ref = jnos.scaffold_from_teacher(teacher, JNET)
    got = tnos.scaffold_from_teacher(params_from_numpy(teacher, "cpu"), TNET)
    _trees_close(ref, got)
    sp = got[1]["sp"]
    assert set(sp) == {"dw", "adapter", "choice"} and sp["choice"].ndim == 0


def test_scaffold_choice_zero_equals_teacher():
    teacher = params_from_numpy(_teacher(), "cpu")
    student = tnos.scaffold_from_teacher(teacher, TNET)
    x = torch.from_numpy(_x((2, 16, 16, 3)))
    y_t = tzoo.apply_network(teacher, TNET, x, "depthwise")
    sp = tnos.set_choices(student, TNET, torch.zeros(N))
    y_s = tzoo.apply_network(sp, TNET, x, ["scaffold"] * N)
    np.testing.assert_allclose(y_t, y_s, rtol=1e-5, atol=1e-5)


def test_collapse_matches_scaffold_all_fuse():
    student = tnos.scaffold_from_teacher(
        params_from_numpy(_teacher(), "cpu"), TNET)
    x = torch.from_numpy(_x((2, 16, 16, 3)))
    sp = tnos.set_choices(student, TNET, torch.ones(N))
    y_scaffold = tzoo.apply_network(sp, TNET, x, ["scaffold"] * N)
    collapsed, variants = tnos.collapse(student, TNET)
    y_collapsed = tzoo.apply_network(collapsed, TNET, x, variants)
    np.testing.assert_allclose(y_scaffold, y_collapsed, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("keep", [None, [True] + [False] * (N - 1),
                                  [i % 2 == 0 for i in range(N)]],
                         ids=["all_fuse", "first_dw", "alternate"])
def test_collapse_matches_reference(keep):
    """All-FuSe and hybrid collapses of a trained-looking scaffold (random
    adapters) against the reference's: same variants, same params."""
    student = _student_numpy()
    rng = np.random.default_rng(4)
    for b in student:
        if "sp" in b:
            b["sp"]["adapter"] = rng.standard_normal(
                b["sp"]["adapter"].shape).astype(np.float32)
    ref, ref_variants = jnos.collapse(student, JNET, keep_depthwise=keep)
    got, variants = tnos.collapse(params_from_numpy(student, "cpu"), TNET,
                                  keep_depthwise=keep)
    assert variants == ref_variants
    if keep is not None:
        assert variants == ["depthwise" if k else "fuse_half" for k in keep]
    _trees_close(ref, got)
    x = _x((2, 16, 16, 3), seed=5)
    ref_logits = jzoo.apply_network(ref, JNET, x, ref_variants)[0]
    # the kernel backends too: a collapse's banks are column slices, which
    # the kernel wrappers must be handed contiguous
    for backend in ("torch", "cuda", "cuda_nofused"):
        _close(tzoo.apply_network(got, TNET, torch.from_numpy(x), variants,
                                  backend=backend), ref_logits)


def test_set_choices_leaves_the_student_as_it_was():
    student = tnos.scaffold_from_teacher(
        params_from_numpy(_teacher(), "cpu"), TNET)
    chosen = tnos.set_choices(student, TNET, torch.ones(N))
    assert all(float(b["sp"]["choice"]) == 1.0 for b in chosen if "sp" in b)
    assert all(float(b["sp"]["choice"]) == 0.0 for b in student
               if "sp" in b)


def test_kd_loss_zero_when_identical():
    logits = torch.from_numpy(_x((4, 10)))
    kd = tnos.kd_loss(logits, logits, temperature=2.0)
    ent = -torch.mean(torch.sum(torch.softmax(logits / 2, -1) *
                                torch.log_softmax(logits / 2, -1), -1)) * 4
    np.testing.assert_allclose(float(kd), float(ent), rtol=1e-5)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_losses_match_reference(smoothing):
    s, t = _x((6, 10)), _x((6, 10), seed=1)
    labels = np.array([0, 3, 9, 2, 2, 7])
    _close(tnos.cross_entropy(torch.from_numpy(s), torch.from_numpy(labels),
                              smoothing),
           jnos.cross_entropy(s, labels, smoothing))
    _close(tnos.kd_loss(torch.from_numpy(s), torch.from_numpy(t), 3.0),
           jnos.kd_loss(s, t, 3.0))


def test_nos_loss_runs_and_grads():
    from repro_torch.train.vision import value_and_grad
    teacher = params_from_numpy(_teacher(), "cpu")
    student = tnos.scaffold_from_teacher(teacher, TNET)
    batch = {"image": torch.from_numpy(_x((4, 16, 16, 3))),
             "label": torch.tensor([0, 1, 2, 3])}
    choices = tnos.sample_choices(torch.Generator().manual_seed(0), N, 0.5)
    (loss, _), grads = value_and_grad(tnos.nos_loss_fn, student, TNET,
                                      teacher, batch, choices,
                                      tnos.NOSConfig())
    assert torch.isfinite(loss)
    gn = sum(float(g.abs().sum()) for g in tree_leaves(grads)
             if g is not None)
    assert np.isfinite(gn) and gn > 0


def test_sample_choices():
    gen = torch.Generator().manual_seed(0)
    c = tnos.sample_choices(gen, 4096, 0.25)
    assert c.dtype == torch.float32 and c.shape == (4096,)
    assert set(c.unique().tolist()) <= {0.0, 1.0}
    assert 0.2 < float(c.mean()) < 0.3


# ---------------------------------------------------------------------------
# The train-mode forward of the wide network.
# ---------------------------------------------------------------------------

V3L = dict(num_classes=16, width_mult=0.25, resolution=32)


@pytest.mark.parametrize("variant", ["fuse_half", "scaffold_mixed",
                                     "hybrid"])
def test_v3_large_train_forward_matches_reference(variant):
    jnet = jzoo.mobilenet_v3_large(**V3L)
    tnet = tzoo.mobilenet_v3_large(**V3L)
    n = jnet.num_spatial_stages
    if variant == "scaffold_mixed":
        params = jax.tree_util.tree_map(np.asarray, jnos.set_choices(
            numpy_params(jnet, "scaffold"), jnet,
            jnp.asarray([float(i % 2) for i in range(n)])))
        v = "scaffold"
    else:
        cycle = ("depthwise", "fuse_half", "fuse_full")
        v = (variant if variant != "hybrid"
             else tuple(cycle[i % 3] for i in range(n)))
        params = numpy_params(jnet, v)
    x = _x((4, 32, 32, 3), seed=1)
    ref_logits, ref_state = jzoo.apply_network(params, jnet, x, v,
                                               train=True)
    logits, state = tzoo.apply_network_train(params_from_numpy(params, "cpu"),
                                             tnet, torch.from_numpy(x), v)
    _close(logits.detach(), ref_logits)
    _trees_close(ref_state, state)


def test_params_round_trip_keeps_choice_and_int_keys():
    tree = [{"sp": {"dw": _x((3, 3, 4)), "choice": np.float32(1.0),
                    "kt": {3: np.eye(9, dtype=np.float32)},
                    "adapter": {3: np.eye(3, dtype=np.float32),
                                5: np.eye(5, dtype=np.float32)}}}]
    t = params_from_numpy(tree, "cpu")
    assert t[0]["sp"]["choice"].shape == ()
    assert set(t[0]["sp"]["adapter"]) == {3, 5}
    back = params_to_numpy(t)
    assert set(back[0]["sp"]["kt"]) == {3}
    for a, b in zip(jax.tree_util.tree_leaves(tree), tree_leaves(back)):
        assert a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# OFA (port of tests/test_ofa.py), against the reference on its params.
# ---------------------------------------------------------------------------

def test_crop_kernel_identity_transform():
    dw = torch.from_numpy(_x((7, 7, 4)))
    w5 = tofa.crop_kernel(dw, 5, torch.eye(25))
    np.testing.assert_allclose(w5, dw[1:6, 1:6, :], rtol=1e-6)


def test_crop_kernel_matches_reference():
    dw, tr = _x((7, 7, 4)), _x((9, 9), seed=1)
    _close(tofa.crop_kernel(torch.from_numpy(dw), 3, torch.from_numpy(tr)),
           jofa.crop_kernel(dw, 3, tr))


def _elastic_params(space, max_k, c):
    p = jofa.init_elastic_stage(jax.random.PRNGKey(0), max_k, c, space)
    rng = np.random.default_rng(2)
    # trained-looking transforms and adapters, not the identity
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape))
        .astype(np.float32), p)
    return p


def test_elastic_stage_kernel_selection():
    space = tofa.ElasticSpace(kernels=(7, 5, 3))
    p = tofa.init_elastic_stage(torch.Generator().manual_seed(0), 7, 8,
                                space, device="cpu")
    x = torch.from_numpy(_x((1, 12, 12, 8)))
    for ki, k in enumerate((7, 5, 3)):
        y = tofa.elastic_spatial_apply(
            p, x, stride=1, kernel_choice=torch.tensor(ki),
            fuse_choice=torch.zeros(()), kernels=(7, 5, 3))
        dw_k = tofa.crop_kernel(p["dw"], k, p["kt"].get(k))
        np.testing.assert_allclose(y, tfc.depthwise_conv2d(x, dw_k),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kernel_choice", [0, 1, 2])
@pytest.mark.parametrize("fuse", [0.0, 1.0])
@pytest.mark.parametrize("stride", [1, 2])
def test_elastic_stage_matches_reference(kernel_choice, fuse, stride):
    space = jofa.ElasticSpace(kernels=(7, 5, 3))
    p = _elastic_params(space, 7, 6)
    x = _x((2, 12, 11, 6), seed=3)
    ref = jofa.elastic_spatial_apply(
        p, x, stride=stride, kernel_choice=jnp.asarray(kernel_choice),
        fuse_choice=jnp.asarray(fuse), kernels=(7, 5, 3))
    got = tofa.elastic_spatial_apply(
        params_from_numpy(p, "cpu"), torch.from_numpy(x), stride=stride,
        kernel_choice=kernel_choice, fuse_choice=torch.tensor(fuse),
        kernels=(7, 5, 3))
    _close(got, ref)


def test_elastic_fuse_choice():
    space = tofa.ElasticSpace(kernels=(5, 3))
    p = tofa.init_elastic_stage(torch.Generator().manual_seed(0), 5, 6,
                                space, device="cpu")
    x = torch.from_numpy(_x((1, 10, 10, 6)))
    y = tofa.elastic_spatial_apply(
        p, x, stride=1, kernel_choice=1, fuse_choice=torch.ones(()),
        kernels=(5, 3))
    dw3 = tofa.crop_kernel(p["dw"], 3, p["kt"][3])
    d = tfc.derive_fuse_from_teacher(dw3, p["adapter"][3], "fuse_half")
    np.testing.assert_allclose(y, tfc.fuse_conv2d_half(x, d["row"], d["col"]),
                               rtol=1e-4, atol=1e-5)


def test_init_elastic_stage_has_the_reference_structure():
    space = tofa.ElasticSpace(kernels=(7, 5, 3))
    p = tofa.init_elastic_stage(torch.Generator().manual_seed(0), 5, 4,
                                space, device="cpu")
    ref = jax.eval_shape(lambda: jofa.init_elastic_stage(
        jax.random.PRNGKey(0), 5, 4, jofa.ElasticSpace(kernels=(7, 5, 3))))
    assert jax.tree_util.tree_structure(ref) == \
        jax.tree_util.tree_structure(params_to_numpy(p))
    assert [tuple(a.shape) for a in jax.tree_util.tree_leaves(ref)] == \
        [tuple(a.shape) for a in tree_leaves(p)]


def test_sample_subnet_phases():
    space = tofa.ElasticSpace()
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    c = tofa.sample_subnet(gen(), 6, 4, space, phase="kernel")
    assert not any(c.fuse) and not any(c.skip)
    d = tofa.sample_subnet(gen(), 6, 4, space, phase="depth")
    assert not any(d.fuse) and d.kernels == c.kernels
    f = tofa.sample_subnet(gen(), 6, 4, space, phase="full")
    assert len(f.kernels) == 6 and len(f.skip) == 4
    assert f.kernels == c.kernels and f.skip == d.skip
    assert set(f.kernels) <= set(space.kernels)
    no_fuse = tofa.sample_subnet(gen(), 6, 4, tofa.ElasticSpace(
        allow_fuse=False), phase="full")
    assert not any(no_fuse.fuse)


# ---------------------------------------------------------------------------
# Hybrid search (port of the EA tests), against the reference's history.
# ---------------------------------------------------------------------------

def test_ea_finds_planted_optimum_with_the_reference_history():
    jnet, tnet = jzoo.mobilenet_v2(), tzoo.mobilenet_v2()
    n = tnet.num_spatial_stages
    target = [i % 2 == 0 for i in range(n)]

    def acc(mask):
        return sum(a == b for a, b in zip(mask, target)) / n

    out = tsearch.evolutionary_search(
        tnet, acc, tsearch.EAConfig(population=24, iterations=12, seed=0))
    ref = jsearch.evolutionary_search(
        jnet, acc, jsearch.EAConfig(population=24, iterations=12, seed=0))
    assert out["best_acc"] >= 0.9
    assert out["history"] == ref["history"]
    assert out["evaluated"] == ref["evaluated"]
    assert out["best_mask"] == ref["best_mask"]


def test_greedy_mask_matches_reference_and_improves_latency():
    net = tzoo.mobilenet_v2()
    n = net.num_spatial_stages
    mask = tsearch.greedy_latency_mask(net, 0.5)
    assert mask == jsearch.greedy_latency_mask(jzoo.mobilenet_v2(), 0.5)
    assert sum(mask) == round(0.5 * n)
    assert tsearch.latency_ms(net, mask) < tsearch.latency_ms(net,
                                                              [False] * n)


def test_v3_large_half_mask_moves_every_kernel():
    """The mask that ``chip_smoke.py`` phase 8 collapses V3-L under
    (``greedy_latency_mask(net, 0.5)``, True = FuSe-Half) keeps some stages
    depthwise and turns SE and non-SE stages to FuSe-Half, so the hybrid
    launches all four kernels on ``cuda``."""
    net = tzoo.mobilenet_v3_large()
    mask = tsearch.greedy_latency_mask(net, 0.5)
    assert mask == jsearch.greedy_latency_mask(jzoo.mobilenet_v3_large(),
                                               0.5)
    names = {name for name, _ in tzoo.kernel_launches(
        net, tsearch.mask_to_variants(mask), 8)}
    assert names == {"matmul", "fuse1d", "fuseconv_fused", "depthwise_kxk"}


def test_pareto_front_non_dominated():
    pts = [{"acc": a, "latency_ms": l} for a, l in
           [(0.7, 5.0), (0.8, 6.0), (0.75, 4.0), (0.6, 2.0), (0.8, 8.0)]]
    front = tsearch.pareto_front(pts)
    assert front == jsearch.pareto_front(pts)
    for p in front:
        for q in pts:
            assert not (q["acc"] > p["acc"] and
                        q["latency_ms"] < p["latency_ms"])


def test_hybrid_search_end_to_end():
    """EA over the tiny net with a synthetic accuracy surface (port of
    tests/test_system.py::test_hybrid_search_end_to_end), with the
    reference's history."""
    n = tzoo.tiny_net().num_spatial_stages

    def acc(mask):  # prefers FuSe on later stages
        return 0.5 + 0.1 * sum(m * i for i, m in enumerate(mask)) / n

    cfg = dict(population=12, iterations=6, latency_weight=0.01)
    out = tsearch.evolutionary_search(tzoo.tiny_net(), acc,
                                      tsearch.EAConfig(**cfg))
    ref = jsearch.evolutionary_search(jzoo.tiny_net(), acc,
                                      jsearch.EAConfig(**cfg))
    assert len(out["evaluated"]) > 10
    assert out["history"] == ref["history"]
    front = tsearch.pareto_front(out["evaluated"])
    assert front and front == jsearch.pareto_front(ref["evaluated"])
