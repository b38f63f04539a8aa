"""The port's LM sharding policy against the JAX package's, on the CPU.

``repro_torch.launch.sharding.ShardingPolicy`` and
``repro.launch.sharding.ShardingPolicy`` read only leaf shapes and a
mesh's axis names and sizes, so both run on stand-in production meshes
(``jax.sharding.AbstractMesh`` of (16, 16) ``("data", "model")`` and
(2, 16, 16) ``("pod", "data", "model")``, as the reference's own test runs
a ``FakeMesh``).  The parameter trees are the reference's
``jax.eval_shape`` shapes (the port's leaves as meta tensors of them), the
decode caches each package's own (the port's ``init_cache`` on the meta
device).  Every parameter, batch and cache spec of the ten production
configs, over every profile, ``attn_align`` and ``zero3`` setting, and
``zero_extend`` and ``train_step_shardings``, must equal the reference's.
Then the spec-to-placement mapping, ``act_constraint``,
``make_production_mesh``'s refusal at a world of 1, ``shard_tree`` on a
world-1 ``gloo`` group (``make_host_mesh("cpu")``), and the RecurrentGemma
smoke model served under a policy there on both backends with the
unsharded engine's tokens.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro import configs as JC
from repro.launch import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro_torch import configs as TC
from repro_torch import tree as ttree
from repro_torch.launch import distributed as tdist
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PROFILES = ("tp", "fsdp", "tp_seq")
CONFIGS = tuple(JC.list_configs())
SETTINGS = [(a, z) for a in (True, False) for z in (False, True)]


def _mesh(key):
    return AbstractMesh(*MESHES[key])


def _norm(spec):
    """A spec as a tuple, a one-axis tuple entry as its axis (JAX treats
    ``("data",)`` and ``"data"`` as one entry)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _jleaves(tree):
    return [_norm(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _tleaves(tree):
    return [_norm(s) for s in ttree.tree_leaves(tree)]


@functools.lru_cache(maxsize=None)
def _param_shapes(name):
    m = jmodel.LanguageModel(JC.get_config(name))
    return jax.eval_shape(m.init, jax.ShapeDtypeStruct((2,), jnp.uint32))


@functools.lru_cache(maxsize=None)
def _caches(name, batch):
    """The reference's decode cache shapes and the port's meta cache."""
    jm = jmodel.LanguageModel(JC.get_config(name))
    tm = tmodel.build_model(TC.get_config(name))
    return (jax.eval_shape(lambda: jm.init_cache(batch, 256)),
            tm.init_cache(batch, 256, device="meta"))


def _meta(shapes):
    """The reference's shape tree as the port's tree of meta tensors."""
    return jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), shapes)


def _policies(name, key, profile, attn_align=True, zero3=False):
    mesh = _mesh(key)
    return (jsh.ShardingPolicy(mesh, JC.get_config(name), profile,
                               attn_align, zero3),
            tsh.ShardingPolicy(mesh, TC.get_config(name), profile,
                               attn_align, zero3))


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("key", sorted(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_param_specs_equal_the_reference(name, key, profile):
    shapes = _param_shapes(name)
    meta = _meta(shapes)
    for attn_align, zero3 in SETTINGS:
        jp, tp = _policies(name, key, profile, attn_align, zero3)
        want = _jleaves(jp.param_specs(shapes))
        got = _tleaves(tp.param_specs(meta))
        assert got == want, (attn_align, zero3)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("key", sorted(MESHES))
def test_batch_specs_equal_the_reference(key, profile):
    jp, tp = _policies("glm4_9b", key, profile)
    for b in (1, 2, 3, 16, 32, 48, 256, 512, 1024):
        assert _norm(tp.batch_spec(b)) == _norm(jp.batch_spec(b)), b
        shapes = {"tokens": (b, 7), "labels": (b, 7), "embeds": (b, 7, 5),
                  "lens": (b,)}
        want = _jleaves(jp.batch_specs(
            {k: jax.ShapeDtypeStruct(s, jnp.float32)
             for k, s in shapes.items()}))
        got = _tleaves(tp.batch_specs(
            {k: torch.empty(s, device="meta") for k, s in shapes.items()}))
        assert got == want, b
    assert tp.batch_axes == jp.batch_axes


@pytest.mark.parametrize("key", sorted(MESHES))
@pytest.mark.parametrize("name", CONFIGS)
def test_cache_specs_equal_the_reference(name, key):
    """Each package's own decode cache at a batch that divides the data
    axes (16 or 32) and one that does not (3)."""
    for batch in (3, 32):
        jcache, tcache = _caches(name, batch)
        jpaths = jax.tree_util.tree_flatten_with_path(jcache)[0]
        tleaves = ttree.tree_leaves(tcache)
        assert [tuple(a.shape) for _, a in jpaths] == [
            tuple(getattr(t, "shape", ())) for t in tleaves]
        for profile in PROFILES:
            for attn_align in (True, False):
                jp, tp = _policies(name, key, profile, attn_align)
                assert (_tleaves(tp.cache_specs(tcache, batch))
                        == _jleaves(jp.cache_specs(jcache, batch))), (
                    batch, profile, attn_align)


@pytest.mark.parametrize("key", sorted(MESHES))
@pytest.mark.parametrize("name", ("recurrentgemma_2b", "qwen3_moe_235b",
                                  "deepseek_v2_236b", "xlstm_125m"))
def test_zero_extend_and_train_step_shardings_equal_the_reference(name,
                                                                  key):
    shapes = _param_shapes(name)
    meta = _meta(shapes)
    for profile in PROFILES:
        for zero3 in (False, True):
            jp, tp = _policies(name, key, profile, zero3=zero3)
            for js, ts, leaf in zip(
                    jax.tree_util.tree_leaves(
                        jp.param_specs(shapes),
                        is_leaf=lambda x: isinstance(x, JP)),
                    ttree.tree_leaves(tp.param_specs(meta)),
                    jax.tree_util.tree_leaves(shapes)):
                assert (_norm(tsteps.zero_extend(tp, ts, leaf))
                        == _norm(jsteps.zero_extend(jp, js, leaf)))
            for mb, zero_opt in ((32, False), (3, True)):
                batch = {"tokens": (2, mb, 9), "labels": (2, mb, 9)}
                jin, jout = jsteps.train_step_shardings(
                    jp, shapes, {k: jax.ShapeDtypeStruct(s, jnp.int32)
                                 for k, s in batch.items()}, zero_opt)
                tin, tout = tsteps.train_step_shardings(
                    tp, meta, {k: torch.empty(s, device="meta")
                               for k, s in batch.items()}, zero_opt)
                for j, t in ((jin, tin), (jout, tout)):
                    want = [_norm(s.spec) for s in
                            jax.tree_util.tree_leaves(j)]
                    got = [_norm(s.spec) for s in ttree.tree_leaves(t)]
                    assert got == want, (profile, zero3, mb)
                    assert all(s.mesh is tp.mesh
                               for s in ttree.tree_leaves(t))


class _Axes:
    """A mesh stand-in: names only, as ``placements`` reads them."""

    def __init__(self, *names):
        self.axis_names = names


def test_specs_map_to_placements_per_mesh_axis():
    from torch.distributed.tensor import Replicate as R, Shard as S
    two, three = _Axes("data", "model"), _Axes("pod", "data", "model")
    P = tsh.P
    assert tsh.placements(two, P()) == (R(), R())
    assert tsh.placements(two, P(None, "model")) == (R(), S(1))
    assert tsh.placements(two, P("model", None)) == (R(), S(0))
    assert tsh.placements(two, P(("data",), None, "model")) == (S(0), S(2))
    assert tsh.placements(two, P(("data", "model"))) == (S(0), S(0))
    assert tsh.placements(three, P(("pod", "data"), None)) == (S(0), S(0),
                                                                R())
    assert tsh.placements(three, P("data", None, None, "model")) == (
        R(), S(0), S(3))
    with pytest.raises(ValueError, match="mesh order"):
        tsh.placements(three, P(("data", "pod")))
    with pytest.raises(ValueError, match="used twice"):
        tsh.placements(two, P("data", "data"))
    assert P(None, "model") == (None, "model") == P(None, "model")
    assert hash(P("data")) == hash(P("data")) and repr(P()) == "P()"


def test_act_spec_shards_the_sequence_only_under_tp_seq():
    mesh = _mesh("16x16")
    cfg = TC.get_config("smollm_135m")
    seq = tsh.ShardingPolicy(mesh, cfg, "tp_seq")
    tp = tsh.ShardingPolicy(mesh, cfg, "tp")
    fsdp = tsh.ShardingPolicy(mesh, cfg, "fsdp")
    x = torch.empty(4, 32, 8, device="meta")
    assert seq.act_spec(x) == (("data",), "model", None)
    assert seq.act_spec(x[:, :8]) == (("data",), None, None)   # 8 % 16
    assert seq.act_spec(x[:, 0]) == (("data",), None)
    assert tp.act_spec(x) == (("data",), None, None)
    assert fsdp.act_spec(x) == (("data", "model"), None, None)
    y = torch.ones(2, 3)
    assert seq.act_constraint(y) is y            # not a DTensor: unchanged


@pytest.fixture(scope="module")
def host_mesh():
    """A world-1 ``gloo`` group and its 1x1 mesh, torn down after."""
    mesh = tmesh.make_host_mesh("cpu")
    yield mesh
    tdist.shutdown_distributed()


def test_production_mesh_refuses_a_world_of_one(host_mesh):
    with pytest.raises(ValueError, match="needs 256 processes.*has 1"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 processes.*has 1"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="needs 4 processes"):
        tmesh.make_lm_mesh((2, 2), "cpu")
    assert tmesh.axis_names(host_mesh) == ("data", "model")
    assert tmesh.axis_size(host_mesh, "model") == 1
    assert tmesh.data_axes(host_mesh) == ("data",)
    assert tmesh.model_axis(host_mesh) == "model"


def test_shard_tree_and_act_constraint_on_a_world_one_group(host_mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    cfg = TC.get_smoke_config("recurrentgemma_2b")
    params = tmodel.build_model(cfg).init(torch.Generator().manual_seed(0),
                                          device="cpu")
    policy = tsh.ShardingPolicy(host_mesh, cfg, "tp_seq")
    shardings = policy.param_shardings(params)
    sharded = tsh.shard_tree(params, shardings)
    n_model = 0
    for t, dt, sh in zip(ttree.tree_leaves(params), ttree.tree_leaves(sharded),
                         ttree.tree_leaves(shardings)):
        assert isinstance(dt, DTensor)
        assert tuple(dt.placements) == sh.placements == tsh.placements(
            host_mesh, sh.spec)
        assert torch.equal(dt.full_tensor(), t)
        n_model += "model" in tuple(sh.spec)
    assert n_model > 0
    x = DTensor.from_local(torch.randn(2, 4, 3), host_mesh,
                           [Replicate(), Replicate()])
    y = policy.act_constraint(x)
    assert tuple(y.placements) == (Shard(0), Shard(1))
    assert torch.equal(y.full_tensor(), x.full_tensor())


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_a_world_one_policy_serves_the_unsharded_tokens(host_mesh, backend):
    """RecurrentGemma smoke under ``tp`` on the 1x1 mesh, prompts past the
    window of 16: on either backend (``torch``'s temporal conv also runs on
    each rank's shard), the sharded engine's tokens are the unsharded
    engine's."""
    from repro_torch.serving import engine as tengine
    cfg = TC.get_smoke_config("recurrentgemma_2b")
    params = tmodel.build_model(cfg).init(torch.Generator().manual_seed(1),
                                          device="cpu")
    policy = tsh.ShardingPolicy(host_mesh, cfg)
    sharded = tsh.shard_tree(params, policy.param_shardings(params))
    model = tmodel.build_model(cfg, backend)
    reqs = [tengine.Request(list(range(3, 3 + n)), 4) for n in (17, 19)]
    want = tengine.ServeEngine(model, params, max_seq=32,
                               batch_slots=2).generate(reqs)
    got = tengine.ServeEngine(model, sharded, max_seq=32, batch_slots=2,
                              policy=policy).generate(reqs)
    assert got == want and [len(t) for t in got] == [4, 4]
