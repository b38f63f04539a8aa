"""The port's MoE feed-forward and Multi-head Latent Attention, and the
``qwen3_moe_235b`` and ``deepseek_v2_236b`` smoke models, against the JAX
package on the CPU.

Layer tests fill the reference's layer trees (``init_moe``, ``init_mla``,
read with ``jax.eval_shape``) with seeded numpy values: each matrix
N(0, 1) / sqrt(its fan-in), so outputs are O(1), the norm scales
0.1 * N(0, 1) (so ``1 + scale`` is exercised).  Model tests take
``_torch_params.numpy_lm_params``.  Every float is held at ``rtol = atol =
1e-4`` of the reference's scale (max(1, max|ref|)) in fp32 and 2e-2 in
bf16; routing (expert, position, kept) must be equal, where a top-k choice
differs only at a float tie of the router probabilities (within 1e-6).
Both port backends run (``cuda`` on CPU tensors runs the plain versions;
neither model has a kernel on its path).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import attention as jattn
from repro.models import ffn as jffn
from repro.models import model as jmodel
from repro.serving import engine as jengine
from repro_torch import configs as TC
from repro_torch import tree as ttree
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import convert as tconvert
from repro_torch.models import ffn as tffn
from repro_torch.models import model as tmodel
from repro_torch.serving import engine as tengine

from _torch_params import NORMS, numpy_lm_params

ARCHS = ("qwen3_moe_235b", "deepseek_v2_236b")
TOL, BF16_TOL = 1e-4, 2e-2
# the reference's own prefill/decode-against-forward tolerance for the MoE
# models (tests/test_decode_consistency.py:21-24): capacity drops differ
# between a prefill group and a one-token decode group
MOE_DECODE_ATOL, MOE_DECODE_RTOL = 0.3, 0.1

# the reference's layer functions, jitted (one compile per shape costs less
# than eager dispatch of their many small ops)
_jit = functools.partial(jax.jit, static_argnames="cfg")
J_MOE, J_AUX = _jit(jffn.moe_forward), _jit(jffn.moe_aux_loss)
J_MLA, J_MLA_DECODE = _jit(jattn.mla_forward), _jit(jattn.mla_decode)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, ref, tol=TOL):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


def _cfg(arch, **kw):
    return (dataclasses.replace(JC.get_smoke_config(arch), **kw),
            dataclasses.replace(TC.get_smoke_config(arch), **kw))


def _fill(shapes, seed):
    """Seeded numpy values in a layer tree of ``jax.eval_shape``."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(path[-1].key)
        n = rng.standard_normal(leaf.shape)
        v = 0.1 * n if name in NORMS else n / np.sqrt(leaf.shape[-2])
        return np.asarray(v, np.float32).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def _layer(kind, arch, dtype="float32", seed=0):
    """(jax cfg, torch cfg, numpy tree) of one ``moe`` or ``mla`` layer."""
    jcfg, tcfg = _cfg(arch, dtype=dtype)
    init = jffn.init_moe if kind == "moe" else jattn.init_mla
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg,
                                         jnp.dtype(dtype)))
    return jcfg, tcfg, _fill(shapes, seed)


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            tconvert.params_from_numpy(tree, device="cpu"))


def _x(shape, dtype="float32", seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x, jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


# ---------------------------------------------------------------------------
# MoE.
# ---------------------------------------------------------------------------

def _jax_routing(router, x, cfg):
    """The reference's routing, ``src/repro/models/ffn.py:64-92`` step by
    step (``moe_forward`` keeps it internal): probs, idx, pos, keep."""
    e = cfg.moe
    b, s, d = x.shape
    gs = min(e.group_size, b * s)
    xt = x.reshape(b * s // gs, gs, d)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ router, axis=-1)
    _, idx = jax.lax.top_k(probs, e.top_k)
    cap = max(int(gs * e.top_k * e.capacity_factor / e.num_experts),
              e.top_k)
    sel = jax.nn.one_hot(idx, e.num_experts, dtype=jnp.float32)
    flat = sel.transpose(0, 2, 1, 3).reshape(xt.shape[0], e.top_k * gs,
                                             e.num_experts)
    pos = jnp.einsum("gte,gte->gt", jnp.cumsum(flat, axis=1) - flat, flat)
    keep = pos < cap
    pos = jnp.minimum(pos, cap - 1).astype(jnp.int32)
    back = lambda a: np.asarray(
        a.reshape(xt.shape[0], e.top_k, gs).transpose(0, 2, 1))
    return np.asarray(probs), np.asarray(idx), back(pos), back(keep), cap


def _moe_case(arch, drops):
    """(jcfg, tcfg, params, x): 2 groups of 64 tokens at the smoke
    config's capacity factor, or at E / K, where the capacity is the
    group size and nothing drops."""
    jcfg, tcfg, tree = _layer("moe", arch)
    if not drops:
        e = jcfg.moe
        kw = dict(moe=dataclasses.replace(
            e, capacity_factor=e.num_experts / e.top_k))
        jcfg, tcfg = (dataclasses.replace(jcfg, **kw),
                      dataclasses.replace(tcfg, **kw))
    return jcfg, tcfg, tree, _x((2, 64, jcfg.d_model))


@pytest.mark.parametrize("drops", [True, False], ids=["drops", "no_drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_routing_matches_reference(arch, drops):
    jcfg, tcfg, tree, (jx, tx) = _moe_case(arch, drops)
    jp, tp = _both(tree)
    probs, idx, pos, keep, cap = _jax_routing(jp["router"], jx, jcfg)
    r = tffn.moe_route(tp, tx, tcfg)
    assert r.cap == cap
    got_idx = r.idx.numpy()
    differ = (got_idx != idx).any(-1)                       # (G, N)
    for g, n in zip(*np.nonzero(differ)):
        # a float tie: the two choices' probabilities agree within 1e-6
        np.testing.assert_allclose(np.sort(probs[g, n][got_idx[g, n]]),
                                   np.sort(probs[g, n][idx[g, n]]),
                                   rtol=0, atol=1e-6)
    same = ~differ.any(-1)                                  # whole groups
    np.testing.assert_array_equal(got_idx[same], idx[same])
    np.testing.assert_array_equal(r.pos.numpy()[same], pos[same])
    np.testing.assert_array_equal(r.keep.numpy()[same], keep[same])
    assert (~keep).any() == drops, "the case must (not) drop a slot"
    gates = r.gates.numpy()
    assert (gates[~r.keep.numpy()] == 0).all()
    np.testing.assert_allclose(gates.sum(-1)[r.keep.numpy().all(-1)], 1.0,
                               rtol=1e-6)


@pytest.mark.parametrize("drops", [True, False], ids=["drops", "no_drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(arch, drops):
    """Qwen's layer has no shared expert, DeepSeek's has one."""
    jcfg, tcfg, tree, (jx, tx) = _moe_case(arch, drops)
    jp, tp = _both(tree)
    assert ("shared" in tp) == bool(tcfg.moe.num_shared)
    _close(tffn.moe_forward(tp, tx, tcfg), J_MOE(jp, jx, cfg=jcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_one_group_and_decode_sized_groups(arch):
    """One group smaller than group_size (gs = n_tok) and a decode step's
    4 tokens (capacity top_k)."""
    jcfg, tcfg, tree = _layer("moe", arch)
    jp, tp = _both(tree)
    for shape in ((2, 11, jcfg.d_model), (4, 1, jcfg.d_model)):
        jx, tx = _x(shape, seed=2)
        _close(tffn.moe_forward(tp, tx, tcfg), J_MOE(jp, jx, cfg=jcfg))


def test_moe_refuses_what_the_reference_cannot_reshape():
    jcfg, tcfg, tree = _layer("moe", "qwen3_moe_235b")
    jp, tp = _both(tree)
    jx, tx = _x((1, 65, jcfg.d_model))          # 65 > 64, not a multiple
    with pytest.raises(TypeError):
        J_MOE(jp, jx, cfg=jcfg)
    with pytest.raises(ValueError, match="group size 64"):
        tffn.moe_forward(tp, tx, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_aux_loss_matches_reference(arch):
    jcfg, tcfg, tree = _layer("moe", arch)
    jp, tp = _both(tree)
    jx, tx = _x((2, 64, jcfg.d_model))
    _close(tffn.moe_aux_loss(tp, tx, tcfg), J_AUX(jp, jx, cfg=jcfg))


# ---------------------------------------------------------------------------
# MLA.
# ---------------------------------------------------------------------------

def _positions(b, s):
    p = np.broadcast_to(np.arange(s)[None], (b, s))
    return jnp.asarray(p, jnp.int32), torch.from_numpy(p.copy())


def test_mla_forward_matches_reference():
    jcfg, tcfg, tree = _layer("mla", "deepseek_v2_236b")
    jcfg, tcfg = (dataclasses.replace(c, attn_q_chunk=4, attn_kv_chunk=4)
                  for c in (jcfg, tcfg))
    jp, tp = _both(tree)
    jx, tx = _x((2, 11, jcfg.d_model))
    jpos, tpos = _positions(2, 11)
    _close(tattn.mla_forward(tp, tx, tpos, tcfg),
           J_MLA(jp, jx, jpos, cfg=jcfg))


@pytest.mark.parametrize("pos", [0, 5, 9, 12], ids=lambda p: f"pos{p}")
def test_mla_decode_matches_reference(pos):
    """A cache of 10 positions; pos 12 writes at 9, as
    ``dynamic_update_slice`` clamps it, and attends to every position."""
    jcfg, tcfg, tree = _layer("mla", "deepseek_v2_236b")
    jp, tp = _both(tree)
    m = jcfg.mla
    rng = np.random.default_rng(3)
    cache = {"ckv": rng.standard_normal((2, 10, m.kv_lora_rank)),
             "kr": rng.standard_normal((2, 10, m.qk_rope_dim))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    jc, tc = _both(cache)
    jx, tx = _x((2, 1, jcfg.d_model), seed=4)
    jy, jnew = J_MLA_DECODE(jp, jx, jc, jnp.asarray(pos, jnp.int32),
                            cfg=jcfg)
    ty, tnew = tattn.mla_decode(tp, tx, tc, pos, tcfg)
    _close(ty, jy)
    assert sorted(tnew) == ["ckv", "kr"]
    for k in ("ckv", "kr"):
        _close(tnew[k], jnew[k])
        np.testing.assert_array_equal(tc[k].numpy(), cache[k])  # not in place


def test_mla_absorbed_decode_equals_expanded_forward():
    """The port's own consistency: a 6-token prefill's latent cache and 5
    absorbed decode steps against the expanded forward over 11 tokens."""
    _, tcfg, tree = _layer("mla", "deepseek_v2_236b")
    tp = tconvert.params_from_numpy(tree, device="cpu")
    _, tx = _x((2, 11, tcfg.d_model), seed=5)
    _, tpos = _positions(2, 11)
    full = tattn.mla_forward(tp, tx, tpos, tcfg)
    y, lat = tattn.mla_prefill(tp, tx[:, :6], tpos[:, :6], tcfg)
    _close(y, full[:, :6])
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 10)) for k, v in
             lat.items()}
    for t in range(6, 11):
        y, cache = tattn.mla_decode(tp, tx[:, t:t + 1], cache, t, tcfg)
        _close(y, full[:, t:t + 1])


def test_bf16_layers_match_reference():
    """bf16 at 2e-2: DeepSeek's MoE layer (with its shared expert) and MLA
    forward and decode, on the same bf16 inputs (so the fp32 router sees
    the same values and the routing is the reference's)."""
    jcfg, tcfg, tree = _layer("moe", "deepseek_v2_236b", "bfloat16")
    jp, tp = _both(tree)
    assert tp["wi"].dtype == torch.bfloat16 and tp["router"].dtype == \
        torch.float32
    jx, tx = _x((2, 64, jcfg.d_model), "bfloat16")
    got = tffn.moe_forward(tp, tx, tcfg)
    assert got.dtype == torch.bfloat16
    _close(got, J_MOE(jp, jx, cfg=jcfg), BF16_TOL)
    jcfg, tcfg, tree = _layer("mla", "deepseek_v2_236b", "bfloat16")
    jp, tp = _both(tree)
    jx, tx = _x((2, 9, jcfg.d_model), "bfloat16")
    jpos, tpos = _positions(2, 9)
    _close(tattn.mla_forward(tp, tx, tpos, tcfg),
           J_MLA(jp, jx, jpos, cfg=jcfg), BF16_TOL)
    jc = {"ckv": jnp.zeros((2, 12, jcfg.mla.kv_lora_rank), jnp.bfloat16),
          "kr": jnp.zeros((2, 12, jcfg.mla.qk_rope_dim), jnp.bfloat16)}
    tc = {k: torch.zeros(v.shape, dtype=torch.bfloat16) for k, v in
          jc.items()}
    for t in range(3):
        jy, jc = J_MLA_DECODE(jp, jx[:, t:t + 1], jc,
                              jnp.asarray(t, jnp.int32), cfg=jcfg)
        ty, tc = tattn.mla_decode(tp, tx[:, t:t + 1], tc, t, tcfg)
        assert ty.dtype == tc["ckv"].dtype == torch.bfloat16
        _close(ty, jy, BF16_TOL)


# ---------------------------------------------------------------------------
# The smoke models.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg, tcfg = _cfg(arch, attn_q_chunk=8, attn_kv_chunk=8)
    np_params = numpy_lm_params(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    return (jmodel.LanguageModel(jcfg), jp, tcfg,
            tconvert.params_from_numpy(np_params, device="cpu"))


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


@functools.lru_cache(maxsize=None)
def _reference_run(arch):
    """The JAX model's forward, prefill, engine-aligned caches and six
    decode steps on 2 x 11 tokens, once per arch."""
    jm, jp, tcfg, _ = _pair(arch)
    toks = jnp.asarray(_tokens(tcfg, 2, 11), jnp.int32)
    fwd = np.asarray(jax.jit(jm.forward)(jp, toks))
    logits, cache = jax.jit(jm.prefill)(jp, toks)
    decode = jax.jit(jm.decode_step)
    eng = jengine.ServeEngine(jm, jp, max_seq=32, batch_slots=2)
    aligned = eng._align_cache(cache, 11)
    steps = []
    for step in range(6):
        tok = jnp.asarray(_tokens(tcfg, 2, 1, seed=10 + step)[:, 0],
                          jnp.int32)
        lg, aligned = decode(jp, tok, aligned)
        steps.append(np.asarray(lg))
    return fwd, np.asarray(logits), cache, eng._align_cache(cache, 11), steps


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_models_match_reference(arch, backend):
    """forward, prefill logits and caches, the engine's alignment of the
    caches (DeepSeek's latent ``ckv``/``kr`` left-aligned into max_seq),
    and six decode steps from them."""
    _, _, tcfg, tp = _pair(arch)
    fwd, logits, jcache, jaligned, steps = _reference_run(arch)
    tm = tmodel.build_model(tcfg, backend=backend)
    toks = torch.as_tensor(_tokens(tcfg, 2, 11))
    tops.reset_launch_counts()
    with torch.inference_mode():
        _close(tm.forward(tp, toks), fwd)
        tl, tc = tm.prefill(tp, toks)
        _close(tl, logits)
        assert tc["pos"] == int(jcache["pos"]) == 11
        for cache, ref in ((tc, jcache),
                           (tengine.ServeEngine(tm, tp, max_seq=32,
                                                batch_slots=2)
                            ._align_cache(tc, 11), jaligned)):
            jflat = jax.tree_util.tree_flatten_with_path(ref["layers"])[0]
            tflat = ttree.tree_leaves(cache["layers"])
            assert len(jflat) == len(tflat)
            for (path, b), a in zip(jflat, tflat):
                _close(a, b)
        if arch == "deepseek_v2_236b":
            lat = cache["layers"][0]["k0"]
            m = tcfg.mla
            assert tuple(lat["ckv"].shape) == (1, 2, 32, m.kv_lora_rank)
            assert tuple(lat["kr"].shape) == (1, 2, 32, m.qk_rope_dim)
            assert not lat["ckv"][:, :, 11:].any()
        for step, ref in enumerate(steps):
            tok = _tokens(tcfg, 2, 1, seed=10 + step)[:, 0]
            tl, cache = tm.decode_step(tp, torch.as_tensor(tok), cache)
            _close(tl, ref)
    assert not any(tops.launch_counts().values())


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_engine(arch):
    jm, jp, tcfg, tp = _pair(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist()
               for n in (5, 21, 9)]
    ref = jengine.ServeEngine(jm, jp, max_seq=48, batch_slots=3).generate(
        [jengine.Request(p, 12) for p in prompts])
    for backend in ("torch", "cuda"):
        got = tengine.ServeEngine(tmodel.build_model(tcfg, backend=backend),
                                  tp, max_seq=48, batch_slots=3).generate(
            [tengine.Request(p, 12) for p in prompts])
        assert got == ref, backend


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_within_the_reference_tolerance(arch):
    """The port's own prefill + decode against its forward, as
    ``tests/test_decode_consistency.py`` holds the reference: 2 x 12
    tokens, prefill of 6, at the reference's MoE tolerance."""
    tcfg = TC.get_smoke_config(arch)
    tm = tmodel.build_model(tcfg)
    tp = tm.init(torch.Generator().manual_seed(1), device="cpu")
    toks = torch.as_tensor(_tokens(tcfg, 2, 12, seed=7))
    with torch.inference_mode():
        full = tm.forward(tp, toks).numpy()
        lg, cache = tm.prefill(tp, toks[:, :6])
        cache = tengine.ServeEngine(tm, tp, max_seq=16)._align_cache(cache,
                                                                      6)
        np.testing.assert_allclose(lg.numpy(), full[:, 5],
                                   atol=MOE_DECODE_ATOL, rtol=MOE_DECODE_RTOL)
        for t in range(6, 12):
            lg, cache = tm.decode_step(tp, toks[:, t], cache)
            np.testing.assert_allclose(lg.numpy(), full[:, t],
                                       atol=MOE_DECODE_ATOL,
                                       rtol=MOE_DECODE_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_the_stacked_expert_weights(arch, dtype):
    jcfg, _ = _cfg(arch, dtype=dtype)
    np_params = numpy_lm_params(jcfg)
    tp = tconvert.params_from_numpy(np_params, device="cpu")
    ffn = tp["segments"][-1]["k0"]["ffn"]
    e = jcfg.moe
    assert tuple(ffn["wi"].shape) == (jcfg.num_layers - e.first_dense_layers,
                                      e.num_experts, jcfg.d_model, e.d_expert)
    assert ffn["wo"].dtype == getattr(torch, dtype)
    assert ffn["router"].dtype == torch.float32
    back = tconvert.params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(np_params),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_prints_one_line_per_prompt(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--max-new",
                "4", "--prompts", "1 2 3", "4 5", "6"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(" -> ")[0] for ln in lines] == [
        "prompt [1 2 3]", "prompt [4 5]", "prompt [6]"]
    for ln in lines:
        toks = eval(ln.split(" -> ")[1])
        assert len(toks) == 4 and all(0 <= t < 256 for t in toks)
