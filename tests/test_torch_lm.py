"""The port's LM serving stack against the JAX package, on the CPU.

The same seeded numpy parameters (the reference tree's shapes and dtypes,
read with ``jax.eval_shape``; norm scales non-zero so ``1 + scale`` is
exercised) go into ``repro.models.model.LanguageModel`` and
``repro_torch.models.model.LanguageModel`` for the RecurrentGemma and
SmolLM smoke configs.  ``forward`` logits, ``prefill`` logits and caches,
six decode steps and ``ServeEngine.generate``'s token lists (past the smoke
window of 16, so the rolling-window decode runs) must agree: every float
at ``rtol = atol = 1e-4`` of the logits' scale, tokens exactly.  Both
backends of the port are held to the reference (``cuda`` on CPU tensors
runs the kernel wrappers' plain versions).  The config registry's plans,
layer patterns and parameter counts equal the reference's for all ten
production configs, and the launcher prints one line per prompt.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import model as jmodel
from repro.models import stack as jstack
from repro.serving import engine as jengine
from repro_torch import configs as TC
from repro_torch import tree as ttree
from repro_torch.kernels import ops as tops
from repro_torch.models import convert as tconvert
from repro_torch.models import model as tmodel
from repro_torch.models import stack as tstack
from repro_torch.serving import engine as tengine

from _torch_params import numpy_lm_params

ARCHS = ("recurrentgemma_2b", "smollm_135m")
MOE_ARCHS = ("qwen3_moe_235b", "deepseek_v2_236b")
TOL = 1e-4


def _cfg(arch, **kw):
    return dataclasses.replace(JC.get_smoke_config(arch), **kw), \
        dataclasses.replace(TC.get_smoke_config(arch), **kw)


@functools.lru_cache(maxsize=None)
def _pair(arch, chunks=False):
    kw = dict(attn_q_chunk=8, attn_kv_chunk=8) if chunks else {}
    jcfg, tcfg = _cfg(arch, **kw)
    np_params = numpy_lm_params(jcfg)
    jm = jmodel.LanguageModel(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = tconvert.params_from_numpy(np_params, device="cpu")
    return jm, jp, tcfg, tp


def _close(got, ref, scale):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * scale)


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, backend):
    jm, jp, tcfg, tp = _pair(arch)
    tm = tmodel.build_model(tcfg, backend=backend)
    toks = _tokens(tcfg, 2, 11)
    with torch.inference_mode():
        ref = np.asarray(jm.forward(jp, jnp.asarray(toks, jnp.int32)))
        scale = max(1.0, float(np.abs(ref).max()))
        _close(tm.forward(tp, torch.as_tensor(toks)), ref, scale)
        jl, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32))
        tl, tc = tm.prefill(tp, torch.as_tensor(toks))
        _close(tl, jl, scale)
        assert tc["pos"] == int(jc["pos"]) == 11
        jflat = jax.tree_util.tree_leaves(jc["layers"])
        tflat = ttree.tree_leaves(tc["layers"])
        assert len(jflat) == len(tflat)
        for a, b in zip(tflat, jflat):
            _close(a, b, max(1.0, float(np.abs(np.asarray(b, np.float32))
                                        .max())))
        # six decode steps from the prefill caches, aligned as the engine
        # aligns them (the window's rolling buffer and a max_seq of 32)
        jeng = jengine.ServeEngine(jm, jp, max_seq=32, batch_slots=2)
        teng = tengine.ServeEngine(tm, tp, max_seq=32, batch_slots=2)
        jc, tc = jeng._align_cache(jc, 11), teng._align_cache(tc, 11)
        for step in range(6):
            tok = _tokens(tcfg, 2, 1, seed=10 + step)[:, 0]
            jl, jc = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc)
            tl, tc = tm.decode_step(tp, torch.as_tensor(tok), tc)
            _close(tl, jl, max(1.0, float(np.abs(np.asarray(jl)).max())))
        assert tc["pos"] == int(jc["pos"])


@pytest.mark.parametrize("arch,chunks", [("recurrentgemma_2b", False),
                                         ("recurrentgemma_2b", True),
                                         ("smollm_135m", False)])
def test_generate_matches_reference_engine(arch, chunks):
    """Mixed prompt lengths; the longest runs 21 + 12 positions, past the
    smoke window of 16, so the rolling-window decode and (RG) the
    right-aligned window buffer are exercised."""
    jm, jp, tcfg, tp = _pair(arch, chunks)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist()
               for n in (5, 21, 9)]
    jreqs = [jengine.Request(p, 12) for p in prompts]
    treqs = [tengine.Request(p, 12) for p in prompts]
    ref = jengine.ServeEngine(jm, jp, max_seq=48, batch_slots=4).generate(
        jreqs)
    for backend in ("torch", "cuda"):
        tm = tmodel.build_model(tcfg, backend=backend)
        got = tengine.ServeEngine(tm, tp, max_seq=48,
                                  batch_slots=4).generate(treqs)
        assert got == ref, backend


def test_cuda_backend_routes_the_temporal_conv_through_the_kernel_wrapper(
        monkeypatch):
    """On backend ``cuda`` every rec layer's prefill calls
    ``ops.fuse_conv1d_temporal`` once and a decode step never; on
    ``torch`` it is never called."""
    _, _, tcfg, tp = _pair("recurrentgemma_2b")
    calls = []
    real = tops.fuse_conv1d_temporal
    monkeypatch.setattr(tops, "fuse_conv1d_temporal",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    n_rec = tcfg.layer_pattern.count("rec")
    toks = torch.as_tensor(_tokens(tcfg, 2, 7))
    with torch.inference_mode():
        for backend, per_call in (("cuda", n_rec), ("torch", 0)):
            tm = tmodel.build_model(tcfg, backend=backend)
            calls.clear()
            tm.forward(tp, toks)
            _, cache = tm.prefill(tp, toks)
            assert len(calls) == 2 * per_call
            tm.decode_step(tp, toks[:, 0], cache)
            assert len(calls) == 2 * per_call


@pytest.mark.parametrize("arch", JC.list_configs())
def test_registry_matches_reference(arch):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.layer_pattern == jcfg.layer_pattern
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert [dataclasses.astuple(s) for s in tstack.plan_segments(tcfg)] == \
        [dataclasses.astuple(s) for s in jstack.plan_segments(jcfg)]
    # the port's model accepts every layer of the plan, MoE and MLA too
    assert tmodel.build_model(tcfg)._check() == tstack.plan_segments(tcfg)
    assert dataclasses.asdict(TC.get_smoke_config(arch)) == \
        dataclasses.asdict(JC.get_smoke_config(arch))
    assert TC.ALIASES == JC.ALIASES and TC.list_configs() == JC.list_configs()


def test_production_recurrentgemma_plan():
    cfg = TC.get_config("recurrentgemma_2b")
    segs = tstack.plan_segments(cfg)
    assert len(segs) == 1 and segs[0].repeats == 1
    assert len(segs[0].kinds) == 26
    assert cfg.layer_pattern.count("rec") == 18
    assert cfg.layer_pattern.count("attn") == 8
    assert 2.6e9 < cfg.param_count() < 2.8e9


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_reference_shapes(arch, dtype):
    jcfg, tcfg = _cfg(arch, dtype=dtype)
    shapes = jax.eval_shape(
        lambda: jmodel.LanguageModel(jcfg).init(jax.random.PRNGKey(0)))
    tp = tmodel.build_model(tcfg).init(torch.Generator().manual_seed(0),
                                       device="cpu")
    jpaths = jax.tree_util.tree_flatten_with_path(shapes)[0]
    tleaves = ttree.tree_leaves(tp)
    assert len(jpaths) == len(tleaves)
    for (path, j), t in zip(jpaths, tleaves):
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).replace("torch.", "") == str(j.dtype), path
    assert all(torch.isfinite(t.float()).all() for t in tleaves)


def test_unported_kinds_raise_with_their_roadmap_item():
    """A policy that is not a ``ShardingPolicy`` raises at the engine and
    an unknown layer kind at the model; the MoE and MLA models (item 9.3,
    ported) build, ``init`` and ``init_cache``, DeepSeek's attention
    caches latent ``ckv``/``kr`` of the reference's shapes."""
    with pytest.raises(TypeError, match="must be a ShardingPolicy or None, "
                                        "not object"):
        tengine.ServeEngine(None, {}, policy=object())
    bad = dataclasses.replace(TC.get_smoke_config("smollm_135m"),
                              block_pattern=("attn", "conv"))
    with pytest.raises(ValueError, match="unknown layer kind 'conv'"):
        tmodel.build_model(bad).init(torch.Generator().manual_seed(0),
                                     device="cpu")
    for arch in MOE_ARCHS:
        jcfg, tcfg = _cfg(arch)
        m = tmodel.build_model(tcfg)
        params = m.init(torch.Generator().manual_seed(0), device="cpu")
        assert "router" in params["segments"][-1]["k0"]["ffn"]
        ref = jax.eval_shape(
            lambda: jmodel.LanguageModel(jcfg).init_cache(2, 8))
        cache = m.init_cache(2, 8, device="cpu")
        jpaths = jax.tree_util.tree_flatten_with_path(ref["layers"])[0]
        tleaves = ttree.tree_leaves(cache["layers"])
        assert len(jpaths) == len(tleaves)
        for (path, j), t in zip(jpaths, tleaves):
            assert tuple(t.shape) == tuple(j.shape), path
            assert not t.any()
        names = {str(path[-1].key) for path, _ in jpaths}
        assert names == ({"ckv", "kr"} if tcfg.attn_kind == "mla"
                         else {"k", "v"})


def test_a_dropped_engine_frees_its_parameters_without_the_collector():
    """No reference cycle through the engine's prefill and decode
    closures: dropping the last reference frees the parameters at once
    (on the card, gigabytes that would stay allocated until a collection
    and inflate the next model's peak memory)."""
    import gc
    import weakref
    _, _, tcfg, tp = _pair("smollm_135m")
    params = dict(tp)
    engine = tengine.ServeEngine(tmodel.build_model(tcfg), params,
                                 max_seq=16, batch_slots=1)
    engine.generate([tengine.Request([1, 2], 2)])
    alive = weakref.ref(engine)
    gc.disable()
    try:
        del engine
        assert alive() is None
    finally:
        gc.enable()


def test_convert_roundtrips_bfloat16():
    _, tcfg = _cfg("recurrentgemma_2b", dtype="bfloat16")
    jcfg, _ = _cfg("recurrentgemma_2b", dtype="bfloat16")
    np_params = numpy_lm_params(jcfg)
    tp = tconvert.params_from_numpy(np_params, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    back = tconvert.params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(np_params),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_launcher_prints_one_line_per_prompt(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "recurrentgemma_2b", "--smoke", "--device", "cpu",
                "--max-new", "5", "--prompts", "1 2 3", "4 5", "6"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(" -> ")[0] for ln in lines] == [
        "prompt [1 2 3]", "prompt [4 5]", "prompt [6]"]
    for ln in lines:
        toks = eval(ln.split(" -> ")[1])
        assert len(toks) == 5 and all(0 <= t < 256 for t in toks)
