"""The port's memory-attending layers (``cross``, ``dec``, ``enc``), the
encoder-decoder and cross-attention models, and the Whisper stems against
the JAX package, on the CPU.

The same seeded numpy parameters (``_torch_params.numpy_lm_params``: the
reference tree of the ``whisper_tiny`` and ``llama32_vision_90b`` smoke
configs, with the cross layers' tanh gates non-zero) and the same numpy
memory embeddings go into ``repro.models`` and ``repro_torch.models``.
Held at ``rtol = atol = 1e-4`` of the output's (or the logits') scale, as
``test_torch_lm.py``: the port's cross-attention against the reference's
``gqa_forward`` with ``kv_override``; each layer
kind's forward, prefill (output and cache) and decode step; the models'
``forward``, ``prefill``, caches and six decode steps with
``memory_embeds`` or ``vision_embeds`` in ``extras``; ``ServeEngine``'s
token lists, exactly.  Both port backends run (``cuda`` on CPU tensors
runs the kernel wrappers' plain versions).  Both Whisper stems are held to
``repro.models.stems``, the FuSe stem also to its kernel form (the Pallas
``fuse1d`` through ``repro.kernels.ops.fuse_conv1d_temporal(causal=False)``
in interpret mode).  The LM launcher refuses the memory models with one
line.
"""
import dataclasses
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import stack as jstack
from repro.models import stems as jstems
from repro.serving import engine as jengine
from repro_torch import configs as TC
from repro_torch import tree as ttree
from repro_torch.kernels import ops as tops
from repro_torch.kernels.backend import resolve_backend
from repro_torch.models import attention as tattn
from repro_torch.models import convert as tconvert
from repro_torch.models import model as tmodel
from repro_torch.models import stack as tstack
from repro_torch.models import stems as tstems
from repro_torch.serving import engine as tengine

from _torch_params import numpy_lm_params

ARCHS = ("whisper_tiny", "llama32_vision_90b")
TOL = 1e-4


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, ref, tol=TOL, scale=None):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if scale is None:
        scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


def _n(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg = dataclasses.replace(JC.get_smoke_config(arch), attn_q_chunk=8,
                               attn_kv_chunk=8)
    tcfg = dataclasses.replace(TC.get_smoke_config(arch), attn_q_chunk=8,
                               attn_kv_chunk=8)
    np_params = numpy_lm_params(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = tconvert.params_from_numpy(np_params, device="cpu")
    return jmodel.LanguageModel(jcfg), jp, tcfg, tp


def _memory(cfg, b, seed=5):
    """(extras key, (B, M, D) numpy memory) of the model's modality."""
    if cfg.encoder_layers:
        return "memory_embeds", _n(np.random.default_rng(seed), b,
                                   cfg.encoder_seq, cfg.d_model)
    return "vision_embeds", _n(np.random.default_rng(seed), b,
                               cfg.num_vision_tokens, cfg.d_model)


def _extras(cfg, b, seed=5):
    key, mem = _memory(cfg, b, seed)
    return {key: jnp.asarray(mem)}, {key: torch.from_numpy(mem)}


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _first(tree):
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[0]


# ---------------------------------------------------------------------------
# attention and layers
# ---------------------------------------------------------------------------

def test_gqa_forward_with_kv_override():
    """Cross-attention over a memory, as the port's ``cross`` and ``dec``
    layers compose it (``attend`` of ``query`` over ``memory_kv``, not
    causal), against the reference's ``gqa_forward(kv_override=)``: keys
    and values through wk and wv, no rope, no causal mask; chunks of 4 over
    9 queries and 13 keys."""
    cfg = dataclasses.replace(JC.get_smoke_config("llama32_vision_90b"),
                              attn_q_chunk=4, attn_kv_chunk=4)
    rng = np.random.default_rng(4)
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": _n(rng, d, h * hd, scale=d ** -0.5),
         "wk": _n(rng, d, kh * hd, scale=d ** -0.5),
         "wv": _n(rng, d, kh * hd, scale=d ** -0.5),
         "wo": _n(rng, h * hd, d, scale=(h * hd) ** -0.5)}
    x, mem = _n(rng, 2, 9, d), _n(rng, 2, 13, d)
    positions = np.broadcast_to(np.arange(9), (2, 9))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    got = tattn.attend(tp, tattn.query(tp, torch.from_numpy(x), cfg),
                       *tattn.memory_kv(tp, torch.from_numpy(mem), cfg), cfg,
                       causal=False)
    ref = jattn.gqa_forward(jp, jnp.asarray(x), jnp.asarray(positions), cfg,
                            kv_override=(jnp.asarray(mem), None))
    _close(got, ref)


def _layer(arch, kind):
    """(reference config, jax layer, port config, port layer): superblock
    0's ``cross`` (k4 of the VLM), ``dec`` (k0 of Whisper) or encoder layer
    0 (``enc``)."""
    jm, jp, tcfg, tp = _pair(arch)
    if kind == "enc":
        return jm.cfg, _first(jp["encoder"]), tcfg, _first(tp["encoder"])
    key = "k4" if kind == "cross" else "k0"
    return (jm.cfg, _first(jp["segments"][0][key]), tcfg,
            _first(tp["segments"][0][key]))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("arch,kind", [("llama32_vision_90b", "cross"),
                                       ("whisper_tiny", "dec"),
                                       ("whisper_tiny", "enc")])
def test_layers_match_reference(arch, kind, backend):
    jcfg, jlp, tcfg, tlp = _layer(arch, kind)
    rng = np.random.default_rng(6)
    x, mem = _n(rng, 2, 9, jcfg.d_model), _n(rng, 2, 13, jcfg.d_model)
    positions = np.broadcast_to(np.arange(9), (2, 9)).copy()
    jctx = {"positions": jnp.asarray(positions), "window": None,
            "memory": jnp.asarray(mem), "memory_len": 13}
    tctx = {"positions": torch.from_numpy(positions), "window": None,
            "memory": torch.from_numpy(mem), "memory_len": 13,
            "backend": resolve_backend(backend)}
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    ref = jstack.layer_forward(jlp, jx, kind, jcfg, False, jctx)
    _close(tstack.layer_forward(tlp, tx, kind, tcfg, False, tctx), ref)
    if kind == "enc":
        return
    jy, jc = jstack.layer_prefill(jlp, jx, kind, jcfg, False, jctx)
    ty, tc = tstack.layer_prefill(tlp, tx, kind, tcfg, False, tctx)
    _close(ty, jy)
    _close(ty, ref)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        _close(tc[k], jc[k])
    # one decode step at position 9 from the prefill's cache, the self
    # cache left-aligned in 12 slots as the engine aligns it
    if kind == "dec":
        jc = dict(jc, k=jnp.pad(jc["k"], ((0, 0), (0, 3), (0, 0), (0, 0))),
                  v=jnp.pad(jc["v"], ((0, 0), (0, 3), (0, 0), (0, 0))))
        tc = dict(tc, k=torch.nn.functional.pad(tc["k"], (0, 0, 0, 0, 0, 3)),
                  v=torch.nn.functional.pad(tc["v"], (0, 0, 0, 0, 0, 3)))
    xt = _n(rng, 2, 1, jcfg.d_model)
    jy, jc2 = jstack.layer_decode(jlp, jnp.asarray(xt), jc, kind, jcfg,
                                  False, jnp.asarray(9, jnp.int32), jctx)
    ty, tc2 = tstack.layer_decode(tlp, torch.from_numpy(xt), tc, kind, tcfg,
                                  False, 9, tctx)
    _close(ty, jy)
    assert sorted(tc2) == sorted(jc2)
    for k in jc2:
        _close(tc2[k], jc2[k])


# ---------------------------------------------------------------------------
# models, engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, backend):
    jm, jp, tcfg, tp = _pair(arch)
    tm = tmodel.build_model(tcfg, backend=backend)
    jex, tex = _extras(tcfg, 2)
    toks = _tokens(tcfg, 2, 11)
    with torch.inference_mode():
        ref = np.asarray(jm.forward(jp, jnp.asarray(toks, jnp.int32), jex))
        scale = max(1.0, float(np.abs(ref).max()))
        _close(tm.forward(tp, torch.as_tensor(toks), tex), ref, scale=scale)
        jl, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32), jex)
        tl, tc = tm.prefill(tp, torch.as_tensor(toks), tex)
        _close(tl, jl, scale=scale)
        assert tc["pos"] == int(jc["pos"]) == 11
        jflat = jax.tree_util.tree_leaves(jc["layers"])
        tflat = ttree.tree_leaves(tc["layers"])
        assert len(jflat) == len(tflat)
        for a, b in zip(tflat, jflat):
            _close(a, b)
        jeng = jengine.ServeEngine(jm, jp, max_seq=32, batch_slots=2,
                                   extras=jex)
        teng = tengine.ServeEngine(tm, tp, max_seq=32, batch_slots=2,
                                   extras=tex)
        jc, tc = jeng._align_cache(jc, 11), teng._align_cache(tc, 11)
        for step in range(6):
            tok = _tokens(tcfg, 2, 1, seed=10 + step)[:, 0]
            jl, jc = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc, jex)
            tl, tc = tm.decode_step(tp, torch.as_tensor(tok), tc, tex)
            _close(tl, jl, scale=max(1.0, float(np.abs(np.asarray(jl))
                                                .max())))
        assert tc["pos"] == int(jc["pos"])


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_engine(arch):
    jm, jp, tcfg, tp = _pair(arch)
    jex, tex = _extras(tcfg, 4, seed=7)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist()
               for n in (5, 13, 9)]
    ref = jengine.ServeEngine(jm, jp, max_seq=32, batch_slots=4,
                              extras=jex).generate(
        [jengine.Request(p, 8) for p in prompts])
    for backend in ("torch", "cuda"):
        tm = tmodel.build_model(tcfg, backend=backend)
        got = tengine.ServeEngine(tm, tp, max_seq=32, batch_slots=4,
                                  extras=tex).generate(
            [tengine.Request(p, 8) for p in prompts])
        assert got == ref, backend


@pytest.mark.parametrize("arch", ARCHS + ("xlstm_125m",))
def test_convert_roundtrips_bfloat16(arch):
    """The reference's bf16 tree (stacked encoder, ``vision_proj``, the
    sLSTM's block-diagonal ``r_gates``, the gates) into the port and
    back, bit for bit."""
    jcfg = dataclasses.replace(JC.get_smoke_config(arch), dtype="bfloat16")
    np_params = numpy_lm_params(jcfg)
    tp = tconvert.params_from_numpy(np_params, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in ttree.tree_leaves(tp))
    back = tconvert.params_to_numpy(tp)
    jpaths = jax.tree_util.tree_flatten_with_path(np_params)[0]
    for (path, a), b in zip(jpaths, jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_models_need_their_embeddings(arch):
    _, _, tcfg, tp = _pair(arch)
    key, _ = _memory(tcfg, 1)
    with pytest.raises(ValueError, match=key):
        tmodel.build_model(tcfg).forward(tp, torch.zeros(1, 3, dtype=int))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference_shapes(arch, dtype):
    jcfg = dataclasses.replace(JC.get_smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_smoke_config(arch), dtype=dtype)
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
    assert ("encoder" in tp) == bool(tcfg.encoder_layers)
    assert ("vision_proj" in tp) == bool(tcfg.num_vision_tokens)


def test_production_plans():
    wh = TC.get_config("whisper_tiny")
    assert [(s.kinds, s.repeats) for s in tstack.plan_segments(wh)] == [
        (("dec",), 4)]
    assert (wh.encoder_layers, wh.d_model, wh.num_heads, wh.d_ff,
            wh.vocab_size) == (4, 384, 6, 1536, 51865)
    assert round(wh.param_count() / 1e9, 3) == 0.036
    vl = dataclasses.replace(TC.get_config("llama32_vision_90b"),
                             num_layers=10)
    assert [i for i, k in enumerate(vl.layer_pattern) if k == "cross"] == \
        [4, 9]
    assert (vl.d_model, vl.num_heads, vl.num_kv_heads, vl.d_ff,
            vl.vocab_size) == (8192, 64, 8, 28672, 128256)
    assert round(vl.param_count() / 1e9, 2) == 10.66


# ---------------------------------------------------------------------------
# stems
# ---------------------------------------------------------------------------

def _stem_params(rng, n_mels, d):
    ref = {"c1": _n(rng, 3, n_mels, d, scale=(3 * n_mels) ** -0.5),
           "c2": _n(rng, 3, d, d, scale=(3 * d) ** -0.5)}
    fuse = {"pw_in": _n(rng, n_mels, d, scale=n_mels ** -0.5),
            "t1": _n(rng, 3, d, scale=0.5), "t2": _n(rng, 3, d, scale=0.5),
            "pw_out": _n(rng, d, d, scale=d ** -0.5)}
    return ref, fuse


@pytest.mark.parametrize("t", [40, 41])
def test_stems_match_reference(t):
    """Both stems on an even and an odd frame count (XLA's SAME split at
    stride 2 is (0, 1) on an even extent); the FuSe stem on both backends
    against the reference's lax form and its kernel form."""
    rng = np.random.default_rng(8)
    ref_p, fuse_p = _stem_params(rng, 80, 64)
    mel = _n(rng, 2, t, 80)
    tmel, jmel = torch.from_numpy(mel), jnp.asarray(mel)
    J = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    T = functools.partial(ttree.tree_map, torch.from_numpy)
    got = tstems.whisper_stem(T(ref_p), tmel)
    assert tuple(got.shape) == (2, -(-t // 2), 64)
    _close(got, jstems.whisper_stem(J(ref_p), jmel))
    lax_ref = jstems.fuse_whisper_stem(J(fuse_p), jmel)
    jp = J(fuse_p)
    y = jax.nn.gelu(jops.fuse_conv1d_temporal(jmel @ jp["pw_in"], jp["t1"],
                                              causal=False))
    y = jops.fuse_conv1d_temporal(y, jp["t2"], causal=False)[:, ::2]
    kernel_ref = jax.nn.gelu(y @ jp["pw_out"])
    for backend in ("torch", "cuda"):
        got = tstems.fuse_whisper_stem(T(fuse_p), tmel, backend)
        _close(got, lax_ref)
        _close(got, kernel_ref)


def test_fuse_stem_runs_two_centred_banks_on_cuda(monkeypatch):
    calls = []
    real = tops.fuse_conv1d_temporal
    monkeypatch.setattr(tops, "fuse_conv1d_temporal",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    p = tstems.init_fuse_whisper_stem(torch.Generator().manual_seed(0), 80,
                                      32)
    mel = torch.randn(1, 12, 80, generator=torch.Generator().manual_seed(1))
    tstems.fuse_whisper_stem(p, mel, "torch")
    assert calls == []
    tstems.fuse_whisper_stem(p, mel, "cuda")
    assert calls == [{"causal": False}] * 2


def test_stem_init_and_macs_match_reference():
    for init_t, init_j in ((tstems.init_whisper_stem,
                            jstems.init_whisper_stem),
                           (tstems.init_fuse_whisper_stem,
                            jstems.init_fuse_whisper_stem)):
        got = init_t(torch.Generator().manual_seed(0), 80, 48)
        ref = init_j(jax.random.PRNGKey(0), 80, 48)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert tuple(got[k].shape) == ref[k].shape
            assert abs(float(got[k].std()) - float(ref[k].std())) < \
                0.2 * float(ref[k].std())
    for args in ((80, 384, 3000), (80, 64, 41)):
        assert tstems.stem_macs(*args) == jstems.stem_macs(*args)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_refuses_memory_models_in_one_line(arch):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu"], capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    lines = proc.stderr.strip().splitlines()
    assert len(lines) == 1 and "Traceback" not in proc.stderr, proc.stderr
    assert "no source of memory embeddings" in lines[0]
    assert "src/repro/launch/serve.py:28-32" in lines[0]
