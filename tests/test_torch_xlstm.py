"""The port's xLSTM blocks (mLSTM ``xm``, sLSTM ``xs``) against the JAX
package, on the CPU.

The same seeded numpy parameters (``_torch_params.numpy_lm_params``: the
reference tree of the ``xlstm_125m`` smoke config, norm scales non-zero)
go into ``repro.models`` and ``repro_torch.models``.  Held at ``rtol = atol
= 1e-4`` of the output's (or the logits') scale, as ``test_torch_lm.py``:
the blocks' forward and decode step; the port's hoisted prefill (the
projections and the conv over the whole prompt, then the cell over time)
against the reference's ``layer_prefill`` (the decode step scanned over
the prompt), outputs and every state leaf, also in bfloat16 at the
reference's bf16 tolerance of 2e-2 (``tests/test_kernels.py:19-28``) and
at a prompt shorter than the conv's K-1; the model's ``forward``,
``prefill``, caches and six decode steps; and ``ServeEngine``'s token
lists, exactly.  Both port backends run (``cuda`` on CPU tensors runs the
kernel wrappers' plain versions).  The launcher serves the smoke model.
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
from repro.models import recurrent as jrec
from repro.models import stack as jstack
from repro.serving import engine as jengine
from repro_torch import configs as TC
from repro_torch import tree as ttree
from repro_torch.kernels import ops as tops
from repro_torch.kernels.backend import resolve_backend
from repro_torch.models import convert as tconvert
from repro_torch.models import model as tmodel
from repro_torch.models import recurrent as trec
from repro_torch.models import stack as tstack
from repro_torch.serving import engine as tengine

from _torch_params import numpy_lm_params

ARCH = "xlstm_125m"
TOL = 1e-4
BF16_TOL = 2e-2
BLOCKS = {"xm": ("k0", jrec.mlstm_block_forward, jrec.mlstm_block_decode,
                 trec.mlstm_block_forward, trec.mlstm_block_decode),
          "xs": ("k3", jrec.slstm_block_forward, jrec.slstm_block_decode,
                 trec.slstm_block_forward, trec.slstm_block_decode)}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, ref, tol=TOL, scale=None):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    finite = np.isfinite(ref)
    assert np.array_equal(finite, np.isfinite(got))   # m starts at -inf
    np.testing.assert_array_equal(got[~finite], ref[~finite])
    if scale is None:
        scale = max(1.0, float(np.abs(ref[finite]).max(initial=0.0)))
    np.testing.assert_allclose(got[finite], ref[finite], rtol=tol,
                               atol=tol * scale)


@functools.lru_cache(maxsize=None)
def _pair(dtype="float32"):
    jcfg = dataclasses.replace(JC.get_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_smoke_config(ARCH), dtype=dtype)
    np_params = numpy_lm_params(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = tconvert.params_from_numpy(np_params, device="cpu")
    return jmodel.LanguageModel(jcfg), jp, tcfg, tp


def _layer(params, kind):
    """Superblock 0's ``xm`` (k0) or ``xs`` (k3) layer."""
    key = BLOCKS[kind][0]
    seg = params["segments"][0][key]
    if isinstance(seg["ln"], torch.Tensor):
        return ttree.tree_map(lambda a: a[0], seg)
    return jax.tree_util.tree_map(lambda a: a[0], seg)


def _x(cfg, b, s, seed, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model))
    return (torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype)),
            jnp.asarray(x, jnp.float32).astype(dtype))


def _state(cfg, kind, b, seed):
    """A random decode state: conv window, fp32 cell, finite m."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jstack.init_layer_cache(
        kind, cfg, b, 0, jnp.float32, {}))
    return {k: np.asarray(rng.standard_normal(v.shape)
                          * (0.5 if k != "n" else 1.0), np.float32)
            for k, v in shapes.items()}


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("kind", ["xm", "xs"])
def test_block_forward_and_decode_match_reference(kind, backend):
    jm, jp, tcfg, tp = _pair()
    _, jfwd, jdec, tfwd, tdec = BLOCKS[kind]
    jlp, tlp = _layer(jp, kind)["blk"], _layer(tp, kind)["blk"]
    tx, jx = _x(tcfg, 2, 9, seed=2)
    _close(tfwd(tlp, tx, tcfg, resolve_backend(backend)),
           jfwd(jlp, jx, jm.cfg))
    st = _state(jm.cfg, kind, 2, seed=3)
    ty, ts = tdec(tlp, tx[:, :1], {k: torch.from_numpy(v)
                                   for k, v in st.items()}, tcfg)
    jy, js = jdec(jlp, jx[:, :1], {k: jnp.asarray(v) for k, v in st.items()},
                  jm.cfg)
    _close(ty, jy)
    assert sorted(ts) == sorted(js)
    for k in js:
        _close(ts[k], js[k])
        assert ts[k].dtype == (torch.float32 if k != "conv" else tx.dtype)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("s", [2, 11])
@pytest.mark.parametrize("kind", ["xm", "xs"])
def test_hoisted_prefill_matches_reference_layer_prefill(kind, s, dtype, tol,
                                                         backend):
    """The port's prefill against the reference's decode step scanned over
    the prompt: every position's output and every leaf of the final state
    (at S = 2 < K-1 the conv tail is left-padded with zeros)."""
    jm, jp, tcfg, tp = _pair(dtype)
    jlp, tlp = _layer(jp, kind), _layer(tp, kind)
    tx, jx = _x(tcfg, 2, s, seed=4, dtype=dtype)
    jy, js = jstack.layer_prefill(jlp, jx, kind, jm.cfg, False,
                                  {"positions": None, "window": None})
    ty, ts = tstack.layer_prefill(tlp, tx, kind, tcfg, False,
                                  {"backend": resolve_backend(backend)})
    assert ty.dtype == tx.dtype
    _close(ty, jy, tol)
    assert sorted(ts) == sorted(js)
    for k in js:
        assert str(ts[k].dtype).replace("torch.", "") == str(js[k].dtype), k
        _close(ts[k], js[k], tol)
    if s < tcfg.recurrent.conv_width - 1:
        assert not ts["conv"][:, :tcfg.recurrent.conv_width - 1 - s].any()


def test_init_state_matches_reference():
    jcfg, tcfg = JC.get_smoke_config(ARCH), TC.get_smoke_config(ARCH)
    for kind in ("xm", "xs"):
        ref = jstack.init_layer_cache(kind, jcfg, 3, 0, jnp.bfloat16, {})
        got = tstack.init_layer_cache(kind, tcfg, 3, 0, torch.bfloat16, {},
                                      "cpu")
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert tuple(got[k].shape) == ref[k].shape
            assert str(got[k].dtype).replace("torch.", "") == \
                str(ref[k].dtype)
            _close(got[k], ref[k])


# ---------------------------------------------------------------------------
# model, engine, launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_forward_prefill_decode_match_reference(backend):
    jm, jp, tcfg, tp = _pair()
    tm = tmodel.build_model(tcfg, backend=backend)
    toks = _tokens(tcfg, 2, 11)
    with torch.inference_mode():
        ref = np.asarray(jm.forward(jp, jnp.asarray(toks, jnp.int32)))
        scale = max(1.0, float(np.abs(ref).max()))
        _close(tm.forward(tp, torch.as_tensor(toks)), ref, scale=scale)
        jl, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32))
        tl, tc = tm.prefill(tp, torch.as_tensor(toks))
        _close(tl, jl, scale=scale)
        assert tc["pos"] == int(jc["pos"]) == 11
        jflat = jax.tree_util.tree_leaves(jc["layers"])
        tflat = ttree.tree_leaves(tc["layers"])
        assert len(jflat) == len(tflat)
        for a, b in zip(tflat, jflat):
            _close(a, b)
        jeng = jengine.ServeEngine(jm, jp, max_seq=32, batch_slots=2)
        teng = tengine.ServeEngine(tm, tp, max_seq=32, batch_slots=2)
        jc, tc = jeng._align_cache(jc, 11), teng._align_cache(tc, 11)
        for step in range(6):
            tok = _tokens(tcfg, 2, 1, seed=10 + step)[:, 0]
            jl, jc = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc)
            tl, tc = tm.decode_step(tp, torch.as_tensor(tok), tc)
            _close(tl, jl, scale=max(1.0, float(np.abs(np.asarray(jl))
                                                .max())))
        assert tc["pos"] == int(jc["pos"])


def test_generate_matches_reference_engine():
    jm, jp, tcfg, tp = _pair()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist()
               for n in (5, 13, 9)]
    ref = jengine.ServeEngine(jm, jp, max_seq=32, batch_slots=4).generate(
        [jengine.Request(p, 8) for p in prompts])
    for backend in ("torch", "cuda"):
        tm = tmodel.build_model(tcfg, backend=backend)
        got = tengine.ServeEngine(tm, tp, max_seq=32, batch_slots=4).generate(
            [tengine.Request(p, 8) for p in prompts])
        assert got == ref, backend


def test_cuda_backend_routes_each_blocks_conv_through_the_kernel_wrapper(
        monkeypatch):
    """On backend ``cuda`` every xm and xs layer's forward and prefill call
    ``ops.fuse_conv1d_temporal`` once and a decode step never; on
    ``torch`` it is never called."""
    _, _, tcfg, tp = _pair()
    calls = []
    real = tops.fuse_conv1d_temporal
    monkeypatch.setattr(tops, "fuse_conv1d_temporal",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    toks = torch.as_tensor(_tokens(tcfg, 2, 7))
    with torch.inference_mode():
        for backend, per_call in (("cuda", tcfg.num_layers), ("torch", 0)):
            tm = tmodel.build_model(tcfg, backend=backend)
            calls.clear()
            tm.forward(tp, toks)
            _, cache = tm.prefill(tp, toks)
            assert len(calls) == 2 * per_call
            assert all(k == {"causal": True} for k in calls)
            tm.decode_step(tp, toks[:, 0], cache)
            assert len(calls) == 2 * per_call


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_reference_shapes(dtype):
    jcfg = dataclasses.replace(JC.get_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_smoke_config(ARCH), dtype=dtype)
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


def test_production_plan():
    cfg = TC.get_config(ARCH)
    segs = tstack.plan_segments(cfg)
    assert [(s.kinds, s.repeats) for s in segs] == [
        (("xm", "xm", "xm", "xs"), 3)]
    assert (cfg.d_model, cfg.num_heads, cfg.vocab_size) == (768, 4, 50304)
    assert round(cfg.param_count() / 1e9, 3) == 0.150


def test_launcher_serves_the_smoke_model(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--max-new", "5", "--prompts", "1 2 3", "4 5"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(" -> ")[0] for ln in lines] == [
        "prompt [1 2 3]", "prompt [4 5]"]
    for ln in lines:
        toks = eval(ln.split(" -> ")[1])
        assert len(toks) == 5 and all(0 <= t < 256 for t in toks)
