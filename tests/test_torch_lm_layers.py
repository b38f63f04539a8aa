"""The port's LM layers against the JAX package's, on the CPU.

Each function of ``repro_torch.models`` (and the temporal FuSeConv of
``repro_torch.core.fuseconv`` and ``repro_torch.kernels.ops``) gets the
same seeded numpy inputs as its counterpart in ``repro``.  Floats agree at
``rtol = atol = 1e-4`` of the output's scale unless a case says otherwise.
The temporal conv is held to both reference forms, the lax one and
``repro.kernels.ops.fuse_conv1d_temporal`` (the Pallas ``fuse1d`` kernel in
interpret mode, as ``tests/test_kernels.py`` runs it), at 1e-5 in float32
and 2e-2 in bfloat16, the tolerances ``tests/test_kernels.py`` holds the
reference kernel to.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.core import fuseconv as jfc
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import recurrent as jrec
from repro.models import rope as jrope
from repro_torch import configs as TC
from repro_torch.core import fuseconv as tfc
from repro_torch.kernels import ops as tops
from repro_torch.kernels.backend import CUDA, TORCH
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import recurrent as trec
from repro_torch.models import rope as trope

TOL = 1e-4


def _rng(seed=0):
    return np.random.default_rng(seed)


def _n(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, ref, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale)


T = torch.from_numpy
J = jnp.asarray


# ---------------------------------------------------------------------------
# common, rope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_softcap_act(dtype):
    rng = _rng()
    x, s = _n(rng, 3, 5, 32, scale=3.0), _n(rng, 32, scale=0.5)
    tol = TOL if dtype == "float32" else 2e-2
    jx, js = J(x).astype(dtype), J(s).astype(dtype)
    tx, ts = T(x).to(getattr(torch, dtype)), T(s).to(getattr(torch, dtype))
    _close(tcommon.rms_norm(tx, ts, 1e-6), jcommon.rms_norm(jx, js, 1e-6),
           tol)
    _close(tcommon.layer_norm(tx, ts, ts), jcommon.layer_norm(jx, js, js),
           tol)
    _close(tcommon.softcap(T(x) * 20, 30.0), jcommon.softcap(J(x) * 20, 30.0))
    assert torch.equal(tcommon.softcap(T(x), 0.0), T(x))   # no cap
    for act in ("silu", "gelu", "relu", "gelu_plain", "relu_sq"):
        _close(tcommon.ACT[act](T(x)), jcommon.ACT[act](J(x)))
    assert tcommon.GLU_ACTS == jcommon.GLU_ACTS


@pytest.mark.parametrize("shape", [(2, 7, 3, 16), (2, 7, 8)])
def test_apply_rope(shape):
    rng = _rng(1)
    x = _n(rng, *shape)
    pos = rng.integers(0, 5000, shape[:2])
    _close(trope.apply_rope(T(x), T(pos), 10_000.0),
           jrope.apply_rope(J(x), J(pos), 10_000.0))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,h,kh,causal,window,qc,kc", [
    (16, 4, 4, True, None, 512, 1024),     # one chunk
    (19, 4, 2, True, None, 8, 8),          # GQA, ragged S, chunk loops
    (23, 4, 1, True, 6, 8, 5),             # MQA, sliding window
    (13, 2, 2, False, None, 4, 6),         # non-causal, kv padding
    (21, 6, 3, False, 5, 7, 4),            # non-causal window
])
def test_blockwise_attention(sq, h, kh, causal, window, qc, kc):
    rng = _rng(2)
    q, k, v = _n(rng, 2, sq, h, 8), _n(rng, 2, sq, kh, 8), \
        _n(rng, 2, sq, kh, 6)
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc)
    _close(tattn.blockwise_attention(T(q), T(k), T(v), **kw),
           jattn.blockwise_attention(J(q), J(k), J(v), **kw))


@pytest.mark.parametrize("kv_len,window", [(1, None), (9, None), (12, 4),
                                           (12, None)])
def test_decode_attention(kv_len, window):
    rng = _rng(3)
    q, kc, vc = _n(rng, 2, 1, 4, 8), _n(rng, 2, 12, 2, 8), _n(rng, 2, 12, 2, 8)
    _close(tattn.decode_attention(T(q), T(kc), T(vc), kv_len, window=window),
           jattn.decode_attention(J(q), J(kc), J(vc), jnp.asarray(kv_len),
                                  window=window))


def _gqa_params(cfg, rng):
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": _n(rng, d, h * hd, scale=d ** -0.5),
            "wk": _n(rng, d, kh * hd, scale=d ** -0.5),
            "wv": _n(rng, d, kh * hd, scale=d ** -0.5),
            "wo": _n(rng, h * hd, d, scale=(h * hd) ** -0.5)}


@pytest.mark.parametrize("pos", [0, 5, 31])
def test_gqa_forward_and_decode(pos):
    cfg = dataclasses.replace(JC.get_smoke_config("smollm_135m"),
                              attn_q_chunk=4, attn_kv_chunk=4)
    rng = _rng(4)
    p = _gqa_params(cfg, rng)
    x = _n(rng, 2, 9, cfg.d_model)
    positions = np.broadcast_to(np.arange(9), (2, 9))
    tp, jp = {k: T(v) for k, v in p.items()}, {k: J(v) for k, v in p.items()}
    _close(tattn.gqa_forward(tp, T(x), T(positions.copy()), cfg, window=5),
           jattn.gqa_forward(jp, J(x), J(positions), cfg, window=5))
    cache = {"k": _n(rng, 2, 32, cfg.num_kv_heads, cfg.head_dim),
             "v": _n(rng, 2, 32, cfg.num_kv_heads, cfg.head_dim)}
    ty, tc = tattn.gqa_decode(tp, T(x[:, :1]), {k: T(v) for k, v in
                                                 cache.items()}, pos, cfg)
    jy, jc = jattn.gqa_decode(jp, J(x[:, :1]), {k: J(v) for k, v in
                                                 cache.items()},
                              jnp.asarray(pos, jnp.int32), cfg)
    _close(ty, jy)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rec_params(cfg, rng):
    d = cfg.d_model
    w = int(d * cfg.recurrent.width_factor)
    nb = cfg.recurrent.heads
    bw = w // nb
    return {"w_in": _n(rng, d, w, scale=d ** -0.5),
            "w_gate": _n(rng, d, w, scale=d ** -0.5),
            "conv": _n(rng, cfg.recurrent.conv_width, w, scale=0.5),
            "wa": _n(rng, nb, bw, bw, scale=w ** -0.5),
            "wx": _n(rng, nb, bw, bw, scale=w ** -0.5),
            "lam": rng.uniform(0.5, 4.0, w).astype(np.float32),
            "w_out": _n(rng, w, d, scale=w ** -0.5)}


def test_rglru_coeffs_and_scan():
    cfg = JC.get_smoke_config("recurrentgemma_2b")
    rng = _rng(5)
    p = _rec_params(cfg, rng)
    tp, jp = {k: T(v) for k, v in p.items()}, {k: J(v) for k, v in p.items()}
    for s in (1, 2, 7, 33):
        x = _n(rng, 2, s, cfg.d_model)
        for got, ref in zip(trec._rglru_coeffs(tp, T(x)),
                            jrec._rglru_coeffs(jp, J(x))):
            _close(got, ref)
        _close(trec.rglru_scan(tp, T(x)), jrec.rglru_scan(jp, J(x)))
        a, b = rng.uniform(0, 1, (2, s, 3)), _n(rng, 2, s, 3)
        _close(trec.linear_scan(T(a.astype(np.float32)), T(b)),
               jrec.linear_scan(J(a.astype(np.float32)), J(b)))


@pytest.mark.parametrize("backend", [TORCH, CUDA], ids=["torch", "cuda"])
def test_rglru_block_forward_and_decode(backend):
    cfg = JC.get_smoke_config("recurrentgemma_2b")
    rng = _rng(6)
    p = _rec_params(cfg, rng)
    tp, jp = {k: T(v) for k, v in p.items()}, {k: J(v) for k, v in p.items()}
    x = _n(rng, 2, 10, cfg.d_model)
    _close(trec.rglru_block_forward(tp, T(x), cfg, backend),
           jrec.rglru_block_forward(jp, J(x), cfg))
    state = {"conv": _n(rng, 2, 3, cfg.d_model), "h": _n(rng, 2, cfg.d_model)}
    ty, ts = trec.rglru_block_decode(tp, T(x[:, :1]),
                                     {k: T(v) for k, v in state.items()}, cfg)
    jy, js = jrec.rglru_block_decode(jp, J(x[:, :1]),
                                     {k: J(v) for k, v in state.items()},
                                     cfg)
    _close(ty, jy)
    _close(ts["conv"], js["conv"])
    _close(ts["h"], js["h"])
    assert ts["h"].dtype == torch.float32
    init = trec.rglru_init_state(3, cfg, torch.bfloat16, "cpu")
    ref = jrec.rglru_init_state(3, cfg, jnp.bfloat16)
    for k in ("conv", "h"):
        assert tuple(init[k].shape) == ref[k].shape
        assert str(init[k].dtype).replace("torch.", "") == str(ref[k].dtype)


# ---------------------------------------------------------------------------
# The temporal FuSeConv: plain op and kernel form, against both reference
# forms.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "centred"])
@pytest.mark.parametrize("k,t", [(1, 13), (2, 13), (3, 13), (4, 13), (5, 13),
                                 (4, 2), (5, 1)])
def test_temporal_conv_matches_both_reference_forms(k, t, causal, dtype):
    rng = _rng(7)
    x, w = _n(rng, 2, t, 11), _n(rng, k, 11, scale=0.5)
    jx, jw = J(x).astype(dtype), J(w).astype(dtype)
    tx, tw = T(x).to(getattr(torch, dtype)), T(w).to(getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 2e-2
    lax_ref = jfc.fuse_conv1d_temporal(jx, jw, causal=causal)
    pallas_ref = jops.fuse_conv1d_temporal(jx, jw, causal=causal)
    for got in (tfc.fuse_conv1d_temporal(tx, tw, causal=causal),
                tops.fuse_conv1d_temporal(tx, tw, causal=causal)):
        assert got.dtype == tx.dtype and tuple(got.shape) == (2, t, 11)
        for ref in (lax_ref, pallas_ref):
            assert str(ref.dtype) == dtype
            _close(got, ref, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_temporal_conv_step_matches_reference(dtype):
    rng = _rng(8)
    state, xt, w = _n(rng, 2, 3, 9), _n(rng, 2, 9), _n(rng, 4, 9)
    tol = 1e-5 if dtype == "float32" else 2e-2
    cast = getattr(torch, dtype)
    ts, ty = tfc.fuse_conv1d_temporal_step(T(state).to(cast), T(xt).to(cast),
                                           T(w).to(cast))
    js, jy = jfc.fuse_conv1d_temporal_step(J(state).astype(dtype),
                                           J(xt).astype(dtype),
                                           J(w).astype(dtype))
    _close(ts, js, tol)
    _close(ty, jy, tol)
    assert ty.dtype == cast
    # stepping the causal conv token by token equals the full-sequence form
    x = T(_n(rng, 2, 6, 9))
    full = tfc.fuse_conv1d_temporal(x, T(w))
    st = torch.zeros(2, 3, 9)
    for i in range(6):
        st, y = tfc.fuse_conv1d_temporal_step(st, x[:, i], T(w))
        _close(y, full[:, i].numpy(), 1e-5)
