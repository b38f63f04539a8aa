"""The port's LM training path against the JAX package, on the CPU.

``LanguageModel.loss`` and its per-leaf gradients against the reference's
unsharded ``jax.value_and_grad(model.loss, has_aux=True)`` for six smoke
configs (RecurrentGemma, SmolLM, xLSTM, Qwen3-MoE, DeepSeek-V2 and
Whisper with ``memory_embeds`` in the batch), on the same
``_torch_params.numpy_lm_params`` and batch; ``linear_scan``'s
``torch.autograd.Function`` against ``jax.vjp`` of the reference's
``linear_scan``, and what it saves; three steps of
``launch.steps.make_train_step`` against the reference's
``make_train_step`` run unsharded (an identity ``act_constraint``), on the
reference's own ``TokenPipeline`` batches, with ``n_micro`` 1 and 2.

Tolerances: the loss within 1e-5 relative; each gradient leaf within 1e-4
of that leaf's max |ref|; a leaf that is zero analytically (found by a
float64 run of the port's plain ops, below 1e-12 of its largest gradient)
is held to zero within 1e-6 of the largest gradient on both sides, as
``tests/test_torch_train.py`` does (none of the six configs has one: the
check stands guard).  ``linear_scan`` within 1e-5 of each gradient's
scale; the train steps' parameters within 1e-5 of each leaf's scale and
their AdamW moments within the gradients' 1e-4.  The steps' AdamW takes eps 1e-5, not 1e-8: with eps 1e-8
an element whose gradient is near zero (6.5e-8 in an embedding leaf whose
largest is 0.26) turns the two packages' float32 round-off of it (1.8e-9)
into a change of 3e-3 in its Adam ratio g / (|g| + eps), 1e-5 of a
parameter at lr 3e-3, past the tolerance after three steps.  eps 1e-5
bounds that amplification (lr / eps) 1000-fold lower.
"""
import contextlib
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.data.tokens import TokenConfig as JTokenConfig
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.models import recurrent as jrec
from repro.optim import adamw as jadamw
from repro_torch import configs as TC
from repro_torch.launch import steps as tsteps
from repro_torch.models import convert as tconvert
from repro_torch.models import model as tmodel
from repro_torch.models import recurrent as trec
from repro_torch.optim import adamw, rmsprop, sgd_momentum
from repro_torch.train.vision import value_and_grad
from repro_torch.tree import tree_leaves, tree_map

from _torch_params import numpy_lm_params

ARCHS = ("recurrentgemma_2b", "smollm_135m", "xlstm_125m", "qwen3_moe_235b",
         "deepseek_v2_236b", "whisper_tiny")
LOSS_RTOL, GRAD_RTOL, ZERO_TOL, STEP_RTOL = 1e-5, 1e-4, 1e-6, 1e-5


def _flat(tree):
    return [(jax.tree_util.keystr(p), np.asarray(leaf)) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _batch(cfg, seed=0, b=2, s=12):
    """Tokens, next-token labels and, for an encoder-decoder, a memory."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.encoder_layers:
        batch["memory_embeds"] = rng.standard_normal(
            (b, 10, cfg.d_model)).astype(np.float32)
    return batch


def _tbatch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v).to(dtype) for k, v in batch.items()}


@contextlib.contextmanager
def _float64_upcasts():
    """``Tensor.float()`` keeps a float64 tensor float64, and new tensors
    default to float64, so that the port's plain ops, whose fp32 upcasts
    call ``float()`` and whose fresh states take the default dtype, run
    wholly in float64."""
    orig, default = torch.Tensor.float, torch.get_default_dtype()

    def upcast(self, *args, **kwargs):
        return self if self.dtype == torch.float64 else orig(self, *args,
                                                            **kwargs)

    torch.Tensor.float = upcast
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = orig
        torch.set_default_dtype(default)


def _to(tree, dtype):
    return tree_map(lambda t: t.to(dtype), tree)


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch):
    cfg = JC.get_smoke_config(arch)
    return jax.jit(jax.value_and_grad(jmodel.LanguageModel(cfg).loss,
                                      has_aux=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg = TC.get_smoke_config(arch)
    np_params = numpy_lm_params(JC.get_smoke_config(arch))
    batch = _batch(cfg)
    (ref_loss, ref_aux), ref_grads = _ref_value_and_grad(arch)(np_params,
                                                               batch)
    model = tmodel.build_model(cfg)
    params = tconvert.params_from_numpy(np_params, device="cpu")
    (loss, aux), grads = value_and_grad(model.loss, params, _tbatch(batch))
    with _float64_upcasts():
        (loss64, _), grads64 = value_and_grad(
            model.loss, _to(params, torch.float64),
            _tbatch(batch, torch.float64))
    assert loss64.dtype == torch.float64
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["ppl_proxy"].detach()),
                               float(ref_aux["ppl_proxy"]), rtol=LOSS_RTOL)
    assert float(aux["loss"].detach()) == float(loss)

    ref_leaves = _flat(ref_grads)
    got, got64 = tree_leaves(grads), tree_leaves(grads64)
    assert len(ref_leaves) == len(got) == len(got64)
    big = max(float(np.abs(r).max()) for _, r in ref_leaves)
    big64 = max(float(g.abs().max()) for g in got64)
    for (path, r), g, g64 in zip(ref_leaves, got, got64):
        g = g.detach().numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, path
        if float(g64.abs().max()) <= 1e-12 * big64:
            assert float(np.abs(r).max()) <= ZERO_TOL * big, path
            assert float(np.abs(g).max()) <= ZERO_TOL * big, path
            continue
        tol = GRAD_RTOL * float(np.abs(r).max())
        assert float(np.abs(g - r).max()) <= tol, path


def test_loss_ignores_nothing_but_tokens_and_labels():
    """A memory model's batch carries its memory to the forward: without
    it the loss refuses, as the forward does."""
    cfg = TC.get_smoke_config("whisper_tiny")
    params = tconvert.params_from_numpy(
        numpy_lm_params(JC.get_smoke_config("whisper_tiny")), device="cpu")
    batch = _tbatch(_batch(cfg))
    loss, _ = tmodel.build_model(cfg).loss(params, batch)
    assert torch.isfinite(loss)
    del batch["memory_embeds"]
    with pytest.raises(ValueError, match="memory_embeds"):
        tmodel.build_model(cfg).loss(params, batch)


def _scan_inputs(b=2, s=37, w=5, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, (b, s, w)).astype(np.float32)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    dh = rng.standard_normal((b, s, w)).astype(np.float32)
    return a, x, dh


@pytest.mark.parametrize("s", [1, 2, 37, 64])
def test_linear_scan_vjp_matches_reference(s):
    a, x, dh = _scan_inputs(s=s)
    h_ref, vjp = jax.vjp(jrec.linear_scan, jnp.asarray(a), jnp.asarray(x))
    da_ref, db_ref = (np.asarray(t) for t in vjp(jnp.asarray(dh)))
    ta = torch.from_numpy(a).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    h = trec.linear_scan(ta, tx)
    da, db = torch.autograd.grad(h, (ta, tx), torch.from_numpy(dh))
    for got, ref in ((h, h_ref), (da, da_ref), (db, db_ref)):
        ref = np.asarray(ref)
        scale = max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(got.detach().numpy() - ref).max()) \
            <= STEP_RTOL * scale


def test_linear_scan_saves_only_a_and_h():
    """The Function keeps (a, h) for its backward, two (B, S, W) tensors;
    autograd through the doubling scan keeps several per doubling level."""
    a, x, _ = _scan_inputs(s=64)

    def saved(fn):
        packed = []

        def pack(t):
            packed.append(t)
            return t

        ta = torch.from_numpy(a).requires_grad_(True)
        tx = torch.from_numpy(x).requires_grad_(True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            h = fn(ta, tx)
        return ta, h, packed

    ta, h, packed = saved(trec.linear_scan)
    assert len(packed) == 2
    assert packed[0] is ta and torch.equal(packed[1], h)
    assert all(t.shape == (2, 64, 5) for t in packed)
    _, _, plain = saved(trec._doubling_scan)
    assert len(plain) > 2 * 6          # log2(64) levels


def test_update_in_place_equals_the_whole_tree_update():
    """``update_in_place`` writes, leaf by leaf, exactly the numbers of
    ``opt.update`` + ``apply_updates`` over the whole tree, for each of the
    port's optimizers, with a ``None`` gradient among the leaves."""
    from repro_torch.optim import apply_updates
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 3, generator=gen),
              "b": torch.randn(3, generator=gen).to(torch.bfloat16),
              "s": [torch.randn(2, 2, generator=gen)]}
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen)
                     .to(p.dtype), params)
    grads["s"][0] = None
    for opt in (adamw(1e-2, weight_decay=0.1),
                sgd_momentum(1e-2, weight_decay=0.1), rmsprop(1e-2)):
        state = opt.init(params)
        state = tree_map(lambda t: t + 0.5, state)
        with torch.no_grad():
            updates, want_state = opt.update(grads, state, params, 3)
            want = apply_updates(params, updates)
        p2, s2 = tree_map(torch.clone, params), tree_map(torch.clone, state)
        tsteps.update_in_place(opt, tree_leaves(grads), s2, p2, 3)
        for x, y in zip(tree_leaves((want, want_state)),
                        tree_leaves((p2, s2))):
            assert x.dtype == y.dtype and torch.equal(x, y)


@functools.lru_cache(maxsize=None)
def _jax_train_step(n_micro):
    cfg = JC.get_smoke_config("recurrentgemma_2b")
    policy = types.SimpleNamespace(act_constraint=lambda x: x)
    return jax.jit(jsteps.make_train_step(
        jmodel.LanguageModel(cfg), policy, n_micro, _opt(jadamw)))


def _opt(adamw_fn):
    return adamw_fn(3e-3, eps=1e-5, weight_decay=0.1)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_match_reference(n_micro):
    """Three steps from the same parameters on the reference's batches
    (global batch 4, seq 16): parameters within 1e-5 of each leaf's scale,
    the AdamW moments, which are the gradients' (``v`` their squares, so
    twice their relative error), within the gradients' 1e-4; the loss and
    the gradient norm of each step within 1e-5 relative."""
    jcfg = JC.get_smoke_config("recurrentgemma_2b")
    cfg = TC.get_smoke_config("recurrentgemma_2b")
    np_params = numpy_lm_params(jcfg)
    pipe = JTokenPipeline(JTokenConfig(vocab_size=cfg.vocab_size,
                                       seq_len=16, global_batch=4, seed=3))
    jstep = _jax_train_step(n_micro)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    js = _opt(jadamw).init(jp)
    topt = _opt(adamw)
    tstep = tsteps.make_train_step(tmodel.build_model(cfg), n_micro, topt)
    tp = tconvert.params_from_numpy(np_params, device="cpu")
    ts = topt.init(tp)
    for s in range(3):
        batch = {k: np.array(v).reshape(n_micro, 4 // n_micro, 16)
                 for k, v in pipe.batch_at(s).items()}
        jp, js, jm = jstep(jp, js, jnp.asarray(s), batch)
        tp, ts, tm = tstep(tp, ts, s, {k: torch.from_numpy(v).long()
                                       for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=STEP_RTOL, err_msg=k)
    for rtol, ref, got in ((STEP_RTOL, jp, tp), (GRAD_RTOL, js, ts)):
        for (path, r), g in zip(_flat(ref), tree_leaves(got)):
            g = g.numpy()
            assert g.shape == r.shape, path
            assert float(np.abs(g - r).max()) \
                <= rtol * float(np.abs(r).max()), path
    # the steps moved the parameters by far more than the tolerance
    assert max(float(np.abs(r - p0).max()) for (_, r), (_, p0)
               in zip(_flat(jp), _flat(np_params))) > 1e-3


def test_step_defaults_match_reference():
    """``default_microbatches`` picks the reference's depth for every
    config; ``default_optimizer``'s updates (AdamW, warmup-cosine) equal
    the reference's within 1e-6 at a warm-up step and a cosine step."""
    for arch in TC.list_configs():
        for gb, seq, chips in ((8, 128, 1), (256, 4096, 1), (512, 4096, 8)):
            assert tsteps.default_microbatches(
                TC.get_config(arch), gb, seq, chips) == \
                jsteps.default_microbatches(JC.get_config(arch), gb, seq,
                                            chips), (arch, gb, seq, chips)
    rng = np.random.default_rng(0)
    p = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32)}
    g = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}
    jopt = jsteps.default_optimizer(JC.get_smoke_config("smollm_135m"))
    topt = tsteps.default_optimizer(TC.get_smoke_config("smollm_135m"))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    for step in (3, 250):
        ju, _ = jopt.update(g, jopt.init(p), p, jnp.asarray(step))
        tu, _ = topt.update(tg, topt.init(tp), tp, step)
        for k in p:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-6, atol=0, err_msg=k)


def test_prefill_and_decode_steps_are_the_models():
    cfg = TC.get_smoke_config("recurrentgemma_2b")
    model = tmodel.build_model(cfg)
    params = tconvert.params_from_numpy(
        numpy_lm_params(JC.get_smoke_config("recurrentgemma_2b")), "cpu")
    tokens = torch.from_numpy(_batch(cfg)["tokens"]).long()
    with torch.inference_mode():
        logits, cache = tsteps.make_prefill_step(model)(params, tokens, {})
        want, want_cache = model.prefill(params, tokens)
        assert torch.equal(logits, want)
        step, _ = tsteps.make_decode_step(model)(params, tokens[:, 0],
                                                  cache, {})
        assert torch.equal(step, model.decode_step(params, tokens[:, 0],
                                                   want_cache)[0])
