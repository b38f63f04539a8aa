"""LM training across processes, four ``gloo`` ranks on the CPU, against
the JAX package.

One subprocess (``tests/_torch_training_ranks.py``, which imports only
``repro_torch``) runs four ranks of one process group.  On the tiny
RecurrentGemma and SmolLM configs (``tests/test_torch_trainer.py``'s
widths), ``Trainer(mesh=)`` on a (data 2, model 2) mesh trains 4 steps,
``n_micro`` 2, AdamW eps 1e-5 (for the reason
``tests/test_torch_lm_train.py``'s docstring gives), on the reference's
``TokenPipeline`` batches.  While the ranks run, this process runs the
reference's unsharded ``make_train_step`` (an identity
``act_constraint``: the reference's ``Trainer`` cannot run under jax
0.9.0, ``tests/test_torch_trainer.py`` says why) from the same init on the
same batches.  Tolerances: each step's loss within 1e-5 relative; the
final parameters within 1e-5 of each leaf's scale, the AdamW moments
within the gradients' 1e-4 of theirs (``tests/test_torch_lm_train.py``'s).
A leaf's scale is its max|ref|, but for an RMS norm's scale (``ln1``,
``ln2``, ``final_norm``), which starts at zero and enters the model as
``1 + scale``: its scale is max|1 + ref|.  Measured by its own max|ref|
(four Adam steps, about 4 lr), the one-device port against the reference
reads 5.5e-5 (SmolLM ``ln2``) and 1.3e-5 (RecurrentGemma ``ln1``) on
these batches: Adam turns the float32 round-off of a gradient element
near zero into up to lr / eps of its update, and such a leaf's scale is
its updates.

The contract of ``tests/test_checkpoint_trainer.py`` over a mesh: a crash
by ``fault_hook`` at step 2 and a restart end where the straight run ends
(1e-6); the (2, 2) checkpoint restored on (4, 1), on (1, 4) and without a
mesh is bit for bit the checkpoint, each leaf a DTensor with its policy's
placements; two more steps from it on (4, 1) equal two more on (2, 2)
within the same 1e-6 (``|d| <= 1e-6 + 1e-6 |ref|``, the reference's
exact-resume tolerance); the reference's ``CheckpointManager``
reads the mesh checkpoint and equals the state the ranks gathered.  The
sharded int8 step equals the one-device int8 step within 1e-5 of each
leaf's scale, and a short int8 run's loss falls.  ``compressed_psum`` over
four ranks equals the reference's under ``jax.vmap(axis_name="i")`` on the
same payloads: inputs that are exact multiples of their scale (powers of
two, a different one per rank), so rounding does not depend on the noise
and the max-scale sum differs from the plain sum.
"""
import dataclasses
import json
import os
import subprocess
import sys

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
from repro.optim import adamw as jadamw
from repro.optim.compression import compressed_psum as jcompressed_psum
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch import tree
from repro_torch.models.model import build_model
from repro_torch.train.checkpoint import CheckpointManager

import _torch_training_ranks as R

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
RANKS_TIMEOUT_S = 240
SEED, DATA_SEED, LR = 7, 3, 3e-3
INT8_STEPS = 3
LOSS_RTOL, STEP_RTOL, MOMENT_RTOL, RESUME_TOL, INT8_RTOL = (
    1e-5, 1e-5, 1e-4, 1e-6, 1e-5)
PSUM_N = 64


def _jcfg(arch):
    cfg = R.tiny_cfg(arch)
    return dataclasses.replace(
        JC.get_smoke_config(arch), **{f.name: getattr(cfg, f.name) for f in
                                      dataclasses.fields(cfg)})


def _batches(arch):
    pipe = JTokenPipeline(JTokenConfig(vocab_size=R.tiny_cfg(arch)
                                       .vocab_size, seq_len=R.SEQ,
                                       global_batch=R.GLOBAL_BATCH,
                                       seed=DATA_SEED))
    steps = [pipe.batch_at(s) for s in range(max(R.STEPS + 2, INT8_STEPS))]
    return {k: np.stack([np.asarray(b[k]) for b in steps])
            for k in ("tokens", "labels")}


def _psum_inputs():
    """Rank r's row: integers in [-127, 127] times 2^-r, with 127 * 2^-r
    at one element, so its scale is exactly 2^-r."""
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(-127, 128, PSUM_N) * 2.0 ** -r
                  for r in range(R.WORLD)])
    for r in range(R.WORLD):
        x[r, r] = 127 * 2.0 ** -r
    return x.astype(np.float32)


def _reference_run(arch, batches):
    """The reference's unsharded train step from the port's seeded init
    (the trainer's own draw) on ``batches``: per-step losses and the final
    parameters and moments, keyed as a checkpoint."""
    init = build_model(R.tiny_cfg(arch)).init(
        torch.Generator().manual_seed(SEED), device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, tree.tree_map(
        lambda t: t.numpy(), init))
    opt = jadamw(LR, eps=1e-5, weight_decay=0.1)
    policy = type("Identity", (), {"act_constraint": staticmethod(
        lambda x: x)})
    step = jax.jit(jsteps.make_train_step(
        jmodel.LanguageModel(_jcfg(arch)), policy, R.N_MICRO, opt))
    js, losses = opt.init(jp), []
    mb = R.GLOBAL_BATCH // R.N_MICRO
    for s in range(R.STEPS):
        batch = {k: v[s].reshape(R.N_MICRO, mb, R.SEQ)
                 for k, v in batches.items()}
        jp, js, metrics = step(jp, js, jnp.asarray(s), batch)
        losses.append(float(metrics["loss"]))
    flat = {}
    for name, t in (("params", jp), ("opt", js)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
            key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                           for p in path)
            flat[f"{name}/{key}"] = np.asarray(leaf)
    return losses, flat


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Start the four ranks, run the references meanwhile, then read what
    the ranks wrote."""
    tmp = tmp_path_factory.mktemp("sharded_training")
    batches = {arch: _batches(arch) for arch in R.ARCHS}
    np.savez(tmp / "batches.npz", **{f"{arch}/{k}": v for arch in R.ARCHS
                                     for k, v in batches[arch].items()})
    x = _psum_inputs()
    np.savez(tmp / "psum.npz", x=x)
    spec = dict(batches=str(tmp / "batches.npz"), psum=str(tmp / "psum.npz"),
                seed=SEED, lr=LR, int8_lr=LR, int8_steps=INT8_STEPS)
    (tmp / "spec.json").write_text(json.dumps(spec))
    log = tmp / "ranks.log"
    with open(log, "w") as out:       # a file: no pipe for the ranks to fill
        proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_training_ranks.py"),
             str(tmp / "spec.json"), str(tmp)],
            env=dict(os.environ, PYTHONPATH=SRC), stdout=out,
            stderr=subprocess.STDOUT)
        try:
            refs = {arch: _reference_run(arch, batches[arch])
                    for arch in R.ARCHS}
            keys = jax.random.split(jax.random.PRNGKey(0), R.WORLD)
            psum_ref = np.asarray(jax.vmap(
                lambda v, k: jcompressed_psum(v, "i", k),
                axis_name="i")(jnp.asarray(x), keys))
            proc.wait(timeout=RANKS_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0, log.read_text()[-6000:]
    report = json.loads((tmp / "report.json").read_text())
    return dict(dir=tmp, report=report, refs=refs, psum_ref=psum_ref, x=x)


def _ckpt(trained, arch, run, step):
    with np.load(trained["dir"] / arch / run / f"step_{step}" /
                 "state.npz") as z:
        return {k: z[k] for k in z.files}


def _gathered(trained, arch):
    with np.load(trained["dir"] / f"{arch}_gathered.npz") as z:
        return {k: z[k] for k in z.files}


# RMS norm scales: zero at init, applied as ``1 + scale``
ONE_PLUS = ("ln1", "ln2", "final_norm")


def _close(got, want, rtol, what):
    """Every leaf of ``got`` within ``rtol`` of its leaf's scale in
    ``want``: max|w|, or max|1 + w| for an RMS norm's scale."""
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        assert got[k].shape == w.shape, (what, k)
        err = float(np.abs(got[k].astype(np.float64) - w).max())
        scale = np.abs(1.0 + w if k.split("/")[-1] in ONE_PLUS else w)
        assert err <= rtol * float(scale.max()), (what, k, err)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_trainer_on_a_mesh_matches_the_reference_step(trained, arch):
    losses, ref = trained["refs"][arch]
    np.testing.assert_allclose(
        trained["report"][arch]["straight_losses"], losses, rtol=LOSS_RTOL)
    got = _ckpt(trained, arch, "straight", R.STEPS)
    _close({k: v for k, v in got.items() if k.startswith("params/")},
           {k: v for k, v in ref.items() if k.startswith("params/")},
           STEP_RTOL, "parameters")
    _close({k: v for k, v in got.items() if k.startswith("opt/")},
           {k: v for k, v in ref.items() if k.startswith("opt/")},
           MOMENT_RTOL, "moments")
    init = build_model(R.tiny_cfg(arch)).init(
        torch.Generator().manual_seed(SEED), device="cpu")
    moved = max(float(np.abs(got[f"params/{k}"] - t.numpy()).max())
                for k, t in zip(R._keys(init), tree.tree_leaves(init)))
    assert moved > 1e-3                 # the steps moved the parameters


@pytest.mark.parametrize("arch", R.ARCHS)
def test_trained_state_keeps_the_policy_placements(trained, arch):
    rep = trained["report"][arch]
    assert rep["placed"] and rep["model_sharded"] > 0


def test_crash_and_restart_match_the_straight_run(trained):
    rep = trained["report"]["recurrentgemma_2b"]
    assert rep["crashed_latest"] == 2 and rep["restart_logged"] == [2, 3]
    want = _ckpt(trained, "recurrentgemma_2b", "straight", R.STEPS)
    got = _ckpt(trained, "recurrentgemma_2b", "restart", R.STEPS)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RESUME_TOL,
                                   atol=RESUME_TOL, err_msg=k)


@pytest.mark.parametrize("mesh", ["41", "14"])
def test_mesh_checkpoint_restores_bit_for_bit_on_another_mesh(trained, mesh):
    rep = trained["report"]["recurrentgemma_2b"][f"restore_{mesh}"]
    assert rep == {"placed": True, "bitwise": True, "leaves": rep["leaves"],
                   "step": R.STEPS}
    assert rep["leaves"] == len(_gathered(trained, "recurrentgemma_2b"))


@pytest.mark.parametrize("arch", R.ARCHS)
def test_mesh_checkpoint_restores_without_a_mesh(trained, arch):
    trainer = R._train(arch, {"lr": LR, "seed": SEED}, str(trained["dir"]),
                       "straight", None, R.STEPS, None)
    params, opt_state = trainer.state_template()
    state, manifest = trainer.ckpt.restore(
        R.STEPS, {"params": params, "opt": opt_state}, device="cpu")
    assert manifest["step"] == R.STEPS
    gathered = _gathered(trained, arch)
    keys = R._keys(state)
    assert sorted(keys) == sorted(gathered)
    for k, t in zip(keys, tree.tree_leaves(state)):
        assert t.device.type == "cpu" and np.array_equal(t.numpy(),
                                                         gathered[k]), k


@pytest.mark.parametrize("arch", R.ARCHS)
def test_reference_manager_reads_the_mesh_checkpoint(trained, arch):
    gathered = _gathered(trained, arch)
    template = {}
    for k, v in gathered.items():
        node, *path, last = k.split("/")
        d = template.setdefault(node, {})
        for p in path:
            d = d.setdefault(p, {})
        d[last] = np.zeros(v.shape, v.dtype)
    # the port's lists are the reference's lists: rebuild them
    def lists(t):
        if not isinstance(t, dict):
            return t
        if t and all(k.isdigit() for k in t):
            return [lists(t[str(i)]) for i in range(len(t))]
        return {k: lists(v) for k, v in t.items()}
    state, manifest = JCheckpointManager(
        str(trained["dir"] / arch / "straight")).restore(
            R.STEPS, lists(template))
    assert manifest["step"] == R.STEPS
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        flat["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path)] = leaf
    assert sorted(flat) == sorted(gathered)
    for k, v in gathered.items():
        assert flat[k].dtype == v.dtype and np.array_equal(flat[k], v), k


def test_two_more_steps_on_another_mesh_match(trained):
    rep = trained["report"]["recurrentgemma_2b"]
    assert rep["more_41_logged"] == rep["more_22_logged"] == [R.STEPS,
                                                              R.STEPS + 1]
    want = _ckpt(trained, "recurrentgemma_2b", "more_22", R.STEPS + 2)
    got = _ckpt(trained, "recurrentgemma_2b", "more_41", R.STEPS + 2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RESUME_TOL,
                                   atol=RESUME_TOL, err_msg=k)


def test_sharded_int8_step_matches_the_one_device_step(trained):
    _close(_ckpt(trained, "recurrentgemma_2b", "int8", 1),
           _ckpt(trained, "recurrentgemma_2b", "int8_one_device", 1),
           INT8_RTOL, "int8 step on (2, 2) against one device")


def test_sharded_int8_loss_falls(trained):
    losses = trained["report"]["recurrentgemma_2b"]["int8_losses"]
    assert len(losses) == INT8_STEPS and losses[-1] < losses[0]


def test_compressed_psum_matches_the_reference_under_vmap(trained):
    got = np.load(trained["dir"] / "psum.npy")
    ref, x = trained["psum_ref"], trained["x"]
    assert got.dtype == np.float32 and got.shape == (PSUM_N,)
    for row in ref:                     # every rank gets the same sum
        assert np.array_equal(got, row)
    # the reference's quirk: the payload sum times the largest scale
    assert np.array_equal(got, (x / 2.0 ** -np.arange(R.WORLD)[:, None])
                          .sum(0).astype(np.float32))
    assert not np.allclose(got, x.sum(0))
