"""The port's LM trainer, checkpoints, token pipeline, int8 compression
and training launcher, on the CPU.

The reference ``Trainer`` cannot run here (its step fails with a
``ShardingTypeError`` at the vocab-sharded embedding gather,
``src/repro/models/model.py:124``), so the port is held to the contract of
``tests/test_checkpoint_trainer.py`` on its tiny SmolLM config: checkpoint
round trip, ``keep`` and ``latest``, a partial write ignored, exact resume
through ``fault_hook`` (1e-6), a falling loss, an int8 run that trains.
Beyond it: a bfloat16 leaf round-tripped bit for bit in a process where
``ml_dtypes`` cannot be imported; an npz written by the reference's
``CheckpointManager`` (float32, int32 and bfloat16 leaves) restored by
the port; ``TokenPipeline.batch_at`` a pure function of (seed, step,
host) with shifted labels; ``quantize_int8`` within one scale of its input
and unbiased over draws; the launcher in subprocesses (a rerun resumes to
the state of one straight run; a bad ``--distributed`` topology exits in
one line before any process group forms; ``--distributed`` on one process
trains on the 1x1 host mesh and resumes; a production mesh on one process
exits in one line naming the mesh and the world).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch import configs as TC
from repro_torch.data.tokens import TokenConfig, TokenPipeline
from repro_torch.optim import adamw
from repro_torch.optim.compression import (compress_tree, dequantize_int8,
                                           quantize_int8)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _tiny_cfg():
    return dataclasses.replace(TC.get_smoke_config("smollm_135m"),
                               num_layers=2, vocab_size=64, d_model=32,
                               num_heads=2, num_kv_heads=2, head_dim=16,
                               d_ff=64)


def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)},
            "w": [torch.tensor([1.0, -2.5, 3.140625, 1e-3]).to(torch.bfloat16)]}


def _assert_same(got, want):
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


# -- checkpoints -------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    mgr.save(3, tree, meta={"data_step": 3}, blocking=True)
    out, manifest = mgr.restore(3, tree)
    assert manifest["step"] == 3 and manifest["data_step"] == 3
    assert manifest["bfloat16"] == ["w/0"]
    _assert_same(out, tree)
    assert mgr.last_save["step"] == 3 and mgr.last_save["bytes"] > 0


def test_checkpoint_save_copies_before_returning(tmp_path):
    """An async save holds a host copy: the caller may write its tensors
    in place at once (the train step updates them in place)."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    want = _tree()
    mgr.save(1, tree)
    tree["a"].add_(100.0)
    tree["w"][0].mul_(2)
    mgr.wait()
    out, _ = mgr.restore(1, want)
    _assert_same(out, want)


def test_checkpoint_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = {"x": torch.zeros(2)}
    for s in (1, 2, 3):
        mgr.save(s, t, blocking=True)
    assert mgr.steps() == [2, 3]
    assert mgr.latest_step() == 3


def test_checkpoint_atomic_partial_write_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"x": torch.zeros(2)}, blocking=True)
    # simulate a crash mid-write: orphan temp dir + step dir w/o manifest
    (tmp_path / ".tmp_step_9").mkdir()
    (tmp_path / "step_7").mkdir()
    assert mgr.latest_step() == 1


def test_checkpoint_restore_checks_leaves_and_takes_template_dtype(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.arange(4.0)}, blocking=True)
    out, _ = mgr.restore(1, {"x": torch.zeros(4, dtype=torch.float64)})
    assert out["x"].dtype == torch.float64
    assert torch.equal(out["x"], torch.arange(4.0, dtype=torch.float64))
    with pytest.raises(KeyError, match="y"):
        mgr.restore(1, {"y": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"x": torch.zeros(5)})
    meta, _ = mgr.restore(1, {"x": torch.zeros(4, device="meta")})
    assert meta["x"].device.type == "meta"


def test_checkpoint_restores_compressed_and_stored_members(tmp_path):
    """``restore`` reads an npz member stored uncompressed (as ``np.savez``
    writes them) from its offset in the file, and any other member (here
    one ``np.savez_compressed`` wrote, and a Fortran-ordered one) through
    ``np.load``: the same arrays either way."""
    want = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b/0": np.arange(6, dtype=np.int32)[::-1].copy(),
            "e": np.zeros((0, 4), np.float32),
            "f": np.asfortranarray(np.arange(6.0).reshape(2, 3))}
    template = {"a": torch.zeros(3, 4),
                "b": [torch.zeros(6, dtype=torch.int32)],
                "e": torch.zeros(0, 4),
                "f": torch.zeros(2, 3, dtype=torch.float64)}
    for save in (np.savez, np.savez_compressed):
        d = tmp_path / save.__name__ / "step_1"
        d.mkdir(parents=True)
        save(d / "state.npz", **want)
        (d / "manifest.json").write_text('{"step": 1}')
        out, _ = CheckpointManager(str(d.parent)).restore(1, template)
        for k, t in zip(("a", "b/0", "e", "f"), tree_leaves(out)):
            assert np.array_equal(t.numpy(), want[k]), (save.__name__, k)


def test_checkpoint_save_error_raised_at_wait(tmp_path, monkeypatch):
    """A failed background write is raised at ``wait()``, and no step of
    it is published."""
    def fail(*args, **kwargs):
        raise OSError("disk full")

    mgr = CheckpointManager(str(tmp_path))
    monkeypatch.setattr(np, "savez", fail)
    mgr.save(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.steps() == []
    mgr.wait()                          # raised once


def test_bf16_roundtrips_bit_for_bit_without_ml_dtypes(tmp_path):
    """Every bfloat16 bit pattern but the NaNs (whose payloads torch may
    canonicalize) survives a save and a restore, in a process where
    ``import ml_dtypes`` fails."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["ml_dtypes"] = None
        sys.path.insert(0, {SRC!r})
        import torch
        from repro_torch.train.checkpoint import CheckpointManager
        bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
        w = bits.view(torch.bfloat16)
        keep = ~torch.isnan(w)
        w = w[keep].clone()
        mgr = CheckpointManager({str(tmp_path)!r})
        mgr.save(1, {{"w": w, "f": torch.ones(3)}}, blocking=True)
        out, _ = mgr.restore(1, {{"w": torch.zeros_like(w),
                                  "f": torch.zeros(3)}})
        assert out["w"].dtype == torch.bfloat16
        assert torch.equal(out["w"].view(torch.int16), w.view(torch.int16))
        assert "ml_dtypes" not in sys.modules or sys.modules["ml_dtypes"] \\
            is None
        print("ok", w.numel())
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # 2 signs x 127 non-zero mantissas with the exponent all ones are NaN
    assert proc.stdout.split() == ["ok", str(65536 - 2 * 127)]


def test_restores_the_reference_npz(tmp_path):
    """An npz written by the reference's ``CheckpointManager``: float32,
    int32 and bfloat16 leaves (the last stored as ``|V2`` bytes) restored
    by the port, bit for bit, in the template's dtypes and device."""
    bf = np.array([1.0, -2.5, 3.140625, 1e-3, -0.0],
                  np.float32).astype(ml_dtypes.bfloat16)
    ref = {"a": jnp.arange(6.0).reshape(2, 3),
           "b": {"c": jnp.ones((4,), jnp.int32)},
           "w": [jnp.asarray(bf)]}
    JCheckpointManager(str(tmp_path)).save(5, ref, meta={"data_step": 5},
                                           blocking=True)
    with np.load(tmp_path / "step_5" / "state.npz") as z:
        assert z["w/0"].dtype.kind == "V"
    template = {"a": torch.zeros(2, 3), "b": {"c": torch.zeros(
        4, dtype=torch.int32)}, "w": [torch.zeros(5, dtype=torch.bfloat16)]}
    out, manifest = CheckpointManager(str(tmp_path)).restore(5, template)
    assert manifest == {"step": 5, "data_step": 5}
    assert torch.equal(out["a"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(out["b"]["c"], torch.ones(4, dtype=torch.int32))
    assert out["w"][0].dtype == torch.bfloat16
    assert torch.equal(out["w"][0].view(torch.int16),
                       torch.from_numpy(bf.view(np.int16)))


# -- data and compression ------------------------------------------------------

def test_token_pipeline_is_a_pure_function_of_seed_step_host():
    cfg = TokenConfig(vocab_size=1000, seq_len=64, global_batch=8, seed=3)
    a, b = TokenPipeline(cfg), TokenPipeline(cfg)
    for step in (0, 5):
        x, y = a.batch_at(step), b.batch_at(step)
        assert torch.equal(x["tokens"], y["tokens"])
        assert x["tokens"].shape == (8, 64) and x["tokens"].dtype == torch.int64
        assert torch.equal(x["labels"], torch.roll(x["tokens"], -1, dims=1))
    assert not torch.equal(a.batch_at(0)["tokens"], a.batch_at(1)["tokens"])
    other_seed = TokenPipeline(dataclasses.replace(cfg, seed=4))
    assert not torch.equal(a.batch_at(0)["tokens"],
                           other_seed.batch_at(0)["tokens"])
    hosts = [TokenPipeline(cfg, host_id=h, num_hosts=2) for h in (0, 1)]
    s0, s1 = (h.batch_at(2)["tokens"] for h in hosts)
    assert s0.shape == s1.shape == (4, 64) and not torch.equal(s0, s1)
    assert torch.equal(s0, TokenPipeline(cfg, 0, 2).batch_at(2)["tokens"])


def test_token_pipeline_follows_its_markov_chain():
    """Tokens stay in the 512-token core; all but about 5% of the steps go
    to one of the previous token's 4 preferred successors."""
    cfg = TokenConfig(vocab_size=4000, seq_len=256, global_batch=16, seed=1)
    pipe = TokenPipeline(cfg)
    toks = pipe.batch_at(0)["tokens"]
    assert int(toks.max()) < 512 and int(toks.min()) >= 0
    prev, nxt = toks[:, :-1], toks[:, 1:]
    follows = (pipe._nxt[prev] == nxt[..., None]).any(-1).float().mean()
    assert 0.93 < float(follows) < 0.99


def test_quantize_int8_error_and_bias():
    """Each draw is within one scale of x (scale = max|x| / 127); the mean
    of 400 draws is within 5 standard errors (scale / 2 / sqrt(400)) of x
    at every element: the rounding is unbiased."""
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 3
    gen = torch.Generator().manual_seed(1)
    q, scale = quantize_int8(x, gen)
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    assert float(scale) == pytest.approx(float(x.abs().max()) / 127,
                                         rel=1e-6)
    n = 400
    draws = torch.stack([dequantize_int8(*quantize_int8(x, gen))
                         for _ in range(n)])
    assert float((draws - x).abs().max()) <= float(scale)
    bound = 5 * float(scale) / 2 / n ** 0.5
    assert float((draws.mean(0) - x).abs().max()) <= bound
    assert abs(float((draws.mean(0) - x).mean())) <= bound / 10


def test_compress_tree_keeps_structure_dtype_and_seed():
    tree = {"w": torch.randn(4, 3).to(torch.bfloat16), "b": [torch.randn(3),
                                                             None]}
    one = compress_tree(tree, torch.Generator().manual_seed(2))
    two = compress_tree(tree, torch.Generator().manual_seed(2))
    assert one["b"][1] is None and one["w"].dtype == torch.bfloat16
    for a, b, x in zip(tree_leaves(one), tree_leaves(two), tree_leaves(tree)):
        if x is not None:
            assert torch.equal(a, b) and a.shape == x.shape


# -- trainer -----------------------------------------------------------------

def _trainer(tmp_path, name, steps, **kw):
    tcfg = dict(steps=steps, global_batch=4, seq_len=16, microbatches=2,
                log_every=0, ckpt_every=3, ckpt_dir=str(tmp_path / name),
                seed=7)
    opt = kw.pop("optimizer", None)
    return Trainer(_tiny_cfg(), TrainerConfig(**{**tcfg, **kw}),
                   device="cpu", optimizer=opt)


def test_trainer_exact_resume(tmp_path):
    """train(6) == train(3) + crash + restore + train(3)."""
    ref = _trainer(tmp_path, "ref", 6).train()

    class Bomb(Exception):
        pass

    def hook(step):
        if step == 4:                       # after the step-3 checkpoint
            raise Bomb()

    t2 = _trainer(tmp_path, "ft", 6)
    with pytest.raises(Bomb):
        t2.train(fault_hook=hook)
    t2.ckpt.wait()
    assert t2.ckpt.latest_step() == 3
    # "restart the job": fresh trainer, same ckpt dir -> resumes at step 3
    out = _trainer(tmp_path, "ft", 6).train()
    for a, b in zip(tree_leaves((ref["params"], ref["opt_state"])),
                    tree_leaves((out["params"], out["opt_state"]))):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=1e-6, atol=1e-6)


def _fast_opt():
    return adamw(3e-3, weight_decay=0.0)


def test_trainer_loss_decreases(tmp_path):
    t = _trainer(tmp_path, "x", 20, global_batch=8, seq_len=32,
                 microbatches=1, log_every=19, ckpt_every=0, seed=1,
                 optimizer=_fast_opt())
    out = t.train()
    hist = out["history"]
    assert [h["step"] for h in hist] == [0, 19]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert out["straggler_events"] == []
    assert t.ckpt.latest_step() == 20       # the final, blocking save


def test_trainer_int8_compression_trains(tmp_path):
    t = _trainer(tmp_path, "c", 16, global_batch=8, seq_len=32,
                 microbatches=2, log_every=15, ckpt_every=0,
                 grad_compression="int8", seed=1, optimizer=_fast_opt())
    out = t.train()
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]


def test_trainer_reports_stragglers(tmp_path):
    t = _trainer(tmp_path, "s", 2, straggler_timeout_s=0.0, ckpt_every=0)
    events = t.train()["straggler_events"]
    assert [e["step"] for e in events] == [0, 1]
    assert all(e["seconds"] > 0 for e in events)


# -- launcher ----------------------------------------------------------------

def _launch(*args):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm_135m", "--smoke", "--device", "cpu", "--global-batch", "4",
         "--seq-len", "16", *args], capture_output=True, text=True,
        timeout=300, env=env)


def test_launcher_resumes_on_rerun(tmp_path):
    """The same command rerun with more steps resumes from the latest
    checkpoint and ends where one straight run ends, within the
    reference's exact-resume 1e-6 (not bitwise on the CPU: its threaded
    embedding backward accumulates in a varying order, so two straight
    runs differ by about 1e-8)."""
    straight, split = tmp_path / "straight", tmp_path / "split"
    for args in (("--steps", "4", "--ckpt-dir", str(straight)),
                 ("--steps", "2", "--ckpt-dir", str(split)),
                 ("--steps", "4", "--ckpt-dir", str(split))):
        proc = _launch("--ckpt-every", "2", *args)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "final loss:" in proc.stdout
    # the resumed run starts at step 2: it logs no step 0
    assert "step     0" not in proc.stdout
    a, b = CheckpointManager(str(straight)), CheckpointManager(str(split))
    assert a.steps() == b.steps() == [2, 4]
    with np.load(straight / "step_4" / "state.npz") as za, \
            np.load(split / "step_4" / "state.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_allclose(za[k], zb[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("flags, reason", [
    (["--num-processes", "1", "--process-id", "0"], "no coordinator address"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "2"], "process_id 2 out of range"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "0",
      "--process-id", "0"], "num_processes must be >= 1")])
def test_launcher_bad_topology_exits_in_one_line(flags, reason):
    """A bad ``--distributed`` topology exits with one ``--distributed:``
    line, before any process group forms (nothing listens at the
    coordinator address, and the launcher has not imported torch)."""
    env = {k: v for k, v in os.environ.items() if k not in (
        "JAX_COORDINATOR_ADDRESS", "REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID")}
    code = ("import sys\n"
            "from repro_torch.launch import train\n"
            "try:\n"
            "    train.main(sys.argv[1:])\n"
            "finally:\n"
            "    assert 'torch' not in sys.modules\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--arch", "smollm_135m", "--smoke",
         "--device", "cpu", "--distributed", *flags], capture_output=True,
        text=True, timeout=60, env=dict(env, PYTHONPATH=SRC))
    assert proc.returncode == 1 and proc.stdout == ""
    lines = proc.stderr.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("--distributed: ")
    assert reason in lines[0]


def test_launcher_distributed_trains_on_the_host_mesh_and_resumes(tmp_path):
    """``--distributed`` on one process trains on the 1x1 host mesh (a
    world-1 ``gloo`` group), and the same command rerun with more steps
    resumes from its mesh checkpoint."""
    d = tmp_path / "ckpt"
    common = ("--distributed", "--coordinator", "127.0.0.1:1",
              "--num-processes", "1", "--process-id", "0", "--ckpt-every",
              "2", "--ckpt-dir", str(d))
    first = _launch(*common, "--steps", "2")
    assert first.returncode == 0, first.stderr[-3000:]
    assert "mesh: 1x1 ('data', 'model') over a world-1 gloo group" \
        in first.stdout
    assert "step     0 loss" in first.stdout and "final loss: " \
        in first.stdout
    rerun = _launch(*common, "--steps", "4")
    assert rerun.returncode == 0, rerun.stderr[-3000:]
    assert "step     0" not in rerun.stdout      # resumed at step 2
    assert CheckpointManager(str(d)).steps() == [2, 4]
    with np.load(d / "step_2" / "state.npz") as a, \
            np.load(d / "step_4" / "state.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert not np.array_equal(a["params/embed"], b["params/embed"])


@pytest.mark.parametrize("flags, mesh", [
    (["--multi-pod"], "a 2x16x16 ('pod', 'data', 'model') mesh"),
    (["--distributed", "--coordinator", "127.0.0.1:1", "--num-processes",
      "1", "--process-id", "0"], "a 16x16 ('data', 'model') mesh")])
def test_launcher_mesh_larger_than_the_world_exits_in_one_line(flags, mesh):
    """The production meshes on one process: one line naming the mesh and
    the world."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm_135m", "--device", "cpu", *flags], capture_output=True,
        text=True, timeout=300, env=env)
    assert proc.returncode == 1 and proc.stdout == ""
    lines = proc.stderr.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith(mesh)
    assert "but the process group has 1" in lines[0]
