"""LM trainer: the production loop.

Port of ``repro.train.trainer``.  Composes the model (on backend
``torch``: training runs plain ops) and its optimizer, the step-indexed
token pipeline with prefetch, gradient-accumulation microbatching,
optional int8 gradient compression, async atomic checkpointing with exact
resume, and straggler detection.  A fault hook makes the fault-tolerance
path testable.

Without a mesh the trainer runs on one ``device`` (the card unless the
caller asks for the CPU).  With ``mesh`` (a ``DeviceMesh`` with the
reference's ``"data"``/``"model"`` axes over the default process group,
``launch/mesh.py``) it is the reference's distributed trainer: the
sharding policy (``launch/sharding.py``) places the parameters, the AdamW
moments and each step's batch as ``launch.steps.train_step_shardings``
gives them (every rank draws the same seeded full init and keeps its
shards, as the reference's jitted init does), the sharded train step runs
on the DTensors, checkpoints gather on every rank and are written by
process 0, and a restart restores onto whatever mesh the new job has (the
elastic re-shard).  A restore's template is shapes, dtypes and placements
(``state_template``), not a second init.

Each step is timed from taking its batch to the end of its device work
(the loop synchronizes the device after every step, so that the time and
the straggler alarm read the step, not its dispatch).  The parameters and
optimizer state are updated in place (``launch.steps.make_train_step``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import torch

from repro_torch.data.prefetch import Prefetcher
from repro_torch.data.tokens import TokenConfig, TokenPipeline
from repro_torch.launch.mesh import local_device
from repro_torch.launch.sharding import ShardingPolicy, shard_tree
from repro_torch.launch.steps import (default_optimizer, make_train_step,
                                      train_step_shardings)
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import build_model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    microbatches: int = 1
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join("build", "ckpt")
    ckpt_keep: int = 3
    grad_compression: str = "none"      # none | int8
    straggler_timeout_s: float = 300.0  # step wall-clock alarm
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig, device="cuda",
                 optimizer=None, mesh=None):
        if tcfg.global_batch % tcfg.microbatches:
            raise ValueError(f"global batch {tcfg.global_batch} is not a "
                             f"multiple of {tcfg.microbatches} microbatches")
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        # over a mesh, the mesh's device on this rank
        self.device = (torch.device(device) if mesh is None
                       else local_device(mesh))
        self.model = build_model(cfg, backend="torch")
        self.opt = optimizer or default_optimizer(cfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        self.pipeline = TokenPipeline(TokenConfig(
            vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed))
        self.straggler_events: list = []
        self.policy = None if mesh is None else ShardingPolicy(mesh, cfg)
        self.step_fn = make_train_step(self.model, tcfg.microbatches,
                                       self.opt, tcfg.grad_compression,
                                       policy=self.policy)
        self.shardings = None
        if mesh is not None:
            params, _ = self.state_template()
            self.shardings = train_step_shardings(
                self.policy, params, self._batch_shape())[0]

    def _batch_shape(self) -> dict:
        t = self.tcfg
        mb = t.global_batch // t.microbatches
        leaf = torch.empty((t.microbatches, mb, t.seq_len),
                           dtype=torch.int64, device="meta")
        return {"tokens": leaf, "labels": leaf}

    def _get_batch(self, step: int) -> dict:
        """The step's batch on the host, leaves (n_micro, mb, seq_len)."""
        t = self.tcfg
        mb = t.global_batch // t.microbatches
        return {k: v.reshape(t.microbatches, mb, t.seq_len)
                for k, v in self.pipeline.batch_at(step).items()}

    def _place_batch(self, batch: dict) -> dict:
        """The host batch on the device; over a mesh, each rank keeps its
        shard of the whole batch (every rank reads the same one)."""
        batch = {k: v.to(self.device) for k, v in batch.items()}
        if self.mesh is None:
            return batch
        return shard_tree(batch, self.shardings[3])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- init / resume ------------------------------------------------------------
    def state_template(self):
        """``(params, opt_state)`` as meta tensors: the shapes and dtypes
        of the state, made without drawing it."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            params = self.model.init(torch.Generator(), device="cpu")
            opt_state = self.opt.init(params)
        meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
        return tree_map(meta, params), tree_map(meta, opt_state)

    def init_state(self):
        """The seeded init at step 0.  Over a mesh every rank draws the
        whole init and keeps its shards; the optimizer state is made on the
        shards."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = self.model.init(gen, device=self.device)
        if self.mesh is not None:
            params = shard_tree(params, self.shardings[0])
        return params, self.opt.init(params), 0

    def restore_or_init(self):
        """The latest checkpoint's (params, opt_state, step), placed on this
        trainer's device or mesh, or a fresh init at step 0."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return self.init_state()
        params, opt_state = self.state_template()
        shardings = None
        if self.mesh is not None:
            shardings = {"params": self.shardings[0],
                         "opt": self.shardings[1]}
        state, manifest = self.ckpt.restore(
            latest, {"params": params, "opt": opt_state},
            shardings=shardings, device=self.device)
        return state["params"], state["opt"], int(manifest["step"])

    # -- loop ----------------------------------------------------------------------
    def train(self, fault_hook: Optional[Callable[[int], None]] = None
              ) -> dict:
        t = self.tcfg
        params, opt_state, start = self.restore_or_init()
        prefetch = Prefetcher(self._get_batch, start_step=start, depth=2)
        history = []
        try:
            for s in range(start, t.steps):
                t0 = time.perf_counter()
                step_idx, batch = prefetch.next()
                assert step_idx == s
                if fault_hook is not None:
                    fault_hook(s)      # test hook: raise to simulate a crash
                batch = self._place_batch(batch)
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, s, batch)
                self._sync()
                dt = time.perf_counter() - t0
                if dt > t.straggler_timeout_s:
                    self.straggler_events.append({"step": s, "seconds": dt})
                if t.log_every and s % t.log_every == 0:
                    loss = float(metrics["loss"])
                    history.append({"step": s, "loss": loss,
                                    "sec_per_step": dt})
                    print(f"step {s:5d} loss {loss:.4f} ({dt:.2f}s)",
                          flush=True)
                if t.ckpt_every and (s + 1) % t.ckpt_every == 0:
                    self.ckpt.save(s + 1, {"params": params,
                                           "opt": opt_state},
                                   meta={"data_step": s + 1})
            self.ckpt.save(t.steps, {"params": params, "opt": opt_state},
                           meta={"data_step": t.steps}, blocking=True)
        finally:
            prefetch.close()
            self.ckpt.wait()
        return {"params": params, "opt_state": opt_state,
                "history": history,
                "straggler_events": self.straggler_events}
