"""LM trainer: the production loop.

Port of ``repro.train.trainer`` for one device.  Composes the model (on
backend ``torch``: training runs plain ops) and its optimizer, the
step-indexed token pipeline with prefetch, gradient-accumulation
microbatching, optional int8 gradient compression, async atomic
checkpointing with exact resume, and straggler detection.  A fault hook
makes the fault-tolerance path testable.  The reference takes a device
mesh and restores onto whatever mesh the new job has; the port runs on one
``device`` (the card unless the caller asks for the CPU).  The sharding
policy and the train step's shardings are ported
(``launch/sharding.py``, ``launch/steps.py::train_step_shardings``); a
trainer over a mesh, with sharded parameters and optimizer state and the
restore's re-shard, is ROADMAP Queue 1 item 7 (training across processes,
which now carries the training half of LM sharding).

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
from repro_torch.launch.steps import default_optimizer, make_train_step
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import build_model
from repro_torch.train.checkpoint import CheckpointManager


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
                 optimizer=None):
        if tcfg.global_batch % tcfg.microbatches:
            raise ValueError(f"global batch {tcfg.global_batch} is not a "
                             f"multiple of {tcfg.microbatches} microbatches")
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = torch.device(device)
        self.model = build_model(cfg, backend="torch")
        self.opt = optimizer or default_optimizer(cfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        self.pipeline = TokenPipeline(TokenConfig(
            vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
            global_batch=tcfg.global_batch, seed=tcfg.seed))
        self.straggler_events: list = []
        self.step_fn = make_train_step(self.model, tcfg.microbatches,
                                       self.opt, tcfg.grad_compression)

    def _get_batch(self, step: int) -> dict:
        """The step's batch on the host, leaves (n_micro, mb, seq_len)."""
        t = self.tcfg
        mb = t.global_batch // t.microbatches
        return {k: v.reshape(t.microbatches, mb, t.seq_len)
                for k, v in self.pipeline.batch_at(step).items()}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- init / resume ------------------------------------------------------------
    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = self.model.init(gen, device=self.device)
        return params, self.opt.init(params), 0

    def restore_or_init(self):
        """The latest checkpoint's (params, opt_state, step), or a fresh
        init at step 0.  The template of the restore is a fresh init, so a
        resume holds the state twice for a moment."""
        latest = self.ckpt.latest_step()
        params, opt_state, step = self.init_state()
        if latest is None:
            return params, opt_state, step
        state, manifest = self.ckpt.restore(
            latest, {"params": params, "opt": opt_state})
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
                batch = {k: v.to(self.device) for k, v in batch.items()}
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
