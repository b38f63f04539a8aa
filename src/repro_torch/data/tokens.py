"""Deterministic synthetic LM token pipeline (seekable, host-shardable).

Port of ``repro.data.tokens``.  Sequences follow a fixed seeded first-order
Markov chain over a frequent-token core (learnable structure), with
occasional jumps: each core token prefers 4 successors (the table is the
reference's own numpy draw from ``seed``), and at each position a
Bernoulli(0.05) jump picks a random token of the vocabulary, folded into
the core as the reference folds it.  ``batch_at(step)`` is a pure function
of (seed, step, host): its draws come from a ``torch.Generator`` seeded by
that triple, so restarts resume exactly and each host materializes only
its shard.  The draws are not ``jax.random``'s: tests feed the reference's
own batches to the port's steps.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    core_tokens: int = 512      # size of the structured Markov core


def batch_seed(seed: int, step: int, host_id: int) -> int:
    """A 64-bit generator seed for ``(seed, step, host_id)``: numpy's
    ``SeedSequence`` mixes the triple, so neighbouring steps and hosts draw
    unrelated streams."""
    return int(np.random.SeedSequence((int(seed), int(step), int(host_id)))
               .generate_state(1, np.uint64)[0])


class TokenPipeline:
    def __init__(self, cfg: TokenConfig, host_id: int = 0, num_hosts: int = 1):
        assert cfg.global_batch % num_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.host_batch = cfg.global_batch // num_hosts
        core = min(cfg.core_tokens, cfg.vocab_size)
        rng = np.random.default_rng(cfg.seed)
        # sparse-ish transition preferences: each core token prefers 4 others
        self._nxt = torch.from_numpy(
            rng.integers(0, core, size=(core, 4)).astype(np.int64))
        self._core = core

    def batch_at(self, step: int) -> dict:
        """Tokens (host_batch, seq_len) int64 on the host for (step, host);
        ``labels`` are the next-token shift of ``tokens`` (the last
        position wraps to the first, as the reference's ``roll``)."""
        cfg = self.cfg
        b, t = self.host_batch, cfg.seq_len
        g = torch.Generator().manual_seed(
            batch_seed(cfg.seed, step, self.host_id))
        tok = torch.randint(0, self._core, (b,), generator=g)
        branch = torch.randint(0, 4, (t, b), generator=g)
        jump = torch.rand((t, b), generator=g) < 0.05
        jump_tok = torch.randint(0, cfg.vocab_size, (t, b), generator=g)
        seq = torch.empty((t, b), dtype=torch.int64)
        for i in range(t):
            tok = torch.where(jump[i], jump_tok[i] % self._core,
                              self._nxt[tok, branch[i]])
            seq[i] = tok
        seq = seq.T.contiguous()
        return {"tokens": seq, "labels": torch.roll(seq, -1, dims=1)}
