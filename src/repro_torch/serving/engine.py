"""Batched LM serving engine: prefill -> aligned decode buffers -> greedy loop.

Port of ``repro.serving.engine``.  Prefill emits exact per-layer caches
(attention K/V, recurrent states); ``_align_cache`` pads them into
fixed-size decode buffers:

  * full-attention K/V (``attn``, and ``dec``'s self-attention):
    left-aligned in a (B, max_seq, ...) buffer — decode writes at ``pos``
    and masks ``[0, pos)``;
  * sliding-window K/V: RIGHT-aligned in a (B, window, ...) rolling buffer;
  * MLA's latent cache (``ckv``, ``kr``): left-aligned in (B, max_seq, r);
  * recurrent states (RG-LRU, mLSTM, sLSTM) and the memory's K/V
    (``xk``, ``xv``, computed once at prefill): carried as-is.

The engine batches requests into fixed slots (padded), runs one prefill,
then steps the decode.  ``extras`` go to every prefill and decode call, as
in the reference: the memory's embeddings (``memory_embeds`` or
``vision_embeds``, one row per slot) and optionally its length
``memory_len``.  ``_prefill`` and ``_decode`` are the model's calls, kept
as attributes as in the reference.

Without a policy the engine runs under ``torch.inference_mode()`` on the
parameters' device.  With ``policy`` (a ``launch.sharding.ShardingPolicy``)
the caller passes parameters already distributed on its mesh
(``shard_tree(params, policy.param_shardings(params))``), as in the
reference; prefill and decode run ``launch.steps``' step builders, which
constrain the residual stream with ``policy.act_constraint``, on the
mesh's device.  That path runs under ``torch.no_grad()`` (DTensor cannot
set the version counter of an inference tensor) and under DTensor's
implicit replication, scoped to the generate, so that the plain tensors
the engine and the model make (tokens, positions, masks) meet the
parameters as replicated; token ids are read from full tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch

from repro_torch import tree
from repro_torch.launch.mesh import local_device
from repro_torch.launch.sharding import ShardingPolicy
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import common
from repro_torch.models.model import LanguageModel

PyTree = Any


def _token_ids(logits) -> list:
    """The greedy token of each row, from the full logits (a DTensor's are
    gathered first)."""
    full = getattr(logits, "full_tensor", None)
    return torch.argmax(full() if full else logits, -1).tolist()


@dataclasses.dataclass
class Request:
    prompt: list                     # token ids
    max_new_tokens: int = 16


class ServeEngine:
    def __init__(self, model: LanguageModel, params: PyTree, *,
                 max_seq: int = 256, batch_slots: int = 4,
                 policy: Optional[ShardingPolicy] = None,
                 extras: Optional[dict] = None):
        if policy is not None and not isinstance(policy, ShardingPolicy):
            raise TypeError(f"ServeEngine: policy must be a ShardingPolicy "
                            f"or None, not {type(policy).__name__}")
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.max_seq = max_seq
        self.slots = batch_slots
        self.policy = policy
        self.extras = extras = extras or {}
        if policy is None:
            self.device = params["embed"].device
        else:
            self.device = local_device(policy.mesh)
        # the closures hold the model and extras, not the engine: an engine
        # dropped is freed at once, with its parameters (a reference cycle
        # would hold them on the card until the garbage collector runs)
        self._prefill = make_prefill_step(model, policy)
        decode = make_decode_step(model, policy)
        self._decode = lambda p, t, c: decode(p, t, c, extras)

    # -- cache alignment ---------------------------------------------------------
    def _align_entry(self, kind_key: str, arr, prefill_len: int):
        window = self.cfg.sliding_window
        if kind_key in ("k", "v"):
            s = arr.shape[2]          # (n_super, B, S, KH, hd)
            if window and s <= window:
                pad = window - s      # right-align rolling window buffer
                return common.pad(arr, (0, 0, 0, 0, pad, 0))
            pad = self.max_seq - s    # left-align absolute buffer
            return common.pad(arr, (0, 0, 0, 0, 0, pad))
        if kind_key in ("ckv", "kr"):
            pad = self.max_seq - arr.shape[2]   # (n_super, B, S, r)
            return common.pad(arr, (0, 0, 0, pad))   # left-aligned
        return arr                    # recurrent states, memory K/V

    def _align_cache(self, cache: PyTree, prefill_len: int) -> PyTree:
        def walk(path, leaf):
            name = next((str(p) for p in reversed(path)
                         if isinstance(p, str)), None)
            if name == "pos":
                return leaf
            return self._align_entry(name, leaf, prefill_len)
        return tree.tree_map_with_path(walk, cache)

    # -- generation ---------------------------------------------------------------
    def generate(self, requests: List[Request]) -> List[list]:
        """Mixed-length batch, continuous-batching-lite: prefill to the
        SHORTEST prompt, then advance all slots together — slots still in
        their prompt are teacher-forced, finished slots decode greedily.
        No pad token ever enters a cache (batch-independence holds)."""
        if self.policy is None:
            with torch.inference_mode():
                return self._generate(requests)
        from torch.distributed.tensor.experimental import implicit_replication
        with torch.no_grad(), implicit_replication():
            return self._generate(requests)

    def _generate(self, requests: List[Request]) -> List[list]:
        assert len(requests) <= self.slots
        reqs = list(requests) + [Request([0], 0)] * (self.slots -
                                                     len(requests))
        min_prompt = min(len(r.prompt) for r in reqs)
        max_prompt = max(len(r.prompt) for r in reqs)
        tokens = torch.tensor([r.prompt[:min_prompt] for r in reqs],
                              dtype=torch.int64, device=self.device)
        logits, cache = self._prefill(self.params, tokens, self.extras)
        cache = self._align_cache(cache, min_prompt)
        max_new = max(r.max_new_tokens for r in reqs)
        outs: List[list] = [[] for _ in reqs]
        greedy = _token_ids(logits)

        def record(pos, greedy):
            # slot i emits when it has consumed its full prompt
            for i, r in enumerate(reqs):
                if pos >= len(r.prompt) and len(outs[i]) < r.max_new_tokens:
                    outs[i].append(int(greedy[i]))

        record(min_prompt, greedy)
        total_steps = max_prompt + max_new - min_prompt
        for pos in range(min_prompt, min_prompt + total_steps - 1):
            feed = []
            for i, r in enumerate(reqs):
                if pos < len(r.prompt):
                    feed.append(r.prompt[pos])          # teacher-force
                elif outs[i]:
                    feed.append(outs[i][-1])
                else:
                    feed.append(int(greedy[i]))
            logits, cache = self._decode(
                self.params, torch.tensor(feed, dtype=torch.int64,
                                          device=self.device), cache)
            greedy = _token_ids(logits)
            record(pos + 1, greedy)
            if all(len(o) >= r.max_new_tokens for o, r in zip(outs, reqs)):
                break
        return [outs[i] for i in range(len(requests))]
