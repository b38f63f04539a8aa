"""LanguageModel: init / forward / loss / prefill / decode over segments.

Port of ``repro.models.model``.  Parameters of each segment
are stacked on a leading superblock axis, as in the reference, and a Python
loop over that axis stands in for ``lax.scan`` (``remat`` and
``scan_unroll`` have no meaning here and are ignored).  The model carries
a ``Backend``: ``torch`` runs every op plainly, ``cuda`` puts the RG-LRU
blocks' temporal FuSeConv on the hand ``fuse1d`` kernel (one launch per
``rec`` layer per ``forward`` or ``prefill``; a decode step launches none).
The MoE and MLA layers (``qwen3_moe_235b``, ``deepseek_v2_236b``) run no
hand kernel on either backend.  The decode cache's ``pos`` is a Python
int.  ``loss`` (training) runs on backend ``torch``: the kernels have no
backward pass and refuse grad-requiring inputs, and the reference trains
on plain ops too.  ``forward``, ``loss``, ``prefill`` and ``decode_step``
take the reference's ``shard_act``, applied to the residual stream after
every layer (a sharding policy's ``act_constraint``; the identity by
default).  On DTensor parameters the embedding lookup and the loss's
per-token NLL run on each rank's batch rows (``embed_lookup``,
``token_nll``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch import tree
from repro_torch.kernels._build import is_dtensor
from repro_torch.kernels.backend import TORCH, Backend, resolve_backend
from repro_torch.models import stack as S
from repro_torch.models.common import (dense_init, embed_init, rms_norm,
                                       softcap, torch_dtype)
from repro_torch.models.config import ArchConfig

Tensor = torch.Tensor
PyTree = Any


def Identity(x, *_):
    return x


def _replicated(t: Tensor, mesh) -> Tensor:
    """A DTensor as it is; a plain tensor as a replicated DTensor on
    ``mesh``."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def embed_lookup(embed: Tensor, tokens: Tensor) -> Tensor:
    """``embed[tokens]``.  A DTensor embedding (vocab-sharded under a
    policy) is made whole and looked up on each rank's token rows under
    ``local_map`` (DTensor's rule for the lookup's backward,
    ``index_put``, fails in PyTorch 2.11); its gradient is a partial sum
    over the axes that shard the token rows.  ``tokens`` may be a plain
    tensor (taken as replicated) or a DTensor."""
    if not is_dtensor(embed):
        return embed[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = embed.device_mesh
    tokens = _replicated(tokens, mesh)
    rows = [p if p == Shard(0) else Replicate() for p in tokens.placements]
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if p == Shard(0) else p for p in rows]
    return local_map(lambda e, t: e[t], out_placements=rows,
                     in_placements=(whole, rows),
                     in_grad_placements=(grad, rows), device_mesh=mesh,
                     redistribute_inputs=True)(embed, tokens)


def token_nll(logits: Tensor, labels: Tensor) -> Tensor:
    """``logsumexp(logits) - logit[label]`` per token: (B, S, V), (B, S)
    -> (B, S).  DTensor logits are taken on each rank's batch rows, the
    vocab and sequence made whole first (a vocab-sharded head's logits are
    gathered over "model"): DTensor's own rule for a gather along a
    sharded dim leaves a masked partial sum that its next reduction cannot
    take (PyTorch 2.13).  ``labels`` may then be a plain tensor (taken as
    replicated) or a DTensor."""
    if is_dtensor(logits):
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor.experimental import local_map
        mesh = logits.device_mesh
        rows = [p if p == Shard(0) else Replicate()
                for p in logits.placements]
        return local_map(token_nll, out_placements=rows,
                         in_placements=(rows, rows), device_mesh=mesh,
                         redistribute_inputs=True)(
            logits, _replicated(labels, mesh))
    lse = torch.logsumexp(logits, dim=-1)
    return lse - logits.gather(-1, labels[..., None])[..., 0]


def _stack(trees: List[PyTree]) -> PyTree:
    """Leaves of equal-structure trees stacked on a new leading axis."""
    if len(trees) == 1:
        return tree.tree_map(lambda a: a[None], trees[0])
    return tree.tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def _draw_stacked(draw: Callable[[], PyTree], repeats: int) -> PyTree:
    """``repeats`` trees from ``draw()``, called in order, stacked on a new
    leading axis.  Each is copied into the stacked leaves as soon as it is
    drawn and then dropped, so a segment is held once plus one repeat, not
    twice (a full-width segment's parameters are tens of GB)."""
    t = draw()
    out = tree.tree_map(lambda a: a.new_empty((repeats, *a.shape)), t)
    for r in range(repeats):
        if r:
            t = draw()
        tree.tree_map(lambda dst, src: dst[r].copy_(src), out, t)
    return out


def _index(stacked: PyTree, r: int) -> PyTree:
    return tree.tree_map(lambda a: a[r], stacked)


@dataclasses.dataclass(frozen=True)
class LanguageModel:
    cfg: ArchConfig
    backend: Backend = TORCH

    def _check(self) -> List[S.Segment]:
        """The segments, after refusing a layer kind the stack does not
        know."""
        segs = S.plan_segments(self.cfg)
        for seg in segs:
            for kind in seg.kinds:
                S.check_ported(kind, self.cfg)
        return segs

    def _memory_len(self, extras: Optional[dict]) -> int:
        cfg = self.cfg
        return ((extras or {}).get("memory_len") or cfg.num_vision_tokens
                or cfg.encoder_seq or 0)

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator, device="cuda") -> PyTree:
        """The reference's tree, shapes, dtypes and scales, drawn from
        ``generator`` (on its own device) and placed on ``device``."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        segs = self._check()
        kw = dict(device=device)
        params: Dict[str, Any] = {
            "embed": embed_init(generator, cfg.vocab_size, cfg.d_model,
                                dtype, **kw),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, **kw),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(
                generator, (cfg.d_model, cfg.vocab_size), dtype, **kw)
        params["segments"] = [
            _draw_stacked(lambda seg=seg: {
                f"k{i}": S.init_layer(generator, kind, cfg, seg.use_moe,
                                      dtype, device)
                for i, kind in enumerate(seg.kinds)}, seg.repeats)
            for seg in segs]
        if cfg.encoder_layers:
            params["encoder"] = _draw_stacked(
                lambda: S.init_layer(generator, "enc", cfg, False, dtype,
                                     device), cfg.encoder_layers)
            params["enc_norm"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                             **kw)
        if cfg.num_vision_tokens:
            params["vision_proj"] = dense_init(
                generator, (cfg.d_model, cfg.d_model), dtype, **kw)
        return params

    def _ctx(self, positions: Optional[Tensor]) -> dict:
        return {"positions": positions, "window": self.cfg.sliding_window,
                "backend": self.backend}

    def _embed(self, params: PyTree, tokens: Tensor,
               extras: Optional[dict]) -> Tuple[Tensor, dict]:
        b, s_len = tokens.shape
        positions = torch.arange(s_len, device=tokens.device)[None].expand(
            b, s_len)
        ctx = self._ctx(positions)
        self._prepare_memory(params, extras or {}, ctx)
        return embed_lookup(params["embed"], tokens), ctx

    def _encode(self, params: PyTree, memory_embeds: Tensor) -> Tensor:
        """Encoder stack over the modality embeddings (audio frames)."""
        b, m, _ = memory_embeds.shape
        ctx = self._ctx(torch.arange(m, device=memory_embeds.device)[None]
                        .expand(b, m))
        h = memory_embeds
        for r in range(self.cfg.encoder_layers):
            h = S.layer_forward(_index(params["encoder"], r), h, "enc",
                                self.cfg, False, ctx)
        return rms_norm(h, params["enc_norm"], self.cfg.norm_eps)

    def _prepare_memory(self, params: PyTree, extras: dict, ctx: dict
                        ) -> None:
        """``ctx["memory"]`` and ``ctx["memory_len"]`` from ``extras``, for
        a model whose layers attend to a memory."""
        cfg = self.cfg
        if cfg.encoder_layers and "memory_embeds" in extras:
            ctx["memory"] = self._encode(params, extras["memory_embeds"])
        elif cfg.num_vision_tokens and "vision_embeds" in extras:
            ctx["memory"] = extras["vision_embeds"] @ params["vision_proj"]
        elif cfg.encoder_layers or cfg.num_vision_tokens:
            key = "memory_embeds" if cfg.encoder_layers else "vision_embeds"
            raise ValueError(f"{cfg.name}: its layers attend to a memory; "
                             f"pass (B, M, {cfg.d_model}) embeddings as "
                             f"extras[{key!r}]")
        else:
            return
        ctx["memory_len"] = ctx["memory"].shape[1]

    def _logits(self, params: PyTree, x: Tensor) -> Tensor:
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        head = (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"])
        return softcap((x @ head).float(), cfg.logit_softcap)

    # -- full-sequence forward (prefill logits) -------------------------------
    def forward(self, params: PyTree, tokens: Tensor,
                extras: Optional[dict] = None,
                shard_act: Callable = Identity) -> Tensor:
        """tokens: (B, S) -> logits (B, S, V) in fp32."""
        segs = self._check()
        x, ctx = self._embed(params, tokens, extras)
        for seg, sp in zip(segs, params["segments"]):
            for r in range(seg.repeats):
                lp = _index(sp, r)
                for i, kind in enumerate(seg.kinds):
                    x = shard_act(S.layer_forward(lp[f"k{i}"], x, kind,
                                                  self.cfg, seg.use_moe, ctx))
        return self._logits(params, x)

    def loss(self, params: PyTree, batch: dict,
             shard_act: Callable = Identity) -> Tuple[Tensor, dict]:
        """Mean next-token NLL, ``logsumexp(logits) - logit[label]``, over
        ``batch["labels"]`` (B, S); every batch key but ``tokens`` and
        ``labels`` goes to ``extras``.  The label's logit is a gather (the
        reference contracts a one-hot, which at vocab 256000 costs as
        much memory as the logits).  Returns ``(loss, {"loss",
        "ppl_proxy"})``, ``ppl_proxy = exp(min(loss, 20))``."""
        logits = self.forward(params, batch["tokens"],
                              extras={k: v for k, v in batch.items()
                                      if k not in ("tokens", "labels")},
                              shard_act=shard_act)
        loss = torch.mean(token_nll(logits, batch["labels"].long()))
        return loss, {"loss": loss,
                      "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int,
                   extras: Optional[dict] = None, device="cuda") -> PyTree:
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        ctx = {"window": cfg.sliding_window,
               "memory_len": self._memory_len(extras)}
        caches = [
            _stack([{f"k{i}": S.init_layer_cache(kind, cfg, batch, max_seq,
                                                  dtype, ctx, device)
                     for i, kind in enumerate(seg.kinds)}
                    for _ in range(seg.repeats)])
            for seg in self._check()]
        return {"layers": caches, "pos": 0}

    def prefill(self, params: PyTree, tokens: Tensor,
                extras: Optional[dict] = None,
                shard_act: Callable = Identity) -> Tuple[Tensor, PyTree]:
        """Full-sequence prefill: last-token logits + filled decode caches.

        Returned caches hold exactly the processed sequence (attention k/v
        of length S or the sliding window; recurrent final states).  The
        serving engine re-aligns them into fixed-size decode buffers.
        """
        segs = self._check()
        x, ctx = self._embed(params, tokens, extras)
        caches = []
        for seg, sp in zip(segs, params["segments"]):
            per_rep = []
            for r in range(seg.repeats):
                lp, new_c = _index(sp, r), {}
                for i, kind in enumerate(seg.kinds):
                    x, new_c[f"k{i}"] = S.layer_prefill(
                        lp[f"k{i}"], x, kind, self.cfg, seg.use_moe, ctx)
                    x = shard_act(x)
                per_rep.append(new_c)
            caches.append(_stack(per_rep))
        logits = self._logits(params, x[:, -1:])
        return logits[:, 0], {"layers": caches, "pos": tokens.shape[1]}

    def decode_step(self, params: PyTree, token: Tensor, cache: PyTree,
                    extras: Optional[dict] = None,
                    shard_act: Callable = Identity
                    ) -> Tuple[Tensor, PyTree]:
        """token: (B,) -> logits (B,V), updated cache (one position)."""
        segs = self._check()
        pos = int(cache["pos"])
        x = embed_lookup(params["embed"], token)[:, None, :]  # (B,1,D)
        ctx = dict(self._ctx(None), memory_len=self._memory_len(extras))
        new_caches = []
        for seg, sp, sc in zip(segs, params["segments"], cache["layers"]):
            per_rep = []
            for r in range(seg.repeats):
                lp, lc, new_lc = _index(sp, r), _index(sc, r), {}
                for i, kind in enumerate(seg.kinds):
                    x, new_lc[f"k{i}"] = S.layer_decode(
                        lp[f"k{i}"], x, lc[f"k{i}"], kind, self.cfg,
                        seg.use_moe, pos, ctx)
                    x = shard_act(x)
                per_rep.append(new_lc)
            new_caches.append(_stack(per_rep))
        logits = self._logits(params, x)
        return logits[:, 0], {"layers": new_caches, "pos": pos + 1}


def build_model(cfg: ArchConfig,
                backend: Union[str, Backend, None] = None) -> LanguageModel:
    """``backend``: ``"torch"`` (default) or ``"cuda"`` (a ``Backend`` or
    one of ``kernels.backend.BACKEND_KEYS``)."""
    return LanguageModel(cfg, resolve_backend(backend))
