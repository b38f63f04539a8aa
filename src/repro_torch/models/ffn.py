"""Feed-forward layers: the dense (GLU) MLP and the capacity-based MoE.

Port of ``repro.models.ffn``.  The MoE follows the reference's GShard
formulation: tokens in groups of ``min(group_size, n_tok)``, router logits
in fp32, softmax, top-k, the k gates renormalised, a capacity of
``max(int(gs * k * capacity_factor / E), k)`` slots per expert and group,
and slot positions from the slot-major cumulative count (every token's
first choice before any token's second), so a slot past the capacity is
dropped: its gate is 0 and its position clamped to ``cap - 1``.  The
reference's one-hot dispatch and combine matmuls become a scatter of each
sent token into its expert slot and a gather of each slot's output, summed
with the gates in fp32 and cast once to ``x.dtype``: the combine weights
are the gates cast to ``x.dtype`` and a slot is sent where that weight is
positive (the reference's ``dispatch = combine > 0``), so every kept
(token, slot) pair and every drop is the reference's.  The expert FFNs are
``torch.einsum`` over the stacked (E, d, f) weights, as in the reference,
and read every expert whatever the routing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import ACT, GLU_ACTS, dense_init
from repro_torch.models.config import ArchConfig, MoEConfig

Tensor = torch.Tensor


def init_mlp(generator: torch.Generator, d: int, d_ff: int, dtype,
             act: str = "silu", device=None) -> dict:
    p = {"wi": dense_init(generator, (d, d_ff), dtype, device=device)}
    if act in GLU_ACTS:
        p["wg"] = dense_init(generator, (d, d_ff), dtype, device=device)
    p["wo"] = dense_init(generator, (d_ff, d), dtype, device=device)
    return p


def mlp_forward(p: dict, x: Tensor, act: str = "silu") -> Tensor:
    if "wg" in p:
        return (ACT[act](x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
    return ACT[act](x @ p["wi"]) @ p["wo"]


# ---------------------------------------------------------------------------
# Mixture of Experts.
# ---------------------------------------------------------------------------

def init_moe(generator: torch.Generator, cfg: ArchConfig, dtype,
             device=None) -> dict:
    e: MoEConfig = cfg.moe
    d, n, f = cfg.d_model, e.num_experts, e.d_expert
    p = {"router": dense_init(generator, (d, n), torch.float32,
                              device=device),
         "wi": dense_init(generator, (n, d, f), dtype, device=device),
         "wg": dense_init(generator, (n, d, f), dtype, device=device),
         "wo": dense_init(generator, (n, f, d), dtype, device=device)}
    if e.num_shared:
        p["shared"] = init_mlp(generator, d, f * e.num_shared, dtype,
                               cfg.act, device)
    return p


class Routing(NamedTuple):
    """One MoE layer's routing of G groups of N tokens over K slots."""
    idx: Tensor     # (G, N, K) expert of each (token, slot), top-k order
    gates: Tensor   # (G, N, K) fp32 renormalised gate, 0 where dropped
    keep: Tensor    # (G, N, K) bool: the slot fits in its expert's buffer
    pos: Tensor     # (G, N, K) int64 position there, clamped to cap - 1
    cap: int        # slots per expert and group


def token_groups(x: Tensor, e: MoEConfig) -> Tensor:
    """x (B, S, D) as (G, gs, D) dispatch groups, gs = min(group_size,
    B * S).  The reference's reshape fails where B * S exceeds the group
    size and is not a multiple of it; padding would change the capacity
    and the drops, so this refuses the same inputs."""
    b, s, d = x.shape
    n_tok = b * s
    gs = min(e.group_size, n_tok)
    if n_tok % gs:
        raise ValueError(
            f"MoE: {n_tok} tokens (batch {b} x {s}) are more than the "
            f"group size {e.group_size} and not a multiple of it; the "
            f"reference's dispatch reshape fails there")
    return x.reshape(n_tok // gs, gs, d)


def moe_route(p: dict, x: Tensor, cfg: ArchConfig) -> Routing:
    """The reference's routing of x (B, S, D): top-k of the fp32 router
    softmax, gates renormalised, slot-major positions, capacity drops."""
    e: MoEConfig = cfg.moe
    xt = token_groups(x, e)
    g, gs, _ = xt.shape
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    gate_vals, idx = torch.topk(probs, e.top_k, dim=-1)       # (G, N, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    cap = max(int(gs * e.top_k * e.capacity_factor / e.num_experts),
              e.top_k)
    # each assignment's place in its expert's buffer: the assignments
    # before it, every token's slot 0 first, then every token's slot 1, ...
    flat = F.one_hot(idx.transpose(1, 2).reshape(g, e.top_k * gs),
                     e.num_experts)                           # (G, K*N, E)
    before = flat.cumsum(1) - flat
    pos = (before * flat).sum(-1).reshape(g, e.top_k, gs).transpose(1, 2)
    keep = pos < cap
    return Routing(idx, gate_vals * keep, keep, pos.clamp(max=cap - 1), cap)


def moe_forward(p: dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    e: MoEConfig = cfg.moe
    b, s, d = x.shape
    xt = token_groups(x, e)
    g, gs, _ = xt.shape
    r = moe_route(p, x, cfg)
    n_slots = e.num_experts * r.cap
    w = r.gates.to(x.dtype)                                   # combine
    sent = w > 0                                              # dispatch
    # flat slot (group, expert, position) of each (token, slot); a slot not
    # sent writes to a spare last row (no boolean mask: no device sync)
    slot = (torch.arange(g, device=x.device)[:, None, None] * n_slots
            + r.idx * r.cap + r.pos)
    expert_in = x.new_zeros(g * n_slots + 1, d)
    expert_in[torch.where(sent, slot, g * n_slots).reshape(-1)] = \
        xt[:, :, None].expand(g, gs, e.top_k, d).reshape(-1, d)
    expert_in = expert_in[:-1].reshape(g, e.num_experts, r.cap, d)
    hg = torch.einsum("gecd,edf->gecf", expert_in, p["wg"])
    hi = torch.einsum("gecd,edf->gecf", expert_in, p["wi"])
    out = torch.einsum("gecf,efd->gecd", ACT[cfg.act](hg) * hi, p["wo"])
    picked = out.reshape(g * n_slots, d)[slot]                # (G, N, K, D)
    y = (w.float()[..., None] * picked.float()).sum(2).to(x.dtype)
    if e.num_shared:
        y = y + mlp_forward(p["shared"], xt, cfg.act)
    return y.reshape(b, s, d)


def moe_aux_loss(p: dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    """Load-balance auxiliary loss (Switch-style), computed on router
    probs."""
    e: MoEConfig = cfg.moe
    logits = x.reshape(-1, x.shape[-1]).float() @ p["router"].float()
    probs = torch.softmax(logits, -1)
    frac_tokens = F.one_hot(probs.argmax(-1), e.num_experts).float().mean(0)
    return e.num_experts * (frac_tokens * probs.mean(0)).sum()
