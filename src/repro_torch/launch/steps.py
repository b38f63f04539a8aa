"""Step builders: train_step (grad-accumulation microbatching),
prefill_step, decode_step, and the train step's shardings.

Port of ``repro.launch.steps``.  Eager autograd through the model's plain
ops stands in for ``jax.jit(value_and_grad)``; the model must be on
backend ``torch`` (the kernels have no backward pass).  Each
``make_*_step`` takes a sharding policy and passes its ``act_constraint``
to the model (the identity without one).  ``make_train_step`` with a policy runs on
DTensor parameters and optimizer state placed as ``train_step_shardings``
gives them (``zero_extend`` and ``train_step_shardings`` give the specs
and placements of that state, as the reference's jit takes them) and on a
batch sharded over the data axes; without one it runs on one device.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from repro_torch.data.vision_synth import step_seed
from repro_torch.kernels._build import is_dtensor
from repro_torch.launch.mesh import axis_size
from repro_torch.launch.sharding import (NamedSharding, P, PartitionSpec,
                                         ShardingPolicy)
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import LanguageModel
from repro_torch.optim import (adamw, apply_updates, clip_by_global_norm,
                               warmup_cosine)
from repro_torch.optim.compression import compress_tree
from repro_torch.optim.optimizers import Optimizer
from repro_torch.train.vision import value_and_grad
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


def default_optimizer(cfg: ArchConfig) -> Optimizer:
    sched = warmup_cosine(3e-4, 200, 10_000, min_lr=3e-5)
    return adamw(sched, b1=0.9, b2=0.95, weight_decay=0.1)


def default_microbatches(cfg: ArchConfig, global_batch: int, seq: int,
                         n_chips: int = 1) -> int:
    """Pick grad-accumulation depth so per-chip live activations stay sane.

    Heuristic: target <= ~2^21 (2M) tokens x d_model bf16 bytes per chip of
    saved residuals across the depth; large models need more splits.
    """
    tokens_per_chip = global_batch * seq / max(n_chips, 1)
    n_super = cfg.num_layers
    bytes_per_chip = tokens_per_chip * cfg.d_model * 2 * max(n_super, 1)
    budget = 4e9                      # ~4 GB of checkpointed residuals
    n = 1
    while bytes_per_chip / n > budget and n < global_batch:
        n *= 2
    while global_batch % n != 0:
        n //= 2
    return max(n, 1)


def update_in_place(opt: Optimizer, grads: List, opt_state: dict,
                    params: PyTree, step: int) -> None:
    """``opt.update`` then ``apply_updates``, one leaf at a time, each new
    parameter and state leaf written into the old tensor.  ``grads`` is the
    list of gradient leaves in ``tree_leaves`` order (``None`` for a leaf
    the loss does not reach); each is dropped from it once used.  The
    numbers are those of the whole-tree update (every optimizer of
    ``repro_torch.optim`` is elementwise, its state a dict of trees shaped
    as ``params``), but only one leaf's new values are alive at a time: a
    whole-tree AdamW would hold the old and the new fp32 moments and the
    fp32 updates of every leaf at once."""
    p_leaves = tree_leaves(params)
    s_leaves = {k: tree_leaves(v) for k, v in opt_state.items()}
    assert all(len(v) == len(p_leaves) for v in s_leaves.values())
    assert len(grads) == len(p_leaves)
    with torch.no_grad():
        for i, p in enumerate(p_leaves):
            state = {k: v[i] for k, v in s_leaves.items()}
            updates, new = opt.update(grads[i], state, p, step)
            grads[i] = None
            for k, t in state.items():
                t.copy_(new[k])
            p.copy_(apply_updates(p, updates))


def _as_placed(grads: List, params: List) -> List:
    """Each DTensor gradient redistributed to its parameter's placements
    (a replicated parameter's gradient arrives as a partial sum over the
    data axes: one all-reduce); plain gradients as they are."""
    return [g if g is None or not is_dtensor(g)
            else g.redistribute(p.device_mesh, p.placements)
            for g, p in zip(grads, params)]


def _full(t):
    """A DTensor's full value as a plain tensor (a collective); a plain
    tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def make_train_step(model: LanguageModel, n_micro: int, optimizer=None,
                    grad_compression: str = "none",
                    policy: Optional[ShardingPolicy] = None) -> Callable:
    """Returns ``train_step(params, opt_state, step, batch) -> (params,
    opt_state, metrics)``.  ``batch`` leaves are (n_micro, mb, ...).  With
    ``n_micro == 1`` the gradient is used directly, in the parameters'
    dtype; otherwise each microbatch's gradient is accumulated in fp32 and
    averaged.  ``grad_compression="int8"`` quantizes each microbatch's
    gradient (``compress_tree``, a generator seeded by the step) before it
    is accumulated, always in fp32, as the reference's trainer does.  Then
    ``clip_by_global_norm(1.0)`` and the optimizer (``default_optimizer``
    unless given), applied in place: the parameters and the optimizer
    state passed in are updated and returned, as the reference donates
    them.  ``metrics``: ``loss`` (the mean over microbatches) and
    ``grad_norm``, plain device tensors.

    With ``policy`` the parameters and optimizer state are DTensors on the
    policy's mesh and the batch leaves DTensors (or plain tensors, taken
    as replicated): the loss runs with ``policy.act_constraint`` under
    DTensor's implicit replication (the plain tensors the model makes meet
    the parameters as replicated), each microbatch's gradient is brought
    to its parameter's placements before anything reads it, the global
    norm is the whole tree's, and each rank updates its own shards.  The
    int8 noise of a leaf is its whole tensor's, drawn on every rank, so
    the step computes the one-device step's numbers on the same batch."""
    if grad_compression not in ("none", "int8"):
        raise ValueError(f"grad_compression: none or int8, not "
                         f"{grad_compression!r}")
    opt = optimizer or default_optimizer(model.cfg)
    int8 = grad_compression == "int8"
    shard_act = _shard_act(policy)

    def loss_fn(params, mb):
        return model.loss(params, mb, shard_act=shard_act)

    def grads_of(params, mb):
        (loss, _), g = value_and_grad(loss_fn, params, mb)
        return loss, _as_placed(tree_leaves(g), tree_leaves(params))

    def train_step(params, opt_state, step, batch):
        micro = [{k: v[i] for k, v in batch.items()} for i in range(n_micro)]
        if n_micro == 1 and not int8:
            # direct path: no fp32 accumulator tree
            loss_sum, grads = grads_of(params, micro[0])
        else:
            gen = None
            if int8:
                dev = tree_leaves(params)[0].device
                gen = torch.Generator(device=dev).manual_seed(
                    step_seed(0, step))
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in tree_leaves(params)]
            loss_sum = 0.0
            for mb in micro:
                loss, g = grads_of(params, mb)
                if int8:
                    g = compress_tree(g, gen)
                for acc, gi in zip(grads, g):
                    if gi is not None:
                        acc.add_(gi.float())
                del g
                loss_sum = loss_sum + loss
            for acc in grads:
                acc.div_(n_micro)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, 1.0)
        update_in_place(opt, grads, opt_state, params, step)
        return params, opt_state, {"loss": _full(loss_sum / n_micro),
                                   "grad_norm": _full(gnorm)}

    if policy is None:
        return train_step

    def sharded_step(params, opt_state, step, batch):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            return train_step(params, opt_state, step, batch)

    return sharded_step


def zero_extend(policy: ShardingPolicy, spec, leaf) -> PartitionSpec:
    """ZeRO: additionally shard optimizer state over 'data' on the first
    divisible dim not already sharded.  No-op when the param spec already
    uses 'data' (zero3 2-D weights)."""
    dsz = axis_size(policy.mesh, "data")
    parts = list(spec) + [None] * (leaf.ndim - len(spec))
    if "data" in parts:
        return P(*parts)
    for i, (dim, s) in enumerate(zip(leaf.shape, parts)):
        if s is None and dim % dsz == 0 and dim >= dsz:
            parts[i] = "data"
            break
    return P(*parts)


def train_step_shardings(policy: ShardingPolicy, params_shape: PyTree,
                         batch_shape: PyTree, zero_opt: bool = False):
    """``(in_shardings, out_shardings)`` of ``train_step(params,
    opt_state, step, batch)``: the parameters' ``NamedSharding``s, the
    AdamW moments' (``zero_extend``-ed with ``zero_opt``), the replicated
    step, and each batch leaf (n_micro, mb, ...) sharded on its
    microbatch axis."""
    mesh = policy.mesh
    ns = lambda s: NamedSharding(mesh, s)
    raw_pspecs = policy.param_specs(params_shape)
    pspecs = tree_map(ns, raw_pspecs)
    if zero_opt:
        osp = tree_map(lambda sp, leaf: ns(zero_extend(policy, sp, leaf)),
                       raw_pspecs, params_shape)
        ospecs = {"m": osp, "v": osp}
    else:
        ospecs = {"m": pspecs, "v": pspecs}

    def batch_one(leaf):
        # leaves are (n_micro, mb, ...): micro axis unsharded
        base = policy.batch_spec(leaf.shape[1])
        return ns(P(None, *(list(base) + [None] * (leaf.ndim - 2))))

    bspecs = tree_map(batch_one, batch_shape)
    in_sh = (pspecs, ospecs, ns(P()), bspecs)
    out_sh = (pspecs, ospecs, ns(P()))
    return in_sh, out_sh


def _shard_act(policy: Optional[ShardingPolicy]) -> Callable:
    return policy.act_constraint if policy is not None else (lambda x: x)


def make_prefill_step(model: LanguageModel,
                      policy: Optional[ShardingPolicy] = None) -> Callable:
    shard_act = _shard_act(policy)

    def prefill_step(params, tokens, extras):
        return model.prefill(params, tokens, extras, shard_act=shard_act)
    return prefill_step


def make_decode_step(model: LanguageModel,
                     policy: Optional[ShardingPolicy] = None) -> Callable:
    shard_act = _shard_act(policy)

    def decode_step(params, token, cache, extras):
        return model.decode_step(params, token, cache, extras,
                                 shard_act=shard_act)
    return decode_step
