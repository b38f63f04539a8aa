"""Small-scale vision training loops: baseline / in-place / NOS scaffolded.

Port of ``repro.train.vision``.  These drive the paper's accuracy
experiments at container scale on the synthetic task
(``repro_torch.data.vision_synth``), and V3-L at full width on the card.
Eager autograd stands in for ``jax.jit(value_and_grad)``: the forward is
``zoo.apply_network_train`` (plain ops; the reference trains on XLA, not
on its kernels), the update runs under ``torch.no_grad`` with global-norm
clipping to 1.0 and SGD with momentum.  Each step is one module-level
function (``train_step``, ``nos_step``) taking the step's batch (and NOS
choices), so a test can drive it with the reference's own.  Parameters and
data live on ``device`` (the card by default); a step copies nothing to
the host, and the losses come back once, after the loop.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import nos
from repro_torch.data.vision_synth import (SynthVisionConfig, step_seed,
                                           synth_image_batch)
from repro_torch.optim import apply_updates, clip_by_global_norm, sgd_momentum
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path
from repro_torch.vision import zoo


@dataclasses.dataclass(frozen=True)
class VisionTrainConfig:
    steps: int = 300
    batch: int = 64
    lr: float = 0.05
    momentum: float = 0.9
    weight_decay: float = 1e-4
    eval_batches: int = 8
    seed: int = 0


def _loss_fn(params, net, variant, batch):
    logits, new_state = zoo.apply_network_train(params, net, batch["image"],
                                                variant)
    ce = nos.cross_entropy(logits, batch["label"])
    acc = torch.mean((torch.argmax(logits, -1) == batch["label"])
                     .to(torch.float32))
    return ce, (new_state, acc)


def _merge_bn(params, new_state):
    """Keep optimized weights, take BN running stats from the fwd pass."""
    def merge(path, p, s):
        return s.detach() if path[-1] in ("mean", "var") else p
    return tree_map_with_path(merge, params, new_state)


def value_and_grad(fn: Callable, params, *args):
    """``((value, aux), grads)`` of ``fn(params, *args)`` with respect to
    every floating leaf of ``params``, as ``jax.value_and_grad(fn,
    has_aux=True)``; a leaf the value does not reach gets ``None``."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(
            p.is_floating_point()), params)
        value, aux = fn(leaves, *args)
        wrt = [p for p in tree_leaves(leaves) if p.requires_grad]
        grads = iter(torch.autograd.grad(value, wrt, allow_unused=True))
    return (value.detach(), aux), tree_map(
        lambda p: next(grads) if p.requires_grad else None, leaves)


def _update(params, opt_state, grads, new_state, step, opt: Optimizer):
    with torch.no_grad():
        grads, _ = clip_by_global_norm(grads, 1.0)
        updates, opt_state = opt.update(grads, opt_state, params, step)
        params = apply_updates(params, updates)
        return _merge_bn(params, new_state), opt_state


def train_step(params, opt_state, step: int, batch: dict, *, net, variant,
               opt: Optimizer):
    """One step of ``train_vision``: returns (params, opt_state, loss,
    acc), the last two as 0-d tensors on the device."""
    (loss, (new_state, acc)), grads = value_and_grad(
        _loss_fn, params, net, variant, batch)
    params, opt_state = _update(params, opt_state, grads, new_state, step,
                                opt)
    return params, opt_state, loss, acc.detach()


def _log(s, metrics, steps, log_every):
    if log_every and (s % log_every == 0 or s == steps - 1):
        print(f"  step {s:4d} " + " ".join(
            f"{k} {float(v):.4f}" for k, v in metrics.items()))


def train_vision(net: zoo.NetworkDef, variant, cfg: VisionTrainConfig,
                 data_cfg: SynthVisionConfig, params=None,
                 log_every: int = 0, *, device="cuda") -> dict:
    """Train and return {params, train_acc, eval_acc, losses}.  ``params``
    (on ``device``) default to the port's seeded init from ``cfg.seed``."""
    if params is None:
        params = zoo.init_network(torch.Generator().manual_seed(cfg.seed),
                                  net, variant, device=device)
    opt = sgd_momentum(cfg.lr, cfg.momentum, cfg.weight_decay)
    opt_state = opt.init(params)
    losses = []
    acc = torch.zeros(())
    for s in range(cfg.steps):
        batch = synth_image_batch(s, cfg.batch, data_cfg, device=device)
        params, opt_state, loss, acc = train_step(
            params, opt_state, s, batch, net=net, variant=variant, opt=opt)
        losses.append(loss)
        _log(s, {"loss": loss, "acc": acc}, cfg.steps, log_every)
    eval_acc = evaluate(params, net, variant, cfg, data_cfg, device=device)
    return {"params": params, "train_acc": float(acc), "eval_acc": eval_acc,
            "losses": _floats(losses)}


def _floats(ts) -> list:
    return torch.stack(ts).tolist() if ts else []


def recalibrate_bn(params, net, variant, cfg: VisionTrainConfig,
                   data_cfg: SynthVisionConfig, batches: int = 25,
                   offset: int = 20_000, *, device="cuda"):
    """Re-estimate BN running stats for a realized subnet (OFA-style).

    After scaffold training, the stored running stats average over the
    *mixture* of sampled operator choices; a collapsed subnet needs its own
    statistics.  Weights are untouched.
    """
    with torch.no_grad():
        for i in range(batches):
            batch = synth_image_batch(offset + i, cfg.batch, data_cfg,
                                      device=device)
            _, new_state = zoo.apply_network_train(params, net,
                                                   batch["image"], variant)
            params = _merge_bn(params, new_state)
    return params


def evaluate(params, net, variant, cfg: VisionTrainConfig,
             data_cfg: SynthVisionConfig, offset: int = 10_000, *,
             device="cuda") -> float:
    """Held-out eval: step indices disjoint from training."""
    accs = []
    with torch.no_grad():
        for i in range(cfg.eval_batches):
            batch = synth_image_batch(offset + i, cfg.batch, data_cfg,
                                      device=device)
            logits = zoo.apply_network(params, net, batch["image"], variant)
            accs.append(torch.mean((torch.argmax(logits, -1) ==
                                    batch["label"]).to(torch.float32)))
    return sum(_floats(accs)) / len(accs)


# ---------------------------------------------------------------------------
# NOS training (scaffolded student distilling from a frozen teacher).
# ---------------------------------------------------------------------------

def nos_choices(cfg: VisionTrainConfig, step: int, n_stages: int,
                fuse_prob: float) -> torch.Tensor:
    """The operator choices of NOS step ``step`` (on the CPU)."""
    gen = torch.Generator().manual_seed(step_seed(cfg.seed + 1, step))
    return nos.sample_choices(gen, n_stages, fuse_prob)


def nos_step(student, opt_state, step: int, batch: dict,
             choices: torch.Tensor, *, net, teacher_params,
             nos_cfg: nos.NOSConfig, opt: Optimizer):
    """One step of ``train_nos``: returns (student, opt_state, metrics),
    the metrics as 0-d tensors on the device."""
    (_, (new_state, metrics)), grads = value_and_grad(
        nos.nos_loss_fn, student, net, teacher_params, batch, choices,
        nos_cfg)
    student, opt_state = _update(student, opt_state, grads, new_state, step,
                                 opt)
    return student, opt_state, {k: v.detach() for k, v in metrics.items()}


def train_nos(net: zoo.NetworkDef, teacher_params, cfg: VisionTrainConfig,
              data_cfg: SynthVisionConfig,
              nos_cfg: nos.NOSConfig = nos.NOSConfig(),
              log_every: int = 0, *, device="cuda") -> dict:
    """NOS from ``teacher_params`` (on ``device``), then the all-FuSe-Half
    collapse, its BN recalibration and its eval.  Returns {scaffold_params,
    collapsed_params, variants, eval_acc, losses}."""
    student = nos.scaffold_from_teacher(teacher_params, net)
    opt = sgd_momentum(cfg.lr, cfg.momentum, cfg.weight_decay)
    opt_state = opt.init(student)
    n_stages = net.num_spatial_stages
    losses = []
    for s in range(cfg.steps):
        choices = nos_choices(cfg, s, n_stages, nos_cfg.fuse_prob).to(device)
        batch = synth_image_batch(s, cfg.batch, data_cfg, device=device)
        student, opt_state, metrics = nos_step(
            student, opt_state, s, batch, choices, net=net,
            teacher_params=teacher_params, nos_cfg=nos_cfg, opt=opt)
        losses.append(metrics["loss"])
        _log(s, metrics, cfg.steps, log_every)

    collapsed, variants = nos.collapse(student, net)
    collapsed = recalibrate_bn(collapsed, net, variants, cfg, data_cfg,
                               device=device)
    eval_acc = evaluate(collapsed, net, variants, cfg, data_cfg,
                        device=device)
    return {"scaffold_params": student, "collapsed_params": collapsed,
            "variants": variants, "eval_acc": eval_acc,
            "losses": _floats(losses)}
