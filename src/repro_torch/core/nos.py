"""Neural Operator Scaffolding (paper §4), port of ``repro.core.nos``.

Trains the cheap FuSeConv operator by distilling from the expensive
depthwise operator *inside the same network*:

  1. start from a trained all-depthwise teacher network;
  2. build a scaffolded student: every spatial stage holds the teacher
     kernel + a shared KxK adapter (``variant="scaffold"``);
  3. each step, every scaffolded layer is randomly realized as depthwise or
     (adapter-derived) FuSe-Half — OFA-style operator sampling;
  4. loss = CE + knowledge distillation against the frozen teacher's logits;
  5. after training, ``collapse`` materializes pure FuSe-Half weights
     (R_w = A @ T_w[:,mid,:], C_w = A @ T_w[mid,:,:]) and the scaffold is
     discarded — inference cost is exactly the FuSe-Half network.

Parameter trees are the zoo's (lists of dicts of tensors); every function
here returns new containers and never writes into a tensor it was given.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core import fuseconv as fc
from repro_torch.vision import zoo

Tensor = torch.Tensor


def _spatial_blocks(net: zoo.NetworkDef, params: list):
    """(is_spatial, params) per block, in order."""
    return [(isinstance(b, (zoo.DWSep, zoo.MBConv)), p)
            for b, p in zip(net.blocks, params)]


# ---------------------------------------------------------------------------
# Scaffold construction / collapse.
# ---------------------------------------------------------------------------

def scaffold_from_teacher(teacher_params: list, net: zoo.NetworkDef) -> list:
    """A scaffold student from a trained all-depthwise network's params.

    Every spatial stage gains an identity-initialized shared adapter and a
    runtime ``choice`` scalar (0 = depthwise, 1 = FuSe).  The student's
    containers are new; its tensors are the teacher's until updated.
    """
    student: list = []
    for spatial, p in _spatial_blocks(net, teacher_params):
        q = dict(p)
        if spatial:
            dw = p["sp"]["dw"]
            q["sp"] = {"dw": dw,
                       "adapter": torch.eye(dw.shape[0], dtype=dw.dtype,
                                            device=dw.device),
                       "choice": torch.zeros((), dtype=dw.dtype,
                                             device=dw.device)}
        student.append(q)
    return student


def set_choices(params: list, net: zoo.NetworkDef, choices: Tensor) -> list:
    """choices: (num_spatial_stages,) in [0,1]."""
    out: list = []
    vi = 0
    for spatial, p in _spatial_blocks(net, params):
        if spatial:
            q = dict(p)
            q["sp"] = dict(p["sp"])
            q["sp"]["choice"] = choices[vi].to(p["sp"]["dw"].dtype)
            vi += 1
            out.append(q)
        else:
            out.append(p)
    return out


def collapse(params: list, net: zoo.NetworkDef,
             keep_depthwise: Optional[Sequence[bool]] = None) -> tuple:
    """Materialize deployable params from a trained scaffold.

    Returns (params, variant_list).  ``keep_depthwise[i]=True`` keeps stage i
    as depthwise (hybrid networks, paper §4.2); default collapses every
    stage to FuSe-Half.
    """
    out: list = []
    variants: List[str] = []
    vi = 0
    for spatial, p in _spatial_blocks(net, params):
        if spatial:
            keep = bool(keep_depthwise[vi]) if keep_depthwise is not None \
                else False
            q = dict(p)
            if keep:
                q["sp"] = {"dw": p["sp"]["dw"]}
                variants.append("depthwise")
            else:
                q["sp"] = fc.derive_fuse_from_teacher(
                    p["sp"]["dw"], p["sp"]["adapter"], "fuse_half")
                variants.append("fuse_half")
            vi += 1
            out.append(q)
        else:
            out.append(p)
    return out, variants


# ---------------------------------------------------------------------------
# Losses.
# ---------------------------------------------------------------------------

def cross_entropy(logits: Tensor, labels: Tensor,
                  label_smoothing: float = 0.0) -> Tensor:
    n = logits.shape[-1]
    onehot = F.one_hot(labels.long(), n).to(logits.dtype)
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / n
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(onehot * logp, dim=-1))


def kd_loss(student_logits: Tensor, teacher_logits: Tensor,
            temperature: float = 2.0) -> Tensor:
    """Hinton et al. soft-label distillation (paper §4.1 uses logit KD)."""
    t = temperature
    p_t = F.softmax(teacher_logits / t, dim=-1)
    logp_s = F.log_softmax(student_logits / t, dim=-1)
    return -torch.mean(torch.sum(p_t * logp_s, dim=-1)) * t * t


# ---------------------------------------------------------------------------
# One NOS training step's loss (functional; optimizer from repro_torch.optim).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NOSConfig:
    kd_alpha: float = 1.0
    kd_temperature: float = 2.0
    label_smoothing: float = 0.1
    fuse_prob: float = 0.5       # per-layer per-step P(realize as FuSe)


def nos_loss_fn(student_params: list, net: zoo.NetworkDef,
                teacher_params: list, batch: dict, choices: Tensor,
                cfg: NOSConfig):
    """Returns (loss, (new_bn_state, metrics)).  The teacher is frozen: its
    forward runs under ``torch.no_grad``."""
    sp = set_choices(student_params, net, choices)
    n_stages = net.num_spatial_stages
    s_logits, new_state = zoo.apply_network_train(
        sp, net, batch["image"], ["scaffold"] * n_stages)
    with torch.no_grad():
        t_logits = zoo.apply_network(teacher_params, net, batch["image"],
                                     "depthwise")
    ce = cross_entropy(s_logits, batch["label"], cfg.label_smoothing)
    kd = kd_loss(s_logits, t_logits, cfg.kd_temperature)
    loss = ce + cfg.kd_alpha * kd
    acc = torch.mean((torch.argmax(s_logits, -1) == batch["label"])
                     .to(torch.float32))
    return loss, (new_state, {"loss": loss, "ce": ce, "kd": kd, "acc": acc})


def sample_choices(generator: torch.Generator, n_stages: int,
                   fuse_prob: float) -> Tensor:
    """(n_stages,) float32 of 0/1, each 1 with probability ``fuse_prob``,
    on the generator's device."""
    u = torch.rand(n_stages, generator=generator, device=generator.device)
    return (u < fuse_prob).to(torch.float32)
