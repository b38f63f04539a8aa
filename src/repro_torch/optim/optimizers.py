"""Optimizers as (init, update) pairs over parameter trees (port of
``repro.optim.optimizers``).

``update(grads, state, params, step) -> (updates, state)``; apply with
``apply_updates``.  Weight decay is decoupled (AdamW-style) and masked to
parameters with ndim >= 2 (skips BN scale/bias, biases, BN running stats
and the 0-d NOS ``choice``; keeps the (K, K) NOS adapter).  A gradient of
``None`` (a leaf the loss does not reach, as ``torch.autograd.grad``
reports it with ``allow_unused=True``) counts as zero, as ``jax.grad``
gives it.  Not ``torch.optim``: the decay mask, the momentum and the
order of the update follow the reference.  Call under ``torch.no_grad``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

Tree = Any
Tensor = torch.Tensor
LR = Union[Callable[[int], float], float]


def _lr_fn(lr: LR) -> Callable[[int], float]:
    return lr if callable(lr) else (lambda _: lr)


def _grad(g, p) -> Tensor:
    return torch.zeros_like(p, dtype=torch.float32) if g is None \
        else g.float()


def _decayed(g, p, weight_decay: float) -> Tensor:
    """The gradient plus the masked decay term, in float32."""
    g = _grad(g, p)
    return g + weight_decay * p.float() if p.ndim >= 2 else g


def global_norm(tree: Tree) -> Tensor:
    leaves = [l for l in tree_leaves(tree) if l is not None]
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: None if g is None else g * scale, grads), norm


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[..., Tuple[Tree, Tree]]  # (grads, state, params, step)


def _zeros(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def sgd_momentum(lr: LR, momentum: float = 0.9, weight_decay: float = 0.0,
                 nesterov: bool = False) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"mu": _zeros(params)}

    def update(grads, state, params, step):
        g = tree_map(lambda gr, p: _decayed(gr, p, weight_decay), grads,
                     params)
        mu = tree_map(lambda m_, g_: momentum * m_ + g_, state["mu"], g)
        d = (tree_map(lambda g_, m_: g_ + momentum * m_, g, mu)
             if nesterov else mu)
        lr_t = lr_fn(step)
        return tree_map(lambda d_: -lr_t * d_, d), {"mu": mu}

    return Optimizer(init, update)


def rmsprop(lr: LR, decay: float = 0.9, momentum: float = 0.9,
            eps: float = 1e-3, weight_decay: float = 0.0) -> Optimizer:
    """TF-style RMSProp (the paper's in-place-replacement optimizer)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"nu": _zeros(params), "mu": _zeros(params)}

    def update(grads, state, params, step):
        g = tree_map(lambda gr, p: _decayed(gr, p, weight_decay), grads,
                     params)
        nu = tree_map(lambda n_, g_: decay * n_ + (1 - decay) * torch.square(g_),
                      state["nu"], g)
        scaled = tree_map(lambda g_, n_: g_ / (torch.sqrt(n_) + eps), g, nu)
        mu = tree_map(lambda m_, s_: momentum * m_ + s_, state["mu"], scaled)
        lr_t = lr_fn(step)
        return tree_map(lambda m_: -lr_t * m_, mu), {"nu": nu, "mu": mu}

    return Optimizer(init, update)


def adamw(lr: LR, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with fp32 moments (the LM trainer's default)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def update(grads, state, params, step):
        step_f = float(step) + 1.0
        m = tree_map(lambda m_, gr, p: b1 * m_ + (1 - b1) * _grad(gr, p),
                     state["m"], grads, params)
        v = tree_map(lambda v_, gr, p: b2 * v_ + (1 - b2) *
                     torch.square(_grad(gr, p)), state["v"], grads, params)
        bc1 = 1 - b1 ** step_f
        bc2 = 1 - b2 ** step_f
        lr_t = lr_fn(step)

        def upd(m_, v_, p):
            mask = 1.0 if p.ndim >= 2 else 0.0
            return -lr_t * ((m_ / bc1) / (torch.sqrt(v_ / bc2) + eps) +
                            weight_decay * mask * p.float())

        return tree_map(upd, m, v, params), {"m": m, "v": v}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Exponential moving average of params (paper §5.3.1 uses decay 0.999).
# ---------------------------------------------------------------------------

def ema_init(params: Tree) -> Tree:
    return tree_map(lambda p: p.float(), params)


def ema_update(ema: Tree, params: Tree, decay: float = 0.999) -> Tree:
    return tree_map(lambda e, p: decay * e + (1 - decay) * p.float(),
                    ema, params)
