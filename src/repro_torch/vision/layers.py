"""Functional NN layers for the vision zoo (PyTorch, NHWC, explicit params).

Port of ``repro.vision.layers``.  BatchNorm is written functionally, as in
the reference (biased batch variance, ``new = 0.9 * old + 0.1 * batch``,
eps 1e-5); ``nn.BatchNorm2d`` would update its running variance with the
unbiased estimate instead.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import fuseconv as fc

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Activations.
# ---------------------------------------------------------------------------

def relu(x: Tensor) -> Tensor:
    return torch.relu(x)


def relu6(x: Tensor) -> Tensor:
    return torch.clamp(torch.relu(x), max=6.0)


def hswish(x: Tensor) -> Tensor:
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hsigmoid(x: Tensor) -> Tensor:
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


ACTS = {"relu": relu, "relu6": relu6, "hswish": hswish, "linear": lambda x: x}


# ---------------------------------------------------------------------------
# BatchNorm (train-mode batch stats; inference uses running stats).
# ---------------------------------------------------------------------------

def init_bn(c: int, *, device="cuda", dtype=torch.float32) -> dict:
    return {"scale": torch.ones(c, device=device, dtype=dtype),
            "bias": torch.zeros(c, device=device, dtype=dtype),
            "mean": torch.zeros(c, device=device, dtype=dtype),
            "var": torch.ones(c, device=device, dtype=dtype)}


def apply_bn(p: dict, x: Tensor, *, train: bool, eps: float = 1e-5,
             momentum: float = 0.9) -> Tuple[Tensor, dict]:
    """Returns (y, new_state).  new_state is p when train=False."""
    axes = tuple(range(x.ndim - 1))
    if train:
        mean = x.mean(dim=axes)
        var = x.var(dim=axes, unbiased=False)
        new_p = dict(p)
        new_p["mean"] = momentum * p["mean"] + (1 - momentum) * mean
        new_p["var"] = momentum * p["var"] + (1 - momentum) * var
    else:
        mean, var = p["mean"], p["var"]
        new_p = p
    inv = torch.rsqrt(var + eps)
    y = (x - mean) * inv * p["scale"] + p["bias"]
    return y, new_p


def bn_inference_affine(p: dict, eps: float = 1e-5) -> Tuple[Tensor, Tensor]:
    """Fold inference-mode BN into a per-channel affine: y = x * g + b.

    g = scale / sqrt(var + eps), b = bias - mean * g: algebraically equal
    to ``apply_bn(p, x, train=False)``, which lets the fused FuSeConv
    kernel apply BN between the spatial banks and the pointwise mix.
    """
    g = p["scale"] * torch.rsqrt(p["var"] + eps)
    return g, p["bias"] - p["mean"] * g


# ---------------------------------------------------------------------------
# Conv / dense inits (He normal), drawn from an explicit generator.
# ---------------------------------------------------------------------------

def init_conv(generator: torch.Generator, k: int, cin: int, cout: int, *,
              device="cuda", dtype=torch.float32) -> Tensor:
    """HWIO weights, as in the JAX package."""
    return fc.randn_scaled(generator, (k, k, cin, cout),
                           float(np.sqrt(2.0 / (k * k * cin))), device, dtype)


def init_pointwise(generator: torch.Generator, cin: int, cout: int, *,
                   device="cuda", dtype=torch.float32) -> Tensor:
    return fc.randn_scaled(generator, (cin, cout),
                           float(np.sqrt(2.0 / cin)), device, dtype)


def init_dense(generator: torch.Generator, cin: int, cout: int, *,
               device="cuda", dtype=torch.float32) -> dict:
    return {"w": fc.randn_scaled(generator, (cin, cout),
                                 float(np.sqrt(1.0 / cin)), device, dtype),
            "b": torch.zeros(cout, device=device, dtype=dtype)}


def apply_dense(p: dict, x: Tensor) -> Tensor:
    return x @ p["w"] + p["b"]


# ---------------------------------------------------------------------------
# Squeeze-and-Excite.
# ---------------------------------------------------------------------------

def se_channels(c: int, ratio: int = 4, divisor: int = 8) -> int:
    v = max(divisor, int(c / ratio + divisor / 2) // divisor * divisor)
    return v


def init_se(generator: torch.Generator, c: int, ratio: int = 4, *,
            device="cuda", dtype=torch.float32) -> dict:
    cr = se_channels(c, ratio)
    return {"reduce": init_dense(generator, c, cr, device=device,
                                 dtype=dtype),
            "expand": init_dense(generator, cr, c, device=device,
                                 dtype=dtype)}


def apply_se(p: dict, x: Tensor) -> Tensor:
    s = x.mean(dim=(1, 2))                        # (B, C)
    s = relu(apply_dense(p["reduce"], s))
    s = hsigmoid(apply_dense(p["expand"], s))
    return x * s[:, None, None, :]
