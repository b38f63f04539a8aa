"""Deterministic procedural vision classification task (port of
``repro.data.vision_synth``).

Each class is a mixture of oriented gratings + a radial component with
class-dependent parameters, plus noise — easy for a convnet with enough
capacity, hard enough to show operator-capacity gaps.  Fully seeded and
step-indexed (seekable): ``synth_image_batch`` draws from a
``torch.Generator`` seeded from ``(cfg.seed, step)`` on the target device,
so a step's batch is the same across restarts on that device.  The draws
cannot match ``jax.random``; ``render`` is the deterministic part, which
turns draws into images exactly as the reference's ``_render`` does.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SynthVisionConfig:
    resolution: int = 32
    num_classes: int = 10
    noise: float = 0.35
    seed: int = 0


def step_seed(seed: int, step: int) -> int:
    """A 64-bit generator seed for ``(seed, step)``: numpy's
    ``SeedSequence`` mixes the pair, so neighbouring steps and seeds draw
    unrelated streams."""
    return int(np.random.SeedSequence((int(seed), int(step)))
               .generate_state(1, np.uint64)[0])


def render(label: Tensor, theta_jitter: Tensor, phase: Tensor,
           noise: Tensor, *, num_classes: int, noise_scale: float) -> Tensor:
    """Images from draws, batched.  label: (B,) ints; theta_jitter: (B,)
    standard normals; phase: (B,) in [0, 2 pi); noise: (B, R, R, 3)
    standard normals.  Returns (B, R, R, 3) float32."""
    res = noise.shape[1]
    dev = noise.device
    lab = label.to(torch.float32)[:, None, None]
    lin = torch.linspace(-1.0, 1.0, res, device=dev)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    theta = math.pi * lab / num_classes + theta_jitter[:, None, None] * 0.05
    freq = 2.0 + torch.remainder(lab, 3) * 1.5
    grat = torch.sin(2 * math.pi * freq * (xx * torch.cos(theta) +
                                           yy * torch.sin(theta))
                     + phase[:, None, None])
    r = torch.sqrt(xx ** 2 + yy ** 2)
    rings = torch.cos(2 * math.pi * (1.0 + torch.remainder(lab, 4)) * r)
    mix = torch.where(torch.remainder(lab, 2) == 0, 0.7, 0.3)
    base = mix * grat + (1 - mix) * rings
    # class-dependent channel tinting
    tint = torch.stack([torch.cos(2 * math.pi * lab[:, 0, 0] / num_classes
                                  + d) for d in (0.0, 2.1, 4.2)], dim=-1)
    img = base[..., None] * (0.5 + 0.5 * tint)[:, None, None, :]
    return (img + noise_scale * noise).to(torch.float32)


def synth_image_batch(step: int, batch: int, cfg: SynthVisionConfig, *,
                      device="cuda") -> dict:
    """Batch for a given step index, made on ``device``: ``{"image": (B,
    R, R, 3) float32, "label": (B,) int64}``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(step_seed(cfg.seed, step))
    res = cfg.resolution
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen,
                           device=dev)
    theta_jitter = torch.randn(batch, generator=gen, device=dev)
    phase = torch.rand(batch, generator=gen, device=dev) * (2 * math.pi)
    noise = torch.randn(batch, res, res, 3, generator=gen, device=dev)
    return {"image": render(labels, theta_jitter, phase, noise,
                            num_classes=cfg.num_classes,
                            noise_scale=cfg.noise),
            "label": labels}
