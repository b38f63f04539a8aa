"""Once-For-All-style elastic training combined with NOS (paper §4.2, Fig
15), port of ``repro.core.ofa``.

The paper plugs the FuSeConv operator choice into OFA's progressive-
shrinking design space (elastic kernel / depth / width) and "scaffolds
adapter matrices across kernel sizes".  The two dimensions the paper's
§6.5 results hinge on, at container scale:

  * elastic kernel: the spatial stage stores its max-K depthwise kernel;
    smaller kernels are derived OFA-style by center-crop + a learned
    (k'^2 x k'^2) transform matrix shared across channels — the same
    adapter mechanism NOS uses, extended across kernel sizes;
  * elastic operator: every (stage, kernel) choice can additionally be
    realized as FuSe-Half via the NOS adapter of that kernel size;
  * elastic depth: residual-compatible blocks (stride 1, cin == cout) carry
    a runtime skip gate.

``sample_subnet`` draws a configuration.  Progressive shrinking = schedule
over the sampling space (kernels first, then depth, then operators).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import fuseconv as fc

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ElasticSpace:
    kernels: tuple = (7, 5, 3)
    elastic_depth: bool = True
    allow_fuse: bool = True


def kernel_transforms(max_k: int, kernels: Sequence[int], *, device="cuda",
                      dtype=torch.float32) -> dict:
    """Identity-initialized crop transforms {k: (k^2, k^2)} for k < max_k."""
    return {int(k): torch.eye(k * k, device=device, dtype=dtype)
            for k in kernels if k < max_k}


def crop_kernel(dw: Tensor, k: int, transform: Optional[Tensor]) -> Tensor:
    """Center-crop a (K,K,C) kernel to (k,k,C), then linear-transform."""
    off = (dw.shape[0] - k) // 2
    w = dw[off:off + k, off:off + k, :]
    if transform is not None:
        c = w.shape[-1]
        w = (transform @ w.reshape(k * k, c)).reshape(k, k, c)
    return w


def elastic_spatial_apply(params: dict, x: Tensor, *, stride: int,
                          kernel_choice, fuse_choice: Tensor,
                          kernels: Sequence[int]) -> Tensor:
    """Runtime-selectable (kernel, operator) spatial stage.

    params: {dw: (K,K,C) max kernel, kt: {k: transform}, adapter: {k: (k,k)}}
    kernel_choice: index into ``kernels`` (int or 0-d int tensor);
    fuse_choice: {0,1} float.  Every branch is computed and the selection
    is a one-hot weighted sum, as in the reference, so gradients reach
    every branch's weights the same way.
    """
    ys = []
    for k in kernels:
        k = int(k)
        tr = params["kt"].get(k) if k < params["dw"].shape[0] else None
        dw_k = crop_kernel(params["dw"], k, tr)
        y_dw = fc.depthwise_conv2d(x, dw_k, stride=stride)
        derived = fc.derive_fuse_from_teacher(dw_k, params["adapter"][k],
                                              "fuse_half")
        y_fu = fc.fuse_conv2d_half(x, derived["row"], derived["col"],
                                   stride=stride)
        f = fuse_choice.to(y_dw.dtype)
        ys.append(f * y_fu + (1.0 - f) * y_dw)
    stacked = torch.stack(ys)                    # (num_kernels, ...)
    sel = F.one_hot(torch.as_tensor(kernel_choice, device=x.device).long(),
                    len(kernels)).to(stacked.dtype)
    return torch.einsum("s,s...->...", sel, stacked)


def init_elastic_stage(generator: torch.Generator, max_k: int, c: int,
                       space: ElasticSpace, *, device="cuda",
                       dtype=torch.float32) -> dict:
    ks = [k for k in space.kernels if k <= max_k]
    scale = float(np.sqrt(2.0 / (max_k * max_k)))
    return {
        "dw": fc.randn_scaled(generator, (max_k, max_k, c), scale, device,
                              dtype),
        "kt": kernel_transforms(max_k, ks, device=device, dtype=dtype),
        "adapter": {int(k): torch.eye(k, device=device, dtype=dtype)
                    for k in ks},
    }


@dataclasses.dataclass(frozen=True)
class SubnetChoice:
    kernels: List[int]        # per spatial stage
    fuse: List[bool]          # per spatial stage
    skip: List[bool]          # per skippable block


def sample_subnet(generator: torch.Generator, n_stages: int,
                  n_skippable: int, space: ElasticSpace, *,
                  phase: str = "full") -> SubnetChoice:
    """Progressive-shrinking phases: 'kernel' -> 'depth' -> 'full'.

    Kernels, skips and operators are drawn in that order in every phase
    (and masked by it), so one generator state gives the same kernels in
    every phase and the same skips in 'depth' and 'full'."""
    ks = list(space.kernels)
    dev = generator.device
    kern_i = torch.randint(0, len(ks), (n_stages,), generator=generator,
                           device=dev)
    skip_u = torch.rand(n_skippable, generator=generator, device=dev)
    fuse_u = torch.rand(n_stages, generator=generator, device=dev)
    kern = [ks[int(i)] for i in kern_i]
    skip = ([False] * n_skippable if phase == "kernel"
            else [bool(u < 0.25) for u in skip_u])
    fuse = ([bool(u < 0.5) for u in fuse_u]
            if phase not in ("kernel", "depth") and space.allow_fuse
            else [False] * n_stages)
    return SubnetChoice(kern, fuse, skip)
