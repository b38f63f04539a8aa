"""Model registry: zoo networks x FuSe variants, served eagerly per bucket.

Port of ``repro.serving.vision.registry`` (single device).  A
``RegisteredModel`` bundles everything the engine and cost model need for
one servable entry: the ``NetworkDef``, the spatial-operator variant, the
initialized (or loaded) params and the lowered operator IR (for the
systolic cost model).  ``ModelRegistry.apply`` runs the network eagerly
on the registry's device and backend, whatever the bucket: there is no
jit, donation, mesh or compile cache in this slice.

Numerics are fixed at construction: fp32 convolutions and matmuls with
TF32 off (``torch.backends.cudnn.allow_tf32`` defaults to True, and TF32
would move the stem conv's output past any 1e-4 tolerance).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.layerir import OpSpec
from repro_torch.kernels import backend as kb
from repro_torch.vision import zoo


@dataclasses.dataclass
class RegisteredModel:
    key: str
    net: zoo.NetworkDef
    variant: Union[str, tuple]
    params: list
    ir: List[OpSpec]

    @property
    def resolution(self) -> int:
        return self.net.resolution

    @property
    def num_classes(self) -> int:
        head = self.net.blocks[-1]
        assert isinstance(head, zoo.Head), head
        return head.classes


def default_model_key(net_name: str, variant: Union[str, tuple]) -> str:
    v = variant if isinstance(variant, str) else "hybrid"
    return f"{net_name}/{v}"


class ModelRegistry:
    """Servable models on one device.  ``device`` defaults to ``cuda``;
    asking for CUDA without a card raises (there is no CPU fallback)."""

    def __init__(self, backend: Union[str, kb.Backend, None] = "cuda",
                 device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ModelRegistry: CUDA requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.backend = kb.resolve_backend(backend)
        self._models: Dict[str, RegisteredModel] = {}

    # -- registration -------------------------------------------------------
    def register(self, net: zoo.NetworkDef, variant: Union[str, tuple]
                 = "depthwise", *, key: Optional[str] = None,
                 params: Optional[list] = None, seed: int = 0
                 ) -> RegisteredModel:
        """Register ``net`` in ``variant``.  ``params`` (tensors on this
        registry's device, e.g. from ``convert.params_from_numpy``) default
        to the port's own init from ``seed``."""
        k = key or default_model_key(net.name, variant)
        if k in self._models:
            raise ValueError(f"duplicate model key {k!r}")
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            params = zoo.init_network(gen, net, variant, device=self.device)
        model = RegisteredModel(k, net, variant, params,
                                zoo.lower_to_ir(net, variant))
        self._models[k] = model
        return model

    def get(self, key: str) -> RegisteredModel:
        return self._models[key]

    def __contains__(self, key: str) -> bool:
        return key in self._models

    def keys(self) -> List[str]:
        return list(self._models)

    # -- execution ----------------------------------------------------------
    def apply(self, key: str, images) -> torch.Tensor:
        """images: (bucket, res, res, C) numpy, already bucket-padded.
        Returns the logits on this registry's device; the call
        returns once the work is queued, not when it is done."""
        model = self._models[key]
        x = torch.from_numpy(np.asarray(images, np.float32)).to(self.device)
        with torch.inference_mode():
            return zoo.apply_network(model.params, model.net, x,
                                     model.variant, backend=self.backend)
