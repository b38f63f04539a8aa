"""Model registry: zoo networks x FuSe variants, served eagerly per bucket.

Port of ``repro.serving.vision.registry`` (single device).  A
``RegisteredModel`` bundles everything the engine and cost model need for
one servable entry: the ``NetworkDef``, the spatial-operator variant, the
initialized (or loaded) params and the lowered operator IR (for the
systolic cost model).  ``ModelRegistry.apply`` runs the network eagerly
on the registry's device and backend, whatever the bucket: there is no
jit, donation or mesh; what is compiled is the kernel libraries, once per
process (see the build cache below).

Asynchrony, as ``jax.device_put`` and jit dispatch give the reference:
``apply`` stages the batch through a pinned host buffer, uploads it with
``non_blocking=True``, queues the forward and the logits' copy back into
another pinned buffer, records a CUDA event behind them and returns a
``BatchLogits`` handle at once.  ``is_ready()`` queries the event (the
engine's readiness probe), ``materialize()`` waits on it and hands back
the numpy logits.  The handle keeps the staged input alive until then,
so a pinned buffer is never reused before its copy has run.  On a CPU
registry the handle is ready at once.

Accounting: the first call of each (model, bucket) is timed into a
compile log (the wall ms of the call: kernel libraries loaded or built,
cuDNN's algorithm search for the stem, first allocations), with the
kernel build cache's hit/miss delta seen during it; an entry that has run
once is "compiled" for the replanner's warm-only backfill.  The build
cache (``compilecache.py``) is pointed at ``compilation_cache_dir`` at
construction, before any kernel library loads.

Numerics are fixed at construction: fp32 convolutions and matmuls with
TF32 off (``torch.backends.cudnn.allow_tf32`` defaults to True, and TF32
would move the stem conv's output past any 1e-4 tolerance).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.layerir import OpSpec
from repro_torch.kernels import backend as kb
from repro_torch.serving.vision.compilecache import (
    counters_delta, enable_compilation_cache, persistent_cache_counters)
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


def device_groups(devices: Sequence, k: int) -> List[tuple]:
    """Split ``devices`` into ``k`` equal contiguous groups (the round
    scheduler's analogue of assigning independent convolutions to
    independent systolic-array rows).  The engine does not use groups yet:
    meshes are not ported."""
    assert k >= 1 and len(devices) % k == 0, (len(devices), k)
    g = len(devices) // k
    return [tuple(devices[i * g:(i + 1) * g]) for i in range(k)]


def device_groups_sized(devices: Sequence,
                        sizes: Sequence[int]) -> List[tuple]:
    """Split ``devices`` into contiguous groups with explicit per-group
    sizes (the adaptive round planner's uneven splits); ``sizes`` must be
    positive and sum to the device count."""
    assert sum(sizes) == len(devices), (list(sizes), len(devices))
    out: List[tuple] = []
    i = 0
    for s in sizes:
        assert s >= 1, sizes
        out.append(tuple(devices[i:i + s]))
        i += s
    return out


class BatchLogits:
    """The logits of one dispatched batch on their way to the host.

    On a CUDA tensor the device-to-host copy into a pinned buffer is
    queued on the current stream at construction and an event recorded
    behind it; ``is_ready()`` queries that event without blocking and
    ``materialize()`` waits on it.  ``staged`` (the batch's pinned input
    buffer) is held until the event has completed."""

    def __init__(self, logits: torch.Tensor, staged=None):
        self._event = None
        self._staged = staged
        if logits.device.type == "cuda":
            self._host = torch.empty(logits.shape, dtype=torch.float32,
                                     pin_memory=True)
            self._host.copy_(logits, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(logits.device))
        else:
            self._host = logits.float()

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def materialize(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._staged = None
        return self._host.numpy()


class ModelRegistry:
    """Servable models on one device.  ``device`` defaults to ``cuda``;
    asking for CUDA without a card raises (there is no CPU fallback).
    ``compilation_cache_dir`` (else ``$REPRO_TORCH_KERNEL_CACHE_DIR``) is
    where the kernel libraries are built and found."""

    devices = None          # no mesh: the engine schedules one device

    def __init__(self, backend: Union[str, kb.Backend, None] = "cuda",
                 device: Union[str, torch.device] = "cuda",
                 compilation_cache_dir: Optional[str] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ModelRegistry: CUDA requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.backend = kb.resolve_backend(backend)
        self.compilation_cache_dir = enable_compilation_cache(
            compilation_cache_dir)
        self._models: Dict[str, RegisteredModel] = {}
        # per-entry compile log: one record per (model, bucket) first run
        # by THIS registry, with the call's wall ms.  Written under a
        # lock: warmup, the device thread and replanning all run entries.
        self._compile_lock = threading.Lock()
        self._compile_log: List[Dict] = []
        self._called: set = set()      # (key, bucket) run at least once

    @property
    def n_devices(self) -> int:
        return 1

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
    def apply(self, key: str, images,
              devices: Optional[Sequence] = None) -> BatchLogits:
        """images: (bucket, res, res, C) numpy, already bucket-padded.
        Queues the forward on this registry's device and returns its
        ``BatchLogits`` handle once the work is queued, not when it is
        done.  ``devices`` (a device group) is refused: meshes are not
        ported."""
        if devices is not None:
            raise ValueError("ModelRegistry.apply: device groups are not "
                             "ported; the port serves on one device")
        model = self._models[key]
        x_np = np.ascontiguousarray(images, np.float32)
        cache_key = (key, x_np.shape[0])
        with self._compile_lock:
            fresh = cache_key not in self._called
            self._called.add(cache_key)
        before = persistent_cache_counters() if fresh else None
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                out = self._dispatch(model, x_np)
        else:
            out = self._dispatch(model, x_np)
        if fresh:
            build_ms = (time.perf_counter() - t0) * 1e3
            delta = counters_delta(before)
            with self._compile_lock:
                self._compile_log.append({
                    "key": key, "bucket": cache_key[1], "devices": None,
                    "build_ms": build_ms,
                    "pcache_hits": int(delta["hits"]),
                    "pcache_misses": int(delta["misses"])})
        return out

    def _dispatch(self, model: RegisteredModel,
                  x_np: np.ndarray) -> BatchLogits:
        x = torch.from_numpy(x_np)
        staged = None
        if self.device.type == "cuda":
            staged = x.pin_memory()
            x = staged.to(self.device, non_blocking=True)
        with torch.inference_mode():
            logits = zoo.apply_network(model.params, model.net, x,
                                       model.variant, backend=self.backend)
            return BatchLogits(logits, staged)

    def is_compiled(self, key: str, bucket: int,
                    devices: Optional[Sequence] = None) -> bool:
        """True when ``apply(key, <bucket-sized batch>)`` has run before on
        this registry — the engine's mid-flight replanner only backfills
        with such entries, so a replan dispatch never pays a first run
        under traffic."""
        if devices is not None:
            return False
        with self._compile_lock:
            return (key, bucket) in self._called

    def prewarm(self, key: str, buckets, *, host: bool = True,
                device: bool = True,
                groups: Optional[Sequence[Sequence]] = None) -> None:
        """Warm the serving pipeline's stages off the hot path.

        device: run the network once per (model, bucket) and wait, so the
        device stage never runs an entry for the first time under traffic.
        host: exercise the batch-formation path (letterbox + stack +
        bucket pad) per bucket.  ``groups`` (device groups) are refused."""
        if groups:
            raise ValueError("ModelRegistry.prewarm: device groups are not "
                             "ported")
        model = self._models[key]
        res, cin = model.resolution, model.net.in_channels
        if host:
            from repro_torch.serving.vision.batcher import (VisionRequest,
                                                            form_batch)
            img = np.zeros((res // 2 or 1, res + 1, cin), np.float32)
            for b in buckets:
                form_batch([VisionRequest(-1, key, img, 0.0)], b, res)
        if device:
            for b in buckets:
                self.warm_entry(key, b, host=False)

    def warm_entry(self, key: str, bucket: int,
                   devices: Optional[Sequence] = None, *,
                   host: bool = True) -> None:
        """Warm exactly ONE (model, bucket) entry: run the bucket-shaped
        apply once and wait for its logits.  ``host=True`` also exercises
        batch formation for the bucket."""
        model = self._models[key]
        res, cin = model.resolution, model.net.in_channels
        if host:
            from repro_torch.serving.vision.batcher import (VisionRequest,
                                                            form_batch)
            img = np.zeros((res // 2 or 1, res + 1, cin), np.float32)
            form_batch([VisionRequest(-1, key, img, 0.0)], bucket, res)
        self.apply(key, np.zeros((bucket, res, res, cin), np.float32),
                   devices=tuple(devices) if devices else None).materialize()

    def backend_fingerprint(self) -> str:
        """Stable hash of what a warmed entry depends on: the torch and
        CUDA versions, the device's name, the backend key and the
        registered model set (key, variant, resolution, depth)."""
        ident = {
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
            "backend": self.backend.key,
            "n_devices": self.n_devices,
            "models": sorted(
                (k, str(m.variant), m.resolution, len(m.net.blocks))
                for k, m in self._models.items()),
        }
        blob = json.dumps(ident, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def compile_stats(self) -> Dict:
        """First-run accounting: the build cache's directory, entries run,
        their first calls' wall ms, the process-wide build counters and the
        log of each entry.  The cold/warm restart gate diffs
        ``persistent["misses"]`` across two processes sharing a
        directory."""
        with self._compile_lock:
            log = [dict(e) for e in self._compile_log]
        return {
            "cache_dir": self.compilation_cache_dir,
            "persistent": persistent_cache_counters(),
            "entries_built": len(log),
            "build_ms_total": sum(e["build_ms"] for e in log),
            "compile_log": log,
        }

    def compiled_buckets(self) -> List[tuple]:
        with self._compile_lock:
            return sorted(self._called)
