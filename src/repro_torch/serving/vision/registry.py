"""Model registry: zoo networks x FuSe variants, served eagerly per bucket.

Port of ``repro.serving.vision.registry``.  A ``RegisteredModel`` bundles
everything the engine and cost model need for one servable entry: the
``NetworkDef``, the spatial-operator variant, the initialized (or loaded)
params and the lowered operator IR (for the systolic cost model).
``ModelRegistry.apply`` runs the network eagerly on the registry's
device and backend, whatever the bucket: there is no jit or donation;
what is compiled is the kernel libraries, once per process (see the
build cache below).

Asynchrony, as ``jax.device_put`` and jit dispatch give the reference:
``apply`` stages the batch through a pinned host buffer, uploads it with
``non_blocking=True``, queues the forward and the logits' copy back into
another pinned buffer, records a CUDA event behind them and returns a
``BatchLogits`` handle at once.  ``is_ready()`` queries the event (the
engine's readiness probe), ``materialize()`` waits on it and hands back
the numpy logits.  The handle keeps the staged input alive until then,
so a pinned buffer is never reused before its copy has run.  On a CPU
registry the handle is ready at once.

Meshes: constructed with a data mesh (``repro_torch.launch.mesh.
make_data_mesh``), the registry executes each batch data-parallel over a
device group of mesh devices.  When the bucket divides the group, group
position ``j`` runs its contiguous stripe of rows on its own device and
stream; otherwise the whole batch runs on the group's first device (the
reference replicates it over the group, every device computing the same
rows; the copies would be identical, so the port computes one).  One
``BatchLogits`` handle waits on every stripe's event, and the stripes'
logits land in their rows of one pinned buffer.  Parameters are copied
once per physical device, not per mesh device: a mesh of logical devices
on one card shares one copy.  The kernels launch on the current stream
(``kernels/_build.py::launch``), so a stripe runs under
``torch.cuda.stream`` of its device's stream.  Entries are keyed (model,
bucket) without a mesh and (model, bucket, device-group ids) with one.

Accounting: the first call of each entry is timed into a compile log (the
wall ms of the call: kernel libraries loaded or built, cuDNN's algorithm
search for the stem, first allocations), with the kernel build cache's
hit/miss delta seen during it; an entry that has run once is "compiled"
for the replanner's warm-only backfill.  The build cache
(``compilecache.py``) is pointed at ``compilation_cache_dir`` at
construction, before any kernel library loads.

Numerics are fixed at construction: fp32 convolutions and matmuls with
TF32 off (``torch.backends.cudnn.allow_tf32`` defaults to True, and TF32
would move the stem conv's output past any 1e-4 tolerance).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import tree
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
    independent systolic-array rows)."""
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

    Built on one tensor (its copy queued at once), or empty with a
    ``shape`` for a striped batch, whose stripes ``add`` their rows, each
    under the stream it ran on.  On a CUDA tensor ``add`` queues the
    device-to-host copy into those rows of one pinned buffer and records
    an event behind it; ``is_ready()`` queries every event without
    blocking and ``materialize()`` waits on them.  Each stripe's
    ``staged`` input (its pinned upload buffer) is held until its event
    has completed."""

    def __init__(self, logits: Optional[torch.Tensor] = None, staged=None,
                 *, shape: Optional[tuple] = None, pinned: bool = False):
        if logits is not None:
            shape, pinned = logits.shape, logits.device.type == "cuda"
        self._host = torch.empty(tuple(shape), dtype=torch.float32,
                                 pin_memory=pinned)
        self._events: list = []
        self._staged: list = []
        if logits is not None:
            self.add(0, logits, staged)

    def add(self, row0: int, logits: torch.Tensor, staged=None) -> None:
        dst = self._host[row0:row0 + logits.shape[0]]
        if logits.device.type == "cuda":
            dst.copy_(logits, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(logits.device))
            self._events.append(event)
            self._staged.append(staged)
        else:
            dst.copy_(logits)

    def is_ready(self) -> bool:
        return all(e.query() for e in self._events)

    def materialize(self) -> np.ndarray:
        for e in self._events:
            e.synchronize()
        self._staged.clear()
        return self._host.numpy()


class ModelRegistry:
    """Servable models on one device or over a data mesh.

    ``device`` defaults to the mesh's first physical device, else
    ``cuda``; asking for CUDA without a card raises (there is no CPU
    fallback).  ``mesh`` (a ``launch.mesh.DataMesh``) makes ``devices``
    its mesh devices and ``apply`` stripe batches over device groups.
    ``compilation_cache_dir`` (else ``$REPRO_TORCH_KERNEL_CACHE_DIR``) is
    where the kernel libraries are built and found."""

    def __init__(self, backend: Union[str, kb.Backend, None] = "cuda",
                 device: Union[str, torch.device, None] = None,
                 compilation_cache_dir: Optional[str] = None,
                 mesh=None):
        self.mesh = mesh
        if mesh is not None:
            if "data" not in mesh.axis_names:
                raise ValueError(f"ModelRegistry: mesh axes {mesh.axis_names}"
                                 f" have no 'data' axis")
            self.devices: Optional[tuple] = tuple(mesh.devices)
            first = self.devices[0].device
            if device is not None and torch.device(device).type != first.type:
                raise ValueError(f"ModelRegistry: device {device} but the "
                                 f"mesh runs on {first}")
            device = first
        else:
            self.devices = None
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ModelRegistry: CUDA requested but "
                    "torch.cuda.is_available() is False; pass device='cpu' "
                    "to run the plain versions")
            if self.device.index is None:
                # the index a tensor placed on "cuda" reports
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.backend = kb.resolve_backend(backend)
        self.compilation_cache_dir = enable_compilation_cache(
            compilation_cache_dir)
        self._models: Dict[str, RegisteredModel] = {}
        # parameter copies on physical devices other than the registry's
        # own: (model key, device) -> tree
        self._placed_params: Dict[Tuple[str, str], list] = {}
        # per-entry compile log: one record per entry first run by THIS
        # registry, with the call's wall ms.  Written under a lock: warmup,
        # the device thread and replanning all run entries.
        self._compile_lock = threading.Lock()
        self._compile_log: List[Dict] = []
        self._called: set = set()      # entries run at least once

    @property
    def n_devices(self) -> int:
        return len(self.devices) if self.devices else 1

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
    def _group(self, devices: Optional[Sequence]) -> Optional[tuple]:
        """The device group ``devices`` names (the whole mesh when None),
        None without a mesh.  Raises unless every device is one of this
        registry's mesh devices."""
        if devices is None:
            return self.devices
        if self.devices is None:
            raise ValueError(f"ModelRegistry: device groups need a registry "
                             f"built with mesh=; this one serves on "
                             f"{self.device}")
        group = tuple(devices)
        pool = {d.id: d for d in self.devices}
        for d in group:
            if pool.get(getattr(d, "id", None)) is not d:
                raise ValueError(f"ModelRegistry: device groups are devices "
                                 f"of the registry's mesh, not {d!r}")
        return group

    @staticmethod
    def _entry(key: str, bucket: int, group: Optional[tuple]) -> tuple:
        if group is None:
            return (key, bucket)
        return (key, bucket, tuple(d.id for d in group))

    def _params_for(self, model: RegisteredModel, device: torch.device):
        """``model``'s params on physical ``device``: the registered tree
        on the registry's own device, else one cached copy per physical
        device."""
        if device == self.device:
            return model.params
        ck = (model.key, str(device))
        with self._compile_lock:
            placed = self._placed_params.get(ck)
        if placed is None:
            placed = tree.tree_map(lambda t: t.to(device), model.params)
            with self._compile_lock:
                placed = self._placed_params.setdefault(ck, placed)
        return placed

    def apply(self, key: str, images,
              devices: Optional[Sequence] = None) -> BatchLogits:
        """images: (bucket, res, res, C) numpy, already bucket-padded.
        Queues the forward and returns its ``BatchLogits`` handle once the
        work is queued, not when it is done.  ``devices``: the device
        group to execute on (defaults to the whole mesh when the registry
        has one, else its one device); the batch stripes over the group
        when the bucket divides it, else runs whole on the group's first
        device."""
        model = self._models[key]
        x_np = np.ascontiguousarray(images, np.float32)
        group = self._group(devices)
        cache_key = self._entry(key, x_np.shape[0], group)
        with self._compile_lock:
            fresh = cache_key not in self._called
            self._called.add(cache_key)
        before = persistent_cache_counters() if fresh else None
        t0 = time.perf_counter()
        out = self._dispatch(model, x_np, group)
        if fresh:
            build_ms = (time.perf_counter() - t0) * 1e3
            delta = counters_delta(before)
            with self._compile_lock:
                self._compile_log.append({
                    "key": key, "bucket": cache_key[1],
                    "devices": list(cache_key[2]) if group else None,
                    "build_ms": build_ms,
                    "pcache_hits": int(delta["hits"]),
                    "pcache_misses": int(delta["misses"])})
        return out

    def _dispatch(self, model: RegisteredModel, x_np: np.ndarray,
                  group: Optional[tuple]) -> BatchLogits:
        rows = x_np.shape[0]
        if group is None:
            stripes = [(None, 0, rows)]
        elif len(group) > 1 and rows % len(group) == 0:
            m = rows // len(group)
            stripes = [(d, j * m, m) for j, d in enumerate(group)]
        else:
            stripes = [(group[0], 0, rows)]
        out = BatchLogits(shape=(rows, model.num_classes),
                          pinned=self.device.type == "cuda")
        for mesh_dev, row0, m in stripes:
            dev = self.device if mesh_dev is None else mesh_dev.device
            with self._on(dev, None):
                # a first copy is queued on the device's current stream,
                # which the stripe's stream waits for below
                params = self._params_for(model, dev)
            with self._on(dev, getattr(mesh_dev, "stream", None)):
                x = torch.from_numpy(x_np[row0:row0 + m])
                staged = None
                if dev.type == "cuda":
                    staged = x.pin_memory()
                    x = staged.to(dev, non_blocking=True)
                with torch.inference_mode():
                    logits = zoo.apply_network(params, model.net, x,
                                               model.variant,
                                               backend=self.backend)
                    out.add(row0, logits, staged)
        return out

    @staticmethod
    @contextlib.contextmanager
    def _on(dev: torch.device, stream):
        """Make ``dev`` and ``stream`` (a mesh device's own stream, None
        for the device's current one) current.  The stream first waits for
        the work already queued on the current stream (parameter copies,
        earlier forwards of the caller)."""
        if dev.type != "cuda":
            yield
            return
        with torch.cuda.device(dev):
            if stream is None:
                yield
                return
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                yield

    def is_compiled(self, key: str, bucket: int,
                    devices: Optional[Sequence] = None) -> bool:
        """True when ``apply(key, <bucket-sized batch>, devices=...)`` has
        run before on this registry — the engine's mid-flight replanner
        only backfills with such entries, so a replan dispatch never pays
        a first run under traffic."""
        entry = self._entry(key, bucket, self._group(devices))
        with self._compile_lock:
            return entry in self._called

    def prewarm(self, key: str, buckets, *, host: bool = True,
                device: bool = True,
                groups: Optional[Sequence[Sequence]] = None) -> None:
        """Warm the serving pipeline's stages off the hot path.

        device: run the network once per (model, bucket) and wait, so the
        device stage never runs an entry for the first time under traffic.
        Under a mesh this warms the full-mesh placement; pass ``groups``
        (tuples of mesh devices) to also warm the round scheduler's device
        groups.  host: exercise the batch-formation path (letterbox +
        stack + bucket pad) per bucket."""
        model = self._models[key]
        res, cin = model.resolution, model.net.in_channels
        if host:
            from repro_torch.serving.vision.batcher import (VisionRequest,
                                                            form_batch)
            img = np.zeros((res // 2 or 1, res + 1, cin), np.float32)
            for b in buckets:
                form_batch([VisionRequest(-1, key, img, 0.0)], b, res)
        if device:
            for devs in [None] + [tuple(g) for g in (groups or [])]:
                for b in buckets:
                    self.warm_entry(key, b, devices=devs, host=False)

    def warm_entry(self, key: str, bucket: int,
                   devices: Optional[Sequence] = None, *,
                   host: bool = True) -> None:
        """Warm exactly ONE (model, bucket[, device group]) entry: run the
        bucket-shaped apply once and wait for its logits.  ``host=True``
        also exercises batch formation for the bucket."""
        model = self._models[key]
        res, cin = model.resolution, model.net.in_channels
        if host:
            from repro_torch.serving.vision.batcher import (VisionRequest,
                                                            form_batch)
            img = np.zeros((res // 2 or 1, res + 1, cin), np.float32)
            form_batch([VisionRequest(-1, key, img, 0.0)], bucket, res)
        self.apply(key, np.zeros((bucket, res, res, cin), np.float32),
                   devices=tuple(devices) if devices else None).materialize()

    def devices_by_id(self, ids: Sequence[int]) -> Optional[tuple]:
        """Map persisted device ids back to this registry's mesh devices
        (manifest entries store ids).  None when any id is not on the
        current mesh."""
        pool = {d.id: d for d in (self.devices or ())}
        try:
            return tuple(pool[i] for i in ids)
        except KeyError:
            return None

    def backend_fingerprint(self) -> str:
        """Stable hash of what a warmed entry depends on: the torch and
        CUDA versions, the device's name, the backend key, the mesh shape
        and the registered model set (key, variant, resolution, depth)."""
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
