"""Request queue + batch formation for the vision serving engine.

Requests arrive with arbitrary image sizes; each model executes at a fixed
resolution and a fixed set of batch "buckets" (powers of two by default).
The batcher (a) letterboxes every image to the model's resolution, (b)
groups requests per model in FIFO order, and (c) pads each formed batch up
to the chosen bucket so the jit cache sees only |models| x |buckets|
distinct shapes — no recompiles under mixed traffic.

Cross-model rounds: under the sharded round scheduler, one bucketed batch
per model with queued work is co-scheduled into a device round —
``RequestQueue.pop_many`` pops every participating model under a single
lock acquisition (an atomic round pop: no submitter can interleave and
reorder FIFO ordering between two models' pops), and ``form_round`` forms
the per-model batches with per-slot error containment.

Units: ``t_submit`` is a wall-clock timestamp from the engine's clock
(``time.perf_counter`` seconds unless a test injects a fake); everything
else here is shapes and counts — no accelerator units enter this module.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Deque, Dict, List, Optional, Tuple, Union

import numpy as np

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8)


def fit_image(img: np.ndarray, resolution: int) -> np.ndarray:
    """Letterbox an (H, W, C) image to (resolution, resolution, C).

    Smaller extents are zero-padded symmetrically; larger extents are
    center-cropped.  Deterministic, preserves dtype, never interpolates
    (serving must not silently change pixel values).
    """
    assert img.ndim == 3, img.shape
    h, w, c = img.shape
    out = img
    # crop first (center), then pad (center)
    if h > resolution:
        top = (h - resolution) // 2
        out = out[top:top + resolution]
    if w > resolution:
        left = (w - resolution) // 2
        out = out[:, left:left + resolution]
    ph = resolution - out.shape[0]
    pw = resolution - out.shape[1]
    if ph or pw:
        out = np.pad(out, ((ph // 2, ph - ph // 2),
                           (pw // 2, pw - pw // 2), (0, 0)))
    return out


@dataclasses.dataclass
class VisionRequest:
    rid: int
    model: str
    image: np.ndarray            # (H, W, C), any H/W
    t_submit: float
    slo_ms: Optional[float] = None
    # tenancy (see tenancy.py): the SLO class orders shedding and weighs
    # planner scores; the tenant tag only feeds per-tenant metrics and
    # fairness — neither changes batch formation or FIFO order
    slo_class: str = "batch"
    tenant: Optional[str] = None


@dataclasses.dataclass
class Batch:
    model: str
    requests: List[VisionRequest]
    images: np.ndarray           # (bucket, res, res, C) — padded
    bucket: int

    @property
    def fill(self) -> int:
        return len(self.requests)


class RequestQueue:
    """Per-model FIFO queues with a global arrival order.

    Thread-safe: the pipelined engine pushes from caller threads while its
    scheduler thread plans and pops, so every accessor holds one lock.
    ``snapshot_oldest`` exists so the scheduler can pick (model, depth) in a
    single atomic read instead of racing ``models_with_work`` + ``pending``.
    """

    def __init__(self):
        self._queues: Dict[str, Deque[VisionRequest]] = {}
        self._lock = threading.Lock()

    def push(self, req: VisionRequest) -> None:
        with self._lock:
            self._queues.setdefault(req.model,
                                    collections.deque()).append(req)

    def pending(self, model: Optional[str] = None) -> int:
        with self._lock:
            if model is not None:
                return len(self._queues.get(model, ()))
            return sum(len(q) for q in self._queues.values())

    def models_with_work(self) -> List[str]:
        """Models ordered by their oldest queued request (FIFO fairness)."""
        with self._lock:
            live = [(q[0].t_submit, m) for m, q in self._queues.items() if q]
        return [m for _, m in sorted(live)]

    def snapshot(self) -> List[Tuple[str, int, float]]:
        """One atomic read of every model with queued work, ordered by the
        age of its oldest waiting request (global FIFO): a list of
        (model, queue depth, oldest request's submit time)."""
        with self._lock:
            live = [(q[0].t_submit, m, len(q))
                    for m, q in self._queues.items() if q]
        return [(m, d, t) for t, m, d in sorted(live)]

    def snapshot_oldest(self) -> Optional[Tuple[str, int, float]]:
        """snapshot()'s head — the model holding the oldest request."""
        snap = self.snapshot()
        return snap[0] if snap else None

    def pop(self, model: str, n: int) -> List[VisionRequest]:
        with self._lock:
            q = self._queues[model]
            return [q.popleft() for _ in range(min(n, len(q)))]

    def pop_many(self, wants: List[Tuple[str, int]]
                 ) -> List[List[VisionRequest]]:
        """Atomically pop ``n`` requests for every (model, n) in ``wants``
        under ONE lock acquisition — the round scheduler's pop: batch
        composition of a whole cross-model round is a single linearization
        point with respect to concurrent submitters."""
        with self._lock:
            out = []
            for model, n in wants:
                q = self._queues.get(model, ())
                out.append([q.popleft() for _ in range(min(n, len(q)))])
            return out

    # -- tenancy ------------------------------------------------------------
    def shed_lowest(self, max_priority: int,
                    priority_of) -> Optional[VisionRequest]:
        """Remove and return the NEWEST queued request of the lowest
        priority class strictly below ``max_priority`` (None when every
        queued request is at or above it).  ``priority_of`` maps a class
        name to its priority (kept a callable so this module stays free of
        tenancy imports).

        Newest-of-lowest is the shed order that hurts least: the lowest
        class gives way first, and within it the request that has waited
        least loses its slot (the oldest is closest to being served —
        shedding it wastes the most queueing investment)."""
        with self._lock:
            victim: Optional[Tuple[int, float, str, int]] = None
            for model, q in self._queues.items():
                for i, req in enumerate(q):
                    pr = priority_of(req.slo_class)
                    if pr >= max_priority:
                        continue
                    cand = (pr, -req.t_submit, model, i)
                    if victim is None or cand < victim:
                        victim = cand
            if victim is None:
                return None
            _, _, model, i = victim
            q = self._queues[model]
            req = q[i]
            del q[i]
            return req

    def class_weights(self, weight_of) -> Dict[str, float]:
        """Per-model mean SLO-class weight of the queued requests — the
        round planner's exchange rate for ms-per-served-request scoring
        (``weight_of`` maps a class name to its weight).  Models with no
        queued work are absent."""
        with self._lock:
            out: Dict[str, float] = {}
            for model, q in self._queues.items():
                if q:
                    out[model] = sum(weight_of(r.slo_class)
                                     for r in q) / len(q)
            return out


def form_batch(requests: List[VisionRequest], bucket: int,
               resolution: int) -> Batch:
    """Stack fitted images and zero-pad the batch axis up to ``bucket``."""
    assert 1 <= len(requests) <= bucket, (len(requests), bucket)
    fitted = [fit_image(np.asarray(r.image, np.float32), resolution)
              for r in requests]
    images = np.stack(fitted)
    pad = bucket - images.shape[0]
    if pad:
        images = np.concatenate(
            [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
    return Batch(requests[0].model, list(requests), images, bucket)


def form_round(pops: List[Tuple[List[VisionRequest], int, int]]
               ) -> List[Union[Batch, BaseException, None]]:
    """Form one cross-model round from atomic ``pop_many`` output — a list
    of (requests, bucket, resolution) triples, one per model — the
    fleet-level analogue of ST-OS mapping independent convolutions onto
    independent systolic-array rows.

    Per-slot results, aligned with ``pops`` so the caller can map parts
    back to their plans: the formed ``Batch``, ``None`` for an empty pop,
    or the exception a malformed part raised (one bad image must not sink
    the other models' batches; the containment policy is the caller's)."""
    out: List[Union[Batch, BaseException, None]] = []
    for reqs, bucket, res in pops:
        if not reqs:
            out.append(None)
            continue
        try:
            out.append(form_batch(reqs, bucket, res))
        except Exception as exc:
            out.append(exc)
    return out
