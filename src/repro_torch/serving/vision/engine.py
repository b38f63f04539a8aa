"""VisionServeEngine: batched FuSeConv inference with cost-model scheduling.

Port of ``repro.serving.vision.engine``, synchronous path only.  Units:
every latency in this module is **wall milliseconds** measured on ``clock``
(``time.perf_counter`` unless a test injects a fake); the cost model's
``predicted_ms`` may be raw **accelerator-ms** before calibration
converges — ``VisionResult.calibrated`` flags which unit a prediction was
quoted in.

Request lifecycle:

  submit(model, image[, slo_ms])
      -> admission check (the cost model predicts e2e latency behind the
         queued work; SLO'd requests that cannot make it are rejected
         immediately instead of clogging the queue).
      -> FIFO queue, per model; returns a request id.  ``future(rid)``
         hands back a ``VisionFuture`` that resolves when the request
         completes.

  step()
      -> on the caller's thread: the model with the oldest waiting request,
         the cost model's best batch bucket for its queue depth, the padded
         batch, one ``registry.apply``, and a copy of the logits to the host
         (the point where the device work is known to be done).

  flush()
      -> steps until the queue is empty, then hands back (and clears)
         finished results in request order.

The pipelined executor, cross-model rounds, mid-flight replanning, load
shedding, meshes and multi-process serving are not ported yet: the
constructor refuses them.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.serving.vision.batcher import (DEFAULT_BUCKETS, Batch,
                                                RequestQueue, VisionRequest,
                                                form_batch)
from repro_torch.serving.vision.calibrate import LatencyCalibrator
from repro_torch.serving.vision.costmodel import BucketPlan, SystolicCostModel
from repro_torch.serving.vision.metrics import ServeMetrics
from repro_torch.serving.vision.registry import ModelRegistry
from repro_torch.serving.vision.tenancy import slo_class as resolve_slo_class


@dataclasses.dataclass
class VisionResult:
    rid: int
    model: str
    status: str          # "ok" | "rejected" | "cancelled" | "error"
    logits: Optional[np.ndarray]      # (num_classes,) for "ok"
    predicted_ms: float               # cost-model estimate at decision time
    queue_ms: float = 0.0
    run_ms: float = 0.0               # measured batch compute (whole batch)
    e2e_ms: float = 0.0
    bucket: int = 0
    batch_fill: int = 0
    calibrated: bool = False          # predicted_ms was calibrated wall-ms
    n_devices: int = 1                # devices the batch ran on
    error: Optional[str] = None       # exception text for status "error"
    slo_class: str = "batch"          # tenancy (see tenancy.py)
    tenant: Optional[str] = None


class VisionFuture:
    """Completion handle for one submitted request.

    Resolves exactly once with a ``VisionResult`` (status "ok", "rejected",
    "cancelled", or "error").  ``result()`` blocks; pass a timeout to poll.
    """

    def __init__(self, rid: int):
        self.rid = rid
        self._event = threading.Event()
        self._result: Optional[VisionResult] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> VisionResult:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} still pending")
        assert self._result is not None
        return self._result

    def _resolve(self, result: VisionResult) -> None:
        self._result = result
        self._event.set()


class VisionServeEngine:
    def __init__(self, registry: ModelRegistry, *,
                 cost_model: Optional[SystolicCostModel] = None,
                 metrics: Optional[ServeMetrics] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 clock=time.perf_counter,
                 pipelined: bool = False,
                 cross_model: Optional[bool] = None,
                 replan: bool = False,
                 shed: bool = False,
                 multiprocess=None):
        refused = [name for name, on in (
            ("pipelined", pipelined), ("cross_model", cross_model),
            ("replan", replan), ("shed", shed),
            ("multiprocess", multiprocess is not None),
            ("a registry mesh", getattr(registry, "mesh", None) is not None))
            if on]
        if refused:
            raise ValueError(f"VisionServeEngine: {', '.join(refused)} not "
                             f"ported yet; the port serves synchronously "
                             f"on one device")
        self.registry = registry
        self.cost_model = cost_model or SystolicCostModel(
            calibrator=LatencyCalibrator(), n_devices=1)
        self.buckets = tuple(sorted(buckets))
        self.metrics = metrics or ServeMetrics(clock)
        self._clock = clock
        self._queue = RequestQueue()
        self._results: Dict[int, VisionResult] = {}
        self._futures: Dict[int, VisionFuture] = {}
        self._next_rid = 0
        self._closed = False

    # -- intake -------------------------------------------------------------
    def submit(self, model_key: str, image: np.ndarray,
               slo_ms: Optional[float] = None, *,
               slo_class: Optional[str] = None,
               tenant: Optional[str] = None) -> int:
        """Enqueue one image; returns its request id (see ``future``).

        With an SLO, the request is subject to admission control: if the
        cost model predicts the queued work ahead of it plus its own batch
        already blows the budget, it is rejected now (result status
        "rejected").  ``slo_class`` names the request's service class (see
        ``tenancy.py``; default "batch", unknown names raise); ``tenant``
        tags the request for per-tenant metrics only."""
        if self._closed:
            raise RuntimeError("engine is closed")
        model = self.registry.get(model_key)
        cls = resolve_slo_class(slo_class)          # raises on unknown names
        rid = self._next_rid
        self._next_rid += 1
        self.metrics.on_submit()
        fut = VisionFuture(rid)
        self._futures[rid] = fut
        if slo_ms is not None:
            admitted, predicted = self._admit(model, model_key, slo_ms)
            if not admitted:
                self.metrics.on_reject()
                res = VisionResult(rid, model_key, "rejected", None,
                                   predicted, slo_class=cls.name,
                                   tenant=tenant)
                self._results[rid] = res
                fut._resolve(res)
                return rid
        self._queue.push(VisionRequest(rid, model_key, np.asarray(image),
                                       self._clock(), slo_ms,
                                       slo_class=cls.name, tenant=tenant))
        return rid

    def _admit(self, model, model_key: str,
               slo_ms: float) -> Tuple[bool, float]:
        """One admission check against the current queue: this model's own
        drain plus every other model's queued drain, which FIFO serves
        first."""
        return self.cost_model.admit(
            model, slo_ms, self._queue.pending(model_key), self.buckets,
            self._backlog_ms(model_key))

    def _backlog_ms(self, model_key: str) -> float:
        """Predicted work served before a new ``model_key`` request: every
        other model's queued drain, priced at the cost model's admission
        quantile when it has one."""
        q = getattr(self.cost_model, "admission_quantile", None)
        kw = {} if q is None else {"quantile": q}
        return sum(
            self.cost_model.drain_ms(self.registry.get(m), depth,
                                     self.buckets, **kw)
            for m, depth, _ in self._queue.snapshot() if m != model_key)

    def future(self, rid: int) -> VisionFuture:
        """The completion future for a submitted request id."""
        return self._futures[rid]

    # -- execution ------------------------------------------------------------
    def _fail(self, reqs: List[VisionRequest], plan: BucketPlan,
              exc: BaseException) -> None:
        """Resolve ``reqs`` with status "error"."""
        for r in reqs:
            res = VisionResult(r.rid, r.model, "error", None,
                               plan.predicted_ms, bucket=plan.bucket,
                               batch_fill=len(reqs), error=repr(exc),
                               slo_class=r.slo_class, tenant=r.tenant)
            self._results[r.rid] = res
            self.metrics.on_error()
            self._futures[r.rid]._resolve(res)

    def _finalize(self, batch: Batch, plan: BucketPlan,
                  logits_np: np.ndarray, t0: float,
                  t1: float) -> List[VisionResult]:
        model_key = batch.model
        run_ms = (t1 - t0) * 1e3
        resid = self.cost_model.observe(self.registry.get(model_key),
                                        plan.bucket, run_ms)
        self.metrics.on_batch(model_key, batch.fill, plan.bucket, run_ms,
                              plan.predicted_ms, calibrated=plan.calibrated,
                              resid_ms=resid)
        out: List[VisionResult] = []
        for i, r in enumerate(batch.requests):
            res = VisionResult(
                rid=r.rid, model=model_key, status="ok",
                logits=logits_np[i], predicted_ms=plan.predicted_ms,
                queue_ms=(t0 - r.t_submit) * 1e3, run_ms=run_ms,
                e2e_ms=(t1 - r.t_submit) * 1e3, bucket=plan.bucket,
                batch_fill=batch.fill, calibrated=plan.calibrated,
                slo_class=r.slo_class, tenant=r.tenant)
            self._results[r.rid] = res
            self.metrics.on_complete(model_key, res.e2e_ms, run_ms,
                                     slo_class=res.slo_class,
                                     tenant=res.tenant)
            self._futures[r.rid]._resolve(res)
            out.append(res)
        return out

    def step(self) -> List[VisionResult]:
        """Synchronously run ONE batch on the caller's thread; [] if
        nothing is queued."""
        snap = self._queue.snapshot_oldest()
        if snap is None:
            return []
        model_key, depth, _ = snap
        model = self.registry.get(model_key)
        t_h0 = self._clock()
        plan = self.cost_model.plan_bucket(model, depth, self.buckets)
        reqs = self._queue.pop(model_key, plan.served)
        batch = form_batch(reqs, plan.bucket, model.resolution)
        self.metrics.on_stage("host", self._clock() - t_h0)
        t0 = self._clock()
        try:
            # the copy to the host waits for the device work to finish
            logits = self.registry.apply(model_key, batch.images)
            logits_np = logits.float().cpu().numpy()
        except Exception as exc:
            # a poisoned batch resolves its requests with status "error"
            # instead of leaking the exception to the caller
            self._fail(reqs, plan, exc)
            return []
        t1 = self._clock()
        self.metrics.on_stage("device", t1 - t0)
        return self._finalize(batch, plan, logits_np, t0, t1)

    def flush(self) -> List[VisionResult]:
        """Drain the queue on this thread, then hand back (and clear)
        finished results in request order."""
        while self._queue.pending():
            self.step()
        done = [self._results[rid] for rid in sorted(self._results)]
        self._results.clear()
        for r in done:
            self._futures.pop(r.rid, None)
        return done

    def generate(self, items: Sequence[Union[Tuple[str, np.ndarray],
                                             Tuple[str, np.ndarray, float]]]
                 ) -> List[VisionResult]:
        """Submit (model_key, image[, slo_ms]) items, flush, return results
        in submission order."""
        for item in items:
            self.submit(*item)
        return self.flush()

    def poll(self, rid: int,
             timeout_ms: float = 0.0) -> Optional[VisionResult]:
        """The result for one request id, or None while it is pending.

        Non-destructive: the result stays owned by the engine until
        ``flush()`` collects it.  The sync engine has no workers, so poll
        IS the executor: it steps queued batches on the caller's thread
        until the request resolves (``timeout_ms`` is accepted for
        interface compatibility).  Raises ``KeyError`` for an id this
        engine never issued or whose result was already flushed."""
        fut = self._futures.get(rid)
        if fut is None:
            raise KeyError(f"unknown or already-flushed request id {rid}")
        while not fut.done() and self._queue.pending():
            self.step()
        return fut.result(0) if fut.done() else None

    def snapshot(self) -> Dict:
        """The metrics snapshot (one self-describing dict)."""
        return self.metrics.snapshot()

    # -- shutdown -------------------------------------------------------------
    def close(self, *, drain: bool = True) -> None:
        """``drain=True`` (default) serves everything queued first;
        ``drain=False`` cancels it (futures resolve with status
        "cancelled").  Idempotent; ``submit`` raises afterwards."""
        if self._closed:
            return
        if drain:
            while self._queue.pending():
                self.step()
        self._closed = True
        for snap in iter(self._queue.snapshot_oldest, None):
            model_key, depth, _ = snap
            for r in self._queue.pop(model_key, depth):
                res = VisionResult(r.rid, model_key, "cancelled", None, 0.0,
                                   slo_class=r.slo_class, tenant=r.tenant)
                self._results[r.rid] = res
                self._futures[r.rid]._resolve(res)

    def __enter__(self) -> "VisionServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
