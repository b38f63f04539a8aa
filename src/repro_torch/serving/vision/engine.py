"""VisionServeEngine: batched FuSeConv inference with cost-model scheduling
and an async pipelined executor; under a device mesh, a cross-model round
scheduler stripes batches over device groups.

Port of ``repro.serving.vision.engine``.  Units: every
latency in this module is **wall milliseconds** measured on ``clock``
(``time.perf_counter`` unless a test injects a fake); the cost model's
``predicted_ms`` may be raw **accelerator-ms** before calibration
converges — ``VisionResult.calibrated`` flags which unit a prediction was
quoted in.

Request lifecycle:

  submit(model, image[, slo_ms])
      -> admission check (the cost model predicts e2e latency behind the
         queued plus in-flight work; SLO'd requests that cannot make it
         are rejected immediately instead of clogging the queue).
      -> FIFO queue, per model; returns a request id.  ``future(rid)``
         hands back a ``VisionFuture`` that resolves when the request
         completes.

  pipelined executor (default) — three stages connected by bounded queues:

      scheduler thread   picks the model with the oldest waiting request,
                         asks the cost model for the best batch bucket,
                         pops requests and forms the padded batch
                         (letterboxing is the host-side cost) ........ N+1
      device thread      ``registry.apply``: pinned upload, forward and
                         the logits' copy back queued on the card, a
                         CUDA event recorded behind them ............. N
      completer thread   waits on that event, resolves futures, feeds
                         measured wall latency back into the
                         calibrator .................................. N-1

      The submit/complete queues are bounded by ``max_in_flight``, so host
      batching of batch N+1 overlaps device execution of batch N without
      ever racing unboundedly ahead of the device.

  cross-model rounds (``cross_model=True``, the default whenever the
  registry carries a mesh) — the ST-OS row mapping lifted to the mesh:
  as the paper maps *independent* 1-D convolutions onto rows of the
  systolic array, the scheduler maps independent models' batches onto
  device groups of the mesh.  Each cycle it snapshots every model with
  queued work, asks the cost model for a ``RoundPlan`` (one bucket per
  model; the adaptive planner scores even/uneven/serial group
  compositions in calibrated wall-ms, round latency = slowest group),
  pops all models atomically and ships the round as ONE pipeline unit
  (one ``max_in_flight`` slot): the device thread dispatches every part
  back to back (each group's stripes on its devices' own streams, so
  parts on different groups overlap on the card), the completer waits on
  each part in turn and fans results back to per-request futures.  Each
  part's measured latency is charged from the round's service start to
  that part's readiness.  Without a mesh every round has one group.

  multi-process serving (``multiprocess=``, see ``multiproc.py``) — the
  engine runs on process 0 and schedules over the logical universe of
  every process's devices; the device thread broadcasts each round's
  spec through the coordination store before dispatching its own
  stripes, and the completer gathers and stitches the workers' shards.

  reactive mid-flight replanning (``replan=True``, rounds only) — right
  after dispatching a round the device thread polls each group's outputs
  through a non-blocking ``ReadinessProbe`` (the outputs' CUDA events;
  tests inject fake probes) and backfills a group OBSERVED complete, with
  at least one planning quantum left before the round's predicted end,
  with the next FIFO-eligible queued batch whose entry is already warm
  and whose predicted latency fits the window (``_replan_round``).
  Backfilled parts ride the round's slot; their latency observations are
  flagged ``partial`` so calibration fits never learn their queueing.

  tenancy (``shed=True`` + per-request ``slo_class``/``tenant``) — see
  ``tenancy.py``: SLO classes order load shedding at admission time
  (lowest priority, newest first, status "shed") and weigh the round
  planner's ms-per-served-request scores.

  flush()
      -> waits for the pipeline to drain (or, with ``pipelined=False``,
         drains synchronously on the caller's thread), then hands back
         (and clears) finished results in request order.

In sync mode batch composition is deterministic given the submission
order; in pipelined mode the scheduler consumes concurrently with
submission, so composition depends on the arrival/execution interleaving
(``batch_window_ms`` trades latency for fuller buckets).  Per-request
results are the same in either case — composition only moves batch
boundaries.

"""
from __future__ import annotations

import dataclasses
import inspect
import json
import os
import queue
import threading
import time
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Set, Tuple, Union)

import numpy as np

from repro_torch.serving.vision.batcher import (DEFAULT_BUCKETS, Batch,
                                                RequestQueue, VisionRequest,
                                                form_batch, form_round)
from repro_torch.serving.vision.calibrate import LatencyCalibrator
from repro_torch.serving.vision.compilecache import (
    counters_delta, persistent_cache_counters)
from repro_torch.serving.vision.costmodel import (BucketPlan,
                                                  SystolicCostModel)
from repro_torch.serving.vision.metrics import ServeMetrics
from repro_torch.serving.vision.registry import (ModelRegistry,
                                                 device_groups,
                                                 device_groups_sized)
from repro_torch.serving.vision.tenancy import class_priority, class_weight
from repro_torch.serving.vision.tenancy import slo_class as resolve_slo_class


class ReadinessProbe:
    """Non-blocking completion check for dispatched device outputs.

    ``poll(out)`` answers "is this output ready?" without blocking:
    ``out.is_ready()`` when the output exposes it (the registry's
    ``BatchLogits`` queries its CUDA event), True otherwise (host arrays
    from duck-typed stub registries are ready by construction, and a
    ``_BatchError`` already failed).  ``wait(ms)`` is the inter-poll
    pause.  Both are overridable: tests inject scripted or
    fake-clock-keyed probes and drive the device thread's reactive loop
    deterministically without touching a device."""

    def poll(self, out) -> bool:
        probe = getattr(out, "is_ready", None)
        if probe is None:
            return True
        try:
            return bool(probe())
        except Exception:
            return True

    def wait(self, interval_ms: float) -> None:
        if interval_ms > 0.0:
            time.sleep(interval_ms / 1e3)


def _host_logits(out) -> np.ndarray:
    """The numpy logits of a dispatched output: ``materialize()`` waits
    for a device result and copies it out; a host array is used as is."""
    mat = getattr(out, "materialize", None)
    return np.asarray(mat() if mat is not None else out)


@dataclasses.dataclass
class VisionResult:
    rid: int
    model: str
    status: str          # "ok" | "rejected" | "cancelled" | "error" | "shed"
    logits: Optional[np.ndarray]      # (num_classes,) for "ok"
    predicted_ms: float               # cost-model estimate at decision time
    queue_ms: float = 0.0
    run_ms: float = 0.0               # measured batch compute (whole batch)
    e2e_ms: float = 0.0
    bucket: int = 0
    batch_fill: int = 0
    calibrated: bool = False          # predicted_ms was calibrated wall-ms
    n_devices: int = 1                # devices the batch was striped over
    error: Optional[str] = None       # exception text for status "error"
    slo_class: str = "batch"          # tenancy (see tenancy.py)
    tenant: Optional[str] = None


class VisionFuture:
    """Completion handle for one submitted request.

    Resolves exactly once with a ``VisionResult`` (status "ok", "rejected",
    "cancelled", "shed" or "error").  ``result()`` blocks; pass a timeout
    to poll.
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


@dataclasses.dataclass
class _Prepared:
    """A formed batch travelling through the submit/complete queues."""
    batch: Batch
    plan: BucketPlan
    devices: Optional[tuple] = None   # device group (round scheduler only)
    replanned: bool = False           # mid-flight backfill, not a round part
    group: Optional[int] = None       # round group index (readiness probing)


@dataclasses.dataclass
class _Round:
    """A co-scheduled cross-model round travelling as ONE pipeline unit
    (one ``max_in_flight`` slot, one in-flight increment).  ``groups`` and
    ``group_ms`` (device groups — None without a mesh — and predicted
    per-group serial sums, in group order) feed the mid-flight replanner:
    the gap between a group's predicted end and the round's predicted end
    is backfillable idle."""
    parts: List[_Prepared]
    predicted_ms: float               # slowest group's serial sum
    n_groups: int
    groups: Optional[List[Optional[tuple]]] = None
    group_ms: Optional[List[float]] = None


@dataclasses.dataclass
class _BatchError:
    """Device-stage failure travelling the complete queue in logits' place."""
    exc: BaseException


@dataclasses.dataclass
class _DeviceCall:
    """Work the device thread runs itself (``warmup``): PyTorch keeps its
    cuDNN and cuBLAS handles per thread, so the device stage is warm only
    once its own thread has run every entry."""
    fn: Callable[[], None]
    done: threading.Event
    exc: Optional[BaseException] = None


_STOP = object()


class VisionServeEngine:
    def __init__(self, registry: ModelRegistry, *,
                 cost_model: Optional[SystolicCostModel] = None,
                 metrics: Optional[ServeMetrics] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 clock=time.perf_counter,
                 pipelined: bool = True,
                 max_in_flight: int = 2,
                 batch_window_ms: float = 0.0,
                 cross_model: Optional[bool] = None,
                 replan: bool = False,
                 replan_quantum_ms: Optional[float] = None,
                 probe: Optional[ReadinessProbe] = None,
                 probe_interval_ms: float = 0.2,
                 shed: bool = False,
                 multiprocess=None):
        self.registry = registry
        # mesh comes in through the registry (it owns placement); the
        # engine owns scheduling over its device list
        self._devices = getattr(registry, "devices", None)
        # multi-process serving (see multiproc.py): the engine runs on
        # process 0 only and schedules over the LOGICAL universe spanning
        # every process — groups are broadcast per round, each process
        # executes its addressable stripe, shards are stitched by the
        # completer.  The registry keeps the process-local mesh.
        self.multiprocess = multiprocess
        if multiprocess is not None:
            if not pipelined:
                raise ValueError(
                    "multiprocess serving requires the pipelined engine "
                    "(rounds are broadcast from the device thread)")
            self._devices = multiprocess.universe
            cross_model = True
            # mid-flight replanning keys off per-group readiness; a
            # cross-process part's readiness lives on other processes, so
            # replanning is disabled rather than half-observed
            replan = False
        ndev = len(self._devices) if self._devices else 1
        self.cost_model = cost_model or SystolicCostModel(
            calibrator=LatencyCalibrator(), n_devices=ndev)
        # cross-model rounds default on whenever a mesh is present; they
        # also work without one (rounds of size |models| on one device)
        self.cross_model = (self._devices is not None
                            if cross_model is None else bool(cross_model))
        cm_ndev = getattr(self.cost_model, "n_devices", None)
        if self._devices is not None and cm_ndev is not None \
                and cm_ndev != ndev:
            # a planner sized for a different mesh would hand the round
            # scheduler group counts that don't partition the device list
            raise ValueError(
                f"cost model plans for {cm_ndev} device(s) but the "
                f"registry mesh has {ndev}; construct the cost model with "
                f"n_devices={ndev}")
        if multiprocess is not None:
            gran = getattr(self.cost_model, "group_granularity", 1)
            n_procs = multiprocess.mesh.num_processes
            if gran != n_procs:
                # a group that does not span every process with equal
                # stripes cannot be executed by the stripe protocol
                raise ValueError(
                    f"multiprocess serving over {n_procs} processes needs "
                    f"a cost model with group_granularity={n_procs}, got "
                    f"{gran}")
        self.buckets = tuple(sorted(buckets))
        self.metrics = metrics or ServeMetrics(clock)
        self._clock = clock
        self.pipelined = pipelined
        self.max_in_flight = max(1, int(max_in_flight))
        # dynamic-batching coalescing window: a sub-maximal batch is held
        # back until its oldest request has waited this long, trading a
        # bounded latency hit for fuller buckets under bursty traffic.
        # 0 (default) forms batches as soon as the pipeline has a free slot.
        self.batch_window_ms = max(0.0, float(batch_window_ms))
        # mid-flight replanning (rounds only; see _replan_round).  Quantum
        # default: the round's smallest scheduled batch
        self.replan = bool(replan) and self.cross_model
        self.replan_quantum_ms = replan_quantum_ms
        self._probe = probe if probe is not None else ReadinessProbe()
        self.probe_interval_ms = max(0.0, float(probe_interval_ms))
        # tenancy: shed lowest-priority queued work when an SLO'd request
        # of a higher class would otherwise be rejected at admission
        self._shed = bool(shed)
        self._plan_weights_ok: Optional[bool] = None
        self._queue = RequestQueue()
        self._results: Dict[int, VisionResult] = {}
        self._futures: Dict[int, VisionFuture] = {}
        self._next_rid = 0
        # one lock for rid/results/futures/in-flight; two wait-sides of it
        self._lock = threading.Lock()
        self._work_cv = threading.Condition(self._lock)    # scheduler wakeup
        self._done_cv = threading.Condition(self._lock)    # flush wakeup
        self._inflight_batches = 0
        self._inflight_pred_ms = 0.0
        # hard bound on outstanding batches anywhere in the pipeline
        # (formed, queued for the device, executing, or completing)
        self._depth_sem = threading.Semaphore(self.max_in_flight)
        self._submit_q: "queue.Queue" = queue.Queue(maxsize=self.max_in_flight)
        self._complete_q: "queue.Queue" = queue.Queue(
            maxsize=self.max_in_flight)
        self._threads: List[threading.Thread] = []
        self._started = False
        self._closing = False
        self._closed = False
        self._drain_on_close = True
        self._flush_waiters = 0        # flush() intent: stop coalescing

    # -- intake -------------------------------------------------------------
    def submit(self, model_key: str, image: np.ndarray,
               slo_ms: Optional[float] = None, *,
               slo_class: Optional[str] = None,
               tenant: Optional[str] = None) -> int:
        """Enqueue one image; returns its request id (see ``future``).

        With an SLO, the request is subject to admission control: if the
        cost model predicts the queued + in-flight work ahead of it plus its
        own batch already blows the budget, it is rejected now (result
        status "rejected").

        ``slo_class`` names the request's service class (see
        ``tenancy.py``; default "batch", unknown names raise).  With the
        engine's ``shed=True``, an SLO'd request that would be rejected
        first sheds queued work of strictly lower priority — newest first
        within the lowest class — re-checking admission after each
        eviction; shed requests resolve with status "shed".  ``tenant``
        tags the request for per-tenant metrics and the fairness index
        only — it never affects scheduling."""
        if self._closing or self._closed:
            raise RuntimeError("engine is closed")
        model = self.registry.get(model_key)
        cls = resolve_slo_class(slo_class)          # raises on unknown names
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
        self.metrics.on_submit()
        if slo_ms is not None:
            admitted, predicted = self._admit(model, model_key, slo_ms)
            if not admitted and self._shed:
                # evict strictly-lower-priority queued work until this
                # request fits (or nothing lower remains); every eviction
                # changes the backlog, so admission is re-priced each time
                while not admitted:
                    victim = self._queue.shed_lowest(cls.priority,
                                                     class_priority)
                    if victim is None:
                        break
                    self._resolve_shed(victim)
                    admitted, predicted = self._admit(model, model_key,
                                                      slo_ms)
            if not admitted:
                self.metrics.on_reject()
                res = VisionResult(rid, model_key, "rejected", None,
                                   predicted, slo_class=cls.name,
                                   tenant=tenant)
                fut = VisionFuture(rid)
                fut._resolve(res)
                with self._lock:
                    self._results[rid] = res
                    self._futures[rid] = fut
                return rid
        if self.pipelined:
            self._ensure_started()
        with self._work_cv:
            # re-check under the lock close() takes to flip _closing: a
            # request pushed here is either seen by the draining scheduler
            # or swept by close()'s cancel pass — never stranded
            if self._closing or self._closed:
                raise RuntimeError("engine is closed")
            self._futures[rid] = VisionFuture(rid)
            self._queue.push(VisionRequest(rid, model_key,
                                           np.asarray(image),
                                           self._clock(), slo_ms,
                                           slo_class=cls.name,
                                           tenant=tenant))
            self._work_cv.notify_all()
        return rid

    def _admit(self, model, model_key: str,
               slo_ms: float) -> Tuple[bool, float]:
        """One admission check against the CURRENT queue + in-flight state
        (re-run after each shed eviction)."""
        extra = {}
        if self.cross_model and self._devices \
                and hasattr(self.cost_model, "plan_round"):
            # price this model's own drain on the device group the
            # round planner would assign it right now — the full mesh
            # would under-predict (and over-admit) whenever rounds
            # split the mesh across active models
            from repro_torch.serving.vision.costmodel import round_groups
            active = {m for m, _, _ in self._queue.snapshot()}
            active.add(model_key)
            ndev = len(self._devices)
            gran = getattr(self.cost_model, "group_granularity", 1)
            extra["group_size"] = ndev // round_groups(len(active), ndev,
                                                       gran)
        return self.cost_model.admit(
            model, slo_ms, self._queue.pending(model_key), self.buckets,
            self._backlog_ms(model_key), **extra)

    def _resolve_shed(self, req: VisionRequest) -> None:
        """Resolve an evicted queued request with status "shed"."""
        res = VisionResult(req.rid, req.model, "shed", None, 0.0,
                           slo_class=req.slo_class, tenant=req.tenant)
        self.metrics.on_shed(req.slo_class)
        with self._lock:
            self._results[req.rid] = res
            fut = self._futures.get(req.rid)
        if fut is not None:
            fut._resolve(res)

    def future(self, rid: int) -> VisionFuture:
        """The completion future for a submitted request id."""
        with self._lock:
            return self._futures[rid]

    def _backlog_ms(self, model_key: str) -> float:
        """Predicted work the scheduler serves before a new ``model_key``
        request: every other model's queued drain plus all batches already
        in flight through the pipeline.  Under the round scheduler the
        other models' drain is priced as the rounds it would actually
        form, not a serial per-model sum.  The drain is priced at the cost
        model's admission quantile when it has one; in-flight work stays at
        its scheduling-time (mean) estimate."""
        snap = self._queue.snapshot()
        q = getattr(self.cost_model, "admission_quantile", None)
        kw = {} if q is None else {"quantile": q}
        if self.cross_model and hasattr(self.cost_model, "drain_rounds_ms"):
            other = self.cost_model.drain_rounds_ms(
                [(self.registry.get(m), depth) for m, depth, _ in snap
                 if m != model_key], self.buckets, **kw)
        else:
            other = sum(
                self.cost_model.drain_ms(self.registry.get(m), depth,
                                         self.buckets, **kw)
                for m, depth, _ in snap if m != model_key)
        with self._lock:
            return other + self._inflight_pred_ms

    # -- pipelined executor --------------------------------------------------
    def _ensure_started(self) -> None:
        with self._lock:
            if self._started:
                return
            self._started = True
            for name, target in (("scheduler", self._scheduler_loop),
                                 ("device", self._device_loop),
                                 ("completer", self._completer_loop)):
                t = threading.Thread(target=target, daemon=True,
                                     name=f"vision-serve-{name}")
                self._threads.append(t)
                t.start()

    def _pick_model(self) -> Optional[Tuple[str, int]]:
        """(model, depth) of the next batch to form, or None to keep
        coalescing.  Scans every model with work in global FIFO order so a
        model whose bucket is full (or whose window expired) dispatches even
        while an older-but-sub-maximal model is still inside its window —
        the window must not head-of-line block other models' ready work."""
        entries = self._queue.snapshot()
        if not entries:
            return None
        if (self.batch_window_ms <= 0.0 or self._closing
                or self._flush_waiters):
            m, d, _ = entries[0]
            return m, d
        max_bucket = max(self.buckets)
        now = self._clock()
        for m, d, t_oldest in entries:
            if d >= max_bucket:
                return m, d
            if now - t_oldest >= self.batch_window_ms / 1e3:
                return m, d
        return None                     # everyone is still coalescing

    def _scheduler_loop(self) -> None:
        try:
            while True:
                if self._queue.pending() == 0:
                    with self._work_cv:
                        # submit() pushes and close() flips _closing under
                        # this same lock, so re-checking pending here is
                        # race-free: a request that won the submit/close
                        # race is drained, not cancelled
                        if self._queue.pending() == 0:
                            if self._closing:
                                break
                            self._work_cv.wait(timeout=0.05)
                    continue
                if self._closing and not self._drain_on_close:
                    break
                pick = self._pick_model()
                if pick is None:        # sub-maximal batches inside window
                    with self._work_cv:
                        self._work_cv.wait(
                            timeout=min(self.batch_window_ms / 1e3, 0.05))
                    continue
                model_key, depth = pick
                # reserve an in-flight slot before touching the queue; gives
                # up only on a no-drain close so shutdown can't wedge here
                acquired = self._depth_sem.acquire(timeout=0.05)
                while not acquired:
                    if self._closing and not self._drain_on_close:
                        break
                    acquired = self._depth_sem.acquire(timeout=0.05)
                if not acquired:
                    break
                if self._closing and not self._drain_on_close:
                    self._depth_sem.release()
                    break
                if self.cross_model:
                    # round scheduler: one batch per model with queued work;
                    # holds the slot just acquired (released via
                    # _round_done / _fail)
                    item = self._form_round()
                    if item is not None:
                        self._submit_q.put(item)       # backpressure
                    continue
                model = self.registry.get(model_key)
                t_h0 = self._clock()
                try:
                    plan = self.cost_model.plan_bucket(model, depth,
                                                       self.buckets)
                except Exception as exc:
                    # cost-model failure: fail this model's queued requests
                    # rather than retrying the same exception forever.  Same
                    # invariant as the happy path: count the batch in flight
                    # BEFORE popping so a concurrent flush() can't observe
                    # an empty queue with nothing in flight mid-failure.
                    with self._lock:
                        self._inflight_batches += 1
                    self.metrics.on_inflight(+1)
                    self._fail(self._queue.pop(model_key, depth), None, exc,
                               in_flight=True)
                    continue
                with self._lock:
                    # counted BEFORE the pop so flush never observes an
                    # empty queue while a batch is being formed
                    self._inflight_batches += 1
                    self._inflight_pred_ms += plan.predicted_ms
                self.metrics.on_inflight(+1)
                reqs = self._queue.pop(model_key, plan.served)
                try:
                    batch = form_batch(reqs, plan.bucket, model.resolution)
                    self.metrics.on_stage("host", self._clock() - t_h0)
                except Exception as exc:
                    self._fail(reqs, plan, exc, in_flight=True)
                    continue
                self._submit_q.put(_Prepared(batch, plan))  # backpressure
        finally:
            self._submit_q.put(_STOP)

    def _form_round(self) -> Optional["_Round"]:
        """Plan, pop, and form one cross-model round.  The caller has
        already acquired ONE depth slot for the whole round; every exit
        path either hands it to the returned round (released by the
        completer via ``_round_done``) or releases it here."""
        entries = self._queue.snapshot()
        if not entries:
            self._depth_sem.release()
            return None
        models = [(self.registry.get(m), d) for m, d, _ in entries]
        t_h0 = self._clock()
        try:
            plan_kw = {}
            weights = self._queue.class_weights(class_weight)
            if any(w != 1.0 for w in weights.values()) \
                    and self._planner_takes_weights():
                # mixed service classes queued: let the planner weigh
                # ms-per-served-request by class priority (tenancy.py)
                plan_kw["weights"] = weights
            rplan = self.cost_model.plan_round(models, self.buckets,
                                               **plan_kw)
            # resolved before any request is popped: a plan whose group
            # count can't partition the device list must fail HERE, where
            # containment below still owns every queued request
            sizes = getattr(rplan, "group_sizes", None)
            if self._devices is None:
                groups = [None] * rplan.n_groups
            elif sizes is not None:
                # adaptive plans carry explicit (possibly uneven) sizes
                groups = device_groups_sized(self._devices, sizes)
            else:
                groups = device_groups(self._devices, rplan.n_groups)
        except Exception as exc:
            # planner failure: fail everything currently queued rather than
            # retrying the same exception forever (same invariant as the
            # single-model path: count in flight BEFORE popping)
            with self._lock:
                self._inflight_batches += 1
            self.metrics.on_inflight(+1)
            reqs = [r for m, d, _ in entries for r in self._queue.pop(m, d)]
            self._fail(reqs, None, exc, in_flight=True)
            return None
        with self._lock:
            # counted BEFORE the atomic pop so flush never observes an
            # empty queue while the round is being formed
            self._inflight_batches += 1
            self._inflight_pred_ms += rplan.predicted_ms
        self.metrics.on_inflight(+1)
        pops = self._queue.pop_many([(p.key, p.plan.served)
                                     for p in rplan.parts])
        formed = form_round(
            [(reqs, part.plan.bucket, self.registry.get(part.key).resolution)
             for part, reqs in zip(rplan.parts, pops)])
        parts: List[_Prepared] = []
        for part, reqs, batch in zip(rplan.parts, pops, formed):
            if batch is None:
                continue
            if isinstance(batch, BaseException):
                # a malformed part must not sink the whole round: fail its
                # requests, keep the others (round slot released at the end)
                self._fail(reqs, part.plan, batch, in_flight=False)
                continue
            parts.append(_Prepared(batch, part.plan,
                                   devices=groups[part.group],
                                   group=part.group))
        self.metrics.on_stage("host", self._clock() - t_h0)
        if not parts:
            self._round_done(rplan.predicted_ms)
            return None
        self.metrics.on_round(len(parts), rplan.n_groups,
                              strategy=getattr(rplan, "strategy", None),
                              candidates=getattr(rplan, "candidates", None),
                              group_sizes=getattr(rplan, "group_sizes", None))
        return _Round(parts, rplan.predicted_ms, rplan.n_groups,
                      groups=list(groups),
                      group_ms=getattr(rplan, "group_ms", None))

    def _planner_takes_weights(self) -> bool:
        """Whether the cost model's plan_round accepts the tenancy
        ``weights`` kwarg (duck-typed stub planners may not)."""
        if self._plan_weights_ok is None:
            try:
                sig = inspect.signature(self.cost_model.plan_round)
                self._plan_weights_ok = "weights" in sig.parameters
            except (TypeError, ValueError):
                self._plan_weights_ok = False
        return self._plan_weights_ok

    def _round_done(self, predicted_ms: float) -> None:
        """Release a round's in-flight accounting and depth slot."""
        with self._done_cv:
            self._inflight_batches -= 1
            self._inflight_pred_ms = max(
                0.0, self._inflight_pred_ms - predicted_ms)
            self._done_cv.notify_all()
        self.metrics.on_inflight(-1)
        self._depth_sem.release()

    # -- reactive mid-flight replanning ---------------------------------------
    def _replan_round(self, rnd: "_Round", outs: List[tuple],
                      t0: float) -> None:
        """Backfill a dispatched round's OBSERVED-idle groups with queued
        work (runs on the device thread, right after the round's scheduled
        parts were dispatched at ``t0``).

        A round costs its slowest group, so every other group idles from
        its own completion until the round's end.  This loop polls each
        group's dispatched outputs through the engine's ``ReadinessProbe``
        (non-blocking: the outputs' CUDA events), and only a group whose
        work is ACTUALLY complete — with at least one planning quantum
        left before the round's predicted end — gets the next
        FIFO-eligible batch whose entry is already warm and whose
        predicted latency fits the remaining window.  Each observed
        completion also feeds ``metrics.on_group_complete`` with
        |predicted - actual|.

        The loop exits when every group is observed complete with nothing
        left to backfill, when the remaining window cannot fit a quantum,
        or when the queue is empty — it never outlives the round's
        predicted end by more than one poll interval, so the device
        thread keeps its pipelining role.  Backfilled parts ride the
        round's existing pipeline slot; the completer fans their results
        exactly like scheduled parts, but their latency observations are
        flagged partial so round-level calibration fits ignore them."""
        groups = rnd.groups
        group_ms = list(rnd.group_ms or [])
        if not groups or len(group_ms) != len(groups):
            return
        round_end = max(group_ms)
        quantum = self.replan_quantum_ms
        if quantum is None:
            quantum = min(p.plan.predicted_ms for p in rnd.parts)
        if quantum <= 0.0:
            return
        n = len(groups)
        # outstanding dispatched outputs per group (scheduled parts now,
        # backfills as they are dispatched)
        pending: Dict[int, List] = {gi: [] for gi in range(n)}
        for p, logits, _t in outs:
            pending[p.group if p.group is not None else 0].append(logits)
        completed: Set[int] = set()
        exhausted: Set[int] = set()
        while True:
            now_ms = (self._clock() - t0) * 1e3
            for gi in range(n):
                if gi in completed:
                    continue
                self.metrics.on_probe_poll(max(1, len(pending[gi])))
                if all(self._probe.poll(out) for out in pending[gi]):
                    completed.add(gi)
                    self.metrics.on_group_complete(group_ms[gi], now_ms)
            idle_ms = round_end - now_ms
            progressed = False
            if idle_ms >= quantum:
                for gi in sorted(completed - exhausted):
                    prep = self._pop_warm_batch(groups[gi], idle_ms,
                                                group_index=gi)
                    if prep is None:
                        # nothing queued is warm for (or fits) THIS group;
                        # exhaustion is sticky so the loop stays bounded
                        exhausted.add(gi)
                        continue
                    try:
                        logits = self.registry.apply(prep.batch.model,
                                                     prep.batch.images,
                                                     devices=prep.devices)
                    except Exception as exc:
                        logits = _BatchError(exc)
                    outs.append((prep, logits, self._clock()))
                    pending[gi].append(logits)
                    # new outstanding work: the group must be observed
                    # complete again before another backfill
                    completed.discard(gi)
                    group_ms[gi] += prep.plan.predicted_ms
                    self.metrics.on_replan(prep.plan.predicted_ms)
                    progressed = True
            if progressed:
                continue
            if len(completed) == n:
                return              # all observed done, nothing backfillable
            if idle_ms < quantum:
                return              # window too small for any further work
            if exhausted >= set(range(n)) or self._queue.pending() == 0:
                return              # no backfill can ever apply
            self._probe.wait(self.probe_interval_ms)

    def _pop_warm_batch(self, group: Optional[tuple], idle_ms: float,
                        group_index: Optional[int] = None
                        ) -> Optional[_Prepared]:
        """Pop and form the next FIFO-eligible batch for an idle group:
        the oldest queued model whose best bucket is already warm AND
        predicted to fit inside ``idle_ms``.  None when nothing eligible
        is queued."""
        for model_key, depth, _ in self._queue.snapshot():
            model = self.registry.get(model_key)
            try:
                if group is not None:
                    plan = self.cost_model.plan_bucket(
                        model, depth, self.buckets, group_size=len(group))
                else:
                    plan = self.cost_model.plan_bucket(model, depth,
                                                       self.buckets)
            except Exception:
                continue
            if plan.predicted_ms > idle_ms:
                continue
            if not self._is_warm(model_key, plan.bucket, group):
                continue
            reqs = self._queue.pop(model_key, plan.served)
            if not reqs:
                continue              # a concurrent pop drained this model
            try:
                batch = form_batch(reqs, plan.bucket, model.resolution)
            except Exception as exc:
                self._fail(reqs, plan, exc, in_flight=False)
                continue
            return _Prepared(batch, plan, devices=group, replanned=True,
                             group=group_index)
        return None

    def _is_warm(self, model_key: str, bucket: int,
                 group: Optional[tuple]) -> bool:
        """Whether the registry already ran this (model, bucket) —
        replanning must never pay a first run under traffic.  Registries
        without the ``is_compiled`` hook (duck-typed stubs) are treated as
        always warm."""
        probe = getattr(self.registry, "is_compiled", None)
        if probe is None:
            return True
        return bool(probe(model_key, bucket, devices=group))

    def _device_loop(self) -> None:
        try:
            while True:
                item = self._submit_q.get()
                if item is _STOP:
                    break
                if isinstance(item, _DeviceCall):
                    try:
                        item.fn()
                    except Exception as exc:
                        item.exc = exc
                    finally:
                        item.done.set()
                    continue
                t0 = self._clock()
                if isinstance(item, _Round):
                    # dispatch every part back-to-back: dispatch is async,
                    # so parts on different device groups execute
                    # concurrently (independent models -> independent
                    # streams); the completer blocks on readiness.  In
                    # multiprocess mode the round spec is broadcast FIRST
                    # so worker stripes start while the coordinator's own
                    # dispatches are still being issued.
                    outs = []
                    mp_round = None
                    if self.multiprocess is not None:
                        try:
                            mp_round = self.multiprocess.begin_round(
                                [(p.batch.model, p.batch.images,
                                  tuple(d.id for d in p.devices))
                                 for p in item.parts])
                        except Exception as exc:
                            for p in item.parts:
                                outs.append((p, _BatchError(exc),
                                             self._clock()))
                            self._complete_q.put((item, outs, t0))
                            continue
                    for idx, p in enumerate(item.parts):
                        try:
                            if mp_round is not None:
                                logits = self.multiprocess.dispatch(
                                    mp_round, idx, p.batch.model,
                                    p.batch.images, p.devices)
                            else:
                                logits = self.registry.apply(
                                    p.batch.model, p.batch.images,
                                    devices=p.devices)
                        except Exception as exc:
                            logits = _BatchError(exc)
                        outs.append((p, logits, self._clock()))
                    if self.replan:
                        self._replan_round(item, outs, t0)
                    self._complete_q.put((item, outs, t0))
                    continue
                try:
                    logits = self.registry.apply(item.batch.model,
                                                 item.batch.images)
                except Exception as exc:
                    logits = _BatchError(exc)
                self._complete_q.put((item, logits, t0))
        finally:
            self._complete_q.put(_STOP)

    def _complete_round(self, rnd: "_Round", outs, t0: float,
                        t_prev: Optional[float]) -> float:
        """Resolve every part of a dispatched round; returns the new
        ``t_prev`` (device-timeline watermark).  Part latency is charged
        from the round's service start to that part's readiness — the
        "when is my batch done" quantity admission control predicts."""
        t_start = t0 if t_prev is None else max(t0, t_prev)
        for p, logits, t_disp in outs:
            try:
                if isinstance(logits, _BatchError):
                    raise logits.exc
                logits_np = _host_logits(logits)
                t1 = self._clock()
                self._finalize(p, logits_np, t_disp, t1, in_flight=False,
                               service_start=max(t_disp, t_start))
            except Exception as exc:
                self._fail(p.batch.requests, p.plan, exc, in_flight=False)
        t_end = self._clock()
        self.metrics.on_stage("device", t_end - t_start)
        # composition feedback: how far off was the chosen plan's round
        # latency from what the device actually delivered?
        self.metrics.on_round_complete(rnd.predicted_ms,
                                       (t_end - t_start) * 1e3)
        self._round_done(rnd.predicted_ms)
        return t_end

    def _completer_loop(self) -> None:
        t_prev: Optional[float] = None
        while True:
            got = self._complete_q.get()
            if got is _STOP:
                break
            item, logits, t0 = got
            if isinstance(item, _Round):
                t_prev = self._complete_round(item, logits, t0, t_prev)
                continue
            try:
                if isinstance(logits, _BatchError):
                    raise logits.exc
                logits_np = _host_logits(logits)
                t1 = self._clock()
                # service time, not dispatch-to-ready: under pipelining this
                # batch was dispatched while its predecessor still occupied
                # the device, so charge it only from the later of its own
                # dispatch and the previous completion — otherwise measured
                # (and calibrated) latency double-counts device time
                t_start = t0 if t_prev is None else max(t0, t_prev)
                t_prev = t1
                self.metrics.on_stage("device", t1 - t_start)
                self._finalize(item, logits_np, t0, t1,
                               in_flight=True, service_start=t_start)
            except Exception as exc:
                # the failed batch still consumed device timeline up to now;
                # advance t_prev so the next batch isn't charged for it
                t_prev = self._clock()
                self._fail(item.batch.requests, item.plan, exc,
                           in_flight=True)

    def _fail(self, reqs: List[VisionRequest], plan: Optional[BucketPlan],
              exc: BaseException, *, in_flight: bool) -> None:
        """Resolve ``reqs`` with status "error" and release pipeline slots —
        a poisoned batch must not wedge flush()/close() or leak depth."""
        out = [VisionResult(r.rid, r.model, "error", None,
                            plan.predicted_ms if plan else 0.0,
                            bucket=plan.bucket if plan else 0,
                            batch_fill=len(reqs), error=repr(exc),
                            slo_class=r.slo_class, tenant=r.tenant)
               for r in reqs]
        with self._lock:
            for res in out:
                self._results[res.rid] = res
            futs = [self._futures.get(res.rid) for res in out]
        for fut, res in zip(futs, out):
            self.metrics.on_error()
            if fut is not None:
                fut._resolve(res)
        with self._done_cv:
            if in_flight:
                self._inflight_batches -= 1
                self._inflight_pred_ms = max(
                    0.0, self._inflight_pred_ms
                    - (plan.predicted_ms if plan else 0.0))
            self._done_cv.notify_all()
        if in_flight:
            self.metrics.on_inflight(-1)
            self._depth_sem.release()

    def _finalize(self, item: _Prepared, logits_np: np.ndarray,
                  t0: float, t1: float, *, in_flight: bool,
                  service_start: Optional[float] = None
                  ) -> List[VisionResult]:
        batch, plan = item.batch, item.plan
        model_key = batch.model
        run_ms = (t1 - (t0 if service_start is None else service_start)) * 1e3
        nd = getattr(plan, "n_devices", 1)
        # kwargs built up so duck-typed cost models predating n_devices /
        # partial keep working; replanned (partial-round) dispatches are
        # flagged so calibration fits don't learn their queueing time
        obs_kw = {}
        if nd != 1:
            obs_kw["n_devices"] = nd
        if getattr(item, "replanned", False):
            obs_kw["partial"] = True
        resid = self.cost_model.observe(self.registry.get(model_key),
                                        plan.bucket, run_ms, **obs_kw)
        self.metrics.on_batch(model_key, batch.fill, plan.bucket, run_ms,
                              plan.predicted_ms, calibrated=plan.calibrated,
                              resid_ms=resid)
        out: List[VisionResult] = []
        for i, r in enumerate(batch.requests):
            out.append(VisionResult(
                rid=r.rid, model=model_key, status="ok",
                logits=logits_np[i], predicted_ms=plan.predicted_ms,
                queue_ms=(t0 - r.t_submit) * 1e3, run_ms=run_ms,
                e2e_ms=(t1 - r.t_submit) * 1e3, bucket=plan.bucket,
                batch_fill=batch.fill, calibrated=plan.calibrated,
                n_devices=nd, slo_class=r.slo_class, tenant=r.tenant))
        # publish results and resolve futures BEFORE signalling completion:
        # a flush() woken by the notify clears self._futures, so a future
        # resolved after the notify could be lost to a concurrent waiter
        with self._lock:
            for res in out:
                self._results[res.rid] = res
            futs = [self._futures.get(res.rid) for res in out]
        for fut, res in zip(futs, out):
            self.metrics.on_complete(model_key, res.e2e_ms, run_ms,
                                     slo_class=res.slo_class,
                                     tenant=res.tenant)
            if fut is not None:
                fut._resolve(res)
        with self._done_cv:
            if in_flight:
                self._inflight_batches -= 1
                self._inflight_pred_ms = max(
                    0.0, self._inflight_pred_ms - plan.predicted_ms)
            self._done_cv.notify_all()
        if in_flight:
            self.metrics.on_inflight(-1)
            self._depth_sem.release()
        return out

    # -- scheduling / execution ---------------------------------------------
    def _reachable_groups(self, n_models: int) -> List[tuple]:
        """Every device group the round scheduler / replanner can ever
        dispatch on with ``n_models`` registered models — the entries a
        process must run once before it is servable."""
        groups: List[tuple] = []
        if self.cross_model and self._devices and len(self._devices) > 1 \
                and hasattr(self.cost_model, "plan_round"):
            from repro_torch.serving.vision.costmodel import (
                power_of_two_partitions, round_groups)
            # group assignment is by FIFO position, so over time a model
            # can land on ANY group of any reachable partition width —
            # warm them all, or the first round on a fresh group runs its
            # entry for the first time under traffic
            seen = set()
            gran = getattr(self.cost_model, "group_granularity", 1)
            widths = {round_groups(m, len(self._devices), gran)
                      for m in range(1, n_models + 1)}
            for k_groups in sorted(widths):
                if k_groups > 1:        # full mesh is warmed by default
                    for grp in device_groups(self._devices, k_groups):
                        if grp not in seen:
                            seen.add(grp)
                            groups.append(grp)
            if getattr(self.cost_model, "round_planner",
                       None) in ("adaptive", "hybrid"):
                # uneven splits are laid out largest-group-first, so the
                # reachable layouts are exactly the descending power-of-two
                # partitions of the mesh into 2..|models| groups.  Hybrid
                # compositions draw from the SAME set (partitions into
                # fewer groups than models), so one sweep covers both —
                # and since replanning may land any model on any group,
                # prewarm runs every model on every warmed group.
                for m in range(2, n_models + 1):
                    for sizes in power_of_two_partitions(
                            len(self._devices), m, gran):
                        for grp in device_groups_sized(self._devices, sizes):
                            if len(grp) < len(self._devices) \
                                    and grp not in seen:
                                seen.add(grp)
                                groups.append(grp)
        return groups

    def warmup(self, keys: Optional[Sequence[str]] = None,
               buckets: Optional[Sequence[int]] = None,
               manifest_path: Optional[str] = None) -> List[tuple]:
        """Prewarm every (model, bucket) pair off the serving path: seed the
        cost model's simulator cache, then both pipeline stages (host batch
        formation and one run of the network on the device) via the
        registry hooks.  Under the round scheduler this also warms every
        device group a round can land on (``_reachable_groups``), so the
        first cross-model round never runs an entry for the first time
        under traffic.  The pipelined engine runs the entries on its device
        thread (started here if traffic has not started it), where PyTorch
        keeps the per-thread library handles that the device stage will
        use.

        ``manifest_path``: a warm restart.  The warmed (model, bucket,
        device-id group) set is persisted to that JSON file, stamped with
        the registry's backend fingerprint (and the multiprocess mesh's),
        and a restarted process replays it instead of deriving the set;
        with the registry's build cache pointed at a kept directory, a
        replayed start builds no kernel.  A manifest whose fingerprint does
        not match is ignored (re-derived and rewritten).  Returns the
        warmed entry list as ``(key, bucket, device-id tuple | None)``
        triples; warm-up wall-ms and the build cache's hit/miss delta land
        in the metrics snapshot.  In multiprocess mode the entries are then
        broadcast to the workers, which warm their stripes of them."""
        if self._closing or self._closed:
            raise RuntimeError("engine is closed")
        t_w0 = time.perf_counter()
        bks = tuple(buckets) if buckets is not None else self.buckets
        ks = list(keys if keys is not None else self.registry.keys())
        groups = self._reachable_groups(len(ks))
        if self.multiprocess is not None and self._devices:
            # the serial strategy dispatches on the full logical universe,
            # whose per-process stripe entry (local bucket = bucket / P)
            # differs from the default full-LOCAL-mesh warm — warm it
            # explicitly like any other group
            full = tuple(self._devices)
            if full not in groups:
                groups = groups + [full]
        for k in ks:
            model = self.registry.get(k)
            for b in bks:
                self.cost_model.predicted_ms(model, b)
            for grp in groups:
                # seed the sharded simulator points (per-device microbatch)
                self.cost_model.plan_bucket(model, max(bks), bks,
                                            group_size=len(grp))
        entries: Optional[List[tuple]] = None
        replayed = False
        if manifest_path:
            entries = self._load_manifest(manifest_path, ks)
            replayed = entries is not None
        if entries is None:
            entries = [(k, b, None) for k in ks for b in bks]
            # stub registries in tests hand out bare ints as devices;
            # real meshes hand out devices with .id
            entries += [(k, b, tuple(getattr(d, "id", d) for d in grp))
                        for k in ks for grp in groups for b in bks]
        before = persistent_cache_counters()
        warm_entry = getattr(self.registry, "warm_entry", None)
        if warm_entry is not None:
            def warm():
                hosted = set()
                for k, b, ids in entries:
                    if self.multiprocess is not None and ids is not None:
                        # ids name LOGICAL universe devices: warm this
                        # process's stripe of the group (the same entry
                        # every worker's stripe resolves to)
                        self._warm_multiprocess_entry(k, b, ids, hosted)
                        continue
                    devs = None
                    if ids is not None:
                        by_id = getattr(self.registry, "devices_by_id", None)
                        devs = by_id(ids) if by_id else None
                        if devs is None:
                            continue       # id set not on this mesh: skip
                    warm_entry(k, b, devices=devs,
                               host=(k, b) not in hosted)
                    hosted.add((k, b))
            if self.pipelined:
                self._on_device_thread(warm)
            else:
                warm()
        else:
            # duck-typed stub registries: the coarse per-model hook
            for k in ks:
                self.registry.prewarm(k, bks, groups=groups or None)
        delta = counters_delta(before)
        if manifest_path and not replayed:
            self._write_manifest(manifest_path, entries)
        if self.multiprocess is not None:
            # broadcast AFTER the coordinator warmed (and built the kernel
            # libraries), so every worker warm loads them: a pure hit
            self.multiprocess.broadcast_warmup(
                self._manifest_fingerprint() or "", entries)
        self.metrics.on_warmup((time.perf_counter() - t_w0) * 1e3,
                               len(entries), replayed,
                               pcache_hits=int(delta["hits"]),
                               pcache_misses=int(delta["misses"]))
        return entries

    def _warm_multiprocess_entry(self, k: str, b: int,
                                 ids: Sequence[int], hosted: set) -> None:
        """Warm this process's stripe of one logical (model, bucket,
        universe-group) entry — the entry round dispatch will actually run,
        identical (same local device ids, same local bucket) on every
        process."""
        from repro_torch.serving.vision.multiproc import local_exec_plan
        mp = self.multiprocess
        plan = local_exec_plan(mp.mesh, mp.group_by_ids(ids), b)
        if plan is None:
            return
        self.registry.warm_entry(k, plan.local_bucket,
                                 devices=plan.devices,
                                 host=(k, b) not in hosted)
        hosted.add((k, b))

    def _manifest_fingerprint(self) -> Optional[str]:
        """What a warmup manifest is stamped with: the registry's backend
        fingerprint, extended with the multiprocess mesh topology when one
        is attached — a manifest whose group ids name LOGICAL universe
        devices must never replay into a single-process engine (whose
        local ids they would silently alias), and vice versa.  None for
        registries without a fingerprint, which then neither read nor
        write a manifest."""
        fp_fn = getattr(self.registry, "backend_fingerprint", None)
        if fp_fn is None:
            return None
        fp = fp_fn()
        if self.multiprocess is not None:
            fp = f"{fp}:{self.multiprocess.mesh.fingerprint()}"
        return fp

    def _load_manifest(self, path: str,
                       ks: Sequence[str]) -> Optional[List[tuple]]:
        """Entries from a warmup manifest, or None when it is missing,
        unreadable, fingerprint-stale, or names no registered model —
        every failure mode falls back to deriving the set fresh."""
        fp = self._manifest_fingerprint()
        if fp is None or not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError, ValueError):
            return None
        if not isinstance(manifest, dict) \
                or manifest.get("fingerprint") != fp:
            return None
        known = set(ks)
        entries = []
        for e in manifest.get("entries", []):
            try:
                k, b, ids = e[0], int(e[1]), e[2]
            except (TypeError, ValueError, IndexError, KeyError):
                return None
            if k in known:
                entries.append((k, b, tuple(ids) if ids is not None else None))
        return entries or None

    def _write_manifest(self, path: str, entries: List[tuple]) -> None:
        """Persist the warmed entry set (atomic rename; fingerprint-stamped
        so a drifted backend or model set invalidates it)."""
        fp = self._manifest_fingerprint()
        if fp is None:
            return
        data = {
            "version": 1,
            "fingerprint": fp,
            "created_unix": time.time(),
            "entries": [[k, b, list(ids) if ids is not None else None]
                        for k, b, ids in entries],
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
        os.replace(tmp, path)

    def _on_device_thread(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` on the pipeline's device thread and wait for it;
        re-raises what it raised."""
        self._ensure_started()
        call = _DeviceCall(fn, threading.Event())
        self._submit_q.put(call)
        call.done.wait()
        if call.exc is not None:
            raise call.exc

    def step(self) -> List[VisionResult]:
        """Synchronously run ONE batch on the caller's thread (the
        ``pipelined=False`` execution path); [] if nothing is queued."""
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
            logits_np = _host_logits(
                self.registry.apply(model_key, batch.images))
        except Exception as exc:
            # engine-interface conformance: a poisoned batch resolves its
            # requests with status "error" on every engine — the pipelined
            # device/completer threads already do this, and the sync path
            # must not differ by leaking the exception to the caller
            self._fail(reqs, plan, exc, in_flight=False)
            return []
        t1 = self._clock()
        self.metrics.on_stage("device", t1 - t0)
        return self._finalize(_Prepared(batch, plan), logits_np,
                              t0, t1, in_flight=False)

    def flush(self) -> List[VisionResult]:
        """Wait for all queued work to complete (pipelined) or drain it on
        this thread (sync), then hand back (and clear) finished results."""
        if self.pipelined:
            if self._started:
                with self._done_cv:
                    # drain intent: the scheduler stops holding sub-maximal
                    # batches back for the coalescing window
                    self._flush_waiters += 1
                    self._work_cv.notify_all()
                    try:
                        while self._inflight_batches or self._queue.pending():
                            self._done_cv.wait(timeout=0.05)
                    finally:
                        self._flush_waiters -= 1
        else:
            while self._queue.pending():
                self.step()
        with self._lock:
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

    # -- engine-interface surface (see interface.ServingEngine) ---------------
    def poll(self, rid: int,
             timeout_ms: float = 0.0) -> Optional[VisionResult]:
        """The result for one request id, or None while it is pending.

        Non-destructive: the result stays owned by the engine until
        ``flush()`` collects it, so polling and flushing compose.  On the
        pipelined engine ``timeout_ms`` bounds how long to wait for the
        worker threads; the sync engine has no workers, so poll IS the
        executor — it drains queued batches on the caller's thread until
        the request resolves.  Raises ``KeyError`` for an id this engine
        never issued or whose result was already handed out by
        ``flush()``."""
        with self._lock:
            fut = self._futures.get(rid)
        if fut is None:
            raise KeyError(f"unknown or already-flushed request id {rid}")
        if fut.done():
            return fut.result(0)
        if not self.pipelined:
            while not fut.done() and self._queue.pending():
                self.step()
            return fut.result(0) if fut.done() else None
        if timeout_ms > 0:
            try:
                return fut.result(timeout_ms / 1e3)
            except TimeoutError:
                return None
        return None

    def stream_results(self, rids: Optional[Sequence[int]] = None,
                       timeout_ms: Optional[float] = None
                       ) -> Iterator[VisionResult]:
        """Yield results as they complete (completion order, not
        submission order).  ``rids`` restricts the stream to those ids
        (default: every outstanding unflushed request); ``timeout_ms``
        bounds the total wait on the pipelined engine (the stream simply
        ends when it elapses).  On the sync engine the generator drains
        queued batches on the caller's thread between yields.  Results
        stay flushable afterwards (non-destructive, like ``poll``)."""
        with self._lock:
            want = list(rids) if rids is not None else sorted(self._futures)
            pending = {r: self._futures[r] for r in want}
        t_end = (None if timeout_ms is None
                 else time.monotonic() + timeout_ms / 1e3)
        while pending:
            progressed = False
            for rid in list(pending):
                if pending[rid].done():
                    fut = pending.pop(rid)
                    progressed = True
                    yield fut.result(0)
            if not pending or progressed:
                continue
            if not self.pipelined:
                if self._queue.pending() == 0:
                    return             # nothing left that could resolve
                self.step()
                continue
            if t_end is not None and time.monotonic() >= t_end:
                return
            time.sleep(0.001)

    def snapshot(self) -> Dict:
        """One self-describing dict for the whole engine: the metrics
        snapshot plus the registry's first-run accounting (entries run,
        per-entry first-call ms)."""
        snap = self.metrics.snapshot()
        stats = getattr(self.registry, "compile_stats", None)
        if stats is not None:
            comp = dict(snap.get("compilation", {}))
            comp.update(stats())
            snap["compilation"] = comp
        if self.multiprocess is not None:
            mp = dict(snap.get("multiprocess", {}))
            mp.update(self.multiprocess.mesh.describe())
            snap["multiprocess"] = mp
        return snap

    # -- shutdown -------------------------------------------------------------
    def close(self, *, drain: bool = True) -> None:
        """Stop the pipeline.  ``drain=True`` (default) finishes everything
        queued and in flight first; ``drain=False`` completes only batches
        already formed and cancels the rest (their futures resolve with
        status "cancelled").  Idempotent; ``submit`` raises afterwards."""
        if self._closed:
            return
        with self._work_cv:
            self._closing = True
            self._drain_on_close = drain
            self._work_cv.notify_all()
        if self._started:
            for t in self._threads:
                t.join()
        elif drain:
            # sync engine (or pipeline that never started): drain on this
            # thread so drain=True keeps its contract in every mode
            while self._queue.pending():
                self.step()
        self._closed = True
        # anything still queued was abandoned by the scheduler (drain=False
        # or never-started pipeline): resolve as cancelled
        for snap in iter(self._queue.snapshot_oldest, None):
            model_key, depth, _ = snap
            for r in self._queue.pop(model_key, depth):
                res = VisionResult(r.rid, model_key, "cancelled", None, 0.0,
                                   slo_class=r.slo_class, tenant=r.tenant)
                with self._lock:
                    self._results[r.rid] = res
                    fut = self._futures.get(r.rid)
                if fut is not None:
                    fut._resolve(res)

    def __enter__(self) -> "VisionServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
