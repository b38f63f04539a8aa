"""Serving metrics: counters + latency distributions (p50/p99, throughput).

Pure-Python accounting (no jax): every number here is host-side bookkeeping
around the jitted compute, so importing this module never touches a device.

Units: every ``*_ms`` here is measured **wall milliseconds** on the
engine's clock, and every ``*_s`` wall seconds — with one deliberate
exception: ``cost_model_abs_err_ms`` compares a measured wall-ms against
the prediction *in whatever unit the scheduler quoted at decision time*
(calibrated wall-ms once converged, raw ST-OS accel-ms during warm-up), so
early samples of that one stat mix units by construction.
``calibration_abs_resid_ms`` only records once calibrated and is pure
wall-ms.

Latency tables are **request-weighted**: ``run`` records the batch compute
time once per request served by that batch, not once per batch, so p99
under mixed bucket sizes reflects what requests actually experienced (a
bucket-8 batch carries 8x the weight of a singleton).  Batch-level counts
(batches, padded slots, cost-model error) stay per-batch.

The pipelined engine additionally reports stage-occupancy numbers: current
and peak in-flight batch depth, per-stage busy seconds, and an overlap
ratio (how much of the device stage's busy time was hidden behind host-side
batching) derived as ``(host_busy + device_busy - wall) / device_busy``,
clamped to [0, 1].  All mutators take one lock — submit, scheduler, and
completion threads all write here.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Dict, List, Optional

from .tenancy import jain_fairness as _jain


def percentile(values: List[float], p: float) -> float:
    """Nearest-rank percentile (p in [0, 100]); 0.0 on empty input."""
    if not values:
        return 0.0
    xs = sorted(values)
    rank = max(0, min(len(xs) - 1, int(round(p / 100.0 * (len(xs) - 1)))))
    return xs[rank]


@dataclasses.dataclass
class LatencyStat:
    """Latency distribution with bounded memory.

    Count and mean are exact (running totals); percentiles come from a
    uniform reservoir of at most ``max_samples`` values, so a long-running
    server neither grows without bound nor pays an ever-larger sort in
    ``snapshot()``.  The reservoir RNG is seeded, keeping runs repeatable.
    """
    max_samples: int = 4096
    samples: List[float] = dataclasses.field(default_factory=list)
    _count: int = 0
    _sum: float = 0.0
    _rng: random.Random = dataclasses.field(
        default_factory=lambda: random.Random(0))

    def record(self, ms: float) -> None:
        ms = float(ms)
        self._count += 1
        self._sum += ms
        if len(self.samples) < self.max_samples:
            self.samples.append(ms)
        else:
            j = self._rng.randrange(self._count)
            if j < self.max_samples:
                self.samples[j] = ms

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def p(self, q: float) -> float:
        return percentile(self.samples, q)

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "mean_ms": self.mean,
                "p50_ms": self.p(50), "p95_ms": self.p(95),
                "p99_ms": self.p(99)}


class ServeMetrics:
    """Engine-wide counters + per-model latency distributions."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._reset_locked()

    def _reset_locked(self) -> None:
        self._t_start: Optional[float] = None
        self._t_last: Optional[float] = None
        self.submitted = 0
        self.rejected = 0
        self.completed = 0
        self.errors = 0                # requests failed by a pipeline stage
        self.batches = 0
        self.calibrated_batches = 0    # batches scheduled on calibrated ms
        self.padded_slots = 0          # wasted compute from bucket padding
        self.e2e = {}                  # model -> LatencyStat (submit -> done)
        self.run = {}                  # model -> LatencyStat, request-weighted
        self.cost_model_err = LatencyStat()   # |predicted - measured| in ms
        self.calibration_resid = LatencyStat()  # |wall - calibrated fit| in ms
        # pipeline occupancy
        self.in_flight = 0
        self.max_in_flight = 0
        self.host_busy_s = 0.0         # scheduling + letterbox/batch formation
        self.device_busy_s = 0.0       # dispatch -> block_until_ready
        # cross-model round scheduler
        self.rounds = 0                # co-scheduled device rounds dispatched
        self.cross_model_rounds = 0    # rounds carrying >1 model
        self.max_round_models = 0      # widest round (models co-scheduled)
        self.max_round_groups = 0      # widest round (device groups used)
        # adaptive round planner: which composition won, and by how much.
        # round_margin is SIGNED, in predicted ms per served request (the
        # planner's score unit): best alternative minus chosen — positive
        # when the winner was decisively cheaper, negative when the switch
        # hysteresis kept the structural split despite a cheaper challenger
        self.round_strategies: Dict[str, int] = {}   # strategy -> rounds won
        self.round_margin = LatencyStat()
        self.round_pred_err = LatencyStat()  # |predicted - measured| per round
        # hybrid compositions: which group-size layout won ("4+2+2" -> count)
        self.hybrid_compositions: Dict[str, int] = {}
        # mid-flight replanning: batches backfilled onto predicted-idle
        # groups, and the predicted idle wall-ms those batches recovered
        self.replans = 0
        self.replan_idle_recovered_ms = 0.0
        # reactive completion: readiness-probe polls issued by the device
        # thread, and per-group |predicted - actual| completion error
        # (round_pred_err above is per-round; this one is per device
        # group, measured at the probe's observed completion)
        self.probe_polls = 0
        self.group_pred_err = LatencyStat()
        # tenancy: shed requests per SLO class, per-class and per-tenant
        # end-to-end latency ledgers, per-tenant completion counts for
        # the fairness index
        self.shed: Dict[str, int] = {}
        self.class_e2e: Dict[str, LatencyStat] = {}
        self.tenant_e2e: Dict[str, LatencyStat] = {}
        self.tenant_completed: Dict[str, int] = {}
        # warmup: cold-start-to-servable is dominated by the first run of
        # each (model, bucket) on the device (kernel libraries built or
        # loaded, cuDNN's algorithm picked, allocator blocks held), so the
        # warmup pass reports its wall-ms, the entries it ran, whether a
        # manifest named them and the kernel build cache's hit/miss delta
        # it observed (a miss is an nvcc run; a warm restart sees only
        # hits)
        self.warmup_ms = 0.0
        self.warmup_entries = 0
        self.warmup_manifest_replayed = False
        self.warmup_pcache_hits = 0
        self.warmup_pcache_misses = 0

    def reset(self) -> None:
        """Zero every counter/distribution (e.g. after warm-up traffic so a
        reported snapshot covers only the measured pass).  Only call while
        the engine is drained — in-flight work would decrement fresh
        gauges."""
        with self._lock:
            self._reset_locked()

    def _stat(self, table: Dict[str, LatencyStat], model: str) -> LatencyStat:
        if model not in table:
            table[model] = LatencyStat()
        return table[model]

    def on_submit(self) -> None:
        with self._lock:
            self.submitted += 1
            if self._t_start is None:
                self._t_start = self._clock()

    def on_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def on_error(self) -> None:
        with self._lock:
            self.errors += 1

    def on_batch(self, model: str, served: int, bucket: int,
                 run_ms: float, predicted_ms: float, *,
                 calibrated: bool = False,
                 resid_ms: Optional[float] = None) -> None:
        with self._lock:
            self.batches += 1
            self.padded_slots += bucket - served
            self.cost_model_err.record(abs(predicted_ms - run_ms))
            if calibrated:
                self.calibrated_batches += 1
            if resid_ms is not None:
                self.calibration_resid.record(abs(resid_ms))
            self._t_last = self._clock()

    def on_complete(self, model: str, e2e_ms: float,
                    run_ms: Optional[float] = None, *,
                    slo_class: Optional[str] = None,
                    tenant: Optional[str] = None) -> None:
        with self._lock:
            self.completed += 1
            self._stat(self.e2e, model).record(e2e_ms)
            if run_ms is not None:
                self._stat(self.run, model).record(run_ms)
            if slo_class is not None:
                self._stat(self.class_e2e, slo_class).record(e2e_ms)
            if tenant is not None:
                self._stat(self.tenant_e2e, tenant).record(e2e_ms)
                self.tenant_completed[tenant] = \
                    self.tenant_completed.get(tenant, 0) + 1

    def on_warmup(self, ms: float, entries: int, manifest_replayed: bool,
                  *, pcache_hits: int = 0, pcache_misses: int = 0) -> None:
        """One warmup pass finished: ``entries`` (model, bucket) entries
        run once in ``ms`` wall-ms, observing the given kernel build cache
        hit/miss delta.  Cumulative across passes (warmup may be re-run
        after registering models)."""
        with self._lock:
            self.warmup_ms += ms
            self.warmup_entries += entries
            self.warmup_manifest_replayed = bool(manifest_replayed)
            self.warmup_pcache_hits += int(pcache_hits)
            self.warmup_pcache_misses += int(pcache_misses)

    def on_shed(self, slo_class: str) -> None:
        """One queued request shed at admission time to make room for a
        higher-priority one."""
        with self._lock:
            self.shed[slo_class] = self.shed.get(slo_class, 0) + 1

    def on_probe_poll(self, n: int = 1) -> None:
        """The device thread polled round readiness ``n`` times."""
        with self._lock:
            self.probe_polls += n

    def on_group_complete(self, predicted_ms: float,
                          measured_ms: float) -> None:
        """One device group observed complete by the readiness probe:
        record |predicted - actual| for the group, the reactive analogue
        of the per-round prediction error."""
        with self._lock:
            self.group_pred_err.record(abs(predicted_ms - measured_ms))

    def fairness_index(self) -> float:
        """Jain's index over per-tenant completed counts (1.0 = even)."""
        with self._lock:
            return _jain(list(self.tenant_completed.values()))

    def on_round(self, n_models: int, n_groups: int, *,
                 strategy: Optional[str] = None,
                 candidates: Optional[Dict[str, float]] = None,
                 group_sizes: Optional[List[int]] = None) -> None:
        """One cross-model round dispatched: ``n_models`` batches
        co-scheduled over ``n_groups`` device groups.  ``strategy`` is the
        composition the planner chose; ``candidates`` maps every scored
        composition to its predicted ms per served request.  The recorded
        margin (best alternative minus chosen) is signed: positive = the
        chosen composition was predicted cheaper by that much per request,
        negative = the switch hysteresis kept the structural split despite
        a challenger predicted cheaper by that much.  When a hybrid
        composition wins, its ``group_sizes`` layout is histogrammed
        (``"4+2+2"``) so a deployment can see which shapes the packer
        actually uses."""
        with self._lock:
            self.rounds += 1
            if n_models > 1:
                self.cross_model_rounds += 1
            self.max_round_models = max(self.max_round_models, n_models)
            self.max_round_groups = max(self.max_round_groups, n_groups)
            if strategy is not None:
                self.round_strategies[strategy] = \
                    self.round_strategies.get(strategy, 0) + 1
                if candidates and len(candidates) > 1:
                    losers = [ms for name, ms in candidates.items()
                              if name != strategy]
                    self.round_margin.record(
                        min(losers) - candidates[strategy])
                if strategy == "hybrid" and group_sizes:
                    layout = "+".join(str(s) for s in group_sizes)
                    self.hybrid_compositions[layout] = \
                        self.hybrid_compositions.get(layout, 0) + 1

    def on_replan(self, recovered_ms: float) -> None:
        """One batch backfilled mid-flight onto a predicted-idle device
        group; ``recovered_ms`` is the predicted idle wall-ms it filled
        (the batch's own predicted latency — it was only dispatched
        because it fit inside the group's idle window)."""
        with self._lock:
            self.replans += 1
            self.replan_idle_recovered_ms += recovered_ms

    def on_round_complete(self, predicted_ms: float,
                          measured_ms: float) -> None:
        """One round finished on the mesh: record how far the chosen
        composition's predicted latency was from the measured wall time
        (the adaptive planner's own calibration error)."""
        with self._lock:
            self.round_pred_err.record(abs(predicted_ms - measured_ms))

    # -- pipeline occupancy ---------------------------------------------------
    def on_inflight(self, delta: int) -> None:
        with self._lock:
            self.in_flight += delta
            self.max_in_flight = max(self.max_in_flight, self.in_flight)

    def on_stage(self, stage: str, seconds: float) -> None:
        with self._lock:
            if stage == "host":
                self.host_busy_s += seconds
            elif stage == "device":
                self.device_busy_s += seconds
            else:
                raise ValueError(stage)

    @property
    def wall_s(self) -> float:
        if self._t_start is None or self._t_last is None:
            return 0.0
        return max(self._t_last - self._t_start, 0.0)

    @property
    def throughput_ips(self) -> float:
        """Completed images per wall-clock second (0 until a batch ran)."""
        wall = self.wall_s
        return self.completed / wall if wall > 0 else 0.0

    @property
    def overlap_ratio(self) -> float:
        """Fraction of device busy time overlapped with host-stage work."""
        wall = self.wall_s
        if self.device_busy_s <= 0.0 or wall <= 0.0:
            return 0.0
        overlap = self.host_busy_s + self.device_busy_s - wall
        return max(0.0, min(1.0, overlap / self.device_busy_s))

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "submitted": self.submitted,
                "rejected": self.rejected,
                "completed": self.completed,
                "errors": self.errors,
                "batches": self.batches,
                "calibrated_batches": self.calibrated_batches,
                "padded_slots": self.padded_slots,
                "throughput_ips": self.throughput_ips,
                "rounds": self.rounds,
                "cross_model_rounds": self.cross_model_rounds,
                "max_round_models": self.max_round_models,
                "max_round_groups": self.max_round_groups,
                "round_strategies": dict(self.round_strategies),
                "round_margin_ms_per_req": self.round_margin.summary(),
                "round_pred_abs_err_ms": self.round_pred_err.summary(),
                "hybrid_compositions": dict(self.hybrid_compositions),
                "replans": self.replans,
                "replan_idle_recovered_ms": self.replan_idle_recovered_ms,
                "probe_polls": self.probe_polls,
                "group_pred_abs_err_ms": self.group_pred_err.summary(),
                "shed": dict(self.shed),
                "class_e2e": {c: s.summary()
                              for c, s in self.class_e2e.items()},
                "tenant_e2e": {t: s.summary()
                               for t, s in self.tenant_e2e.items()},
                "tenant_completed": dict(self.tenant_completed),
                "fairness_index": _jain(
                    list(self.tenant_completed.values())),
                "compilation": {
                    "warmup_ms": self.warmup_ms,
                    "warmup_entries": self.warmup_entries,
                    "manifest_replayed": self.warmup_manifest_replayed,
                    "warmup_pcache_hits": self.warmup_pcache_hits,
                    "warmup_pcache_misses": self.warmup_pcache_misses,
                },
                "max_in_flight": self.max_in_flight,
                "host_busy_s": self.host_busy_s,
                "device_busy_s": self.device_busy_s,
                "overlap_ratio": self.overlap_ratio,
                "e2e": {m: s.summary() for m, s in self.e2e.items()},
                "run": {m: s.summary() for m, s in self.run.items()},
                "cost_model_abs_err_ms": self.cost_model_err.summary(),
                "calibration_abs_resid_ms": self.calibration_resid.summary(),
            }
