"""Cost model: ST-OS systolic latency estimates driving scheduling decisions.

Units: ``predicted_ms`` is **accelerator milliseconds** (accel-ms) from the
ST-OS simulator — the paper machine's clock; ``expected_ms`` returns
calibrated **wall milliseconds** (wall-ms) once the ``LatencyCalibrator``
has converged for a cell, accel-ms before (the ``calibrated`` flag says
which).  Measured batch times fed to ``observe`` are always wall-ms.

The systolic simulator (``repro.systolic.simulator``) gives a per-network,
per-batch latency estimate for the paper's accelerator — for free, from the
same operator IR the counting/benchmark stack uses.  The serving engine
uses it four ways:

  * bucket selection — among the fixed batch buckets, run the one that
    maximizes delivered images per predicted millisecond (padding a batch
    to a bigger bucket is wasted compute; a too-small bucket leaves queued
    work waiting for another pass);
  * round composition — ``plan_round`` maps the models that currently have
    queued work onto device groups of the mesh (the ST-OS trick of mapping
    independent convolutions onto independent array rows, lifted to the
    fleet: independent models fill independent devices).  A batch sharded
    over ``g`` devices is priced as the per-device microbatch
    (``bucket / g``), and the round costs the slowest device group.  The
    **adaptive** planner (default) enumerates candidate compositions —
    serializing every model on the full mesh, the structural even
    power-of-two split, and uneven power-of-two splits sized proportional
    to queue depth — scores each in calibrated wall-ms via ``expected_ms``,
    and returns the argmin; the losing candidates' scores ride along on the
    ``RoundPlan`` for metrics and debugging.  ``round_planner="hybrid"``
    additionally scores **hybrid** compositions — uneven power-of-two
    groups that host several models back-to-back, priced at the admission
    quantile so the shared groups' summed prediction errors are paid for
    up front.  ``round_planner="fifo"`` keeps the structural even split
    unconditionally (the pre-adaptive behavior, and the benchmark
    baseline);
  * admission control — a request with an SLO is rejected up front when the
    predicted time to drain the queue ahead of it (plus its own batch)
    already exceeds the SLO.  Admission prices each batch at a configurable
    latency **quantile** (default p95: ``scale * accel + z * resid_std``
    from the calibrator's residual variance) rather than the mean — an SLO
    is a tail promise, and a mean-based admit over-admits exactly when
    latency is noisy;
  * reporting — predicted vs measured latency per batch (the cost model's
    calibration error is itself a serving metric).

Simulator calls are memoized per (model key, batch): the IR never changes
after registration, so each point is simulated at most once per process.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.systolic.arrays import PAPER_CONFIG, SystolicConfig
from repro_torch.systolic.simulator import NetworkSim, simulate_network

from repro_torch.serving.vision.calibrate import LatencyCalibrator
from repro_torch.serving.vision.registry import RegisteredModel


@dataclasses.dataclass
class BucketPlan:
    bucket: int
    served: int                  # requests actually in the batch
    predicted_ms: float          # expected latency for the whole batch
    calibrated: bool = False     # True -> predicted_ms is calibrated wall-ms
    n_devices: int = 1           # devices the batch is sharded over

    @property
    def imgs_per_ms(self) -> float:
        return self.served / self.predicted_ms if self.predicted_ms else 0.0


@dataclasses.dataclass
class RoundPart:
    """One model's batch inside a co-scheduled cross-model round."""
    key: str
    plan: BucketPlan
    group: int                   # device-group index within the round


@dataclasses.dataclass
class RoundPlan:
    """A cross-model device round: one bucketed batch per model assigned to
    a contiguous device group.  ``predicted_ms`` is the slowest group's
    serial sum — groups run in parallel, models sharing a group run
    back-to-back.  ``group_sizes`` (devices per group, in group order) is
    set by ``SystolicCostModel.plan_round``; None means equal groups of
    ``n_devices // n_groups`` (duck-typed planners that predate uneven
    splits).  ``group_ms`` is each group's predicted serial sum — the
    slowest entry is ``predicted_ms``, and the gaps to it are the
    predicted idle the executor's mid-flight replanner may backfill.
    ``strategy`` names the composition that won and ``candidates`` records
    every scored composition's predicted ms per served request — the
    planner's reasoning is part of the plan, so metrics and debugging can
    see what adaptivity rejected."""
    parts: List[RoundPart]
    n_devices: int               # mesh size the round was planned for
    n_groups: int
    predicted_ms: float
    group_sizes: Optional[List[int]] = None
    strategy: str = "even"
    candidates: Dict[str, float] = dataclasses.field(default_factory=dict)
    group_ms: Optional[List[float]] = None

    @property
    def served(self) -> int:
        return sum(p.plan.served for p in self.parts)


def round_groups(n_models: int, n_devices: int,
                 granularity: int = 1) -> int:
    """Number of device groups for a round: the largest power of two that
    divides ``n_devices`` and does not exceed ``n_models`` — every group
    gets the same contiguous device count, every model gets a group.
    ``granularity`` additionally requires every group's size to stay a
    multiple of it (multi-process serving: a group must span all P
    processes with equal local stripes, so sizes are multiples of P)."""
    assert n_models >= 1 and n_devices >= 1
    k = 1
    while (k * 2 <= min(n_models, n_devices)
           and n_devices % (k * 2) == 0
           and (n_devices // (k * 2)) % granularity == 0):
        k *= 2
    return k


def power_of_two_partitions(n_devices: int, n_parts: int,
                            granularity: int = 1) -> List[List[int]]:
    """Every descending list of ``n_parts`` power-of-two group sizes
    summing exactly to ``n_devices`` — the complete layout space of the
    adaptive planner's uneven splits (used by engine warm-up to precompile
    each reachable device group).  With ``granularity`` g > 1, only sizes
    that are multiples of g are legal (multi-process group constraint)."""
    out: List[List[int]] = []

    def rec(remaining: int, parts_left: int, max_size: int,
            acc: List[int]) -> None:
        if parts_left == 0:
            if remaining == 0:
                out.append(list(acc))
            return
        p = 1
        while p * 2 <= min(max_size, remaining):
            p *= 2
        while p >= 1:
            if (p % granularity == 0
                    and remaining - p >= (parts_left - 1) * granularity):
                rec(remaining - p, parts_left - 1, p, acc + [p])
            p //= 2

    if n_parts >= 1:
        rec(n_devices, n_parts, n_devices, [])
    return out


def uneven_sizes(weights: Sequence[float], n_devices: int,
                 granularity: int = 1) -> Optional[List[int]]:
    """Power-of-two device-group sizes, one per model, proportional to
    ``weights`` (queue depths) and summing exactly to ``n_devices``.

    Greedy water-filling: every model starts with ``granularity`` devices
    (one, single-process), then the group with the highest
    weight-per-device repeatedly doubles while a doubling still fits.
    Sizes stay powers of two times the granularity (doubling from it), so
    every group keeps both the bucket-divisibility property sharding
    relies on and the spans-all-processes property multi-process rounds
    require.  Returns None when no exact fill exists (more models than
    device budget, or the remainder cannot be expressed by any legal
    doubling) — the caller simply drops the uneven candidate."""
    n = len(weights)
    if n == 0 or n * granularity > n_devices:
        return None
    sizes = [granularity] * n
    free = n_devices - n * granularity
    while free > 0:
        fits = [i for i in range(n) if sizes[i] <= free]
        if not fits:
            return None
        i = max(fits, key=lambda j: (weights[j] / sizes[j], -j))
        free -= sizes[i]
        sizes[i] *= 2
    return sizes


class SystolicCostModel:
    def __init__(self, cfg: SystolicConfig = PAPER_CONFIG, *,
                 stos: bool = True, baseline_dataflow: str = "OS",
                 calibrator: Optional[LatencyCalibrator] = None,
                 n_devices: int = 1,
                 round_planner: str = "adaptive",
                 admission_quantile: float = 0.95,
                 switch_margin: float = 0.25,
                 group_granularity: int = 1):
        assert round_planner in ("fifo", "adaptive", "hybrid"), round_planner
        assert 0.0 < admission_quantile < 1.0, admission_quantile
        assert switch_margin >= 0.0, switch_margin
        self.cfg = cfg
        self.stos = stos
        self.baseline_dataflow = baseline_dataflow
        self.calibrator = calibrator
        self.n_devices = max(1, int(n_devices))
        # multi-process serving: every device group must span all P
        # processes with equal local stripes, so group sizes (and the mesh
        # itself) stay multiples of P.  1 = single-process, unconstrained.
        self.group_granularity = max(1, int(group_granularity))
        assert self.n_devices % self.group_granularity == 0, \
            (self.n_devices, self.group_granularity)
        # "adaptive": plan_round scores serial/even/uneven compositions and
        # returns the argmin; "hybrid": adaptive plus compositions whose
        # uneven groups host several models back-to-back; "fifo": the
        # structural even split always.
        self.round_planner = round_planner
        # latency quantile admit() prices batches at (0.5 = mean).  Only
        # bites once the calibrator carries residual variance; accel-ms
        # warm-up estimates have no variance term.
        self.admission_quantile = admission_quantile
        # hysteresis: a non-structural composition must beat the even
        # split's score by this fraction before the planner switches.
        # Calibration scales on small batches carry 10-30% residual noise
        # (see _Fit.resid_std), and a serial/uneven round is scored from
        # cells observed under different co-scheduling conditions — so a
        # predicted win inside the margin is indistinguishable from noise,
        # and chasing it trades the warm, predictable structural split for
        # jitter.  Decisive wins (sharding or skew worth >=25%) switch.
        self.switch_margin = switch_margin
        self._cache: Dict[Tuple[str, int], float] = {}

    # -- latency ------------------------------------------------------------
    def simulate(self, model: RegisteredModel, batch: int) -> NetworkSim:
        return simulate_network(model.ir, self.cfg, stos=self.stos,
                                baseline_dataflow=self.baseline_dataflow,
                                batch=batch, name=model.key)

    def predicted_ms(self, model: RegisteredModel, batch: int) -> float:
        """Raw accelerator-ms from the ST-OS simulator (memoized)."""
        key = (model.key, batch)
        if key not in self._cache:
            self._cache[key] = self.simulate(model, batch).latency_ms
        return self._cache[key]

    def fingerprint(self, model: RegisteredModel) -> str:
        """Tag for calibration fits: which backend and mesh shape produced
        the wall-ms observations.  A change within one process invalidates
        the model's fits (see ``LatencyCalibrator``)."""
        backend = getattr(model, "backend", None)
        bk = getattr(backend, "key", "?")
        return f"{bk}|ndev={self.n_devices}"

    def shard_width(self, bucket: int, group_size: int) -> int:
        """Devices a bucket actually shards over inside a ``group_size``
        group: the whole group when the batch divides evenly, else 1
        (replicated-batch execution keeps results bitwise-identical)."""
        g = max(1, int(group_size))
        return g if g > 1 and bucket % g == 0 else 1

    def sharded_accel_ms(self, model: RegisteredModel, bucket: int,
                         n_devices: int) -> float:
        """Accel-ms for a bucket data-parallel over ``n_devices``: devices
        run per-device microbatches concurrently, so the batch costs one
        microbatch (``bucket`` must divide evenly — see shard_width)."""
        assert bucket % n_devices == 0, (bucket, n_devices)
        return self.predicted_ms(model, bucket // n_devices)

    def expected_ms(self, model: RegisteredModel, batch: int,
                    n_devices: int = 1,
                    quantile: Optional[float] = None) -> Tuple[float, bool]:
        """(latency, calibrated?) — calibrated wall-ms once the calibrator
        has enough observations for this cell (or, during warm-up, the
        cross-model global ratio — simulator-relative pricing keeps every
        model in wall units as soon as ANY model is calibrated), raw
        accelerator-ms before.  ``quantile`` prices the Gaussian latency
        quantile instead of the mean (tail-aware admission); it only moves
        the estimate once a fit with residual variance is answering."""
        accel = self.sharded_accel_ms(model, batch, n_devices)
        if self.calibrator is not None:
            wall = self.calibrator.calibrated_ms(
                model.key, batch, accel, n_devices=n_devices,
                fingerprint=self.fingerprint(model), quantile=quantile)
            if wall is not None:
                return wall, True
        return accel, False

    def observe(self, model: RegisteredModel, batch: int,
                measured_ms: float, n_devices: int = 1,
                partial: bool = False) -> Optional[float]:
        """Feed one completed batch's measured wall latency back into the
        calibrator; returns the calibration residual when available.
        ``partial`` marks a mid-flight replan dispatch — monitored but
        excluded from the fits (see ``LatencyCalibrator.observe``)."""
        if self.calibrator is None:
            return None
        return self.calibrator.observe(
            model.key, batch, self.sharded_accel_ms(model, batch, n_devices),
            measured_ms, n_devices=n_devices,
            fingerprint=self.fingerprint(model), partial=partial)

    # -- scheduling ---------------------------------------------------------
    def plan_bucket(self, model: RegisteredModel, queued: int,
                    buckets: Sequence[int],
                    group_size: Optional[int] = None,
                    quantile: Optional[float] = None) -> BucketPlan:
        """Best bucket for ``queued`` waiting requests of one model on a
        ``group_size``-device group (default: the full mesh).

        Maximizes delivered images per predicted ms; ties break toward the
        smaller bucket (less padded compute, lower batch latency).
        ``quantile`` prices batches at a latency quantile instead of the
        mean (admission paths); scheduling calls leave it None.
        """
        assert queued >= 1
        g = self.n_devices if group_size is None else group_size
        best: Optional[BucketPlan] = None
        for b in sorted(buckets):
            e = self.shard_width(b, g)
            ms, cal = self.expected_ms(model, b, n_devices=e,
                                       quantile=quantile)
            plan = BucketPlan(b, min(queued, b), ms, cal, n_devices=e)
            if best is None or plan.imgs_per_ms > best.imgs_per_ms * (1 + 1e-9):
                best = plan
        assert best is not None
        return best

    def plan_round(self, models: Sequence[Tuple[RegisteredModel, int]],
                   buckets: Sequence[int],
                   quantile: Optional[float] = None,
                   weights: Optional[Dict[str, float]] = None) -> RoundPlan:
        """Compose one cross-model device round from ``models`` — FIFO-
        ordered (model, queued depth) pairs, every entry with depth >= 1.

        With ``round_planner="adaptive"`` (default) three composition
        families are scored in the cost model's best available unit
        (calibrated wall-ms once any model converged, accel-ms before) and
        the cheapest wins:

        * ``even`` — the structural split: ``round_groups`` equal
          contiguous groups, models dealt round-robin in FIFO order (the
          only composition the "fifo" planner ever emits);
        * ``uneven`` — one power-of-two group per model, sized proportional
          to queue depth (a hot model gets half the mesh while the long
          tail shares the rest);
        * ``serial`` — no split: every model's batch runs back-to-back on
          the full mesh (wins when per-group microbatches are too small to
          amortize dispatch, i.e. the split is *not* actually faster);
        * ``hybrid`` (``round_planner="hybrid"`` only) — groups may be
          uneven in size AND host several models back-to-back: every
          descending power-of-two partition of the mesh into *fewer*
          groups than models, models packed onto groups greedily by
          predicted work (LPT).  This is the composition family the other
          three cannot express: a group that finishes its one model early
          idles for the rest of the round, while a hybrid group runs a
          second model in that window.  Because a shared group's wall-ms
          is a SUM of batches — prediction errors add, and an optimistic
          mean would chase compositions that serialize more work — hybrid
          candidates are priced at the cost model's **admission quantile**
          (when the caller did not fix one), so the new family pays for
          its own serialization risk up front.

        Candidates are compared on predicted **ms per served request**
        (``predicted_ms / served``), not raw round latency — different
        compositions pick different buckets and so serve different request
        counts, and a tiny round that finishes quickly by serving almost
        nothing must not beat a full round (same delivered-throughput
        objective as ``plan_bucket``).  A non-structural candidate must
        beat the even split's score by ``switch_margin`` before it wins —
        the scores are calibrated estimates with noise, and the structural
        split is the warm, predictable default; ties and marginal wins
        keep it.  Every candidate's per-request score is recorded in
        ``RoundPlan.candidates``.

        ``weights`` (model key -> mean SLO-class weight of its queued
        requests, see ``tenancy.py``) turns the denominator into a
        *weighted* served count: an interactive request counts several
        batch ones, so under contention the composition that serves
        interactive-heavy queues wins the round even when its raw
        request count is lower.  None (or all-equal weights) reduces to
        plain ms-per-request — pre-tenancy behavior exactly."""
        assert models
        strategies = [("even", self._even_assignment(len(models)))]
        if self.round_planner in ("adaptive", "hybrid"):
            uneven = self._uneven_assignment(models)
            if uneven is not None:
                strategies.append(("uneven", uneven))
            if len(models) > 1 and self.n_devices >= 1 \
                    and strategies[0][1][1] != [self.n_devices]:
                strategies.append(
                    ("serial", ([0] * len(models), [self.n_devices])))
        if self.round_planner == "hybrid":
            hybrid = self._hybrid_assignment(models, buckets,
                                             quantile=quantile)
            if hybrid is not None:
                strategies.append(("hybrid", hybrid))
        best: Optional[RoundPlan] = None
        best_score = 0.0
        scores: Dict[str, float] = {}
        for name, (group_of, sizes) in strategies:
            plan = self._score_assignment(
                models, buckets, group_of, sizes, name,
                quantile=self._strategy_quantile(name, quantile))
            served = plan.served if not weights else sum(
                p.plan.served * weights.get(p.key, 1.0) for p in plan.parts)
            score = plan.predicted_ms / max(1, served)
            scores[name] = score
            if best is None:
                best, best_score = plan, score
                continue
            bar = best_score * ((1.0 - self.switch_margin)
                                if best.strategy == "even" else 1.0)
            if score < bar:
                best, best_score = plan, score
        assert best is not None
        best.candidates = scores
        return best

    def _strategy_quantile(self, strategy: str,
                           quantile: Optional[float]) -> Optional[float]:
        """The latency quantile one candidate family is priced at.  An
        explicit caller quantile (admission drains) applies everywhere;
        otherwise only hybrid compositions pay the admission quantile —
        their shared groups sum several batches' errors, so they must
        clear the tail-priced bar before displacing a composition scored
        at the mean."""
        if quantile is not None:
            return quantile
        return self.admission_quantile if strategy == "hybrid" else None

    def _even_assignment(self, n_models: int
                         ) -> Tuple[List[int], List[int]]:
        """(model -> group index, group sizes) for the structural even
        split: round_groups equal groups, models dealt round-robin."""
        k = round_groups(n_models, self.n_devices, self.group_granularity)
        return [i % k for i in range(n_models)], [self.n_devices // k] * k

    def _uneven_assignment(self, models: Sequence[Tuple[RegisteredModel, int]]
                           ) -> Optional[Tuple[List[int], List[int]]]:
        """One group per model, power-of-two sizes proportional to queue
        depth; None when no exact fill exists or it degenerates to the
        even split (nothing new to score).

        Groups are laid out largest-first on the device list, so the
        physical layout depends only on the size multiset — the finitely
        many descending power-of-two partitions of the mesh
        (``power_of_two_partitions``) — and ``warmup`` can precompile
        every group the planner will ever emit."""
        if len(models) < 2:
            return None
        by_model = uneven_sizes([max(1, depth) for _, depth in models],
                                self.n_devices, self.group_granularity)
        if by_model is None:
            return None
        order = sorted(range(len(by_model)),
                       key=lambda i: (-by_model[i], i))
        sizes = [by_model[i] for i in order]
        group_of = [0] * len(by_model)
        for grp, i in enumerate(order):
            group_of[i] = grp
        _, even_sizes = self._even_assignment(len(models))
        if sizes == even_sizes:
            return None
        return group_of, sizes

    def _hybrid_assignment(self, models: Sequence[Tuple[RegisteredModel,
                                                        int]],
                           buckets: Sequence[int],
                           quantile: Optional[float] = None
                           ) -> Optional[Tuple[List[int], List[int]]]:
        """Best hybrid composition: groups uneven in size AND hosting
        several models back-to-back.  The layout space is every descending
        power-of-two partition of the mesh into 2..len(models)-1 groups —
        fewer groups than models, so at least one group is shared (the
        one-group-per-model layouts are the uneven family, one group is
        serial).  Groups laid out largest-first keeps every reachable
        layout inside ``power_of_two_partitions``, the same finite set
        ``warmup`` precompiles for the uneven splits.

        Models are packed onto groups LPT-style: visited in decreasing
        standalone cost, each placed on the group whose load-after-adding
        is smallest (the cost of a model DEPENDS on its group's width —
        per-device microbatch pricing — so placement re-prices per
        candidate group).  Returns the argmin layout by predicted ms per
        served request, or None when no hybrid layout exists."""
        n = len(models)
        if n < 3 or self.n_devices < 2 * self.group_granularity:
            return None
        q = self._strategy_quantile("hybrid", quantile)
        # one bucket plan per (model, group width) serves the whole sweep:
        # packing and scoring both depend only on the width a model runs
        # at, so the partition enumeration must not re-sweep buckets (and
        # re-quote the calibrator) per layout — this memo is what keeps
        # hybrid planning cheap enough for the scheduler hot path
        plans: Dict[Tuple[int, int], BucketPlan] = {}

        def plan_for(i: int, width: int) -> BucketPlan:
            if (i, width) not in plans:
                model, depth = models[i]
                plans[(i, width)] = self.plan_bucket(
                    model, depth, buckets, group_size=width, quantile=q)
            return plans[(i, width)]

        best: Optional[Tuple[List[int], List[int]]] = None
        best_score = 0.0
        for k in range(2, n):
            for sizes in power_of_two_partitions(self.n_devices, k,
                                                 self.group_granularity):
                group_of = self._pack_lpt(
                    n, sizes, lambda i, w: plan_for(i, w).predicted_ms)
                group_ms = [0.0] * len(sizes)
                served = 0
                for i, grp in enumerate(group_of):
                    p = plan_for(i, sizes[grp])
                    group_ms[grp] += p.predicted_ms
                    served += p.served
                score = max(group_ms) / max(1, served)
                if best is None or score < best_score:
                    best, best_score = (group_of, list(sizes)), score
        return best

    def _pack_lpt(self, n_models: int, sizes: Sequence[int],
                  cost) -> List[int]:
        """Longest-processing-time packing of models onto sized groups:
        heaviest model first, each onto the group where its arrival leaves
        the smallest load.  ``cost(model index, group width) -> ms``
        re-prices per width (a batch's cost depends on how wide it
        shards)."""
        order = sorted(range(n_models), key=lambda i: (-cost(i, sizes[0]), i))
        load = [0.0] * len(sizes)
        group_of = [0] * n_models
        for i in order:
            grp = min(range(len(sizes)),
                      key=lambda g: (load[g] + cost(i, sizes[g]), g))
            group_of[i] = grp
            load[grp] += cost(i, sizes[grp])
        return group_of

    def _score_assignment(self, models: Sequence[Tuple[RegisteredModel, int]],
                          buckets: Sequence[int], group_of: List[int],
                          sizes: List[int], strategy: str,
                          quantile: Optional[float] = None) -> RoundPlan:
        """Price one composition: each model's batch planned for (and
        sharded over) its group, round latency = slowest group's serial
        sum."""
        parts: List[RoundPart] = []
        group_ms = [0.0] * len(sizes)
        for (model, depth), grp in zip(models, group_of):
            plan = self.plan_bucket(model, depth, buckets,
                                    group_size=sizes[grp], quantile=quantile)
            parts.append(RoundPart(model.key, plan, grp))
            group_ms[grp] += plan.predicted_ms
        return RoundPlan(parts, self.n_devices, len(sizes), max(group_ms),
                         group_sizes=list(sizes), strategy=strategy,
                         group_ms=group_ms)

    def drain_ms(self, model: RegisteredModel, queued: int,
                 buckets: Sequence[int],
                 group_size: Optional[int] = None,
                 quantile: Optional[float] = None) -> float:
        """Predicted time to serve ``queued`` requests with greedy batching
        on a ``group_size``-device group (default: the full mesh)."""
        total = 0.0
        remaining = queued
        while remaining > 0:
            plan = self.plan_bucket(model, remaining, buckets,
                                    group_size=group_size, quantile=quantile)
            total += plan.predicted_ms
            remaining -= plan.served
        return total

    def drain_rounds_ms(self, models: Sequence[Tuple[RegisteredModel, int]],
                        buckets: Sequence[int],
                        quantile: Optional[float] = None) -> float:
        """Predicted time for the round scheduler to drain a queue
        snapshot: rounds are composed exactly as ``plan_round`` would and
        their latencies summed until every model's depth reaches zero."""
        depths = [[model, depth] for model, depth in models if depth > 0]
        total = 0.0
        while depths:
            plan = self.plan_round([(m, d) for m, d in depths], buckets,
                                   quantile=quantile)
            total += plan.predicted_ms
            for entry, part in zip(depths, plan.parts):
                entry[1] -= part.plan.served
            depths = [e for e in depths if e[1] > 0]
        return total

    # -- admission ----------------------------------------------------------
    def admit(self, model: RegisteredModel, slo_ms: Optional[float],
              queued: int, buckets: Sequence[int],
              backlog_ms: float = 0.0,
              group_size: Optional[int] = None,
              quantile: Optional[float] = None) -> Tuple[bool, float]:
        """(admit?, predicted e2e ms) for a request arriving behind
        ``queued`` same-model requests and ``backlog_ms`` of predicted
        other-model/in-flight work the scheduler serves first.  Latencies
        are calibrated wall-ms once the calibrator has enough observations
        (accelerator-ms before).  No SLO -> always admitted.

        ``quantile`` (default: the cost model's ``admission_quantile``,
        p95) prices each batch of this model's drain at that Gaussian
        latency quantile using the calibrator's residual variance — an SLO
        is a promise about the tail, so admission must reason about the
        tail.  Per-batch quantiles summed over a drain over-estimate the
        drain's own quantile (quantiles are not additive); admission errs
        conservative by construction.  Pass 0.5 for the historical
        mean-based admit.

        ``group_size`` prices this model's own drain on the device group
        the round scheduler would currently assign it (the engine passes
        ``n_devices // round_groups(active models)``); defaulting to the
        full mesh would under-predict — and silently over-admit —
        whenever cross-model rounds place the model on a smaller group.
        The ``backlog_ms`` side errs the other way (round drains price
        group concurrency, in-flight work is charged serially).

        Mixed-units warm-up: while SOME models are calibrated and others
        are not, the calibrator's global cross-model ratio keeps the whole
        sum in wall-ms (simulator-relative pricing times one machine
        scale).  Only before ANY model has ``min_samples`` observations do
        estimates remain raw accel-ms — warm traffic (the launcher's
        ``--warm-bursts``) closes that window after one burst of any
        single model."""
        q = self.admission_quantile if quantile is None else quantile
        predicted = backlog_ms + self.drain_ms(model, queued + 1, buckets,
                                               group_size=group_size,
                                               quantile=q)
        if slo_ms is None:
            return True, predicted
        return predicted <= slo_ms, predicted
