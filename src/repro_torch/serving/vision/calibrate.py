"""Online calibration of ST-OS accelerator predictions to host wall latency.

Units: the simulator prices every (model, batch bucket) in **accelerator
milliseconds** (accel-ms) on the paper's 16x16 array; measurements arrive in
**wall milliseconds** (wall-ms) on whatever machine actually executes the
batch; this module is the only place the two meet.  The machine executing a
batch (CPU interpret mode today, a real TPU tomorrow) has its own clock, so
scheduling decisions made in accel-ms and SLOs expressed in wall-ms disagree
by an unknown machine-dependent factor.  This module closes the loop: every
completed batch contributes an (accel-ms, measured wall-ms) observation, and
once a cell has enough samples the cost model quotes calibrated wall
milliseconds instead.

Fit shape: through-origin least squares ``wall = s * accel`` maintained
online per (model, bucket, n_devices) with running sums (no sample
storage)::

    s = sum(accel * wall) / sum(accel^2)

Tail awareness: every fit also tracks ``sum(wall^2)``, from which the
residual variance of the through-origin fit falls out analytically
(``SSE = sum_yy - sum_xy^2 / sum_xx``), *and* a streaming P² quantile
sketch of its residuals (``sketch.py``).  ``calibrated_ms(..., quantile=q)``
quotes ``scale * accel + resid_quantile(q)`` straight from the sketch once
it has enough observations; before that it falls back to the closed-form
Gaussian term ``z_q * resid_std``.  The distinction matters because
serving wall-ms is heavy-tailed (GC pauses, shared-core throttling,
co-scheduled rounds), and a Gaussian p95 can sit a factor of 2-4 away from
the observed one — over- or under-pricing SLO admission depending on the
skew direction — while the sketch reads the p95 off the residual stream
directly.  ``quantile=None`` (or 0.5 under the Gaussian fallback) keeps
the mean estimate.

The accelerator prediction for one cell is a constant, so the
through-origin fit degenerates gracefully to the ratio-of-means estimator —
exactly the right thing — while staying well-defined when the predictor
varies (e.g. after a simulator-config change mid-process).  A pooled
per-(model, n_devices) fit over all of that model's observations backs up
buckets that have not individually converged yet, so bucket selection never
compares calibrated wall-ms for one bucket against raw accelerator-ms for
another.  One level further out, a **global** ratio pooled over every
calibrated model (same fingerprint) backs up models with no observations at
all: the simulator already prices models *relative to each other*, so one
machine-wide accel->wall scale pins the units for the whole fleet.  This
closes the warm-up window where a cross-model admission backlog used to mix
wall-ms and accel-ms until every model had served ``min_samples`` batches.  ``n_devices`` is part of the key because a batch sharded over a
device group has a different accel->wall scale than the same bucket on one
device (per-device microbatches, collective/dispatch overheads).

Drift: fits are tagged with a per-model **fingerprint** (backend + mesh
shape, supplied by the cost model).  An observation or query carrying a
different fingerprint than the one a model's fits were built under drops
those fits — a backend or mesh change within one process must not serve
SLO admission from stale scales (previously stale fits survived such a
change for the whole process lifetime).

Thread safety: ``observe`` runs on the engine's completion thread while
``calibrated_ms`` serves admission control on caller threads; all state is
guarded by one lock.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading
from statistics import NormalDist
from typing import Dict, List, Optional, Tuple

from .sketch import QuantileSketch


@functools.lru_cache(maxsize=64)
def z_score(quantile: float) -> float:
    """Standard-normal z for a latency quantile in (0, 1); 0.5 -> 0 (mean).
    Cached: quantile quotes run on the scheduler hot path (every tail-
    priced bucket sweep), and serving uses a handful of distinct
    quantiles per process."""
    assert 0.0 < quantile < 1.0, quantile
    return NormalDist().inv_cdf(quantile)


@dataclasses.dataclass
class _Fit:
    """Running through-origin least-squares accumulator with residual
    variance (``sum_yy`` makes ``SSE = sum_yy - sum_xy^2 / sum_xx`` exact
    without storing samples)."""
    n: int = 0
    sum_xy: float = 0.0
    sum_xx: float = 0.0
    sum_yy: float = 0.0
    sum_abs_resid: float = 0.0     # |measured - fit-at-observation-time|
    # streaming quantiles of the signed residuals (measured minus this
    # fit's own pre-update prediction); answers tail quotes directly once
    # it has ``min_count`` observations, Gaussian z*resid_std before that
    sketch: QuantileSketch = dataclasses.field(default_factory=QuantileSketch)

    def add(self, x: float, y: float) -> None:
        self.n += 1
        self.sum_xy += x * y
        self.sum_xx += x * x
        self.sum_yy += y * y

    @property
    def scale(self) -> Optional[float]:
        if self.n == 0 or self.sum_xx <= 0.0:
            return None
        return self.sum_xy / self.sum_xx

    @property
    def resid_var(self) -> float:
        """Unbiased residual variance of the through-origin fit (ms^2);
        0 until two observations exist (one point fits exactly)."""
        if self.n < 2 or self.sum_xx <= 0.0:
            return 0.0
        sse = self.sum_yy - self.sum_xy * self.sum_xy / self.sum_xx
        return max(0.0, sse / (self.n - 1))

    @property
    def resid_std(self) -> float:
        return math.sqrt(self.resid_var)

    def quote(self, accel_ms: float,
              quantile: Optional[float] = None) -> Optional[float]:
        """Wall-ms estimate at ``quantile`` (None -> mean fit).  The tail
        term comes from the residual sketch when it is active (observed
        quantile, honest under heavy tails), else the Gaussian
        ``z * resid_std`` closed form (warm-up)."""
        scale = self.scale
        if scale is None:
            return None
        ms = scale * accel_ms
        if quantile is not None:
            tail = (self.sketch.quantile(quantile)
                    if self.sketch.active else None)
            if tail is None:
                tail = z_score(quantile) * self.resid_std
            ms += tail
        return ms

    def summary(self) -> Dict[str, float]:
        out = {"n": self.n, "scale": self.scale if self.scale else 0.0,
               "resid_var_ms2": self.resid_var,
               "resid_std_ms": self.resid_std,
               "mean_abs_resid_ms": (self.sum_abs_resid / self.n
                                     if self.n else 0.0)}
        if self.sketch.active:
            for label, v in self.sketch.summary().items():
                if label != "n":
                    out[f"resid_{label}_ms"] = v
        return out


def _combined(fits: List[_Fit]) -> _Fit:
    """Pool several through-origin fits into one (sums are sufficient
    statistics, so pooling is exact for the combined sample; the residual
    sketches merge approximately — see ``sketch.py``)."""
    tot = _Fit()
    for f in fits:
        tot.n += f.n
        tot.sum_xy += f.sum_xy
        tot.sum_xx += f.sum_xx
        tot.sum_yy += f.sum_yy
    tot.sketch.merge_from(f.sketch for f in fits if f.sketch.count)
    return tot


class LatencyCalibrator:
    """Online accel-ms -> wall-ms calibration per (model, bucket, devices)."""

    def __init__(self, min_samples: int = 3):
        assert min_samples >= 1
        self.min_samples = min_samples
        self._cells: Dict[Tuple[str, int, int], _Fit] = {}
        self._pooled: Dict[Tuple[str, int], _Fit] = {}
        self._fps: Dict[str, str] = {}       # model key -> fit fingerprint
        self._invalidations = 0
        # partial-round observations (mid-flight replan dispatches) are
        # monitored but never folded into the fits: a backfilled batch
        # runs back-to-back behind its group's scheduled parts, so its
        # measured wall-ms includes queueing the round-level fits must
        # not learn as compute
        self._partial_n = 0
        self._partial_abs_resid = 0.0
        self._lock = threading.Lock()

    # -- drift ----------------------------------------------------------------
    def _check_fingerprint_locked(self, key: str,
                                  fingerprint: Optional[str]) -> bool:
        """True when ``key``'s fits are valid under ``fingerprint``.  A
        mismatching fingerprint drops the model's fits (drift: the backend
        or mesh changed since they were built)."""
        if fingerprint is None:
            return True
        prev = self._fps.get(key)
        if prev is None:
            self._fps[key] = fingerprint
            return True
        if prev == fingerprint:
            return True
        self._drop_locked(key)
        self._fps[key] = fingerprint
        self._invalidations += 1
        return False

    def _drop_locked(self, key: str) -> None:
        for cell_key in [ck for ck in self._cells if ck[0] == key]:
            del self._cells[cell_key]
        for pool_key in [pk for pk in self._pooled if pk[0] == key]:
            del self._pooled[pool_key]

    @property
    def invalidations(self) -> int:
        """How many times a fingerprint mismatch dropped a model's fits."""
        with self._lock:
            return self._invalidations

    def invalidate(self, key: Optional[str] = None) -> None:
        """Manually drop fits for one model (or every model)."""
        with self._lock:
            keys = [key] if key is not None else \
                list({ck[0] for ck in self._cells}
                     | {pk[0] for pk in self._pooled})
            for k in keys:
                self._drop_locked(k)
                self._fps.pop(k, None)

    # -- intake ---------------------------------------------------------------
    def observe(self, key: str, bucket: int, accel_ms: float,
                wall_ms: float, n_devices: int = 1,
                fingerprint: Optional[str] = None,
                partial: bool = False) -> Optional[float]:
        """Record one completed batch; returns the residual (measured minus
        the calibrated prediction *before* this observation) once this
        model is calibrated, else None.  The residual is charged against
        whichever fit ``calibrated_ms`` would have quoted — the cell's own
        fit, or the pooled per-model fallback — so pooled-regime SLO
        decisions are monitored too.  A ``fingerprint`` differing from the
        one this model's fits were built under drops them first (drift).

        ``partial=True`` marks a partial-round dispatch (the executor's
        mid-flight replanner backfilling an idle group): the residual is
        still computed and monitored, but the observation is NOT folded
        into any fit — a backfilled batch is dispatched behind its group's
        scheduled work, so its measured wall-ms carries queueing time that
        would bias every round-level scale upward."""
        with self._lock:
            self._check_fingerprint_locked(key, fingerprint)
            # .get, not setdefault: a partial observation must not create
            # phantom n=0 cells that snapshot() would then report
            cell = self._cells.get((key, bucket, n_devices))
            pooled = self._pooled.get((key, n_devices))
            fit = None
            if cell is not None and cell.n >= self.min_samples \
                    and cell.scale is not None:
                fit = cell
            elif pooled is not None and pooled.n >= self.min_samples \
                    and pooled.scale is not None:
                fit = pooled
            resid = None
            if fit is not None:
                resid = wall_ms - fit.scale * accel_ms
            if partial:
                self._partial_n += 1
                if resid is not None:
                    self._partial_abs_resid += abs(resid)
                return resid
            if cell is None:
                cell = self._cells.setdefault((key, bucket, n_devices),
                                              _Fit())
            if pooled is None:
                pooled = self._pooled.setdefault((key, n_devices), _Fit())
            if resid is not None:
                fit.sum_abs_resid += abs(resid)
            # each converged fit sketches its OWN pre-update residual
            # (wall minus its own scale's prediction), so a fit's quantile
            # quotes describe the errors that fit actually makes —
            # a drift drop discards the sketches with the fits
            for f in (cell, pooled):
                if f.n >= self.min_samples and f.scale is not None:
                    f.sketch.add(wall_ms - f.scale * accel_ms)
            cell.add(accel_ms, wall_ms)
            pooled.add(accel_ms, wall_ms)
            return resid

    # -- queries --------------------------------------------------------------
    def is_calibrated(self, key: str, bucket: int,
                      n_devices: int = 1) -> bool:
        with self._lock:
            cell = self._cells.get((key, bucket, n_devices))
            return (cell is not None and cell.n >= self.min_samples
                    and cell.scale is not None)

    def calibrated_ms(self, key: str, bucket: int, accel_ms: float,
                      n_devices: int = 1,
                      fingerprint: Optional[str] = None,
                      quantile: Optional[float] = None) -> Optional[float]:
        """Calibrated wall-ms for an accelerator prediction, or None.

        Resolution order: the (model, bucket, n_devices) cell once it has
        ``min_samples`` observations, else the pooled per-(model,
        n_devices) fit once *it* has ``min_samples`` (keeps every bucket of
        a model in the same units as soon as any bucket has data), else the
        model's best-sampled pooled fit at ANY mesh width, else the
        **global** cross-model ratio (every same-fingerprint model's
        observations pooled — the simulator's relative pricing plus one
        machine scale), else None (caller falls back to raw accel-ms).

        The cross-width fallback matters for SLO admission under sharding:
        admission prices a model's drain on the full mesh, but cross-model
        rounds execute it on smaller groups, so the full-mesh cells may
        never accumulate samples.  A scale borrowed from another width or
        model is approximate (per-width dispatch overheads and per-model
        fit quality differ) but keeps the whole admission sum in wall-ms —
        raw accel-ms would be orders of magnitude off and silently
        over-admit.  A mismatching ``fingerprint`` drops the stale fits.

        ``quantile`` (e.g. 0.95) adds ``z * resid_std`` of whichever fit
        answered, turning the mean estimate into a Gaussian tail quantile
        for tail-aware SLO admission; None keeps the mean."""
        with self._lock:
            if not self._check_fingerprint_locked(key, fingerprint):
                return None
            fit = self._resolve_fit_locked(key, bucket, n_devices,
                                           fingerprint)
            if fit is None:
                return None
            return fit.quote(accel_ms, quantile)

    def _resolve_fit_locked(self, key: str, bucket: int, n_devices: int,
                            fingerprint: Optional[str]) -> Optional[_Fit]:
        cell = self._cells.get((key, bucket, n_devices))
        if cell is not None and cell.n >= self.min_samples \
                and cell.scale is not None:
            return cell
        pooled = self._pooled.get((key, n_devices))
        if pooled is not None and pooled.n >= self.min_samples \
                and pooled.scale is not None:
            return pooled
        others = [f for (k, nd), f in self._pooled.items()
                  if k == key and f.n >= self.min_samples
                  and f.scale is not None]
        if others:
            return max(others, key=lambda f: f.n)
        glob = self._global_fit_locked(fingerprint)
        if glob.n >= self.min_samples and glob.scale is not None:
            return glob
        return None

    def _global_fit_locked(self, fingerprint: Optional[str]) -> _Fit:
        """Every pooled observation under ``fingerprint`` combined into one
        cross-model fit (all of them when fingerprint is None).  Derived
        from the surviving pooled fits on every query, so drift drops and
        invalidations are reflected automatically."""
        return _combined([
            f for (k, nd), f in self._pooled.items()
            if fingerprint is None or self._fps.get(k) in (None, fingerprint)
        ])

    def global_scale(self, fingerprint: Optional[str] = None
                     ) -> Optional[float]:
        """The machine-wide accel->wall ratio (None until ``min_samples``
        observations exist across all same-fingerprint models)."""
        with self._lock:
            glob = self._global_fit_locked(fingerprint)
            if glob.n >= self.min_samples:
                return glob.scale
            return None

    def snapshot(self) -> Dict:
        """{model: {"pooled": fit, "buckets": {label: fit}}} summaries plus
        a ``"global"`` cross-model fit.  Every fit summary carries the
        residual variance/std alongside the scale, so a dumped metrics
        snapshot is self-describing about how tight each calibration is.
        Bucket labels are strings: ``"<bucket>"`` for single-device cells,
        ``"<bucket>x<n_devices>"`` for sharded ones (and sharded pooled
        fits ``"pooled@x<n_devices>"``)."""
        with self._lock:
            out: Dict[str, Dict] = {}
            glob = self._global_fit_locked(None)
            if glob.n:
                out["global"] = glob.summary()
            if self._partial_n:
                out["partial"] = {
                    "n": self._partial_n,
                    "mean_abs_resid_ms": (self._partial_abs_resid
                                          / self._partial_n)}
            for (key, nd), fit in self._pooled.items():
                entry = out.setdefault(key, {"pooled": {}, "buckets": {}})
                if nd == 1:
                    entry["pooled"] = fit.summary()
                else:
                    entry[f"pooled@x{nd}"] = fit.summary()
            for (key, bucket, nd), fit in self._cells.items():
                s = fit.summary()
                s["calibrated"] = fit.n >= self.min_samples
                entry = out.setdefault(key, {"pooled": {}, "buckets": {}})
                label = str(bucket) if nd == 1 else f"{bucket}x{nd}"
                entry["buckets"][label] = s
            for key, fp in self._fps.items():
                if key in out:
                    out[key]["fingerprint"] = fp
            return out
