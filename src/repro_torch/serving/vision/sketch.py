"""Streaming quantile estimation for the serving control plane.

The latency calibrator used to summarize fit residuals with a single
variance and quote tails as ``scale * accel + z_q * resid_std`` — a
Gaussian assumption that is simply wrong for serving wall-clock: GC
pauses, shared-core throttling, and co-scheduled rounds make wall-ms
heavy-tailed, and a Gaussian p95 can sit a factor of 2-4 away from the
observed one (over- OR under-pricing admission, depending on the skew
direction).  This module provides the replacement: the **P²
(piecewise-parabolic) algorithm** of Jain & Chlamtac (1985) — a streaming
quantile estimator with O(1) memory per tracked quantile (five markers),
no sample storage, and deterministic results for a deterministic input
stream.

``P2Quantile`` tracks ONE quantile; ``QuantileSketch`` bundles a small
set of tracked quantiles (p50/p90/p95/p99 by default) behind one ``add``
and interpolates queries between tracked points.  Everything here is
plain Python floats — no numpy, no jax — because it runs under the
calibrator's lock on the completion path.

Merging: P² markers are not mergeable exactly (they are positions in a
stream, not sufficient statistics).  ``QuantileSketch.merge_from``
re-inserts the other sketch's marker heights weighted by its count — an
approximation that preserves location and spread well enough for the
calibrator's pooled fallback fits, and is deterministic.  Exactness lives
in the per-cell sketches that see every residual directly.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEFAULT_QUANTILES: Tuple[float, ...] = (0.5, 0.9, 0.95, 0.99)


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


class P2Quantile:
    """P² streaming estimator for a single quantile ``p``.

    The first five observations are kept verbatim (nearest-rank answers
    during that window); from the sixth on, five markers track the
    running min, the p/2, p, and (1+p)/2 quantiles, and the max,
    adjusted per observation with a piecewise-parabolic update.  O(1)
    memory, O(1) per observation, deterministic."""

    def __init__(self, p: float):
        assert 0.0 < p < 1.0, p
        self.p = p
        self.n = 0                       # observations seen
        self._q: List[float] = []        # marker heights
        self._pos: List[float] = []      # marker positions (1-based counts)
        self._want: List[float] = []     # desired positions
        self._dwant = [0.0, p / 2.0, p, (1.0 + p) / 2.0, 1.0]

    def add(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if self.n <= 5:
            self._q.append(x)
            self._q.sort()
            if self.n == 5:
                p = self.p
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                self._want = [1.0, 1.0 + 2.0 * p, 1.0 + 4.0 * p,
                              3.0 + 2.0 * p, 5.0]
            return
        q, pos = self._q, self._pos
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and not (q[k] <= x < q[k + 1]):
                k += 1
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            self._want[i] += self._dwant[i]
        for i in (1, 2, 3):
            d = self._want[i] - pos[i]
            if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or \
                    (d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                d = 1.0 if d > 0 else -1.0
                qp = self._parabolic(i, d)
                if q[i - 1] < qp < q[i + 1]:
                    q[i] = qp
                else:
                    q[i] = self._linear(i, d)
                pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        q, n = self._q, self._pos
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        q, n = self._q, self._pos
        j = i + (1 if d > 0 else -1)
        return q[i] + d * (q[j] - q[i]) / (n[j] - n[i])

    @property
    def value(self) -> Optional[float]:
        """Current estimate of the tracked quantile (None before any
        observation; nearest-rank on the buffered head before the
        markers form)."""
        if self.n == 0:
            return None
        if self.n < 5:
            xs = sorted(self._q)
            rank = min(len(xs) - 1, max(0, round(self.p * (len(xs) - 1))))
            return xs[int(rank)]
        return self._q[2]

    def marker_points(self) -> List[Tuple[float, float]]:
        """(value, cumulative fraction) pairs of the current markers — an
        empirical-CDF skeleton of the stream (exact ranks while the first
        five observations are still buffered).  ``QuantileSketch`` unions
        these across trackers to reconstruct a mergeable CDF."""
        if self.n == 0:
            return []
        if self.n < 5:
            xs = sorted(self._q)
            return [(x, (i + 0.5) / len(xs)) for i, x in enumerate(xs)]
        return [(self._q[i], self._pos[i] / self.n) for i in range(5)]


class QuantileSketch:
    """A bundle of P² estimators over a fixed tracked-quantile grid.

    ``add`` feeds every tracker; ``quantile(q)`` answers an arbitrary q
    by linear interpolation between the two nearest tracked quantiles
    (clamped to the grid's ends), returning None until ``min_count``
    observations have arrived — the caller keeps its warm-up fallback
    (the calibrator's Gaussian term) until the sketch is trustworthy."""

    def __init__(self, quantiles: Sequence[float] = DEFAULT_QUANTILES,
                 min_count: int = 8):
        assert quantiles == tuple(sorted(quantiles)), quantiles
        self.quantiles = tuple(quantiles)
        self.min_count = max(1, int(min_count))
        self._trackers: Dict[float, P2Quantile] = {
            p: P2Quantile(p) for p in self.quantiles}
        self.count = 0

    def add(self, x: float) -> None:
        self.count += 1
        for t in self._trackers.values():
            t.add(x)

    @property
    def active(self) -> bool:
        """Whether quantile() answers (count >= min_count)."""
        return self.count >= self.min_count

    def quantile(self, q: float) -> Optional[float]:
        assert 0.0 < q < 1.0, q
        if not self.active:
            return None
        qs = self.quantiles
        if q <= qs[0]:
            return self._trackers[qs[0]].value
        if q >= qs[-1]:
            return self._trackers[qs[-1]].value
        for lo, hi in zip(qs, qs[1:]):
            if lo <= q <= hi:
                vlo = self._trackers[lo].value
                vhi = self._trackers[hi].value
                assert vlo is not None and vhi is not None
                w = (q - lo) / (hi - lo)
                return vlo + w * (vhi - vlo)
        raise AssertionError(q)     # unreachable: grid covers (qs[0], qs[-1])

    # samples re-drawn per source sketch in a merge: the global pooled
    # fallback merges on the query path during warm-up, and an uncapped
    # resample of a long-running sketch would cost O(count) marker
    # updates per query
    MERGE_SAMPLE_CAP = 160

    def cdf_points(self) -> List[Tuple[float, float]]:
        """The union of every tracker's (value, cumulative fraction)
        markers, sorted by value with fractions forced monotone — a
        piecewise-linear empirical CDF of the stream."""
        pts: List[Tuple[float, float]] = []
        for p in self.quantiles:
            pts.extend(self._trackers[p].marker_points())
        pts.sort()
        out: List[Tuple[float, float]] = []
        hi = 0.0
        for v, f in pts:
            hi = max(hi, f)
            out.append((v, hi))
        return out

    def sample_values(self, k: int) -> List[float]:
        """``k`` values drawn at evenly spaced cumulative fractions from
        the reconstructed CDF — a deterministic resampling of the stream
        this sketch summarizes (used by merges)."""
        pts = self.cdf_points()
        if not pts or k <= 0:
            return []
        out: List[float] = []
        j = 0
        for i in range(k):
            f = (i + 0.5) / k
            while j + 1 < len(pts) and pts[j + 1][1] < f:
                j += 1
            if f <= pts[0][1]:
                out.append(pts[0][0])
            elif j + 1 >= len(pts):
                out.append(pts[-1][0])
            else:
                (v0, f0), (v1, f1) = pts[j], pts[j + 1]
                w = 0.0 if f1 <= f0 else (f - f0) / (f1 - f0)
                out.append(v0 + w * (v1 - v0))
        return out

    def merge_from(self, others: Iterable["QuantileSketch"]) -> None:
        """Fold other sketches into this one by resampling each one's
        reconstructed CDF (approximate: P² markers are not sufficient
        statistics — see module docstring).  Sample counts are
        proportional to each source's observation count (capped), and the
        combined resample is re-inserted in a deterministic stride
        permutation: per-source the resample comes out sorted and the
        sources would otherwise arrive one after another — both are worst
        cases for P² marker adjustment, and the permutation interleaves
        everything."""
        sources = [o for o in others if o.count > 0]
        if not sources:
            return
        cmax = max(o.count for o in sources)
        vals: List[float] = []
        for o in sources:
            k = min(o.count,
                    max(1, round(self.MERGE_SAMPLE_CAP * o.count / cmax)))
            vals.extend(o.sample_values(k))
        k = len(vals)
        stride = max(1, round(k * 0.618))
        while _gcd(stride, k) != 1:
            stride += 1
        for i in range(k):
            self.add(vals[(i * stride) % k])

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {"n": self.count}
        if self.active:
            for p in self.quantiles:
                v = self._trackers[p].value
                out[f"p{round(p * 100)}"] = v if v is not None else 0.0
        return out
