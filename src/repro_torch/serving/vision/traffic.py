"""Synthetic traffic generation shared by the example, launcher, and bench.

Port of ``repro.serving.vision.traffic`` (numpy only, kept as the port's
own copy): the same seed gives the same items and traces in both
packages.

One canonical mixed burst: round-robin across the registry's models (or a
weighted draw — the multi-model serving workload), image extents drawn
uniformly from [res/2, 2*res) so every request exercises the batcher's
letterboxing, pixels standard-normal.  Deterministic per seed.

``make_mixed_burst`` only builds the items (so benchmarks can pre-generate
traffic outside the timed region); ``submit_mixed_burst`` builds and
submits them.  All times here are wall-clock seconds/ms (open-loop
inter-arrival gaps); no accelerator units enter this module.

Multi-tenant traces: open-loop streams are honest only if the arrival
process is — DRACO and DeepDive both show accelerator utilization claims
evaporating under the workloads real deployments see, so ``TenantSpec`` +
``make_tenant_trace`` generate per-tenant arrival-time traces from four
adversarial patterns (all deterministic per seed, gaps in wall-ms):

* ``poisson`` — memoryless baseline (exponential gaps at ``rate_rps``);
* ``bursty``  — on/off: bursts of ~``burst_len`` back-to-back arrivals
  (fast ``burst_gap_ms`` gaps) separated by idle ~``burst_every_ms``;
* ``diurnal`` — non-homogeneous Poisson thinned against a sinusoidal
  day curve (``period_ms``), peak rate = ``rate_rps``;
* ``heavy_tail`` — Pareto(``alpha``) gaps: calm stretches punctured by
  very long silences followed by pile-ups (the GC-pause shape, α <= 2
  has infinite variance).

``submit_trace`` merges several tenants' traces into one global
arrival-ordered stream and plays it against an engine, carrying each
tenant's model mix, SLO class, and SLO budget through ``engine.submit``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


def make_mixed_burst(registry, n: int, *, seed: int = 0,
                     weights: Optional[Sequence[float]] = None
                     ) -> List[Tuple[str, np.ndarray]]:
    """``n`` mixed-size requests as [(model key, image)], not submitted.

    ``weights`` (one per registry model, any positive scale) skews the
    model mix — the multi-model serving workload where a hot model
    dominates but every model keeps a steady trickle.  Default: strict
    round-robin (every model equally loaded)."""
    rng = np.random.default_rng(seed)
    keys = registry.keys()
    if weights is not None:
        assert len(weights) == len(keys), (len(weights), len(keys))
        p = np.asarray(weights, np.float64)
        p = p / p.sum()
        picks = rng.choice(len(keys), size=n, p=p)
    else:
        picks = [i % len(keys) for i in range(n)]
    out: List[Tuple[str, np.ndarray]] = []
    for i in range(n):
        key = keys[int(picks[i])]
        res = registry.get(key).resolution
        h = int(rng.integers(res // 2, res * 2))
        w = int(rng.integers(res // 2, res * 2))
        out.append((key, rng.standard_normal((h, w, 3), dtype=np.float32)))
    return out


def submit_mixed_burst(engine, n: int, *, seed: int = 0,
                       slo_ms: Optional[float] = None
                       ) -> List[Tuple[int, str, np.ndarray]]:
    """Submit ``n`` mixed-size requests; returns [(rid, model key, image)]."""
    return [(engine.submit(key, img, slo_ms=slo_ms), key, img)
            for key, img in make_mixed_burst(engine.registry, n, seed=seed)]


def stream_items(engine, items: List[Tuple[str, np.ndarray]], *,
                 interarrival_ms: float = 0.0,
                 slo_ms: Optional[float] = None
                 ) -> List[Tuple[int, str, np.ndarray]]:
    """Submit pre-built (model key, image) items open-loop at a fixed rate.

    Models offered load: item i is submitted ``i * interarrival_ms`` after
    the first, regardless of how fast the engine drains — the client does
    not wait for completions.  A pipelined engine executes batches inside
    the arrival gaps; a synchronous engine can only start computing once
    the caller stops submitting and flushes.
    """
    import time
    out: List[Tuple[int, str, np.ndarray]] = []
    t0 = time.perf_counter()
    for i, (key, img) in enumerate(items):
        target = t0 + i * interarrival_ms / 1e3
        delay = target - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        out.append((engine.submit(key, img, slo_ms=slo_ms), key, img))
    return out


def stream_mixed_burst(engine, n: int, *, seed: int = 0,
                       interarrival_ms: float = 0.0,
                       slo_ms: Optional[float] = None,
                       ) -> List[Tuple[int, str, np.ndarray]]:
    """The canonical mixed burst, submitted open-loop (see stream_items)."""
    return stream_items(engine,
                        make_mixed_burst(engine.registry, n, seed=seed),
                        interarrival_ms=interarrival_ms, slo_ms=slo_ms)


# ---------------------------------------------------------------------------
# Multi-tenant adversarial arrival traces.
# ---------------------------------------------------------------------------

ARRIVAL_PATTERNS = ("poisson", "bursty", "diurnal", "heavy_tail")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's offered load: an arrival pattern plus the service
    terms every generated request carries (SLO class / budget, model
    mix).  ``weights`` skews the tenant's model draw exactly like
    ``make_mixed_burst``; None = round-robin."""
    name: str
    pattern: str = "poisson"         # one of ARRIVAL_PATTERNS
    rate_rps: float = 100.0          # mean (peak, for diurnal) arrivals/sec
    slo_class: str = "batch"
    slo_ms: Optional[float] = None
    weights: Optional[Sequence[float]] = None
    # bursty knobs
    burst_len: int = 8               # mean arrivals per burst
    burst_gap_ms: float = 0.1        # intra-burst gap
    burst_every_ms: float = 200.0    # mean burst-to-burst spacing
    # diurnal knobs
    period_ms: float = 1000.0        # one "day"
    # heavy_tail knobs
    alpha: float = 1.5               # Pareto shape (<= 2: infinite variance)

    def __post_init__(self):
        assert self.pattern in ARRIVAL_PATTERNS, self.pattern
        assert self.rate_rps > 0.0, self


def _arrival_times_ms(spec: TenantSpec, n: int,
                      rng: np.random.Generator) -> np.ndarray:
    """``n`` monotone arrival times (wall-ms from trace start) drawn from
    the spec's pattern.  Deterministic given the rng state."""
    mean_gap = 1e3 / spec.rate_rps
    if spec.pattern == "poisson":
        gaps = rng.exponential(mean_gap, n)
        return np.cumsum(gaps)
    if spec.pattern == "bursty":
        times: List[float] = []
        t = 0.0
        while len(times) < n:
            t += rng.exponential(spec.burst_every_ms)
            burst = t
            for _ in range(max(1, int(rng.geometric(
                    1.0 / max(1, spec.burst_len))))):
                if len(times) >= n:
                    break
                times.append(burst)
                burst += spec.burst_gap_ms
        return np.asarray(times[:n])
    if spec.pattern == "diurnal":
        # thinning: candidate Poisson stream at the peak rate, kept with
        # probability = the sinusoidal day curve at its arrival time
        times = []
        t = 0.0
        while len(times) < n:
            t += rng.exponential(mean_gap)
            day = 0.5 * (1.0 + np.sin(2.0 * np.pi * t / spec.period_ms))
            if rng.random() < day:
                times.append(t)
        return np.asarray(times)
    assert spec.pattern == "heavy_tail", spec.pattern
    # Pareto gaps scaled so the mean gap matches rate_rps when finite
    # (alpha > 1); alpha <= 1 keeps the raw scale (mean is infinite)
    scale = mean_gap * ((spec.alpha - 1.0) / spec.alpha
                        if spec.alpha > 1.0 else 1.0)
    gaps = scale * (1.0 + rng.pareto(spec.alpha, n))
    return np.cumsum(gaps)


def make_tenant_trace(registry, specs: Sequence[TenantSpec],
                      n_per_tenant: int, *, seed: int = 0
                      ) -> List[Tuple[float, TenantSpec, str, np.ndarray]]:
    """A merged, arrival-ordered trace: [(t_ms, tenant spec, model key,
    image)] with ``n_per_tenant`` requests per tenant.  Each tenant draws
    from an independent deterministic substream (seed + tenant index), so
    adding a tenant never perturbs another's trace."""
    merged: List[Tuple[float, int, TenantSpec, str, np.ndarray]] = []
    keys = registry.keys()
    for ti, spec in enumerate(specs):
        rng = np.random.default_rng(seed * 7919 + ti)
        times = _arrival_times_ms(spec, n_per_tenant, rng)
        if spec.weights is not None:
            assert len(spec.weights) == len(keys)
            p = np.asarray(spec.weights, np.float64)
            picks = rng.choice(len(keys), size=n_per_tenant, p=p / p.sum())
        else:
            picks = [i % len(keys) for i in range(n_per_tenant)]
        for i in range(n_per_tenant):
            key = keys[int(picks[i])]
            res = registry.get(key).resolution
            h = int(rng.integers(res // 2, res * 2))
            w = int(rng.integers(res // 2, res * 2))
            img = rng.standard_normal((h, w, 3), dtype=np.float32)
            merged.append((float(times[i]), ti, spec, key, img))
    # tenant index breaks timestamp ties deterministically
    merged.sort(key=lambda item: (item[0], item[1]))
    return [(t, spec, key, img) for t, _ti, spec, key, img in merged]


def submit_trace(engine, trace: Sequence[Tuple[float, TenantSpec, str,
                                               np.ndarray]], *,
                 realtime: bool = True
                 ) -> List[Tuple[int, str, np.ndarray]]:
    """Play a merged tenant trace against an engine, open-loop: request i
    is submitted at its trace time (``realtime=False`` submits
    back-to-back — the fake-clock test path, where queue pressure comes
    from the trace's ordering alone).  Each submit carries its tenant's
    SLO class, SLO budget, and tenant tag; returns [(rid, model key,
    image)] in submission order."""
    import time
    out: List[Tuple[int, str, np.ndarray]] = []
    t0 = time.perf_counter()
    for t_ms, spec, key, img in trace:
        if realtime:
            delay = t0 + t_ms / 1e3 - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
        out.append((engine.submit(key, img, spec.slo_ms,
                                  slo_class=spec.slo_class,
                                  tenant=spec.name), key, img))
    return out
