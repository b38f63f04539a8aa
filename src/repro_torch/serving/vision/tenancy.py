"""SLO classes and fairness accounting for multi-tenant serving.

The serving stack up to PR 5 treats every request identically: one queue
discipline (FIFO per model), one admission rule, one latency ledger.
Real edge-serving traffic is not like that — a camera pipeline's
interactive requests (a user is waiting) share the array with batch
re-scoring jobs (nobody is waiting), and under backlog the two must NOT
degrade together.  This module defines the tiny, deliberately closed
vocabulary the control plane speaks:

* ``SLOClass`` — a named priority level.  ``priority`` orders load
  shedding (lower priorities are shed first); ``weight`` is the round
  planner's exchange rate when it scores compositions by
  ms-per-served-request (an interactive request counts ``weight``-times
  a batch one, so compositions that serve interactive work win ties).
* ``SLO_CLASSES`` — the registry.  Two classes, ``interactive`` and
  ``batch``, mirroring the paper's edge-inference setting; ``batch`` is
  the default so every pre-tenancy call site keeps its exact behavior
  (all requests same class -> nothing is ever shed ahead of anything).
* ``jain_fairness`` — Jain's index over per-tenant service counts, the
  standard [1/n, 1] fairness summary ``metrics.py`` reports (1.0 =
  perfectly even service, 1/n = one tenant got everything).

Kept dependency-free (no engine/costmodel imports) so the batcher, the
metrics ledger, and the traffic generators can all import it without
cycles.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One service class: shed order via ``priority`` (higher survives
    longer), planner exchange rate via ``weight``."""
    name: str
    priority: int
    weight: float

    def __post_init__(self):
        assert self.priority >= 0, self
        assert self.weight > 0.0, self


SLO_CLASSES: Dict[str, SLOClass] = {
    "interactive": SLOClass("interactive", priority=2, weight=4.0),
    "batch": SLOClass("batch", priority=1, weight=1.0),
}

# pre-tenancy call sites submit without a class; "batch" keeps them all
# equal-priority (nothing sheds anything) and weight-1 (planner scores
# reduce to plain ms-per-request)
DEFAULT_CLASS = "batch"


def slo_class(name: Optional[str]) -> SLOClass:
    """Resolve a class name (None -> the default class).  Unknown names
    are an error at submit time, not silently default — a typo'd class
    must not quietly demote a tenant to shed-first."""
    if name is None:
        name = DEFAULT_CLASS
    cls = SLO_CLASSES.get(name)
    if cls is None:
        raise KeyError(f"unknown SLO class {name!r}; "
                       f"known: {sorted(SLO_CLASSES)}")
    return cls


def class_priority(name: Optional[str]) -> int:
    return slo_class(name).priority


def class_weight(name: Optional[str]) -> float:
    return slo_class(name).weight


def jain_fairness(counts: Sequence[float]) -> float:
    """Jain's fairness index ``(sum x)^2 / (n * sum x^2)`` over
    per-tenant service counts; 1.0 when service is perfectly even,
    ``1/n`` when one tenant monopolizes.  Zeros count (a starved tenant
    IS unfairness); empty or all-zero input -> 1.0 (nothing served is
    vacuously fair)."""
    xs = [float(c) for c in counts]
    ss = sum(x * x for x in xs)
    if not xs or ss <= 0.0:
        return 1.0
    s = sum(xs)
    return (s * s) / (len(xs) * ss)
