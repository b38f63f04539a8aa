"""JetStream-style serving-engine interface: one explicit protocol, many
conforming engines, selected by factory.

Port of ``repro.serving.vision.interface``, unchanged but for the engine
it wraps.

The MaxText decode-microbenchmark engine API (named in ROADMAP.md) makes
the serving surface a small verb set — submit work, poll for one result,
stream results as they land, warm up, snapshot, shut down — and lets any
number of engine implementations conform behind it.  This module is that
surface for the vision stack:

* :class:`ServingEngine` — the abstract protocol.  Everything above the
  engine (launchers, benches, traffic generators, the restart CI gate)
  programs against these six methods and nothing else.
* :class:`SyncVisionEngine` / :class:`PipelinedVisionEngine` — the two
  existing execution paths (drain-on-caller vs the 3-thread pipelined
  executor), now explicit conforming implementations instead of a
  ``pipelined=`` constructor flag.
* :func:`create_engine` — the factory.  Future engines (multi-process,
  elastic-OFA hot-swap) plug in via :func:`register_engine` without
  another engine rewrite.

Conformance contract (pinned by tests/test_torch_engine.py): driven
through identical submit/poll/flush/close sequences, every engine must
produce identical per-request results — same statuses, bitwise-identical
logits — differing only in *when* work happens (sync engines execute
inside ``poll``/``flush`` on the caller's thread; pipelined engines
overlap it with submission).
"""
from __future__ import annotations

import abc
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.serving.vision.engine import (VisionResult,
                                               VisionServeEngine)


class ServingEngine(abc.ABC):
    """Abstract serving-engine protocol (JetStream-style verb set).

    Implementations own scheduling, batching, and placement; callers own
    traffic.  All six methods are mandatory — an engine that cannot
    stream results or snapshot itself is not servable in this fleet.
    """

    @abc.abstractmethod
    def submit(self, model_key: str, image: np.ndarray,
               slo_ms: Optional[float] = None, *,
               slo_class: Optional[str] = None,
               tenant: Optional[str] = None) -> int:
        """Enqueue one request; returns its request id immediately.
        SLO'd requests may be admission-rejected (the id still resolves,
        with status "rejected")."""

    @abc.abstractmethod
    def poll(self, rid: int,
             timeout_ms: float = 0.0) -> Optional[VisionResult]:
        """The finished result for ``rid``, or None while pending.
        Non-destructive (results stay flushable)."""

    @abc.abstractmethod
    def stream_results(self, rids: Optional[Sequence[int]] = None,
                       timeout_ms: Optional[float] = None
                       ) -> Iterator[VisionResult]:
        """Yield results in completion order as they land."""

    @abc.abstractmethod
    def warmup(self, keys: Optional[Sequence[str]] = None,
               buckets: Optional[Sequence[int]] = None,
               manifest_path: Optional[str] = None) -> List[tuple]:
        """Precompile the reachable (model, bucket, device-group) layout
        set so nothing compiles under traffic; with ``manifest_path``,
        persist/replay the set across restarts (see engine.warmup)."""

    @abc.abstractmethod
    def snapshot(self) -> Dict:
        """Self-describing metrics + compilation accounting dict."""

    @abc.abstractmethod
    def close(self, *, drain: bool = True) -> None:
        """Stop serving; ``drain`` finishes outstanding work first."""


# VisionServeEngine implements the full surface; the subclasses below are
# the named conforming implementations the factory hands out.
ServingEngine.register(VisionServeEngine)


class SyncVisionEngine(VisionServeEngine):
    """Drain-on-caller engine: no worker threads, deterministic batch
    composition given submission order.  ``poll``/``flush`` execute
    queued batches on the calling thread.  The apples-to-apples baseline
    every pipelined win is measured against."""

    name = "sync"

    def __init__(self, registry, **kwargs):
        kwargs.pop("pipelined", None)
        super().__init__(registry, pipelined=False, **kwargs)


class PipelinedVisionEngine(VisionServeEngine):
    """3-thread pipelined engine (scheduler / device / completer) with
    bounded in-flight depth; with ``cross_model=True`` it co-schedules
    cross-model rounds."""

    name = "pipelined"

    def __init__(self, registry, **kwargs):
        kwargs.pop("pipelined", None)
        super().__init__(registry, pipelined=True, **kwargs)


ENGINES: Dict[str, Callable[..., ServingEngine]] = {}


def register_engine(name: str,
                    factory: Callable[..., ServingEngine]) -> None:
    """Register an engine implementation under ``name`` (later wins —
    deliberate, so deployments can shadow a stock engine)."""
    ENGINES[name] = factory


register_engine(SyncVisionEngine.name, SyncVisionEngine)
register_engine(PipelinedVisionEngine.name, PipelinedVisionEngine)


def create_engine(registry, engine: str = "pipelined",
                  **kwargs) -> ServingEngine:
    """Build a conforming engine by name ("sync" | "pipelined" | anything
    registered via :func:`register_engine`).  ``kwargs`` pass through to
    the implementation's constructor."""
    try:
        factory = ENGINES[engine]
    except KeyError:
        raise ValueError(f"unknown engine {engine!r}; registered engines: "
                         f"{sorted(ENGINES)}") from None
    return factory(registry, **kwargs)
