"""The port's serving engine against the JAX package's, on the CPU.

* **Scenario grid.**  Every deterministic engine scenario of
  ``tests/test_serve_async.py`` and the engine shed/probe/tenancy
  scenarios of ``tests/test_tenancy.py`` — with their fake clock, stub
  registries and stub cost models, imported from there — run through
  ``repro.serving.vision`` and ``repro_torch.serving.vision``.  Each
  scenario asserts its own pins on either package and returns an outcome
  record (rid order, status, bucket, batch fill, predicted ms and the
  counters it pins, where the interleaving of the pipeline's threads
  cannot change them); the port's record must equal the JAX one.  Both
  packages are parametrised, so every case counts once per package.
  ``test_serve_async.py::test_replan_falls_through_to_the_next_idle_group``
  runs over a stub registry of three devices, as the reference's does;
  ``test_engine_refuses_meshes_multiprocess_and_manifest`` pins what the
  engine still refuses, and that the warmup manifest is taken.
* **Real models.**  ``tiny_net(resolution=16, width=8)`` in ``depthwise``,
  ``fuse_half`` and ``fuse_full`` on one parameter tree
  (``_torch_params.numpy_params``): the port's pipelined engine
  (``device="cpu"``, backend ``cuda``: the kernels' plain versions) against
  the JAX pipelined engine on backend ``xla`` (same statuses, logits within
  rtol=atol=1e-4), the port's sync and pipelined engines against each other
  (within 1e-6 of the scale: the CPU's summation order follows the batch),
  and the conformance tests of ``tests/test_engine_interface.py``.
* **On the card** (marker ``gpu``, skipped without one): the CUDA-event
  readiness probe, pipelined against sync on ``cuda``, and back-to-back
  batches that each get their own logits (pinned buffers not reused early).

Every test that drives a pipelined engine uses bounded waits and closes the
engine in a ``finally`` block.
"""
import threading
import time
import types

import numpy as np
import pytest
import torch
from _torch_params import numpy_params
from test_serve_async import (FakeClock, Stub3GroupCostModel, StubCostModel,
                              StubRegistry, StubReplanCostModel,
                              StubRoundCostModel)

import repro.serving.vision as jsv
import repro_torch.serving.vision as tsv
from repro.vision import zoo as jzoo
from repro_torch.vision import zoo as tzoo
from repro_torch.vision.convert import params_from_numpy

RTOL = ATOL = 1e-4
WAIT_S = 30.0                        # bound on every wait on a pipeline
IMPLS = ("jax", "torch")
PKG = {"jax": types.SimpleNamespace(sv=jsv, zoo=jzoo, name="jax"),
       "torch": types.SimpleNamespace(sv=tsv, zoo=tzoo, name="torch")}


def _img(seed: int, res: int = 8) -> np.ndarray:
    return np.full((res, res, 3), float(seed), np.float32)


def _wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.002)
    return False


def _rows(results, fields=("rid", "status", "bucket", "batch_fill",
                           "predicted_ms")):
    """The outcome record of ``results``: the named fields plus the first
    logit (the stub registries put the request's image mean there)."""
    return [tuple(getattr(r, f) for f in fields)
            + (None if r.logits is None else float(r.logits[0]),)
            for r in results]


def _engine(p, registry, *, buckets=(1,), max_in_flight=2,
            ms_per_batch=10.0, batch_window_ms=0.0, **kw):
    return p.sv.VisionServeEngine(
        registry, cost_model=StubCostModel(ms_per_batch), buckets=buckets,
        clock=FakeClock(), max_in_flight=max_in_flight,
        batch_window_ms=batch_window_ms, **kw)


def _round_engine(p, registry, *, buckets=(1, 2, 4), max_in_flight=2,
                  batch_window_ms=0.0):
    return p.sv.VisionServeEngine(
        registry, cost_model=StubRoundCostModel(), buckets=buckets,
        clock=FakeClock(), max_in_flight=max_in_flight,
        batch_window_ms=batch_window_ms, cross_model=True)


def _sync_engine(p, reg, **kw):
    return p.sv.VisionServeEngine(reg, cost_model=StubCostModel(),
                                  buckets=(1,), clock=FakeClock(),
                                  pipelined=False, **kw)


class ExplodingRegistry(StubRegistry):
    def apply(self, key, images):
        raise RuntimeError("device on fire")


class HalfExplodingRegistry(StubRegistry):
    def apply(self, key, images, devices=None):
        if key == "b":
            raise RuntimeError("model b on fire")
        return super().apply(key, images, devices)


class ColdRegistry(StubRegistry):
    def is_compiled(self, key, bucket, devices=None):
        return False


class NeverReadyProbe(jsv.ReadinessProbe):
    def poll(self, out):
        return False

    def wait(self, interval_ms):
        pass                                        # fake clock drives time


class WeightsSpyCostModel(StubRoundCostModel):
    """Round planner recording the ``weights`` kwarg it was handed."""

    def __init__(self):
        super().__init__()
        self.seen_weights = []

    def plan_round(self, models, buckets, weights=None):
        self.seen_weights.append(weights)
        return super().plan_round(models, buckets)


# ---------------------------------------------------------------------------
# Scenarios of tests/test_serve_async.py.
# ---------------------------------------------------------------------------

def sc_in_flight_depth_is_bounded(p):
    gate = threading.Event()
    reg = StubRegistry(gate=gate)
    engine = _engine(p, reg, buckets=(1,), max_in_flight=2)
    try:
        for i in range(8):
            engine.submit("m", _img(i))
        assert _wait_until(lambda: len(reg.applied) == 1)
        time.sleep(0.1)
        assert len(reg.applied) == 1
        assert engine.metrics.max_in_flight <= 2
        gate.set()
        results = engine.flush()
        assert engine.metrics.max_in_flight <= 2
        return dict(results=_rows(results), applied=len(reg.applied))
    finally:
        gate.set()
        engine.close()


def sc_requests_complete_in_order_with_their_own_logits(p):
    reg = StubRegistry()
    engine = _engine(p, reg, buckets=(1, 2, 4), max_in_flight=2)
    try:
        rids = [engine.submit("m", _img(i)) for i in range(9)]
        futures = [engine.future(rid) for rid in rids]
        results = engine.flush()
        assert [r.rid for r in results] == rids
        assert all(r.e2e_ms > 0 and r.run_ms > 0 and r.queue_ms >= 0
                   for r in results)
        assert [f.result(timeout=WAIT_S).rid for f in futures] == rids
        # composition follows the interleaving: buckets are not compared
        return dict(results=_rows(results, ("rid", "status")))
    finally:
        engine.close()


def sc_multi_model_fifo_fairness(p):
    reg = StubRegistry(keys=("a", "b"))
    engine = _engine(p, reg, buckets=(1,), max_in_flight=1)
    try:
        for i in range(6):
            engine.submit(("a", "b")[i % 2], _img(i))
        results = engine.flush()
        return dict(results=_rows(results),
                    order=[k for k, _ in reg.applied])
    finally:
        engine.close()


def sc_slo_rejected_while_backlog_in_flight(p):
    gate = threading.Event()
    reg = StubRegistry(gate=gate)
    engine = _engine(p, reg, buckets=(1,), max_in_flight=2)
    try:
        for i in range(4):
            engine.submit("m", _img(i))
        assert _wait_until(lambda: len(reg.applied) == 1)
        rid_late = engine.submit("m", _img(99), slo_ms=15.0)
        late = engine.future(rid_late).result(timeout=WAIT_S)
        rid_ok = engine.submit("m", _img(42), slo_ms=1e6)
        gate.set()
        results = engine.flush()
        # the rejected request's prediction depends on how far the
        # scheduler got; its status does not
        return dict(late=(late.status, late.logits), ok=rid_ok,
                    results=_rows(results, ("rid", "status")),
                    rejected=engine.metrics.rejected)
    finally:
        gate.set()
        engine.close()


def sc_slo_admission_flips_to_calibrated_wall_ms(p):
    reg = (p.sv.ModelRegistry(backend="xla") if p.name == "jax"
           else p.sv.ModelRegistry(device="cpu"))
    model = reg.register(p.zoo.tiny_net(), "fuse_full", params=[])
    cm = p.sv.SystolicCostModel(
        calibrator=p.sv.LatencyCalibrator(min_samples=2))
    accel = cm.predicted_ms(model, 1)
    before = cm.admit(model, accel * 10, 0, (1,))
    for _ in range(2):
        cm.observe(model, 1, accel * 100.0)
    after = cm.admit(model, accel * 10, 0, (1,))
    assert before[0] and not after[0]
    plan = cm.plan_bucket(model, 3, (1, 2, 4))
    return dict(accel=accel, before=before, after=after,
                expected=[cm.expected_ms(model, b) for b in (1, 4)],
                plan=(plan.bucket, plan.served, plan.predicted_ms,
                      plan.calibrated))


def sc_close_drains_in_flight_batches(p):
    gate = threading.Event()
    reg = StubRegistry(gate=gate)
    engine = _engine(p, reg, buckets=(1,), max_in_flight=2)
    rids = [engine.submit("m", _img(i)) for i in range(5)]
    assert _wait_until(lambda: len(reg.applied) == 1)
    closer = threading.Thread(target=engine.close)
    closer.start()
    time.sleep(0.05)
    alive = closer.is_alive()
    gate.set()
    closer.join(timeout=WAIT_S)
    assert alive and not closer.is_alive()
    with pytest.raises(RuntimeError):
        engine.submit("m", _img(0))
    return dict(results=_rows([engine.future(r).result(timeout=1)
                               for r in rids]))


def sc_close_without_drain_cancels_queued_requests(p):
    gate = threading.Event()
    reg = StubRegistry(gate=gate)
    engine = _engine(p, reg, buckets=(1,), max_in_flight=2)
    rids = [engine.submit("m", _img(i)) for i in range(6)]
    assert _wait_until(lambda: len(reg.applied) == 1)
    closer = threading.Thread(target=lambda: engine.close(drain=False))
    closer.start()
    time.sleep(0.05)
    gate.set()
    closer.join(timeout=WAIT_S)
    assert not closer.is_alive()
    statuses = [engine.future(rid).result(timeout=1).status for rid in rids]
    n_ok = statuses.count("ok")
    # formed batches complete (1 or 2, by interleaving), the rest cancel
    return dict(n_ok_in_range=1 <= n_ok <= 2,
                pattern=statuses == ["ok"] * n_ok
                + ["cancelled"] * (6 - n_ok))


def sc_pipeline_contains_bad_requests_without_wedging(p):
    reg = StubRegistry()
    engine = _engine(p, reg, buckets=(1,), max_in_flight=2)
    try:
        bad = engine.submit("m", np.zeros((8, 8), np.float32))
        engine.submit("m", _img(5))
        results = engine.flush()
        assert {r.rid: r for r in results}[bad].error
        again = engine.submit("m", _img(6))
        return dict(results=_rows(results), errors=engine.metrics.errors,
                    again=engine.future(again).result(timeout=WAIT_S).status)
    finally:
        engine.close()


def sc_device_stage_error_resolves_futures(p):
    engine = _engine(p, ExplodingRegistry(), buckets=(2,), max_in_flight=2)
    try:
        for i in range(3):
            engine.submit("m", _img(i))
        results = engine.flush()
        return dict(results=_rows(results, ("rid", "status", "bucket")),
                    fire=["device on fire" in r.error for r in results])
    finally:
        engine.close()


def sc_close_is_idempotent_and_safe_before_start(p):
    engine = _engine(p, StubRegistry())
    engine.close()
    engine.close()
    with pytest.raises(RuntimeError):
        engine.submit("m", _img(0))
    return dict(closed=True)


def sc_close_drains_sync_engine_too(p):
    engine = p.sv.VisionServeEngine(StubRegistry(), cost_model=StubCostModel(),
                                    buckets=(2,), clock=FakeClock(),
                                    pipelined=False)
    rids = [engine.submit("m", _img(i)) for i in range(3)]
    engine.close()
    engine2 = p.sv.VisionServeEngine(StubRegistry(),
                                     cost_model=StubCostModel(),
                                     buckets=(2,), clock=FakeClock(),
                                     pipelined=False)
    rid = engine2.submit("m", _img(0))
    engine2.close(drain=False)
    return dict(results=_rows([engine.future(r).result(timeout=1)
                               for r in rids]),
                cancelled=_rows([engine2.future(rid).result(timeout=1)]))


def sc_window_does_not_head_of_line_block_other_models(p):
    reg = StubRegistry(keys=("a", "b"))
    engine = p.sv.VisionServeEngine(
        reg, cost_model=StubCostModel(), buckets=(1, 2), max_in_flight=2,
        batch_window_ms=60_000.0)
    try:
        engine.submit("a", _img(0))
        engine.submit("b", _img(1))
        engine.submit("b", _img(2))
        assert _wait_until(lambda: len(reg.applied) >= 1)
        first = reg.applied[0][0]
        results = engine.flush()
        return dict(first=first, results=_rows(results))
    finally:
        engine.close()


def sc_flush_bypasses_batch_window(p):
    reg = StubRegistry()
    engine = p.sv.VisionServeEngine(
        reg, cost_model=StubCostModel(), buckets=(4,), max_in_flight=2,
        batch_window_ms=60_000.0)
    try:
        for i in range(3):
            engine.submit("m", _img(i))
        t0 = time.monotonic()
        results = engine.flush()
        assert time.monotonic() - t0 < WAIT_S
        return dict(results=_rows(results), applied=len(reg.applied))
    finally:
        engine.close()


def sc_cross_model_round_coschedules_all_models(p):
    reg = StubRegistry(keys=("a", "b"))
    engine = _round_engine(p, reg, batch_window_ms=60_000.0)
    try:
        for i in range(4):
            engine.submit(("a", "b")[i % 2], _img(i))
        results = engine.flush()
        snap = engine.metrics.snapshot()
        return dict(results=_rows(results), applied=sorted(reg.applied),
                    rounds=(snap["rounds"], snap["cross_model_rounds"],
                            snap["max_round_models"]))
    finally:
        engine.close()


def sc_round_counts_as_one_in_flight_unit(p):
    gate = threading.Event()
    reg = StubRegistry(keys=("a", "b"), gate=gate)
    engine = _round_engine(p, reg, max_in_flight=1)
    try:
        for i in range(6):
            engine.submit(("a", "b")[i % 2], _img(i))
        assert _wait_until(lambda: len(reg.applied) >= 1)
        time.sleep(0.1)
        held = len(reg.applied) <= 2 and engine.metrics.max_in_flight <= 1
        gate.set()
        results = engine.flush()
        return dict(held=held, results=_rows(results, ("rid", "status")))
    finally:
        gate.set()
        engine.close()


def sc_round_part_error_does_not_sink_other_models(p):
    engine = _round_engine(p, HalfExplodingRegistry(keys=("a", "b")))
    try:
        engine.submit("a", _img(1))
        engine.submit("b", _img(2))
        results = engine.flush()
        again = engine.submit("a", _img(3))
        return dict(results=_rows(results),
                    fire=[r.error is not None and "model b on fire" in r.error
                          for r in results],
                    again=engine.future(again).result(timeout=WAIT_S).status)
    finally:
        engine.close()


def sc_round_engine_drains_on_close(p):
    engine = _round_engine(p, StubRegistry(keys=("a", "b")))
    rids = [engine.submit(("a", "b")[i % 2], _img(i)) for i in range(5)]
    engine.close()
    return dict(results=_rows([engine.future(r).result(timeout=1)
                               for r in rids], ("rid", "status")))


def _replan_engine(p, reg, cost_model=None, **kw):
    return p.sv.VisionServeEngine(
        reg, cost_model=cost_model or StubReplanCostModel(), buckets=(1,),
        clock=FakeClock(), cross_model=True, replan=True, **kw)


def _drive_round(p, engine, reg, keys, classes=None):
    """Push ``keys`` requests directly, form one round and dispatch its
    scheduled parts — the deterministic equivalent of the scheduler and
    device stages, leaving replanning to the caller."""
    clock = engine._clock
    for i, key in enumerate(keys):
        engine._queue.push(p.sv.VisionRequest(
            i, key, _img(i), clock(),
            slo_class=classes[i] if classes else "batch"))
    engine._depth_sem.acquire()
    rnd = engine._form_round()
    assert rnd is not None
    t0 = clock()
    outs = [(prep, reg.apply(prep.batch.model, prep.batch.images), clock())
            for prep in rnd.parts]
    return rnd, outs, t0


def _replan_record(engine, outs):
    snap = engine.metrics.snapshot()
    return dict(pending=engine._queue.pending(),
                outs=[(prep.batch.model, prep.replanned, prep.group)
                      for prep, _, _ in outs],
                replans=snap["replans"],
                recovered=snap["replan_idle_recovered_ms"],
                group_errs=snap["group_pred_abs_err_ms"]["count"],
                polled=snap["probe_polls"] > 0)


def sc_replan_backfills_idle_group_with_warm_batches(p):
    reg = StubRegistry(keys=("a", "b"))
    engine = _replan_engine(p, reg)
    cm = engine.cost_model
    rnd, outs, t0 = _drive_round(p, engine, reg, ["a", "b", "a", "a"])
    engine._replan_round(rnd, outs, t0)
    record = _replan_record(engine, outs)
    engine._complete_round(rnd, outs, t0, None)
    results = sorted(engine._results.values(), key=lambda r: r.rid)
    engine.close()
    return dict(record, results=_rows(results),
                observed=sorted(k for k, _, _ in cm.observed),
                partials=[k for k, _, _ in cm.partials])


def sc_replan_falls_through_to_the_next_idle_group(p):
    class ColdGroup0Registry(StubRegistry):
        devices = (0, 1, 2)

        def is_compiled(self, key, bucket, devices=None):
            return devices != (0,)

    reg = ColdGroup0Registry(keys=("a", "c", "b"))
    engine = p.sv.VisionServeEngine(
        reg, cost_model=Stub3GroupCostModel(), buckets=(1,),
        clock=FakeClock(), cross_model=True, replan=True)
    rnd, outs, t0 = _drive_round(p, engine, reg, ["a", "c", "b", "a"])
    assert engine._queue.pending() == 1          # the extra 'a'
    engine._replan_round(rnd, outs, t0)
    extra = [prep for prep, _, _ in outs if prep.replanned]
    assert len(extra) == 1
    assert extra[0].devices == (1,)              # backfilled g1, not cold g0
    record = _replan_record(engine, outs)
    engine._complete_round(rnd, outs, t0, None)
    results = sorted(engine._results.values(), key=lambda r: r.rid)
    engine.close()
    return dict(record, results=_rows(results),
                devices=[prep.devices for prep, _, _ in outs])


def sc_replan_only_dispatches_batches_that_fit_the_idle_window(p):
    reg = StubRegistry(keys=("a", "b"))
    engine = _replan_engine(p, reg)
    rnd, outs, t0 = _drive_round(p, engine, reg, ["a", "b", "b"])
    engine._replan_round(rnd, outs, t0)
    record = _replan_record(engine, outs)
    engine._complete_round(rnd, outs, t0, None)
    engine.close(drain=False)
    return record


def sc_replan_skips_cold_jit_entries(p):
    reg = ColdRegistry(keys=("a", "b"))
    engine = _replan_engine(p, reg)
    rnd, outs, t0 = _drive_round(p, engine, reg, ["a", "b", "a"])
    engine._replan_round(rnd, outs, t0)
    record = _replan_record(engine, outs)
    engine._complete_round(rnd, outs, t0, None)
    engine.close(drain=False)
    return record


def sc_replan_end_to_end_through_the_pipeline(p):
    engine = _replan_engine(p, StubRegistry(keys=("a", "b")),
                            max_in_flight=1)
    try:
        keys = ["a", "b", "a", "a", "b", "a", "a", "b"]
        for i, k in enumerate(keys):
            engine.submit(k, _img(i))
        results = engine.flush()
        return dict(results=_rows(results, ("rid", "status")),
                    completed=engine.metrics.snapshot()["completed"])
    finally:
        engine.close()


def sc_no_backfill_without_observed_completion(p):
    reg = StubRegistry(keys=("a", "b"))
    engine = _replan_engine(p, reg, probe=NeverReadyProbe())
    rnd, outs, t0 = _drive_round(p, engine, reg, ["a", "b", "a"])
    engine._replan_round(rnd, outs, t0)
    record = _replan_record(engine, outs)
    engine._complete_round(rnd, outs, t0, None)
    engine.close(drain=False)
    return record


def sc_observed_completion_feeds_group_error_and_backfill(p):
    reg = StubRegistry(keys=("a", "b"))
    engine = _replan_engine(p, reg)
    rnd, outs, t0 = _drive_round(p, engine, reg, ["a", "b", "a", "a"])
    engine._replan_round(rnd, outs, t0)
    record = _replan_record(engine, outs)
    engine._complete_round(rnd, outs, t0, None)
    engine.close()
    return record


def sc_planner_gets_weights_only_for_mixed_classes(p):
    cm = WeightsSpyCostModel()
    reg = StubRegistry()
    engine = p.sv.VisionServeEngine(reg, cost_model=cm, buckets=(1,),
                                    clock=FakeClock(), cross_model=True)
    _drive_round(p, engine, reg, ["m"])
    _drive_round(p, engine, reg, ["m"], classes=["interactive"])
    engine.close(drain=False)
    return dict(weights=cm.seen_weights)


def sc_calibrator_ignores_partial_observations(p):
    cal = p.sv.LatencyCalibrator(min_samples=2)
    first = [cal.observe("m", 1, 2.0, 20.0, partial=True) for _ in range(5)]
    unfit = cal.calibrated_ms("m", 1, 2.0)
    for _ in range(2):
        cal.observe("m", 1, 2.0, 20.0)
    resid = cal.observe("m", 1, 2.0, 60.0, partial=True)
    snap = cal.snapshot()
    return dict(first=first, unfit=unfit, resid=resid,
                fit=cal.calibrated_ms("m", 1, 2.0),
                partial_n=snap["partial"]["n"],
                cell_n=snap["m"]["buckets"]["1"]["n"])


def sc_run_percentiles_are_request_weighted(p):
    m = p.sv.ServeMetrics(clock=FakeClock())
    m.on_submit()
    m.on_batch("net", served=3, bucket=4, run_ms=10.0, predicted_ms=5.0)
    for _ in range(3):
        m.on_complete("net", e2e_ms=12.0, run_ms=10.0)
    m.on_batch("net", served=1, bucket=1, run_ms=1000.0, predicted_ms=5.0)
    m.on_complete("net", e2e_ms=1002.0, run_ms=1000.0)
    snap = m.snapshot()
    return dict(run=snap["run"], batches=snap["batches"],
                padded=snap["padded_slots"])


def sc_engine_run_stats_count_requests_not_batches(p):
    reg = StubRegistry()
    engine = _engine(p, reg, buckets=(4,), max_in_flight=1)
    try:
        for i in range(4):
            engine.submit("m", _img(i))
        results = engine.flush()
        snap = engine.metrics.snapshot()
        assert snap["batches"] == len(reg.applied)
        return dict(results=_rows(results, ("rid", "status")),
                    counts=(snap["run"]["m"]["count"],
                            snap["e2e"]["m"]["count"]))
    finally:
        engine.close()


# ---------------------------------------------------------------------------
# Scenarios of tests/test_tenancy.py (the engine shed path and the bursty
# two-class pin).
# ---------------------------------------------------------------------------

def sc_engine_sheds_batch_for_interactive(p):
    engine = _sync_engine(p, StubRegistry(), shed=True)
    for i in range(6):
        engine.submit("m", _img(i))
    rid = engine.submit("m", _img(9), slo_ms=40.0, slo_class="interactive",
                        tenant="search")
    queued = not engine.future(rid).done()
    results = engine.flush()
    snap = engine.metrics.snapshot()
    engine.close()
    return dict(queued=queued, shed=snap["shed"],
                results=_rows(results, ("rid", "status", "bucket",
                                        "batch_fill", "predicted_ms",
                                        "slo_class", "tenant")))


def sc_engine_shed_requires_opt_in(p):
    engine = _sync_engine(p, StubRegistry())
    for i in range(6):
        engine.submit("m", _img(i))
    rid = engine.submit("m", _img(9), slo_ms=40.0, slo_class="interactive")
    res = engine.future(rid).result(timeout=1)
    snap = engine.metrics.snapshot()
    engine.close()
    return dict(rejected=_rows([res]), shed=snap["shed"])


def sc_engine_interactive_never_shed_for_batch(p):
    engine = _sync_engine(p, StubRegistry(), shed=True)
    for i in range(6):
        engine.submit("m", _img(i), slo_class="interactive")
    engine.submit("m", _img(9), slo_ms=40.0, slo_class="batch")
    results = engine.flush()
    engine.close()
    return dict(results=_rows(results))


def sc_engine_rejects_unknown_class(p):
    engine = _sync_engine(p, StubRegistry())
    with pytest.raises(KeyError):
        engine.submit("m", _img(0), slo_class="gold")
    engine.close()
    return dict(raised=True)


def sc_bursty_two_class_scenario_pins_p95_and_shed_order(p):
    engine = _sync_engine(p, StubRegistry(keys=("m",)), shed=True)
    specs = [
        p.sv.TenantSpec("ads", pattern="bursty", slo_class="batch",
                        burst_len=8, burst_gap_ms=0.1, burst_every_ms=30.0),
        p.sv.TenantSpec("search", pattern="poisson", rate_rps=150.0,
                        slo_class="interactive", slo_ms=40.0),
    ]
    trace = p.sv.make_tenant_trace(engine.registry, specs, 24, seed=1)
    p.sv.submit_trace(engine, trace, realtime=False)
    results = engine.flush()
    snap = engine.metrics.snapshot()
    engine.close()
    by = {}
    for r in results:
        by.setdefault((r.slo_class, r.status), []).append(r)
    assert ("interactive", "shed") not in by
    assert len(by[("batch", "shed")]) == 10
    assert all(r.tenant == "ads" for r in by[("batch", "shed")])
    inter_p95 = snap["class_e2e"]["interactive"]["p95_ms"]
    batch_p95 = snap["class_e2e"]["batch"]["p95_ms"]
    assert inter_p95 < batch_p95 and inter_p95 <= 60.0 < batch_p95
    assert len(by[("interactive", "ok")]) == 4
    return dict(shed=snap["shed"], p95=(inter_p95, batch_p95),
                tenants=sorted(snap["tenant_completed"]),
                fairness=snap["fairness_index"],
                results=_rows(results, ("rid", "status", "bucket",
                                        "batch_fill", "predicted_ms",
                                        "slo_class", "tenant")))


SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items())
             if name.startswith("sc_")}
_REFERENCE = {}


def _jax_outcome(name):
    if name not in _REFERENCE:
        _REFERENCE[name] = SCENARIOS[name](PKG["jax"])
    return _REFERENCE[name]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_scenario_matches_jax(name, impl):
    want = _jax_outcome(name)
    got = want if impl == "jax" else SCENARIOS[name](PKG[impl])
    assert got == want


def test_scenario_pins():
    """Spot pins from the JAX tests, read off the shared outcome records
    (a scenario that silently stopped checking would still agree)."""
    rec = _jax_outcome("replan_backfills_idle_group_with_warm_batches")
    assert rec["replans"] == 2 and rec["pending"] == 0
    assert rec["recovered"] == pytest.approx(20.0)
    assert rec["observed"] == ["a", "b"] and rec["partials"] == ["a", "a"]
    assert _jax_outcome("replan_skips_cold_jit_entries")["replans"] == 0
    assert _jax_outcome("multi_model_fifo_fairness")["order"] == \
        ["a", "b"] * 3
    rec = _jax_outcome("engine_sheds_batch_for_interactive")
    assert rec["shed"] == {"batch": 3}
    assert [r[1] for r in rec["results"]] == ["ok"] * 3 + ["shed"] * 3 \
        + ["ok"]
    rec = _jax_outcome("flush_bypasses_batch_window")
    assert rec["applied"] == 1 and rec["results"][0][2:4] == (4, 3)
    rec = _jax_outcome("no_backfill_without_observed_completion")
    assert rec["replans"] == 0 and rec["polled"] and rec["group_errs"] == 0
    assert _jax_outcome("observed_completion_feeds_group_error_and_backfill"
                        )["group_errs"] == 4


# ---------------------------------------------------------------------------
# What stays refused, and the registry hooks.
# ---------------------------------------------------------------------------

def test_engine_refuses_meshes_multiprocess_and_manifest(tmp_path):
    """A registry mesh is taken (cross-model rounds on by default) unless
    the cost model plans for another device count; multi-process serving
    is refused on the sync engine and with a cost model whose group
    granularity is not the process count, as the reference's engine
    refuses them.  The warmup manifest: a registry without a fingerprint
    (a stub) warms the derived set and neither reads nor writes a
    manifest."""
    class ThreeDeviceRegistry(StubRegistry):
        devices = (0, 1, 2)

    reg = ThreeDeviceRegistry(keys=("a", "c", "b"))
    for sv in (jsv, tsv):
        engine = sv.VisionServeEngine(reg, cost_model=Stub3GroupCostModel())
        assert engine.cross_model is True
        engine.close()
        with pytest.raises(ValueError, match="registry mesh has 3"):
            sv.VisionServeEngine(reg, cost_model=sv.SystolicCostModel(
                n_devices=2))
        with pytest.raises(ValueError, match="multiprocess"):
            sv.VisionServeEngine(StubRegistry(), multiprocess=object(),
                                 pipelined=False)
        mp = types.SimpleNamespace(
            universe=(0, 1, 2, 3),
            mesh=types.SimpleNamespace(num_processes=2))
        with pytest.raises(ValueError, match="group_granularity=2"):
            sv.VisionServeEngine(StubRegistry(), multiprocess=mp,
                                 cost_model=sv.SystolicCostModel(
                                     n_devices=4))
    engine = tsv.VisionServeEngine(StubRegistry(), cost_model=StubCostModel())
    try:
        assert engine.pipelined is True          # the reference's default
        manifest = tmp_path / "m.json"
        assert engine.warmup(manifest_path=str(manifest)) == [
            ("m", b, None) for b in engine.buckets]
        assert not manifest.exists()
        assert engine.snapshot()["compilation"]["manifest_replayed"] is False
    finally:
        engine.close()


def test_registry_hooks_on_cpu():
    net = tzoo.tiny_net(resolution=16, width=8)
    reg = tsv.ModelRegistry(device="cpu")
    reg.register(net, "fuse_half")
    assert reg.n_devices == 1 and reg.devices is None
    fp = reg.backend_fingerprint()
    assert not reg.is_compiled("tiny_net/fuse_half", 2)
    engine = tsv.create_engine(reg, "sync", buckets=(1, 2))
    try:
        assert engine.warmup() == [("tiny_net/fuse_half", 1, None),
                                   ("tiny_net/fuse_half", 2, None)]
    finally:
        engine.close()
    assert reg.is_compiled("tiny_net/fuse_half", 2)
    assert reg.compiled_buckets() == [("tiny_net/fuse_half", 1),
                                      ("tiny_net/fuse_half", 2)]
    comp = engine.snapshot()["compilation"]
    assert comp["entries_built"] == 2 and comp["warmup_entries"] == 2
    assert [e["bucket"] for e in comp["compile_log"]] == [1, 2]
    assert comp["cache_dir"] is None and comp["manifest_replayed"] is False
    assert set(comp["persistent"]) == {"requests", "hits", "misses",
                                       "compile_s"}
    assert all(e["pcache_misses"] == 0 for e in comp["compile_log"])
    assert reg.backend_fingerprint() == fp
    reg.register(net, "depthwise")
    assert reg.backend_fingerprint() != fp
    out = reg.apply("tiny_net/depthwise", np.zeros((1, 16, 16, 3),
                                                  np.float32))
    assert out.is_ready() and out.materialize().shape == (1, 10)
    # groups are the devices of a registry mesh; this one has none
    with pytest.raises(ValueError, match="device groups"):
        reg.apply("tiny_net/depthwise", np.zeros((1, 16, 16, 3), np.float32),
                  devices=(0,))


def test_pipelined_warmup_runs_on_the_device_thread():
    """PyTorch keeps cuDNN and cuBLAS handles per thread, so the pipelined
    engine warms its entries on the thread that serves them."""
    threads = []

    class Recording(tsv.ModelRegistry):
        def warm_entry(self, key, bucket, devices=None, *, host=True):
            threads.append(threading.current_thread().name)
            super().warm_entry(key, bucket, devices, host=host)

    reg = Recording(device="cpu")
    reg.register(tzoo.tiny_net(resolution=16, width=8), "depthwise")
    for name, want in (("pipelined", "vision-serve-device"),
                       ("sync", threading.current_thread().name)):
        threads.clear()
        engine = tsv.create_engine(reg, name, buckets=(1, 2))
        try:
            assert len(engine.warmup()) == 2
        finally:
            engine.close()
        assert threads == [want, want]
    engine = tsv.create_engine(reg, "pipelined")
    engine.close()
    with pytest.raises(RuntimeError, match="closed"):
        engine.warmup()


# ---------------------------------------------------------------------------
# Real models: tiny_net in three variants on one parameter tree.
# ---------------------------------------------------------------------------

VARIANTS = ("depthwise", "fuse_half", "fuse_full")
BUCKETS = (1, 2, 4)
JNET = jzoo.tiny_net(resolution=16, width=8)
TNET = tzoo.tiny_net(resolution=16, width=8)


@pytest.fixture(scope="module")
def params():
    return {v: numpy_params(JNET, v, seed=i) for i, v in enumerate(VARIANTS)}


@pytest.fixture(scope="module")
def jreg(params):
    reg = jsv.ModelRegistry(backend="xla")
    for v in VARIANTS:
        reg.register(JNET, v, params=params[v])
    return reg


@pytest.fixture(scope="module")
def treg(params):
    reg = tsv.ModelRegistry(backend="cuda", device="cpu")
    for v in VARIANTS:
        reg.register(TNET, v, params=params_from_numpy(params[v], "cpu"))
    return reg


def drive(engine, sv, n=10, seed=5):
    """The conformance script of tests/test_engine_interface.py: submit a
    burst (``sv.make_mixed_burst``), poll the first request to
    completion, stream the rest, flush, close.  Returns [(status,
    logits)] in submission order."""
    try:
        items = sv.make_mixed_burst(engine.registry, n, seed=seed)
        rids = [engine.submit(k, img) for k, img in items]
        first = engine.poll(rids[0], timeout_ms=WAIT_S * 1e3)
        assert first is not None and first.rid == rids[0]
        streamed = {r.rid: r for r in engine.stream_results(
            rids, timeout_ms=WAIT_S * 1e3)}
        assert sorted(streamed) == sorted(rids)
        flushed = {r.rid: r for r in engine.flush()}
        assert sorted(flushed) == sorted(rids)
    finally:
        engine.close()
    return [(flushed[rid].status, flushed[rid].logits) for rid in rids]


def test_mixed_burst_items_are_bitwise_equal(jreg, treg):
    j_items = jsv.make_mixed_burst(jreg, 10, seed=5)
    t_items = tsv.make_mixed_burst(treg, 10, seed=5)
    assert [k for k, _ in j_items] == [k for k, _ in t_items]
    for (_, a), (_, b) in zip(j_items, t_items):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_pipelined_port_matches_the_jax_engine(jreg, treg):
    want = drive(jsv.create_engine(jreg, "pipelined", buckets=BUCKETS), jsv)
    got = drive(tsv.create_engine(treg, "pipelined", buckets=BUCKETS), tsv)
    assert [s for s, _ in got] == [s for s, _ in want] == ["ok"] * 10
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_port_sync_and_pipelined_give_identical_outcomes(treg):
    """As tests/test_engine_interface.py asks of the JAX engines: the same
    statuses and the same logits, request by request.  Not bitwise on the
    CPU: the pipelined engine forms other batches than the sync one (its
    scheduler runs while requests arrive), and PyTorch's CPU convolutions
    and matmuls sum in a batch-dependent order, which moved a logit by
    about 1e-7 of the scale in some runs; hence 1e-6 of the scale."""
    sync_out = drive(tsv.create_engine(treg, "sync", buckets=BUCKETS), tsv)
    pipe_out = drive(tsv.create_engine(treg, "pipelined", buckets=BUCKETS),
                     tsv)
    assert len(sync_out) == len(pipe_out) == 10
    for (s_status, s_logits), (p_status, p_logits) in zip(sync_out,
                                                          pipe_out):
        assert s_status == p_status == "ok"
        scale = max(1.0, float(np.abs(s_logits).max()))
        assert float(np.abs(p_logits - s_logits).max()) <= 1e-6 * scale


@pytest.mark.parametrize("engine_name", ["pipelined", "sync"])
def test_engine_conforms_to_protocol(treg, engine_name):
    engine = tsv.create_engine(treg, engine_name, buckets=BUCKETS)
    try:
        assert isinstance(engine, tsv.ServingEngine)
        assert isinstance(engine, tsv.VisionServeEngine)
        for verb in ("submit", "poll", "stream_results", "warmup",
                     "snapshot", "close"):
            assert callable(getattr(engine, verb))
    finally:
        engine.close()


@pytest.mark.parametrize("engine_name", ["pipelined", "sync"])
def test_poll_unknown_rid_raises(treg, engine_name):
    engine = tsv.create_engine(treg, engine_name, buckets=BUCKETS)
    try:
        with pytest.raises(KeyError):
            engine.poll(10_000)
    finally:
        engine.close()


def test_rejected_status_parity(treg):
    outcomes = {}
    for name in ("sync", "pipelined"):
        engine = tsv.create_engine(treg, name, buckets=BUCKETS)
        try:
            rid = engine.submit(treg.keys()[0],
                                np.zeros((16, 16, 3), np.float32),
                                slo_ms=1e-6)
            outcomes[name] = engine.poll(rid, timeout_ms=WAIT_S * 1e3).status
        finally:
            engine.close()
    assert outcomes == {"sync": "rejected", "pipelined": "rejected"}


class _PoisonRegistry:
    """Registry wrapper whose ``apply`` raises for one model key."""

    def __init__(self, inner, poison_key):
        self._inner = inner
        self._poison = poison_key

    def apply(self, key, images, **kw):
        if key == self._poison:
            raise RuntimeError("poisoned model")
        return self._inner.apply(key, images, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_error_status_parity(treg):
    poison_key = treg.keys()[0]
    items = tsv.make_mixed_burst(treg, 8, seed=9)
    outcomes = {}
    for name in ("sync", "pipelined"):
        engine = tsv.create_engine(_PoisonRegistry(treg, poison_key), name,
                                   buckets=BUCKETS)
        try:
            rids = [engine.submit(k, img) for k, img in items]
            done = {r.rid: r for r in engine.flush()}
        finally:
            engine.close()
        outcomes[name] = [(done[rid].status, k == poison_key)
                          for rid, (k, _) in zip(rids, items)]
        for rid, (k, _) in zip(rids, items):
            if k == poison_key:
                assert done[rid].status == "error"
                assert "poisoned model" in done[rid].error
                assert done[rid].logits is None
            else:
                assert done[rid].status == "ok"
    assert outcomes["sync"] == outcomes["pipelined"]


@pytest.mark.parametrize("engine_name", ["pipelined", "sync"])
def test_closed_engine_rejects_submit(treg, engine_name):
    engine = tsv.create_engine(treg, engine_name, buckets=BUCKETS)
    engine.close()
    with pytest.raises(RuntimeError):
        engine.submit(treg.keys()[0], np.zeros((16, 16, 3), np.float32))
    engine.close()


def test_factory_and_registration_surface(treg):
    with pytest.raises(ValueError, match="unknown engine"):
        tsv.create_engine(treg, "warp-drive")
    assert tsv.ENGINES["sync"] is tsv.SyncVisionEngine
    assert tsv.ENGINES["pipelined"] is tsv.PipelinedVisionEngine
    engine = tsv.create_engine(treg)
    try:
        assert type(engine) is tsv.PipelinedVisionEngine   # the default
    finally:
        engine.close()
    calls = []

    def fake(reg, **kw):
        calls.append(kw)
        return tsv.SyncVisionEngine(reg, **kw)

    original = tsv.ENGINES["sync"]
    tsv.register_engine("sync", fake)
    try:
        tsv.create_engine(treg, "sync", buckets=BUCKETS).close()
        assert calls == [{"buckets": BUCKETS}]
    finally:
        tsv.register_engine("sync", original)
    for cls, flag, want in ((tsv.SyncVisionEngine, True, False),
                            (tsv.PipelinedVisionEngine, False, True)):
        engine = cls(treg, pipelined=flag, buckets=BUCKETS)
        try:
            assert engine.pipelined is want
        finally:
            engine.close()


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA-event probe and the kernels "
                    "run only on the card")


@pytest.mark.gpu
def test_probe_reads_the_cuda_event():
    _need_card()
    x = torch.full((4,), 2.0, device="cuda")
    # a first handle of this size makes the host allocator cache its pinned
    # block: allocating one (cudaHostAlloc) waits for the device
    tsv.BatchLogits(x * 3.0).materialize()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)          # about 0.1 s of device spin
    out = tsv.BatchLogits(x * 3.0)
    probe = tsv.ReadinessProbe()
    assert not probe.poll(out)
    torch.cuda.synchronize()
    assert probe.poll(out)
    np.testing.assert_array_equal(out.materialize(), np.full(4, 6.0))


def _cuda_registry(params):
    reg = tsv.ModelRegistry(backend="cuda", device="cuda")
    for v in VARIANTS:
        reg.register(TNET, v, params=params_from_numpy(params[v], "cuda"))
    return reg


@pytest.mark.gpu
def test_pipelined_matches_sync_on_the_card(params):
    _need_card()
    reg = _cuda_registry(params)
    sync_out = drive(tsv.create_engine(reg, "sync", buckets=BUCKETS), tsv)
    engine = tsv.create_engine(reg, "pipelined", buckets=BUCKETS)
    engine.warmup()
    pipe_out = drive(engine, tsv)
    for (s_status, s_logits), (p_status, p_logits) in zip(sync_out,
                                                          pipe_out):
        assert s_status == p_status == "ok"
        scale = max(1.0, float(np.abs(s_logits).max()))
        assert float(np.abs(p_logits - s_logits).max()) <= 1e-5 * scale


@pytest.mark.gpu
def test_back_to_back_batches_get_their_own_logits(params):
    """bucket-1 batches, two in flight, each request a different image:
    a pinned staging buffer reused before its copy ran would hand a
    request another request's logits."""
    _need_card()
    reg = _cuda_registry(params)
    key = "tiny_net/fuse_full"
    rng = np.random.default_rng(7)
    images = [rng.standard_normal((16, 16, 3)).astype(np.float32)
              for _ in range(12)]
    sync = tsv.create_engine(reg, "sync", buckets=(1,))
    try:
        want = [sync.poll(sync.submit(key, img)).logits for img in images]
    finally:
        sync.close()
    engine = tsv.create_engine(reg, "pipelined", buckets=(1,),
                               max_in_flight=2)
    try:
        engine.warmup()
        rids = [engine.submit(key, img) for img in images]
        got = [engine.future(r).result(timeout=WAIT_S) for r in rids]
    finally:
        engine.close()
    assert engine.metrics.max_in_flight == 2
    for r, w in zip(got, want):
        assert r.status == "ok" and r.bucket == 1
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(r.logits - w).max()) <= 1e-5 * scale
