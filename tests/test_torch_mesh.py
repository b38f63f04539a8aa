"""The port's data mesh, topology and sharded serving on the CPU, against
the JAX package.

* **Topology.**  ``resolve_spec`` (every readable error of
  ``tests/test_distributed_launch.py``, same messages), ``env_exports``,
  ``env.configure``, ``logical_universe``, and on the reference's stub
  meshes ``stripe``, ``by_id``, ``fingerprint``, ``local_exec_plan``,
  ``slice_local_rows`` and ``stitch_shards``: the port's results equal the
  reference's exactly.
* **The mesh.**  ``make_data_mesh`` over logical CPU devices
  (``REPRO_TORCH_VIRTUAL_DEVICES``) and its readable refusals.
* **The sharded registry.**  ``tiny_net`` (16 px, width 8) in
  ``fuse_half`` and ``depthwise`` on one parameter tree
  (``_torch_params.numpy_params``), on a registry over 4 logical CPU
  devices: every bucket of (1, 2, 4, 8) on groups of width 1, 2 and 4,
  against the JAX package's unsharded apply (rtol=atol=1e-4) and against
  the port's unsharded registry (max|d| <= 1e-6 of max(1, max|ref|): the
  CPU's plain versions round a one-row batch differently from a larger
  one, so a stripe is not bitwise the whole batch).
* **The engine over a mesh.**  The device scenarios of
  ``tests/test_serve_sharded.py`` (8 logical devices, the fifo and adaptive
  planners: rounds formed, groups used, results fanned back in submission
  order, entries stable over a second burst, sharded calibration cells)
  and ``tests/test_round_planner.py``'s warmup of the hybrid planner's
  reachable layouts, through the port's engine (the latter through both).
* The launcher's ``--mesh 4`` without logical devices exits with one line.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
from _torch_params import jax_logits, numpy_params

import repro.launch.distributed as jdist
import repro.launch.mesh as jmesh
import repro.serving.vision as jsv
import repro.serving.vision.multiproc as jmp
import repro_torch.launch.distributed as tdist
import repro_torch.launch.env as tenv
import repro_torch.launch.mesh as tmesh
import repro_torch.serving.vision as tsv
import repro_torch.serving.vision.multiproc as tmp
from repro.vision import zoo as jzoo
from repro_torch.serving.vision import compilecache
from repro_torch.vision import zoo as tzoo
from repro_torch.vision.convert import params_from_numpy

RTOL = ATOL = 1e-4          # against the JAX package
SHARD_RTOL = 1e-6           # against the port's unsharded registry
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIRTUAL = tmesh.ENV_VIRTUAL_DEVICES
JNET = jzoo.tiny_net(resolution=16, width=8)
TNET = tzoo.tiny_net(resolution=16, width=8)
VARIANTS = ("fuse_half", "depthwise")
PARAMS = {v: numpy_params(JNET, v, seed=i) for i, v in enumerate(VARIANTS)}


# -- topology ----------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    dict(env={}),
    dict(coordinator_address="nocolon", env={}),
    dict(coordinator_address="h:notaport", env={}),
    dict(coordinator_address="h:1", env={}),
    dict(coordinator_address="h:1", num_processes=2, env={}),
    dict(coordinator_address="h:1", num_processes=0, process_id=0, env={}),
    dict(coordinator_address="h:1", num_processes=2, process_id=2, env={}),
    dict(coordinator_address="h:1", env={"REPRO_NUM_PROCESSES": "two",
                                        "REPRO_PROCESS_ID": "0"}),
])
def test_resolve_spec_errors_match_the_reference(kwargs):
    with pytest.raises(jdist.DistributedConfigError) as want:
        jdist.resolve_spec(**kwargs)
    with pytest.raises(tdist.DistributedConfigError) as got:
        tdist.resolve_spec(**kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("args,env", [
    (("10.0.0.1:8476", 2, 1), {}),
    ((), {"JAX_COORDINATOR_ADDRESS": "envhost:1111",
          "REPRO_NUM_PROCESSES": "4", "REPRO_PROCESS_ID": "3"}),
    (("cli:2222", None, 0), {"JAX_COORDINATOR_ADDRESS": "envhost:1111",
                             "REPRO_NUM_PROCESSES": "4",
                             "REPRO_PROCESS_ID": "3"}),
])
def test_resolve_spec_and_exports_match_the_reference(args, env):
    want = jdist.resolve_spec(*args, env=env)
    got = tdist.resolve_spec(*args, env=env)
    fields = ("coordinator_address", "num_processes", "process_id",
              "is_coordinator")
    assert [getattr(got, f) for f in fields] == \
        [getattr(want, f) for f in fields]
    assert got.env_exports() == want.env_exports()
    assert tdist.resolve_spec(env=got.env_exports()) == got


def test_env_configure_exports_what_the_port_reads():
    env = tenv.configure(4, compilation_cache_dir="/c",
                         coordinator_address="h:1", num_processes=2,
                         process_id=1, env={})
    assert env == {VIRTUAL: "4", compilecache.ENV_CACHE_DIR: "/c",
                   **tdist.DistributedSpec("h:1", 2, 1).env_exports()}
    assert tmesh.virtual_device_count(env) == 4
    assert tenv.configure(env={}) == {}
    # env.py and distributed.py declare the trio under the reference's
    # names; the duplication must never drift
    for name in ("ENV_COORDINATOR", "ENV_NUM_PROCESSES", "ENV_PROCESS_ID"):
        assert getattr(tenv, name) == getattr(tdist, name) \
            == getattr(jdist, name)


def test_distributed_and_env_modules_do_not_import_torch():
    code = ("import sys; import repro_torch.launch.distributed, "
            "repro_torch.launch.env; "
            "sys.exit(1 if 'torch' in sys.modules else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"},
                          timeout=120)
    assert proc.returncode == 0


@pytest.mark.parametrize("p,n", [(1, 4), (2, 2), (2, 4), (4, 2), (3, 3)])
def test_logical_universe_matches_the_reference(p, n):
    got = tmesh.logical_universe(p, n)
    assert [tuple(d) for d in got] == \
        [tuple(d) for d in jmesh.logical_universe(p, n)]


def _stub_local_mesh(n_local):
    """The reference's stub: ``.devices`` an object array of stubs with
    ``id`` and ``platform``."""
    devs = np.empty(n_local, dtype=object)
    for i in range(n_local):
        devs[i] = types.SimpleNamespace(id=i, platform="cpu")
    return types.SimpleNamespace(devices=devs)


def _stub_meshes(num_processes, process_id, n_local):
    local = _stub_local_mesh(n_local)
    return tuple(mod.MultiprocessDataMesh(
        local_mesh=local, num_processes=num_processes,
        process_id=process_id, n_local=n_local,
        universe=mod.logical_universe(num_processes, n_local))
        for mod in (jmesh, tmesh))


@pytest.mark.parametrize("p,pid,n", [(2, 0, 4), (2, 1, 4), (2, 0, 2),
                                     (4, 3, 2), (1, 0, 4)])
def test_stub_mesh_matches_the_reference(p, pid, n):
    want, got = _stub_meshes(p, pid, n)
    assert got.fingerprint() == want.fingerprint()
    assert got.describe() == want.describe()
    assert got.universe_ids == want.universe_ids
    assert [tuple(d) for d in got.by_id([0, n * p - 1])] == \
        [tuple(d) for d in want.by_id([0, n * p - 1])]
    for off in range(0, p * n, p):
        for size in range(p, p * n - off + 1, p):
            group_w = want.universe[off:off + size]
            group_t = got.universe[off:off + size]
            for q in range(p):
                dw, pw = want.stripe(group_w, q)
                dt, pt = got.stripe(group_t, q)
                assert pt == pw and [d.id for d in dt] == \
                    [d.id for d in dw]


def _plan_tuple(plan):
    return None if plan is None else (
        tuple(d.id for d in plan.devices), plan.positions,
        plan.local_bucket, plan.rows_per_position)


def test_exec_plans_slices_and_stitches_match_the_reference():
    rng = np.random.default_rng(0)
    want_m, got_m = _stub_meshes(2, 0, 4)
    for off, size in ((0, 8), (0, 4), (4, 4), (2, 2), (6, 2), (0, 2)):
        group_w = want_m.universe[off:off + size]
        group_t = got_m.universe[off:off + size]
        for bucket in (1, 2, 4, 8):
            batch = rng.standard_normal((bucket, 3)).astype(np.float32)
            shards_w, shards_t = [], []
            for pid in range(2):
                pw = jmp.local_exec_plan(want_m, group_w, bucket, pid)
                pt = tmp.local_exec_plan(got_m, group_t, bucket, pid)
                assert _plan_tuple(pt) == _plan_tuple(pw)
                if pt is None:
                    continue
                rows_w = jmp.slice_local_rows(batch, pw)
                rows_t = tmp.slice_local_rows(batch, pt)
                assert np.array_equal(rows_t, rows_w)
                shards_w.append((pw, rows_w * 10))
                shards_t.append((pt, rows_t * 10))
            got = tmp.stitch_shards(bucket, shards_t)
            assert np.array_equal(got, jmp.stitch_shards(bucket, shards_w))
            assert np.array_equal(got, batch * 10)


# -- the mesh ------------------------------------------------------------------

def test_make_data_mesh_over_logical_cpu_devices():
    mesh = tmesh.make_data_mesh(4, "cpu", env={VIRTUAL: "4"})
    assert [d.id for d in mesh.devices] == [0, 1, 2, 3]
    assert {str(d.device) for d in mesh.devices} == {"cpu"}
    assert all(d.stream is None for d in mesh.devices)
    assert tmesh.data_axes(mesh) == ("data",)
    assert len(tmesh.make_data_mesh(0, "cpu", env={VIRTUAL: "3"}).devices) \
        == 3
    assert len(tmesh.make_data_mesh(0, "cpu", env={}).devices) == 1
    mp = tmesh.make_multiprocess_data_mesh(2, 1, 2, "cpu",
                                           env={VIRTUAL: "2"})
    assert mp.global_size == 4 and mp.local_devices() == \
        mp.local_mesh.devices
    with pytest.raises(ValueError, match=f"{VIRTUAL}=4 to map 4"):
        tmesh.make_data_mesh(4, "cpu", env={})
    with pytest.raises(ValueError, match=f"{VIRTUAL}=2; set it to 8"):
        tmesh.make_data_mesh(8, "cpu", env={VIRTUAL: "2"})
    with pytest.raises(ValueError, match="not a device count"):
        tmesh.make_data_mesh(2, "cpu", env={VIRTUAL: "two"})
    with pytest.raises(ValueError, match="out of range"):
        tmesh.make_multiprocess_data_mesh(2, 2, 1, "cpu", env={})


def test_launcher_mesh_without_logical_devices_exits_in_one_line():
    env = {k: v for k, v in os.environ.items() if k != VIRTUAL}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_vision", "--device",
         "cpu", "--mesh", "4"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 1 and proc.stdout == ""
    assert proc.stderr.strip().splitlines() == [
        f"--mesh 4: a data mesh of 4 devices needs 4 cpu devices, but 1 is "
        f"visible; set {VIRTUAL}=4 to map 4 logical devices onto it"]


# -- the sharded registry ------------------------------------------------------

def _registries(n_devices):
    mesh = tmesh.make_data_mesh(n_devices, "cpu",
                                env={VIRTUAL: str(n_devices)})
    sharded = tsv.ModelRegistry(mesh=mesh)
    plain = tsv.ModelRegistry(device="cpu")
    for v in VARIANTS:
        for reg in (sharded, plain):
            reg.register(TNET, v, params=params_from_numpy(PARAMS[v], "cpu"))
    return sharded, plain


@pytest.fixture(scope="module")
def registries():
    return _registries(4)


def _off(got, want):
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


@pytest.mark.parametrize("variant", VARIANTS)
def test_sharded_registry_matches_jax_and_the_unsharded_port(registries,
                                                             variant):
    sharded, plain = registries
    key = f"tiny_net/{variant}"
    rng = np.random.default_rng(5)
    for bucket in (1, 2, 4, 8):
        x = rng.standard_normal((bucket, 16, 16, 3)).astype(np.float32)
        want = plain.apply(key, x).materialize().copy()
        if bucket in (2, 8):
            np.testing.assert_allclose(
                want, jax_logits(PARAMS[variant], JNET, x, variant),
                rtol=RTOL, atol=ATOL)
        for group in (sharded.devices[:1], sharded.devices[:2],
                      sharded.devices[2:], sharded.devices):
            got = sharded.apply(key, x, devices=group).materialize()
            if bucket in (2, 8):
                np.testing.assert_allclose(
                    got, jax_logits(PARAMS[variant], JNET, x, variant),
                    rtol=RTOL, atol=ATOL)
            assert _off(got, want) <= SHARD_RTOL, (bucket, len(group))
            assert sharded.is_compiled(key, bucket, devices=group)
    # the whole mesh is the default group
    x = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
    assert np.array_equal(sharded.apply(key, x).materialize(),
                          sharded.apply(key, x, sharded.devices)
                          .materialize())


def test_sharded_registry_hooks(registries):
    sharded, plain = registries
    assert sharded.n_devices == 4 and plain.n_devices == 1
    assert sharded.devices_by_id([3, 1]) == (sharded.devices[3],
                                              sharded.devices[1])
    assert sharded.devices_by_id([9]) is None
    assert sharded.backend_fingerprint() != plain.backend_fingerprint()
    # one parameter copy per physical device: the mesh's is the CPU, where
    # the registered tree already lives
    assert sharded._placed_params == {}
    key = "tiny_net/depthwise"
    sharded.warm_entry(key, 4, devices=sharded.devices[:2])
    log = [e for e in sharded.compile_stats()["compile_log"]
           if e["key"] == key and e["bucket"] == 4]
    assert [0, 1] in [e["devices"] for e in log]
    assert (key, 4, (0, 1)) in sharded.compiled_buckets()
    other = tsv.ModelRegistry(mesh=tmesh.make_data_mesh(
        2, "cpu", env={VIRTUAL: "2"}))
    with pytest.raises(ValueError, match="devices of the registry's mesh"):
        sharded.apply(key, np.zeros((2, 16, 16, 3), np.float32),
                      devices=other.devices)
    with pytest.raises(ValueError, match="no 'data' axis"):
        tsv.ModelRegistry(mesh=types.SimpleNamespace(axis_names=("x",)))


# -- the engine over a mesh ----------------------------------------------------

@pytest.fixture(scope="module")
def mesh8():
    return _registries(8)


def _reference_logits(plain, key, img):
    x = tsv.fit_image(np.asarray(img, np.float32), 16)[None]
    return plain.apply(key, x).materialize()[0]


def _check_fanback(results, rids, items, plain):
    by_rid = {r.rid: r for r in results}
    worst = 0.0
    for rid, (key, img) in zip(rids, items):
        r = by_rid[rid]
        assert r.status == "ok", r.error
        worst = max(worst, _off(r.logits, _reference_logits(plain, key,
                                                            img)))
    return worst


def test_engine_forms_cross_model_rounds_on_mesh(mesh8):
    """``test_serve_sharded.py``'s fifo engine on 8 devices: rounds form
    over two groups, batches stripe 4 wide, every result comes back in
    submission order with its own logits (within ``SHARD_RTOL`` of the
    unsharded single-image apply, and the JAX package's at 1e-4), and a
    second burst runs no new entry while feeding sharded calibration
    cells."""
    reg, plain = mesh8
    cal = tsv.LatencyCalibrator(min_samples=2)
    engine = tsv.VisionServeEngine(
        reg, cost_model=tsv.SystolicCostModel(calibrator=cal, n_devices=8,
                                              round_planner="fifo"),
        buckets=(1, 2, 4, 8), max_in_flight=2)
    try:
        assert engine.cross_model is True
        engine.warmup()
        items = tsv.make_mixed_burst(reg, 16, seed=7)
        rids = [engine.submit(k, img) for k, img in items]
        results = engine.flush()
        assert [r.rid for r in results] == sorted(rids)
        assert _check_fanback(results, rids, items, plain) <= SHARD_RTOL
        for rid, (key, img) in list(zip(rids, items))[:4]:
            x = tsv.fit_image(np.asarray(img, np.float32), 16)[None]
            np.testing.assert_allclose(
                {r.rid: r for r in results}[rid].logits,
                jax_logits(PARAMS[key.split("/")[1]], JNET, x,
                           key.split("/")[1])[0], rtol=RTOL, atol=ATOL)
        snap = engine.metrics.snapshot()
        assert snap["rounds"] >= 1 and snap["cross_model_rounds"] >= 1
        assert snap["max_round_groups"] == 2
        assert 4 in {r.n_devices for r in results}
        n_entries = len(reg.compiled_buckets())
        engine.generate(tsv.make_mixed_burst(reg, 16, seed=8))
        assert len(reg.compiled_buckets()) == n_entries
        cells = {label for entry in cal.snapshot().values()
                 if isinstance(entry, dict)
                 for label in entry.get("buckets", {}) if "x" in str(label)}
        assert cells
    finally:
        engine.close()


def test_adaptive_planner_serves_on_mesh(mesh8):
    reg, plain = mesh8
    engine = tsv.VisionServeEngine(
        reg, cost_model=tsv.SystolicCostModel(
            calibrator=tsv.LatencyCalibrator(min_samples=2), n_devices=8,
            round_planner="adaptive"),
        buckets=(1, 2, 4, 8), max_in_flight=2)
    try:
        warmed = engine.warmup()
        # the reachable groups were warmed: the full mesh and its halves
        groups = {ids for _, _, ids in warmed if ids is not None}
        assert groups == {(0, 1, 2, 3), (4, 5, 6, 7)}
        assert all(reg.is_compiled(k, b, reg.devices_by_id(ids))
                   for k, b, ids in warmed if ids is not None)
        items = tsv.make_mixed_burst(reg, 16, seed=11)
        rids = [engine.submit(k, img) for k, img in items]
        results = engine.flush()
        assert _check_fanback(results, rids, items, plain) <= SHARD_RTOL
        snap = engine.metrics.snapshot()
        assert snap["rounds"] >= 1
        assert sum(snap["round_strategies"].values()) == snap["rounds"]
        assert set(snap["round_strategies"]) <= {"even", "uneven", "serial"}
    finally:
        engine.close()


class _RecordingRegistry:
    """Delegates model lookup to a real registry but fakes an 8-device
    mesh and records prewarm calls (``test_round_planner.py``)."""

    def __init__(self, inner, n_devices=8):
        self._inner = inner
        self.devices = tuple(range(n_devices))
        self.prewarmed = []

    def get(self, key):
        return self._inner.get(key)

    def keys(self):
        return self._inner.keys()

    def prewarm(self, key, buckets, groups=None, **kw):
        self.prewarmed.append(
            (key, tuple(buckets), tuple(tuple(g) for g in (groups or ()))))


def _hybrid_warmup_layouts(impl):
    """{model key: device groups prewarmed} of a hybrid-planner engine's
    ``warmup()`` over 8 stub devices and three models."""
    sv, zoo = (jsv, jzoo) if impl == "jax" else (tsv, tzoo)
    inner = (sv.ModelRegistry(backend="xla") if impl == "jax"
             else sv.ModelRegistry(device="cpu"))
    for variant in ("depthwise", "fuse_half", "fuse_full"):
        inner.register(zoo.tiny_net(resolution=16, width=8), variant,
                       params=[])
    rec = _RecordingRegistry(inner)
    engine = sv.VisionServeEngine(
        rec, cost_model=sv.SystolicCostModel(n_devices=8,
                                             round_planner="hybrid"),
        buckets=(1, 2, 4), cross_model=True)
    try:
        engine.warmup()
    finally:
        engine.close()
    return {key: set(gs) for key, _, gs in rec.prewarmed}


@pytest.mark.parametrize("impl", ["jax", "torch"])
def test_warmup_precompiles_hybrid_reachable_layouts(impl):
    """Every sub-mesh group of every descending power-of-two partition
    into 2..|models| groups is prewarmed for every model; the port's set
    is the reference's."""
    warmed = _hybrid_warmup_layouts(impl)
    assert len(warmed) == 3
    for k in (2, 3):
        for sizes in tsv.power_of_two_partitions(8, k):
            for grp in tsv.device_groups_sized(tuple(range(8)), sizes):
                if len(grp) < 8:
                    for key, groups in warmed.items():
                        assert grp in groups, (sizes, grp, key)
    if impl == "torch":
        assert warmed == _hybrid_warmup_layouts("jax")


def test_batch_logits_of_one_tensor_and_of_stripes():
    """The handle the registry returns: built on one tensor (the form the
    card's probe test uses), or empty with a shape that stripes fill."""
    torch = tmesh.torch
    one = tsv.BatchLogits(torch.full((4,), 2.0) * 3.0)
    assert one.is_ready()
    np.testing.assert_array_equal(one.materialize(), np.full(4, 6.0))
    striped = tsv.BatchLogits(shape=(4, 3))
    striped.add(2, torch.zeros(2, 3))
    striped.add(0, torch.ones(2, 3))
    np.testing.assert_array_equal(striped.materialize(),
                                  np.repeat([[1.0], [0.0]], 2, axis=0)
                                  * np.ones((4, 3)))
