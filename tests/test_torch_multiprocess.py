"""Two-process data-parallel serving of the port, and its control plane.

This file imports no JAX (its card test runs where the kernels build).

* **The launcher pair** (``scripts/multiprocess_check_torch.py``'s
  ``run_pair`` and ``run_single``, the same commands the check runs): a
  coordinator (process 0: the scheduler, the traffic and the coordination
  store) and a worker (process 1, started a second later), each
  ``python -m repro_torch.launch.serve_vision --device cpu`` over 2
  logical devices, ``tiny_net/fuse_full`` and ``tiny_net/depthwise`` at
  16 px, bucket 8; and one process over a 4-device mesh on the same
  burst.  As ``tests/test_serve_multiprocess.py`` asserts of the
  reference: both processes build one mesh fingerprint, every request is
  served, rounds crossed processes both ways, the logits digest equals
  the single process's bit for bit, the worker warmed the broadcast
  entries and ran no nvcc (on the CPU nothing is built at all), and the
  worker's snapshot has the reference's shape.
* **The store client** (``launch.distributed.CoordinationClient`` over a
  ``TCPStore`` in this process): values larger than a chunk, reads that
  time out, barriers; ``initialize_distributed``'s modes.
* **A dead worker** fails the round's requests within the coordinator's
  ``round_timeout_ms``.
* **Pipes**: the pair's children are drained at once, past 64 KiB on
  both pipes of both, and one that fails ends the other.
* **On the card** (marker ``gpu``): a registry over 4 logical devices of
  the card on backend ``cuda`` against the ``torch`` backend unsharded,
  MobileNetV3-Large ``fuse_half`` and ``depthwise`` at 224 px, every
  bucket of (1, 2, 4, 8) on groups of width 1, 2 and 4, within
  ``SERVE_RTOL`` of max(1, max|ref|), with each kernel launched exactly
  width x its launches for one stripe.
"""
import collections
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch.launch.distributed as tdist
import repro_torch.launch.mesh as tmesh
import repro_torch.serving.vision as tsv
from repro_torch.vision import zoo as tzoo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import multiprocess_check_torch as mpcheck  # noqa: E402

REQUESTS = 6
SERVE_RTOL = 1e-5           # served logits, as chip_smoke.py holds them
WAIT_S = 60.0


@pytest.fixture(scope="module")
def mp_pair(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("mp"))
    common = mpcheck.COMMON + ["--device", "cpu",
                               "--requests", str(REQUESTS)]
    # the launchers inherit the environment: two threads each, so that the
    # three of them do not crowd the host's cores (every process gets the
    # same count, so the stripes round alike)
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "2"
    try:
        single = mpcheck.run_single(common, base, timeout=300)
        coord, worker = mpcheck.run_pair(common, base, timeout=300)
    finally:
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    return coord, worker, single


def test_mesh_agreement(mp_pair):
    coord, worker, _ = mp_pair
    mp = coord["multiprocess"]
    assert mp["num_processes"] == 2 and mp["global_size"] == 4
    assert worker["mesh_fingerprint"] == mp["mesh_fingerprint"]
    assert worker["num_processes"] == 2
    assert worker["mesh_devices"] == 4 and worker["local_devices"] == 2
    assert coord["mesh_devices"] == 4 and coord["num_processes"] == 2


def test_cross_process_rounds_served_everything(mp_pair):
    coord, worker, _ = mp_pair
    assert coord["completed"] == REQUESTS and coord["rejected"] == 0
    mp = coord["multiprocess"]
    assert mp["rounds_broadcast"] > 0 and mp["shards_gathered"] > 0
    assert mp["broadcast_bytes"] > 0 and mp["gather_bytes"] > 0
    assert worker["worker"]["rounds_seen"] == mp["rounds_broadcast"]
    assert worker["worker"]["parts_executed"] > 0


def test_logits_bitwise_identical_to_single_process(mp_pair):
    coord, _, single = mp_pair
    assert coord["logits_sha256"] == single["logits_sha256"]
    assert single["completed"] == coord["completed"] == REQUESTS
    assert single["mesh_devices"] == 4 and single["num_processes"] == 1


def test_late_joining_worker_builds_nothing(mp_pair):
    coord, worker, single = mp_pair
    w = worker["worker"]
    assert w["warmup_entries_warmed"] > 0 and w["warmup_fingerprint"]
    assert w["warmup_fingerprint"].endswith(
        coord["multiprocess"]["mesh_fingerprint"])
    assert worker["compilation"]["persistent"]["misses"] == 0
    assert mpcheck.checks(single, coord, worker, REQUESTS, "cpu") == {
        name: True for name in mpcheck.checks(single, coord, worker,
                                              REQUESTS, "cpu")}


def test_worker_snapshot_shape(mp_pair):
    _, worker, _ = mp_pair
    assert worker["mode"] == "worker" and worker["process_id"] == 1
    assert set(worker["worker"]) == {
        "rounds_seen", "parts_executed", "parts_skipped",
        "warmup_entries_warmed", "warmup_entries_skipped",
        "shard_bytes_out", "warmup_fingerprint"}
    assert set(worker["compilation"]["persistent"]) == {
        "requests", "hits", "misses", "compile_s"}


# -- the store client ----------------------------------------------------------

def _store_pair(num_processes=2):
    """A hosting client (process 0) and a connected one (process 1) in
    this process, on a free port."""
    port = mpcheck.free_port()
    clients = []
    for pid in range(num_processes):
        spec = tdist.DistributedSpec(f"127.0.0.1:{port}", num_processes, pid)
        clients.append(tdist.initialize_distributed(spec,
                                                    mode="coordination"))
    return clients


def test_store_client_values_timeouts_and_barriers(monkeypatch):
    monkeypatch.setattr(tdist, "CHUNK_BYTES", 1000)
    host, other = _store_pair()
    blob = np.random.default_rng(0).bytes(3500)
    host.set("blob", blob)
    assert other.get("blob") == blob                   # 4 chunks
    other.set("text", "fingerprint")
    assert host.get("text") == b"fingerprint"
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="'repro/absent'"):
        other.get("absent", timeout_ms=200)
    assert time.monotonic() - t0 < 5.0
    passed = []
    t = threading.Thread(target=lambda: (other.barrier("b", 10_000),
                                         passed.append("worker")))
    t.start()
    time.sleep(0.2)
    assert passed == []                                # waits for process 0
    host.barrier("b", 10_000)
    passed.append("host")
    t.join(timeout=WAIT_S)
    assert not t.is_alive() and sorted(passed) == ["host", "worker"]


def test_initialize_distributed_modes():
    """A single-process spec brings up nothing in either mode; the global
    mode's process 0 of two, with no peer, gives up readably within its
    timeout and leaves no process group behind."""
    one = tdist.DistributedSpec("127.0.0.1:1", 1, 0)
    assert tdist.initialize_distributed(one, mode="coordination") is None
    assert tdist.initialize_distributed(one) is None
    assert not torch.distributed.is_initialized()
    two = tdist.DistributedSpec(f"127.0.0.1:{mpcheck.free_port()}", 2, 0)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="process 0 of 2.*within 2 s"):
        tdist.initialize_distributed(two, mode="global", device="cpu",
                                     timeout_s=2)
    assert time.monotonic() - t0 < 15.0
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="unknown mode"):
        tdist.initialize_distributed(two, mode="nccl")


def test_dead_worker_fails_the_round_in_time():
    """Process 0 of two, with no worker: every round (bucket 4 striped
    over the 4-device universe) waits for a worker shard that never
    arrives, so its requests fail after ``round_timeout_ms``."""
    host, _ = _store_pair()
    mp_mesh = tmesh.make_multiprocess_data_mesh(
        2, 0, 2, "cpu", env={tmesh.ENV_VIRTUAL_DEVICES: "2"})
    reg = tsv.ModelRegistry(mesh=mp_mesh.local_mesh)
    reg.register(tzoo.tiny_net(resolution=16, width=8), "depthwise")
    coord = tsv.MultiprocessCoordinator(host, mp_mesh, reg,
                                        round_timeout_ms=300)
    engine = tsv.VisionServeEngine(
        reg, cost_model=tsv.SystolicCostModel(n_devices=4,
                                              group_granularity=2),
        buckets=(4,), multiprocess=coord)
    coord.metrics = engine.metrics
    try:
        img = np.zeros((16, 16, 3), np.float32)
        t0 = time.monotonic()
        rids = [engine.submit("tiny_net/depthwise", img) for _ in range(4)]
        results = engine.flush()
        assert time.monotonic() - t0 < 30.0
        by_rid = {r.rid: r for r in results}
        assert {by_rid[r].status for r in rids} == {"error"}
        assert "no 'repro/shard/0/0/1'" in str(by_rid[rids[0]].error)
        assert engine.snapshot()["multiprocess"]["rounds_broadcast"] >= 1
    finally:
        engine.close()


# -- pipes ---------------------------------------------------------------------

def _talker(nbytes, rc):
    code = (f"import sys; sys.stdout.write('o' * {nbytes}); "
            f"sys.stderr.write('e' * {nbytes}); sys.exit({rc})")
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_drain_reads_every_pipe_and_ends_on_a_failure():
    big = 200_000                              # past a 64 KiB pipe buffer
    res = mpcheck.drain({"a": _talker(big, 0), "b": _talker(big, 0)},
                        timeout=60)
    assert {name: (rc, len(out), len(err)) for name, (rc, out, err)
            in res.items()} == {"a": (0, big, big), "b": (0, big, big)}
    sleeper = subprocess.Popen([sys.executable, "-c",
                                "import time; time.sleep(600)"],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
    t0 = time.monotonic()
    res = mpcheck.drain({"bad": _talker(10, 3), "sleeper": sleeper},
                        timeout=60)
    assert res["bad"][0] == 3 and res["sleeper"][0] != 0
    assert time.monotonic() - t0 < 30.0


def test_free_port_is_bindable():
    port = mpcheck.free_port()
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", port))
    finally:
        s.close()


# -- on the card ---------------------------------------------------------------

@pytest.mark.gpu
def test_striped_kernels_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    from repro_torch.kernels import ops as kops
    from repro_torch.vision import zoo
    mesh = tmesh.make_data_mesh(4, "cuda",
                                env={tmesh.ENV_VIRTUAL_DEVICES: "4"})
    cuda = tsv.ModelRegistry(backend="cuda", mesh=mesh)
    plain = tsv.ModelRegistry(backend="torch", device="cuda")
    net = zoo.mobilenet_v3_large()
    rng = np.random.default_rng(0)
    for i, variant in enumerate(("fuse_half", "depthwise")):
        m = cuda.register(net, variant, seed=i)
        plain.register(net, variant, params=m.params)
        for bucket in (1, 2, 4, 8):
            x = rng.standard_normal((bucket, 224, 224, 3)).astype(np.float32)
            want = plain.apply(m.key, x).materialize().copy()
            scale = max(1.0, float(np.abs(want).max()))
            for width in (1, 2, 4):
                group = cuda.devices[:width]
                rows = bucket // width if bucket % width == 0 else bucket
                stripes = bucket // rows
                expect = collections.Counter(
                    name for name, _ in zoo.kernel_launches(net, variant,
                                                            rows))
                kops.reset_launch_counts()
                got = cuda.apply(m.key, x, devices=group).materialize()
                counts = {k: c for k, c in kops.launch_counts().items() if c}
                assert counts == {k: stripes * c for k, c in expect.items()}
                err = float(np.abs(got - want).max()) / scale
                assert err <= SERVE_RTOL, (variant, bucket, width, err)
