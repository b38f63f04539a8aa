"""Multi-process serving check for the PyTorch port: a 2-process
coordinator/worker pair must agree on the mesh, serve every request with
logits bitwise-identical to one process over the same 4-device universe,
and warm the late-joining worker without running nvcc.

    python scripts/multiprocess_check_torch.py [--device cpu] \
        [--report multiprocess_check_torch_report.json]

Three launcher processes (``repro_torch.launch.serve_vision``, the
entry point a user starts), each with ``REPRO_TORCH_VIRTUAL_DEVICES``
logical devices on the one card (``--device cuda``, the default) or the
CPU:

* single — one process over a 4-device mesh, the same burst; its logits
  digest is ground truth;
* coordinator — process 0 of a 2-process x 2-device topology on a free
  local port and a fresh shared kernel build directory and manifest;
  serves the burst through cross-process rounds;
* worker — process 1, started after the coordinator (the rolling join),
  follower loop only.

The pair's children are drained at once (both stdout and stderr of each,
in threads), so neither blocks on a full pipe, and a child that exits
non-zero ends the others.  A coordinator that finds its port taken
(``EADDRINUSE``: a port picked free can be taken before the store binds)
is retried on a new port.

Checks (any failure exits 1): both pair processes exit 0 with the same
mesh fingerprint; the pair's ``logits_sha256`` equals the single
process's; rounds crossed processes (the worker executed parts, the
coordinator gathered shards); the worker warmed the broadcast entries
and ran no nvcc (build-cache misses 0).  On the card the coordinator also
built the kernels cold and the worker loaded every library it asked for
from the shared directory (hits = requests > 0); on the CPU nothing is
built, and the build counters stay 0.

``--buckets 8`` (the default here): every stripe holds at least two rows
whatever group a round lands on, so both runs compute each row at the
same shapes (the CPU's plain versions round a one-row batch differently).
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMMON = ["--models", "tiny_net/fuse_full", "tiny_net/depthwise",
          "--resolution", "16", "--buckets", "8", "--seed", "3"]
ATTEMPTS = 3


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(args, virtual_devices: int) -> subprocess.Popen:
    """One launcher process with ``virtual_devices`` logical devices."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([env["PYTHONPATH"]]
                                       if env.get("PYTHONPATH") else []))
    env["REPRO_TORCH_VIRTUAL_DEVICES"] = str(virtual_devices)
    for var in ("REPRO_TORCH_KERNEL_CACHE_DIR", "JAX_COORDINATOR_ADDRESS",
                "REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID"):
        env.pop(var, None)
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_vision", *args],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def drain(procs, timeout: float) -> dict:
    """Wait for every process in ``procs`` (name: Popen), reading all of
    their pipes at once; a process that exits non-zero kills the rest.
    Returns name: (returncode, stdout, stderr); raises ``TimeoutError``
    (after killing them all) past ``timeout`` seconds."""
    outs = {}

    def read(name, proc):
        outs[name] = proc.communicate()

    threads = [threading.Thread(target=read, args=item, daemon=True)
               for item in procs.items()]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    try:
        while any(t.is_alive() for t in threads):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{sorted(procs)} still running after "
                                   f"{timeout:.0f} s")
            if any(p.poll() not in (None, 0) for p in procs.values()):
                break
            time.sleep(0.05)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        for t in threads:
            t.join(timeout=30)
    return {name: (p.returncode,) + outs.get(name, ("", ""))
            for name, p in procs.items()}


def _failed(name, rc, out, err) -> str:
    return (f"{name} launcher exited with {rc}\n--- stdout ---\n"
            f"{out[-2000:]}\n--- stderr ---\n{err[-4000:]}")


def run_single(common, workdir: str, timeout: float = 600) -> dict:
    """One process over a 4-device mesh; returns its snapshot."""
    path = os.path.join(workdir, "single.json")
    res = drain({"single": launch([*common, "--mesh", "4",
                                   "--json", path], 4)}, timeout)
    if res["single"][0] != 0:
        raise RuntimeError(_failed("single", *res["single"]))
    with open(path) as f:
        return json.load(f)


def run_pair(common, workdir: str, *, worker_delay: float = 1.0,
             timeout: float = 600) -> tuple:
    """The coordinator, then (``worker_delay`` s later) the worker, each
    over 2 logical devices, on one build directory and manifest under
    ``workdir``; returns (coordinator snapshot, worker snapshot)."""
    for attempt in range(ATTEMPTS):
        pair = [*common, "--mesh", "2",
                "--coordinator", f"127.0.0.1:{free_port()}",
                "--num-processes", "2",
                "--compilation-cache-dir", os.path.join(workdir, "cache"),
                "--warmup-manifest", os.path.join(workdir, "manifest.json")]
        paths = {name: os.path.join(workdir, f"{name}.json")
                 for name in ("coordinator", "worker")}
        procs = {"coordinator": launch(
            [*pair, "--process-id", "0", "--json", paths["coordinator"]], 2)}
        time.sleep(worker_delay)
        procs["worker"] = launch(
            [*pair, "--process-id", "1", "--json", paths["worker"]], 2)
        res = drain(procs, timeout)
        rc, out, err = res["coordinator"]
        if rc != 0 and "EADDRINUSE" in err and attempt + 1 < ATTEMPTS:
            continue
        for name, (rc, out, err) in res.items():
            if rc != 0:
                raise RuntimeError(_failed(name, rc, out, err))
        snaps = []
        for name in ("coordinator", "worker"):
            with open(paths[name]) as f:
                snaps.append(json.load(f))
        return tuple(snaps)
    raise AssertionError("unreachable")


def checks(single: dict, coordinator: dict, worker: dict, requests: int,
           device: str) -> dict:
    """The check's verdicts by name (see the module docstring)."""
    mp = coordinator.get("multiprocess", {})
    wstats = worker.get("worker", {})
    wcache = worker.get("compilation", {}).get("persistent", {})
    ccache = coordinator.get("compilation", {}).get("persistent", {})
    out = {
        "single_served_everything":
            single.get("completed") == requests,
        "pair_served_everything":
            coordinator.get("completed") == requests,
        "mesh_fingerprints_agree":
            bool(mp.get("mesh_fingerprint"))
            and worker.get("mesh_fingerprint") == mp.get("mesh_fingerprint"),
        "logits_bitwise_identical":
            bool(single.get("logits_sha256"))
            and coordinator.get("logits_sha256")
            == single.get("logits_sha256"),
        "rounds_crossed_processes":
            int(mp.get("shards_gathered", 0)) > 0
            and int(wstats.get("parts_executed", 0)) > 0,
        "worker_warmed_broadcast_entries":
            int(wstats.get("warmup_entries_warmed", 0)) > 0,
        "worker_ran_no_nvcc": int(wcache.get("misses", -1)) == 0,
    }
    if device == "cuda":
        out["coordinator_built_cold"] = int(ccache.get("misses", 0)) > 0
        out["worker_loaded_every_library"] = \
            int(wcache.get("hits", 0)) == int(wcache.get("requests", -1)) > 0
    else:
        out["cpu_builds_nothing"] = \
            int(wcache.get("requests", -1)) == 0 \
            and int(ccache.get("requests", -1)) == 0
    return out


def main() -> int:
    ap = argparse.ArgumentParser(
        description="2-process serving check for the PyTorch port")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--worker-delay", type=float, default=1.0,
                    help="seconds the worker joins after the coordinator")
    ap.add_argument("--report", default="multiprocess_check_torch_report.json",
                    help="write the report here (pass or fail)")
    args = ap.parse_args()

    common = COMMON + ["--device", args.device,
                       "--requests", str(args.requests)]
    with tempfile.TemporaryDirectory(prefix="mp_check_torch_") as tmp:
        single = run_single(common, tmp)
        coordinator, worker = run_pair(common, tmp,
                                       worker_delay=args.worker_delay)
    verdicts = checks(single, coordinator, worker, args.requests,
                      args.device)
    mp = coordinator.get("multiprocess", {})
    wstats = worker.get("worker", {})
    wcache = worker.get("compilation", {}).get("persistent", {})
    report = {
        "device": args.device, "requests": args.requests,
        "single": {k: single.get(k) for k in ("completed", "logits_sha256",
                                              "mesh_devices")},
        "coordinator": {"completed": coordinator.get("completed"),
                        "logits_sha256": coordinator.get("logits_sha256"),
                        "multiprocess": mp,
                        "persistent_cache": coordinator.get(
                            "compilation", {}).get("persistent")},
        "worker": {"stats": wstats, "persistent_cache": wcache,
                   "mesh_fingerprint": worker.get("mesh_fingerprint")},
        "checks": verdicts, "ok": all(verdicts.values()),
    }
    with open(args.report, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    print(f"multiprocess-check-torch: rounds={mp.get('rounds_broadcast', 0)}"
          f" gathered={mp.get('shards_gathered', 0)} worker parts="
          f"{wstats.get('parts_executed', 0)} warmed="
          f"{wstats.get('warmup_entries_warmed', 0)} build hits="
          f"{wcache.get('hits', 0)} misses={wcache.get('misses', '?')}")
    for name, ok in sorted(verdicts.items()):
        print(f"  {'PASS' if ok else 'FAIL'}  {name}")
    print(f"report: {args.report}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
