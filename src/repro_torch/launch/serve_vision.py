"""Vision-serving launcher: synthetic mixed traffic through the port's engine.

  PYTHONPATH=src python -m repro_torch.launch.serve_vision \
      --models mobilenet_v3_large/fuse_half mobilenet_v3_large/depthwise \
      --requests 32 --warm-bursts 1

Port of ``repro.launch.serve_vision`` for one CUDA device.  ``--models``
entries are ``<zoo name>/<variant>``; ``tiny_net`` plus every network in
``repro_torch.vision.zoo.ZOO`` is accepted.  ``--resolution`` overrides the
network's native input size.  Weights come from the port's own init with
seed 0 (the reference launcher also initializes from seed 0).

The engine runs its async pipelined executor by default (host batching of
batch N+1 overlapped with device execution of batch N); ``--sync`` (or
``--engine sync``) selects the synchronous drain-on-caller path.
``--backend`` picks the execution path (``cuda``: the hand-written
kernels, ``torch``: plain PyTorch, ``cuda_nofused``: the kernels with the
fused FuSe block off) and ``--device`` where it runs (``cuda``, or ``cpu``
for the kernels' plain versions).  ``engine.warmup()`` runs every (model,
bucket) once before traffic; ``--warm-bursts`` replays the burst before
the measured pass so the latency calibrator has enough observations for
SLO admission to operate in calibrated wall-ms.  ``--tenant`` replaces the
burst with multi-tenant traffic and ``--shed`` lets SLO'd requests shed
lower-priority queued work.

Warm restarts, as the reference launcher gives them:

  python -m repro_torch.launch.serve_vision --compilation-cache-dir D \
      --warmup-manifest D/m.json

``--compilation-cache-dir`` (default ``$REPRO_TORCH_KERNEL_CACHE_DIR``;
unset: ``build/kernels``) is where the CUDA kernel libraries are built
and found, and ``--warmup-manifest`` persists the warmed (model, bucket)
set on a cold start and replays it on the next.  A second process on the
same directory and manifest builds no kernel; the printed ``compile ...``
line reports the build cache's hits and misses.

``--mesh N`` builds a 1-D data mesh of N devices (``launch.mesh``) and
turns on the cross-model round scheduler: each dispatch co-schedules one
bucketed batch per model onto device groups of the mesh, and batches
stripe over their group.  N devices are N cards unless
``REPRO_TORCH_VIRTUAL_DEVICES`` asks for logical ones, which share the
cards (each with a CUDA stream of its own) or the CPU:

  REPRO_TORCH_VIRTUAL_DEVICES=4 python -m repro_torch.launch.serve_vision \
      --mesh 4

Multi-process data parallelism: give every process the same command plus
``--coordinator HOST:PORT --num-processes P --process-id I`` (or the
``JAX_COORDINATOR_ADDRESS`` / ``REPRO_NUM_PROCESSES`` /
``REPRO_PROCESS_ID`` environment trio, the reference launcher's).
``--mesh`` then counts *local* devices per process and rounds plan over
the ``mesh x num-processes`` logical universe; process 0 hosts the
coordination store and runs the scheduler and traffic, every other
process runs the worker follower loop and reports its stripe and
warm-join accounting as its snapshot.  The processes share no process
group, so they may share one card.  The flags and the JSON snapshot's
keys are the reference launcher's.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json

# the stock ServingEngine factory names, spelled out here so --help works
# without importing torch; create_engine re-validates at runtime
ENGINE_CHOICES = ("pipelined", "sync")


def run_worker_process(args, spec, client, mp_mesh, registry):
    """Worker (process id > 0) service loop: no engine, no traffic — the
    process publishes its mesh fingerprint, follows the coordinator's
    message channel (warmup broadcast, round specs, stop sentinel), and
    reports the accounting the multiprocess check reads: stripe
    executions plus the kernel build cache's counters, which show that a
    worker sharing the coordinator's cache directory ran no nvcc."""
    from repro_torch.serving.vision import (persistent_cache_counters,
                                            publish_mesh_fingerprint,
                                            run_worker)
    fp = publish_mesh_fingerprint(client, mp_mesh)
    stats = run_worker(client, mp_mesh, registry)
    pc = persistent_cache_counters()
    snap = {
        "mode": "worker",
        "process_id": spec.process_id,
        "num_processes": spec.num_processes,
        "mesh_fingerprint": fp,
        "mesh_devices": mp_mesh.global_size,
        "local_devices": mp_mesh.n_local,
        "worker": stats,
        "compilation": {"cache_dir": registry.compilation_cache_dir,
                        "persistent": pc},
    }
    print(f"worker {spec.process_id}/{spec.num_processes} "
          f"rounds={stats['rounds_seen']} parts={stats['parts_executed']} "
          f"warmed={stats['warmup_entries_warmed']} "
          f"pcache_hits={pc['hits']} pcache_misses={pc['misses']}")
    print(json.dumps(snap, indent=2, sort_keys=True))
    if args.json_path:
        with open(args.json_path, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)


def build_network(name: str, resolution: int = 0):
    from repro_torch.vision import zoo
    if name == "tiny_net":
        net = zoo.tiny_net()
    else:
        net = zoo.ZOO[name]()
    if resolution:
        net = dataclasses.replace(net, resolution=resolution)
    return net


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="+",
                    default=["tiny_net/depthwise", "tiny_net/fuse_full"],
                    help="entries of the form <zoo name>/<variant>")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--backend", default="cuda",
                    choices=["cuda", "torch", "cuda_nofused"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the models run (cpu: the kernels' plain"
                         " versions)")
    ap.add_argument("--resolution", type=int, default=0,
                    help="override network input resolution (0 = native)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="serve over this many devices (1-D data mesh +"
                         " cross-model round scheduler; 0 = off).  More"
                         " than the visible cards (or, on the CPU, than 1)"
                         " needs REPRO_TORCH_VIRTUAL_DEVICES=N.  With"
                         " --num-processes this counts LOCAL devices per"
                         " process; rounds plan over the"
                         " mesh x num-processes logical universe")
    ap.add_argument("--coordinator", default=None,
                    help="multi-process serving: coordinator HOST:PORT,"
                         " where process 0 hosts the coordination store"
                         " (overrides JAX_COORDINATOR_ADDRESS)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="multi-process serving: total process count"
                         " (overrides REPRO_NUM_PROCESSES)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="multi-process serving: this process's id; 0 runs"
                         " the scheduler, others the worker follower loop"
                         " (overrides REPRO_PROCESS_ID)")
    ap.add_argument("--buckets", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request SLO for admission control (calibrated"
                         " wall-ms once the calibrator converges,"
                         " accelerator-ms before)")
    ap.add_argument("--admission-quantile", type=float, default=0.95,
                    help="latency quantile SLO admission prices batches at"
                         " (scale*accel + z*resid_std from the calibrator's"
                         " residual variance); 0.5 = the historical"
                         " mean-based admit")
    ap.add_argument("--round-planner", default="adaptive",
                    choices=["fifo", "adaptive", "hybrid"],
                    help="cross-model round composition: 'adaptive' scores"
                         " serial/even/uneven splits in calibrated wall-ms"
                         " and picks the cheapest; 'hybrid' additionally"
                         " scores uneven splits whose groups host several"
                         " models back-to-back (priced at the admission"
                         " quantile); 'fifo' always deals models onto the"
                         " structural even split")
    ap.add_argument("--replan", action="store_true",
                    help="mid-flight replanning: backfill device groups"
                         " OBSERVED complete (readiness probe) with the"
                         " next warm FIFO-eligible batch (needs the"
                         " cross-model rounds --mesh turns on)")
    ap.add_argument("--probe-interval-ms", type=float, default=0.2,
                    help="pause between readiness-probe polls while the"
                         " replanner watches a dispatched round")
    ap.add_argument("--shed", action="store_true",
                    help="tenancy: an SLO'd request that would be rejected"
                         " first sheds queued work of strictly lower"
                         " priority (newest first; shed requests resolve"
                         " with status 'shed')")
    ap.add_argument("--tenant", action="append", default=None,
                    metavar="NAME:PATTERN:RATE_RPS:CLASS[:SLO_MS]",
                    help="replace the mixed burst with multi-tenant traffic"
                         " (repeatable).  PATTERN is one of poisson/bursty/"
                         "diurnal/heavy_tail, CLASS one of interactive/"
                         "batch, SLO_MS optional.  --requests becomes"
                         " per-tenant; the snapshot gains per-class and"
                         " per-tenant latency ledgers plus the fairness"
                         " index")
    ap.add_argument("--engine", default=None,
                    choices=sorted(ENGINE_CHOICES),
                    help="serving-engine implementation (the ServingEngine"
                         " factory name; default 'pipelined', or 'sync'"
                         " when --sync is given)")
    ap.add_argument("--sync", action="store_true",
                    help="drain synchronously on the caller's thread instead"
                         " of the pipelined executor (alias for"
                         " --engine sync)")
    ap.add_argument("--compilation-cache-dir", default=None,
                    help="kernel build cache directory (default:"
                         " $REPRO_TORCH_KERNEL_CACHE_DIR; unset ="
                         " build/kernels).  The CUDA kernel libraries are"
                         " built here once and a restarted process loads"
                         " them instead of running nvcc")
    ap.add_argument("--warmup-manifest", default=None,
                    help="warmup-manifest JSON path: persist the warmed"
                         " (model, bucket, group) set on cold start and"
                         " replay it on restart")
    ap.add_argument("--max-in-flight", type=int, default=2,
                    help="pipelined executor's bound on outstanding batches")
    ap.add_argument("--warm-bursts", type=int, default=0,
                    help="unmeasured bursts replayed first to feed the"
                         " latency calibrator")
    ap.add_argument("--min-calibration-samples", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", dest="json_path", default=None,
                    help="write the metrics snapshot to this path")
    args = ap.parse_args(argv)

    import os

    import numpy as np

    from repro_torch.serving.vision import (ARRIVAL_PATTERNS,
                                            LatencyCalibrator, ModelRegistry,
                                            SLO_CLASSES, SystolicCostModel,
                                            TenantSpec, create_engine,
                                            make_tenant_trace,
                                            submit_mixed_burst, submit_trace)

    if args.engine and args.sync and args.engine != "sync":
        raise SystemExit(f"--sync conflicts with --engine {args.engine}")
    engine_name = args.engine or ("sync" if args.sync else "pipelined")

    tenants = []
    for entry in args.tenant or []:
        fields = entry.split(":")
        if not 4 <= len(fields) <= 5:
            raise SystemExit(f"--tenant {entry!r} is malformed; expected "
                             f"NAME:PATTERN:RATE_RPS:CLASS[:SLO_MS]")
        name, pattern, rate, cls = fields[:4]
        if pattern not in ARRIVAL_PATTERNS:
            raise SystemExit(f"--tenant pattern {pattern!r} not in "
                             f"{ARRIVAL_PATTERNS}")
        if cls not in SLO_CLASSES:
            raise SystemExit(f"--tenant class {cls!r} not in "
                             f"{tuple(SLO_CLASSES)}")
        tenants.append(TenantSpec(
            name, pattern=pattern, rate_rps=float(rate), slo_class=cls,
            slo_ms=float(fields[4]) if len(fields) == 5 else None))

    # the multi-process topology resolves (and fails readably) before
    # any device is touched; any of the three flags — or the env trio —
    # opts in
    from repro_torch.launch.distributed import (DistributedConfigError,
                                                ENV_NUM_PROCESSES,
                                                initialize_distributed,
                                                resolve_spec)
    from repro_torch.launch.mesh import (make_data_mesh,
                                         make_multiprocess_data_mesh)
    spec = None
    if (args.coordinator or args.num_processes is not None
            or args.process_id is not None
            or os.environ.get(ENV_NUM_PROCESSES)):
        try:
            spec = resolve_spec(args.coordinator, args.num_processes,
                                args.process_id)
        except DistributedConfigError as e:
            raise SystemExit(f"multi-process serving: {e}")
        if spec.num_processes == 1:
            spec = None  # degenerate topology: plain single-process serving

    mesh = None
    mp_mesh = None
    client = None
    if spec is not None:
        if not args.mesh:
            raise SystemExit("multi-process serving needs --mesh N (local"
                             " devices per process); rounds plan over"
                             " mesh x num-processes")
        if engine_name == "sync":
            raise SystemExit("multi-process serving needs the pipelined "
                             "executor; drop --sync / --engine sync")
        if args.replan:
            raise SystemExit("--replan is not supported with multi-process"
                             " serving (workers execute published rounds"
                             " as planned)")
        try:
            mp_mesh = make_multiprocess_data_mesh(
                spec.num_processes, spec.process_id, args.mesh, args.device)
        except ValueError as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}")
        client = initialize_distributed(spec, mode="coordination")
        mesh = mp_mesh.local_mesh
    elif args.mesh:
        try:
            mesh = make_data_mesh(args.mesh, args.device)
        except ValueError as e:
            raise SystemExit(f"--mesh {args.mesh}: {e}")
        if engine_name == "sync":
            raise SystemExit("--mesh needs the pipelined executor; "
                             "drop --sync / --engine sync")

    registry = ModelRegistry(backend=args.backend, device=args.device,
                             compilation_cache_dir=args.compilation_cache_dir,
                             mesh=mesh)
    for entry in args.models:
        name, sep, variant = entry.rpartition("/")
        if not sep or not name:
            raise SystemExit(f"--models entry {entry!r} is malformed; "
                             f"expected '<zoo name>/<variant>', e.g. "
                             f"tiny_net/fuse_full")
        net = build_network(name, args.resolution)
        registry.register(net, variant, key=entry)

    if spec is not None and not spec.is_coordinator:
        run_worker_process(args, spec, client, mp_mesh, registry)
        return

    coord = None
    if spec is not None:
        from repro_torch.serving.vision import MultiprocessCoordinator
        coord = MultiprocessCoordinator(client, mp_mesh, registry)
        coord.check_mesh_agreement()

    if not 0.0 < args.admission_quantile < 1.0:
        raise SystemExit("--admission-quantile must be in (0, 1)")
    calibrator = LatencyCalibrator(min_samples=args.min_calibration_samples)
    engine = create_engine(
        registry, engine_name, cost_model=SystolicCostModel(
            calibrator=calibrator,
            n_devices=mp_mesh.global_size if mp_mesh else (args.mesh or 1),
            round_planner=args.round_planner,
            admission_quantile=args.admission_quantile,
            group_granularity=spec.num_processes if spec else 1),
        buckets=args.buckets, max_in_flight=args.max_in_flight,
        replan=args.replan, probe_interval_ms=args.probe_interval_ms,
        shed=args.shed, **({"multiprocess": coord} if coord else {}))
    if coord is not None:
        coord.metrics = engine.metrics
    try:
        engine.warmup(manifest_path=args.warmup_manifest)

        for i in range(args.warm_bursts):
            submit_mixed_burst(engine, args.requests, seed=args.seed + 1 + i)
            engine.flush()
        if args.warm_bursts:
            # warm traffic fed the calibrator; the reported snapshot should
            # describe only the measured burst
            engine.metrics.reset()

        if tenants:
            trace = make_tenant_trace(registry, tenants, args.requests,
                                      seed=args.seed)
            submit_trace(engine, trace)
        else:
            submit_mixed_burst(engine, args.requests, seed=args.seed,
                               slo_ms=args.slo_ms)
        results = engine.flush()
    except BaseException:
        engine.close(drain=False)
        raise
    for r in results:
        top1 = int(np.argmax(r.logits)) if r.logits is not None else -1
        unit = "cal-ms" if r.calibrated else "acc-ms"
        who = f" [{r.tenant}/{r.slo_class}]" if r.tenant else ""
        print(f"req {r.rid:3d} {r.model:28s} {r.status:8s} top1={top1:4d} "
              f"bucket={r.bucket} predicted={r.predicted_ms:8.3f}{unit} "
              f"measured_run={r.run_ms:8.2f}ms e2e={r.e2e_ms:8.2f}ms{who}")
    if tenants:
        snap_t = engine.metrics.snapshot()
        for cls, stat in sorted(snap_t["class_e2e"].items()):
            print(f"class {cls:12s} n={stat['count']:4d} "
                  f"p50={stat['p50_ms']:8.2f}ms p95={stat['p95_ms']:8.2f}ms")
        print(f"shed={snap_t['shed']} "
              f"fairness={snap_t['fairness_index']:.3f}")
    snap = engine.snapshot()
    comp = snap.get("compilation", {})
    pc = comp.get("persistent", {})
    print(f"compile entries_built={comp.get('entries_built', 0)} "
          f"build_ms_total={comp.get('build_ms_total', 0.0):.1f} "
          f"pcache_hits={pc.get('hits', 0)} "
          f"pcache_misses={pc.get('misses', 0)} "
          f"cache_dir={comp.get('cache_dir')} "
          f"warmup_ms={comp.get('warmup_ms', 0.0):.1f}")
    snap["calibration"] = calibrator.snapshot()
    snap["mode"] = engine_name
    snap["mesh_devices"] = mp_mesh.global_size if mp_mesh else (args.mesh
                                                                or 1)
    snap["num_processes"] = spec.num_processes if spec else 1
    snap["round_planner"] = args.round_planner
    # order-stable digest of every served logit tensor: the multiprocess
    # check compares this against a single-process run of the same burst
    digest = hashlib.sha256()
    for r in sorted(results, key=lambda r: r.rid):
        if r.logits is not None:
            digest.update(np.ascontiguousarray(r.logits).tobytes())
    snap["logits_sha256"] = digest.hexdigest()
    # the engine's resolved flag, not the CLI's: replanning needs the
    # cross-model round scheduler, so --replan without --mesh stays off
    snap["replan"] = bool(engine.replan)
    snap["admission_quantile"] = args.admission_quantile
    snap["shed_enabled"] = bool(args.shed)
    if tenants:
        snap["tenants"] = {t.name: {"pattern": t.pattern,
                                    "rate_rps": t.rate_rps,
                                    "slo_class": t.slo_class,
                                    "slo_ms": t.slo_ms}
                           for t in tenants}
    print(json.dumps(snap, indent=2, sort_keys=True))
    if args.json_path:
        with open(args.json_path, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
    engine.close()
    if coord is not None:
        # engine drained first; then release the workers
        coord.stop_workers()


if __name__ == "__main__":
    main()
