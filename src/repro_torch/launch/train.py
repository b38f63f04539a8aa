"""LM training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \\
      --steps 100 --global-batch 8 --seq-len 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \\
      --smoke --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \\
      --smoke --device cpu --distributed --coordinator 127.0.0.1:29500 \\
      --num-processes 1 --process-id 0

Port of ``repro.launch.train``: the model trains in its config's dtype
(``--smoke``: the reduced same-family config, float32) on ``--device``
(``cuda`` by default), from the port's seeded init.  Checkpoints land in
``--ckpt-dir`` (``build/ckpt`` under the working directory by default);
rerunning the same command resumes from the latest step.

``--distributed`` trains over the reference's mesh: the topology (flags,
else ``JAX_COORDINATOR_ADDRESS``, ``REPRO_NUM_PROCESSES``,
``REPRO_PROCESS_ID``) is validated before any process group forms (a bad
one exits with one ``--distributed:`` line), the global process group
comes up (``nccl`` on the card, ``gloo`` on the CPU; one process brings up
none), and the trainer runs on ``make_host_mesh`` (1x1) under ``--smoke``
or ``make_production_mesh`` (16x16, 2x16x16 with ``--multi-pod``)
otherwise.  A world the mesh does not fit exits with one line naming the
mesh and the world, on every rank.  A rerun resumes onto whatever mesh
the new job has.  Without ``--distributed`` or ``--multi-pod`` the
launcher trains on one device, without a mesh.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join("build", "ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--distributed", action="store_true",
                    help="bring up the global process group from the "
                         "coordinator env (JAX_COORDINATOR_ADDRESS, "
                         "REPRO_NUM_PROCESSES, REPRO_PROCESS_ID) or the "
                         "flags below, and train over the mesh")
    ap.add_argument("--coordinator", default=None,
                    help="coordinator HOST:PORT (overrides env)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)

    from repro_torch.launch.distributed import shutdown_distributed
    if args.distributed:
        # validate the topology before any process group forms
        from repro_torch.launch.distributed import (DistributedConfigError,
                                                    initialize_distributed,
                                                    resolve_spec)
        try:
            spec = resolve_spec(args.coordinator, args.num_processes,
                                args.process_id)
        except DistributedConfigError as e:
            raise SystemExit(f"--distributed: {e}") from None
        initialize_distributed(spec, mode="global", device=args.device)

    from repro_torch import configs as C
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.train.trainer import Trainer, TrainerConfig

    try:
        mesh = None
        if args.distributed or args.multi_pod:
            try:
                mesh = (make_host_mesh(args.device) if args.smoke else
                        make_production_mesh(multi_pod=args.multi_pod,
                                             device=args.device))
            except ValueError as e:
                raise SystemExit(str(e)) from None
            import torch.distributed as dist
            print(f"mesh: {'x'.join(map(str, mesh.mesh.shape))} "
                  f"{tuple(mesh.mesh_dim_names)} over a world-"
                  f"{dist.get_world_size()} {dist.get_backend()} group",
                  flush=True)
        cfg = (C.get_smoke_config(args.arch) if args.smoke
               else C.get_config(args.arch))
        tcfg = TrainerConfig(
            steps=args.steps, global_batch=args.global_batch,
            seq_len=args.seq_len, microbatches=args.microbatches,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            grad_compression=args.grad_compression)
        out = Trainer(cfg, tcfg, device=args.device, mesh=mesh).train()
    finally:
        shutdown_distributed()
    print("final loss:", out["history"][-1]["loss"] if out["history"]
          else "n/a")
    if out["straggler_events"]:
        print("straggler events:", out["straggler_events"])


if __name__ == "__main__":
    main()
