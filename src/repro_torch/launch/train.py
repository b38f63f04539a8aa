"""LM training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \\
      --steps 100 --global-batch 8 --seq-len 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \\
      --smoke --device cpu --steps 20

Port of ``repro.launch.train`` on one device: the model trains in its
config's dtype (``--smoke``: the reduced same-family config, float32) on
``--device`` (``cuda`` by default), from the port's seeded init.
Checkpoints land in ``--ckpt-dir`` (``build/ckpt`` under the working
directory by default); rerunning the same command resumes from the latest
step.  The reference's multi-host flags (``--distributed``,
``--coordinator``, ``--num-processes``, ``--process-id``, ``--multi-pod``)
are accepted and exit with one line naming the ROADMAP items that will
port them.
"""
from __future__ import annotations

import argparse
import os

NOT_PORTED = {
    flag: f"--{flag.replace('_', '-')} (multi-host training) is not ported "
          f"yet: ROADMAP Queue 1 items 7 and 4.2 (training across "
          f"processes, LM sharding)"
    for flag in ("distributed", "coordinator", "num_processes",
                 "process_id", "multi_pod")}


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
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)
    for flag, message in NOT_PORTED.items():
        value = getattr(args, flag)
        if value is not None and value is not False:
            raise SystemExit(message)

    from repro_torch import configs as C
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = (C.get_smoke_config(args.arch) if args.smoke
           else C.get_config(args.arch))
    tcfg = TrainerConfig(
        steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq_len, microbatches=args.microbatches,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        grad_compression=args.grad_compression)
    out = Trainer(cfg, tcfg, device=args.device).train()
    print("final loss:", out["history"][-1]["loss"] if out["history"]
          else "n/a")
    if out["straggler_events"]:
        print("straggler events:", out["straggler_events"])


if __name__ == "__main__":
    main()
