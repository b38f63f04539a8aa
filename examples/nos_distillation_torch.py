"""Example: Neural Operator Scaffolding (paper §4 / §6.3) on the PyTorch port.

The port's counterpart of examples/nos_distillation.py.  Trains (1) an
all-depthwise teacher, (2) an in-place FuSe-Half replacement, (3) a
NOS-scaffolded student distilled from the teacher and collapsed to pure
FuSe-Half — the paper's mechanism claim that NOS recovers (part of) the
in-place accuracy drop at identical inference cost.  Runs on the card by
default; ``--device cpu`` runs the same loops on the CPU.

Run:  PYTHONPATH=src python examples/nos_distillation_torch.py [--steps 250]
      [--device cpu]
"""
import argparse
import json
import pathlib

from repro_torch.data.vision_synth import SynthVisionConfig
from repro_torch.train.vision import (VisionTrainConfig, train_nos,
                                      train_vision)
from repro_torch.vision import zoo


def nos_experiment(net: zoo.NetworkDef, dcfg: SynthVisionConfig,
                   cfg: VisionTrainConfig, *, device="cuda",
                   log_every: int = 0) -> dict:
    """The three runs; returns each run's result under ``teacher``,
    ``inplace`` and ``nos``, and the accuracies with the share of the
    in-place gap NOS recovered under ``summary``."""
    print("== teacher: all-depthwise ==")
    r_teacher = train_vision(net, "depthwise", cfg, dcfg, log_every=log_every,
                             device=device)
    print("teacher eval acc:", r_teacher["eval_acc"])

    print("== in-place replacement: FuSe-Half trained from scratch ==")
    r_inplace = train_vision(net, "fuse_half", cfg, dcfg, log_every=log_every,
                             device=device)
    print("in-place eval acc:", r_inplace["eval_acc"])

    print("== NOS: scaffolded student distilled from teacher ==")
    r_nos = train_nos(net, r_teacher["params"], cfg, dcfg,
                      log_every=log_every, device=device)
    print("NOS collapsed eval acc:", r_nos["eval_acc"])

    gap = r_teacher["eval_acc"] - r_inplace["eval_acc"]
    recovered = r_nos["eval_acc"] - r_inplace["eval_acc"]
    summary = {
        "teacher_acc": r_teacher["eval_acc"],
        "inplace_fuse_half_acc": r_inplace["eval_acc"],
        "nos_fuse_half_acc": r_nos["eval_acc"],
        "inplace_gap": gap,
        "nos_recovered": recovered,
        "recovered_fraction": (recovered / gap) if gap > 1e-9 else None,
    }
    return {"teacher": r_teacher, "inplace": r_inplace, "nos": r_nos,
            "summary": summary}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--width", type=int, default=12)
    ap.add_argument("--resolution", type=int, default=28)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--noise", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=str,
                    default="results/nos_distillation_torch.json")
    args = ap.parse_args(argv)

    net = zoo.tiny_net(num_classes=args.classes, resolution=args.resolution,
                       width=args.width)
    dcfg = SynthVisionConfig(resolution=args.resolution,
                             num_classes=args.classes, noise=args.noise)
    cfg = VisionTrainConfig(steps=args.steps, batch=args.batch,
                            eval_batches=6)
    out = dict(nos_experiment(net, dcfg, cfg, device=args.device,
                              log_every=50)["summary"], config=vars(args))
    print(json.dumps(out, indent=2))
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2))
    print("wrote", path)


if __name__ == "__main__":
    main()
