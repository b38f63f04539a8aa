"""Four ``gloo`` ranks training tiny LMs over a mesh.

    python tests/_torch_training_ranks.py SPEC.json OUT_DIR

``SPEC.json``: ``{"batches": NPZ, "psum": NPZ, "seed": int, "lr": float,
"int8_lr": float, "int8_steps": int}``.  ``NPZ`` of the batches holds, per
arch, ``<arch>/tokens`` and ``<arch>/labels``, (steps, global batch, seq)
int arrays: the batches the trainers take at steps 0, 1, ... (the
reference's ``TokenPipeline``'s, in the test).  ``psum``'s NPZ holds
``x`` (4, n) float32: rank r's input to ``compressed_psum``.

The script spawns four processes that join one process group
(``initialize_distributed(mode="global")`` on the CPU) and, for the tiny
RecurrentGemma and SmolLM configs of ``tiny_cfg``, run
``Trainer(mesh=)`` on a (data 2, model 2) mesh (``straight``: 4 steps,
``n_micro`` 2, a checkpoint every 2 steps, AdamW at ``lr`` with eps
1e-5).  For RecurrentGemma also: the same run crashed by ``fault_hook``
at step 2 and restarted (``restart``); the straight run's step-4
checkpoint restored on (4, 1) and on (1, 4) (every leaf a DTensor with
its policy's placements and bit for bit the checkpoint's); two more steps
from it on (4, 1) (``more_41``) and on (2, 2) (``more_22``);
``int8_steps`` int8 steps on (2, 2) with a checkpoint every step
(``int8``), rank 0 running one int8 step of the one-device trainer beside
them (``int8_one_device``).  Then
``compressed_psum`` over the 4 ranks of a (1, 4) mesh's ``"model"`` axis.

Every checkpoint lands in ``OUT_DIR/<arch>/<run>``.  Rank 0 writes
``OUT_DIR/<arch>_gathered.npz`` (the straight run's final parameters and
moments, gathered by ``full_tensor()``, keyed as the checkpoint),
``OUT_DIR/psum.npy`` and ``OUT_DIR/report.json`` (placements, restores,
losses).  Imports only ``repro_torch``, never ``jax``.
"""
import dataclasses
import json
import os
import shutil
import socket
import sys

import numpy as np
import torch
import torch.multiprocessing as mp

WORLD = 4
ARCHS = ("recurrentgemma_2b", "smollm_135m")
GLOBAL_BATCH, SEQ, N_MICRO, STEPS = 8, 16, 2, 4


def tiny_cfg(arch: str):
    """The smoke config at ``tests/test_torch_trainer.py``'s tiny widths
    (RecurrentGemma keeps its 3 layers and one KV head)."""
    from repro_torch import configs as C
    cfg = C.get_smoke_config(arch)
    kw = dict(vocab_size=64, d_model=32, num_heads=2, head_dim=16, d_ff=64)
    if arch == "smollm_135m":
        kw.update(num_layers=2, num_kv_heads=2)
    return dataclasses.replace(cfg, **kw)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Replay:
    """A token pipeline that hands out recorded batches."""

    def __init__(self, tokens: np.ndarray, labels: np.ndarray):
        self.tokens, self.labels = tokens, labels

    def batch_at(self, step: int) -> dict:
        return {"tokens": torch.from_numpy(self.tokens[step]).long(),
                "labels": torch.from_numpy(self.labels[step]).long()}


def _placed(tree_, specs, mesh) -> bool:
    """Every leaf a DTensor with its spec's placements on ``mesh``."""
    from torch.distributed.tensor import DTensor
    from repro_torch import tree
    from repro_torch.launch import sharding as tsh
    return all(isinstance(t, DTensor) and t.device_mesh == mesh
               and tuple(t.placements) == tsh.placements(mesh, s)
               for t, s in zip(tree.tree_leaves(tree_),
                               tree.tree_leaves(specs)))


def _train(arch, spec, out_dir, name, mesh, steps, pipe, ckpt_every=2,
           **kw):
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    lr = kw.pop("lr", spec["lr"])
    tcfg = TrainerConfig(steps=steps, global_batch=GLOBAL_BATCH,
                         seq_len=SEQ, microbatches=N_MICRO, log_every=1,
                         ckpt_every=ckpt_every, ckpt_dir=os.path.join(
                             out_dir, arch, name), seed=spec["seed"], **kw)
    trainer = Trainer(tiny_cfg(arch), tcfg, device="cpu", mesh=mesh,
                      optimizer=adamw(lr, eps=1e-5, weight_decay=0.1))
    trainer.pipeline = pipe
    return trainer


def _restored(trainer, mesh, step: int) -> dict:
    """The checkpoint at ``step`` restored onto ``mesh`` by ``trainer``'s
    manager: whether every leaf has its policy's placements and whether
    each is bit for bit the checkpoint's."""
    from repro_torch import tree
    from repro_torch.launch import sharding as tsh
    from repro_torch.launch.steps import train_step_shardings
    policy = tsh.ShardingPolicy(mesh, trainer.cfg)
    params, opt_state = trainer.state_template()
    sh = train_step_shardings(policy, params, trainer._batch_shape())[0]
    state, manifest = trainer.ckpt.restore(
        step, {"params": params, "opt": opt_state},
        shardings={"params": sh[0], "opt": sh[1]})
    specs = {"params": policy.param_specs(params)}
    specs["opt"] = {"m": specs["params"], "v": specs["params"]}
    full = [t.full_tensor() for t in tree.tree_leaves(state)]
    d = os.path.join(trainer.tcfg.ckpt_dir, f"step_{step}", "state.npz")
    with np.load(d) as z:
        keys = sorted(z.files)
        bitwise = [np.array_equal(z[k], f.numpy()) for k, f in zip(
            _keys(state), full)]
    return {"placed": _placed(state, specs, mesh),
            "bitwise": all(bitwise) and len(bitwise) == len(keys),
            "leaves": len(full), "step": manifest["step"]}


def _keys(state) -> list:
    from repro_torch import tree
    out = []
    tree.tree_map_with_path(
        lambda p, _: out.append("/".join(map(str, p))), state)
    return out


def _losses(out) -> list:
    return [h["loss"] for h in out["history"]]


def _run(rank: int, spec: dict, out_dir: str) -> None:
    from repro_torch import tree
    from repro_torch.launch import mesh as tmesh
    from repro_torch.optim.compression import compressed_psum

    report = {}
    m22 = tmesh.make_lm_mesh((2, 2), "cpu")
    m41 = tmesh.make_lm_mesh((4, 1), "cpu")
    m14 = tmesh.make_lm_mesh((1, 4), "cpu")
    with np.load(spec["batches"]) as z:
        pipes = {a: Replay(z[f"{a}/tokens"], z[f"{a}/labels"])
                 for a in ARCHS}
    for arch in ARCHS:
        rep = report[arch] = {}
        pipe = pipes[arch]
        t = _train(arch, spec, out_dir, "straight", m22, STEPS, pipe)
        out = t.train()
        rep["straight_losses"] = _losses(out)
        state = {"params": out["params"], "opt": out["opt_state"]}
        specs = {"params": t.policy.param_specs(out["params"])}
        specs["opt"] = {"m": specs["params"], "v": specs["params"]}
        rep["placed"] = _placed(state, specs, m22)
        rep["model_sharded"] = sum("model" in tuple(s) for s in
                                   tree.tree_leaves(specs["params"]))
        gathered = {k: v.full_tensor().numpy()
                    for k, v in zip(_keys(state), tree.tree_leaves(state))}
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{arch}_gathered.npz"),
                     **gathered)
        if arch != "recurrentgemma_2b":
            continue

        # a crash at step 2 (after the step-2 checkpoint), then a restart
        class Bomb(Exception):
            pass

        def hook(step):
            if step == 2:
                raise Bomb()

        t = _train(arch, spec, out_dir, "restart", m22, STEPS, pipe)
        try:
            t.train(fault_hook=hook)
            raise AssertionError("the fault hook did not fire")
        except Bomb:
            pass
        rep["crashed_latest"] = t.ckpt.latest_step()
        out = _train(arch, spec, out_dir, "restart", m22, STEPS,
                     pipe).train()
        rep["restart_logged"] = [h["step"] for h in out["history"]]

        # the (2, 2) checkpoint on other meshes, then two more steps
        for name, mesh in (("41", m41), ("14", m14)):
            rep[f"restore_{name}"] = _restored(
                _train(arch, spec, out_dir, "straight", mesh, STEPS, pipe),
                mesh, STEPS)
        src = os.path.join(out_dir, arch, "straight")
        if rank == 0:
            shutil.copytree(src, os.path.join(out_dir, arch, "more_41"))
            shutil.copytree(src, os.path.join(out_dir, arch, "more_22"))
        torch.distributed.barrier()
        for name, mesh in (("more_41", m41), ("more_22", m22)):
            out = _train(arch, spec, out_dir, name, mesh, STEPS + 2,
                         pipe).train()
            rep[f"{name}_logged"] = [h["step"] for h in out["history"]]

        # int8: a short run on the mesh (a checkpoint every step), and one
        # step on one device beside it
        out = _train(arch, spec, out_dir, "int8", m22, spec["int8_steps"],
                     pipe, ckpt_every=1, lr=spec["int8_lr"],
                     grad_compression="int8").train()
        rep["int8_losses"] = _losses(out)
        if rank == 0:
            _train(arch, spec, out_dir, "int8_one_device", None, 1, pipe,
                   lr=spec["int8_lr"], grad_compression="int8").train()
        torch.distributed.barrier()

    # compressed_psum over the 4 ranks of "model"
    with np.load(spec["psum"]) as z:
        x = torch.from_numpy(z["x"][rank])
    got = compressed_psum(x, m14, "model",
                          torch.Generator().manual_seed(100 + rank))
    if rank == 0:
        np.save(os.path.join(out_dir, "psum.npy"), got.numpy())
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(report, f)


def _rank(rank: int, port: int, spec: dict, out_dir: str) -> None:
    from repro_torch.launch.distributed import (DistributedSpec,
                                                initialize_distributed,
                                                shutdown_distributed)
    torch.set_num_threads(1)
    initialize_distributed(DistributedSpec(f"127.0.0.1:{port}", WORLD, rank),
                           device="cpu", timeout_s=60)
    try:
        _run(rank, spec, out_dir)
    finally:
        shutdown_distributed()


def main() -> int:
    spec_path, out_dir = sys.argv[1:3]
    with open(spec_path) as f:
        spec = json.load(f)
    mp.spawn(_rank, args=(_free_port(), spec, out_dir), nprocs=WORLD,
             join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
