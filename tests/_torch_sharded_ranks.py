"""Four ``gloo`` ranks serving smoke LMs under a sharding policy.

    python tests/_torch_sharded_ranks.py CASES.json OUT_DIR

``CASES.json`` is a list of cases, each ``{"name", "arch", "profile",
"mesh": [data, model], "params": NPZ, "prompts", "max_new", "max_seq"}``;
``NPZ`` holds the smoke config's parameter leaves as ``arr_0``, ``arr_1``,
... in ``tree_leaves`` order (sorted keys, as ``jax.tree_util`` orders
them).  The script spawns four processes, each joins one process group
(``initialize_distributed(mode="global")`` on the CPU), and for every
case builds the (data, model) mesh, distributes the parameters by the
policy's shardings, and runs ``ServeEngine.generate`` on backend
``cuda`` (the kernel wrappers run their plain versions on CPU tensors).
Rank 0 writes ``OUT_DIR/<name>.json`` (token lists, every parameter's
spec, whether each parameter is a DTensor with its spec's placements, how
many are sharded on ``"model"``) and ``OUT_DIR/<name>.npy`` (the prefill's
full logits).  Imports only ``repro_torch``, never ``jax``.
"""
import json
import os
import socket
import sys

import numpy as np
import torch
import torch.multiprocessing as mp

WORLD = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(case: dict, rank: int, out_dir: str) -> None:
    from torch.distributed.tensor import DTensor
    from repro_torch import configs as C, tree
    from repro_torch.launch import mesh as tmesh, sharding as tsh
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = C.get_smoke_config(case["arch"])
    template = build_model(cfg).init(torch.Generator().manual_seed(0),
                                     device="cpu")
    with np.load(case["params"]) as z:
        arrays = iter([z[f"arr_{i}"] for i in range(len(z.files))])
    params = tree.tree_map(
        lambda t: torch.from_numpy(next(arrays)).to(t.dtype).reshape(t.shape),
        template)
    mesh = tmesh.make_lm_mesh(case["mesh"], "cpu")
    policy = tsh.ShardingPolicy(mesh, cfg, case["profile"])
    specs = policy.param_specs(params)
    sharded = tsh.shard_tree(params, policy.param_shardings(params))
    placed = tree.tree_leaves(tree.tree_map(
        lambda t, s: isinstance(t, DTensor)
        and tuple(t.placements) == tsh.placements(mesh, s), sharded, specs))
    engine = ServeEngine(build_model(cfg, "cuda"), sharded,
                         max_seq=case["max_seq"], batch_slots=WORLD,
                         policy=policy)
    prefill, kept = engine._prefill, []

    def keep(*args):
        logits, cache = prefill(*args)
        kept.append(logits.full_tensor())
        return logits, cache

    engine._prefill = keep
    tokens = engine.generate([Request(p, case["max_new"])
                              for p in case["prompts"]])
    if rank == 0:
        spec_list = [[list(e) if isinstance(e, tuple) else e for e in s]
                     for s in tree.tree_leaves(specs)]
        with open(os.path.join(out_dir, case["name"] + ".json"), "w") as f:
            json.dump({"tokens": tokens, "specs": spec_list,
                       "placed": placed,
                       "model_sharded": sum("model" in s for s in spec_list),
                       "prefill_calls": len(kept)}, f)
        np.save(os.path.join(out_dir, case["name"] + ".npy"),
                kept[0].numpy())


def _rank(rank: int, port: int, cases: list, out_dir: str) -> None:
    from repro_torch.launch.distributed import (DistributedSpec,
                                                initialize_distributed,
                                                shutdown_distributed)
    torch.set_num_threads(1)
    initialize_distributed(DistributedSpec(f"127.0.0.1:{port}", WORLD, rank),
                           device="cpu", timeout_s=60)
    try:
        for case in cases:
            _serve(case, rank, out_dir)
    finally:
        shutdown_distributed()


def main() -> int:
    cases_path, out_dir = sys.argv[1:3]
    with open(cases_path) as f:
        cases = json.load(f)
    mp.spawn(_rank, args=(_free_port(), cases, out_dir), nprocs=WORLD,
             join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
