"""LM serving launcher: batched greedy generation with the ServeEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma_2b \
      --prompts "1 2 3" "7 8" --max-new 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_135m \
      --smoke --device cpu --prompts "1 2 3" "7 8" --max-new 8

Port of ``repro.launch.serve``, with its flags and output lines (``prompt
[...] -> [...]``).  Weights come from the port's own init with seed 0 (the
reference launcher also initializes from seed 0), drawn on ``--device``.
``--backend cuda`` (the default) runs the RG-LRU and xLSTM blocks'
temporal FuSeConv on the hand ``fuse1d`` kernel, ``torch`` every op
plainly.  The model is served in its config's dtype (``recurrentgemma_2b``
and ``xlstm_125m``: bfloat16; the smoke configs: float32).

A model that attends to a memory (``encoder_layers`` or
``num_vision_tokens``: ``whisper_tiny``, ``llama32_vision_90b``) needs
memory embeddings, and this launcher has no source of them: it exits
non-zero with one line saying so.  The reference launcher passes only
``memory_len`` for them (``src/repro/launch/serve.py:28-32``), so no memory
is built and its prefill fails; such models are served through
``ServeEngine(..., extras={"memory_embeds": ...})`` or ``{"vision_embeds":
...}``.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompts", nargs="+", default=["1 2 3 4", "9 8 7"])
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"),
                    help="cuda: the temporal conv on the hand fuse1d "
                         "kernel; torch: plain ops")
    args = ap.parse_args(argv)

    from repro_torch import configs as C

    cfg = (C.get_smoke_config(args.arch) if args.smoke
           else C.get_config(args.arch))
    if cfg.encoder_layers or cfg.num_vision_tokens:
        raise SystemExit(
            f"repro_torch.launch.serve: {cfg.name} attends to an encoder or "
            f"vision memory and this launcher has no source of memory "
            f"embeddings (the reference launcher passes only memory_len, "
            f"src/repro/launch/serve.py:28-32); serve it through ServeEngine "
            f"with extras memory_embeds or vision_embeds")

    import torch
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Request, ServeEngine

    model = build_model(cfg, backend=args.backend)
    device = torch.device(args.device)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    engine = ServeEngine(model, params, max_seq=args.max_seq,
                         batch_slots=max(len(args.prompts), 1))
    reqs = [Request([int(t) % cfg.vocab_size for t in p.split()],
                    args.max_new) for p in args.prompts]
    outs = engine.generate(reqs)
    for p, o in zip(args.prompts, outs):
        print(f"prompt [{p}] -> {o}")


if __name__ == "__main__":
    main()
