#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--seed N] [--profile]

Phases (any failure exits non-zero, and no result line is printed):

1. card   — the card's name and power limit as nvidia-smi reports them;
2. build  — compile every kernel under src/repro_torch/kernels/csrc (one
            nvcc per source, in parallel); print build time and the
            ``-Xptxas -v`` register/shared-memory report, and fail if a
            depthwise, fused, SGEMM or FuSe-stage instantiation has a stack
            frame or spills;
3. kernels — each of the four kernels at its largest MobileNetV3-Large
            main-path shape (bucket 8) and at a ragged shape, against its
            plain PyTorch version on the card, twice (the repeat must be
            bitwise equal); then CUDA-event times of the kernel, the plain
            version and one PyTorch library call for the same function,
            beside the roofline bound from the shapes.  ``fuse1d``'s unit
            is the FuSe spatial stage (``ops.fuse_conv2d_half``, one
            launch); its 1-D form is checked and timed beside it (its
            temporal form, the LM stack's ``ops.fuse_conv1d_temporal``,
            after phase 10, below).  Then the
            same for every distinct shape of every kernel launch the main
            path makes at bucket 8 (``zoo.kernel_launches``), with the
            main-path sums (launches x ms, launches x bound) and, for
            matmul, a note of the tiling ``matmul_tiling`` picks and the
            blocks it launches (printed, not part of the ``kernels``
            line);
4. serve  — MobileNetV3-Large (224 px, width 1.0, 1000 classes, weights
            from the port's own seeded init) in ``fuse_half`` and
            ``depthwise``, 16 mixed-size requests through the synchronous
            engine on backend ``cuda``; the logits must match the
            ``torch`` backend and the ``cuda_nofused`` backend on the same
            card and weights, and every kernel's launch counter must have
            moved while serving (``pipelined=False``: one bucket-8 batch per
            model, whose launches must equal the main-path sums' weights);
5. pipeline — the same 16 requests on the same weights through the
            pipelined engine (``create_engine(..., "pipelined")`` after
            ``warmup()``), then with cross-model rounds and mid-flight
            replanning; every request must be ``ok`` within the serve
            tolerance of phase 4's ``torch`` results, every kernel's counter
            must move, and the replanning round must poll the CUDA-event
            readiness probe.  Sync and pipelined rounds are timed in turns
            (sync, pipelined, pipelined, sync, three times).  Then the
            launcher ``python -m repro_torch.launch.serve_vision`` serves
            the two models in a subprocess, 32 requests after one warm
            burst (every status ``ok``), and once more with two tenants and
            shedding (no ``error``); its per-request e2e p50/p95 and wall
            ms are printed;
6. zoo    — every paper network (224 px, width 1.0, 1000 classes) in
            ``fuse_half``, ``fuse_full``, ``depthwise`` and a hybrid
            per-stage list (20 models) on three registries (``cuda``,
            ``torch``, ``cuda_nofused``, the same seeded weights), one
            bucket-8 batch of mixed-size images per model through the sync
            engine; every request ``ok``, logits within the serve
            tolerance of ``torch``, and each kernel's counter moved by
            exactly the sum of ``zoo.kernel_launches`` over the models;
7. restart — the launcher twice as a subprocess on the 15 (network,
            variant) models with one fresh kernel cache directory under
            build/ and a warmup manifest in it: the cold run compiles each
            kernel source once and writes 60 entries; the warm run
            replays them, compiles nothing, loads the three libraries and
            serves identical logits (``logits_sha256``);
8. train  — the training path (``repro_torch.train.vision``, eager
            autograd through plain ops, as the reference trains on XLA):
            a MobileNetV3-Large teacher (224 px, width 1.0, 1000 classes)
            trained 4 steps at batch 32 in ``depthwise`` from the port's
            seeded init, then 4 NOS steps from it with the all-FuSe-Half
            collapse, BN recalibration and eval; losses and trained trees
            finite; the median step ms of teacher and NOS steps and each
            run's peak device memory; then the NOS student collapsed to a
            hybrid (``search.greedy_latency_mask(net, 0.5)`` stages
            FuSe-Half, the rest depthwise) and the all-FuSe-Half collapse
            served as phase 6 serves (within the serve tolerance of
            ``torch``, exact launch counts, all four kernels launched);
            last, ``examples/nos_distillation_torch.py``'s teacher,
            in-place and NOS runs at its scale (250 steps each), whose
            losses must fall; the three accuracies and
            ``recovered_fraction`` are printed;
9. lm     — ``recurrentgemma_2b`` at its production config (26 layers, 18
            RG-LRU, d_model 2560, vocab 256000, 2.68 B parameters) from
            the port's seeded init, in bfloat16 and then in float32, each
            serving 4 requests (prompts of 64, 200, 333 and 512 token ids
            from ``--seed``, 32 new tokens, max_seq 1024) through
            ``ServeEngine.generate`` on backends ``cuda`` and ``torch``
            with the same weights: exactly 18 ``fuse1d`` launches per
            prefill and per forward and none per decode step; the logits
            of every call within ``KERNEL_RTOL`` (fp32) or
            ``LM_BF16_RTOL`` (bf16) of ``torch`` and identical tokens;
            the temporal conv through the kernel against its plain version
            on the forward's own input at each shape it runs; prefill
            tokens/s, decode ms per step and peak device memory printed;
            then ``python -m repro_torch.launch.serve --arch
            recurrentgemma_2b`` as a subprocess (one line per prompt);
10. lm2   — (a) ``xlstm_125m`` at its production config (12 blocks
            [xm, xm, xm, xs] x 3, d_model 768, vocab 50304, 0.150 B
            parameters) served as phase 9 serves RG-2B, with the same
            traffic: exactly 12 ``fuse1d`` launches per prefill and per
            forward, 0 per decode step, none on ``torch``; the forward's
            last position against the prefill (``XLSTM_BF16_FWD_RTOL`` in
            bf16); then the launcher with ``--arch xlstm_125m``.  (b)
            ``whisper_tiny`` (4 encoder + 4 decoder layers, d_model 384,
            vocab 51865) in bf16 then fp32: a (4, 3000, 80) log-mel from
            ``--seed`` through ``fuse_whisper_stem`` on ``cuda`` (exactly 2
            centred ``fuse1d`` launches) and ``torch``, (4, 1500, 384)
            each and within tolerance; ``whisper_stem`` once for its
            output contract; each backend's stem output the
            ``memory_embeds`` of a ``ServeEngine.generate`` (prompts of 8,
            16, 24, 32 tokens, 32 new, max_seq 128): logits within
            tolerance, tokens identical, no launch in the encoder or
            decoder.  (c) ``llama32_vision_90b`` at full width cut to 10
            layers (cross layers 4 and 9; 10.66 B parameters) in fp32 on
            ``vision_embeds`` (4, 1600, 8192) from ``--seed``: a forward of
            80 tokens, a prefill of 64 and 16 teacher-forced decode steps
            each within 1e-3 of the forward's logits' scale, one generate
            of 4 requests, no kernel launch.  Each model is freed before
            the next is drawn; last, the launcher must refuse ``--arch
            whisper_tiny`` with one line;
11. moe   — ``qwen3_moe_235b`` (GQA, 128 experts top-8) cut from 94 to 8
            layers and ``deepseek_v2_236b`` (MLA, a dense layer 0, then 160
            experts top-6 + 2 shared) cut from 60 to 6, at published
            widths (about 42 GB of bf16 weights each), from the port's
            seeded init: one ``ServeEngine.generate`` each in bf16 (phase
            9's traffic), every logit finite, no kernel counter moved,
            prefill and decode times, peak memory and the prefill's share
            of dropped (token, slot) assignments printed.  Then each in
            fp32 cut to 2 layers: (a) the forward's last position against
            the prefill on its own tokens (the same groups and drops),
            within ``KERNEL_RTOL``; (b) with the capacity at the group size
            (nothing drops) a prefill of 64 and 16 decode steps (MLA's
            absorbed decode over the engine-aligned latent cache) against
            the forward over 80 tokens, within ``KERNEL_RTOL``; (c) the
            same at the published capacity within the reference's MoE
            tolerance (``MOE_DECODE_ATOL``, ``MOE_DECODE_RTOL``), the drops
            on each side printed; (d) one MoE layer on 256 tokens against
            a plain Python loop over its kept (token, slot) pairs.  Each
            model is freed before the next is drawn;
12. lm_train — (a) ``recurrentgemma_2b`` at its production config in
            bfloat16 with fp32 AdamW moments trained by
            ``train.trainer.Trainer`` (backend ``torch``: the kernels have
            no backward pass) for 4 steps of 4 x 512 tokens from the
            port's seeded init: finite losses and trained leaves, no kernel
            launched; the median step ms of steps 2-4, peak device memory
            and the final checkpoint's bytes and save seconds printed, the
            checkpoint then deleted; (b) ``linear_scan`` (the reference's
            VJP as a ``torch.autograd.Function``) at (1, 4096, 2560) fp32
            against autograd through the plain doubling scan, within 1e-5
            of each gradient's scale, both peak memories printed; (c) the
            trained parameters served as phase 9 serves its init, on the
            short traffic (prompts of 64-70 tokens, 4 new: one prefill of
            64 and 9 decode steps; 18 ``fuse1d`` launches per prefill,
            every call's logits within ``LM_BF16_RTOL`` of ``torch``,
            identical tokens); the final checkpoint is kept for phase 15;
            (d)
            ``smollm_135m`` at its production config through ``python -m
            repro_torch.launch.train`` in subprocesses, 6 steps into one
            directory and 3 then 6 steps into another (a process restart
            that resumes): the two final checkpoints within the reference's
            1e-6, bitwise equality printed; then 16 steps in process with
            int8 gradient compression and ``adamw(3e-3)``: the loss must
            fall;
13. mesh  — a data mesh of 4 logical devices of the card
            (``REPRO_TORCH_VIRTUAL_DEVICES``, a CUDA stream each):
            MobileNetV3-Large ``fuse_half`` and ``depthwise`` at 224 px,
            every bucket of (1, 2, 4, 8) on groups of width 1, 2 and 4
            through ``ModelRegistry(mesh=).apply(devices=)``, each kernel
            launched exactly stripes x its launches for one stripe, the
            logits within ``SERVE_RTOL`` of the unsharded ``torch`` and
            ``cuda`` registries, bitwise equality with ``cuda`` printed
            (and, where it fails, the kernel shapes whose stripe is not
            bitwise the whole batch's rows); each bucket-8 batch's wall
            over 1, 2 and 4 devices; the pipelined engine with cross-model
            rounds and the adaptive planner over both models (its
            reachable groups warmed, 16 requests fanned back in
            submission order within ``SERVE_RTOL`` of ``torch``, every
            kernel launched); then ``python -m
            repro_torch.launch.serve_vision`` as a coordinator and a
            worker (2 logical devices each, one fresh build directory
            and manifest) beside one process over 4, at once, with the
            checks of ``scripts/multiprocess_check_torch.py``: one mesh
            fingerprint, every request ``ok``, equal ``logits_sha256``,
            the worker executed parts and ran no nvcc, the coordinator
            built cold; the card's compute mode is printed first (an
            exclusive one fails the phase);
14. sharded — ``recurrentgemma_2b`` at its production config in bfloat16
            (phase 9's seeded init, the short traffic) served through
            ``ServeEngine(policy=ShardingPolicy(mesh, cfg))`` on backend
            ``cuda``, its parameters distributed as DTensors by the policy
            (``launch.sharding.shard_tree``) over ``make_host_mesh``: a
            world-1 ``nccl`` group, a 1x1 ("data", "model") mesh (NCCL
            refuses two ranks on one GPU: the world-4 partitioning is
            held on the CPU, ``tests/test_torch_sharded_serving.py``);
            against the unsharded ``cuda`` engine on the same weights:
            identical tokens, every call's logits within ``LM_BF16_RTOL``
            (bitwise equality printed), exactly 18 ``fuse1d`` launches per
            generate, each on a rank's local shard at (4, 64, 2560) K4
            causal bf16; prefill ms, decode ms per step and peak memory of
            both engines, and the leaves sharded on "model", printed;
15. mesh_train — on a world-1 ``nccl`` group's 1x1 mesh
            (``make_host_mesh``): (a) ``recurrentgemma_2b`` at its
            production config trained by ``Trainer(mesh=)`` (parameters,
            AdamW moments and batches placed by the sharding policy) with
            phase 12's seed, batch and steps (its init, batches and step;
            no final checkpoint: the machine caps a command's disk writes
            at 45 GiB): each loss within 2^-7 relative of phase 12's, no
            kernel launched, step ms, DTensor's cost per step and peak
            memory printed; (b) phase 12's checkpoint restored onto the mesh,
            every leaf a DTensor with its policy's placements and bit for
            bit the checkpoint's, and (a)'s final state within 2^-7 of each
            leaf's scale of it (bitwise count printed); (c) (a)'s weights
            served through ``ServeEngine(policy=)`` on ``cuda`` and
            ``torch`` (short traffic): identical tokens, 18 ``fuse1d``
            launches per generate at (4, 64, 2560) K4 causal bf16 on the
            local shard; (d) ``smollm_135m`` at its production config on
            the mesh, straight and crashed by ``fault_hook`` then
            restarted from its mesh checkpoint: bitwise equal; (e) 4 int8
            steps of it in fp32 on the mesh against one device, within
            1e-5 of each leaf's scale; (f) ``python -m
            repro_torch.launch.train --smoke --distributed
            --num-processes 1`` as a subprocess trains on its own world-1
            group's 1x1 mesh and prints its final loss.

Then the temporal form of ``fuse1d`` at each (dtype, shape, form) the
``cuda`` generates of phases 9, 10, 12, 14 and 15 and the FuSe stem launched it at
(``fuse1d.by_shape``: RG-2B x (4, 64, 2560), xLSTM (4, 64, 1536) and
(4, 64, 768) K4 causal, the stem (4, 3000, 384) K3 centred; float32 and
bfloat16), each checked against its plain version there and at T = 2,
timed beside ``F.conv1d(groups=C)`` and its bound, a row of its own in the
``kernels`` line with the launches counted at that shape.

``--profile`` adds one more served round of each engine, sync and
pipelined, under ``torch.profiler`` and prints device time by kernel and
the device's busy share of each round;
it also counts the device kernels of one call at each FuSe stage shape
(failing unless it is one) and of one ``fuse_half`` forward at bucket 8.
``--parent DIR`` also times the kernels of another tree of the repository
(``DIR/src``, for example a ``git archive`` of the parent commit unpacked
under ``build/``) at the same shapes, in a subprocess before and after
this tree's pass, and reports its times beside this tree's; its FuSe
stages are timed again with the device spin doubled, and with
``--profile`` their device kernels are counted too.
The last two lines are the ``kernels`` JSON line and the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32, CUDA cores
KERNEL_RTOL = 1e-4              # max|kernel - plain| <= 1e-4 * max(1, max|plain|)
# One bf16 step: bf16 keeps 8 significant bits, so its numbers in [1, 2)
# are 2^-7 apart and a value's rounding error is at most 2^-8 of it.  A
# kernel and its plain version that round one output differently differ by
# one step of that output, at most 2^-7 of the largest |plain|.
BF16_STEP = 2.0 ** -7
# The LM's bf16 logits, backend cuda against torch: the two differ only in
# the temporal conv's rounding (one bf16 step, 2^-8 relative, of a conv
# output in at most each of the 18 rec layers).  Each such difference
# enters a bf16 residual stream that rounds at 2^-8 again; allowing eight
# compounded roundings of 2^-8 gives 2^-5 of the logits' scale
# (max(1, max|torch|), up to the softcap of 30).
LM_BF16_RTOL = 8 * 2.0 ** -8
SERVE_RTOL = 1e-5               # max|served - reference| <= 1e-5 * max(1, max|ref|)
L2_FLUSH_BYTES = 64 << 20       # larger than the H100's 50 MB L2
SPIN_CYCLES = 4_000_000         # ~2 ms at the H100's clock: longer than the
                                # host takes to enqueue any timed call
ZOO_VARIANTS = ("fuse_half", "fuse_full", "depthwise")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    flops over the fp32 peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fuse_input_elems(n, h, w, c, k, stride, variant) -> int:
    """Elements of x (n, h, w, c) that a FuSe block's two banks read at this
    stride: the Kx1 row bank reads rows oy*s - lo_h + tap at columns ox*s,
    the 1xK column bank rows oy*s at columns ox*s - lo_w + tap (XLA-SAME
    split, as in kernels/csrc/fused.cu).  ``fuse_half`` gives the banks
    disjoint channel halves; ``fuse_full`` runs both on every channel."""
    from repro_torch.kernels.fused import same_pad
    oh, lo_h, _ = same_pad(h, k, stride)
    ow, lo_w, _ = same_pad(w, k, stride)
    taps_h = {oy * stride - lo_h + t for oy in range(oh) for t in range(k)}
    taps_w = {ox * stride - lo_w + t for ox in range(ow) for t in range(k)}
    rows_r, cols_r = taps_h & set(range(h)), {ox * stride for ox in range(ow)}
    rows_c, cols_c = {oy * stride for oy in range(oh)}, taps_w & set(range(w))
    row_px, col_px = len(rows_r) * len(cols_r), len(rows_c) * len(cols_c)
    if variant == "fuse_half":
        c_r = c // 2
        return n * (c_r * row_px + (c - c_r) * col_px)
    both = len(rows_r & rows_c) * len(cols_r & cols_c)
    return n * c * (row_px + col_px - both)


def spills(ptxas: str, names=("depthwise_kernel", "fuseconv_kernel",
                              "sgemm_kernel", "stage_direct_kernel")):
    """{mangled entry: (stack frame bytes, spill store bytes, spill load
    bytes)} of the entries of an ``-Xptxas -v`` report whose names contain
    one of ``names``."""
    out, fn = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn and any(n in fn for n in names):
            out[fn] = tuple(int(g) for g in m.groups())
    return out


def make_timer(dev, spin=SPIN_CYCLES):
    """``time_ms(fn)``: mean CUDA-event time of one call, L2 flushed (64 MB
    written) before each.  A spin of ``spin`` cycles on the device after
    the flush lets the host enqueue the whole call before the start event
    is reached, so the events time the device work and not the host's
    launch latency."""
    import torch
    flush_buf = torch.empty(L2_FLUSH_BYTES // 4, device=dev)

    def time_ms(fn, iters=20, warmup=3) -> float:
        for _ in range(warmup):
            fn()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        # a garbage collection that outlasts the spin would be timed as
        # device time (the start event fires while the host is collecting)
        gc.disable()
        try:
            for s, e in zip(starts, ends):
                flush_buf.zero_()
                torch.cuda._sleep(spin)
                s.record()
                fn()
                e.record()
        finally:
            gc.enable()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters

    return time_ms


def same_pad_nchw(x_nhwc, kh, kw, stride):
    import torch.nn.functional as F
    from repro_torch.kernels.fused import same_pad
    _, lo_h, hi_h = same_pad(x_nhwc.shape[1], kh, stride)
    _, lo_w, hi_w = same_pad(x_nhwc.shape[2], kw, stride)
    return F.pad(x_nhwc.permute(0, 3, 1, 2), (lo_w, hi_w, lo_h, hi_h))


def fused_chain(x, wr, wc, wp, variant, stride, g, bb, act):
    """cuDNN row + column banks, concat, affine, act, cuBLAS mix."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fused import ACTS
    k, c_r = wr.shape
    xr, xc = (x, x) if variant == "fuse_full" else (
        x[..., :c_r], x[..., c_r:])
    yr = F.conv2d(same_pad_nchw(xr, k, 1, stride),
                  wr.t().reshape(-1, 1, k, 1), stride=stride,
                  groups=wr.shape[1])
    yc = F.conv2d(same_pad_nchw(xc, 1, k, stride),
                  wc.t().reshape(-1, 1, 1, k), stride=stride,
                  groups=wc.shape[1])
    ysp = torch.cat([yr, yc], dim=1).permute(0, 2, 3, 1)
    ysp = ACTS[act](ysp * g + bb)
    return ysp.reshape(-1, ysp.shape[-1]) @ wp


def matmul_tiling(m: int, k: int, n: int) -> dict:
    """The SGEMM tiling the wrapper picks on this card for (m, k) @ (k, n)
    with aligned operands, and the blocks it launches."""
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels.fused import smem_optin
    bm, bn, bk, tm, stages, ks = kmm.matmul_tiling(
        m, n, k, 4 if k % 4 == 0 and n % 4 == 0 else 1, kmm.sm_count(0),
        smem_optin(0))
    return dict(bm=bm, bn=bn, bk=bk, tm=tm, stages=stages, ks=ks,
                blocks=-(-m // bm) * -(-n // bn) * ks)


LIBRARY_NAMES = {
    "matmul": "torch.matmul",
    "fuse1d": "F.conv2d(groups=C) on the padded NCHW input, row and column "
              "taps in a KxK weight",
    "fuse1d (1-D)": "F.conv1d(groups=C) on (N, C, T+K-1)",
    "fuse1d (temporal)": "F.conv1d(groups=C) on the causally padded "
                         "(B, C, T+K-1) input",
    "fuse1d (centred)": "F.conv1d(groups=C) on the zero-padded "
                        "((K-1)//2 left, K//2 right) (B, C, T+K-1) input",
    "depthwise_kxk": "F.conv2d(groups=C) on the padded input",
    "fuseconv_fused": "chain: cuDNN conv2d(groups) x2 + cat + affine + act "
                      "+ cuBLAS matmul",
}


def stage_weight(wr, wc, variant, lo_h, lo_w):
    """The (C_out, 1, K, K) depthwise weight that computes a FuSe stage as
    one ``F.conv2d(groups=C)`` on the SAME-padded input: a row tap t of
    channel j at (t, lo_w), a column tap at (lo_h, t), zero elsewhere (the
    row bank reads column ox*s, the column bank row oy*s).  ``fuse_full``
    gives each input channel two outputs, its row then its column filter
    (interleaved, where the kernel puts all rows first)."""
    import torch
    k, c_r = wr.shape
    c_c = wc.shape[1]
    if variant == "fuse_full":
        w = torch.zeros(c_r, 2, k, k, device=wr.device)
        w[:, 0, :, lo_w], w[:, 1, lo_h, :] = wr.t(), wc.t()
        return w.reshape(2 * c_r, 1, k, k)
    w = torch.zeros(c_r + c_c, 1, k, k, device=wr.device)
    w[:c_r, 0, :, lo_w], w[c_r:, 0, lo_h, :] = wr.t(), wc.t()
    return w


def shape_case(name: str, sh: dict, randn) -> dict:
    """The kernel ``name`` at shape ``sh`` (a ``zoo.kernel_launches``
    dict) on inputs from ``randn``: its call, plain version and library
    call, the bytes and flops of its bound, and a description.  A
    ``fuse1d`` dict with ``n, t, c, k`` is the 1-D primitive; with ``b, h,
    w, c, k, stride, variant`` it is a FuSe spatial stage through
    ``ops.fuse_conv2d_half``/``full`` (which this tree and its parents
    both have)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fuse1d as kf1, fused as kfu
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops as kops
    if name == "matmul":
        m, k, n = sh["m"], sh["k"], sh["n"]
        a, w = randn(m, k), randn(k, n, scale=0.25)
        return dict(run=lambda: kmm.matmul(a, w),
                    plain=lambda: kmm.matmul_plain(a, w),
                    library=lambda: torch.matmul(a, w),
                    nbytes=4 * (m * k + k * n + m * n), flops=2 * m * k * n,
                    shape=f"a ({m}, {k}) @ b ({k}, {n})")
    if name == "fuse1d" and "causal" in sh:
        # the LM stack's temporal form in its dtype: x (B, T, C), w (K, C)
        b, t, c, k = sh["b"], sh["t"], sh["c"], sh["k"]
        dt = getattr(torch, sh["dtype"])
        x, wt = randn(b, t, c).to(dt), randn(k, c, scale=0.5).to(dt)
        lo = k - 1 if sh["causal"] else (k - 1) // 2
        x_ncw = F.pad(x.permute(0, 2, 1), (lo, k - 1 - lo)).contiguous()
        w_ncw = wt.t().reshape(c, 1, k).contiguous()
        return dict(run=lambda: kops.fuse_conv1d_temporal(
                        x, wt, causal=sh["causal"]),
                    plain=lambda: kf1.fuse_temporal_plain(
                        x, wt, causal=sh["causal"]),
                    library=lambda: F.conv1d(x_ncw, w_ncw, groups=c),
                    library_name=LIBRARY_NAMES["fuse1d (temporal)"]
                    if sh["causal"] else LIBRARY_NAMES["fuse1d (centred)"],
                    nbytes=x.element_size() * (2 * b * t * c + k * c),
                    flops=2 * k * b * t * c,
                    shape=f"x ({b}, {t}, {c}) {sh['dtype']}, w ({k}, {c}), "
                          f"{'causal' if sh['causal'] else 'centred'}")
    if name == "fuse1d" and "n" in sh:
        n, t, c, k = sh["n"], sh["t"], sh["c"], sh["k"]
        xp, w1 = randn(n, t, c), randn(k, c, scale=0.5)
        t_out = t - k + 1
        x_ncl = xp.permute(0, 2, 1).contiguous()
        w_ncl = w1.t().reshape(c, 1, k).contiguous()
        return dict(run=lambda: kf1.fuse1d(xp, w1),
                    plain=lambda: kf1.fuse1d_plain(xp, w1),
                    library=lambda: F.conv1d(x_ncl, w_ncl, groups=c),
                    library_name=LIBRARY_NAMES["fuse1d (1-D)"],
                    nbytes=4 * (n * t * c + k * c + n * t_out * c),
                    flops=2 * k * n * t_out * c,
                    shape=f"x_pad ({n}, {t}, {c}), w ({k}, {c})")
    b, h, w, c, k, s = (sh[key] for key in ("b", "h", "w", "c", "k",
                                            "stride"))
    oh, ow = -(-h // s), -(-w // s)
    x = randn(b, h, w, c)
    if name == "fuse1d":
        variant = sh["variant"]
        c_r = c if variant == "fuse_full" else c // 2
        c_sp = 2 * c if variant == "fuse_full" else c
        wr, wc = randn(k, c_r, scale=0.5), randn(k, c_sp - c_r, scale=0.5)
        op = (kops.fuse_conv2d_full if variant == "fuse_full"
              else kops.fuse_conv2d_half)
        x_pad = same_pad_nchw(x, k, k, s)
        _, lo_h, _ = kfu.same_pad(h, k, s)
        _, lo_w, _ = kfu.same_pad(w, k, s)
        w_oihw = stage_weight(wr, wc, variant, lo_h, lo_w)
        return dict(run=lambda: op(x, wr, wc, stride=s),
                    plain=lambda: kf1.fuse_stage_plain(
                        x, wr, wc, variant=variant, stride=s),
                    library=lambda: F.conv2d(x_pad, w_oihw, stride=s,
                                             groups=c),
                    nbytes=4 * (fuse_input_elems(b, h, w, c, k, s, variant)
                                + k * c_sp + b * oh * ow * c_sp),
                    flops=2 * k * b * oh * ow * c_sp,
                    shape=f"x ({b}, {h}, {w}, {c}), {variant} K{k} "
                          f"stride {s}")
    if name == "depthwise_kxk":
        wd = randn(k, k, c, scale=0.3)
        x_pad = same_pad_nchw(x, k, k, s)
        w_oihw = wd.permute(2, 0, 1).unsqueeze(1).contiguous()
        return dict(run=lambda: kfu.depthwise_kxk(x, wd, stride=s),
                    plain=lambda: kfu.depthwise_kxk_plain(x, wd, stride=s),
                    library=lambda: F.conv2d(x_pad, w_oihw, stride=s,
                                             groups=c),
                    nbytes=4 * (x.numel() + wd.numel() + b * oh * ow * c),
                    flops=2 * k * k * b * oh * ow * c,
                    shape=f"x ({b}, {h}, {w}, {c}), K{k} stride {s}")
    variant, cout, act = sh["variant"], sh["cout"], sh["act"]
    c_r = c if variant == "fuse_full" else c // 2
    c_sp = 2 * c if variant == "fuse_full" else c
    wr, wc = randn(k, c_r, scale=0.5), randn(k, c_sp - c_r, scale=0.5)
    wp, g, bb = randn(c_sp, cout, scale=0.2), randn(c_sp, scale=0.5), \
        randn(c_sp)
    kw = dict(variant=variant, stride=s, scale=g, bias=bb, act=act)
    return dict(
        run=lambda: kfu.fuseconv_fused(x, wr, wc, wp, **kw),
        plain=lambda: kfu.fuseconv_fused_plain(x, wr, wc, wp, **kw),
        library=lambda: fused_chain(x, wr, wc, wp, variant, s, g, bb, act),
        nbytes=4 * (fuse_input_elems(b, h, w, c, k, s, variant)
                    + wr.numel() + wc.numel() + 2 * c_sp + wp.numel()
                    + b * oh * ow * cout),
        flops=b * oh * ow * (2 * k * c_sp + 2 * c_sp + 2 * c_sp * cout),
        shape=f"x ({b}, {h}, {w}, {c}), {variant} K{k} stride {s}, "
              f"w_pw ({c_sp}, {cout}), {act}")


def is_stage(name: str, sh: dict) -> bool:
    return name == "fuse1d" and "variant" in sh


def device_kernels(fn):
    """(count, names) of the device kernels and copies that one call of
    ``fn`` runs, from ``torch.profiler`` (after one untraced call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return sum(e.count for e in rows), sorted(e.key[:60] for e in rows)


def forward_kernels(seed: int, dev) -> int:
    """Device kernels and copies of one MobileNetV3-Large ``fuse_half``
    forward at bucket 8 (224 px) on backend ``cuda``."""
    import torch
    from repro_torch.vision import zoo
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = zoo.mobilenet_v3_large()
    params = zoo.init_network(torch.Generator().manual_seed(seed), net,
                              "fuse_half", device=dev)
    x = torch.randn(8, 224, 224, 3, generator=torch.Generator()
                    .manual_seed(seed)).to(dev)
    return device_kernels(lambda: zoo.apply_network(
        params, net, x, "fuse_half", backend="cuda"))[0]


def time_kernels_only(shapes_json: str, out_json: str, seed: int,
                      profile: bool) -> int:
    """``--time-only``: time this process's ``repro_torch`` kernels (the
    tree whose ``src`` is first on ``sys.path``) at the shapes listed in
    ``shapes_json``; write to ``out_json`` their ms, the FuSe stages' ms
    with the device spin doubled and, with ``profile``, the device kernels
    of one call at each stage shape and of one fuse_half forward."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    _build.build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    time_ms, time_ms_2 = make_timer(dev), make_timer(dev, 2 * SPIN_CYCLES)
    with open(shapes_json) as f:
        shapes = json.load(f)
    out = dict(ms=[], ms_spin2=[], kernels=[])
    for name, sh in shapes:
        run = shape_case(name, sh, randn)["run"]
        stage = is_stage(name, sh)
        out["ms"].append(time_ms(run))
        out["ms_spin2"].append(time_ms_2(run) if stage else None)
        out["kernels"].append(device_kernels(run)[0] if stage and profile
                              else None)
    out["forward_kernels"] = forward_kernels(seed, dev) if profile else None
    with open(out_json, "w") as f:
        json.dump(out, f)
    return 0


def parent_times(parent: str, shapes, seed: int, profile: bool) -> dict:
    """``time_kernels_only``'s results for the tree at ``parent`` at
    ``shapes``, from a subprocess that imports that tree's ``src``."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    sj = os.path.join(ROOT, "build", "parent_shapes.json")
    oj = os.path.join(ROOT, "build", "parent_ms.json")
    with open(sj, "w") as f:
        json.dump(shapes, f)
    subprocess.run([sys.executable, os.path.abspath(__file__), "--time-only",
                    sj, oj, "--src", os.path.join(parent, "src"),
                    "--seed", str(seed)] + (["--profile"] if profile else []),
                   check=True, timeout=900)
    with open(oj) as f:
        return json.load(f)


def profile_round(run, label: str) -> float:
    """Device time by kernel and the device's busy share over one round;
    returns the busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only (kernels, copies): a host op's row repeats the
    # device time of the kernels it launched
    attr = "self_device_time_total"
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and getattr(e, attr)),
                  key=lambda e: getattr(e, attr), reverse=True)
    busy_ms = sum(getattr(e, attr) for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    print(f"profile: {label} wall {wall_ms:.2f} ms (traced), device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}), {launches} device "
          f"kernels and copies")
    for e in rows[:20]:
        print(f"  {getattr(e, attr) / 1e3:9.3f} ms {e.count:5d}x  "
              f"{e.key[:90]}")
    return busy_ms / wall_ms


# the launcher's command in phase 5: the two served models at full width
LAUNCH_MODELS = ("mobilenet_v3_large/fuse_half",
                 "mobilenet_v3_large/depthwise")
LAUNCH_TENANTS = ("--shed", "--tenant", "search:poisson:150:interactive:40",
                  "--tenant", "ads:bursty:50:batch")
LAUNCH_REQ = re.compile(r"^req +\d+ \S+ +(\S+) .* e2e= *([\d.]+)ms")


def submit_round(engine, keys, images):
    """Submit ``images`` round-robin over ``keys`` and flush: the results
    in submission order and the wall seconds from the first submit to the
    flush's return."""
    t0 = time.perf_counter()
    rids = [engine.submit(keys[i % len(keys)], img)
            for i, img in enumerate(images)]
    results = {r.rid: r for r in engine.flush()}
    return [results[rid] for rid in rids], time.perf_counter() - t0


def check_served(label, served, reference) -> float:
    """Fail unless every request is ``ok`` with finite logits of the
    reference's shape within ``SERVE_RTOL`` of it; returns the worst
    max|d| / scale."""
    import numpy as np
    worst = 0.0
    for i, (r, ref) in enumerate(zip(served, reference)):
        if r.status != "ok":
            raise SystemExit(f"{label}: request {i} status {r.status} "
                             f"({r.error})")
        if r.logits.shape != ref.logits.shape \
                or not np.all(np.isfinite(r.logits)):
            raise SystemExit(f"{label}: request {i}: bad logits "
                             f"{r.logits.shape}")
        scale = max(1.0, float(np.abs(ref.logits).max()))
        d = float(np.abs(r.logits - ref.logits).max()) / scale
        if d > SERVE_RTOL:
            raise SystemExit(f"{label}: request {i}: logits off the "
                             f"reference by {d:.2e} of the scale")
        worst = max(worst, d)
    return worst


def run_launcher(extra, json_path, timeout=600, models=None):
    """``python -m repro_torch.launch.serve_vision`` in a subprocess on
    ``models`` (default: phase 5's): (statuses, e2e ms, snapshot) of its
    measured pass; fails unless it exits with 0."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([env["PYTHONPATH"]]
                                       if env.get("PYTHONPATH") else []))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_vision",
           "--models", *(models or LAUNCH_MODELS), "--json", json_path,
           *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"launcher {' '.join(extra)} exited with "
                         f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    rows = [m.groups() for m in map(LAUNCH_REQ.match,
                                    proc.stdout.splitlines()) if m]
    with open(json_path) as f:
        snap = json.load(f)
    print(f"launcher {' '.join(extra)}: exit 0 in {seconds:.1f} s "
          f"(process start, model init, warmup and traffic)")
    return [st for st, _ in rows], [float(ms) for _, ms in rows], snap


def launcher_line(e2e, snap) -> str:
    """Per-request e2e p50/p95 (all requests) and the measured pass's wall
    ms (first submit to last batch, from the snapshot's throughput)."""
    e2e = sorted(e2e)
    pick = lambda q: e2e[min(len(e2e) - 1, int(q * len(e2e)))]
    wall_ms = (snap["completed"] / snap["throughput_ips"] * 1e3
               if snap["throughput_ips"] else float("nan"))
    return (f"{snap['completed']} completed, e2e p50 {pick(0.5):.2f} ms "
            f"p95 {pick(0.95):.2f} ms, wall {wall_ms:.1f} ms, batches "
            f"{snap['batches']}, host busy {snap['host_busy_s'] * 1e3:.1f} "
            f"ms, device stage busy {snap['device_busy_s'] * 1e3:.1f} ms, "
            f"peak in flight {snap['max_in_flight']}")


def pipeline_phase(reg, keys, images, reference, serve, serve_s,
                   launch_extra=()):
    """Phase 5 on registry ``reg`` (see the module docstring; ``serve_s``
    is phase 4's sync round): returns {round name: launch counts} and the
    two pipelined engines (warm, for the profiled round; the caller closes
    them)."""
    out, engines = {}, {}
    try:
        pipeline_rounds(reg, keys, images, reference, serve, serve_s, out,
                        engines)
        launcher_runs(launch_extra)
    except BaseException:
        for engine in engines.values():
            engine.close(drain=False)
        raise
    return out, engines


def launcher_runs(launch_extra=()):
    """The launcher as a user starts it: 32 requests after one warm burst
    (every status ``ok``), then two tenants with shedding (no ``error``)."""
    json_path = os.path.join(ROOT, "build", "serve_vision.json")
    os.makedirs(os.path.dirname(json_path), exist_ok=True)
    statuses, e2e, snap = run_launcher(
        ["--requests", "32", "--warm-bursts", "1", *launch_extra], json_path)
    if snap["completed"] != 32 or len(statuses) != 32 \
            or set(statuses) != {"ok"}:
        raise SystemExit(f"launcher: completed {snap['completed']}, "
                         f"statuses {collections.Counter(statuses)}")
    print(f"launcher 32 requests: {launcher_line(e2e, snap)}")
    statuses, e2e, snap = run_launcher(
        [*LAUNCH_TENANTS, "--requests", "32", *launch_extra],
        os.path.join(ROOT, "build", "serve_vision_tenants.json"))
    if "error" in statuses or snap["errors"]:
        raise SystemExit(f"launcher with tenants: statuses "
                         f"{collections.Counter(statuses)}")
    print(f"launcher tenants: statuses {dict(collections.Counter(statuses))},"
          f" shed {snap['shed']}, rejected {snap['rejected']}, class e2e "
          + ", ".join(f"{c} p50 {st['p50_ms']:.2f} p95 {st['p95_ms']:.2f} ms"
                      for c, st in sorted(snap["class_e2e"].items())))


def pipeline_rounds(reg, keys, images, reference, serve, serve_s, out,
                    engines):
    """The checked pipelined rounds of phase 5 and the timed turns; fills
    ``out`` (round name: launch counts) and ``engines`` (round name: its
    engine, left open)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.serving.vision import create_engine
    for name, kw in (("pipelined", {}),
                     ("rounds+replan", dict(cross_model=True, replan=True))):
        engine = create_engine(reg, "pipelined", buckets=(1, 2, 4, 8), **kw)
        engines[name] = engine
        t0 = time.perf_counter()
        engine.warmup()
        warm_s = time.perf_counter() - t0
        kops.reset_launch_counts()
        served, wall_s = submit_round(engine, keys, images)
        counts = kops.launch_counts()
        snap = engine.snapshot()
        worst = check_served(f"pipeline {name}", served, reference)
        missing = [k for k, c in counts.items() if c == 0]
        if missing:
            raise SystemExit(f"pipeline {name}: kernels never launched: "
                             f"{missing}")
        buckets = collections.Counter(
            (r.model.split("/")[1], r.bucket, r.batch_fill) for r in served)
        print(f"pipeline {name}: 16 requests in {wall_s * 1e3:.1f} ms "
              f"(phase 4 sync: {serve_s * 1e3:.1f} ms; this engine's "
              f"warmup {warm_s:.1f} s), worst max|d ref| / scale "
              f"{worst:.2e}, batches {snap['batches']}, (variant, bucket, "
              f"fill) x requests {dict(sorted(buckets.items()))}, host "
              f"stage {snap['host_busy_s'] * 1e3:.2f} ms, device stage "
              f"{snap['device_busy_s'] * 1e3:.2f} ms, overlap "
              f"{snap['overlap_ratio']:.2f}, peak in flight "
              f"{snap['max_in_flight']}, launches {counts}")
        if kw:
            if snap["probe_polls"] <= 0:
                raise SystemExit("pipeline rounds+replan: the readiness "
                                 "probe was never polled")
            print(f"pipeline {name}: rounds {snap['rounds']}, replans "
                  f"{snap['replans']}, recovered "
                  f"{snap['replan_idle_recovered_ms']:.3f} ms, probe polls "
                  f"{snap['probe_polls']}")
        out[name] = counts
    # sync and pipelined in turns on the same registry and images: three
    # times (sync, pipelined, pipelined, sync)
    walls = {"sync": [], "pipelined": []}
    for kind in ("sync", "pipelined", "pipelined", "sync") * 3:
        if kind == "sync":
            t0 = time.perf_counter()
            served, _ = serve(reg)
            wall_s = time.perf_counter() - t0
        else:
            served, wall_s = submit_round(engines["pipelined"], keys, images)
        check_served(f"pipeline turn {kind}", served, reference)
        walls[kind].append(wall_s * 1e3)
    for kind, ms in walls.items():
        print(f"pipeline turns, {kind}: 16 requests in "
              + ", ".join(f"{t:.1f}" for t in ms)
              + f" ms (median {sorted(ms)[len(ms) // 2]:.1f})")

def hybrid(net):
    """The hybrid per-stage variant list: ``depthwise``, ``fuse_half``,
    ``fuse_full`` in turn over the network's spatial stages."""
    cycle = ("depthwise", "fuse_half", "fuse_full")
    return tuple(cycle[i % 3] for i in range(net.num_spatial_stages))


def zoo_models(nets=None):
    """Phase 6's models as (key, network, variant): every paper network
    (224 px, width 1.0, 1000 classes unless ``nets`` gives others) in
    ``fuse_half``, ``fuse_full``, ``depthwise`` and its hybrid."""
    from repro_torch.serving.vision import default_model_key
    from repro_torch.vision import zoo
    nets = nets or [f() for f in zoo.ZOO.values()]
    return [(default_model_key(net.name, v), net, v)
            for net in nets for v in ZOO_VARIANTS + (hybrid(net),)]


def zoo_phase(seed: int, device="cuda", nets=None) -> dict:
    """Phase 6: the 20 models of ``zoo_models`` with seeded weights,
    served by ``serve_checked``.  Returns the launch counts."""
    t_phase = time.perf_counter()
    counts = serve_checked("zoo", [(key, net, v, None) for key, net, v
                                   in zoo_models(nets)], seed, device)
    print(f"zoo: phase wall {time.perf_counter() - t_phase:.1f} s")
    return counts


def serve_checked(label: str, models, seed: int, device="cuda") -> dict:
    """``models`` as (key, network, variant, params) on three registries
    (``cuda``, ``torch``, ``cuda_nofused``) with the same weights (params
    ``None``: the port's init from ``seed`` + the model's index), one
    bucket-8 batch of mixed-size images per model through the sync engine
    (``pipelined=False``: a fixed batch composition, so exact launch
    counts).  Every request ``ok``; ``cuda`` and ``cuda_nofused`` logits
    within ``SERVE_RTOL`` of ``torch``; every kernel's counter, zeroed just
    before the measured ``cuda`` round and read just after, moved by
    exactly the sum of ``zoo.kernel_launches`` over the models.  Returns
    the counts."""
    import numpy as np
    from repro_torch.kernels import ops as kops
    from repro_torch.serving.vision import ModelRegistry, VisionServeEngine
    from repro_torch.vision import zoo
    regs = {bk: ModelRegistry(backend=bk, device=device)
            for bk in ("cuda", "torch", "cuda_nofused")}
    for i, (key, net, v, params) in enumerate(models):
        m = regs["cuda"].register(net, v, key=key, params=params,
                                  seed=seed + i)
        for bk in ("torch", "cuda_nofused"):
            regs[bk].register(net, v, key=key, params=m.params)
    img_rng = np.random.default_rng((seed, 6))
    items = []
    for _ in range(8):
        for key, net, _v, _p in models:
            # 160-288 px at 224, as phase 4's requests
            lo, hi = (net.resolution * 5) // 7, (net.resolution * 9) // 7
            items.append((key, img_rng.standard_normal(
                (int(img_rng.integers(lo, hi + 1)),
                 int(img_rng.integers(lo, hi + 1)), 3)).astype(np.float32)))

    def serve(reg):
        engine = VisionServeEngine(reg, buckets=(1, 2, 4, 8),
                                   pipelined=False)
        rids = [engine.submit(key, img) for key, img in items]
        results = {r.rid: r for r in engine.flush()}
        engine.close()
        return [results[rid] for rid in rids], engine.snapshot()

    serve(regs["cuda"])              # first run of every model
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    served, snap = serve(regs["cuda"])
    wall_s = time.perf_counter() - t0
    counts = kops.launch_counts()
    reference, _ = serve(regs["torch"])
    nofused, _ = serve(regs["cuda_nofused"])
    worst = check_served(f"{label} cuda", served, reference)
    worst_nof = check_served(f"{label} cuda_nofused", nofused, reference)
    if snap["batches"] != len(models) or {r.bucket for r in served} != {8}:
        raise SystemExit(f"{label}: {snap['batches']} batches over buckets "
                         f"{sorted({r.bucket for r in served})}, not one "
                         f"bucket-8 batch per model")
    expected = collections.Counter(
        name for _, net, v, _p in models
        for name, _ in zoo.kernel_launches(net, v, 8))
    print(f"{label}: {len(models)} models, {len(items)} requests in "
          f"{wall_s * 1e3:.1f} ms through the sync engine, worst max|d "
          f"torch| / scale {worst:.2e} (cuda_nofused {worst_nof:.2e}, "
          f"tolerance {SERVE_RTOL}), launches {counts}")
    for name in sorted(expected):
        print(f"{label} launches {name}: {counts.get(name, 0)} while "
              f"serving, {expected[name]} in zoo.kernel_launches over the "
              f"models")
    if dict(counts) != dict(expected):
        raise SystemExit(f"{label}: launch counts {counts} are not the "
                         f"{dict(expected)} that zoo.kernel_launches lists")
    run_ms = {}
    for r in served:
        run_ms.setdefault(r.model, r.run_ms)
    for key, ms in run_ms.items():
        print(f"  {label} batch {key:34s} bucket 8: {ms:8.2f} ms")
    return counts


def train_phase(seed: int, device="cuda", net=None, data_cfg=None,
                example_steps: int = 250) -> dict:
    """Phase 8: NOS training of ``net`` (default MobileNetV3-Large, 224 px,
    width 1.0, 1000 classes) and serving what it trained.

    A depthwise teacher (``train_vision``, 4 steps at batch 32 from the
    port's seeded init), then ``train_nos`` from it (4 steps, its
    all-FuSe-Half collapse, ``recalibrate_bn`` over 25 batches and
    ``evaluate``); every logged loss and every leaf of the trained trees
    finite; the median ms of 3 more teacher and NOS steps (each between
    synchronizes) and each run's peak device memory.  Then the student
    collapsed to the hybrid (stages in ``search.greedy_latency_mask(net,
    0.5)`` FuSe-Half, the rest depthwise; BN recalibrated) and the
    all-FuSe-Half collapse, served by ``serve_checked``, which must move
    all four kernel counters.  Last, ``examples/nos_distillation_torch.py``'s
    three runs at its scale (``tiny_net(8, 28, 12)``, noise 0.5,
    ``example_steps`` steps, batch 48): losses finite and the last 10
    steps' mean below the first 10's in each run.  Returns the launch
    counts of the served round."""
    import statistics

    import torch
    from repro_torch.core import nos, search
    from repro_torch.data.vision_synth import (SynthVisionConfig,
                                               synth_image_batch)
    from repro_torch.optim import sgd_momentum
    from repro_torch.train import vision as tv
    from repro_torch.tree import tree_leaves
    from repro_torch.vision import zoo
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from nos_distillation_torch import nos_experiment

    t_phase = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    net = net or zoo.mobilenet_v3_large()
    dcfg = data_cfg or SynthVisionConfig(resolution=224, num_classes=1000)
    cfg = tv.VisionTrainConfig(steps=4, batch=32, eval_batches=1, seed=seed)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def check_finite(label, losses, *trees):
        bad = [i for i, x in enumerate(losses) if not math.isfinite(x)]
        if bad or not losses:
            raise SystemExit(f"train {label}: losses {losses} (steps {bad} "
                             f"not finite)")
        for tree in trees:
            for leaf in tree_leaves(tree):
                if not bool(torch.isfinite(leaf).all()):
                    raise SystemExit(f"train {label}: a trained leaf of "
                                     f"shape {tuple(leaf.shape)} is not "
                                     f"finite")

    def run(label, fn):
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        sync()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        print(f"train {label}: {time.perf_counter() - t0:.1f} s, "
              f"max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB)")
        return out, peak

    def step_ms(step, state):
        times = []
        for s in range(3):
            batch = synth_image_batch(100 + s, cfg.batch, dcfg, device=device)
            sync()
            t0 = time.perf_counter()
            state = step(state, s, batch)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), times

    # -- teacher and NOS ------------------------------------------------------
    teacher, teacher_peak = run(
        f"teacher ({net.name} depthwise, {dcfg.resolution} px, "
        f"{dcfg.num_classes} classes, {cfg.steps} steps at batch "
        f"{cfg.batch})",
        lambda: tv.train_vision(net, "depthwise", cfg, dcfg, device=device))
    check_finite("teacher", teacher["losses"], teacher["params"])
    student, nos_peak = run(
        f"NOS ({cfg.steps} steps, all-FuSe-Half collapse, recalibrate_bn "
        f"over 25 batches, evaluate)",
        lambda: tv.train_nos(net, teacher["params"], cfg, dcfg,
                             device=device))
    check_finite("NOS", student["losses"], student["scaffold_params"],
                 student["collapsed_params"])
    print(f"train losses: teacher {teacher['losses']}, NOS "
          f"{student['losses']}; eval acc teacher {teacher['eval_acc']}, "
          f"NOS all-FuSe-Half collapse {student['eval_acc']}")

    opt = sgd_momentum(cfg.lr, cfg.momentum, cfg.weight_decay)
    n_stages = net.num_spatial_stages
    t_ms, t_all = step_ms(
        lambda st, s, b: tv.train_step(*st, s, b, net=net,
                                       variant="depthwise", opt=opt)[:2],
        (teacher["params"], opt.init(teacher["params"])))
    n_ms, n_all = step_ms(
        lambda st, s, b: tv.nos_step(
            *st, s, b, tv.nos_choices(cfg, s, n_stages, 0.5).to(device),
            net=net, teacher_params=teacher["params"],
            nos_cfg=nos.NOSConfig(), opt=opt)[:2],
        (student["scaffold_params"], opt.init(student["scaffold_params"])))
    print(f"train step ms (median of 3, synchronized): teacher {t_ms:.1f} "
          f"({', '.join(f'{t:.1f}' for t in t_all)}), NOS {n_ms:.1f} "
          f"({', '.join(f'{t:.1f}' for t in n_all)}); max_memory_allocated "
          f"teacher {teacher_peak} B, NOS {nos_peak} B")
    if cuda:
        print(card_line())

    # -- serve the hybrid -------------------------------------------------------
    mask = search.greedy_latency_mask(net, 0.5)
    hybrid, hybrid_variants = nos.collapse(
        student["scaffold_params"], net, keep_depthwise=[not m for m in mask])
    hybrid = tv.recalibrate_bn(hybrid, net, hybrid_variants, cfg, dcfg,
                               device=device)
    print(f"train hybrid: greedy_latency_mask(net, 0.5) keeps "
          f"{hybrid_variants.count('depthwise')} of {n_stages} stages "
          f"depthwise: {''.join('F' if m else 'd' for m in mask)}")
    models = [(f"{net.name}/nos_fuse_half", net, tuple(student["variants"]),
               student["collapsed_params"]),
              (f"{net.name}/nos_hybrid", net, tuple(hybrid_variants), hybrid)]
    counts = serve_checked("train serve", models, seed, device)
    if not all(counts.get(name) for name in
               ("fuseconv_fused", "depthwise_kxk", "fuse1d", "matmul")):
        raise SystemExit(f"train serve: a kernel never launched: {counts}")

    # -- the mechanism at the example's scale ---------------------------------
    t0 = time.perf_counter()
    exp = nos_experiment(
        zoo.tiny_net(num_classes=8, resolution=28, width=12),
        SynthVisionConfig(resolution=28, num_classes=8, noise=0.5),
        tv.VisionTrainConfig(steps=example_steps, batch=48, eval_batches=6,
                             seed=seed), device=device)
    for label in ("teacher", "inplace", "nos"):
        r = exp[label]
        params = r["params"] if label != "nos" else r["collapsed_params"]
        check_finite(f"example {label}", r["losses"], params)
        first = sum(r["losses"][:10]) / 10
        last = sum(r["losses"][-10:]) / 10
        print(f"train example {label}: loss mean of the first 10 steps "
              f"{first:.4f}, of the last 10 {last:.4f}, eval acc "
              f"{r['eval_acc']}")
        if not last < first:
            raise SystemExit(f"train example {label}: the loss did not "
                             f"fall ({first:.4f} -> {last:.4f})")
    print(f"train example: {json.dumps(exp['summary'])} in "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"train: phase wall {time.perf_counter() - t_phase:.1f} s")
    return counts


def restart_phase(models, expect_builds, launch_extra=()) -> None:
    """Phase 7: the launcher twice as a subprocess on ``models``, one
    fresh kernel cache directory under build/ and a warmup manifest in it
    (``--engine sync``; plans kept on the uncalibrated cost model, so both
    runs form the same batches).  The cold run must compile each kernel
    source once (``expect_builds`` misses) and write one manifest entry per
    (model, bucket); the warm run must replay the manifest, compile
    nothing, load every source from the directory and serve the same
    logits bit for bit.  Every status ``ok``."""
    import shutil
    cache = os.path.join(ROOT, "build", "restart_cache")
    shutil.rmtree(cache, ignore_errors=True)
    manifest = os.path.join(cache, "warmup_manifest.json")
    runs = {}
    for label in ("cold", "warm"):
        statuses, _, snap = run_launcher(
            ["--engine", "sync", "--min-calibration-samples", "1000",
             "--requests", str(2 * len(models)),
             "--compilation-cache-dir", cache,
             "--warmup-manifest", manifest, *launch_extra],
            os.path.join(ROOT, "build", f"restart_{label}.json"),
            timeout=900, models=models)
        comp, pc = snap["compilation"], snap["compilation"]["persistent"]
        print(f"restart {label}: manifest replayed "
              f"{comp['manifest_replayed']}, {comp['warmup_entries']} "
              f"entries, warmup_ms {comp['warmup_ms']:.1f}, build cache "
              f"hits {pc['hits']} misses {pc['misses']} (nvcc "
              f"{pc['compile_s']:.1f} s), statuses "
              f"{dict(collections.Counter(statuses))}")
        if set(statuses) != {"ok"} or len(statuses) != 2 * len(models):
            raise SystemExit(f"restart {label}: statuses "
                             f"{collections.Counter(statuses)}")
        runs[label] = snap
    cold, warm = runs["cold"]["compilation"], runs["warm"]["compilation"]
    with open(manifest) as f:
        entries = json.load(f)["entries"]
    want = len(models) * 4
    if cold["manifest_replayed"] or cold["persistent"]["misses"] \
            != expect_builds or len(entries) != want:
        raise SystemExit(f"restart cold: replayed "
                         f"{cold['manifest_replayed']}, misses "
                         f"{cold['persistent']['misses']} (want "
                         f"{expect_builds}), {len(entries)} manifest "
                         f"entries (want {want})")
    if not warm["manifest_replayed"] or warm["persistent"]["misses"] \
            or warm["persistent"]["hits"] != expect_builds \
            or warm["warmup_pcache_misses"]:
        raise SystemExit(f"restart warm: replayed "
                         f"{warm['manifest_replayed']}, persistent "
                         f"{warm['persistent']}, warmup misses "
                         f"{warm['warmup_pcache_misses']}")
    if runs["cold"]["logits_sha256"] != runs["warm"]["logits_sha256"]:
        raise SystemExit("restart: the warm run's logits differ from the "
                         "cold run's")
    print(f"restart: warm run replayed {len(entries)} entries with 0 "
          f"misses and {warm['persistent']['hits']} hits, identical "
          f"logits_sha256 {runs['warm']['logits_sha256'][:16]}; warmup_ms "
          f"cold {cold['warmup_ms']:.1f}, warm {warm['warmup_ms']:.1f}")


# phase 9: RecurrentGemma-2B at its production config, served through the
# ServeEngine; a chat-style batch of mixed prompt lengths
LM_ARCH = "recurrentgemma_2b"
LM_PROMPT_LENS = (64, 200, 333, 512)
LM_MAX_NEW, LM_MAX_SEQ, LM_SLOTS = 32, 1024, 4
LM_LAUNCH_NEW = 16
# the short traffic of phases 12 (c), 14 and 15 (c): one prefill of 64
# tokens, as phase 9's, then 9 decode steps (phase 9 pays for the long
# generate: 479 steps)
SHORT_PROMPT_LENS, SHORT_MAX_NEW = (64, 66, 68, 70), 4
LM_LINE = re.compile(r"^prompt \[([\d ]*)\] -> \[([\d, ]*)\]$")
# the layer kinds that open with a temporal FuSeConv (one fuse1d launch each
# per forward or prefill on backend cuda)
CONV_KINDS = ("rec", "xm", "xs")
# phase 10: xLSTM-125M as phase 9 serves RG-2B; Whisper-tiny on the FuSe
# stem's memory (30 s of audio: 3000 frames of 80 mel bins); the cross-
# attention VLM at full width cut to 10 layers, on seeded vision embeddings
XLSTM_ARCH = "xlstm_125m"
WHISPER_ARCH, N_MELS = "whisper_tiny", 80
WHISPER_PROMPT_LENS, WHISPER_MAX_SEQ = (8, 16, 24, 32), 128
VLM_ARCH, VLM_LAYERS = "llama32_vision_90b", 10
VLM_TOKENS, VLM_PREFILL = 80, 64
VLM_PROMPT_LENS, VLM_MAX_NEW, VLM_MAX_SEQ = (16, 24, 32, 40), 8, 128
# decode against forward: the reference's own tolerance for these models
# (tests/test_decode_consistency.py:21-24), of the logits' scale
VLM_RTOL = 1e-3
# xLSTM's bf16 prefill against its bf16 forward.  The two round in other
# places by design: the reference's mLSTM forward keeps the cell output in
# fp32 through the norm and the down-projection, its decode step (which
# the prefill follows) casts it to bf16 first.  Readings on the H100
# (``--xlstm-rtol-readings 8``): 5.95e-2 to 1.18e-1 of the scale over
# seeds 0-7; with the prefill's conv centred instead of causal, 1.35 to
# 1.54.  The limit sits between.  A cast fault in the cell (its forget
# gate or its state rounded to bf16) read 5.8e-2 to 1.16e-1, inside the
# sound band: this check cannot see one, since forward and prefill share
# the cell; the CPU tests against the reference's cell and prefill (fp32
# at 1e-4, the bf16 prefill at 2e-2) do.
XLSTM_BF16_FWD_RTOL = 2.0 ** -2


def traced_generate(engine, reqs, sync) -> dict:
    """``engine.generate(reqs)`` with every prefill and decode call of the
    engine timed (between synchronizes), its logits copied to the host
    (after the timed span, so that the device's peak memory is the
    engine's) and its ``fuse1d`` launches counted, in all and by shape;
    every launch counter is zeroed just before the generate and read just
    after."""
    import torch
    from repro_torch.kernels import fuse1d as kf1, ops as kops
    log = {k: [] for k in ("prefill", "decode", "prefill_s", "decode_s",
                           "prefill_launches", "decode_launches")}

    def traced(fn, kind):
        def call(*args):
            n0 = kf1.fuse1d.launches
            sync()
            t0 = time.perf_counter()
            logits, cache = fn(*args)
            sync()
            log[f"{kind}_s"].append(time.perf_counter() - t0)
            log[f"{kind}_launches"].append(kf1.fuse1d.launches - n0)
            full = getattr(logits, "full_tensor", None)   # a DTensor's
            log[kind].append((full() if full else logits).cpu())
            return logits, cache
        return call

    engine._prefill = traced(engine._prefill, "prefill")
    engine._decode = traced(engine._decode, "decode")
    on_card = engine.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(engine.device)
    log["resident_bytes"] = (torch.cuda.memory_allocated(engine.device)
                             if on_card else 0)
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    log["tokens"] = engine.generate(reqs)
    log["wall_s"] = time.perf_counter() - t0
    log["counts"] = kops.launch_counts()
    log["by_shape"] = dict(kf1.fuse1d.by_shape)
    log["peak_bytes"] = (torch.cuda.max_memory_allocated(engine.device)
                         if on_card else 0)
    return log


def check_launches(label, run, per_prefill) -> None:
    """A traced generate launched ``fuse1d`` exactly ``per_prefill`` times
    in each prefill, never in a decode step, and no other kernel."""
    counts = run["counts"]
    if (run["prefill_launches"] != [per_prefill] * len(run["prefill"])
            or any(run["decode_launches"])
            or counts != {**{k: 0 for k in counts},
                          "fuse1d": per_prefill * len(run["prefill"])}):
        raise SystemExit(
            f"{label}: fuse1d launches per prefill {run['prefill_launches']},"
            f" per decode step {sorted(set(run['decode_launches']))}, counts "
            f"{counts}; expected {per_prefill} per prefill, 0 per step")


def check_logits(label, pairs, rtol, shape):
    """Every (got, ref) pair of logits is finite, of ``shape``, and within
    ``rtol`` of max(1, max|ref|).  Returns the worst ratio and max|d|."""
    import torch
    worst, worst_abs = 0.0, 0.0
    for i, (a, b) in enumerate(pairs):
        if tuple(a.shape) != shape or not bool(
                torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise SystemExit(f"{label}: logits of call {i} are "
                             f"{tuple(a.shape)} or not finite")
        d = (a.float() - b.float()).abs().max().item()
        ratio = d / max(1.0, b.float().abs().max().item())
        worst, worst_abs = max(worst, ratio), max(worst_abs, d)
        if ratio > rtol:
            raise SystemExit(f"{label}: call {i} is {ratio:.3e} of the scale"
                             f" off its reference (tolerance {rtol})")
    return worst, worst_abs


def check_backends(label, runs, rtol, n_reqs, max_new, vocab):
    """The ``cuda`` generate against the ``torch`` one: every call's logits
    (prefill, then each decode step) within ``rtol``, and identical token
    lists of ``max_new`` each.  Returns (calls compared, worst ratio, worst
    max|d|)."""
    cu, to = runs["cuda"], runs["torch"]
    steps = list(zip(cu["prefill"] + cu["decode"],
                     to["prefill"] + to["decode"]))
    if len(cu["decode"]) != len(to["decode"]) or not steps:
        raise SystemExit(f"{label}: {len(cu['decode'])} decode steps on "
                         f"cuda, {len(to['decode'])} on torch")
    worst, worst_abs = check_logits(f"{label} (0 = prefill, cuda against "
                                    f"torch)", steps, rtol, (LM_SLOTS, vocab))
    if cu["tokens"] != to["tokens"] or [len(t) for t in cu["tokens"]] \
            != [max_new] * n_reqs:
        raise SystemExit(f"{label}: token lists differ between cuda and "
                         f"torch, or are short")
    return len(steps), worst, worst_abs


def generate_rows(label, runs, prefill_len, card) -> dict:
    """Print and return each run's prefill ms and tokens/s, decode ms per
    step, generate wall and peak device memory."""
    rows = {}
    for bk, r in runs.items():
        pre_s = r["prefill_s"][0]
        dec = sorted(r["decode_s"])
        row = dict(prefill_tokens_per_s=LM_SLOTS * prefill_len / pre_s,
                   prefill_ms=pre_s * 1e3,
                   decode_ms_median=dec[len(dec) // 2] * 1e3 if dec else None,
                   decode_ms_mean=sum(dec) * 1e3 / len(dec) if dec else None,
                   decode_steps=len(dec), generate_s=r["wall_s"],
                   peak_bytes=r["peak_bytes"],
                   resident_bytes=r["resident_bytes"])
        rows[bk] = row
        print(f"{label} {bk}: prefill {LM_SLOTS}x{prefill_len} tokens in "
              f"{row['prefill_ms']:.2f} ms "
              f"({row['prefill_tokens_per_s']:.0f} tokens/s), {len(dec)} "
              f"decode steps, median {row['decode_ms_median'] or 0:.3f} ms, "
              f"mean {row['decode_ms_mean'] or 0:.3f} ms per step; generate "
              f"{r['wall_s']:.2f} s; peak device memory {r['peak_bytes']} B "
              f"({r['resident_bytes']} B allocated before it); launches "
              f"{r['counts']}; {card}")
    return rows


def forward_convs(model, params, tokens):
    """``model.forward(params, tokens)``, keeping the first input of
    ``kops.fuse_conv1d_temporal`` at each (dtype, shape, form) it calls it
    with.  Returns the logits, the forward's ``fuse1d`` launches and the
    kept (x, w, causal), the forward's own activations and taps."""
    from repro_torch.kernels import fuse1d as kf1, ops as kops
    real, kept = kops.fuse_conv1d_temporal, {}

    def keep(x, w, *, causal=True):
        kept.setdefault((x.dtype, tuple(x.shape), causal), (x, w, causal))
        return real(x, w, causal=causal)

    n0 = kf1.fuse1d.launches
    kops.fuse_conv1d_temporal = keep
    try:
        logits = model.forward(params, tokens)
    finally:
        kops.fuse_conv1d_temporal = real
    return logits, kf1.fuse1d.launches - n0, list(kept.values())


def check_convs(label, kept, rtol) -> float:
    """Each kept temporal conv input through the kernel against its plain
    version, within ``rtol`` of max(1, max|plain|) and in x's dtype.
    Returns the worst ratio."""
    from repro_torch.kernels import fuse1d as kf1, ops as kops
    worst = 0.0
    for x, w, causal in kept:
        got = kops.fuse_conv1d_temporal(x, w, causal=causal)
        ref = kf1.fuse_temporal_plain(x, w, causal=causal)
        assert got.dtype == ref.dtype == x.dtype, (got.dtype, ref.dtype)
        ratio = ((got.float() - ref.float()).abs().max().item()
                 / max(1.0, ref.float().abs().max().item()))
        if not ratio <= rtol:
            raise SystemExit(f"{label}: the temporal conv at x "
                             f"{tuple(x.shape)} through the kernel is "
                             f"{ratio:.3e} of the scale off its plain version"
                             f" (tolerance {rtol})")
        worst = max(worst, ratio)
    return worst


def temporal_shape(key) -> dict:
    """A ``fuse1d.by_shape`` key of the temporal form (x (B, T, 1, C), K,
    stride 1, the leading pad) as a ``shape_case`` dict."""
    dtype, (b, t, _, c), k, _, lo, _ = key
    return dict(b=b, t=t, c=c, k=k, causal=lo == k - 1,
                dtype=str(dtype).removeprefix("torch."))


def shape_counts(by_shape) -> list:
    """``fuse1d.by_shape`` of the temporal form, readable."""
    return [f"x ({sh['b']}, {sh['t']}, {sh['c']}) K{sh['k']} "
            f"{'causal' if sh['causal'] else 'centred'} {sh['dtype']}: {n}"
            for key, n in by_shape.items() for sh in [temporal_shape(key)]]


def run_lm_launcher(args, timeout=600, module="repro_torch.launch.serve"):
    """``python -m MODULE ARGS`` as a user starts it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([env["PYTHONPATH"]]
                                       if env.get("PYTHONPATH") else []))
    return subprocess.run(
        [sys.executable, "-m", module, *args], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=timeout)


def tree_bytes(params) -> int:
    """The bytes of a tree's tensors."""
    from repro_torch import tree
    return sum(t.numel() * t.element_size() for t in tree.tree_leaves(params))


def lm_prompts(seed: int, vocab: int, prompt_lens) -> list:
    """Phase 9's prompts: token ids drawn from ``(seed, 9)``, one list per
    length."""
    import numpy as np
    rng = np.random.default_rng((seed, 9))
    return [rng.integers(0, vocab, n).tolist() for n in prompt_lens]


def serve_backends(label, cfg, params, reqs, n_conv, rtol, sync, card):
    """One traced ``ServeEngine.generate(reqs)`` on each of the backends
    ``cuda`` and ``torch`` with the same ``params``.  Fails unless the
    ``cuda`` run launched ``fuse1d`` exactly ``n_conv`` times per prefill
    and never in a decode step, the ``torch`` run launched nothing, every
    call's logits agree within ``rtol`` and the token lists are identical
    (``check_backends``).  Prints ``generate_rows``; returns the runs, the
    calls compared and the worst ratio and max|d|."""
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ServeEngine
    runs = {bk: traced_generate(
                ServeEngine(build_model(cfg, bk), params,
                            max_seq=LM_MAX_SEQ, batch_slots=LM_SLOTS),
                reqs, sync)
            for bk in ("cuda", "torch")}
    to = runs["torch"]
    check_launches(label, runs["cuda"], n_conv)
    if any(to["prefill_launches"]) or any(to["decode_launches"]) or any(
            to["counts"].values()):
        raise SystemExit(f"{label}: backend torch launched kernels: "
                         f"{to['counts']}")
    n_calls, worst, worst_abs = check_backends(
        label, runs, rtol, len(reqs), reqs[0].max_new_tokens, cfg.vocab_size)
    generate_rows(label, runs, min(len(r.prompt) for r in reqs), card)
    return runs, n_calls, worst, worst_abs


def lm_phase(seed: int, device="cuda", card="", smoke=False,
             prompt_lens=LM_PROMPT_LENS, max_new=LM_MAX_NEW,
             launch_extra=(), arch=LM_ARCH, label="lm",
             fwd_bf16_rtol=LM_BF16_RTOL) -> dict:
    """Phase 9 (and 10a): ``arch`` (``recurrentgemma_2b``: 26 layers,
    d_model 2560, vocab 256000; ``xlstm_125m``: 12 blocks, d_model 768,
    vocab 50304) at its production config (``smoke``: the smoke config,
    for a CPU rehearsal) from the port's seeded init on ``device``, in
    bfloat16 (the published dtype) and then in float32, each served through
    ``ServeEngine.generate``: 4 requests with prompts of ``prompt_lens``
    token ids drawn from ``seed``, ``max_new`` new tokens each, max_seq
    1024, 4 slots, on backend ``cuda`` and on backend ``torch`` with the
    same weights.  Fails unless (a) the ``fuse1d`` counter moves by exactly
    the number of layers with a temporal conv (``rec``, ``xm``, ``xs``) per
    prefill (and per ``forward``) and by 0 per decode step on ``cuda``, and
    never on ``torch``; (b) in float32 the prefill and every decode step's
    logits of ``cuda`` are within ``KERNEL_RTOL`` of ``torch``, the
    ``forward``'s last position within it of the prefill's, and the token
    lists identical; (c) the same in bfloat16 within ``LM_BF16_RTOL`` (the
    forward against the prefill within ``fwd_bf16_rtol``); (d)
    temporal conv through the kernel agrees with its plain
    version on the forward's own input (``KERNEL_RTOL``, one bf16 step)
    at each shape the forward runs it at; (e) every logit is finite.
    Then the launcher ``python -m repro_torch.launch.serve --arch ARCH`` in
    a subprocess must exit 0 with one line per prompt.  Returns, per
    dtype, the ``cuda`` generate's ``fuse1d`` launches by shape."""
    import dataclasses
    import torch
    from repro_torch import configs as C
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Request
    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    base = C.get_smoke_config(arch) if smoke else C.get_config(arch)
    n_conv = sum(k in CONV_KINDS for k in base.layer_pattern)
    prompts = lm_prompts(seed, base.vocab_size, prompt_lens)
    reqs = [Request(p, max_new) for p in prompts]
    print(f"{label}: {arch} ({base.num_layers} layers, {n_conv} with a "
          f"temporal conv, d_model {base.d_model}, vocab {base.vocab_size}, "
          f"{base.param_count() / 1e9:.3f} B parameters), prompts "
          f"{list(prompt_lens)}, {max_new} new tokens each, max_seq "
          f"{LM_MAX_SEQ}, {LM_SLOTS} slots; {card}")
    out = {}
    for dtype, rtol, conv_rtol, fwd_rtol in (
            ("bfloat16", LM_BF16_RTOL, BF16_STEP, fwd_bf16_rtol),
            ("float32", KERNEL_RTOL, KERNEL_RTOL, KERNEL_RTOL)):
        cfg = dataclasses.replace(base, dtype=dtype)
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = build_model(cfg).init(
            torch.Generator(device=dev).manual_seed(seed), device=dev)
        sync()
        init_s = time.perf_counter() - t0
        n_bytes = tree_bytes(params)
        with torch.inference_mode():
            tokens = torch.tensor([p[:min(prompt_lens)] for p in prompts],
                                  device=dev)
            fwd, fwd_launches, kept = forward_convs(
                build_model(cfg, "cuda"), params, tokens)
            fwd = fwd[:, -1].cpu()
            # (d) the kernel against plain on the forward's conv inputs
            conv_worst = check_convs(f"{label} {dtype}", kept, conv_rtol)
            conv_shapes = [tuple(x.shape) for x, _, _ in kept]
            del kept
        # (a) launches, (b), (c), (e): every step's logits, cuda against
        # torch
        runs, n_calls, worst, worst_abs = serve_backends(
            f"{label} {dtype}", cfg, params, reqs, n_conv, rtol, sync, card)
        cu = runs["cuda"]
        if fwd_launches != n_conv:
            raise SystemExit(f"{label} {dtype}: one forward launched fuse1d "
                             f"{fwd_launches} times, not {n_conv}")
        # the forward's last position against the prefill
        fwd_worst, _ = check_logits(
            f"{label} {dtype} forward against the cuda prefill",
            [(fwd, cu["prefill"][0])], fwd_rtol, (LM_SLOTS, cfg.vocab_size))
        print(f"{label} {dtype}: parameters {n_bytes} B, init {init_s:.2f} "
              f"s; cuda vs torch over {n_calls} calls: worst max|d| / scale "
              f"{worst:.3e} (max|d| {worst_abs:.3e}, tolerance {rtol}), "
              f"tokens identical; forward's last position vs prefill "
              f"{fwd_worst:.3e} (tolerance {fwd_rtol}); conv kernel vs plain "
              f"on the forward's inputs at {conv_shapes}: max|d| / scale "
              f"{conv_worst:.3e} (tolerance {conv_rtol}); fuse1d launches by "
              f"shape in the cuda generate {shape_counts(cu['by_shape'])}; "
              f"first request's tokens "
              f"{cu['tokens'][0][:8]}...; {card}")
        out[dtype] = cu["by_shape"]
        del params, runs, cu, fwd
    # the launcher, as a user starts it
    texts = [" ".join(map(str, p[:n])) for p, n in zip(prompts, (8, 5, 3))]
    t0 = time.perf_counter()
    proc = run_lm_launcher(["--arch", arch, "--max-new", str(LM_LAUNCH_NEW),
                         "--prompts", *texts, *launch_extra])
    lines = [m for m in map(LM_LINE.match, proc.stdout.splitlines()) if m]
    if proc.returncode != 0 or [m.group(1) for m in lines] != texts or any(
            len(m.group(2).split(",")) != LM_LAUNCH_NEW for m in lines):
        raise SystemExit(f"{label} launcher exited with {proc.returncode}, "
                         f"lines {proc.stdout[-2000:]!r}:\n"
                         f"{proc.stderr[-4000:]}")
    print(f"{label} launcher: exit 0 in {time.perf_counter() - t0:.1f} s, "
          f"{len(lines)} lines, e.g. {lines[0].group(0)[:120]}")
    print(f"{label}: phase wall {time.perf_counter() - t_phase:.1f} s")
    return out


def xlstm_fwd_readings(seeds, device="cuda", smoke=False) -> list:
    """The readings behind ``XLSTM_BF16_FWD_RTOL``: for each seed,
    ``xlstm_125m`` in bfloat16 from the port's seeded init, its
    ``forward``'s last position against its ``prefill`` on backend
    ``cuda`` (max|d| / max(1, max|prefill|)), on the 4 x 64 tokens phase
    10 draws from that seed; once as it is, and once with each of three
    faults planted in the prefill alone: two casts, the mLSTM cell's log
    forget gate (``gate``) or its state c and n after each step
    (``state``) rounded to bfloat16 where the cell keeps them in float32,
    and the temporal conv centred instead of causal (``conv``).  Prints
    and returns (seed, sound, {fault: reading}) triples."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs as C
    from repro_torch.models import recurrent as R
    from repro_torch.models.model import build_model
    dev = torch.device(device)
    base = (C.get_smoke_config(XLSTM_ARCH) if smoke
            else C.get_config(XLSTM_ARCH))
    cfg = dataclasses.replace(base, dtype="bfloat16")
    model = build_model(cfg, "cuda")
    real_inputs, real_step = R._mlstm_cell_inputs, R._mlstm_step
    real_conv = R.temporal_conv

    def bf16(t):
        return t.to(torch.bfloat16).float()

    def gate(*args):
        q, k, v, i_log, f_log = real_inputs(*args)
        return q, k, v, i_log, bf16(f_log)

    def state(*args):
        (c, n, m), y = real_step(*args)
        return (bf16(c), bf16(n), m), y

    def conv(x, w, backend, *, causal=True):
        return real_conv(x, w, backend, causal=False)

    faults = {"gate": ("_mlstm_cell_inputs", gate),
              "state": ("_mlstm_step", state),
              "conv": ("temporal_conv", conv)}

    def ratio(a, b):
        return ((a.float() - b.float()).abs().max().item()
                / max(1.0, b.float().abs().max().item()))

    out = []
    for seed in seeds:
        rng = np.random.default_rng((seed, 9))
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in LM_PROMPT_LENS]
        tokens = torch.tensor([p[:min(LM_PROMPT_LENS)] for p in prompts],
                              device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(seed),
                            device=dev)
        with torch.inference_mode():
            fwd = model.forward(params, tokens)[:, -1]
            sound = ratio(fwd, model.prefill(params, tokens)[0])
            bad = {}
            for name, (attr, fn) in faults.items():
                real = getattr(R, attr)
                setattr(R, attr, fn)
                try:
                    bad[name] = ratio(fwd, model.prefill(params, tokens)[0])
                finally:
                    setattr(R, attr, real)
        print(f"xlstm bf16 forward vs prefill, seed {seed}: sound "
              f"{sound:.6e}, with a planted fault "
              + ", ".join(f"{k} {v:.6e}" for k, v in bad.items()))
        out.append((seed, sound, bad))
        del params
    return out


def whisper_run(seed: int, dev, sync, card, smoke) -> dict:
    """Phase 10b: ``whisper_tiny`` (4 encoder and 4 decoder layers, d_model
    384, vocab 51865) from the port's seeded init, in bfloat16 and then in
    float32.  A log-mel of (4, 3000, 80) from ``seed`` goes through
    ``fuse_whisper_stem`` on backends ``cuda`` (exactly two centred
    ``fuse1d`` launches) and ``torch`` (none), giving (4, 1500, 384) each,
    within ``KERNEL_RTOL`` or ``LM_BF16_RTOL`` of each other; the conv stem
    ``whisper_stem`` runs once for its output contract.  Each backend's
    stem output is the ``memory_embeds`` of its ``ServeEngine.generate``
    (prompts of 8, 16, 24 and 32 token ids, 32 new tokens, max_seq 128):
    every call's logits within the same tolerance, tokens identical, no
    ``fuse1d`` launch in the encoder or decoder.  Returns, per dtype, the
    ``cuda`` stem call's ``fuse1d`` launches by shape."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs as C
    from repro_torch.kernels import fuse1d as kf1, ops as kops
    from repro_torch.models import stems
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Request, ServeEngine
    base = (C.get_smoke_config(WHISPER_ARCH) if smoke
            else C.get_config(WHISPER_ARCH))
    d, frames = base.d_model, 2 * base.encoder_seq
    rng = np.random.default_rng((seed, 10))
    mel_np = rng.standard_normal((LM_SLOTS, frames, N_MELS)).astype(
        np.float32)
    prompts = [rng.integers(0, base.vocab_size, n).tolist()
               for n in WHISPER_PROMPT_LENS]
    reqs = [Request(p, LM_MAX_NEW) for p in prompts]
    print(f"lm2 whisper: {WHISPER_ARCH} ({base.encoder_layers} encoder and "
          f"{base.num_layers} decoder layers, d_model {d}, vocab "
          f"{base.vocab_size}, {base.param_count() / 1e9:.3f} B parameters), "
          f"mel {mel_np.shape}, prompts {list(WHISPER_PROMPT_LENS)}, "
          f"{LM_MAX_NEW} new tokens each, max_seq {WHISPER_MAX_SEQ}; {card}")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    conv_p = stems.init_whisper_stem(gen, N_MELS, d, device=dev)
    with torch.inference_mode():
        y = stems.whisper_stem(conv_p, torch.from_numpy(mel_np).to(dev))
    if tuple(y.shape) != (LM_SLOTS, frames // 2, d) or not bool(
            torch.isfinite(y).all()):
        raise SystemExit(f"lm2 whisper: whisper_stem gave {tuple(y.shape)}"
                         f" or non-finite values")
    print(f"lm2 whisper: whisper_stem (4 x {frames} frames) -> "
          f"{tuple(y.shape)}, finite; stem MACs (conv, FuSe) "
          f"{stems.stem_macs(N_MELS, d, frames)}")
    del conv_p, y
    out = {}
    for dtype, rtol in (("bfloat16", LM_BF16_RTOL),
                        ("float32", KERNEL_RTOL)):
        cfg = dataclasses.replace(base, dtype=dtype)
        cast = getattr(torch, dtype)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = build_model(cfg).init(gen, device=dev)
        stem_p = stems.init_fuse_whisper_stem(gen, N_MELS, d, cast, dev)
        mel = torch.from_numpy(mel_np).to(dev, cast)
        mem, stem_ms, launches, by_shape = {}, {}, {}, {}
        with torch.inference_mode():
            for bk in ("cuda", "torch"):
                stems.fuse_whisper_stem(stem_p, mel, bk)       # warm
                sync()
                kops.reset_launch_counts()
                t0 = time.perf_counter()
                mem[bk] = stems.fuse_whisper_stem(stem_p, mel, bk)
                sync()
                stem_ms[bk] = (time.perf_counter() - t0) * 1e3
                launches[bk] = kf1.fuse1d.launches
                by_shape[bk] = dict(kf1.fuse1d.by_shape)
        if launches != {"cuda": 2, "torch": 0}:
            raise SystemExit(f"lm2 whisper {dtype}: the FuSe stem launched "
                             f"fuse1d {launches}, expected cuda 2, torch 0")
        stem_worst, _ = check_logits(
            f"lm2 whisper {dtype} stem (cuda against torch)",
            [(mem["cuda"], mem["torch"])], rtol, (LM_SLOTS, frames // 2, d))
        runs = {bk: traced_generate(
                    ServeEngine(build_model(cfg, bk), params,
                                max_seq=WHISPER_MAX_SEQ, batch_slots=LM_SLOTS,
                                extras={"memory_embeds": mem[bk]}),
                    reqs, sync)
                for bk in ("cuda", "torch")}
        for bk, r in runs.items():
            check_launches(f"lm2 whisper {dtype} {bk}", r, 0)
        n_calls, worst, worst_abs = check_backends(
            f"lm2 whisper {dtype}", runs, rtol, len(reqs), LM_MAX_NEW,
            cfg.vocab_size)
        generate_rows(f"lm2 whisper {dtype}", runs, min(WHISPER_PROMPT_LENS),
                      card)
        print(f"lm2 whisper {dtype}: FuSe stem {tuple(mem['cuda'].shape)}, "
              f"cuda {stem_ms['cuda']:.3f} ms ({launches['cuda']} fuse1d "
              f"launches: {shape_counts(by_shape['cuda'])}), torch {stem_ms['torch']:.3f} ms, max|d| / scale "
              f"{stem_worst:.3e}; cuda vs torch over {n_calls} calls: worst "
              f"{worst:.3e} (max|d| {worst_abs:.3e}, tolerance {rtol}), "
              f"tokens identical, first request's tokens "
              f"{runs['cuda']['tokens'][0][:8]}...; {card}")
        out[dtype] = by_shape["cuda"]
        del params, stem_p, mel, mem, runs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def vlm_run(seed: int, dev, sync, card, smoke) -> None:
    """Phase 10c: ``llama32_vision_90b`` at full width (d_model 8192, 64
    heads with 8 KV heads, d_ff 28672, vocab 128256) cut to 10 layers, the
    cross layers 4 and 9, in float32, from the port's seeded init with the
    cross layers' tanh gates drawn from the seed (the init's zeros make a
    cross layer the identity), on ``vision_embeds`` (4, 1600, 8192) from
    the seed.  One ``forward`` over 80 tokens; a prefill of the first 64
    and 16 teacher-forced decode steps, each step's logits within
    ``VLM_RTOL`` of the forward's at the same position (of max(1, their
    max)); then one ``ServeEngine.generate`` of 4 requests.  Backend
    ``cuda``: ``fuse1d`` never launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs as C, tree
    from repro_torch.kernels import ops as kops
    from repro_torch.models import stack as S
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Request, ServeEngine
    base = (C.get_smoke_config(VLM_ARCH) if smoke
            else C.get_config(VLM_ARCH))
    cfg = dataclasses.replace(base, num_layers=VLM_LAYERS, dtype="float32")
    cross = [i for i, k in enumerate(cfg.layer_pattern) if k == "cross"]
    rng = np.random.default_rng((seed, 11))
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_SLOTS, VLM_TOKENS))).to(dev)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in VLM_PROMPT_LENS]
    print(f"lm2 vlm: {VLM_ARCH} at width {cfg.d_model} cut to "
          f"{cfg.num_layers} layers (cross at {cross}), "
          f"{cfg.param_count() / 1e9:.3f} B parameters, {cfg.dtype}; "
          f"vision_embeds ({LM_SLOTS}, {cfg.num_vision_tokens}, "
          f"{cfg.d_model}); {card}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda")
    params = model.init(gen, device=dev)
    for sp, seg in zip(params["segments"], S.plan_segments(cfg)):
        for i, kind in enumerate(seg.kinds):
            if kind == "cross":
                for g in ("gate_attn", "gate_ffn"):
                    sp[f"k{i}"][g] = 0.5 * torch.randn(
                        seg.repeats, generator=gen, device=dev)
    extras = {"vision_embeds": torch.randn(
        LM_SLOTS, cfg.num_vision_tokens, cfg.d_model, generator=gen,
        device=dev)}
    sync()
    init_s = time.perf_counter() - t0
    n_bytes = sum(t.numel() * t.element_size()
                  for t in tree.tree_leaves(params))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kops.reset_launch_counts()
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        fwd = model.forward(params, tokens, extras)
        sync()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, tokens[:, :VLM_PREFILL],
                                      extras)
        sync()
        pre_ms = (time.perf_counter() - t0) * 1e3
        engine = ServeEngine(model, params, max_seq=VLM_MAX_SEQ,
                             batch_slots=LM_SLOTS, extras=extras)
        cache = engine._align_cache(cache, VLM_PREFILL)
        pairs, step_s = [(logits.cpu(), fwd[:, VLM_PREFILL - 1].cpu())], []
        for t in range(VLM_PREFILL, VLM_TOKENS):
            sync()
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, tokens[:, t], cache,
                                              extras)
            sync()
            step_s.append(time.perf_counter() - t0)
            pairs.append((logits.cpu(), fwd[:, t].cpu()))
        del fwd, cache, logits
    counts = kops.launch_counts()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    worst, worst_abs = check_logits("lm2 vlm (0 = prefill, then each decode "
                                    "step, against the forward)", pairs,
                                    VLM_RTOL, (LM_SLOTS, cfg.vocab_size))
    run = traced_generate(engine, [Request(p, VLM_MAX_NEW) for p in prompts],
                          sync)
    if any(counts.values()) or any(run["counts"].values()):
        raise SystemExit(f"lm2 vlm: kernels launched: forward/prefill/decode"
                         f" {counts}, generate {run['counts']}")
    if [len(t) for t in run["tokens"]] != [VLM_MAX_NEW] * len(prompts) \
            or not all(tuple(a.shape) == (LM_SLOTS, cfg.vocab_size)
                       and bool(torch.isfinite(a).all())
                       for a in run["prefill"] + run["decode"]):
        raise SystemExit(f"lm2 vlm: the generate's token lists have lengths "
                         f"{[len(t) for t in run['tokens']]}, or its logits "
                         f"are not finite")
    dec_ms = sorted(step_s)[len(step_s) // 2] * 1e3
    generate_rows("lm2 vlm float32", {"cuda": run}, min(VLM_PROMPT_LENS),
                  card)
    print(f"lm2 vlm: parameters {n_bytes} B, init {init_s:.2f} s; forward "
          f"{LM_SLOTS}x{VLM_TOKENS} tokens {fwd_ms:.2f} ms, prefill "
          f"{LM_SLOTS}x{VLM_PREFILL} {pre_ms:.2f} ms, {len(step_s)} "
          f"teacher-forced decode steps median {dec_ms:.3f} ms; peak device "
          f"memory {peak} B; prefill and every step against the forward: "
          f"worst max|d| / scale {worst:.3e} (max|d| {worst_abs:.3e}, "
          f"tolerance {VLM_RTOL}); launches {counts}; first request's "
          f"tokens {run['tokens'][0]}; {card}")
    del params, engine, extras, run


def lm2_phase(seed: int, device="cuda", card="", smoke=False,
              prompt_lens=LM_PROMPT_LENS, launch_extra=()) -> dict:
    """Phase 10: (a) ``xlstm_125m`` served as phase 9 serves RG-2B (12
    ``fuse1d`` launches per prefill and forward, 0 per decode step), (b)
    ``whisper_tiny`` on the FuSe stem's memory, (c) the 10-layer
    ``llama32_vision_90b``, each model freed before the next is drawn; then
    the launcher refuses ``--arch whisper_tiny`` in one line.  Returns the
    ``cuda`` paths' ``fuse1d`` launches by shape, per model and dtype."""
    import torch
    t_phase = time.perf_counter()
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {"xlstm": lm_phase(seed, device, card, smoke,
                             prompt_lens=prompt_lens,
                             launch_extra=launch_extra, arch=XLSTM_ARCH,
                             label="lm2 xlstm",
                             fwd_bf16_rtol=XLSTM_BF16_FWD_RTOL)}
    out["whisper"] = whisper_run(seed, dev, sync, card, smoke)
    vlm_run(seed, dev, sync, card, smoke)
    proc = run_lm_launcher(["--arch", WHISPER_ARCH, *launch_extra])
    err = proc.stderr.strip().splitlines()
    if proc.returncode == 0 or len(err) != 1 or "Traceback" in proc.stderr \
            or "no source of memory embeddings" not in err[0]:
        raise SystemExit(f"lm2: the launcher on {WHISPER_ARCH} exited "
                         f"{proc.returncode} with {proc.stderr[-2000:]!r}")
    print(f"lm2 launcher: --arch {WHISPER_ARCH} exits {proc.returncode}: "
          f"{err[0][:160]}")
    print(f"lm2: phase wall {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 11: the MoE and MLA models at published widths, depth cut so the
# bf16 weights (about 42 GB each) fit one 80 GB card; the fp32 checks cut
# them to 2 layers (DeepSeek: its dense layer 0 and one MoE layer)
MOE_ARCHS = (("qwen3_moe_235b", 8), ("deepseek_v2_236b", 6))
MOE_CHECK_LAYERS = 2
MOE_TOKENS, MOE_PREFILL, MOE_CHECK_SEQ = 80, 64, 128
MOE_LAYER_TOKENS = 256
# prefill + decode against the forward at the published capacity: the
# reference's own MoE tolerance (tests/test_decode_consistency.py:21-24),
# elementwise |d| <= atol + rtol * |forward|; a prefill group and a
# 4-token decode group drop different (token, slot) assignments
MOE_DECODE_ATOL, MOE_DECODE_RTOL = 0.3, 0.1


@contextlib.contextmanager
def counted_routes():
    """While active, every ``ffn.moe_route`` call appends (kept,
    assignments) of its (token, slot) assignments to the yielded list, the
    kept count as a device tensor (no synchronize inside a timed call)."""
    from repro_torch.models import ffn
    real, log = ffn.moe_route, []

    def route(*args, **kw):
        r = real(*args, **kw)
        log.append((r.keep.sum(), r.keep.numel()))
        return r

    ffn.moe_route = route
    try:
        yield log
    finally:
        ffn.moe_route = real


def dropped(log) -> tuple:
    """(dropped, assignments) over the ``counted_routes`` entries."""
    total = sum(n for _, n in log)
    return total - sum(int(k) for k, _ in log), total


def moe_consistency(model, params, tokens, sync):
    """``model.forward`` over ``tokens`` (B, MOE_TOKENS) against a prefill
    of the first MOE_PREFILL and teacher-forced decode steps over the
    rest, the caches aligned by the engine (max_seq MOE_CHECK_SEQ).
    Returns the (step, forward) logits pairs (0 = prefill), the forward's
    and the prefill + decode's drops, and the decode ms per step."""
    import torch
    from repro_torch.serving.engine import ServeEngine
    with torch.inference_mode():
        with counted_routes() as fwd_log:
            fwd = model.forward(params, tokens)
        with counted_routes() as dec_log:
            logits, cache = model.prefill(params, tokens[:, :MOE_PREFILL])
            cache = ServeEngine(model, params, max_seq=MOE_CHECK_SEQ,
                                batch_slots=tokens.shape[0])._align_cache(
                cache, MOE_PREFILL)
            pairs = [(logits.cpu(), fwd[:, MOE_PREFILL - 1].cpu())]
            step_s = []
            for t in range(MOE_PREFILL, tokens.shape[1]):
                sync()
                t0 = time.perf_counter()
                logits, cache = model.decode_step(params, tokens[:, t],
                                                  cache)
                sync()
                step_s.append(time.perf_counter() - t0)
                pairs.append((logits.cpu(), fwd[:, t].cpu()))
    return pairs, dropped(fwd_log), dropped(dec_log), step_s


def moe_plain_layer(p, x, cfg, r):
    """An independent plain top-k mixture of x (1, T, D) under the routing
    ``r``: a Python loop over the kept (token, slot) pairs, each adding
    gate x expert FFN of its token, plus the shared experts."""
    import torch
    from repro_torch.models.common import ACT
    from repro_torch.models.ffn import mlp_forward
    xt = x.reshape(-1, x.shape[-1])
    gs = r.idx.shape[1]
    out = torch.zeros_like(xt)
    idx, gates = r.idx.tolist(), r.gates.tolist()
    for g, n, k in r.keep.nonzero().tolist():
        e, t = idx[g][n][k], g * gs + n
        h = ACT[cfg.act](xt[t] @ p["wg"][e]) * (xt[t] @ p["wi"][e])
        out[t] += gates[g][n][k] * (h @ p["wo"][e])
    if cfg.moe.num_shared:
        out += mlp_forward(p["shared"], xt, cfg.act)
    return out.reshape(x.shape)


def moe_run(arch: str, layers: int, seed: int, dev, sync, card, smoke,
            prompt_lens, max_new) -> None:
    """Phase 11, one model: ``arch`` at published width cut to ``layers``
    in bf16, one ``ServeEngine.generate`` (4 requests of ``prompt_lens``
    token ids, ``max_new`` new each, max_seq 1024): finite logits, no
    kernel launched, prefill and decode times, peak memory, the prefill's
    drop share.  Then in fp32 cut to 2 layers: (a) the forward's last
    position on the prefill's own tokens against the prefill (the same
    groups, so the same drops), within KERNEL_RTOL; (b) at capacity_factor
    E / K (capacity = group size: nothing drops) a prefill of 64 and 16
    decode steps against the forward over 80 tokens within KERNEL_RTOL;
    (c) the same at the published capacity within the reference's MoE
    tolerance; (d) one MoE layer on 256 tokens against ``moe_plain_layer``
    within KERNEL_RTOL of its output's own scale (max|ref|)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs as C, tree
    from repro_torch.kernels import ops as kops
    from repro_torch.models import ffn
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Request, ServeEngine
    base = C.get_smoke_config(arch) if smoke else C.get_config(arch)
    e = base.moe
    label = f"moe {arch}"
    rng = np.random.default_rng((seed, 12))
    prompts = [rng.integers(0, base.vocab_size, n).tolist()
               for n in prompt_lens]
    tokens = torch.from_numpy(rng.integers(
        0, base.vocab_size, (LM_SLOTS, MOE_TOKENS))).to(dev)
    pre_tokens = torch.tensor([p[:min(prompt_lens)] for p in prompts],
                              device=dev)

    def n_bytes(params):
        return sum(t.numel() * t.element_size()
                   for t in tree.tree_leaves(params))

    # -- bf16 generate at `layers` ------------------------------------------
    cfg = dataclasses.replace(base, num_layers=layers, dtype="bfloat16")
    n_moe = layers - e.first_dense_layers
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    sync()
    init_s = time.perf_counter() - t0
    nb = n_bytes(params)
    print(f"{label}: width {cfg.d_model}, {cfg.num_heads} heads, "
          f"{cfg.attn_kind}, {e.num_experts} experts top-{e.top_k} "
          f"(d_expert {e.d_expert}, shared {e.num_shared}, capacity factor "
          f"{e.capacity_factor}, group {e.group_size}), vocab "
          f"{cfg.vocab_size}, cut to {layers} of {base.num_layers} layers "
          f"({n_moe} MoE); parameters {nb} B in bf16, init "
          f"{init_s:.2f} s; weights read once {nb / PEAK_BYTES_PER_S * 1e3:.3f}"
          f" ms at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s; {card}")
    engine = ServeEngine(model, params, max_seq=LM_MAX_SEQ,
                         batch_slots=LM_SLOTS)
    with counted_routes() as log:
        run = traced_generate(engine, [Request(p, max_new) for p in prompts],
                              sync)
    if any(run["counts"].values()):
        raise SystemExit(f"{label}: kernels launched: {run['counts']}")
    if [len(t) for t in run["tokens"]] != [max_new] * len(prompts) \
            or not all(tuple(a.shape) == (LM_SLOTS, cfg.vocab_size)
                       and bool(torch.isfinite(a).all())
                       for a in run["prefill"] + run["decode"]):
        raise SystemExit(f"{label}: the generate's token lists have lengths "
                         f"{[len(t) for t in run['tokens']]}, or its logits "
                         f"are not finite")
    if len(log) != n_moe * (1 + len(run["decode"])):
        raise SystemExit(f"{label}: {len(log)} routings, not {n_moe} per "
                         f"call over {1 + len(run['decode'])} calls")
    pre_drop, pre_all = dropped(log[:n_moe])
    dec_drop, dec_all = dropped(log[n_moe:])
    generate_rows(f"{label} bfloat16", {"cuda": run}, min(prompt_lens), card)
    print(f"{label} bfloat16: prefill dropped {pre_drop} of {pre_all} "
          f"(token, slot) assignments ({pre_drop / pre_all:.4%}) over "
          f"{n_moe} MoE layers; decode steps dropped {dec_drop} of {dec_all}"
          f"; every logit finite; launches {run['counts']}; first "
          f"request's tokens {run['tokens'][0][:8]}...; {card}")
    del engine, params, model, run, log
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- fp32 checks at MOE_CHECK_LAYERS --------------------------------------
    cfg = dataclasses.replace(base, num_layers=MOE_CHECK_LAYERS,
                              dtype="float32")
    no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
        e, capacity_factor=e.num_experts / e.top_k))
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    kops.reset_launch_counts()
    # (a) the prefill's own tokens: the same groups, so the same drops
    with torch.inference_mode(), counted_routes() as log:
        fwd = model.forward(params, pre_tokens)[:, -1].cpu()
        n_fwd = len(log)
        logits, _ = model.prefill(params, pre_tokens)
        logits = logits.cpu()
    same, _ = check_logits(f"{label} (a) forward's last position against "
                           f"the prefill", [(fwd, logits)], KERNEL_RTOL,
                           (LM_SLOTS, cfg.vocab_size))
    drops_a = (dropped(log[:n_fwd]), dropped(log[n_fwd:]))
    if drops_a[0] != drops_a[1]:
        raise SystemExit(f"{label} (a): forward and prefill dropped "
                         f"{drops_a}")
    # (b) nothing drops: the absorbed decode and the aligned caches
    pairs, fwd_d, dec_d, step_s = moe_consistency(
        build_model(no_drop, "cuda"), params, tokens, sync)
    if fwd_d[0] or dec_d[0]:
        raise SystemExit(f"{label} (b): capacity factor "
                         f"{no_drop.moe.capacity_factor} dropped {fwd_d} "
                         f"(forward), {dec_d} (prefill + decode)")
    nd_worst, nd_abs = check_logits(
        f"{label} (b) no drops (0 = prefill, then each decode step, against "
        f"the forward)", pairs, KERNEL_RTOL, (LM_SLOTS, cfg.vocab_size))
    # (c) the published capacity
    pairs, fwd_c, dec_c, _ = moe_consistency(model, params, tokens, sync)
    worst, excess = 0.0, -math.inf
    for a, b in pairs:
        d = (a - b).abs()
        worst = max(worst, d.max().item()
                    / max(1.0, b.abs().max().item()))
        excess = max(excess, (d - MOE_DECODE_ATOL - MOE_DECODE_RTOL
                              * b.abs()).max().item())
    if not all(bool(torch.isfinite(a).all()) for a, _ in pairs) \
            or excess > 0:
        raise SystemExit(f"{label} (c): published capacity, prefill + "
                         f"decode against the forward: max|d| / scale "
                         f"{worst:.3e}, |d| - (atol + rtol |ref|) up to "
                         f"{excess:.3e} (atol {MOE_DECODE_ATOL}, rtol "
                         f"{MOE_DECODE_RTOL}); drops forward {fwd_c}, "
                         f"prefill + decode {dec_c}")
    # (d) one MoE layer against the plain top-k mixture
    p = tree.tree_map(lambda a: a[0], params["segments"][-1]["k0"]["ffn"])
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(1, MOE_LAYER_TOKENS, cfg.d_model, generator=gen,
                    device=dev)
    with torch.inference_mode():
        y = ffn.moe_forward(p, x, cfg)
        r = ffn.moe_route(p, x, cfg)
        ref = moe_plain_layer(p, x, cfg, r)
    layer_scale = ref.abs().max().item()
    layer_err = (y - ref).abs().max().item()
    kept = int(r.keep.sum())
    if not layer_err <= KERNEL_RTOL * layer_scale:
        raise SystemExit(f"{label} (d): moe_forward is {layer_err:.3e} off "
                         f"the plain mixture (scale {layer_scale:.3e}, "
                         f"tolerance {KERNEL_RTOL} of it)")
    if any(kops.launch_counts().values()):
        raise SystemExit(f"{label}: kernels launched in the fp32 checks: "
                         f"{kops.launch_counts()}")
    dec_ms = sorted(step_s)[len(step_s) // 2] * 1e3
    print(f"{label} float32 at {MOE_CHECK_LAYERS} layers ({n_bytes(params)} "
          f"B): (a) forward's last position vs prefill on its tokens "
          f"{same:.3e} of the scale (tolerance {KERNEL_RTOL}), drops "
          f"{drops_a[0]} on both; (b) capacity factor "
          f"{no_drop.moe.capacity_factor:.4g}, no drops: prefill "
          f"{LM_SLOTS}x{MOE_PREFILL} + {len(step_s)} decode steps (median "
          f"{dec_ms:.3f} ms) vs forward over {MOE_TOKENS}: {nd_worst:.3e} of "
          f"the scale (max|d| {nd_abs:.3e}, tolerance {KERNEL_RTOL}); (c) "
          f"published capacity: {worst:.3e} of the scale, |d| - (atol + "
          f"rtol |ref|) at most {excess:.3e} (atol {MOE_DECODE_ATOL}, rtol "
          f"{MOE_DECODE_RTOL}), dropped: forward {fwd_c[0]} of {fwd_c[1]}, "
          f"prefill + decode {dec_c[0]} of {dec_c[1]}; (d) one MoE layer on "
          f"{MOE_LAYER_TOKENS} tokens vs the plain loop over {kept} kept "
          f"(token, slot) pairs: max|d| {layer_err:.3e}, scale "
          f"{layer_scale:.3e} (tolerance {KERNEL_RTOL} of it); no kernel "
          f"launched; {card}")
    del params, model, fwd, pairs, p, x, y, ref, r


def moe_phase(seed: int, device="cuda", card="", smoke=False,
              prompt_lens=LM_PROMPT_LENS, max_new=LM_MAX_NEW) -> None:
    """Phase 11: ``moe_run`` for each of MOE_ARCHS, each model freed
    before the next is drawn."""
    import torch
    t_phase = time.perf_counter()
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for arch, layers in MOE_ARCHS:
        moe_run(arch, layers, seed, dev, sync, card, smoke, prompt_lens,
                max_new)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(f"moe: phase wall {time.perf_counter() - t_phase:.1f} s")


# phase 12: LM training.  RecurrentGemma-2B at its production config,
# trained in its bf16 (fp32 AdamW moments) at global batch 4 x 512 tokens
# and then served on the hand kernel; linear_scan's VJP at a long sequence;
# SmolLM-135M (the reference launcher's own example) through the training
# launcher with a process restart, and with int8 gradient compression
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 4, 512
SCAN_SHAPE = (1, 4096, 2560)
SCAN_RTOL = 1e-5                # of each gradient's max|autograd|
SMOL_ARCH, SMOL_STEPS, SMOL_RESTART_AT = "smollm_135m", 6, 3
SMOL_BATCH, SMOL_SEQ = 8, 128   # the launcher's defaults
SMOL_INT8_STEPS = 16
# the reference's exact-resume tolerance, |d| <= atol + rtol |ref|
# (tests/test_checkpoint_trainer.py:88-91)
RESUME_TOL = 1e-6
TRAIN_LINE = re.compile(r"^step +(\d+) loss ([\d.naif]+)")


def checkpoint_leaves(directory: str, step: int) -> dict:
    """A port checkpoint's npz as {path: (stored array, float64 values)};
    bfloat16 leaves (stored as their int16 bits) read through torch."""
    import numpy as np
    import torch
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        bf16 = set(json.load(f)["bfloat16"])
    out = {}
    with np.load(os.path.join(d, "state.npz")) as z:
        for k in z.files:
            raw = z[k]
            vals = (torch.from_numpy(raw).view(torch.bfloat16).double()
                    .numpy() if k in bf16 else raw.astype(np.float64))
            out[k] = (raw, vals)
    return out


def scan_vjp(shape, seed: int, dev, sync) -> None:
    """(b): ``linear_scan`` (the reference's VJP as a Function) against
    autograd through the plain doubling scan, on a in [0, 1), b and the
    cotangent standard normal: h and both gradients within ``SCAN_RTOL`` of
    each one's max|autograd|; each run's peak memory above what was
    allocated before it, and its forward + backward ms (the second call)."""
    import torch
    from repro_torch.models import recurrent as rec
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand(shape, generator=gen, device=dev)
    b = torch.randn(shape, generator=gen, device=dev)
    dh = torch.randn(shape, generator=gen, device=dev)

    def run(fn):
        for _ in range(2):
            ai = a.clone().requires_grad_(True)
            bi = b.clone().requires_grad_(True)
            sync()
            if on_card:
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            h = fn(ai, bi)
            da, db = torch.autograd.grad(h, (ai, bi), dh)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            peak = (torch.cuda.max_memory_allocated(dev) - base
                    if on_card else 0)
            out = (h.detach(), da, db)
            del ai, bi, h, da, db
        return out, ms, peak

    got, ms, peak = run(rec.linear_scan)
    ref, plain_ms, plain_peak = run(rec._doubling_scan)
    errs = []
    for name, g, r in zip(("h", "da", "db"), got, ref):
        err = (g - r).abs().max().item() / r.abs().max().item()
        errs.append(f"{name} {err:.3e}")
        if not err <= SCAN_RTOL:
            raise SystemExit(f"lm_train scan: {name} of the Function is "
                             f"{err:.3e} of its scale off autograd through "
                             f"the doubling scan (tolerance {SCAN_RTOL})")
    print(f"lm_train scan: linear_scan at {tuple(shape)} fp32, the Function "
          f"against autograd through the doubling scan: max|d| / scale "
          f"{', '.join(errs)} (tolerance {SCAN_RTOL}); peak memory above "
          f"the inputs {peak} B against {plain_peak} B; forward + backward "
          f"{ms:.2f} ms against {plain_ms:.2f} ms")


def smol_restart(cfg_smoke: bool, build: str, launch_extra, card) -> None:
    """(d), the launcher: ``SMOL_ARCH`` for ``SMOL_STEPS`` steps into one
    directory, and for ``SMOL_RESTART_AT`` then ``SMOL_STEPS`` steps into
    another (the second command a process restart that resumes from the
    latest checkpoint, ``--ckpt-every SMOL_RESTART_AT``).  Fails unless
    every run exits 0, the resumed run logs no step before the restart,
    and the two final checkpoints agree leaf by leaf within
    ``RESUME_TOL``; prints whether they are bitwise equal."""
    import numpy as np
    dirs = {k: os.path.join(build, f"lm_train_{k}")
            for k in ("straight", "restart")}
    common = ["--arch", SMOL_ARCH, "--global-batch", str(SMOL_BATCH),
              "--seq-len", str(SMOL_SEQ), "--ckpt-every",
              str(SMOL_RESTART_AT), *launch_extra]
    for name, steps in (("straight", SMOL_STEPS),
                        ("restart", SMOL_RESTART_AT),
                        ("restart", SMOL_STEPS)):
        t0 = time.perf_counter()
        proc = run_lm_launcher(
            [*common, "--steps", str(steps), "--ckpt-dir", dirs[name]],
            module="repro_torch.launch.train")
        logged = [int(m.group(1)) for m in
                  map(TRAIN_LINE.match, proc.stdout.splitlines()) if m]
        if proc.returncode != 0 or "final loss:" not in proc.stdout:
            raise SystemExit(f"lm_train launcher ({name}, {steps} steps) "
                             f"exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        if name == "restart" and steps == SMOL_STEPS and any(
                s < SMOL_RESTART_AT for s in logged):
            raise SystemExit(f"lm_train launcher: the rerun logged steps "
                             f"{logged}; it did not resume at "
                             f"{SMOL_RESTART_AT}")
        last = proc.stdout.strip().splitlines()[-1]
        print(f"lm_train launcher: {SMOL_ARCH}{' (smoke)' * cfg_smoke} "
              f"--steps {steps} into {name}: exit 0 in "
              f"{time.perf_counter() - t0:.1f} s, logged steps {logged}, "
              f"{last!r}")
    a = checkpoint_leaves(dirs["straight"], SMOL_STEPS)
    b = checkpoint_leaves(dirs["restart"], SMOL_STEPS)
    if sorted(a) != sorted(b):
        raise SystemExit("lm_train launcher: the two final checkpoints "
                         "hold different leaves")
    worst, bitwise = 0.0, True
    for k, (raw, ref) in a.items():
        raw_b, got = b[k]
        d = np.abs(got - ref)
        worst = max(worst, float(d.max()))
        bitwise &= bool(np.array_equal(raw, raw_b))
        if np.any(d > RESUME_TOL + RESUME_TOL * np.abs(ref)):
            raise SystemExit(f"lm_train launcher: leaf {k} of the restarted "
                             f"run's final checkpoint is {float(d.max()):.3e}"
                             f" off the straight run's (tolerance "
                             f"{RESUME_TOL} + {RESUME_TOL} |ref|)")
    print(f"lm_train launcher: step-{SMOL_STEPS} checkpoints of the straight "
          f"and the restarted run, {len(a)} leaves (parameters, AdamW m and "
          f"v): max|d| {worst:.3e} (tolerance {RESUME_TOL} + {RESUME_TOL} "
          f"|ref|), bitwise {'equal' if bitwise else 'NOT equal'}; {card}")
    for d in dirs.values():
        shutil.rmtree(d)


def lm_train_phase(seed: int, device="cuda", card="", smoke=False,
                   prompt_lens=SHORT_PROMPT_LENS, max_new=SHORT_MAX_NEW,
                   launch_extra=(), keep=None) -> dict:
    """Phase 12: (a) ``recurrentgemma_2b`` at its production config (26
    layers, d_model 2560, vocab 256000) in its bf16 with fp32 AdamW moments,
    trained by ``train.trainer.Trainer`` (backend ``torch``: the kernels
    have no backward pass) for ``TRAIN_STEPS`` steps at global batch
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens, one microbatch, from the port's
    seeded init; fails unless every loss is finite, every trained leaf is
    finite and no kernel launched; prints the median of steps 2-4, peak
    memory and the final checkpoint's bytes and save seconds, then deletes
    it, unless ``keep`` (a dict) asks for it: then ``keep`` gets its
    directory and step, the losses, the step ms and the peak, for phase
    15, which deletes it.  (b) ``scan_vjp`` at ``SCAN_SHAPE``.  (c) the
    trained parameters served as phase 9 serves its init
    (``serve_backends``: 18 ``fuse1d`` launches per prefill, every call's
    logits within ``LM_BF16_RTOL``, identical tokens), with the short
    traffic (``SHORT_PROMPT_LENS``).  (d) ``smol_restart``, then
    ``SMOL_ARCH`` trained in process for ``SMOL_INT8_STEPS`` steps with
    int8 gradient compression and ``adamw(3e-3)``, as the reference's test
    does: the loss must fall.  ``smoke``: the smoke configs at sequence 32
    and a (1, 256, 64) scan, for a CPU rehearsal.  Returns the served
    ``fuse1d`` launches by shape, under the dtype."""
    import torch
    from repro_torch import configs as C, tree
    from repro_torch.kernels import ops as kops
    from repro_torch.optim import adamw
    from repro_torch.serving.engine import Request
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    build = os.path.join(ROOT, "build")
    seq = 32 if smoke else TRAIN_SEQ
    get = C.get_smoke_config if smoke else C.get_config

    # (a) RecurrentGemma-2B trained at full width
    cfg = get(LM_ARCH)
    ckpt_dir = os.path.join(build, "lm_train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    trainer = Trainer(cfg, TrainerConfig(
        steps=TRAIN_STEPS, global_batch=TRAIN_BATCH, seq_len=seq,
        microbatches=1, log_every=1, ckpt_every=0, ckpt_dir=ckpt_dir,
        seed=seed), device=dev)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    out = trainer.train()
    train_s = time.perf_counter() - t0
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise SystemExit(f"lm_train {LM_ARCH}: losses {losses}")
    if any(counts.values()):
        raise SystemExit(f"lm_train {LM_ARCH}: training launched kernels "
                         f"{counts}")
    params = out["params"]
    if not all(bool(torch.isfinite(t).all())
               for t in tree.tree_leaves(params)):
        raise SystemExit(f"lm_train {LM_ARCH}: a trained leaf is not finite")
    later = sorted(h["sec_per_step"] for h in hist[1:])
    step_ms = later[len(later) // 2] * 1e3
    save = trainer.ckpt.last_save
    print(f"lm_train {LM_ARCH}{' (smoke)' * smoke}: {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype} "
          f"parameters ({tree_bytes(params)} B) with fp32 AdamW moments "
          f"({tree_bytes(out['opt_state'])} B); {TRAIN_STEPS} steps of "
          f"{TRAIN_BATCH}x{seq} tokens on backend torch: losses "
          f"{[round(x, 4) for x in losses]}; step ms "
          f"{[round(h['sec_per_step'] * 1e3, 1) for h in hist]}, median of "
          f"steps 2-{TRAIN_STEPS} {step_ms:.1f} ms "
          f"({TRAIN_BATCH * seq / step_ms * 1e3:.0f} tokens/s); train wall "
          f"{train_s:.1f} s; peak device memory {peak} B; launches {counts};"
          f" final checkpoint step {save['step']}: {save['bytes']} B, host "
          f"copy {save['copy_s']:.2f} s + write {save['write_s']:.2f} s; "
          f"{card}")
    if keep is None:
        shutil.rmtree(ckpt_dir)
    else:
        keep.update(ckpt_dir=ckpt_dir, step=save["step"], losses=losses,
                    step_ms=step_ms, peak=peak)
    del out, trainer, hist
    if on_card:
        torch.cuda.empty_cache()

    # (b) linear_scan's VJP against autograd through the doubling scan
    scan_vjp((1, 256, 64) if smoke else SCAN_SHAPE, seed, dev, sync)

    # (c) the trained weights served on the hand kernel
    n_conv = sum(k in CONV_KINDS for k in cfg.layer_pattern)
    reqs = [Request(p, max_new)
            for p in lm_prompts(seed, cfg.vocab_size, prompt_lens)]
    rtol = LM_BF16_RTOL if cfg.dtype == "bfloat16" else KERNEL_RTOL
    runs, n_calls, worst, worst_abs = serve_backends(
        f"lm_train {LM_ARCH} trained, served", cfg, params, reqs, n_conv,
        rtol, sync, card)
    served = runs["cuda"]["by_shape"]
    print(f"lm_train {LM_ARCH} trained, served: cuda vs torch over {n_calls}"
          f" calls: worst max|d| / scale {worst:.3e} (max|d| "
          f"{worst_abs:.3e}, tolerance {rtol}), tokens identical; fuse1d "
          f"{n_conv} launches per prefill, by shape "
          f"{shape_counts(served)}; first request's tokens "
          f"{runs['cuda']['tokens'][0][:8]}...; {card}")
    del runs, params
    if on_card:
        torch.cuda.empty_cache()

    # (d) SmolLM-135M: a process restart, then int8 compression
    smol_restart(smoke, build, launch_extra, card)
    int8_dir = os.path.join(build, "lm_train_int8")
    shutil.rmtree(int8_dir, ignore_errors=True)
    t0 = time.perf_counter()
    out = Trainer(get(SMOL_ARCH), TrainerConfig(
        steps=SMOL_INT8_STEPS, global_batch=SMOL_BATCH, seq_len=32,
        microbatches=2, log_every=SMOL_INT8_STEPS - 1, ckpt_every=0,
        ckpt_dir=int8_dir, grad_compression="int8", seed=1), device=dev,
        optimizer=adamw(3e-3, weight_decay=0.0)).train()
    first, last = (h["loss"] for h in out["history"])
    if not last < first:
        raise SystemExit(f"lm_train {SMOL_ARCH} int8: the loss went from "
                         f"{first} to {last}")
    print(f"lm_train {SMOL_ARCH} int8: {SMOL_INT8_STEPS} steps of "
          f"{SMOL_BATCH}x32 tokens in 2 microbatches, int8 gradient "
          f"compression, adamw(3e-3): loss {first:.4f} -> {last:.4f} in "
          f"{time.perf_counter() - t0:.1f} s; {card}")
    shutil.rmtree(int8_dir)
    print(f"lm_train: phase wall {time.perf_counter() - t_phase:.1f} s")
    return {cfg.dtype: served}


# phase 13: vision serving over a data mesh of logical devices of the card,
# in process and across two launcher processes
MESH_DEVICES = 4
MESH_WIDTHS = (1, 2, 4)
MESH_BUCKETS = (1, 2, 4, 8)
MESH_REQUESTS = 16


def seeded_randn(seed: int, dev):
    """``randn(*shape, scale=1.0)`` whose i-th call draws from a generator
    of its own, seeded (seed, i): two sequences of calls whose shapes differ
    only in the first axis draw the same leading rows."""
    import numpy as np
    import torch
    calls = itertools.count()

    def randn(*shape, scale=1.0):
        gen = np.random.default_rng((seed, next(calls)))
        return torch.from_numpy((gen.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev)

    return randn


def stripe_breaks(net, variant, bucket: int, rows: int, dev,
                  seed: int) -> list:
    """The kernel shapes of ``variant``'s forward at batch ``bucket`` whose
    first ``rows`` images' outputs are not bitwise what the same kernel
    gives on those images alone (a tiling picked from the batch, or a K
    split from the row count, changes the order of a sum)."""
    import torch
    from repro_torch.vision import zoo
    shapes = {json.dumps(sh, sort_keys=True): (name, sh)
              for name, sh in zoo.kernel_launches(net, variant, bucket)}
    out = []
    for name, sh in shapes.values():
        part = (dict(sh, m=sh["m"] * rows // bucket) if name == "matmul"
                else dict(sh, b=rows))
        whole = shape_case(name, sh, seeded_randn(seed, dev))["run"]()
        alone = shape_case(name, part, seeded_randn(seed, dev))["run"]()
        if not torch.equal(whole[:alone.shape[0]], alone):
            out.append(f"{name} {json.dumps(part, sort_keys=True)}")
    return out


def compute_mode() -> str:
    """The card's compute mode as nvidia-smi reports it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def mesh_phase(seed: int, device="cuda", card="", net=None,
               launch_models=LAUNCH_MODELS, launch_extra=()) -> dict:
    """Phase 13: (a) a registry over a mesh of ``MESH_DEVICES`` logical
    devices of the card (``REPRO_TORCH_VIRTUAL_DEVICES``: one stream each)
    serves ``net`` (default MobileNetV3-Large at 224) in ``fuse_half`` and
    ``depthwise``: every bucket of ``MESH_BUCKETS`` on groups of width 1, 2
    and 4, each kernel launched exactly stripes x its launches for one
    stripe, the logits within ``SERVE_RTOL`` of the unsharded ``torch`` and
    ``cuda`` registries, bitwise equality with ``cuda`` reported (and, where
    it fails, the kernel shapes that break it); the striped batch's wall
    ms; then the pipelined engine with cross-model rounds and the adaptive
    planner over both models, its reachable groups warmed, 16 requests
    fanned back in submission order within ``SERVE_RTOL`` of ``torch``,
    every kernel launched.  (b) the launcher as two processes (coordinator
    and worker, 2 logical devices each, one fresh build directory and
    manifest) and as one process over 4, at once, on ``launch_models``:
    the checks of ``scripts/multiprocess_check_torch.py`` (same
    fingerprint, every request ``ok``, the pair's ``logits_sha256`` equal
    to the single process's, the worker executed parts and ran no nvcc,
    the coordinator built cold, the snapshot's ``multiprocess`` block).
    Returns the kernels' launch counts of the engine round."""
    import numpy as np
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import ENV_VIRTUAL_DEVICES, make_data_mesh
    from repro_torch.serving.vision import (LatencyCalibrator, ModelRegistry,
                                            SystolicCostModel,
                                            VisionServeEngine, create_engine)
    from repro_torch.vision import zoo
    t_phase = time.perf_counter()
    net = net or zoo.mobilenet_v3_large()
    res = net.resolution
    mesh = make_data_mesh(MESH_DEVICES, device,
                          env={ENV_VIRTUAL_DEVICES: str(MESH_DEVICES)})
    print(f"mesh: {len(mesh.devices)} logical devices on "
          f"{sorted({str(d.device) for d in mesh.devices})}, one stream "
          f"each")
    regs = {"mesh": ModelRegistry(backend="cuda", mesh=mesh),
            "cuda": ModelRegistry(backend="cuda", device=device),
            "torch": ModelRegistry(backend="torch", device=device)}
    keys = []
    for i, v in enumerate(("fuse_half", "depthwise")):
        m = regs["mesh"].register(net, v, seed=seed + i)
        for name in ("cuda", "torch"):
            regs[name].register(net, v, params=m.params)
        keys.append(m.key)
    rng = np.random.default_rng((seed, 13))

    # (a) every bucket on every group width, against the unsharded paths
    not_bitwise, worst = [], 0.0
    for key in keys:
        variant = key.split("/")[1]
        for bucket in MESH_BUCKETS:
            x = rng.standard_normal((bucket, res, res, 3)).astype(np.float32)
            ref = regs["torch"].apply(key, x).materialize().copy()
            whole = regs["cuda"].apply(key, x).materialize().copy()
            scale = max(1.0, float(np.abs(ref).max()))
            for width in MESH_WIDTHS:
                rows = bucket // width if bucket % width == 0 else bucket
                stripes = bucket // rows
                kops.reset_launch_counts()
                got = regs["mesh"].apply(
                    key, x, devices=mesh.devices[:width]).materialize()
                counts = {k: c for k, c in kops.launch_counts().items() if c}
                expected = collections.Counter(
                    name for name, _ in zoo.kernel_launches(net, variant,
                                                            rows))
                expected = {k: stripes * c for k, c in expected.items()}
                if counts != expected:
                    raise SystemExit(f"mesh {key} bucket {bucket} width "
                                     f"{width}: launches {counts}, not "
                                     f"{expected}")
                d_ref = float(np.abs(got - ref).max()) / scale
                d_whole = float(np.abs(got - whole).max()) / scale
                if not np.all(np.isfinite(got)) or max(d_ref, d_whole) \
                        > SERVE_RTOL:
                    raise SystemExit(f"mesh {key} bucket {bucket} width "
                                     f"{width}: max|d torch| / scale "
                                     f"{d_ref:.2e}, max|d cuda| / scale "
                                     f"{d_whole:.2e} (tolerance "
                                     f"{SERVE_RTOL})")
                worst = max(worst, d_ref, d_whole)
                same = bool(np.array_equal(got, whole))
                if not same:
                    not_bitwise.append((variant, bucket, rows))
                print(f"mesh {key} bucket {bucket} width {width} ({stripes} "
                      f"stripe{'s' if stripes > 1 else ''} of {rows}): max|d "
                      f"torch| / scale {d_ref:.2e}, max|d unstriped cuda| / "
                      f"scale {d_whole:.2e}, bitwise "
                      f"{'equal' if same else 'NOT equal'} to unstriped "
                      f"cuda, launches {counts}")
    print(f"mesh: worst max|d| / scale {worst:.2e} (tolerance "
          f"{SERVE_RTOL}); striped logits bitwise equal to unstriped in "
          f"{len(MESH_BUCKETS) * len(MESH_WIDTHS) * len(keys) - len(not_bitwise)}"
          f" of {len(MESH_BUCKETS) * len(MESH_WIDTHS) * len(keys)} cases")
    for variant, bucket, rows in sorted(set(not_bitwise)):
        breaks = stripe_breaks(net, variant, bucket, rows,
                               regs["cuda"].device, seed)
        print(f"mesh not bitwise: {variant} bucket {bucket} as stripes of "
              f"{rows}: " + ("; ".join(breaks) if breaks else
                             "every hand kernel is bitwise on its stripe, "
                             "so the break is in the library ops (cuDNN's "
                             "stem conv, the dense head)"))
    for key in keys:
        for width in MESH_WIDTHS:
            x = rng.standard_normal((8, res, res, 3)).astype(np.float32)
            walls = []
            for _ in range(6):
                t0 = time.perf_counter()
                regs["mesh"].apply(key, x,
                                   devices=mesh.devices[:width]).materialize()
                walls.append((time.perf_counter() - t0) * 1e3)
            print(f"mesh {key} bucket 8 over {width} logical device"
                  f"{'s' if width > 1 else ''}: batch wall (pinned upload, "
                  f"forward, copy back) median "
                  f"{sorted(walls[1:])[len(walls[1:]) // 2]:.2f} ms of 5; "
                  f"{card}")

    # the pipelined engine: cross-model rounds over the mesh
    img_rng = np.random.default_rng((seed, 4))
    lo, hi = (res * 5) // 7, (res * 9) // 7
    images = [img_rng.standard_normal(
        (int(img_rng.integers(lo, hi + 1)), int(img_rng.integers(lo, hi + 1)),
         3)).astype(np.float32) for _ in range(MESH_REQUESTS)]
    sync = VisionServeEngine(regs["torch"], buckets=MESH_BUCKETS,
                             pipelined=False)
    reference, _ = submit_round(sync, keys, images)
    sync.close()
    engine = create_engine(regs["mesh"], "pipelined", buckets=MESH_BUCKETS,
                           cost_model=SystolicCostModel(
                               calibrator=LatencyCalibrator(),
                               n_devices=MESH_DEVICES,
                               round_planner="adaptive"))
    try:
        t0 = time.perf_counter()
        warmed = engine.warmup()
        warm_s = time.perf_counter() - t0
        groups = sorted({ids for _, _, ids in warmed if ids is not None})
        cold = [(k, b, ids) for k, b, ids in warmed if ids is not None
                and not regs["mesh"].is_compiled(
                    k, b, regs["mesh"].devices_by_id(ids))]
        if not engine.cross_model or not groups or cold:
            raise SystemExit(f"mesh engine: cross_model "
                             f"{engine.cross_model}, warmed groups "
                             f"{groups}, entries not warm {cold}")
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        rids = [engine.submit(keys[i % 2], img)
                for i, img in enumerate(images)]
        results = engine.flush()
        wall_s = time.perf_counter() - t0
        counts = kops.launch_counts()
        snap = engine.snapshot()
    finally:
        engine.close()
    if [r.rid for r in results] != rids:
        raise SystemExit(f"mesh engine: results in order "
                         f"{[r.rid for r in results]}, not {rids}")
    worst = check_served("mesh engine", results, reference)
    missing = [k for k, c in counts.items() if c == 0]
    if missing or snap["rounds"] < 1 or snap["cross_model_rounds"] < 1:
        raise SystemExit(f"mesh engine: rounds {snap['rounds']}, cross-model"
                         f" {snap['cross_model_rounds']}, kernels never "
                         f"launched {missing}")
    print(f"mesh engine: warmup {warm_s:.1f} s over {len(warmed)} entries "
          f"(groups {groups} besides the whole mesh); {MESH_REQUESTS} "
          f"requests in {wall_s * 1e3:.1f} ms (round wall), rounds "
          f"{snap['rounds']} (cross-model {snap['cross_model_rounds']}, "
          f"strategies {snap['round_strategies']}, max groups "
          f"{snap['max_round_groups']}), devices per batch "
          f"{sorted(collections.Counter(r.n_devices for r in results).items())}"
          f", worst max|d torch| / scale {worst:.2e}, host stage "
          f"{snap['host_busy_s'] * 1e3:.2f} ms, device stage "
          f"{snap['device_busy_s'] * 1e3:.2f} ms, launches {counts}; {card}")

    # (b) the launcher as two processes on the card, and as one
    if device == "cuda":
        mode = compute_mode()
        print(f"mesh pair: the card's compute mode is {mode}")
        if "exclusive" in mode.lower():
            raise SystemExit(f"mesh pair: compute mode {mode} refuses a "
                             f"second process on the card")
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import multiprocess_check_torch as mpcheck
    work = os.path.join(ROOT, "build", "mesh_pair")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    common = ["--models", *launch_models, "--buckets", "8", "--requests",
              str(MESH_REQUESTS), "--seed", str(seed), *launch_extra]
    single_json = os.path.join(work, "single.json")
    t0 = time.perf_counter()
    single_proc = mpcheck.launch([*common, "--mesh", str(MESH_DEVICES),
                                  "--json", single_json], MESH_DEVICES)
    try:
        coord, worker = mpcheck.run_pair(common, work, timeout=600)
    finally:
        (rc, out, err), = mpcheck.drain({"single": single_proc},
                                        timeout=600).values()
    if rc != 0:
        raise SystemExit(f"mesh single-process launcher exited with {rc}:"
                         f"\n{err[-4000:]}")
    with open(single_json) as f:
        single = json.load(f)
    verdicts = mpcheck.checks(single, coord, worker, MESH_REQUESTS, device)
    mp, w = coord.get("multiprocess", {}), worker["worker"]
    wcache = worker["compilation"]["persistent"]
    ccache = coord["compilation"]["persistent"]
    print(f"mesh pair: coordinator and worker (2 logical devices each) and "
          f"one process over {MESH_DEVICES}, at once, in "
          f"{time.perf_counter() - t0:.1f} s; rounds broadcast "
          f"{mp.get('rounds_broadcast')} ({mp.get('broadcast_bytes')} bytes),"
          f" shards gathered {mp.get('shards_gathered')} "
          f"({mp.get('gather_bytes')} bytes), worker parts "
          f"{w['parts_executed']}, warmed {w['warmup_entries_warmed']}; "
          f"build cache: coordinator {ccache['misses']} misses "
          f"({ccache['compile_s']:.1f} s of nvcc), worker {wcache['hits']} "
          f"hits {wcache['misses']} misses; logits_sha256 pair "
          f"{coord['logits_sha256'][:16]} single "
          f"{single['logits_sha256'][:16]}")
    for name, snap_ in (("pair", coord), ("single", single)):
        e2e = snap_["e2e"]
        print(f"mesh {name}: {snap_['completed']} completed, rounds "
              f"{snap_['rounds']}, wall "
              f"{snap_['completed'] / snap_['throughput_ips'] * 1e3:.1f} ms, "
              + ", ".join(f"{k} e2e p50 {st['p50_ms']:.2f} p95 "
                          f"{st['p95_ms']:.2f} ms"
                          for k, st in sorted(e2e.items())) + f"; {card}")
    for name, ok in sorted(verdicts.items()):
        print(f"mesh pair check {'PASS' if ok else 'FAIL'} {name}")
    failed = [name for name, ok in verdicts.items() if not ok]
    if failed or "multiprocess" not in coord:
        raise SystemExit(f"mesh pair: checks failed {failed}")
    print(f"mesh: phase wall {time.perf_counter() - t_phase:.1f} s")
    return counts


def sharded_phase(seed: int, device="cuda", card="", smoke=False,
                  prompt_lens=SHORT_PROMPT_LENS,
                  max_new=SHORT_MAX_NEW) -> dict:
    """Phase 14: ``recurrentgemma_2b`` at its production config in
    bfloat16 from phase 9's seeded init, served through
    ``ServeEngine(policy=ShardingPolicy(mesh, cfg))`` (profile ``tp``) on
    backend ``cuda``, the parameters distributed by the policy
    (``shard_tree``) on ``make_host_mesh(device)``: a world-1 group
    (``nccl`` on the card) and its 1x1 ("data", "model") mesh, the widest
    one card gives (NCCL refuses two ranks on one GPU).  The short
    traffic (phase 9 pays for the long generate), held against the
    unsharded ``cuda`` engine on the same weights, run here first: every
    parameter a DTensor with its spec's placements,
    identical tokens, every call's logits within ``LM_BF16_RTOL`` of the
    unsharded ones (bitwise equality printed), exactly ``n_conv``
    ``fuse1d`` launches per prefill and none per decode step, all at
    (4, shortest prompt, 2560) K4 causal bf16 on each rank's local shard.
    Prefill ms, decode ms per step and peak memory of both engines
    (``generate_rows``), and how many leaves the policy shards on
    "model", are printed.  The group is destroyed at the end.  Returns
    the sharded generate's ``fuse1d`` launches by shape."""
    import dataclasses
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import configs as C, tree
    from repro_torch.launch import mesh as tmesh, sharding as tsh
    from repro_torch.launch.distributed import shutdown_distributed
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Request, ServeEngine
    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    base = C.get_smoke_config(LM_ARCH) if smoke else C.get_config(LM_ARCH)
    cfg = dataclasses.replace(base, dtype="bfloat16")
    n_conv = sum(k in CONV_KINDS for k in cfg.layer_pattern)
    width = int(cfg.d_model * cfg.recurrent.width_factor)
    k = cfg.recurrent.conv_width
    want_shape = (torch.bfloat16, (LM_SLOTS, min(prompt_lens), 1, width), k,
                  1, k - 1, 0)
    reqs = [Request(p, max_new)
            for p in lm_prompts(seed, cfg.vocab_size, prompt_lens)]
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(seed), device=dev)
    runs = {"unsharded": traced_generate(
        ServeEngine(build_model(cfg, "cuda"), params, max_seq=LM_MAX_SEQ,
                    batch_slots=LM_SLOTS), reqs, sync)}
    mesh = tmesh.make_host_mesh(device)
    try:
        policy = tsh.ShardingPolicy(mesh, cfg)
        specs = policy.param_specs(params)
        t0 = time.perf_counter()
        sharded = tsh.shard_tree(params, policy.param_shardings(params))
        sync()
        shard_s = time.perf_counter() - t0
        del params                       # the shards are copies
        bad = [i for i, (t, s) in enumerate(zip(tree.tree_leaves(sharded),
                                                tree.tree_leaves(specs)))
               if not isinstance(t, DTensor)
               or tuple(t.placements) != tsh.placements(mesh, s)]
        if bad:
            raise SystemExit(f"sharded: leaves {bad} are not DTensors with "
                             f"their spec's placements")
        n_leaves = len(tree.tree_leaves(specs))
        n_model = sum("model" in tuple(s) for s in tree.tree_leaves(specs))
        print(f"sharded: {LM_ARCH} bf16 ({cfg.num_layers} layers, {n_conv} "
              f"with a temporal conv), 1x1 (data, model) mesh over a world-1 "
              f"{torch.distributed.get_backend()} group, profile "
              f"{policy.profile}: {n_model} of {n_leaves} leaves sharded on "
              f"'model', distributed in {shard_s:.2f} s; {card}")
        runs["policy"] = traced_generate(
            ServeEngine(build_model(cfg, "cuda"), sharded,
                        max_seq=LM_MAX_SEQ, batch_slots=LM_SLOTS,
                        policy=policy), reqs, sync)
    finally:
        shutdown_distributed()
    pol, uns = runs["policy"], runs["unsharded"]
    for label, run in runs.items():
        check_launches(f"sharded ({label})", run, n_conv)
    if dict(pol["by_shape"]) != {want_shape: n_conv}:
        raise SystemExit(f"sharded: fuse1d launches by shape "
                         f"{shape_counts(pol['by_shape'])}, expected "
                         f"{shape_counts({want_shape: n_conv})}")
    calls = list(zip(pol["prefill"] + pol["decode"],
                     uns["prefill"] + uns["decode"]))
    if len(pol["decode"]) != len(uns["decode"]):
        raise SystemExit(f"sharded: {len(pol['decode'])} decode steps under "
                         f"the policy, {len(uns['decode'])} without")
    worst, worst_abs = check_logits(
        "sharded (0 = prefill, policy against unsharded)", calls,
        LM_BF16_RTOL, (LM_SLOTS, cfg.vocab_size))
    bitwise = all(torch.equal(a, b) for a, b in calls)
    if pol["tokens"] != uns["tokens"] or [len(t) for t in pol["tokens"]] \
            != [max_new] * len(reqs):
        raise SystemExit("sharded: token lists differ between the policy "
                         "and the unsharded engine, or are short")
    rows = generate_rows("sharded", runs, min(prompt_lens), card)
    dispatch = ((rows["policy"]["decode_ms_median"] or 0)
                - (rows["unsharded"]["decode_ms_median"] or 0))
    print(f"sharded: {len(calls)} calls within {worst:.3e} of the scale "
          f"(max|d| {worst_abs:.3e}, tolerance {LM_BF16_RTOL}), bitwise "
          f"{'equal' if bitwise else 'NOT equal'}; tokens identical; fuse1d "
          f"by shape {shape_counts(pol['by_shape'])}; DTensor dispatch adds "
          f"{dispatch:.3f} ms to the median decode step; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return {"bfloat16": pol["by_shape"]}


# phase 15: LM training across processes, on one card: RecurrentGemma-2B
# trained under the sharding policy on a world-1 nccl mesh against phase
# 12's one-device run, phase 12's checkpoint restored onto the mesh, the
# policy-trained weights served on the hand kernel; SmolLM-135M crashed and
# restarted on the mesh, int8 on the mesh, the launcher's --distributed
MESH_TRAIN_RTOL = 2.0 ** -7     # losses (relative) and leaves (of max|ref|)
SMOL_MESH_STEPS, SMOL_MESH_CRASH_AT = 4, 2
INT8_MESH_STEPS = 4
INT8_MESH_RTOL = 1e-5           # of each leaf's max|one device|


def leaf_items(state) -> list:
    """(checkpoint key, tensor) of each leaf of a trainer state, a DTensor
    as its local shard (the whole leaf on a world-1 mesh)."""
    from repro_torch import tree
    keys = []
    tree.tree_map_with_path(
        lambda p, _: keys.append("/".join(map(str, p))), state)
    return [(k, getattr(t, "to_local", lambda t=t: t)())
            for k, t in zip(keys, tree.tree_leaves(state))]


def compare_states(label, got, ref, rtol) -> tuple:
    """Every leaf of ``got`` within ``rtol`` of its ``ref`` leaf's max|.|
    (same keys, shapes and dtypes).  Returns (leaves, bitwise equal,
    worst ratio)."""
    import torch
    ref = dict(leaf_items(ref))
    items = leaf_items(got)
    if sorted(k for k, _ in items) != sorted(ref):
        raise SystemExit(f"{label}: the two states hold different leaves")
    bitwise, worst = 0, 0.0
    for k, g in items:
        r = ref[k]
        if g.shape != r.shape or g.dtype != r.dtype:
            raise SystemExit(f"{label}: leaf {k} is {g.dtype} "
                             f"{tuple(g.shape)} against {r.dtype} "
                             f"{tuple(r.shape)}")
        bitwise += bool(torch.equal(g, r))
        d = (g.float() - r.float()).abs().max().item()
        ratio = d / max(r.float().abs().max().item(), 1e-30)
        worst = max(worst, ratio if d else 0.0)
        if d > rtol * r.float().abs().max().item():
            raise SystemExit(f"{label}: leaf {k} is {d:.3e} off, {ratio:.3e}"
                             f" of its scale (tolerance {rtol})")
    return len(items), bitwise, worst


def checkpoint_npz(directory: str, step: int):
    """A port checkpoint's ``state.npz``, opened (its leaves are read one
    at a time: a 26.8 GB state is not held on the host at once)."""
    import numpy as np
    return np.load(os.path.join(directory, f"step_{step}", "state.npz"))


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_train_phase(seed: int, device="cuda", card="", smoke=False,
                     one_device=None, prompt_lens=SHORT_PROMPT_LENS,
                     max_new=SHORT_MAX_NEW) -> dict:
    """Phase 15, the trainer over a mesh on ``make_host_mesh(device)`` (a
    world-1 group, ``nccl`` on the card; NCCL refuses two ranks on one
    GPU, so the world-4 partitioning is held on the CPU,
    ``tests/test_torch_sharded_training.py``).  ``one_device``: phase 12's
    ``keep`` (its final checkpoint on disk, its losses, step ms and peak).

    (a) ``recurrentgemma_2b`` at its production config (phase 12's) trained
    by ``Trainer(mesh=)`` with phase 12's seed, batch and steps: every loss
    within ``MESH_TRAIN_RTOL`` (relative) of phase 12's, no kernel
    launched; step ms (median of steps 2-4), DTensor's cost per step
    against phase 12 and peak memory printed.  The phase drives the
    trainer's own init, batches and step, not ``train()``, whose final
    checkpoint would write another 26.8 GB: the card's machine ends a
    command that writes 45 GiB to its disk, and phase 12 writes 33.6 GB
    (mesh checkpoints are saved and restored by (d), at SmolLM-135M's
    size).
    (b) phase 12's checkpoint (saved without a mesh) restored onto the
    mesh: every leaf a DTensor with its policy's placements and bit for
    bit the checkpoint's, the read seconds printed; (a)'s final state
    within ``MESH_TRAIN_RTOL`` of each leaf's max|.| of it, the leaves
    bitwise equal counted.  (c) (a)'s weights served through
    ``ServeEngine(policy=)`` on backends ``cuda`` and ``torch`` (the short
    traffic): identical tokens, every call's logits within
    ``LM_BF16_RTOL``, exactly ``n_conv`` ``fuse1d`` launches per generate,
    all at (4, 64, 2560) K4 causal on each rank's local shard.  (d)
    ``smollm_135m`` at its production config trained on the mesh
    ``SMOL_MESH_STEPS`` steps straight, and crashed by ``fault_hook`` at
    ``SMOL_MESH_CRASH_AT`` then restarted from its mesh checkpoint: the
    two final checkpoints bitwise equal.  (e) ``INT8_MESH_STEPS`` int8
    steps of ``smollm_135m`` in float32 on the mesh against the one-device
    trainer's on the same batches: every leaf within ``INT8_MESH_RTOL`` of
    its scale.  The group is destroyed; then (f) ``python -m
    repro_torch.launch.train --arch smollm_135m --smoke --distributed
    --num-processes 1`` as a subprocess must train on a world-1 group's
    1x1 mesh and print its final loss.  ``smoke``: the smoke configs at
    sequence 32, for a CPU rehearsal.  Deletes phase 12's checkpoint.
    Returns the served ``fuse1d`` launches by shape, under the dtype."""
    import dataclasses
    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import configs as C, tree
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import mesh as tmesh, sharding as tsh
    from repro_torch.launch.distributed import shutdown_distributed
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def free():
        if on_card:
            torch.cuda.empty_cache()

    build = os.path.join(ROOT, "build")
    seq = 32 if smoke else TRAIN_SEQ
    get = C.get_smoke_config if smoke else C.get_config
    cfg = get(LM_ARCH)
    n_conv = sum(k in CONV_KINDS for k in cfg.layer_pattern)
    width = int(cfg.d_model * cfg.recurrent.width_factor)
    k = cfg.recurrent.conv_width
    want_shape = (torch.float32 if cfg.dtype == "float32" else torch.bfloat16,
                  (LM_SLOTS, min(prompt_lens), 1, width), k, 1, k - 1, 0)
    dirs = {name: os.path.join(build, f"lm_mesh_{name}") for name in (
        "train", "smol_straight", "smol_restart", "int8_mesh", "int8_one",
        "launcher")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    mesh = tmesh.make_host_mesh(device)
    try:
        # (a) RG-2B trained under the policy
        trainer = Trainer(cfg, TrainerConfig(
            steps=TRAIN_STEPS, global_batch=TRAIN_BATCH, seq_len=seq,
            microbatches=1, ckpt_dir=dirs["train"], seed=seed), mesh=mesh)
        free()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        params, opt_state, _ = trainer.init_state()
        hist = []
        for step in range(TRAIN_STEPS):
            t1 = time.perf_counter()
            batch = trainer._place_batch(trainer._get_batch(step))
            params, opt_state, metrics = trainer.step_fn(
                params, opt_state, step, batch)
            sync()
            hist.append({"loss": float(metrics["loss"]),
                         "sec_per_step": time.perf_counter() - t1})
        train_s = time.perf_counter() - t0
        counts = kops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        losses = [h["loss"] for h in hist]
        if any(counts.values()):
            raise SystemExit(f"mesh_train {LM_ARCH}: training launched "
                             f"kernels {counts}")
        ref_losses = one_device["losses"]
        loss_err = max((abs(a - b) / abs(b) for a, b in
                        zip(losses, ref_losses)), default=math.inf)
        if len(losses) != len(ref_losses) or not loss_err <= MESH_TRAIN_RTOL:
            raise SystemExit(f"mesh_train {LM_ARCH}: losses {losses} under "
                             f"the policy against {ref_losses} on one device"
                             f" (tolerance {MESH_TRAIN_RTOL} relative)")
        later = sorted(h["sec_per_step"] for h in hist[1:])
        step_ms = later[len(later) // 2] * 1e3
        print(f"mesh_train {LM_ARCH}{' (smoke)' * smoke}: {cfg.dtype}, "
              f"{TRAIN_STEPS} steps of {TRAIN_BATCH}x{seq} tokens by "
              f"Trainer(mesh=) on a 1x1 mesh over a world-1 "
              f"{torch.distributed.get_backend()} group: losses "
              f"{[round(x, 4) for x in losses]} against phase 12's "
              f"{[round(x, 4) for x in ref_losses]} (worst {loss_err:.3e} "
              f"relative, bitwise {losses == ref_losses}); step ms "
              f"{[round(h['sec_per_step'] * 1e3, 1) for h in hist]}, median "
              f"of steps 2-{TRAIN_STEPS} {step_ms:.1f} ms against "
              f"{one_device['step_ms']:.1f} ms on one device (DTensor adds "
              f"{step_ms - one_device['step_ms']:.1f} ms a step); train wall "
              f"{train_s:.1f} s (the init included); peak device memory "
              f"{peak} B against {one_device['peak']} B; launches {counts}; "
              f"{card}")
        trained = {"params": params, "opt": opt_state}
        del params, opt_state, batch, hist

        # (b) phase 12's checkpoint restored onto the mesh, bit for bit;
        # (a)'s final state against it
        p_t, o_t = trainer.state_template()
        sync()
        t0 = time.perf_counter()
        restored, manifest = CheckpointManager(
            one_device["ckpt_dir"]).restore(
                one_device["step"], {"params": p_t, "opt": o_t},
                shardings={"params": trainer.shardings[0],
                           "opt": trainer.shardings[1]})
        sync()
        read_s = time.perf_counter() - t0
        specs = trainer.policy.param_specs(p_t)
        specs = {"params": specs, "opt": {"m": specs, "v": specs}}
        bad = [i for i, (t, sp) in enumerate(zip(
            tree.tree_leaves(restored), tree.tree_leaves(specs)))
            if not isinstance(t, DTensor)
            or tuple(t.placements) != tsh.placements(mesh, sp)]
        if bad or manifest["step"] != one_device["step"]:
            raise SystemExit(f"mesh_train restore: leaves {bad} are not "
                             f"DTensors with their policy's placements, or "
                             f"the step is {manifest['step']}")
        with checkpoint_npz(one_device["ckpt_dir"], one_device["step"]) \
                as stored:
            for key, t in leaf_items(restored):
                got = t.cpu()
                got = (got.view(torch.int16) if got.dtype == torch.bfloat16
                       else got).numpy()
                if not np.array_equal(got, stored[key]):
                    raise SystemExit(f"mesh_train restore: leaf {key} on the"
                                     f" mesh is not bit for bit the "
                                     f"checkpoint's")
        n_leaves, n_bitwise, worst = compare_states(
            f"mesh_train {LM_ARCH} trained under the policy against phase "
            f"12", trained, restored, MESH_TRAIN_RTOL)
        print(f"mesh_train restore: phase 12's step-{one_device['step']} "
              f"checkpoint (saved without a mesh) read onto the mesh in "
              f"{read_s:.2f} s, {n_leaves} leaves, each a DTensor with its "
              f"policy's placements and bit for bit the checkpoint's; the "
              f"state trained under the policy against it: worst max|d| / "
              f"scale {worst:.3e} (tolerance {MESH_TRAIN_RTOL}), "
              f"{n_bitwise} of {n_leaves} leaves bitwise equal; {card}")
        del restored, trained["opt"], trainer
        shutil.rmtree(one_device["ckpt_dir"])
        free()

        # (c) the weights trained under the policy, served on the kernel
        policy = tsh.ShardingPolicy(mesh, cfg)
        reqs = [Request(p, max_new)
                for p in lm_prompts(seed, cfg.vocab_size, prompt_lens)]
        runs = {bk: traced_generate(
            ServeEngine(build_model(cfg, bk), trained["params"],
                        max_seq=LM_MAX_SEQ, batch_slots=LM_SLOTS,
                        policy=policy), reqs, sync)
            for bk in ("cuda", "torch")}
        label = f"mesh_train {LM_ARCH} trained under the policy, served"
        check_launches(label, runs["cuda"], n_conv)
        if any(runs["torch"]["counts"].values()):
            raise SystemExit(f"{label}: backend torch launched kernels "
                             f"{runs['torch']['counts']}")
        served = runs["cuda"]["by_shape"]
        if dict(served) != {want_shape: n_conv}:
            raise SystemExit(f"{label}: fuse1d launches by shape "
                             f"{shape_counts(served)}, expected "
                             f"{shape_counts({want_shape: n_conv})}")
        rtol = LM_BF16_RTOL if cfg.dtype == "bfloat16" else KERNEL_RTOL
        n_calls, worst, worst_abs = check_backends(
            label, runs, rtol, len(reqs), max_new, cfg.vocab_size)
        generate_rows(label, runs, min(prompt_lens), card)
        print(f"{label}: cuda vs torch over {n_calls} calls: worst max|d| / "
              f"scale {worst:.3e} (max|d| {worst_abs:.3e}, tolerance "
              f"{rtol}), tokens identical; fuse1d by shape "
              f"{shape_counts(served)}; first request's tokens "
              f"{runs['cuda']['tokens'][0]}; {card}")
        del runs, trained
        free()

        # (d) SmolLM-135M on the mesh: straight, and crashed + restarted
        smol = get(SMOL_ARCH)

        def smol_trainer(name, ckpt_every):
            return Trainer(smol, TrainerConfig(
                steps=SMOL_MESH_STEPS, global_batch=SMOL_BATCH,
                seq_len=seq if smoke else SMOL_SEQ, microbatches=1,
                log_every=1, ckpt_every=ckpt_every, ckpt_dir=dirs[name],
                seed=seed), mesh=mesh)

        class Crash(Exception):
            pass

        def crash(step):
            if step == SMOL_MESH_CRASH_AT:
                raise Crash()

        t0 = time.perf_counter()
        smol_trainer("smol_straight", 0).train()
        straight_s = time.perf_counter() - t0
        crashed = smol_trainer("smol_restart", SMOL_MESH_CRASH_AT)
        try:
            crashed.train(fault_hook=crash)
            raise SystemExit("mesh_train smol: the fault hook did not fire")
        except Crash:
            pass
        if crashed.ckpt.latest_step() != SMOL_MESH_CRASH_AT:
            raise SystemExit(f"mesh_train smol: the crashed run's latest "
                             f"checkpoint is {crashed.ckpt.latest_step()}")
        logged = [h["step"] for h in
                  smol_trainer("smol_restart",
                               SMOL_MESH_CRASH_AT).train()["history"]]
        if logged != list(range(SMOL_MESH_CRASH_AT, SMOL_MESH_STEPS)):
            raise SystemExit(f"mesh_train smol: the restart logged steps "
                             f"{logged}")
        with checkpoint_npz(dirs["smol_straight"], SMOL_MESH_STEPS) as a, \
                checkpoint_npz(dirs["smol_restart"], SMOL_MESH_STEPS) as b:
            n_smol = len(a.files)
            if sorted(a.files) != sorted(b.files) or not all(
                    np.array_equal(a[k], b[k]) for k in a.files):
                raise SystemExit("mesh_train smol: the restarted run's final"
                                 " checkpoint is not bitwise the straight "
                                 "run's")
        print(f"mesh_train {SMOL_ARCH}{' (smoke)' * smoke}: {smol.dtype}, "
              f"{SMOL_MESH_STEPS} steps of {SMOL_BATCH}x"
              f"{seq if smoke else SMOL_SEQ} tokens on the mesh in "
              f"{straight_s:.1f} s; crashed at step {SMOL_MESH_CRASH_AT} and "
              f"restarted from its mesh checkpoint (logged steps {logged}): "
              f"the two step-{SMOL_MESH_STEPS} checkpoints, {n_smol} "
              f"leaves, bitwise equal; {card}")

        # (e) int8 on the mesh against one device, in fp32
        smol32 = dataclasses.replace(smol, dtype="float32")
        int8 = {}
        for name, on_mesh in (("int8_mesh", mesh), ("int8_one", None)):
            t0 = time.perf_counter()
            out = Trainer(smol32, TrainerConfig(
                steps=INT8_MESH_STEPS, global_batch=SMOL_BATCH, seq_len=32,
                microbatches=2, log_every=1, ckpt_every=0,
                ckpt_dir=dirs[name], grad_compression="int8", seed=1),
                device=dev, mesh=on_mesh,
                optimizer=adamw(3e-3, weight_decay=0.0)).train()
            int8[name] = ({"params": out["params"], "opt": out["opt_state"]},
                          [h["loss"] for h in out["history"]],
                          time.perf_counter() - t0)
            del out
        n_leaves, n_bitwise, worst = compare_states(
            f"mesh_train {SMOL_ARCH} int8 on the mesh against one device",
            int8["int8_mesh"][0], int8["int8_one"][0], INT8_MESH_RTOL)
        print(f"mesh_train {SMOL_ARCH} int8: {INT8_MESH_STEPS} steps of "
              f"{SMOL_BATCH}x32 tokens in 2 microbatches, fp32, int8 gradient"
              f" compression, on the mesh ({int8['int8_mesh'][2]:.1f} s) "
              f"against one device ({int8['int8_one'][2]:.1f} s): losses "
              f"{[round(x, 4) for x in int8['int8_mesh'][1]]} and "
              f"{[round(x, 4) for x in int8['int8_one'][1]]}; worst max|d| / "
              f"scale {worst:.3e} (tolerance {INT8_MESH_RTOL}), {n_bitwise} "
              f"of {n_leaves} leaves bitwise equal; {card}")
        del int8
    finally:
        shutdown_distributed()
    free()

    # (f) the launcher's --distributed on one process
    t0 = time.perf_counter()
    proc = run_lm_launcher(
        ["--arch", SMOL_ARCH, "--smoke", "--device", device, "--distributed",
         "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes", "1",
         "--process-id", "0", "--steps", "4", "--ckpt-dir",
         dirs["launcher"]], module="repro_torch.launch.train")
    want = (f"mesh: 1x1 ('data', 'model') over a world-1 "
            f"{'nccl' if on_card else 'gloo'} group")
    final = [l for l in proc.stdout.splitlines()
             if l.startswith("final loss: ")]
    if proc.returncode != 0 or want not in proc.stdout or len(final) != 1 \
            or not math.isfinite(float(final[0].split()[-1])):
        raise SystemExit(f"mesh_train launcher exited {proc.returncode}:\n"
                         f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    print(f"mesh_train launcher: {SMOL_ARCH} (smoke) --distributed "
          f"--num-processes 1: exit 0 in {time.perf_counter() - t0:.1f} s, "
          f"{want!r}, {final[0]!r}")
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    print(f"mesh_train: phase wall {time.perf_counter() - t_phase:.1f} s")
    return {cfg.dtype: served}


def zoo_report(pair_counts, rows, notes) -> dict:
    """Phase 3's zoo-wide report: each distinct bucket-8 shape's row, the
    sums Σ launches x ms, x bound and x library per (network, variant) and
    per kernel, and the shapes where the library call beats the kernel.
    Also written to build/chip_smoke_shapes.json.  ``rows`` maps
    (kernel, shape json) to its measured row."""
    keys = ("ms", "bound_ms", "library_ms")
    per_pair, per_kernel = {}, {}
    for (net_name, v), counts in pair_counts.items():
        sums = {}
        for (name, label), n in counts.items():
            acc = sums.setdefault(name, dict(launches=0, shapes=0,
                                             **{k: 0.0 for k in keys}))
            acc["launches"] += n
            acc["shapes"] += 1
            for k in keys:
                acc[k] += n * rows[(name, label)][k]
        per_pair[f"{net_name}/{v}"] = sums
        for name, acc in sums.items():
            tot = per_kernel.setdefault(name, dict(launches=0, **{
                k: 0.0 for k in keys}))
            tot["launches"] += acc["launches"]
            for k in keys:
                tot[k] += acc[k]
    print(f"zoo: {len(rows)} distinct kernel shapes at bucket 8 over "
          f"{len(pair_counts)} (network, variant) pairs")
    for (name, label), r in rows.items():
        print(f"  zoo {name} {r['shape']}: {r['ms']:.4f} ms, library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}), plain {r['plain_ms']:.4f}, err "
              f"{r['max_abs_err']:.2e}{notes.get((name, label), '')}")
    for pair, sums in per_pair.items():
        total = {k: sum(acc[k] for acc in sums.values()) for k in keys}
        print(f"zoo sums {pair}: launches x ms {total['ms']:.4f}, x bound "
              f"{total['bound_ms']:.4f}, x library {total['library_ms']:.4f}; "
              + "; ".join(f"{name} {acc['launches']} launches over "
                          f"{acc['shapes']} shapes {acc['ms']:.4f} (bound "
                          f"{acc['bound_ms']:.4f}, library "
                          f"{acc['library_ms']:.4f})"
                          for name, acc in sorted(sums.items())))
    for name, tot in sorted(per_kernel.items()):
        print(f"zoo sums kernel {name}: {tot['launches']} launches, "
              f"launches x ms {tot['ms']:.4f}, x bound {tot['bound_ms']:.4f}"
              f", x library {tot['library_ms']:.4f}")
    wins = [(name, r) for (name, _), r in rows.items()
            if r["library_ms"] < r["ms"]]
    print(f"zoo: the library call beats the kernel at {len(wins)} of "
          f"{len(rows)} shapes")
    for name, r in wins:
        print(f"  library wins {name} {r['shape']}: kernel {r['ms']:.4f} ms,"
              f" library {r['library_ms']:.4f} ms")
    out = dict(rows=[dict(r, name=name, key=json.loads(label))
                     for (name, label), r in rows.items()],
               per_pair=per_pair, per_kernel=per_kernel)
    path = os.path.join(ROOT, "build", "chip_smoke_shapes.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace one more served round with torch.profiler")
    ap.add_argument("--parent", metavar="DIR",
                    help="also time the kernels of the tree at DIR")
    ap.add_argument("--time-only", nargs=2, metavar=("SHAPES", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--src", help=argparse.SUPPRESS)
    ap.add_argument("--xlstm-rtol-readings", type=int, metavar="N",
                    help="only print XLSTM_BF16_FWD_RTOL's readings on "
                    "seeds 0..N-1, sound and with planted faults")
    args = ap.parse_args()
    if args.src:
        sys.path.insert(0, args.src)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if args.time_only:
        return time_kernels_only(*args.time_only, args.seed, args.profile)
    if args.xlstm_rtol_readings:
        print(card_line())
        xlstm_fwd_readings(range(args.xlstm_rtol_readings))
        return 0

    from repro_torch.kernels import _build, ops as kops
    from repro_torch.kernels.fused import same_pad
    from repro_torch.serving.vision import (ModelRegistry, VisionServeEngine)
    from repro_torch.vision import zoo

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(args.seed)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    # -- 1. card -------------------------------------------------------------
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    infos = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(infos)} sources (parallel nvcc)")
    spilled = {}
    for info in infos.values():
        print(f"  {info.name}.cu: {info.seconds:.1f} s")
        for line in info.ptxas.splitlines():
            if re.search(r"Compiling entry|Used \d+ registers|spill", line):
                print("   ", line.strip())
        spilled.update({fn: sl for fn, sl in spills(info.ptxas).items()
                        if any(sl)})
    if spilled:
        raise SystemExit(f"depthwise/fuseconv/sgemm/stage kernels have a "
                         f"stack frame or spill (frame, stores, loads): "
                         f"{spilled}")
    for src, kernels in (("fused", "depthwise_kernel or fuseconv_kernel"),
                         ("matmul", "sgemm_kernel"),
                         ("fuse1d", "stage_direct_kernel")):
        if infos[src].ptxas:
            print(f"build: no stack frame or spill in {kernels}")
        else:
            print(f"build: spill check not run for {kernels}: {src}.cu was "
                  f"built before this run (build/kernels), so there is no "
                  f"-Xptxas -v report")

    # -- 3. kernels ----------------------------------------------------------
    t_phase = time.perf_counter()
    time_ms = make_timer(dev)
    tiny = torch.zeros(1, device=dev)
    floor_ms = time_ms(lambda: tiny.add_(1))
    print(f"timer floor: one 1-element kernel {floor_ms:.4f} ms (every time "
          f"below includes this launch-to-end overhead)")
    b = 8    # the serve phase's largest bucket
    _, lo, hi = same_pad(56, 5, 2)
    # Each kernel at the shape timed since the first port (its largest
    # main-path shape; for fuse1d its largest FuSe stage) and at a ragged
    # one; fuse1d's 1-D form at the shape it was timed at before and at a
    # ragged one.
    timed = {
        "matmul": dict(m=b * 112 * 112, k=16, n=64),
        "fuse1d": dict(b=b, h=56, w=56, c=72, k=5, stride=2,
                       variant="fuse_half"),
        "depthwise_kxk": dict(b=b, h=112, w=112, c=64, k=3, stride=2),
        "fuseconv_fused": dict(b=b, h=112, w=112, c=64, k=3, stride=2,
                               variant="fuse_half", cout=24, act="relu"),
    }
    ragged = {
        "matmul": dict(m=1001, k=37, n=75),
        "fuse1d": dict(b=2, h=13, w=11, c=37, k=5, stride=2,
                       variant="fuse_full"),
        "depthwise_kxk": dict(b=3, h=13, w=10, c=37, k=5, stride=2),
        "fuseconv_fused": dict(b=2, h=13, w=11, c=37, k=5, stride=2,
                               variant="fuse_full", cout=45, act="hswish"),
    }
    one_d = dict(n=b * 56, t=56 + lo + hi, c=36, k=5)
    one_d_ragged = dict(n=7, t=15, c=5, k=3)
    sources = {"matmul": ("matmul.cu", "src/repro/kernels/matmul.py:52"),
               "fuse1d": ("fuse1d.cu", "src/repro/kernels/fuse1d.py:65"),
               "depthwise_kxk": ("fused.cu", "src/repro/kernels/fused.py:285"),
               "fuseconv_fused": ("fused.cu",
                                  "src/repro/kernels/fused.py:212")}
    # Every distinct kernel shape at bucket 8 of every paper network in
    # fuse_half, fuse_full and depthwise (224 px, width 1.0), and how often
    # each (network, variant) launches it.  MobileNetV3-Large fuse_half +
    # depthwise, the path served since the first port, keeps its own sums.
    net = zoo.mobilenet_v3_large()                # 224 px, width 1.0
    variants = ("fuse_half", "depthwise")
    pair_counts = {
        (net_name, v): collections.Counter(
            (name, json.dumps(sh, sort_keys=True))
            for name, sh in zoo.kernel_launches(factory(), v, b))
        for net_name, factory in zoo.ZOO.items() for v in ZOO_VARIANTS}
    shape_counts = sum((pair_counts[("mobilenet_v3_large", v)]
                        for v in variants), collections.Counter())
    zoo_keys = list(dict.fromkeys(key for counts in pair_counts.values()
                                  for key in counts))
    path_shapes = [(name, json.loads(sh), n) for (name, sh), n in
                   shape_counts.items()]
    # the parent tree's times: timed rows, the 1-D row, then every
    # main-path shape
    all_shapes = [[n, sh] for n, sh in timed.items()] + [
        ["fuse1d", one_d]] + [[n, sh] for n, sh, _ in path_shapes]
    parent_runs = []
    if args.parent:
        parent_runs.append(parent_times(args.parent, all_shapes, args.seed,
                                        args.profile))

    def check(name, label, case, rtol=KERNEL_RTOL) -> float:
        """max|kernel - plain|, failing beyond the tolerance or when a
        second call on the same input is not bitwise equal."""
        got, again, ref = case["run"](), case["run"](), case["plain"]()
        torch.cuda.synchronize()
        assert got.shape == ref.shape, (name, label, got.shape, ref.shape)
        assert got.dtype == ref.dtype, (name, label, got.dtype, ref.dtype)
        err = (got.float() - ref.float()).abs().max().item()
        tol = rtol * max(1.0, ref.float().abs().max().item())
        if not (err <= tol and torch.isfinite(got).all()):
            raise SystemExit(f"kernel {name} disagrees with its plain "
                             f"version at {label}: {err:.3e} > {tol:.3e}")
        if not torch.equal(got, again):
            raise SystemExit(f"kernel {name} at {label}: a repeat on the "
                             f"same input is not bitwise equal")
        return err

    def check_library(label, case, sh) -> None:
        """The library call of a fuse_half stage computes the same function
        (NCHW out) as the plain version, within the kernels' tolerance."""
        if sh.get("variant") != "fuse_half":
            return
        lib, ref = case["library"]().permute(0, 2, 3, 1), case["plain"]()
        err = (lib - ref).abs().max().item()
        if err > KERNEL_RTOL * max(1.0, ref.abs().max().item()):
            raise SystemExit(f"the library call for fuse1d at {label} "
                             f"disagrees with the plain version: {err:.3e}")

    def measure(case, err) -> dict:
        ms, plain_ms = time_ms(case["run"]), time_ms(case["plain"])
        library_ms = time_ms(case["library"])
        bound_ms, bound_by = bound(case["nbytes"], case["flops"])
        row = dict(shape=case["shape"], max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        return row

    def timed_line(name, row, library) -> str:
        return (f"kernel {name} {row['shape']}: {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, {library} "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}); max|kernel-plain| "
                f"{row['max_abs_err']:.3e}, repeat bitwise equal")

    report = {}
    for name, sh in timed.items():
        case = shape_case(name, sh, randn)
        rag = shape_case(name, ragged[name], randn)
        err = max(check(name, "the timed shape", case),
                  check(name, "a ragged shape", rag))
        if is_stage(name, sh):
            check_library("the timed shape", case, sh)
        del rag
        row = measure(case, err)
        print(timed_line(name, row, LIBRARY_NAMES[name]))
        src, replaces = sources[name]
        report[name] = dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/"
            f"{src}", replaces=replaces, launches=None, **row,
            library=LIBRARY_NAMES[name], timer_floor_ms=floor_ms, shapes=[])
        del case
    # fuse1d's 1-D form, the degenerate case of the stage kernel
    case = shape_case("fuse1d", one_d, randn)
    err = max(check("fuse1d", "the 1-D timed shape", case),
              check("fuse1d", "a 1-D ragged shape",
                    shape_case("fuse1d", one_d_ragged, randn)))
    report["fuse1d"]["one_d"] = measure(case, err)
    print(timed_line("fuse1d (1-D)", report["fuse1d"]["one_d"],
                     case["library_name"]))
    del case
    # every distinct shape of the zoo at bucket 8, checked and timed;
    # notes printed beside a row but kept out of the kernels line, whose
    # numbers are all measured (or, for bound_ms, computed from the inputs):
    # the SGEMM's tiling and the stage kernel's grid (one thread per 4-channel
    # output vector, 256 a block; every main-path stage takes VEC = 4)
    t_shapes = time.perf_counter()
    zoo_rows, notes = {}, {}
    for key in zoo_keys:
        name, label = key
        sh = json.loads(label)
        case = shape_case(name, sh, randn)
        row = measure(case, check(name, label, case))
        if name == "matmul":
            til = matmul_tiling(sh["m"], sh["k"], sh["n"])
            notes[key] = (
                f", tile {til['bm']}x{til['bn']} bk {til['bk']} tm "
                f"{til['tm']} ring {til['stages']} split {til['ks']}, "
                f"{til['blocks']} blocks")
        if is_stage(name, sh):
            check_library(label, case, sh)
            st = sh["stride"]
            outs = (sh["b"] * -(-sh["h"] // st) * -(-sh["w"] // st) * sh["c"]
                    * (2 if sh["variant"] == "fuse_full" else 1))
            notes[key] = f", {-(-outs // (4 * 256))} blocks"
        zoo_rows[key] = row
        del case
        torch.cuda.empty_cache()
    shapes_s = time.perf_counter() - t_shapes
    path_rows, stage_rows = [], []
    for name, sh, n in path_shapes:
        key = (name, json.dumps(sh, sort_keys=True))
        row = dict(zoo_rows[key], launches=n)
        notes[id(row)] = notes.get(key, "")
        if is_stage(name, sh):
            stage_rows.append((sh, row))
        report[name]["shapes"].append(row)
        path_rows.append(row)
    if args.parent:
        parent_runs.append(parent_times(args.parent, all_shapes, args.seed,
                                        args.profile))

        def mean(key, i):
            vals = [r[key][i] for r in parent_runs]
            return None if vals[0] is None else sum(vals) / len(vals)

        first = len(timed) + 1
        for i, name in enumerate(timed):
            report[name]["parent_ms"] = mean("ms", i)
        report["fuse1d"]["one_d"]["parent_ms"] = mean("ms", len(timed))
        for i, row in enumerate(path_rows, first):
            row["parent_ms"] = mean("ms", i)
            if mean("ms_spin2", i) is not None:
                row["parent_ms_spin2"] = mean("ms_spin2", i)
                row["parent_kernels"] = parent_runs[0]["kernels"][i]
    for name, entry in report.items():
        rows = entry["shapes"]
        sums = {key: sum(r["launches"] * r[key] for r in rows)
                for key in ("ms", "bound_ms", "library_ms")
                + (("parent_ms",) if args.parent else ())
                + (("parent_ms_spin2",) if args.parent and name == "fuse1d"
                   else ())}
        entry["main_path"] = dict(launches=sum(r["launches"] for r in rows),
                                  **sums)
        print(f"kernel {name}: {len(rows)} main-path shapes at bucket {b}")
        for r in rows:
            par = (f", parent {r['parent_ms']:.4f}" if "parent_ms" in r
                   else "")
            til = notes.get(id(r), "")
            if "parent_ms_spin2" in r:
                til += (f", parent at double spin "
                        f"{r['parent_ms_spin2']:.4f}")
            print(f"  {r['launches']:2d}x {r['shape']}: {r['ms']:.4f} ms"
                  f"{par}, library {r['library_ms']:.4f}, bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}), plain "
                  f"{r['plain_ms']:.4f}, err {r['max_abs_err']:.2e}{til}")
        print(f"kernel {name} main-path sums: launches x ms "
              f"{sums['ms']:.4f}, launches x bound {sums['bound_ms']:.4f}, "
              f"launches x library {sums['library_ms']:.4f}"
              + (f", launches x parent {sums['parent_ms']:.4f}"
                 if args.parent else "")
              + (f", launches x parent at double spin "
                 f"{sums['parent_ms_spin2']:.4f}"
                 if "parent_ms_spin2" in sums else "")
              + f" ({entry['main_path']['launches']} launches)")
    zoo_report(pair_counts, zoo_rows, notes)
    print(f"kernels: phase wall {time.perf_counter() - t_phase:.1f} s, of it "
          f"{shapes_s:.1f} s for the {len(zoo_rows)} distinct zoo shapes")
    torch.cuda.empty_cache()

    # -- 4. serve ------------------------------------------------------------
    regs = {bk: ModelRegistry(backend=bk)
            for bk in ("cuda", "torch", "cuda_nofused")}
    for i, v in enumerate(variants):
        m = regs["cuda"].register(net, v, seed=args.seed + i)
        for bk in ("torch", "cuda_nofused"):
            regs[bk].register(net, v, params=m.params)
    keys = regs["cuda"].keys()
    # the requests draw from a generator of their own, so that they stay the
    # same whatever the phases above check
    img_rng = np.random.default_rng((args.seed, 4))
    images = [img_rng.standard_normal((int(img_rng.integers(160, 289)),
                                       int(img_rng.integers(160, 289)), 3)
                                      ).astype(np.float32)
              for _ in range(16)]

    def serve(reg):
        engine = VisionServeEngine(reg, buckets=(1, 2, 4, 8),
                                   pipelined=False)
        rids = [engine.submit(keys[i % 2], img)
                for i, img in enumerate(images)]
        results = {r.rid: r for r in engine.flush()}
        engine.close()
        return [results[rid] for rid in rids], engine.snapshot()

    serve(regs["cuda"])                        # warm-up: cuDNN, allocator
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    served, snap = serve(regs["cuda"])
    serve_s = time.perf_counter() - t0
    counts = kops.launch_counts()
    reference, _ = serve(regs["torch"])
    nofused, _ = serve(regs["cuda_nofused"])
    print(f"serve: 16 requests ({', '.join(keys)}) in {serve_s * 1e3:.1f} ms,"
          f" batches {snap['batches']}, host stage "
          f"{snap['host_busy_s'] * 1e3:.2f} ms, device stage "
          f"{snap['device_busy_s'] * 1e3:.2f} ms, launches {counts}")
    worst = 0.0
    for i, (r, ref, nof) in enumerate(zip(served, reference, nofused)):
        if r.status != "ok" or ref.status != "ok" or nof.status != "ok":
            raise SystemExit(f"request {i}: status {r.status} / {ref.status}"
                             f" / {nof.status} ({r.error})")
        if r.logits.shape != (1000,) or not np.all(np.isfinite(r.logits)):
            raise SystemExit(f"request {i}: bad logits {r.logits.shape}")
        scale = max(1.0, float(np.abs(ref.logits).max()))
        d_ref = float(np.abs(r.logits - ref.logits).max())
        d_nof = float(np.abs(r.logits - nof.logits).max())
        worst = max(worst, d_ref / scale)
        print(f"  req {i:2d} {r.model:32s} bucket {r.bucket} e2e "
              f"{r.e2e_ms:8.2f} ms run {r.run_ms:7.2f} ms  max|d ref| "
              f"{d_ref:.2e}  max|d nofused| {d_nof:.2e}  (scale {scale:.1f})")
        if d_ref > SERVE_RTOL * scale or d_nof > SERVE_RTOL * scale:
            raise SystemExit(f"request {i}: logits off the reference beyond "
                             f"{SERVE_RTOL} x {scale:.2f}")
    print(f"serve: worst max|d ref| / scale = {worst:.2e} "
          f"(tolerance {SERVE_RTOL})")
    # Control for the tolerance: the same round with TF32 allowed in cuDNN
    # and cuBLAS (the stem conv and the dense layers; the hand kernels stay
    # fp32) should land outside it.  Printed, not enforced.
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32, _ = serve(regs["cuda"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    worst_tf32 = max(float(np.abs(r.logits - ref.logits).max())
                     / max(1.0, float(np.abs(ref.logits).max()))
                     for r, ref in zip(tf32, reference))
    side = "outside" if worst_tf32 > SERVE_RTOL else "inside"
    print(f"serve control: with TF32 allowed, worst max|d ref| / scale = "
          f"{worst_tf32:.2e} ({side} the tolerance {SERVE_RTOL})")
    missing = [n for n, c in counts.items() if c == 0]
    if missing:
        raise SystemExit(f"kernels never launched while serving: {missing}")
    # The round is one bucket-8 batch per model, so each counter must read
    # the launches that weight the main-path sums above.
    for name, n in counts.items():
        report[name]["launches"] = n
        listed = report[name]["main_path"]["launches"]
        print(f"launches {name}: {n} while serving, {listed} in "
              f"zoo.kernel_launches at bucket {b} (one batch per model)")
        if n != listed:
            raise SystemExit(f"kernel {name}: {n} launches while serving, "
                             f"but the main-path sums weight {listed}")

    # -- 5. pipeline ---------------------------------------------------------
    pipe_counts, engines = pipeline_phase(regs["cuda"], keys, images,
                                          reference, serve, serve_s)
    for name in report:
        report[name]["pipeline_launches"] = {
            round_name: counts[name]
            for round_name, counts in pipe_counts.items()}
    try:
        if args.profile:
            shares = {
                "sync": profile_round(lambda: serve(regs["cuda"]),
                                      "sync round"),
                "pipelined": profile_round(
                    lambda: submit_round(engines["pipelined"], keys, images),
                    "pipelined round")}
            print(f"profile: device busy share, sync {shares['sync']:.1%}, "
                  f"pipelined {shares['pipelined']:.1%}")
    finally:
        for engine in engines.values():
            engine.close()
    if args.profile:
        # one launch per FuSe stage: no copy, pad or concat kernel around it
        for sh, row in stage_rows:
            n, names = device_kernels(shape_case("fuse1d", sh, randn)["run"])
            row["device_kernels"] = n
            par = (f" (parent: {row['parent_kernels']})"
                   if row.get("parent_kernels") is not None else "")
            print(f"profile: fuse1d stage {row['shape']}: {n} device kernel"
                  f"{'s' if n != 1 else ''} {names}{par}")
            if n != 1:
                raise SystemExit(f"fuse1d stage {row['shape']} ran {n} "
                                 f"device kernels, not one")
        n_fwd = forward_kernels(args.seed, dev)
        par = (f" (parent: {parent_runs[0]['forward_kernels']})"
               if parent_runs else "")
        print(f"profile: one fuse_half forward at bucket {b}: {n_fwd} device "
              f"kernels and copies{par}")

    # -- 6. zoo --------------------------------------------------------------
    zoo_counts = zoo_phase(args.seed)
    for name in report:
        report[name]["zoo_launches"] = zoo_counts[name]
    torch.cuda.empty_cache()

    # -- 7. restart ----------------------------------------------------------
    restart_phase([key for key, _, v in zoo_models() if isinstance(v, str)],
                  len(_build.SOURCES))

    # -- 8. train ------------------------------------------------------------
    train_counts = train_phase(args.seed)
    for name in report:
        report[name]["train_launches"] = train_counts[name]
    torch.cuda.empty_cache()

    # -- 9. lm ---------------------------------------------------------------
    lm = lm_phase(args.seed, card=card)
    torch.cuda.empty_cache()

    # -- 10. lm2 -------------------------------------------------------------
    lm2 = lm2_phase(args.seed, card=card)
    torch.cuda.empty_cache()

    # -- 11. moe -------------------------------------------------------------
    moe_phase(args.seed, card=card)
    torch.cuda.empty_cache()

    # -- 12. lm_train --------------------------------------------------------
    one_device = {}
    trained = lm_train_phase(args.seed, card=card, keep=one_device)
    torch.cuda.empty_cache()

    # -- 13. mesh ------------------------------------------------------------
    mesh_counts = mesh_phase(args.seed, card=card)
    for name in ("matmul", "fuse1d", "depthwise_kxk", "fuseconv_fused"):
        report[name]["mesh_launches"] = mesh_counts[name]
    torch.cuda.empty_cache()

    # -- 14. sharded ---------------------------------------------------------
    sharded = sharded_phase(args.seed, card=card)
    torch.cuda.empty_cache()

    # -- 15. mesh_train ------------------------------------------------------
    mesh_trained = mesh_train_phase(args.seed, card=card,
                                    one_device=one_device)
    torch.cuda.empty_cache()

    # the temporal form's rows: each (dtype, shape, form) at which phases 9,
    # 10, 12, 14 and 15 launched fuse1d (the cuda generates' prefills, the FuSe stem
    # calls), checked there and at T = 2 (< K - 1) against the plain
    # version, timed, with the launches counted at that shape
    paths = [(path, called_from, by_dtype.get(dtype, {}))
             for dtype in ("float32", "bfloat16")
             for path, called_from, by_dtype in (
                 (f"{LM_ARCH} prefill", "src/repro/kernels/ops.py:39", lm),
                 (f"{XLSTM_ARCH} prefill",
                  "src/repro/models/recurrent.py:220 (mLSTM), :321 (sLSTM)",
                  lm2["xlstm"]),
                 (f"{WHISPER_ARCH} FuSe stem", "src/repro/models/stems.py:52",
                  lm2["whisper"]),
                 (f"{LM_ARCH} trained, prefill",
                  "src/repro/kernels/ops.py:39", trained),
                 (f"{LM_ARCH} prefill under a sharding policy",
                  "src/repro/kernels/ops.py:39", sharded),
                 (f"{LM_ARCH} trained under a sharding policy, prefill",
                  "src/repro/kernels/ops.py:39", mesh_trained))]
    for path, called_from, by_shape in paths:
        for key, n in by_shape.items():
            sh = temporal_shape(key)
            dtype = sh["dtype"]
            rtol = KERNEL_RTOL if dtype == "float32" else BF16_STEP
            name = f"fuse1d (temporal, {dtype}, {path}, C {sh['c']})"
            case = shape_case("fuse1d", sh, randn)
            err = max(check("fuse1d", name, case, rtol),
                      check("fuse1d", f"{name} at T = 2", shape_case(
                          "fuse1d", dict(sh, b=3, t=2), randn), rtol))
            lib_err = (case["library"]().permute(0, 2, 1).float()
                       - case["plain"]().float()).abs().max().item()
            scale = max(1.0, case["plain"]().float().abs().max().item())
            if dtype == "float32" and lib_err > KERNEL_RTOL * scale:
                raise SystemExit(f"the library call for {name} disagrees "
                                 f"with the plain version: {lib_err:.3e}")
            row = measure(case, err)
            print(timed_line(name, row, case["library_name"])
                  + f"; max|library-plain| {lib_err:.3e}; {n} launches on "
                  f"the main path; {card}")
            report[name] = dict(
                name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/fuse1d.cu",
                replaces="src/repro/kernels/fuse1d.py:65", launches=n, **row,
                library=case["library_name"], timer_floor_ms=floor_ms,
                tolerance=rtol, library_max_abs_err=lib_err,
                called_from=called_from)
            del case

    print(card)
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
