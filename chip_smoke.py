#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--seed N] [--profile]

Phases (any failure exits non-zero, and no result line is printed):

1. card   — the card's name and power limit as nvidia-smi reports them;
2. build  — compile every kernel under src/repro_torch/kernels/csrc (one
            nvcc per source, in parallel); print build time and the
            ``-Xptxas -v`` register/shared-memory report;
3. kernels — each of the four kernels at its largest MobileNetV3-Large
            main-path shape (bucket 8) and at a ragged shape, against its
            plain PyTorch version on the card; then CUDA-event times of the
            kernel, the plain version and one PyTorch library call for the
            same function, beside the roofline bound from the shapes;
4. serve  — MobileNetV3-Large (224 px, width 1.0, 1000 classes, weights
            from the port's own seeded init) in ``fuse_half`` and
            ``depthwise``, 16 mixed-size requests through the synchronous
            engine on backend ``cuda``; the logits must match the
            ``torch`` backend and the ``cuda_nofused`` backend on the same
            card and weights, and every kernel's launch counter must have
            moved while serving.

``--profile`` adds one more served round under ``torch.profiler`` and
prints device time by kernel and the device's busy share of the round.
The last two lines are the ``kernels`` JSON line and the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32, CUDA cores
KERNEL_RTOL = 1e-4              # max|kernel - plain| <= 1e-4 * max(1, max|plain|)
SERVE_RTOL = 1e-5               # max|served - reference| <= 1e-5 * max(1, max|ref|)
L2_FLUSH_BYTES = 64 << 20       # larger than the H100's 50 MB L2
SPIN_CYCLES = 4_000_000         # ~2 ms at the H100's clock: longer than the
                                # host takes to enqueue any timed call


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


def profile_round(run) -> None:
    """Device time by kernel and the device's busy share over one round."""
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
    print(f"profile: round wall {wall_ms:.2f} ms (traced), device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}), {launches} device "
          f"kernels and copies")
    for e in rows[:20]:
        print(f"  {getattr(e, attr) / 1e3:9.3f} ms {e.count:5d}x  "
              f"{e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace one more served round with torch.profiler")
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1

    from repro_torch.kernels import _build, fuse1d as kf1, fused as kfu
    from repro_torch.kernels import matmul as kmm, ops as kops
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
    for info in infos.values():
        print(f"  {info.name}.cu: {info.seconds:.1f} s")
        for line in info.ptxas.splitlines():
            if re.search(r"Compiling entry|Used \d+ registers|spill", line):
                print("   ", line.strip())

    # -- 3. kernels ----------------------------------------------------------
    flush_buf = torch.empty(L2_FLUSH_BYTES // 4, device=dev)

    def time_ms(fn, iters=20, warmup=3) -> float:
        """Mean CUDA-event time of one call, L2 flushed before each.  A
        spin on the device after the flush lets the host enqueue the whole
        call before the start event is reached, so the events time the
        device work and not the host's launch latency."""
        for _ in range(warmup):
            fn()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        for s, e in zip(starts, ends):
            flush_buf.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters

    def same_pad_nchw(x_nhwc, kh, kw, stride):
        _, lo_h, hi_h = kfu.same_pad(x_nhwc.shape[1], kh, stride)
        _, lo_w, hi_w = kfu.same_pad(x_nhwc.shape[2], kw, stride)
        return F.pad(x_nhwc.permute(0, 3, 1, 2), (lo_w, hi_w, lo_h, hi_h))

    def fused_chain(x, wr, wc, wp, variant, stride, g, bb, act):
        """cuDNN row + column banks, concat, affine, act, cuBLAS mix."""
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
        ysp = kfu.ACTS[act](ysp * g + bb)
        return ysp.reshape(-1, ysp.shape[-1]) @ wp

    b = 8    # the serve phase's largest bucket
    cases = {}
    # matmul: the 16 -> 64 expand at 112x112 (largest M), and a ragged one
    a, w = randn(b * 112 * 112, 16), randn(16, 64, scale=0.25)
    cases["matmul"] = dict(
        run=lambda a=a, w=w: kmm.matmul(a, w),
        plain=lambda a=a, w=w: kmm.matmul_plain(a, w),
        library=lambda a=a, w=w: torch.matmul(a, w), library_name="torch.matmul",
        ragged=(lambda a=randn(1001, 37), w=randn(37, 75): (
            kmm.matmul(a, w), kmm.matmul_plain(a, w))),
        nbytes=4 * (a.numel() + w.numel() + a.shape[0] * w.shape[1]),
        flops=2 * a.shape[0] * a.shape[1] * w.shape[1],
        shape=f"a {tuple(a.shape)} @ b {tuple(w.shape)}",
        source="src/repro_torch/kernels/csrc/matmul.cu",
        replaces="src/repro/kernels/matmul.py:52")
    # fuse1d: rows of SE block 4 (exp 72 -> c_r 36, K=5, stride 2, 56x56
    # in), padded as kops.fuse_conv2d_rows pads it; and a ragged one
    _, lo, hi = kfu.same_pad(56, 5, 2)
    xp, w1 = randn(b * 56, 56 + lo + hi, 36), randn(5, 36, scale=0.5)
    t_out = xp.shape[1] - w1.shape[0] + 1
    x_ncl = xp.permute(0, 2, 1).contiguous()
    w_ncl = w1.t().reshape(36, 1, 5).contiguous()
    cases["fuse1d"] = dict(
        run=lambda: kf1.fuse1d(xp, w1),
        plain=lambda: kf1.fuse1d_plain(xp, w1),
        library=lambda: F.conv1d(x_ncl, w_ncl, groups=36),
        library_name="F.conv1d(groups=C) on (N, C, T+K-1)",
        ragged=(lambda x=randn(7, 15, 5), w=randn(3, 5): (
            kf1.fuse1d(x, w), kf1.fuse1d_plain(x, w))),
        nbytes=4 * (xp.numel() + w1.numel() + xp.shape[0] * t_out * 36),
        flops=2 * 5 * xp.shape[0] * t_out * 36,
        shape=f"x_pad {tuple(xp.shape)}, w {tuple(w1.shape)}",
        source="src/repro_torch/kernels/csrc/fuse1d.cu",
        replaces="src/repro/kernels/fuse1d.py:65")
    # depthwise_kxk: block 2 (64 ch, K=3, stride 2 at 112x112), ragged
    xd, wd = randn(b, 112, 112, 64), randn(3, 3, 64, scale=0.3)
    xd_pad = same_pad_nchw(xd, 3, 3, 2)
    wd_oihw = wd.permute(2, 0, 1).unsqueeze(1).contiguous()
    cases["depthwise_kxk"] = dict(
        run=lambda: kfu.depthwise_kxk(xd, wd, stride=2),
        plain=lambda: kfu.depthwise_kxk_plain(xd, wd, stride=2),
        library=lambda: F.conv2d(xd_pad, wd_oihw, stride=2, groups=64),
        library_name="F.conv2d(groups=C) on the padded input",
        ragged=(lambda x=randn(3, 13, 10, 37), w=randn(5, 5, 37): (
            kfu.depthwise_kxk(x, w, stride=2),
            kfu.depthwise_kxk_plain(x, w, stride=2))),
        nbytes=4 * (xd.numel() + wd.numel() + b * 56 * 56 * 64),
        flops=2 * 9 * b * 56 * 56 * 64,
        shape=f"x {tuple(xd.shape)}, w {tuple(wd.shape)}, stride 2",
        source="src/repro_torch/kernels/csrc/fused.cu",
        replaces="src/repro/kernels/fused.py:285")
    # fuseconv_fused: block 2 of the FuSe-Half model (exp 64, K=3, stride 2
    # at 112x112, project to 24, relu), and a ragged fuse_full/hswish one
    xf = randn(b, 112, 112, 64)
    wr, wc = randn(3, 32, scale=0.5), randn(3, 32, scale=0.5)
    wp, g, bb = randn(64, 24, scale=0.2), randn(64, scale=0.5), randn(64)
    fkw = dict(variant="fuse_half", stride=2, scale=g, bias=bb, act="relu")
    xr_ = randn(2, 13, 11, 37)
    rkw = dict(variant="fuse_full", stride=2, scale=randn(74), bias=randn(74),
               act="hswish")
    rw = (randn(5, 37, scale=0.5), randn(5, 37, scale=0.5), randn(74, 45))
    cases["fuseconv_fused"] = dict(
        run=lambda: kfu.fuseconv_fused(xf, wr, wc, wp, **fkw),
        plain=lambda: kfu.fuseconv_fused_plain(xf, wr, wc, wp, **fkw),
        library=lambda: fused_chain(xf, wr, wc, wp, "fuse_half", 2, g, bb,
                                    "relu"),
        library_name="chain: cuDNN conv2d(groups) x2 + cat + affine + act "
                     "+ cuBLAS matmul",
        ragged=lambda: (kfu.fuseconv_fused(xr_, *rw, **rkw),
                        kfu.fuseconv_fused_plain(xr_, *rw, **rkw)),
        nbytes=4 * (fuse_input_elems(b, 112, 112, 64, 3, 2, "fuse_half")
                    + wr.numel() + wc.numel() + 2 * 64 + wp.numel()
                    + b * 56 * 56 * 24),
        flops=b * 56 * 56 * (2 * 3 * 64 + 2 * 64 + 2 * 64 * 24),
        shape=f"x {tuple(xf.shape)}, fuse_half K=3 stride 2, "
              f"w_pw {tuple(wp.shape)}, relu",
        source="src/repro_torch/kernels/csrc/fused.cu",
        replaces="src/repro/kernels/fused.py:212")

    report = {}
    for name, cs in cases.items():
        got, ref = cs["run"](), cs["plain"]()
        rg, rr = cs["ragged"]()
        torch.cuda.synchronize()
        errs = []
        for label, x, y in (("largest", got, ref), ("ragged", rg, rr)):
            assert x.shape == y.shape, (name, label, x.shape, y.shape)
            err = (x - y).abs().max().item()
            tol = KERNEL_RTOL * max(1.0, y.abs().max().item())
            print(f"kernel {name} [{label}] max|kernel-plain| = {err:.3e} "
                  f"(tolerance {tol:.3e})")
            if not (err <= tol and torch.isfinite(x).all()):
                raise SystemExit(f"kernel {name} disagrees with its plain "
                                 f"version on the {label} shape")
            errs.append(err)
        ms, plain_ms = time_ms(cs["run"]), time_ms(cs["plain"])
        library_ms = time_ms(cs["library"])
        bound_ms, bound_by = bound(cs["nbytes"], cs["flops"])
        print(f"kernel {name} {cs['shape']}: {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, {cs['library_name']} {library_ms:.4f} ms,"
              f" bound {bound_ms:.4f} ms ({bound_by})")
        report[name] = dict(
            name=name, route="cuda", source=cs["source"],
            replaces=cs["replaces"], launches=None, max_abs_err=max(errs),
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, library=cs["library_name"],
            shape=cs["shape"])
    del cases, flush_buf
    torch.cuda.empty_cache()

    # -- 4. serve ------------------------------------------------------------
    net = zoo.mobilenet_v3_large()            # 224 px, width 1.0, 1000 cls
    variants = ("fuse_half", "depthwise")
    regs = {bk: ModelRegistry(backend=bk)
            for bk in ("cuda", "torch", "cuda_nofused")}
    for i, v in enumerate(variants):
        m = regs["cuda"].register(net, v, seed=args.seed + i)
        for bk in ("torch", "cuda_nofused"):
            regs[bk].register(net, v, params=m.params)
    keys = regs["cuda"].keys()
    images = [rng.standard_normal((int(rng.integers(160, 289)),
                                   int(rng.integers(160, 289)), 3)
                                  ).astype(np.float32) for _ in range(16)]

    def serve(reg):
        engine = VisionServeEngine(reg, buckets=(1, 2, 4, 8))
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
          f" batches {snap['batches']}, launches {counts}")
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
    for name, n in counts.items():
        report[name]["launches"] = n
    if args.profile:
        profile_round(lambda: serve(regs["cuda"]))

    print(card)
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
