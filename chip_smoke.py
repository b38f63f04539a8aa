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
            launch); its 1-D form is checked and timed beside it.  Then the
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
            moved while serving.

``--profile`` adds one more served round under ``torch.profiler`` and
prints device time by kernel and the device's busy share of the round;
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
        for s, e in zip(starts, ends):
            flush_buf.zero_()
            torch.cuda._sleep(spin)
            s.record()
            fn()
            e.record()
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
    ap.add_argument("--parent", metavar="DIR",
                    help="also time the kernels of the tree at DIR")
    ap.add_argument("--time-only", nargs=2, metavar=("SHAPES", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--src", help=argparse.SUPPRESS)
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
    net = zoo.mobilenet_v3_large()                # 224 px, width 1.0
    variants = ("fuse_half", "depthwise")
    shape_counts = collections.Counter(
        (name, json.dumps(sh, sort_keys=True))
        for v in variants for name, sh in zoo.kernel_launches(net, v, b))
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

    def check(name, label, case) -> float:
        """max|kernel - plain|, failing beyond the tolerance or when a
        second call on the same input is not bitwise equal."""
        got, again, ref = case["run"](), case["run"](), case["plain"]()
        torch.cuda.synchronize()
        assert got.shape == ref.shape, (name, label, got.shape, ref.shape)
        err = (got - ref).abs().max().item()
        tol = KERNEL_RTOL * max(1.0, ref.abs().max().item())
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
    # every distinct main-path shape at bucket 8, checked and timed
    # notes printed beside a row but kept out of the kernels line, whose
    # numbers are all measured (or, for bound_ms, computed from the inputs):
    # the SGEMM's tiling and the stage kernel's grid (one thread per 4-channel
    # output vector, 256 a block; every main-path stage takes VEC = 4)
    path_rows, stage_rows, notes = [], [], {}
    for name, sh, n in path_shapes:
        case = shape_case(name, sh, randn)
        label = json.dumps(sh)
        row = dict(measure(case, check(name, label, case)), launches=n)
        if name == "matmul":
            til = matmul_tiling(sh["m"], sh["k"], sh["n"])
            notes[id(row)] = (
                f", tile {til['bm']}x{til['bn']} bk {til['bk']} tm "
                f"{til['tm']} ring {til['stages']} split {til['ks']}, "
                f"{til['blocks']} blocks")
        if is_stage(name, sh):
            check_library(label, case, sh)
            st = sh["stride"]
            outs = (sh["b"] * -(-sh["h"] // st) * -(-sh["w"] // st) * sh["c"]
                    * (2 if sh["variant"] == "fuse_full" else 1))
            notes[id(row)] = f", {-(-outs // (4 * 256))} blocks"
            stage_rows.append((sh, row))
        report[name]["shapes"].append(row)
        path_rows.append(row)
        del case
        torch.cuda.empty_cache()
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
    if args.profile:
        profile_round(lambda: serve(regs["cuda"]))
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

    print(card)
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
