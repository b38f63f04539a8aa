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
            serves identical logits (``logits_sha256``).

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
import gc
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
    """Phase 6: the 20 models of ``zoo_models`` on three registries
    (``cuda``, ``torch``, ``cuda_nofused``) with the same seeded weights,
    one bucket-8 batch of mixed-size images per model through the sync
    engine (``pipelined=False``: a fixed batch composition, so exact
    launch counts).  Every request ``ok``; ``cuda`` and ``cuda_nofused``
    logits within ``SERVE_RTOL`` of ``torch``; every kernel's counter
    moved by exactly the sum of ``zoo.kernel_launches`` over the models.
    Returns the counts."""
    import numpy as np
    from repro_torch.kernels import ops as kops
    from repro_torch.serving.vision import ModelRegistry, VisionServeEngine
    from repro_torch.vision import zoo
    t_phase = time.perf_counter()
    models = zoo_models(nets)
    regs = {bk: ModelRegistry(backend=bk, device=device)
            for bk in ("cuda", "torch", "cuda_nofused")}
    for i, (key, net, v) in enumerate(models):
        m = regs["cuda"].register(net, v, key=key, seed=seed + i)
        for bk in ("torch", "cuda_nofused"):
            regs[bk].register(net, v, key=key, params=m.params)
    img_rng = np.random.default_rng((seed, 6))
    items = []
    for _ in range(8):
        for key, net, _v in models:
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
    worst = check_served("zoo cuda", served, reference)
    worst_nof = check_served("zoo cuda_nofused", nofused, reference)
    if snap["batches"] != len(models) or {r.bucket for r in served} != {8}:
        raise SystemExit(f"zoo: {snap['batches']} batches over buckets "
                         f"{sorted({r.bucket for r in served})}, not one "
                         f"bucket-8 batch per model")
    expected = collections.Counter(
        name for _, net, v in models
        for name, _ in zoo.kernel_launches(net, v, 8))
    print(f"zoo: {len(models)} models, {len(items)} requests in "
          f"{wall_s * 1e3:.1f} ms through the sync engine, worst max|d "
          f"torch| / scale {worst:.2e} (cuda_nofused {worst_nof:.2e}, "
          f"tolerance {SERVE_RTOL}), launches {counts}")
    for name in sorted(expected):
        print(f"zoo launches {name}: {counts.get(name, 0)} while serving, "
              f"{expected[name]} in zoo.kernel_launches over the models")
    if dict(counts) != dict(expected):
        raise SystemExit(f"zoo: launch counts {counts} are not the "
                         f"{dict(expected)} that zoo.kernel_launches lists")
    run_ms = {}
    for r in served:
        run_ms.setdefault(r.model, r.run_ms)
    for key, ms in run_ms.items():
        print(f"  zoo batch {key:34s} bucket 8: {ms:8.2f} ms")
    print(f"zoo: phase wall {time.perf_counter() - t_phase:.1f} s")
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

    print(card)
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
