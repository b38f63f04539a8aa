"""Analytic dataflow models for systolic arrays: OS, WS, and ST-OS.

SCALE-Sim is a trace-based cycle-accurate simulator; these are closed-form
models of the same quantities (cycles, PE utilization, SRAM/DRAM traffic),
keeping strict ``<= 1 MAC/PE/cycle`` physics.

Units: every latency in this module is accelerator **cycles** (convert to
accel-ms via ``SystolicConfig.cycles_to_ms``); traffic is bytes; never
host wall time.  Formulas:

Output-Stationary GEMM  (M x K) . (K x N) on an (R x C) array
    folds          = ceil(M/R) * ceil(N/C)
    useful MACs    = M * N * K
    skew="scalesim"  : cycles = folds * (K + 2R + C - 2)
                       (each fold: skewed fill R+C-2, K accumulates, drain R —
                        SCALE-Sim charges full skew per fold; paper-faithful)
    skew="pipelined" : cycles = folds * K + (R + C - 2) + min(R, C)
                       (double-buffered accumulators: consecutive folds
                        overlap fill/drain; skew paid once per GEMM)

Weight-Stationary GEMM
    folds          = ceil(K/R) * ceil(N/C)
    useful MACs    = M * N * K
    skew="scalesim"  : cycles = folds * (M + 2R + C - 2)
    skew="pipelined" : cycles = folds * M + (R + C - 2) + min(R, C)

Depthwise conv on OS/WS (the paper's §2 baseline): each channel is an
independent im2col GEMM with N = 1 — only ONE column of the array can be
used (no filter reuse, no channel-wise dot products), channels run
sequentially.  This is the formal source of the 5-6 % utilization.

ST-OS (Spatial-Tiled Output Stationary), the paper's §3.3 dataflow for
FuSeConv: the layer is a bank of ``P`` independent 1-D convolutions
(P = channels x perpendicular-spatial-extent), each producing ``L`` outputs
with K taps.  Each problem maps to one array ROW; the row's PEs hold L
consecutive outputs; the K weights are broadcast to the whole row over K
cycles while inputs shift laterally, so a fold of R problems x C outputs
completes in K cycles at steady state (inputs for the next fold are staged
through the co-existing vertical systolic links during the current fold's
K >= 3 compute cycles — this is what the per-row broadcast link buys).
    folds          = ceil(P/R) * ceil(L/C)
    cycles / fold  = K + switch             (switch: reg swap, default 1)
    fill (once)    = C + K - 1
    useful MACs    = P * L * K
Mapping policy changes SRAM port pressure, not cycles (paper §3.4):
  spatial-first   : 1 weight read/cycle (broadcast to rows sharing a filter)
  channels-first  : up to R distinct weight reads/cycle
  hybrid (default): min(distinct channels in fold, R) reads/cycle
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.layerir import OpSpec
from repro_torch.systolic.arrays import SystolicConfig


@dataclasses.dataclass
class LayerSim:
    name: str
    kind: str
    dataflow: str
    compute_cycles: float
    useful_macs: float
    ifmap_sram_bytes: float = 0.0
    weight_sram_bytes: float = 0.0
    ofmap_sram_bytes: float = 0.0
    dram_bytes: float = 0.0
    stall_cycles: float = 0.0

    @property
    def cycles(self) -> float:
        return self.compute_cycles + self.stall_cycles

    def utilization(self, cfg: SystolicConfig) -> float:
        if self.cycles <= 0:
            return 0.0
        return self.useful_macs / (cfg.pes * self.cycles)

    @property
    def sram_bytes(self) -> float:
        return self.ifmap_sram_bytes + self.weight_sram_bytes + self.ofmap_sram_bytes

    def avg_sram_bw(self) -> float:
        """bytes/cycle."""
        return self.sram_bytes / max(self.cycles, 1.0)

    def avg_dram_bw(self) -> float:
        return self.dram_bytes / max(self.cycles, 1.0)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# GEMM models.
# ---------------------------------------------------------------------------

def gemm_os(name: str, kind: str, m: int, k: int, n: int,
            cfg: SystolicConfig, repeats: int = 1) -> LayerSim:
    """``repeats`` independent GEMMs run back to back (e.g. dw channels)."""
    r, c = cfg.rows, cfg.cols
    folds = _ceil(m, r) * _ceil(n, c)
    if cfg.skew == "pipelined":
        cycles = repeats * folds * k + (r + c - 2) + min(r, c)
    else:
        cycles = repeats * folds * (k + 2 * r + c - 2)
    useful = repeats * m * n * k
    b = cfg.bytes_per_elem
    # Streaming reads: A is read once per vertical fold group, B once per
    # horizontal fold group; outputs written once.
    ifmap = repeats * m * k * _ceil(n, c) * b
    weight = repeats * k * n * _ceil(m, r) * b
    ofmap = repeats * m * n * b
    dram = repeats * (m * k + k * n + m * n) * b   # compulsory traffic
    return LayerSim(name, kind, "OS", cycles, useful, ifmap, weight, ofmap, dram)


def gemm_ws(name: str, kind: str, m: int, k: int, n: int,
            cfg: SystolicConfig, repeats: int = 1) -> LayerSim:
    r, c = cfg.rows, cfg.cols
    folds = _ceil(k, r) * _ceil(n, c)
    if cfg.skew == "pipelined":
        cycles = repeats * folds * m + (r + c - 2) + min(r, c)
    else:
        cycles = repeats * folds * (m + 2 * r + c - 2)
    useful = repeats * m * n * k
    b = cfg.bytes_per_elem
    ifmap = repeats * m * k * _ceil(n, c) * b
    weight = repeats * k * n * b
    # partial sums spill to the ofmap buffer once per K-fold
    ofmap = repeats * m * n * _ceil(k, r) * 2 * b
    dram = repeats * (m * k + k * n + m * n) * b
    return LayerSim(name, kind, "WS", cycles, useful, ifmap, weight, ofmap, dram)


# ---------------------------------------------------------------------------
# ST-OS model for banks of independent 1-D convolutions (FuSeConv).
# ---------------------------------------------------------------------------

def stos_fuse1d(name: str, kind: str, problems: int, out_len: int, k: int,
                channels: int, cfg: SystolicConfig,
                mapping: str = "hybrid") -> LayerSim:
    """``problems`` independent 1-D convs, each ``out_len`` outputs, K taps."""
    r, c = cfg.rows, cfg.cols
    folds = _ceil(problems, r) * _ceil(out_len, c)
    cycles = folds * (k + cfg.stos_switch_cycles)
    if cfg.stos_pipeline_fill:
        cycles += c + k - 1
    useful = problems * out_len * k
    b = cfg.bytes_per_elem
    # Every row streams its slice once: input elems = problems*(out_len+k-1)
    # per horizontal fold group (slices re-read if out_len spans >1 C-fold).
    ifmap = problems * (out_len + k - 1) * b
    if mapping == "spatial-first":
        weight_reads_per_fold = k                      # one broadcast stream
    elif mapping == "channels-first":
        weight_reads_per_fold = k * min(r, problems)   # distinct per row
    else:  # hybrid: distinct channels actually co-resident in a fold
        weight_reads_per_fold = k * min(r, channels, problems)
    weight = folds * weight_reads_per_fold * b
    ofmap = problems * out_len * b
    dram = (problems * (out_len + k - 1) + channels * k + problems * out_len) * b
    return LayerSim(name, kind, "ST-OS", cycles, useful, ifmap, weight, ofmap,
                    dram)


# ---------------------------------------------------------------------------
# Lowering an OpSpec to a dataflow invocation.
# ---------------------------------------------------------------------------

def simulate_op(op: OpSpec, cfg: SystolicConfig, *, dataflow: str = "OS",
                stos_mapping: str = "hybrid",
                batch: int = 1) -> Optional[LayerSim]:
    m_px = op.out_h * op.out_w * batch
    gemm = gemm_ws if dataflow == "WS" else gemm_os
    if op.kind == "conv":
        return gemm(op.name, op.kind, m_px, op.kernel * op.kernel * op.in_c,
                    op.out_c, cfg)
    if op.kind == "pointwise":
        return gemm(op.name, op.kind, m_px, op.in_c, op.out_c, cfg)
    if op.kind == "depthwise":
        # im2col per channel, N=1: single-column GEMMs, sequential channels.
        return gemm(op.name, op.kind, m_px, op.kernel * op.kernel, 1, cfg,
                    repeats=op.in_c)
    if op.kind in ("fuse_row", "fuse_col"):
        if dataflow == "ST-OS":
            # independent problems: channel x perpendicular spatial extent
            perp = op.out_w if op.kind == "fuse_row" else op.out_h
            out_len = op.out_h if op.kind == "fuse_row" else op.out_w
            return stos_fuse1d(op.name, op.kind, op.in_c * perp * batch,
                               out_len, op.kernel, op.in_c, cfg, stos_mapping)
        # Without ST-OS support, FuSe 1-D convs fall back to the same
        # single-column im2col fate as depthwise (K taps instead of K^2).
        return gemm(op.name, op.kind, m_px, op.kernel, 1, cfg,
                    repeats=op.in_c)
    if op.kind in ("dense", "se_reduce", "se_expand"):
        return gemm(op.name, op.kind, batch, op.in_c, op.out_c, cfg)
    if op.kind in ("pool", "add"):
        return None  # negligible, handled by the vector periphery
    raise ValueError(op.kind)


def simulate_fused_block(row_op: OpSpec, col_op: OpSpec, pw_op: OpSpec,
                         cfg: SystolicConfig, *, stos_mapping: str = "hybrid",
                         batch: int = 1) -> LayerSim:
    """Price a fused FuSeConv block (row bank + col bank + pointwise mix).

    Fusion is a memory-system optimization, not a compute one: the array
    still executes every MAC of the three constituent ops, so compute
    cycles, useful MACs, and SRAM traffic are exactly the sums of the
    decomposed parts (ST-OS for the 1-D banks, OS for the mix) and the
    serving cost model needs no new calibration keys.  What fusion removes
    is the HBM round-trip of the spatial intermediate: the decomposed
    pipeline writes the ``c_sp``-channel spatial ofmap to DRAM and reads it
    back as the pointwise ifmap; fused, it never leaves the chip — DRAM
    traffic drops by 2 x intermediate-size.  Pinned against golden cycle
    counts in tests/test_systolic.py.
    """
    assert pw_op.in_c == row_op.out_c + col_op.out_c, \
        (pw_op.in_c, row_op.out_c, col_op.out_c)
    parts = [simulate_op(row_op, cfg, dataflow="ST-OS",
                         stos_mapping=stos_mapping, batch=batch),
             simulate_op(col_op, cfg, dataflow="ST-OS",
                         stos_mapping=stos_mapping, batch=batch),
             simulate_op(pw_op, cfg, dataflow="OS", batch=batch)]
    intermediate = pw_op.out_h * pw_op.out_w * batch * pw_op.in_c
    saved = 2 * intermediate * cfg.bytes_per_elem
    return LayerSim(
        name=pw_op.name + "/fused", kind="fuse_block", dataflow="ST-OS+OS",
        compute_cycles=sum(p.compute_cycles for p in parts),
        useful_macs=sum(p.useful_macs for p in parts),
        ifmap_sram_bytes=sum(p.ifmap_sram_bytes for p in parts),
        weight_sram_bytes=sum(p.weight_sram_bytes for p in parts),
        ofmap_sram_bytes=sum(p.ofmap_sram_bytes for p in parts),
        dram_bytes=sum(p.dram_bytes for p in parts) - saved,
        stall_cycles=sum(p.stall_cycles for p in parts))
