"""Network-level systolic simulation (SCALE-Sim-FuSe analogue).

Given a vision network lowered to operator IR, simulates every op under a
chosen dataflow policy and aggregates latency / utilization / bandwidth.
Policy (paper §3.3): runtime-configurable dataflow — ST-OS for FuSe 1-D
convs, OS (or WS) for everything else.  DRAM bandwidth stalls are modeled
per layer: stall = max(0, dram_bytes / BW - compute_cycles).

Units: everything here is counted in accelerator **cycles** on the
configured array; ``NetworkSim.latency_ms`` converts cycles to
**accelerator milliseconds** (accel-ms) at ``SystolicConfig.freq_ghz`` —
the paper machine's clock, NOT host wall time.  The serving stack's
``LatencyCalibrator`` (repro.serving.vision.calibrate) owns the accel-ms
-> wall-ms conversion; nothing in this package ever returns wall-ms.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.layerir import OpSpec
from repro_torch.systolic.arrays import SystolicConfig, PAPER_CONFIG
from repro_torch.systolic import dataflow as df


@dataclasses.dataclass
class NetworkSim:
    name: str
    layers: List[df.LayerSim]
    cfg: SystolicConfig

    @property
    def cycles(self) -> float:
        return sum(l.cycles for l in self.layers)

    @property
    def latency_ms(self) -> float:
        return self.cfg.cycles_to_ms(self.cycles)

    @property
    def useful_macs(self) -> float:
        return sum(l.useful_macs for l in self.layers)

    @property
    def utilization(self) -> float:
        return self.useful_macs / (self.cfg.pes * max(self.cycles, 1.0))

    def cycles_by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for l in self.layers:
            key = ("fuse" if l.kind in ("fuse_row", "fuse_col") else l.kind)
            out[key] = out.get(key, 0.0) + l.cycles
        return out

    def macs_by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for l in self.layers:
            key = ("fuse" if l.kind in ("fuse_row", "fuse_col") else l.kind)
            out[key] = out.get(key, 0.0) + l.useful_macs
        return out


def simulate_network(ops: Sequence[OpSpec], cfg: SystolicConfig = PAPER_CONFIG,
                     *, baseline_dataflow: str = "OS",
                     stos: bool = True, stos_mapping: str = "hybrid",
                     batch: int = 1, name: str = "net") -> NetworkSim:
    """``stos=True`` runs FuSe 1-D ops on ST-OS; otherwise they share the
    baseline dataflow (used for the ablation in Fig 9b)."""
    sims: List[df.LayerSim] = []
    for op in ops:
        flow = ("ST-OS" if stos and op.kind in ("fuse_row", "fuse_col")
                else baseline_dataflow)
        sim = df.simulate_op(op, cfg, dataflow=flow, stos_mapping=stos_mapping,
                             batch=batch)
        if sim is None:
            continue
        dram_cycles = sim.dram_bytes / cfg.dram_bw_bytes_per_cycle
        sim.stall_cycles = max(0.0, dram_cycles - sim.compute_cycles)
        sims.append(sim)
    return NetworkSim(name, sims, cfg)


# ---------------------------------------------------------------------------
# Mobile-bottleneck grouping (paper Fig 10): a bottleneck layer is the
# spatial stage plus its adjacent pointwise convs within one block (names
# share the same "b<i>" prefix).
# ---------------------------------------------------------------------------

def bottleneck_utilizations(sim: NetworkSim) -> List[Dict]:
    groups: Dict[str, List[df.LayerSim]] = {}
    order: List[str] = []
    for l in sim.layers:
        prefix = l.name.split("/")[0]
        if prefix not in groups:
            groups[prefix] = []
            order.append(prefix)
        groups[prefix].append(l)
    out = []
    for prefix in order:
        ls = groups[prefix]
        if not any(l.kind in ("depthwise", "fuse_row", "fuse_col") for l in ls):
            continue  # not a separable bottleneck block
        cyc = sum(l.cycles for l in ls)
        useful = sum(l.useful_macs for l in ls)
        out.append({
            "block": prefix,
            "cycles": cyc,
            "utilization": useful / (sim.cfg.pes * max(cyc, 1.0)),
        })
    return out


def layerwise_speedup(base: NetworkSim, fuse: NetworkSim) -> List[Dict]:
    """Per-bottleneck-block speedups (paper Fig 8b)."""
    b = {d["block"]: d for d in bottleneck_utilizations(base)}
    f = {d["block"]: d for d in bottleneck_utilizations(fuse)}
    out = []
    for k in b:
        if k in f:
            out.append({"block": k, "speedup": b[k]["cycles"] / f[k]["cycles"]})
    return out
