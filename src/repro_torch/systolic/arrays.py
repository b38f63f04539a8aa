"""Systolic-array hardware configuration (paper Table 1 defaults).

Units: dimensions are PEs, SRAM sizes are KiB, ``freq_ghz`` is the array
clock in GHz, bandwidth is bytes per accelerator **cycle**.
``cycles_to_ms`` converts cycles to **accelerator milliseconds** (accel-ms)
— simulated time on this array, never host wall time.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SystolicConfig:
    rows: int = 16
    cols: int = 16
    freq_ghz: float = 1.0
    ifmap_sram_kb: int = 64
    weight_sram_kb: int = 64
    ofmap_sram_kb: int = 64
    bytes_per_elem: int = 1          # int8 edge inference
    dram_bw_bytes_per_cycle: float = 16.0
    # Fold timing model (see dataflow.py):
    #   "scalesim"  — every fold pays full skew fill + drain (SCALE-Sim
    #                 semantics; paper-faithful baseline).
    #   "pipelined" — double-buffered accumulators overlap consecutive
    #                 folds; skew is paid once per GEMM (beyond-paper HW).
    skew: str = "scalesim"
    # ST-OS micro-architecture knobs (see dataflow.py docstrings):
    stos_switch_cycles: int = 0      # per-fold problem-switch penalty
    stos_pipeline_fill: bool = True  # charge one (cols + K - 1) fill per layer

    @property
    def pes(self) -> int:
        return self.rows * self.cols

    def cycles_to_ms(self, cycles: float) -> float:
        return cycles / (self.freq_ghz * 1e9) * 1e3


PAPER_CONFIG = SystolicConfig()


# Paper Table 2 (measured at 22 nm, Synopsys DC) — ST-OS support overheads.
PAPER_TABLE2 = {
    8: (3.0, 6.2),
    16: (3.2, 6.7),
    32: (4.5, 6.4),
    64: (5.2, 9.2),
}


def stos_overhead_model(size: int) -> tuple:
    """Analytic stand-in for Table 2 (no VLSI flow in this container).

    The broadcast link adds, per row: a wire spanning ``cols`` PEs, a driver
    sized ~log(cols), and a 2:1 operand mux per PE.  Relative to the PE
    array (area ~ rows*cols) the wire+mux term is ~constant per PE and the
    driver term grows ~log(cols), giving overhead(S) = a + b*log2(S/8).
    Coefficients are least-squares fit to the paper's four measured points.
    """
    import math
    l = math.log2(size / 8)
    area = 3.025 + 0.7875 * l       # fit of (3.0, 3.2, 4.5, 5.2)
    power = 5.95 + 0.8875 * l       # fit of (6.2, 6.7, 6.4, 9.2)
    return area, power
