"""Operator-level IR shared by the MAC/param counter and the systolic simulator.

Every vision network in ``repro.vision`` lowers to a flat ``list[OpSpec]``.
The same list drives:
  * ``repro.vision.counting``  -> Table-3 style MACs/params,
  * ``repro.systolic.simulator`` -> SCALE-Sim-FuSe style latency/utilization,
so the numbers in benchmarks are guaranteed to describe the same network.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

KINDS = (
    "conv",        # standard KxKxCinxCout
    "depthwise",   # KxK per channel
    "fuse_row",    # Kx1 per channel (vertical 1-D)
    "fuse_col",    # 1xK per channel (horizontal 1-D)
    "pointwise",   # 1x1 conv
    "dense",       # fully connected
    "se_reduce",   # SE squeeze FC (on pooled 1x1 features)
    "se_expand",   # SE excite FC
    "pool",        # global average pool (no MACs counted)
    "add",         # residual add (no MACs)
)


@dataclasses.dataclass(frozen=True)
class OpSpec:
    kind: str
    name: str
    in_h: int
    in_w: int
    in_c: int
    out_c: int
    kernel: int = 1
    stride: int = 1

    def __post_init__(self):
        assert self.kind in KINDS, self.kind

    # SAME padding output size.
    @property
    def out_h(self) -> int:
        if self.kind in ("dense", "se_reduce", "se_expand", "pool"):
            return 1
        return math.ceil(self.in_h / self.stride)

    @property
    def out_w(self) -> int:
        if self.kind in ("dense", "se_reduce", "se_expand", "pool"):
            return 1
        return math.ceil(self.in_w / self.stride)

    @property
    def macs(self) -> int:
        oh, ow = self.out_h, self.out_w
        k = self.kernel
        if self.kind == "conv":
            return oh * ow * self.out_c * k * k * self.in_c
        if self.kind == "depthwise":
            return oh * ow * self.in_c * k * k
        if self.kind in ("fuse_row", "fuse_col"):
            return oh * ow * self.in_c * k
        if self.kind == "pointwise":
            return oh * ow * self.in_c * self.out_c
        if self.kind in ("dense", "se_reduce", "se_expand"):
            return self.in_c * self.out_c
        return 0

    @property
    def params(self) -> int:
        k = self.kernel
        if self.kind == "conv":
            return k * k * self.in_c * self.out_c
        if self.kind == "depthwise":
            return k * k * self.in_c
        if self.kind in ("fuse_row", "fuse_col"):
            return k * self.in_c
        if self.kind == "pointwise":
            return self.in_c * self.out_c
        if self.kind in ("dense", "se_reduce", "se_expand"):
            return self.in_c * self.out_c + self.out_c  # + bias
        return 0

    @property
    def is_spatial_stage(self) -> bool:
        """True for the operator the paper replaces (depthwise <-> FuSe)."""
        return self.kind in ("depthwise", "fuse_row", "fuse_col")


def total_macs(ops: List[OpSpec]) -> int:
    return sum(op.macs for op in ops)


def total_params(ops: List[OpSpec]) -> int:
    return sum(op.params for op in ops)


def macs_by_kind(ops: List[OpSpec]) -> dict:
    out: dict = {}
    for op in ops:
        out[op.kind] = out.get(op.kind, 0) + op.macs
    return out
