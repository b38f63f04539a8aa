"""MACs / parameter counting — reproduces the paper's Table 3 quantities.

Port of ``repro.vision.counting`` (pure Python over the operator IR)."""
from __future__ import annotations

from typing import Dict

from repro_torch.core import layerir
from repro_torch.vision import zoo


def count(net: zoo.NetworkDef, variant="depthwise") -> Dict[str, float]:
    ops = zoo.lower_to_ir(net, variant)
    macs = layerir.total_macs(ops)
    params = layerir.total_params(ops)
    # + BatchNorm affine params (2 per channel of every conv output), as
    # counted by standard tools (and by Table 3, which matches torchvision).
    bn_params = 0
    for op in ops:
        if op.kind in ("conv", "depthwise", "fuse_row", "fuse_col", "pointwise"):
            bn_params += 2 * op.out_c
    return {
        "macs": macs,
        "params": params + bn_params,
        "macs_millions": macs / 1e6,
        "params_millions": (params + bn_params) / 1e6,
        "by_kind": layerir.macs_by_kind(ops),
    }


# Paper Table 3 reference values (millions), for validation in benchmarks.
PAPER_TABLE3 = {
    ("mobilenet_v1", "depthwise"): (589, 4.23),
    ("mobilenet_v1", "fuse_full"): (1122, 7.36),
    ("mobilenet_v1", "fuse_half"): (573, 4.20),
    ("mobilenet_v2", "depthwise"): (315, 3.50),
    ("mobilenet_v2", "fuse_full"): (430, 4.46),
    ("mobilenet_v2", "fuse_half"): (300, 3.46),
    ("mnasnet_b1", "depthwise"): (325, 4.38),
    ("mnasnet_b1", "fuse_full"): (440, 5.66),
    ("mnasnet_b1", "fuse_half"): (305, 4.25),
    ("mobilenet_v3_small", "depthwise"): (66, 2.93),
    ("mobilenet_v3_small", "fuse_full"): (84, 4.44),
    ("mobilenet_v3_small", "fuse_half"): (61, 2.89),
    ("mobilenet_v3_large", "depthwise"): (238, 5.47),
    ("mobilenet_v3_large", "fuse_full"): (322, 10.57),
    ("mobilenet_v3_large", "fuse_half"): (225, 5.40),
}
