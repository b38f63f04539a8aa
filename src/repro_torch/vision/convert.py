"""Parameter conversion between the JAX package's pytrees and the port.

``params_from_numpy`` takes a network's params as nested lists/dicts of
array-likes (numpy arrays, or anything ``np.asarray`` accepts) and returns
the same tree of float tensors on ``device``.  Layouts are kept as they
are — HWIO convs, (K, C) banks, (K, K, C) depthwise, (Cin, Cout) pointwise
and dense — so both packages compute the same function on the same
weights.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cuda"):
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
