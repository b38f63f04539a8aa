"""LM parameters between the JAX package's numpy tree and the port.

The port keeps the reference's tree (``embed``, ``final_norm``, optional
``lm_head``, ``segments``: per segment a dict ``k<i>`` of layer dicts whose
leaves are stacked on a leading superblock axis; an encoder-decoder's
``encoder``, one ``enc`` layer dict stacked over the encoder layers, and
``enc_norm``; a VLM's ``vision_proj``), with every layout as the reference
has it (the sLSTM's ``r_gates`` as (blocks, bw, bw), a cross layer's tanh
gates as one scalar per superblock), so conversion is leaf by leaf through
``repro_torch.vision.convert``.  A bfloat16 JAX array becomes
an ``ml_dtypes.bfloat16`` numpy array, which ``torch.from_numpy`` refuses:
such leaves go through float32, which holds every bfloat16 value exactly,
in both directions.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.vision import convert as vconvert


def _is_bf16(a) -> bool:
    return getattr(getattr(a, "dtype", None), "name", None) == "bfloat16"


def params_from_numpy(tree, device="cuda"):
    """A tree of array-likes (numpy, or JAX arrays) as tensors on
    ``device``, bfloat16 leaves kept bfloat16."""
    def leaf(a):
        a = np.asarray(a)
        if _is_bf16(a):
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return vconvert.params_from_numpy(a, device)
    return tree_lib.tree_map(leaf, tree)


def params_to_numpy(tree):
    """The tree of ``params_from_numpy`` back as numpy arrays on the host;
    bfloat16 leaves as ``ml_dtypes.bfloat16`` arrays."""
    def leaf(t):
        if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.detach().float().cpu().numpy().astype(ml_dtypes.bfloat16)
        return vconvert.params_to_numpy(t)
    return tree_lib.tree_map(leaf, tree)
