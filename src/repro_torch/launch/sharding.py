"""Sharding policy: parameter / optimizer / batch / cache partition specs.

Port of ``repro.launch.sharding``.  Rules are (leaf-name, base-ndim)-keyed —
the leading stacked superblock axis of the segments is skipped
automatically.  Tensor-parallel axis is "model"; the batch shards over
("pod","data").

The reference annotates arrays with ``PartitionSpec``s and lets GSPMD
partition the program; the port does the same with DTensor
(``torch.distributed.tensor``) over a named ``DeviceMesh``
(``launch/mesh.py``):

* a spec is a :class:`PartitionSpec`, a tuple with one entry per leading
  tensor dim: ``None``, an axis name or a tuple of axis names, as
  ``jax.sharding.PartitionSpec``;
* :func:`placements` turns a spec into one ``Shard(dim)`` or
  ``Replicate()`` per mesh axis, and a :class:`NamedSharding` holds both;
* :func:`shard_tree` (``jax.device_put(tree, shardings)``) distributes
  each leaf, and ``act_constraint`` (``with_sharding_constraint``)
  redistributes a DTensor activation.

The policy reads only a leaf's ``.shape`` and ``.ndim`` and a mesh's axis
names and sizes (``launch.mesh.axis_names`` and ``axis_size``), so specs
come from meta tensors or shape stand-ins on a stand-in mesh as well.  The reference's quirks are
kept: ``cache_spec``'s stacked-axis test is 1 either way, and
``act_constraint`` shards the batch without checking that it divides.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from repro_torch import tree
from repro_torch.launch.mesh import axis_names, axis_size
from repro_torch.models.config import ArchConfig

PyTree = Any

# (name, base_ndim) -> spec for the trailing base dims.  "M" = model axis.
_RULES = {
    ("embed", 2): ("M", None),        # vocab sharded
    ("lm_head", 2): (None, "M"),
    ("wq", 2): (None, "M"), ("wk", 2): (None, "M"), ("wv", 2): (None, "M"),
    ("wo", 2): ("M", None),           # attn out & dense-FFN down
    ("wi", 2): (None, "M"), ("wg", 2): (None, "M"),
    ("wi", 3): ("M", None, None),     # MoE experts on model
    ("wg", 3): ("M", None, None),
    ("wo", 3): ("M", None, None),
    ("router", 2): (None, None),
    # MLA
    ("wdq", 2): (None, None), ("wuq", 2): (None, "M"),
    ("wdkv", 2): (None, None), ("wuk", 2): (None, "M"),
    ("wuv", 2): (None, "M"), ("wkr", 2): (None, None),
    # recurrent (RG-LRU)
    ("w_in", 2): (None, "M"), ("w_gate", 2): (None, "M"),
    ("w_out", 2): ("M", None), ("conv", 2): (None, "M"),
    ("wa", 3): ("M", None, None), ("wx", 3): ("M", None, None),
    ("lam", 1): ("M",),
    # xLSTM
    ("w_up", 2): (None, "M"), ("w_down", 2): ("M", None),
    ("w_if", 2): (None, None),
    ("w_gates", 2): (None, None), ("r_gates", 3): (None, None, None),
    ("ffn_wi", 2): (None, "M"), ("ffn_wg", 2): (None, "M"),
    ("ffn_wo", 2): ("M", None),
    ("vision_proj", 2): (None, "M"),
}

# decode-cache leaves
_CACHE_RULES = {
    "k": ("B", None, "KV", None),
    "v": ("B", None, "KV", None),
    "xk": ("B", None, "KV", None),
    "xv": ("B", None, "KV", None),
    "ckv": ("B", "M", None),          # MLA latent cache: sequence-sharded
    "kr": ("B", "M", None),
    "conv": ("B", None, "M"),
    "h": ("B", "M"),
    "c": ("B", None, None, "M"),
    "n": ("B", None, "M"),
    "m": ("B", None),
}


class PartitionSpec:
    """``P(*entries)``: one entry per leading tensor dim, each ``None``
    (replicated), an axis name, or a tuple of axis names (the dim split
    over several axes, major first); trailing dims left out replicate.
    Iterates, indexes and compares as the tuple of its entries; not a
    tuple itself, so the tree helpers take it for a leaf."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, (PartitionSpec, tuple)):
            return self._entries == tuple(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"P{self._entries!r}"


P = PartitionSpec


def placements(mesh, spec) -> Tuple:
    """``spec`` as DTensor placements on ``mesh``: ``Shard(dim)`` on each
    axis that ``spec`` names for tensor dim ``dim``, ``Replicate()`` on
    the others.  A dim split over several axes must name them in mesh
    order (DTensor shards the major axis first, as JAX does)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or any(out[i] != Replicate() for i in idx):
            raise ValueError(f"spec {spec!r} on mesh axes {names}: axes out "
                             f"of mesh order or used twice")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> Tuple:
        return placements(self.mesh, self.spec)


def shard_tree(params: PyTree, shardings: PyTree) -> PyTree:
    """Each leaf distributed as its ``NamedSharding`` says (the
    ``jax.device_put(tree, shardings)`` counterpart).  Every rank passes
    the same full leaf and keeps its own shard of it; nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    return tree.tree_map(
        lambda leaf, sh: distribute_tensor(leaf, sh.mesh, sh.placements,
                                           src_data_rank=None),
        params, shardings)


def _path_names(path) -> list:
    return [str(p) for p in path]


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """profile:
      'tp'     — tensor parallel on "model", batch on ("pod","data")  [default]
      'fsdp'   — batch over ALL axes; params sharded over "data" on their
                 largest divisible dim (weights all-gathered on demand) —
                 the right scheme for models too small to TP-shard
      'tp_seq' — tp + Megatron-style sequence-parallel residual stream
    """
    mesh: Any
    cfg: ArchConfig
    profile: str = "tp"
    # Head-alignment-aware attention sharding: only shard q/k/v/o
    # projections on "model" when the head count divides the axis —
    # otherwise the flat (D, heads*hd) shards straddle head boundaries and
    # every layer re-shards.  Misaligned KV caches shard along SEQUENCE
    # instead.  False reproduces the naive baseline.
    attn_align: bool = True
    # ZeRO-3-style 2-D weights: additionally shard each parameter over
    # "data" on its largest un-sharded divisible dim.
    zero3: bool = False

    @property
    def batch_axes(self):
        if self.profile == "fsdp":
            return axis_names(self.mesh)
        return tuple(a for a in axis_names(self.mesh) if a in ("pod", "data"))

    @property
    def model_size(self) -> int:
        return axis_size(self.mesh, "model")

    def _n_data(self) -> int:
        n = 1
        for a in self.batch_axes:
            n *= axis_size(self.mesh, a)
        return n

    def _resolve(self, spec_tuple, leading: int) -> PartitionSpec:
        spec = [None] * leading + [("model" if s == "M" else s)
                                   for s in spec_tuple]
        return P(*spec)

    # -- parameters -----------------------------------------------------------
    def param_spec(self, path, leaf) -> PartitionSpec:
        names = _path_names(path)
        name = names[-1]
        stacked = 1 if ("segments" in names or "encoder" in names) else 0
        base_nd = leaf.ndim - stacked
        if self.profile == "fsdp":
            # ZeRO-3 style: shard the largest divisible dim over "data"
            dsz = axis_size(self.mesh, "data")
            shape = leaf.shape[stacked:]
            best = None
            for i, dim in sorted(enumerate(shape), key=lambda t: -t[1]):
                if dim % dsz == 0:
                    best = i
                    break
            spec = [None] * leaf.ndim
            if best is not None and base_nd >= 1:
                spec[stacked + best] = "data"
            return P(*spec)
        rule = _RULES.get((name, base_nd))
        if rule is None:
            return P()                       # norms, gates, scalars: replicate
        if self.attn_align and base_nd == 2 and name in ("wq", "wk", "wv",
                                                         "wo"):
            # attention projections (vs dense-FFN wi/wg/wo, which never
            # reshape): require head-aligned shards
            if "attn" in names or "xattn" in names:
                heads = (self.cfg.num_kv_heads if name in ("wk", "wv")
                         else self.cfg.num_heads)
                if heads % self.model_size != 0:
                    return P(*([None] * leaf.ndim))
        # refuse to shard dims not divisible by the axis size
        shape = leaf.shape[stacked:]
        resolved = []
        for dim, s in zip(shape, rule):
            if s == "M" and dim % self.model_size != 0:
                resolved.append(None)
            else:
                resolved.append(s)
        spec = self._resolve(tuple(resolved), stacked)
        if self.zero3:
            spec = self._extend_over_data(spec, leaf)
        return spec

    def _extend_over_data(self, spec: PartitionSpec, leaf) -> PartitionSpec:
        dsz = axis_size(self.mesh, "data")
        parts = list(spec) + [None] * (leaf.ndim - len(spec))
        # largest unsharded, divisible dim gets "data"
        order = sorted(range(leaf.ndim), key=lambda i: -leaf.shape[i])
        for i in order:
            if parts[i] is None and leaf.shape[i] % dsz == 0 and \
                    leaf.shape[i] >= dsz:
                parts[i] = "data"
                break
        return P(*parts)

    def param_specs(self, params: PyTree) -> PyTree:
        return tree.tree_map_with_path(self.param_spec, params)

    def param_shardings(self, params: PyTree) -> PyTree:
        return tree.tree_map(lambda s: NamedSharding(self.mesh, s),
                             self.param_specs(params))

    # -- batches --------------------------------------------------------------
    def batch_spec(self, batch_size: int) -> PartitionSpec:
        """Spec for a (B, ...) leaf; replicates when B < #data shards."""
        if batch_size % self._n_data() != 0:
            return P()
        return P(self.batch_axes)

    def batch_specs(self, batch: PyTree) -> PyTree:
        def one(leaf):
            base = self.batch_spec(leaf.shape[0])
            return P(*(list(base) + [None] * (leaf.ndim - len(base))))
        return tree.tree_map(one, batch)

    # -- activations ----------------------------------------------------------
    def act_spec(self, x) -> PartitionSpec:
        """The residual stream's spec: batch over the data axes (+
        Megatron-style sequence sharding on "model" under ``tp_seq``)."""
        if self.profile == "tp_seq" and x.ndim >= 3 and \
                x.shape[1] % self.model_size == 0:
            return P(self.batch_axes, "model", *([None] * (x.ndim - 2)))
        return P(self.batch_axes, *([None] * (x.ndim - 1)))

    def act_constraint(self, x):
        """``x`` redistributed to :meth:`act_spec` (the
        ``with_sharding_constraint`` counterpart); an input that is not a
        DTensor comes back unchanged."""
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, placements(self.mesh,
                                                    self.act_spec(x)))

    # -- decode caches --------------------------------------------------------
    def cache_spec(self, path, leaf, batch_size: int) -> PartitionSpec:
        names = _path_names(path)
        name = names[-1]
        if name == "pos":
            return P()
        # the reference's test, 1 either way: every cache leaf is stacked
        stacked = 1 if any(n.isdigit() for n in names[:2]) else 1
        rule = _CACHE_RULES.get(name)
        if rule is None:
            return P()
        base = leaf.shape[stacked:]
        out = [None] * stacked
        n_data = self._n_data()
        for dim, s in zip(base, rule):
            if s == "B":
                out.append(self.batch_axes if dim % n_data == 0 else None)
            elif s in ("KV", "M"):
                out.append("model" if dim % self.model_size == 0 else None)
            else:
                out.append(None)
        if name in ("k", "v", "xk", "xv") and out[-2] is None:
            if self.attn_align:
                # misaligned KV heads: shard the SEQUENCE dim instead
                if base[-3] % self.model_size == 0:
                    out[-3] = "model"
            elif base[-1] % self.model_size == 0:
                out[-1] = "model"            # naive baseline: shard head_dim
        return P(*out)

    def cache_specs(self, cache: PyTree, batch_size: int) -> PyTree:
        return tree.tree_map_with_path(
            lambda p, leaf: self.cache_spec(p, leaf, batch_size), cache)

    def cache_shardings(self, cache: PyTree, batch_size: int) -> PyTree:
        return tree.tree_map(lambda s: NamedSharding(self.mesh, s),
                             self.cache_specs(cache, batch_size))
