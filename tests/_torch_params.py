"""Shared inputs for the port's parity tests: one parameter tree, fed to
both packages.

``numpy_params``: the tree has the structure and shapes of
``repro.vision.zoo.init_network`` (read with ``jax.eval_shape``, so no
random kernels are compiled) and numpy values from a seed: He-normal
weights (fan-in = product of all but the last axis, which covers HWIO,
(K, C), (K, K, C) and (Cin, Cout)) and non-trivial BatchNorm statistics,
so the BN folding is exercised too.

``numpy_lm_params``: the same for ``repro.models.model.LanguageModel``.
"""
import functools

import jax
import numpy as np

from repro.models import model as jmodel
from repro.vision import zoo as jzoo

NORMS = ("ln", "ln1", "ln2", "ln3", "norm", "final_norm", "enc_norm",
         "q_norm", "kv_norm")


def numpy_params(net, variant, seed=0):
    shapes = jax.eval_shape(
        lambda: jzoo.init_network(jax.random.PRNGKey(0), net, variant))
    rng = np.random.default_rng(seed)

    def fill(tree, name=""):
        if isinstance(tree, dict):
            return {k: fill(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(fill(v) for v in tree)
        shape = tuple(tree.shape)
        n = rng.standard_normal(shape)
        if len(shape) > 1:
            v = n * np.sqrt(2.0 / np.prod(shape[:-1]))
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = 1.0 + 0.1 * n
        else:                                # bias, mean, dense bias
            v = 0.1 * n
        return np.asarray(v, np.float32)

    return fill(shapes)


@functools.lru_cache(maxsize=None)
def _jitted_apply(net, variant):
    return jax.jit(lambda p, x: jzoo.apply_network(p, net, x, variant,
                                                   backend="xla")[0])


def jax_logits(params, net, x, variant):
    """The JAX reference (backend ``xla``), jitted once per (net, variant)
    to keep compile time down."""
    return np.asarray(_jitted_apply(net, variant)(params, x))


def numpy_lm_params(cfg, seed=0):
    """Seeded numpy values in the LM reference tree: stacked matrices
    scaled by 1/sqrt(fan-in), ``embed`` and ``vision_proj`` by
    1/sqrt(d_model), norm scales 0.1 * N(0, 1) (so ``1 + scale`` is
    exercised), ``lam`` uniform in [0.5, 4], temporal conv taps
    0.5 * N(0, 1), and the cross layers' tanh gates 0.5 * N(0, 1) (the
    init's zeros would make a cross layer the identity)."""
    shapes = jax.eval_shape(
        lambda: jmodel.LanguageModel(cfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        shape = tuple(leaf.shape)
        name = str(path[-1].key) if hasattr(path[-1], "key") else ""
        if name == "lam":
            v = rng.uniform(0.5, 4.0, shape)
        elif name in ("conv", "gate_attn", "gate_ffn"):
            v = rng.standard_normal(shape) * 0.5
        elif name in NORMS:
            v = 0.1 * rng.standard_normal(shape)
        elif name in ("embed", "vision_proj"):
            v = rng.standard_normal(shape) / np.sqrt(shape[-1])
        else:       # (superblocks, fan-in..., fan-out)
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:-1]))
        return np.asarray(v, np.float32).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)
