"""Shared inputs for the port's parity tests: one parameter tree, fed to
both packages.

The tree has the structure and shapes of ``repro.vision.zoo.init_network``
(read with ``jax.eval_shape``, so no random kernels are compiled) and
numpy values from a seed: He-normal weights (fan-in = product of all but
the last axis, which covers HWIO, (K, C), (K, K, C) and (Cin, Cout)) and
non-trivial BatchNorm statistics, so the BN folding is exercised too.
"""
import functools

import jax
import numpy as np

from repro.vision import zoo as jzoo


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
