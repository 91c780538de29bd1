"""Shared helpers of the tests/test_torch_port_*.py files: numpy-seeded
inputs and weights handed to both the JAX package and the PyTorch port."""

import numpy as np

import jax


def np_tree(tree):
    """A flax params tree as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def randomize(params, seed):
    """Replace every leaf of a params tree by O(1)-scale values drawn with
    numpy from ``seed``: kernels ~ N(0, 1/fan_in), norm scales around 1,
    biases and shifts ~ N(0, 0.1).  (The 'reference' init draws the
    InstanceNorm scale ~ N(0, 0.02), which shrinks every output toward zero
    and would hide real errors behind an absolute tolerance.)"""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:  # bias, shift
            v = 0.1 * rng.randn(*shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, np_tree(params))


def images(seed, n, hw=64, c=3):
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, hw, hw, c)).astype(np.float32)


def latents(seed, n, nlatent):
    return np.random.RandomState(seed).randn(n, nlatent).astype(np.float32)
