"""Synthetic dataset generation for smoke tests and benchmarks.

Produces the on-disk contract the npz loader expects
({train,test}{A,B}.npz with key 'data'): domain A = random smooth "edge
maps", domain B = coloured blobs derived from A plus noise.  The same
numbers as the JAX package's ``data/synthetic.py`` for the same seed.

    python -m domain_transfer_gan_torch.data.synthetic OUT_DIR [N_TRAIN] [N_TEST]
"""

from __future__ import annotations

import os

import numpy as np


def _smooth_noise(rng, n, h, w, c, blur: int = 3):
    x = rng.randn(n, h, w, c).astype(np.float32)
    for _ in range(blur):
        x = (x + np.roll(x, 1, 1) + np.roll(x, -1, 1)
             + np.roll(x, 1, 2) + np.roll(x, -1, 2)) / 5.0
    return x


def make_synthetic_pair(n: int, size: int = 64, channels: int = 3,
                        seed: int = 0):
    rng = np.random.RandomState(seed)
    base = _smooth_noise(rng, n, size, size, 1, blur=4)
    edges = np.abs(np.gradient(base, axis=1)) + np.abs(np.gradient(base, axis=2))
    A = np.repeat(edges / (edges.max() + 1e-8), channels, axis=3)
    B = np.tanh(3 * base) * rng.uniform(0.5, 1.0, (n, 1, 1, channels))
    B = B + 0.05 * _smooth_noise(rng, n, size, size, channels, blur=2)
    return A.astype(np.float32), B.astype(np.float32)


def write_synthetic_dataset(root: str, n_train: int = 256, n_test: int = 64,
                            size: int = 64, channels: int = 3, seed: int = 0):
    """Write {train,test}{A,B}.npz bundles under ``root``."""
    os.makedirs(root, exist_ok=True)
    trA, trB = make_synthetic_pair(n_train, size, channels, seed)
    teA, teB = make_synthetic_pair(n_test, size, channels, seed + 1)
    np.savez(os.path.join(root, "trainA.npz"), data=trA)
    np.savez(os.path.join(root, "trainB.npz"), data=trB)
    np.savez(os.path.join(root, "testA.npz"), data=teA)
    np.savez(os.path.join(root, "testB.npz"), data=teB)
    return root


if __name__ == "__main__":
    import sys
    out = sys.argv[1] if len(sys.argv) > 1 else "./synthetic_data"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    n_test = int(sys.argv[3]) if len(sys.argv) > 3 else 64
    write_synthetic_dataset(out, n_train=n, n_test=n_test)
    print("wrote synthetic dataset to", out)
