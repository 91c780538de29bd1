"""Synthetic dataset generation for smoke tests and benchmarks.

Produces the on-disk contract the npz loader expects
({train,test}{A,B}.npz with key 'data'): domain A = random smooth "edge
maps", domain B = coloured blobs derived from A plus noise; a Livneh-shaped
variant (4 forcing channels -> 1 SWE channel, with a shared NaN ocean mask);
and the per-sample file layout the per-file loader reads
({train,test}{A,B}/NNNNN.npz).  The same numbers as the JAX package's
``data/synthetic.py`` for the same seed.

    python -m domain_transfer_gan_torch.data.synthetic OUT_DIR [N_TRAIN] [N_TEST] [perfile]
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


def make_synthetic_livneh_pair(n: int, size: int = 64, seed: int = 0,
                               nan_frac: float = 0.08):
    """Livneh-shaped raster pair (the fork's science configuration).

    Domain A mimics the 4-channel atmospheric forcings the reference's
    notebook stacks (prec/tmin/tmax/wind, Livneh cells 6-16) — the loader
    then caps A to its first 3 channels exactly like reference
    dataloader.py:17.  Domain B is a single SWE-like channel physically
    tied to A (snow where cold and wet).  Both domains carry a shared
    smooth NaN mask (ocean/missing cells) that the loader's NaN->0 scrub
    must absorb (reference dataloader.py:19-24 semantics).
    """
    rng = np.random.RandomState(seed)
    terrain = _smooth_noise(rng, n, size, size, 1, blur=4)
    prec = np.abs(_smooth_noise(rng, n, size, size, 1, blur=3))
    tmin = terrain + 0.3 * _smooth_noise(rng, n, size, size, 1, blur=2)
    tmax = tmin + 0.5 * np.abs(_smooth_noise(rng, n, size, size, 1, blur=2))
    wind = _smooth_noise(rng, n, size, size, 1, blur=2)
    A = np.concatenate([prec, tmin, tmax, wind], axis=3).astype(np.float32)
    swe = np.clip(prec * (0.4 - tmin), 0.0, None)
    B = np.tanh(2.0 * swe).astype(np.float32)
    # shared smooth "ocean" mask -> NaN speckle in every channel of both
    # domains (the same cells are missing in every variable of a raster)
    mask_field = _smooth_noise(rng, n, size, size, 1, blur=4)
    thresh = np.quantile(mask_field.reshape(n, -1), 1.0 - nan_frac, axis=1)
    mask = mask_field > thresh[:, None, None, None]
    A[np.broadcast_to(mask, A.shape)] = np.nan
    B[np.broadcast_to(mask, B.shape)] = np.nan
    return A, B


def write_synthetic_livneh_dataset(root: str, n_train: int = 256,
                                   n_test: int = 64, size: int = 64,
                                   seed: int = 0):
    """Write Livneh-shaped {train,test}{A,B}.npz bundles (A: 4ch + NaN,
    B: 1ch + NaN) under `root` for the --input_nc 3 --output_nc 1 arm."""
    os.makedirs(root, exist_ok=True)
    trA, trB = make_synthetic_livneh_pair(n_train, size, seed)
    teA, teB = make_synthetic_livneh_pair(n_test, size, seed + 1)
    np.savez(os.path.join(root, "trainA.npz"), data=trA)
    np.savez(os.path.join(root, "trainB.npz"), data=trB)
    np.savez(os.path.join(root, "testA.npz"), data=teA)
    np.savez(os.path.join(root, "testB.npz"), data=teB)
    return root


def write_synthetic_perfile_dataset(root: str, n_train: int = 32,
                                    n_test: int = 8, size: int = 64,
                                    channels: int = 3, seed: int = 0):
    """Write per-sample .npz files under {trainA,trainB,testA,testB}/.

    Values are stored in [0, 1]: the per-file loader's default_transform
    maps floats with ToTensor semantics ((x - .5)/.5 -> [-1, 1]), so
    storing B's native ~[-1, 1] range would land 'real' B in ~[-3, 1],
    outside the generator's tanh output range."""
    trA, trB = make_synthetic_pair(n_train, size, channels, seed)
    teA, teB = make_synthetic_pair(n_test, size, channels, seed + 1)
    trB = np.clip((trB + 1.0) / 2.0, 0.0, 1.0)
    teB = np.clip((teB + 1.0) / 2.0, 0.0, 1.0)
    for sub, arr in (("trainA", trA), ("trainB", trB),
                     ("testA", teA), ("testB", teB)):
        d = os.path.join(root, sub)
        os.makedirs(d, exist_ok=True)
        for i, x in enumerate(arr):
            np.savez(os.path.join(d, "%05d.npz" % i), data=x)
    return root


if __name__ == "__main__":
    import sys
    out = sys.argv[1] if len(sys.argv) > 1 else "./synthetic_data"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    n_test = int(sys.argv[3]) if len(sys.argv) > 3 else 64
    if len(sys.argv) > 4 and sys.argv[4] == "perfile":
        write_synthetic_perfile_dataset(out, n_train=n, n_test=n_test)
    else:
        write_synthetic_dataset(out, n_train=n, n_test=n_test)
    print("wrote synthetic dataset to", out)
