"""In-memory npz bundle loading with the upstream normalization:

- read key 'data' from {train,test}{A,B}.npz, keep the first 3 channels,
- NaN -> 0, per-sample-per-channel min-max rescale to [-1, 1], +-inf -> 0,
- optional resize to (grid_size, grid_size),
- deterministic seed-123 shuffle of the train split (the upstream Python-2
  ``random.shuffle``, see :func:`py2_seed123_permutation`),
- the first ``dev_size`` samples become the dev split.

Arrays are NHWC float32, bit for bit those of the JAX package's
``data/npz.py``.  As there, the normalization runs in the native C++ reader
(``data/native.py``, bit-exact with the numpy path) when its library builds,
and in numpy otherwise.
"""

from __future__ import annotations

import os
import random
from typing import Optional, Tuple

import numpy as np

from .resize import resize_batch

DEV_SIZE = 200


def py2_seed123_permutation(n: int, seed: int = 123) -> np.ndarray:
    """The index permutation ``random.shuffle(range(n))`` produces under
    Python 2 with ``random.seed(123)``: Fisher-Yates driven by
    ``random.random()``, whose Mersenne-Twister stream for an int seed is
    the same in Python 2 and 3."""
    r = random.Random(seed)
    idx = list(range(n))
    for i in reversed(range(1, n)):
        j = int(r.random() * (i + 1))
        idx[i], idx[j] = idx[j], idx[i]
    return np.asarray(idx, dtype=np.int64)


def normalize_bundle(arr: np.ndarray, use_native: bool = True) -> np.ndarray:
    """NaN->0, per-sample-per-channel min-max to [-1, 1], inf scrubbed, in
    float32.  A 3-D (N, H, W) input gains its channel axis last.  A 4-D one
    goes through the native reader's threaded normalization when
    ``use_native`` and the library is built."""
    if use_native and arr.ndim == 4:
        from . import native
        out = np.array(arr, dtype=np.float32, order="C")
        if native.normalize_batch_inplace(out):
            return out
    arr = np.nan_to_num(arr.astype(np.float32, copy=True))
    if arr.ndim == 3:
        arr = np.expand_dims(arr, axis=3)
    lo = arr.min(axis=(1, 2))[:, np.newaxis, np.newaxis]
    hi = arr.max(axis=(1, 2))[:, np.newaxis, np.newaxis]
    with np.errstate(divide="ignore", invalid="ignore"):
        arr = -1.0 + 2.0 * (arr - lo) / (hi - lo)
    arr = np.nan_to_num(arr)
    arr[arr == np.inf] = 0
    arr[arr == -np.inf] = 0
    return arr.astype(np.float32)


def _load_one(root: str, fname: str, grid_size: Optional[int],
              antialias: bool = True) -> np.ndarray:
    print("Loading %s" % root)
    with np.load(os.path.join(root, fname)) as f:
        arr = f["data"][..., :3]
    arr = normalize_bundle(arr)
    if grid_size is not None:
        print("Resizing data to %d" % grid_size)
        arr = resize_batch(arr, grid_size, antialias=antialias)
    return arr


def load_numpy_data(root: str, shuffle: bool = True,
                    grid_size: Optional[int] = None,
                    dev_size: int = DEV_SIZE,
                    antialias: bool = True) -> Tuple[np.ndarray, ...]:
    """(trainA, trainB, devA, devB, testA, testB), all NHWC float32."""
    print("loading data numpy files...")
    trainA = _load_one(root, "trainA.npz", grid_size, antialias)
    trainB = _load_one(root, "trainB.npz", grid_size, antialias)
    testA = _load_one(root, "testA.npz", grid_size, antialias)
    testB = _load_one(root, "testB.npz", grid_size, antialias)
    print("done.")

    if shuffle:
        indx = py2_seed123_permutation(len(trainA))
        trainA = trainA[indx]
        trainB = trainB[indx]

    devA, devB = trainA[:dev_size], trainB[:dev_size]
    trainA, trainB = trainA[dev_size:], trainB[dev_size:]
    return trainA, trainB, devA, devB, testA, testB
