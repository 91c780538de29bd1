"""Climate-segmentation loader: the upstream's standalone
``simpleloader.py`` (``ClimateSegLoader``), as the JAX package's
``data/climate.py`` has it.  16-channel climate rasters standardized by
precomputed per-channel mean and std, one-hot labels collapsed to classes
by argmax.  numpy only.

Upstream it is a torch ``Dataset`` that neither ``train.py`` nor
``test.py`` uses; here it is a plain iterable with the same file-list
protocol (``{partition}_split.txt`` naming files under ``data_dir``).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

# precomputed dataset statistics (upstream simpleloader.py:10-11)
PRECOMP_MEAN = [26.160023, 0.98314494, 0.116573125, -0.45998842, 0.1930554,
                0.010749293, 98356.03, 100982.02, 216.13145, 258.9456,
                3.765611e-08, 288.82578, 288.03925, 342.4827, 12031.449,
                63.435772]
PRECOMP_STD = [17.04294, 8.164175, 5.6868863, 6.4967732, 5.4465833,
               0.006383436, 7778.5957, 3846.1863, 9.791707, 14.35133,
               1.8771327e-07, 19.866386, 19.094095, 624.22406, 679.5602,
               4.2283397]


class ClimateSegLoader:
    """Iterable dataset of (data, labels) pairs: data ``(16, npoints)``
    standardized float32, labels ``(npoints,)`` int64 classes."""

    def __init__(self, data_dir: str, partition: str = "train",
                 normalize_mean=PRECOMP_MEAN, normalize_std=PRECOMP_STD,
                 split_dir: str = "."):
        if partition not in ("train", "test", "val"):
            raise ValueError("partition must be train, test or val, got %r"
                             % partition)
        with open(os.path.join(split_dir, partition + "_split.txt")) as f:
            lines = f.readlines()
        self.flist: List[str] = [os.path.join(data_dir, l.strip())
                                 for l in lines if l.strip()]
        self.mean = np.expand_dims(normalize_mean, -1).astype(np.float32)
        self.std = np.expand_dims(normalize_std, -1).astype(np.float32)

    def __len__(self):
        return len(self.flist)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        with np.load(self.flist[idx]) as f:
            data = (f["data"] - self.mean) / self.std
            labels = f["labels"].astype(np.int64)
        return data, np.argmax(labels, axis=0)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
