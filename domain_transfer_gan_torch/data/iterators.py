"""Minibatch iterators with the upstream protocol: dict batches
{'A': ..., 'B': ...}, epoch auto-reset via StopIteration, aligned (same
order) vs unaligned (two independent permutations, full-size batches via
last-batch backoff).  They draw the same batches in the same order from the
same ``np.random`` state as the JAX package's ``data/iterators.py``.

Batches are NHWC numpy arrays; the model moves them to its device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class AlignedIterator:
    """Paired minibatches in the same index order."""

    def __init__(self, data_A, data_B, batch_size: int = 100,
                 shuffle: bool = False,
                 rng: Optional[np.random.RandomState] = None):
        if data_A.shape[0] != data_B.shape[0]:
            raise ValueError("passed data differ in number: %d vs %d"
                             % (data_A.shape[0], data_B.shape[0]))
        self.data_A = data_A
        self.data_B = data_B
        self.num_samples = data_A.shape[0]
        self.batch_size = batch_size
        self.n_batches = -(-self.num_samples // batch_size)
        self.shuffle = shuffle
        self.rng = rng or np.random
        self.reset()

    def __iter__(self):
        return self

    def reset(self):
        if self.shuffle:
            self.data_indices = self.rng.permutation(self.num_samples)
        else:
            self.data_indices = np.arange(self.num_samples)
        self.batch_idx = 0

    def __next__(self) -> Dict[str, np.ndarray]:
        if self.batch_idx == self.n_batches:
            self.reset()
            raise StopIteration
        idx = self.batch_idx * self.batch_size
        chosen = self.data_indices[idx:idx + self.batch_size]
        self.batch_idx += 1
        return {"A": self.data_A[chosen], "B": self.data_B[chosen]}

    def __len__(self):
        return self.num_samples


class UnalignedIterator:
    """Unpaired minibatches: independent permutations per domain, every
    batch full-size via last-batch backoff.

    With ``yield_indices`` set, a batch is ``{'A_idx', 'B_idx'}``: the int64
    row indices of the batch instead of the gathered rows (the
    device-resident train set gathers them on the card).  Same RandomState,
    same permutations, same rows."""

    def __init__(self, data_A, data_B, batch_size: int = 100,
                 rng: Optional[np.random.RandomState] = None):
        if data_A.shape[0] != data_B.shape[0]:
            raise ValueError("passed data differ in number: %d vs %d"
                             % (data_A.shape[0], data_B.shape[0]))
        self.data_A = data_A
        self.data_B = data_B
        self.num_samples = data_A.shape[0]
        self.batch_size = batch_size
        self.n_batches = -(-self.num_samples // batch_size)
        self.rng = rng or np.random
        self.yield_indices = False
        self.reset()

    def __iter__(self):
        return self

    def reset(self):
        self.data_indices = [self.rng.permutation(self.num_samples)
                             for _ in range(2)]
        self.batch_idx = 0

    def __next__(self) -> Dict[str, np.ndarray]:
        if self.batch_idx == self.n_batches:
            self.reset()
            raise StopIteration
        idx = self.batch_idx * self.batch_size
        if idx + self.batch_size >= len(self.data_indices[0]):
            idx = len(self.data_indices[0]) - self.batch_size
        chosen_A = self.data_indices[0][idx:idx + self.batch_size]
        chosen_B = self.data_indices[1][idx:idx + self.batch_size]
        self.batch_idx += 1
        if self.yield_indices:
            return {"A_idx": np.asarray(chosen_A, dtype=np.int64),
                    "B_idx": np.asarray(chosen_B, dtype=np.int64)}
        return {"A": self.data_A[chosen_A], "B": self.data_B[chosen_B]}

    def __len__(self):
        return self.num_samples
