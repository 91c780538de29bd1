"""The per-file dataset (``--numpy_data 0``): one .npz/.npy file per sample
under ``dataroot/{trainA,trainB,testA,testB}/``, and its threaded loader.
The JAX package's ``data/folder.py`` in the port, array for array.

What it keeps of the upstream ``NumpyDataset``:

- recursive .npz/.npy discovery, sorted, then the seed-123 shuffle
  (:func:`~.npz.py2_seed123_permutation`);
- dev = the first ``dev_size`` of train, train = the rest;
- ``fraction`` subsetting (the supervised split, the evaluation CLI's 20 %
  train subset);
- unaligned mode draws a B index per item from ``random.Random(seed)``;
- the transform: resize to (grid_size, grid_size), then ``(x - 0.5) / 0.5``
  (upstream ToTensor + Normalize(0.5, 0.5, 0.5)); a uint8 file is scaled by
  1/255 first.

Unlike the bundled npz path, nothing scrubs NaN, min-max normalizes or caps
A at 3 channels: a file's values must already lie in [0, 1].  That is the
JAX package's behaviour too (ROADMAP F4), kept so that both packages give
the same arrays.

Batches are dicts of NHWC float32 numpy arrays.  The shuffle draws from
numpy's global generator, which the CLI seeds.  The loader's worker
threads fill a bounded two-deep queue; an iterator abandoned early stops
its producer.  The unaligned B indices are drawn in item order on the
producer thread, so the batches are the same at any ``nThreads`` (the JAX
loader draws them on its worker threads, in whatever order those run).
"""

from __future__ import annotations

import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from . import native
from .npz import DEV_SIZE, py2_seed123_permutation
from .resize import resize_batch

IMG_EXTENSIONS = (".npz", ".npy")


def is_numpy_file(filename: str) -> bool:
    return filename.endswith(IMG_EXTENSIONS)


def make_dataset(dir: str) -> List[str]:
    """Every .npz/.npy file under ``dir``, in ``os.walk`` order."""
    if not os.path.isdir(dir):
        raise FileNotFoundError("%s is not a valid directory" % dir)
    images = []
    for root, _, fnames in sorted(os.walk(dir)):
        for fname in fnames:
            if is_numpy_file(fname):
                images.append(os.path.join(root, fname))
    return images


def _load_arr(path) -> np.ndarray:
    """A sample's array: through the native reader where it is built (a
    uint8 file comes back uint8), else ``np.load``; an array passes
    through."""
    if isinstance(path, np.ndarray):
        return path
    arr, kind = native.read_npz_f32(str(path), return_kind=True)
    if arr is not None:
        if kind == "u":  # keep integer-image semantics (ToTensor's /255)
            return np.clip(arr, 0, 255).astype(np.uint8)
        return arr
    if str(path).endswith(".npy"):
        return np.load(path)
    with np.load(path) as f:
        return f["data"]


def default_transform(img: np.ndarray, grid_size: int,
                      antialias: bool = True) -> np.ndarray:
    """resize -> [-1, 1], HWC float32 (upstream ``get_transform``)."""
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = img.astype(np.float32)
    if img.shape[0] != grid_size or img.shape[1] != grid_size:
        img = resize_batch(img[None], grid_size, antialias=antialias)[0]
    return (img - 0.5) / 0.5


class NumpyDataset:
    def __init__(self, opt, subset: str, unaligned: bool,
                 fraction: float = 1.0, load_in_mem: bool = True,
                 seed: Optional[int] = None):
        self.root = opt.dataroot
        self.subset = subset
        self.unaligned = unaligned
        self.grid_size = opt.grid_size
        self.antialias = bool(getattr(opt, "resize_antialias", 1))
        if not 0.0 < fraction <= 1.0:
            raise ValueError("fraction must lie in (0, 1], got %r" % fraction)
        if subset in ("dev", "train"):
            sub_A, sub_B = "trainA", "trainB"
        elif subset in ("test", "val"):
            sub_A, sub_B = "testA", "testB"
        else:
            raise NotImplementedError("subset %s not supported" % subset)

        A_paths = sorted(make_dataset(os.path.join(self.root, sub_A)))
        B_paths = sorted(make_dataset(os.path.join(self.root, sub_B)))
        idx = py2_seed123_permutation(len(A_paths))
        A_paths = [A_paths[i] for i in idx]
        B_paths = [B_paths[i] for i in idx]
        dev_size = int(getattr(opt, "dev_size", DEV_SIZE))
        if subset == "dev":
            A_paths, B_paths = A_paths[:dev_size], B_paths[:dev_size]
        elif subset == "train":
            A_paths, B_paths = A_paths[dev_size:], B_paths[dev_size:]

        subset_size = int(len(A_paths) * fraction)
        self.A_paths = A_paths[:subset_size]
        self.B_paths = B_paths[:subset_size]

        # the transform is deterministic: with load_in_mem it runs once here
        # and the items are the transformed arrays
        self._transformed = load_in_mem
        if load_in_mem:
            self.A_paths = [self._transform(_load_arr(p))
                            for p in self.A_paths]
            self.B_paths = [self._transform(_load_arr(p))
                            for p in self.B_paths]

        self.A_size = len(self.A_paths)
        self.B_size = len(self.B_paths)
        self._rng = random.Random(seed)

    def _transform(self, arr: np.ndarray) -> np.ndarray:
        return default_transform(arr, self.grid_size, self.antialias)

    def draw_B(self, index: int) -> int:
        """The B index of item ``index``: a draw from the dataset's
        ``random.Random`` when unaligned, else the aligned one."""
        if self.unaligned:
            return self._rng.randint(0, self.B_size - 1)
        return index % self.A_size

    def item(self, index: int, index_B: int) -> Dict[str, np.ndarray]:
        A = _load_arr(self.A_paths[index % self.A_size])
        B = _load_arr(self.B_paths[index_B])
        if self._transformed:
            return {"A": A, "B": B}
        return {"A": self._transform(A), "B": self._transform(B)}

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.item(index, self.draw_B(index))

    def __len__(self):
        return max(self.A_size, self.B_size)


def _stack(items) -> Dict[str, np.ndarray]:
    return {"A": np.stack([it["A"] for it in items]),
            "B": np.stack([it["B"] for it in items])}


class DataLoader:
    """Threaded batch loader over a :class:`NumpyDataset`: batches of
    ``batchSize`` (the last one short unless ``drop_last``), in order or, with
    ``shuffle``, in a ``np.random.permutation`` of the items per pass."""

    def __init__(self, opt, subset: str, unaligned: bool, batchSize: int,
                 shuffle: bool = False, fraction: float = 1.0,
                 load_in_mem: bool = True, drop_last: bool = False,
                 num_workers: Optional[int] = None,
                 seed: Optional[int] = None):
        self.opt = opt
        self.dataset = NumpyDataset(opt, subset, unaligned, fraction,
                                    load_in_mem, seed=seed)
        self.batch_size = batchSize
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = (num_workers if num_workers is not None
                            else int(getattr(opt, "nThreads", 4)))

    def _batches(self):
        n = len(self.dataset)
        order = np.random.permutation(n) if self.shuffle else np.arange(n)
        batches = [[int(i) for i in order[s:s + self.batch_size]]
                   for s in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def _iter_batches(self):
        ds = self.dataset
        batches = self._batches()
        if self.num_workers <= 1:
            for idxs in batches:
                yield _stack([ds.item(i, ds.draw_B(i)) for i in idxs])
            return

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            def fetch(idxs):
                pairs = [(i, ds.draw_B(i)) for i in idxs]  # in item order
                return _stack(list(pool.map(lambda p: ds.item(*p), pairs)))

            # bounded two-deep pipeline: the next batch loads while the
            # caller consumes this one
            pending: "queue.Queue" = queue.Queue(maxsize=2)
            stop = object()
            cancel = threading.Event()

            def put_or_cancel(item) -> bool:
                while not cancel.is_set():
                    try:
                        pending.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

            def producer():
                try:
                    for idxs in batches:
                        if cancel.is_set() or not put_or_cancel(fetch(idxs)):
                            return
                except BaseException as e:  # re-raised on the consumer
                    put_or_cancel(e)
                finally:
                    put_or_cancel(stop)

            t = threading.Thread(target=producer, daemon=True)
            t.start()
            try:
                while True:
                    item = pending.get()
                    if item is stop:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    yield item
                t.join()
            finally:
                # a consumer that abandons the iterator (break, GC) must
                # release the producer, which may be blocked on the full
                # queue
                cancel.set()
                t.join(timeout=30)

    def load_data(self):
        return self._iter_batches()

    def __iter__(self):
        return self._iter_batches()

    def __len__(self):
        return len(self.dataset)
