"""edges2shoes loading: the dataset the upstream ``test.py`` imports from a
module it never shipped.  The JAX package's ``data/edges2shoes.py`` in the
port.

Two layouts:

1. npz bundles ``{train,test}{A,B}.npz`` with key 'data': the bundled path
   (``load_numpy_data``);
2. the pix2pix edges2shoes folder: ``train/*.jpg`` and ``val/*.jpg`` (or
   ``test/``), each jpg an A|B pair side by side (edges left, photo right),
   each half resized to ``size`` with PIL's bilinear filter and scaled to
   [-1, 1].  This branch needs PIL (Pillow), imported when it runs; without
   it :class:`PILMissingError` names the module.

Returns the 6-tuple (trainA, trainB, devA, devB, testA, testB), NHWC
float32, dev = the first ``dev_size`` train samples after the seed-123
shuffle.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .npz import DEV_SIZE, load_numpy_data, py2_seed123_permutation


class PILMissingError(ImportError):
    """The paired-jpg branch was asked for and PIL cannot be imported."""


def is_paired_jpg_root(root: str) -> bool:
    """What both CLIs read as a paired-jpg folder: a ``train/`` directory
    and no ``trainA.npz``."""
    return (not os.path.exists(os.path.join(root, "trainA.npz"))
            and os.path.isdir(os.path.join(root, "train")))


def require_pil_for(root: str) -> None:
    """Raise :class:`PILMissingError` if ``root`` is a paired-jpg folder and
    PIL cannot be imported: the CLIs' check before they write anything."""
    if is_paired_jpg_root(root):
        _import_pil()


def _import_pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise PILMissingError(
            "the paired-jpg branch of load_edges2shoes needs the PIL module "
            "(Pillow), which cannot be imported here (%s); convert the "
            "folder to {train,test}{A,B}.npz bundles elsewhere" % e) from e
    return Image


def _load_pair_folder(folder: str, size: int) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    Image = _import_pil()
    files = sorted(f for f in os.listdir(folder)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    A, B = [], []
    for f in files:
        img = Image.open(os.path.join(folder, f)).convert("RGB")
        w, h = img.size
        a = img.crop((0, 0, w // 2, h)).resize((size, size), Image.BILINEAR)
        b = img.crop((w // 2, 0, w, h)).resize((size, size), Image.BILINEAR)
        A.append(np.asarray(a, dtype=np.float32))
        B.append(np.asarray(b, dtype=np.float32))
    A = np.stack(A) / 127.5 - 1.0
    B = np.stack(B) / 127.5 - 1.0
    return A, B


def load_edges2shoes(root: str, size: int = 64, shuffle: bool = True,
                     dev_size: int = DEV_SIZE, antialias: bool = True):
    if os.path.exists(os.path.join(root, "trainA.npz")):
        return load_numpy_data(root, shuffle=shuffle, grid_size=size,
                               dev_size=dev_size, antialias=antialias)

    train_dir = os.path.join(root, "train")
    if not os.path.isdir(train_dir):
        raise FileNotFoundError("%s holds neither trainA.npz nor a train/ "
                                "folder of paired jpgs" % root)
    val_dir = os.path.join(root, "val")
    if not os.path.isdir(val_dir):
        val_dir = os.path.join(root, "test")
    trainA, trainB = _load_pair_folder(train_dir, size)
    testA, testB = _load_pair_folder(val_dir, size)

    if shuffle:
        idx = py2_seed123_permutation(len(trainA))
        trainA, trainB = trainA[idx], trainB[idx]

    devA, devB = trainA[:dev_size], trainB[:dev_size]
    trainA, trainB = trainA[dev_size:], trainB[dev_size:]
    return trainA, trainB, devA, devB, testA, testB
