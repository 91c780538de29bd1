"""Data loading of the port: the in-memory npz bundles, their resize, the
minibatch iterators and the synthetic dataset writer.  numpy (and
``scipy.ndimage`` for the resize's pre-blur) only; torch is used by the
resize's interpolation.  The per-file ``DataLoader`` and the native loader
are not ported yet."""

from .iterators import AlignedIterator, UnalignedIterator
from .npz import DEV_SIZE, load_numpy_data, py2_seed123_permutation

__all__ = ["AlignedIterator", "UnalignedIterator", "DEV_SIZE",
           "load_numpy_data", "py2_seed123_permutation"]
