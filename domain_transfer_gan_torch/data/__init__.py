"""Data loading of the port, numpy on the host: the in-memory npz bundles
(``npz``), their resize, the minibatch iterators, the per-file dataset and
its threaded ``DataLoader`` (``folder``), the paired-jpg edges2shoes folder
(``edges2shoes``, PIL imported when used), the climate-segmentation loader
(``climate``), the Livneh NetCDF ETL (``prep_livneh``), the synthetic
writers, the native C++ reader (``native``, built with g++ at first use,
numpy where it cannot be) and the prefetching host feed of one device
(``feed``, torch)."""

from .edges2shoes import PILMissingError, load_edges2shoes
from .folder import DataLoader, NumpyDataset
from .iterators import AlignedIterator, UnalignedIterator
from .npz import DEV_SIZE, load_numpy_data, py2_seed123_permutation

__all__ = ["AlignedIterator", "UnalignedIterator", "DataLoader",
           "NumpyDataset", "DEV_SIZE", "PILMissingError",
           "load_edges2shoes", "load_numpy_data", "py2_seed123_permutation"]
