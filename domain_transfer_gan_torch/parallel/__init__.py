"""Data parallelism over ranks (``torch.distributed``): the port of the JAX
package's ``parallel/mesh.py::DataParallel`` and ``parallel/multihost.py``.
"""

from . import multihost
from .mesh import DataParallel

__all__ = ["DataParallel", "multihost"]
