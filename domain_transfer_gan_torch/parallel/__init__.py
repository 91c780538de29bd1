"""Training over a mesh of ranks (``torch.distributed``): the port of the
JAX package's ``parallel/`` (``mesh.py``: the ``data x space x model x
pipe`` mesh and ``DataParallel``; ``multihost.py``; ``pipeline.py``: GPipe
over the residual trunks; ``hints.py``: ``pin_batch_only``).
"""

from . import multihost
from .mesh import DataParallel

__all__ = ["DataParallel", "multihost"]
