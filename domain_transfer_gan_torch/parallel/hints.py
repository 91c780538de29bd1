"""``pin_batch_only``: the port of the JAX package's ``parallel/hints.py``.

In JAX ``pin_batch_only`` is a sharding constraint that keeps the global
heads of ``DiscriminatorEdges`` and ``LatentEncoder`` (a valid 4x4 conv
that collapses the image to 1x1) off the space axis; GSPMD inserts the
all-gather.  The port writes the communication out, so here it is that
all-gather (``parallel.spatial.gather_rows``): under an active space axis
it gathers all of H over the space group, after which the rest of the
network computes the whole map on every space rank.  Outside one it is the
identity.
"""

from __future__ import annotations

import torch

from .spatial import gather_rows


def pin_batch_only(x: torch.Tensor) -> torch.Tensor:
    """Where the JAX networks pin a head to batch-only sharding
    (``DiscriminatorEdges`` and ``LatentEncoder`` before ``conv4``): gather
    all of H under an active space axis; the identity otherwise."""
    return gather_rows(x)
