"""Layers whose parameters follow the activation's dtype.

Training keeps every parameter in float32 (the optimizer's master copy) and
computes in ``compute_dtype``: a layer casts its weight and bias to the dtype
of the tensor it is given, per use, and autograd carries the gradient back to
the float32 parameter.  For float32 activations, and for a served model whose
weights were cast once by ``place``, the cast is a no-op.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import multihost


def _as(t: Optional[torch.Tensor], dtype: torch.dtype):
    return None if t is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _as(self.bias, x.dtype))


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _as(self.bias, x.dtype))


class Dropout(nn.Dropout):
    """Dropout with keep probability ``1 - p`` whose masks come from an
    explicit ``torch.Generator`` (``self.generator``, on the activation's
    device; None means the global one).  Every call draws anew from that
    stream, so two networks that share a generator never share a mask.  On
    a rank's slice of a global batch (``parallel.multihost.sharded``) the
    mask is drawn for the full batch and the rank keeps its rows, so the
    ranks draw what one process draws."""

    def __init__(self, p: float = 0.5):
        super().__init__(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        shard = multihost.shard_info()
        world = shard[1] if shard is not None else 1
        # on a rank's slice: the full batch's mask, of which the rank's rows
        keep = torch.empty((world * x.shape[0],) + tuple(x.shape[1:]),
                           dtype=torch.float32, device=x.device)
        keep.bernoulli_(1.0 - self.p, generator=self.generator)
        if shard is not None:
            keep = multihost.local_rows(keep, *shard)
        return x * (keep / (1.0 - self.p)).to(x.dtype)
