"""Layers whose parameters follow the activation's dtype.

Training keeps every parameter in float32 (the optimizer's master copy) and
computes in ``compute_dtype``: a layer casts its weight and bias to the dtype
of the tensor it is given, per use, and autograd carries the gradient back to
the float32 parameter.  For float32 activations, and for a served model whose
weights were cast once by ``place``, the cast is a no-op.

Over a mesh (``parallel/mesh.py``):

- under a space axis a convolution computes this rank's rows from its
  slice and its neighbours' halo rows (``parallel.spatial.conv2d_layer``);
- a layer whose weight a model axis slices (``parallel.mesh.slices_of``:
  the axis and the sliced dimensions, entered by
  ``parallel.mesh.TensorShards``) computes this rank's slice of output
  channels and all-gathers them (its input's gradient is summed over the
  model ranks; the gathered output's gradient is the same on every model
  rank, and each keeps its channels); a bias the rule leaves whole is added
  after the gather, so its gradient is the whole one on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import multihost
from ..parallel.mesh import slices_of
from ..parallel.spatial import conv2d_layer, rows_axis


def _as(t: Optional[torch.Tensor], dtype: torch.dtype):
    return None if t is None else t.to(dtype)


def sliced_layer(module: nn.Module, x: torch.Tensor, compute, channel_dim):
    """``compute(x, weight, bias)`` for a layer with parameters
    ``module.weight`` / ``module.bias``, cast to x's dtype; for a layer a
    model axis slices, on this rank's output channels, gathered along
    ``channel_dim`` of the output."""
    w, b = module.weight.to(x.dtype), _as(module.bias, x.dtype)
    sliced = slices_of(module)
    if sliced is None:
        return compute(x, w, b)
    axis, dims = sliced
    whole_bias = b is not None and dims["bias"] is None
    y = compute(multihost.copy_to(x, axis), w, None if whole_bias else b)
    y = multihost.gather_dim(y.movedim(channel_dim, -1), axis, y.dim() - 1,
                             summed=False).movedim(-1, channel_dim)
    if whole_bias:
        shape = [1] * y.dim()
        shape[channel_dim] = -1
        y = y + b.reshape(shape)
    return y


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor, pre_pad: int = 0,
                pad_mode: str = "zeros") -> torch.Tensor:
        """The convolution, after ``pre_pad`` rows and columns of
        ``pad_mode`` padding (``parallel.spatial.conv2d_layer``)."""
        return sliced_layer(self, x, lambda x_, w, b: conv2d_layer(
            x_, w, b, self.stride[0], self.padding[0], pre_pad, pad_mode), 1)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sliced_layer(self, x, F.linear, x.dim() - 1)


class Dropout(nn.Dropout):
    """Dropout with keep probability ``1 - p`` whose masks come from an
    explicit ``torch.Generator`` (``self.generator``, on the activation's
    device; None means the global one).  Every call draws anew from that
    stream, so two networks that share a generator never share a mask.  On
    a rank's slice of a global batch (``parallel.multihost.sharded``) the
    mask is drawn for the full batch and the rank keeps its rows, so the
    ranks draw what one process draws; under a space axis the rank keeps
    its rows of it too."""

    def __init__(self, p: float = 0.5):
        super().__init__(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        mesh = multihost.shard_info()
        batch = mesh.batch if mesh is not None else None
        rows = rows_axis()
        shape = list(x.shape)
        if batch is not None:
            shape[0] *= batch.size
        if rows is not None:
            shape[2] *= rows.size
        # on a rank's part: the full batch's mask, of which the rank's part
        keep = torch.empty(shape, dtype=torch.float32, device=x.device)
        keep.bernoulli_(1.0 - self.p, generator=self.generator)
        if batch is not None:
            keep = multihost.local_rows(keep, batch.index, batch.size)
        if rows is not None:
            keep = multihost.local_rows(keep, rows.index, rows.size, 2)
        return x * (keep / (1.0 - self.p)).to(x.dtype)
