"""Residual blocks (internal NCHW layout).

- :class:`ResnetBlock`: pad -> conv3x3 -> ReLU -> [dropout] -> pad ->
  conv3x3 -> norm; out = ReLU(x + f(x)).  There is NO norm after the first
  conv in the plain block.
- :class:`CINResnetBlock`: pad -> conv3x3 -> CIN(z) -> ReLU -> [dropout] ->
  pad -> conv3x3 -> InstanceNorm(affine); out = ReLU(x + f(x, z)).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, Dropout
from .norms import CondInstanceNorm, InstanceNorm, make_norm

_PADDINGS = ("reflect", "replicate", "zero")


def _conv3x3(x, conv: Conv2d, padding_type: str):
    """pad by 1 (``padding_type``) -> 3x3 conv (``Conv2d.forward``: halo rows
    under a space axis, a channel slice under a model axis)."""
    if padding_type not in _PADDINGS:
        raise NotImplementedError("padding [%s] is not implemented"
                                  % padding_type)
    return conv(x, pre_pad=1, pad_mode=padding_type)


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, padding_type: str = "reflect",
                 norm: str = "instance", use_dropout: bool = False,
                 use_bias: bool = True):
        super().__init__()
        self.padding_type = padding_type
        self.conv1 = Conv2d(dim, dim, 3, bias=use_bias)
        self.dropout = Dropout(0.5) if use_dropout else None
        self.conv2 = Conv2d(dim, dim, 3, bias=use_bias)
        self.norm2 = make_norm(norm, dim)

    def forward(self, x, plain_norm: bool = False):
        h = F.relu(_conv3x3(x, self.conv1, self.padding_type))
        if self.dropout is not None:
            h = self.dropout(h)
        h = _conv3x3(h, self.conv2, self.padding_type)
        h = self.norm2(h, plain_norm)
        return F.relu(x + h)


class CINResnetBlock(nn.Module):
    def __init__(self, dim: int, nlatent: int, padding_type: str = "reflect",
                 use_dropout: bool = False, use_bias: bool = True):
        super().__init__()
        self.padding_type = padding_type
        self.conv1 = Conv2d(dim, dim, 3, bias=use_bias)
        # the ReLU that follows the CIN upstream is fused into the norm
        self.cin1 = CondInstanceNorm(dim, nlatent, fuse_relu=True)
        self.dropout = Dropout(0.5) if use_dropout else None
        self.conv2 = Conv2d(dim, dim, 3, bias=use_bias)
        self.norm2 = InstanceNorm(dim, affine=True)

    def forward(self, x, z, plain_norm: bool = False):
        h = _conv3x3(x, self.conv1, self.padding_type)
        h = self.cin1(h, z, plain_norm)
        if self.dropout is not None:
            h = self.dropout(h)
        h = _conv3x3(h, self.conv2, self.padding_type)
        h = self.norm2(h, plain_norm)
        return F.relu(x + h)
