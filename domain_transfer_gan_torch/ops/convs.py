"""Convolution geometry helpers on the port's internal layout.

Inside the networks an activation is an NCHW tensor (in
``torch.channels_last`` memory format); kernels are in PyTorch's layouts,
``(O, I, kh, kw)`` for a convolution and ``(I, O, kh, kw)`` for a transposed
one.  ``utils.convert`` maps the JAX package's HWIO kernels onto them.  The
convolutions themselves are cuDNN's, as the JAX package leaves them to XLA;
the pads are the port's kernels (``ops/kernels/pad.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels.pad import pad2d


def reflect_pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """nn.ReflectionPad2d on an NCHW tensor."""
    if pad == 0:
        return x
    return pad2d(x, (pad, pad, pad, pad), "reflect")


def replicate_pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """nn.ReplicationPad2d on an NCHW tensor."""
    if pad == 0:
        return x
    return pad2d(x, (pad, pad, pad, pad), "replicate")


def conv2d_torch(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1,
                 padding: int = 0) -> torch.Tensor:
    """Conv2d geometry: symmetric ``padding``, floor-division output size.

    x: (N, Cin, H, W); w: (Cout, Cin, kh, kw); b: (Cout,) or None.
    """
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def conv_transpose2d_torch(x: torch.Tensor, w: torch.Tensor, b=None,
                           stride: int = 2, padding: int = 1,
                           output_padding: int = 1) -> torch.Tensor:
    """ConvTranspose2d(k, s, p, op): out = (in-1)*s - 2p + k + op.

    x: (N, Cin, H, W); w: (Cin, Cout, kh, kw) in PyTorch's transposed-conv
    layout.  The JAX package computes the same layer by correlating the
    stride-dilated input with an unflipped (kh, kw, Cin, Cout) kernel, so a
    kernel carried over from there is flipped on both spatial axes
    (``utils.convert``).
    """
    return F.conv_transpose2d(x, w, b, stride=stride, padding=padding,
                              output_padding=output_padding)


def torch_conv_out_size(in_size: int, k: int, s: int, p: int) -> int:
    return (in_size + 2 * p - k) // s + 1


def torch_conv_transpose_out_size(in_size: int, k: int, s: int, p: int,
                                  op: int) -> int:
    return (in_size - 1) * s - 2 * p + k + op
