"""Normalization layers.

Both variance conventions of the upstream model are kept:

- :class:`InstanceNorm` uses the *biased* variance (divisor HW);
- :class:`CondInstanceNorm` uses the *unbiased* variance (divisor HW-1).

Statistics and the affine are fp32 whatever the compute dtype.  The modules
take the networks' internal layout, an NCHW tensor in ``channels_last``
memory format, and hand its free NHWC view to
``ops.kernels.instance_norm_fused``: the hand-written CUDA kernel on the
card, its plain version on the CPU.

``instance_norm_ref`` is the twin of the JAX package's ``instance_norm_xla``
(variance as E[x^2] - mean^2 clamped at 0) and is kept for module-level
parity tests; it differs from the kernel's centered form by rounding only.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.instance_norm import (
    instance_norm_fused,
    instance_norm_plain,
)
from .init import init_instance_norm_scale_, init_kernel_


def instance_norm_stats(x: torch.Tensor, eps: float, unbiased: bool):
    """Per-(sample, channel) mean/rstd over H,W of an NHWC tensor, in fp32,
    shaped (N, 1, 1, C).  Variance is E[x^2] - mean^2, clamped at 0."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=(1, 2), keepdim=True)
    mean_sq = (x32 * x32).mean(dim=(1, 2), keepdim=True)
    var = torch.clamp_min(mean_sq - mean * mean, 0.0)
    if unbiased:
        hw = x.shape[1] * x.shape[2]
        var = var * (hw / max(hw - 1, 1))
    return mean, torch.rsqrt(var + eps)


def instance_norm_ref(x: torch.Tensor, scale: Optional[torch.Tensor],
                      shift: Optional[torch.Tensor], eps: float,
                      unbiased: bool, relu: bool = False) -> torch.Tensor:
    """Reference-math instance norm on NHWC input; scale/shift are None,
    per-channel (C,) or per-sample (N, C)."""
    mean, rstd = instance_norm_stats(x, eps, unbiased)
    y = (x.to(torch.float32) - mean) * rstd
    if scale is not None:
        if scale.dim() == 1:
            y = y * scale[None, None, None, :] + shift[None, None, None, :]
        else:
            y = y * scale[:, None, None, :] + shift[:, None, None, :]
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


def _norm_nchw(x: torch.Tensor, scale, shift, eps: float, unbiased: bool,
               relu: bool, plain: bool) -> torch.Tensor:
    """Apply the fused norm to an NCHW activation through its NHWC view."""
    x_nhwc = x.permute(0, 2, 3, 1)
    if not x_nhwc.is_contiguous():
        # a conv that answered in another memory format: one copy
        x_nhwc = x_nhwc.contiguous()
    fn = instance_norm_plain if plain else instance_norm_fused
    y = fn(x_nhwc, scale, shift, eps=eps, unbiased=unbiased, relu=relu)
    return y.permute(0, 3, 1, 2)


class InstanceNorm(nn.Module):
    """The upstream custom InstanceNorm: biased variance, per-channel
    ``scale`` / ``shift`` parameters kept in fp32."""

    def __init__(self, features: int, affine: bool = True, eps: float = 1e-5,
                 fuse_relu: bool = False):
        super().__init__()
        self.features = features
        self.eps = eps
        self.fuse_relu = fuse_relu
        if affine:
            self.scale = nn.Parameter(torch.ones(features))
            self.shift = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("scale", None)
            self.register_parameter("shift", None)

    def reset_parameters(self, scheme: str, generator: torch.Generator):
        if self.scale is not None:
            init_instance_norm_scale_(self.scale, scheme, generator)
            with torch.no_grad():
                self.shift.zero_()

    def forward(self, x: torch.Tensor, plain_norm: bool = False):
        return _norm_nchw(x, self.scale, self.shift, self.eps, False,
                          self.fuse_relu, plain_norm)


class CondInstanceNorm(nn.Module):
    """Conditional instance norm, the latent-injection mechanism:
    shift = ReLU(Linear(z)), scale = ReLU(Linear(z)) from the flat latent
    code z (N, nlatent); x is normalized over H,W with *unbiased* variance,
    then out = norm(x) * scale + shift.  The Linear layers run in the
    compute dtype, their outputs are cast to fp32 for the norm."""

    def __init__(self, features: int, nlatent: int, eps: float = 1e-5,
                 fuse_relu: bool = False):
        super().__init__()
        self.features = features
        self.nlatent = nlatent
        self.eps = eps
        self.fuse_relu = fuse_relu
        self.shift_conv = nn.Linear(nlatent, features)
        self.scale_conv = nn.Linear(nlatent, features)

    def reset_parameters(self, scheme: str, generator: torch.Generator):
        for lin in (self.shift_conv, self.scale_conv):
            init_kernel_(lin.weight, self.nlatent, scheme, generator)
            with torch.no_grad():
                lin.bias.zero_()

    def forward(self, x: torch.Tensor, z: torch.Tensor,
                plain_norm: bool = False):
        z = z.to(self.shift_conv.weight.dtype)
        shift = F.relu(self.shift_conv(z)).to(torch.float32)
        scale = F.relu(self.scale_conv(z)).to(torch.float32)
        return _norm_nchw(x, scale, shift, self.eps, True, self.fuse_relu,
                          plain_norm)
