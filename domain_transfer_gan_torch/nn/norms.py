"""Normalization layers.

Both variance conventions of the upstream model are kept:

- :class:`InstanceNorm` uses the *biased* variance (divisor HW);
- :class:`CondInstanceNorm` uses the *unbiased* variance (divisor HW-1).

Statistics and the affine are fp32 whatever the compute dtype.  The modules
take the networks' internal layout, an NCHW tensor in ``channels_last``
memory format, and hand its free NHWC view to
``ops.kernels.instance_norm_fused``: the hand-written CUDA kernels on the
card (forward and backward), their plain versions on the CPU.  With
``plain_norm=True`` a module computes ``instance_norm_plain`` under autograd
instead, on either device; that is the twin the fused path is held against.

:class:`BatchNorm2d` and :class:`BatchNorm1d` follow the JAX package's
``flax.linen.BatchNorm(momentum=0.9)``, not ``torch.nn.BatchNorm``: the
running average stores the *biased* batch variance.

Under a space axis (``parallel.spatial.rows_axis``) an instance norm sees
this rank's rows of each sample: it runs the split forms of the kernels
(``ops.kernels.instance_norm.instance_norm_split``), whose statistics and
backward sums are combined over the space group by :class:`SpaceStats`; a
batch norm reduces over ``data x space``, or over the batch slices alone
where the rows were gathered.

``instance_norm_ref`` is the twin of the JAX package's ``instance_norm_xla``
(variance as E[x^2] - mean^2 clamped at 0) and is kept for module-level
parity tests; it differs from the kernel's centered form by rounding only.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import multihost
from ..parallel.spatial import rows_axis
from ..ops.kernels.instance_norm import (
    combine_stats,
    instance_norm_fused,
    instance_norm_plain,
    instance_norm_split,
)
from .init import (
    batchnorm2d_scale_init_,
    init_instance_norm_scale_,
    init_kernel_,
)
from .layers import Linear


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


class SpaceStats:
    """The collectives of the split instance norm over a space axis: the
    ranks' (mean, M2) gathered and merged in rank order (every rank
    computes the same merge), and the backward's sums all-reduced."""

    def __init__(self, axis):
        self.axis = axis

    def combine(self, mean, m2, rows: int):
        both = multihost.all_gather_list(torch.stack([mean, m2]), self.axis)
        return combine_stats([t[0] for t in both], [t[1] for t in both],
                             [rows] * self.axis.size)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        return multihost.all_reduce_(t.contiguous(), axis=self.axis)


def _norm_nchw(x: torch.Tensor, scale, shift, eps: float, unbiased: bool,
               relu: bool, plain: bool) -> torch.Tensor:
    """Apply the fused norm to an NCHW activation through its NHWC view
    (its split form where the rows are spread over a space axis)."""
    x_nhwc = x.permute(0, 2, 3, 1)
    if not x_nhwc.is_contiguous():
        # a conv that answered in another memory format: one copy
        x_nhwc = x_nhwc.contiguous()
    axis = rows_axis()
    if axis is not None:
        y = instance_norm_split(x_nhwc, scale, shift, SpaceStats(axis),
                                eps=eps, unbiased=unbiased, relu=relu,
                                plain=plain)
        return y.permute(0, 3, 1, 2)
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
    then out = norm(x) * scale + shift.  The Linear layers run in z's dtype
    (the generators hand z over in the compute dtype), their outputs are
    cast to fp32 for the norm."""

    def __init__(self, features: int, nlatent: int, eps: float = 1e-5,
                 fuse_relu: bool = False):
        super().__init__()
        self.features = features
        self.nlatent = nlatent
        self.eps = eps
        self.fuse_relu = fuse_relu
        self.shift_conv = Linear(nlatent, features)
        self.scale_conv = Linear(nlatent, features)

    def reset_parameters(self, scheme: str, generator: torch.Generator):
        for lin in (self.shift_conv, self.scale_conv):
            init_kernel_(lin.weight, self.nlatent, scheme, generator)
            with torch.no_grad():
                lin.bias.zero_()

    def forward(self, x: torch.Tensor, z: torch.Tensor,
                plain_norm: bool = False):
        shift = F.relu(self.shift_conv(z)).to(torch.float32)
        scale = F.relu(self.scale_conv(z)).to(torch.float32)
        return _norm_nchw(x, scale, shift, self.eps, True, self.fuse_relu,
                          plain_norm)


def _global_moments(x32: torch.Tensor, dims, axis):
    """Mean and E[x^2] - mean^2 (clamped at 0) per channel over the global
    batch: the per-channel sums of x and x^2 are summed over the ranks of
    ``axis`` (whose parts are equal) in one differentiable all-reduce, whose
    backward sums the two per-channel gradient sums over them likewise."""
    c = x32.shape[1]
    count = x32.numel() // c * axis.size
    sums = multihost.all_reduce_sum(torch.cat([x32.sum(dim=dims),
                                               (x32 * x32).sum(dim=dims)]),
                                    axis)
    mean = sums[:c] / count
    return mean, torch.clamp_min(sums[c:] / count - mean * mean, 0.0)


class _BatchNormCore(nn.Module):
    """Batch norm over every axis but the channel axis 1, as
    ``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` computes it:
    statistics in fp32 whatever the input's dtype, variance as
    E[x^2] - mean^2 clamped at 0, and a running average that stores the
    *biased* batch variance (``torch.nn.BatchNorm`` stores the unbiased one).
    In train mode the running statistics advance once per call, in place,
    unless ``advance`` is off (:func:`running_stats_held`).  On a rank's
    slice of a global batch (``parallel.multihost.sharded``) the statistics
    are the global batch's, as the JAX package's mesh computes them, and
    the running averages advance from those (over ``data x space`` where the
    rows are spread over a space axis)."""

    momentum = 0.9
    eps = 1e-5
    advance = True

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, -1] + [1] * (x.dim() - 2)
        x32 = x.to(torch.float32)
        if self.training:
            mesh = multihost.shard_info()
            if mesh is not None:
                # rows spread over a space axis: data x space; else the
                # batch's slices (the rows whole, or no space axis)
                axis = (mesh.replica if rows_axis() is not None
                        else mesh.batch)
                mean, var = _global_moments(x32, dims, axis)
            else:
                mean = x32.mean(dim=dims)
                var = torch.clamp_min(
                    (x32 * x32).mean(dim=dims) - mean * mean, 0.0)
            if self.advance:
                with torch.no_grad():
                    self.running_mean.mul_(self.momentum).add_(
                        mean, alpha=1.0 - self.momentum)
                    self.running_var.mul_(self.momentum).add_(
                        var, alpha=1.0 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)
        return y.to(x.dtype)


@contextlib.contextmanager
def running_stats_held(module: nn.Module):
    """Train-mode batch norms anywhere in ``module`` normalize with their
    batch statistics as always but do not advance their running
    statistics: a forward that is run again (a ``--remat`` recompute) or
    whose update is to be discarded leaves no trace."""
    cores = [m for m in module.modules() if isinstance(m, _BatchNormCore)]
    for m in cores:
        m.advance = False
    try:
        yield module
    finally:
        for m in cores:
            m.advance = True


class BatchNorm2d(nn.Module):
    """Batch norm over N, H, W of an NCHW activation.  Under the
    ``reference`` init scale ~ N(1, 0.02), bias = 0.  The parameters live in
    the child ``bn`` (``bn.weight``, ``bn.bias``, ``bn.running_mean``,
    ``bn.running_var``), where the JAX package's tree has them."""

    def __init__(self, features: int):
        super().__init__()
        self.bn = _BatchNormCore(features)

    def reset_parameters(self, scheme: str, generator: torch.Generator):
        batchnorm2d_scale_init_(self.bn.weight, scheme, generator)
        with torch.no_grad():
            self.bn.bias.zero_()

    def forward(self, x: torch.Tensor, plain_norm: bool = False):
        return self.bn(x)


class BatchNorm1d(nn.Module):
    """Batch norm over N of an (N, F) activation, scale = 1 and bias = 0 under
    every init scheme (the latent discriminator's norms)."""

    def __init__(self, features: int):
        super().__init__()
        self.bn = _BatchNormCore(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


def make_norm(kind: str, features: int) -> nn.Module:
    """``instance`` or ``batch`` norm with an affine; both are called as
    ``norm(x, plain_norm)``."""
    if kind == "instance":
        return InstanceNorm(features, affine=True)
    if kind == "batch":
        return BatchNorm2d(features)
    raise NotImplementedError("normalization layer [%s] is not found" % kind)
