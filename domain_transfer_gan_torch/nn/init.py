"""Weight-init schemes, drawing from an explicit ``torch.Generator``.

``reference`` reproduces the upstream init, quirks included:

- every conv kernel (ConvTranspose and the 1x1 convs on z inside the
  conditional instance norm included) ~ N(0, 0.02), bias = 0;
- BatchNorm2d scale ~ N(1, 0.02), bias = 0;
- the custom InstanceNorm keeps its own reset: scale ~ N(0, 0.02), shift = 0
  (a near-zero gain);
- Linear and BatchNorm1d (the latent discriminator) keep the PyTorch
  defaults: Linear weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
  BatchNorm1d scale = 1, bias = 0.

``sane`` swaps these for conventional choices with identical shapes:
InstanceNorm and BatchNorm2d scale = 1 and LeCun-normal kernels (a normal
truncated at two standard deviations with variance 1/fan_in,
fan_in = kh * kw * Cin), the latent discriminator's Linear layers included
(bias = 0).

The two frameworks draw different numbers from the same seed, so only the
distributions agree with the JAX package, not the values.
"""

from __future__ import annotations

import math

import torch

SCHEMES = ("reference", "sane")

# standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _check(scheme: str) -> None:
    if scheme not in SCHEMES:
        raise ValueError("init_scheme must be one of %r, got %r"
                         % (SCHEMES, scheme))


@torch.no_grad()
def normal002_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """N(0, 0.02), in place."""
    return t.normal_(0.0, 0.02, generator=generator)


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Truncated normal with variance 1/fan_in, in place (inverse-CDF
    sampling of the interval [-2, 2] standard deviations)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.empty(t.shape, dtype=torch.float64).uniform_(
        lo, 1.0 - lo, generator=generator)
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    t.copy_((math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0) * std).to(t.dtype))
    return t


def init_kernel_(weight: torch.Tensor, fan_in: int, scheme: str,
                 generator: torch.Generator) -> torch.Tensor:
    """A conv, transposed-conv or Linear weight; ``fan_in`` = kh * kw * Cin."""
    _check(scheme)
    if scheme == "reference":
        return normal002_(weight, generator)
    return lecun_normal_(weight, fan_in, generator)


@torch.no_grad()
def init_instance_norm_scale_(scale: torch.Tensor, scheme: str,
                              generator: torch.Generator) -> torch.Tensor:
    _check(scheme)
    if scheme == "reference":
        return normal002_(scale, generator)
    return scale.fill_(1.0)


@torch.no_grad()
def batchnorm2d_scale_init_(scale: torch.Tensor, scheme: str,
                            generator: torch.Generator) -> torch.Tensor:
    """N(1, 0.02) under ``reference``, ones under ``sane``."""
    _check(scheme)
    if scheme == "reference":
        return scale.normal_(1.0, 0.02, generator=generator)
    return scale.fill_(1.0)


@torch.no_grad()
def torch_linear_init_(t: torch.Tensor, fan_in: int,
                       generator: torch.Generator) -> torch.Tensor:
    """The nn.Linear default for weight and bias:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return t.uniform_(-bound, bound, generator=generator)
