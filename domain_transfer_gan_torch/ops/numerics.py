"""Core math of the Augmented CycleGAN family, under the names and semantics
of the JAX package's ``ops/numerics.py``.

Latent codes are flat ``(B, nlatent)``.  The clamp of z to [-4, 4] is kept
because it changes training dynamics.  Everything here runs on the tensors'
device and never reads a value back to the host.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def gauss_reparametrize(mu: torch.Tensor, logvar: torch.Tensor,
                        n_sample: int = 1, clamp: float = 4.0,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """z = clamp(mu + eps * exp(logvar / 2), -4, 4) with eps ~ N(0, I) drawn
    from ``generator``; returns (B * n_sample, nlatent).  The clamp passes no
    gradient outside the interval."""
    b, d = mu.shape
    eps = torch.randn((b, n_sample, d), dtype=mu.dtype, device=mu.device,
                      generator=generator)
    std = torch.exp(0.5 * logvar)
    z = eps * std[:, None, :] + mu[:, None, :]
    return torch.clamp(z, -clamp, clamp).reshape(b * n_sample, d)


def gauss_reparametrize_eps(mu: torch.Tensor, logvar: torch.Tensor,
                            eps: torch.Tensor, clamp: float = 4.0
                            ) -> torch.Tensor:
    """:func:`gauss_reparametrize` with the noise supplied: the two-phase
    step uses one z sample in both phases."""
    return torch.clamp(eps * torch.exp(0.5 * logvar) + mu, -clamp, clamp)


def log_prob_laplace(z, mu, log_var):
    """Elementwise Laplace log-density with scale sd = exp(log_var / 2)."""
    sd = torch.exp(0.5 * log_var)
    return -0.5 * log_var - torch.abs(z - mu) / sd - math.log(2.0)


def log_prob_gaussian(z, mu, log_var):
    """Elementwise Gaussian log-density."""
    return (-0.5 * log_var
            - (z - mu) ** 2.0 / (2.0 * torch.exp(log_var))
            - 0.5 * math.log(2 * math.pi))


def kld_std_gauss(mu, log_var):
    """KL(N(mu, exp(log_var)) || N(0, I)) summed over the latent dim: (B,)."""
    return -0.5 * torch.sum(log_var + 1.0 - mu ** 2 - torch.exp(log_var),
                            dim=1)


def criterion_gan(pred: torch.Tensor, target_is_real: bool,
                  use_sigmoid: bool) -> torch.Tensor:
    """GAN criterion, computed in float32 whatever the compute dtype.

    LSGAN (``use_sigmoid=False``): mean squared error against 0/1 targets.
    Vanilla (``use_sigmoid=True``): binary cross-entropy on sigmoid
    *probabilities* (the nets end in a Sigmoid in this mode).
    ``F.binary_cross_entropy`` in float32 has the semantics the JAX package
    spells out by hand: log terms clamped at -100 in the forward, and
    ``(p - t) / max(p * (1 - p), 1e-12)`` in the backward, huge but finite at
    p in {0, 1}; tests/test_torch_port_numerics.py holds it to that.
    """
    p = pred.to(torch.float32)
    target = torch.ones_like(p) if target_is_real else torch.zeros_like(p)
    if use_sigmoid:
        return F.binary_cross_entropy(p, target)
    return torch.mean((p - target) ** 2)


def l1_loss(a, b):
    return torch.mean(torch.abs(a - b))


def mse_loss(a, b):
    return torch.mean((a - b) ** 2)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Global L2 norm of a list of gradients, accumulated in float32; a
    0-dim tensor on their device (a CPU zero for an empty list)."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    norms = torch._foreach_norm([t.to(torch.float32) for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_grads_torchlike(grads: Sequence[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None
                         ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Global-norm clipping of one network's gradients: scale by
    ``max_norm / (norm + 1e-6)`` only when the norm exceeds ``max_norm``.
    Returns the clipped gradients and the *pre-clip* norm.

    This is the old ``clip_grad_norm`` rule the upstream model was written
    against; ``torch.nn.utils.clip_grad_norm_`` clamps the coefficient
    instead, which scales by 1 / (1 + 1e-6 / max) just below the threshold.
    The decision stays on the device: no value is read back.  ``norm``:
    the gradient's global norm where the caller has it, else computed here.
    """
    grads = list(grads)
    if norm is None:
        norm = global_norm(grads)
    if not grads:
        return grads, norm
    scale = torch.where(norm > max_norm, max_norm / (norm + 1e-6),
                        torch.ones_like(norm))
    # one fused multiply over the whole list, not a launch per tensor
    return list(torch._foreach_mul(grads, scale)), norm


def nats2bpp(nats, nc: int, npx: int):
    """nats -> bits per pixel."""
    return (nats / (npx * npx * nc)) / math.log(2.0)


def log_prob_gaussian_detail(z, mu, log_var, size):
    """Decomposed Gaussian log-density terms (logvar term, quadratic term,
    normalizer); ``size`` must be 3-D (batch, groups, feat).  The normalizer
    scales by the per-sample feature count, derived from the shapes."""
    if len(size) != 3:
        raise ValueError("size must be 3-D (batch, groups, feat), got %r"
                         % (size,))
    res1 = (-0.5 * log_var).reshape(size).sum(2).mean(1).mean(0)
    res2 = (-(z - mu) ** 2.0 / (2.0 * torch.exp(log_var))
            ).reshape(size).sum(2).mean(1).mean(0)
    feat = z.numel() // (size[0] * size[1])
    res3 = -0.5 * math.log(2 * math.pi) * feat
    return res1, res2, res3
