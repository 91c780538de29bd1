"""Fréchet distance between feature distributions, with a fixed-seed random
convolutional feature extractor: the port of the JAX package's
``eval/fid.py``.

There are no pretrained vision weights here, so the default extractor is a
**fixed-seed random conv net** (4 x conv3x3 stride 2 + LeakyReLU(0.2), then
the mean over space), a documented proxy ("random-feature FID"): comparable
across models and checkpoints scored with the same extractor, not with
published Inception FID numbers.

The weights are drawn as flax's default ``nn.Conv`` init draws them (LeCun
normal kernels, zero biases), but from a ``torch.Generator`` seeded with
1234: the JAX package draws from ``jax.random.PRNGKey(1234)``, which cannot
be reproduced here, so the port's proxy-FID numbers are its own.  Loading
the JAX extractor's parameters (``utils.convert.jax_fid_params_to_state_dict``)
gives the JAX features.  The JAX package's ``--fid_extractor`` files are
``jax.export`` artifacts, which only JAX can run; the evaluation CLI refuses
the flag.

The convolutions are cuDNN's (the JAX package computes them outside any
Pallas kernel).  Images are NHWC numpy arrays or tensors in [-1, 1];
features come back as numpy arrays.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from scipy import linalg
from torch import nn
from torch.nn import functional as F

from ..nn.init import lecun_normal_


class RandomFeatureNet(nn.Module):
    """4 x (conv3x3 stride 2, padding 1 + LeakyReLU(0.2)), global mean:
    (N, H, W, 3) -> (N, 4 * width)."""

    def __init__(self, width: int = 64, in_ch: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        chans = (in_ch, width, 2 * width, 4 * width, 4 * width)
        for i in range(4):
            conv = nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1)
            lecun_normal_(conv.weight.data, 9 * chans[i],
                          generator or torch.Generator())
            conv.bias.data.zero_()
            setattr(self, "conv%d" % i, conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(4):
            x = F.leaky_relu(getattr(self, "conv%d" % i)(x), 0.2)
        return x.mean(dim=(2, 3))


def random_feature_extractor(width: int = 64, seed: int = 1234,
                             batch: int = 64, device="cuda",
                             state_dict=None) -> Callable:
    """Deterministic random-conv feature extractor (N, H, W, 3) -> (N, 4 *
    width), fed in batches of ``batch`` on ``device``; ``state_dict``
    replaces the seeded weights."""
    generator = torch.Generator()
    generator.manual_seed(seed)
    net = RandomFeatureNet(width, generator=generator)
    if state_dict is not None:
        net.load_state_dict(state_dict, strict=True)
    net = net.to(device).eval().requires_grad_(False)

    def extract(images) -> np.ndarray:
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images,
                                                           np.float32))
        outs = []
        with torch.no_grad():
            for i in range(0, len(images), batch):
                outs.append(net(images[i:i + batch].to(device,
                                                       torch.float32)))
        return torch.cat(outs).cpu().numpy()

    return extract


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """d^2 = |mu1 - mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))."""
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def activation_statistics(features: np.ndarray):
    mu = np.mean(features, axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def compute_fid(real_images, fake_images,
                extractor: Optional[Callable] = None,
                device="cuda") -> float:
    """Fréchet distance between the feature distributions of two image
    sets (the default extractor on ``device``)."""
    extractor = extractor or random_feature_extractor(device=device)
    mu1, s1 = activation_statistics(extractor(real_images))
    mu2, s2 = activation_statistics(extractor(fake_images))
    return frechet_distance(mu1, s1, mu2, s2)


def eval_fid_B(dataset, model, n_max: int = 2048,
               extractor: Optional[Callable] = None) -> float:
    """Proxy-FID of generated B (from A with the model's prior z draws)
    against real B, over up to ``n_max`` images, the extractor on the
    model's device."""
    reals, fakes, n = [], [], 0
    for batch in dataset:
        real_A = model._tensor(batch["A"])
        z = model.sample_prior_z(real_A.shape[0])
        reals.append(model._tensor(batch["B"]))
        fakes.append(model.predict_B(real_A, z))
        n += real_A.shape[0]
        if n >= n_max:
            break
    extractor = extractor or random_feature_extractor(device=model.device)
    return compute_fid(torch.cat(reals)[:n_max], torch.cat(fakes)[:n_max],
                       extractor)
