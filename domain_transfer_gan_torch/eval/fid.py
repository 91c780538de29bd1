"""Fréchet distance between feature distributions, with a fixed random
convolutional feature extractor: the port of the JAX package's
``eval/fid.py``.

There are no pretrained vision weights here, so the default extractor is a
**fixed random conv net** (4 x conv3x3 stride 2 + LeakyReLU(0.2), then the
mean over space), a documented proxy ("random-feature FID"): comparable
across models and checkpoints scored with the same extractor, not with
published Inception FID numbers.

Its weights are the JAX package's own: ``net.init(jax.random.PRNGKey(1234),
...)`` at width 64, stored as data in ``fid_weights.npz`` beside this file
(flax layout; ``conv1`` .. ``conv3`` once, ``conv0`` for every input channel
count C from 1 to 16, the most the repo's data has: ``data/climate.py``'s
rasters; flax draws ``conv1`` .. ``conv3`` the same whatever C is).  So a
checkpoint scores the same ``PROXY_FID_B`` in both packages.  The port draws
no extractor weights of its own: another width or seed, or C > 16, is a
``ValueError``.  The file is written from the JAX package by
``tests/test_torch_port_fid.py::write_fid_weights``.

A real extractor (Inception features, for true FID) comes as the JAX
package's ``--fid_extractor`` file, a ``jax.export`` artifact written by
its ``save_extractor``: :func:`load_extractor` reads it
(``utils/jax_export.py``) and runs its StableHLO program with torch on
the card (``eval/stablehlo.py``), without JAX.

The convolutions are cuDNN's (the JAX package computes them outside any
Pallas kernel).  Images are NHWC numpy arrays or tensors in [-1, 1];
features come back as numpy arrays.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
from scipy import linalg
from torch import nn
from torch.nn import functional as F

from ..utils import jax_export, vhlo
from ..utils.convert import jax_fid_params_to_state_dict
from .stablehlo import Program

FID_WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fid_weights.npz")
FID_WIDTH, FID_SEED, FID_MAX_CHANNELS = 64, 1234, 16


class RandomFeatureNet(nn.Module):
    """4 x (conv3x3 stride 2, padding 1 + LeakyReLU(0.2)), global mean:
    (N, H, W, in_ch) -> (N, 4 * width).  Its weights are zeros until a
    state is loaded (:func:`stored_extractor_state`)."""

    def __init__(self, width: int = 64, in_ch: int = 3):
        super().__init__()
        chans = (in_ch, width, 2 * width, 4 * width, 4 * width)
        for i in range(4):
            conv = nn.Conv2d(chans[i], chans[i + 1], 3, stride=2, padding=1)
            with torch.no_grad():
                conv.weight.zero_()
                conv.bias.zero_()
            setattr(self, "conv%d" % i, conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(4):
            x = F.leaky_relu(getattr(self, "conv%d" % i)(x), 0.2)
        return x.mean(dim=(2, 3))


@functools.lru_cache(maxsize=None)
def _stored() -> Dict[str, np.ndarray]:
    with np.load(FID_WEIGHTS) as f:
        return {k: f[k] for k in f.files}


def stored_extractor_state(in_ch: int) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of :class:`RandomFeatureNet` (width 64) holding
    the JAX package's default extractor for ``in_ch`` input channels."""
    if not 1 <= in_ch <= FID_MAX_CHANNELS:
        raise ValueError(
            "the stored proxy-FID extractor covers 1 to %d input channels, "
            "got %d (the port draws no extractor weights of its own)"
            % (FID_MAX_CHANNELS, in_ch))
    w = _stored()
    params = {"conv0": {"kernel": w["conv0/kernel/c%d" % in_ch],
                        "bias": w["conv0/bias"]}}
    for i in (1, 2, 3):
        params["conv%d" % i] = {"kernel": w["conv%d/kernel" % i],
                                "bias": w["conv%d/bias" % i]}
    return jax_fid_params_to_state_dict(params)


def random_feature_extractor(width: int = FID_WIDTH, seed: int = FID_SEED,
                             batch: int = 64, device="cuda",
                             state_dict=None) -> Callable:
    """The JAX package's random-conv feature extractor (N, H, W, C) -> (N,
    4 * width), fed in batches of ``batch`` on ``device``: its stored
    weights for the images' C, or ``state_dict`` (any width).  Only the
    stored width 64 and seed 1234 exist without a ``state_dict``."""
    if state_dict is None and (width, seed) != (FID_WIDTH, FID_SEED):
        raise ValueError(
            "only the JAX extractor of width %d and seed %d is stored, got "
            "width %d seed %d; pass its state_dict for another"
            % (FID_WIDTH, FID_SEED, width, seed))
    nets = {}

    def net_for(in_ch):
        if in_ch not in nets:
            sd = state_dict
            if sd is None:
                sd = stored_extractor_state(in_ch)
            net = RandomFeatureNet(sd["conv0.weight"].shape[0],
                                   sd["conv0.weight"].shape[1])
            net.load_state_dict(sd, strict=True)
            nets[in_ch] = net.to(device).eval().requires_grad_(False)
        return nets[in_ch]

    def extract(images) -> np.ndarray:
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images,
                                                           np.float32))
        net = net_for(int(images.shape[-1]))
        outs = []
        with torch.no_grad():
            for i in range(0, len(images), batch):
                outs.append(net(images[i:i + batch].to(device,
                                                       torch.float32)))
        return torch.cat(outs).cpu().numpy()

    return extract


def load_extractor(path: str, device="cuda") -> Callable:
    """Load a ``save_extractor`` artifact (the JAX package's
    ``eval/fid.py``) as an extractor callable on ``device``
    (``--fid_extractor PATH`` in the evaluation CLI).

    The whole module is checked here, before any image is read (what the
    port does not run is refused by name: ``utils/jax_export.py``,
    ``eval/stablehlo.py``).  The serialized function has a fixed traced
    batch; inputs are fed in chunks of that batch (the final chunk
    zero-padded and trimmed), so the returned callable accepts any N and
    returns numpy features.
    """
    exp = jax_export.check_extractor(jax_export.load(path), where=path)
    program = Program(exp.mlir_module_serialized, device=device)
    (aval,) = exp.in_avals
    fixed_batch = aval.shape[0]
    sample_shape = tuple(aval.shape[1:])
    dtype = vhlo.DTYPES[aval.dtype][0]
    lead = []
    if exp.platform_index is not None:
        lead = [torch.tensor(exp.platform_index, dtype=torch.int32,
                             device=program.device)]

    def extract(images) -> np.ndarray:
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images,
                                                           np.float32))
        if tuple(images.shape[1:]) != sample_shape:
            raise ValueError(
                "extractor %s was traced for %s images, got %s"
                % (path, sample_shape, tuple(images.shape[1:])))
        outs = []
        with torch.no_grad():
            for i in range(0, len(images), fixed_batch):
                chunk = images[i:i + fixed_batch].to(program.device, dtype)
                n = len(chunk)
                if n < fixed_batch:
                    chunk = torch.cat([chunk, chunk.new_zeros(
                        (fixed_batch - n,) + sample_shape)])
                args = lead + ([chunk] if exp.module_kept_var_idx else [])
                outs.append(program(*args)[0][:n])
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
               extractor: Optional[Callable] = None,
               rng_seed: Optional[int] = None) -> float:
    """Proxy-FID of generated B (from A with prior z) against real B, over
    up to ``n_max`` images, the extractor on the model's device.  The z
    draws consume the model's noise stream, or with ``rng_seed`` a
    ``torch.Generator`` of their own on the model's device, seeded with it,
    so the score does not depend on the model's state.  Those draws are the
    port's: they match the JAX package's (a ``jax.random`` key of the same
    seed) only where the same z is fed to both."""
    gen = None
    if rng_seed is not None:
        gen = torch.Generator(device=model.device)
        gen.manual_seed(rng_seed)
    reals, fakes, n = [], [], 0
    for batch in dataset:
        real_A = model._tensor(batch["A"])
        if gen is None:
            z = model.sample_prior_z(real_A.shape[0])
        else:
            z = torch.randn((real_A.shape[0], model.opt.nlatent),
                            device=model.device, generator=gen)
        reals.append(model._tensor(batch["B"]))
        fakes.append(model.predict_B(real_A, z))
        n += real_A.shape[0]
        if n >= n_max:
            break
    extractor = extractor or random_feature_extractor(device=model.device)
    return compute_fid(torch.cat(reals)[:n_max], torch.cat(fakes)[:n_max],
                       extractor)
