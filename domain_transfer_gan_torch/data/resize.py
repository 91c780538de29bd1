"""Batch resize with the JAX package's ``data/resize.py`` semantics.

Upstream resized with ``skimage.transform.resize``, which on downscaling
pre-blurs with a Gaussian of ``sigma = max(0, (factor - 1) / 2)`` per axis
and then interpolates linearly at half-pixel sample centres.  The JAX package
reproduces it with ``scipy.ndimage.gaussian_filter`` (mode 'mirror') and
``jax.image.resize(method='linear')``; this module keeps the same pre-blur
and replaces ``jax.image.resize`` by :func:`linear_resize`, a torch port of
its algorithm (``jax._src.image.scale``: one weight matrix per spatial axis,
triangle kernel, weights normalised over in-range taps, contracted with the
image):

- ``antialias=True`` (the default): pre-blur on downscale, then the plain
  triangle kernel (``jax.image.resize(..., antialias=False)``, which is
  ``F.interpolate(mode='bilinear', align_corners=False)``);
- ``antialias=False``: no pre-blur, and the triangle kernel widened by the
  downscale factor, as ``jax.image.resize``'s own antialias does
  (``scale_and_translate``); ``F.interpolate(antialias=True)`` is close to
  it but not the same filter.

Equal sizes are the identity.
"""

from __future__ import annotations

import numpy as np
import torch


def _antialias_sigma(in_size: int, out_size: int) -> float:
    """skimage's anti_aliasing_sigma: max(0, (factor - 1) / 2)."""
    factor = in_size / float(out_size)
    return max(0.0, (factor - 1.0) / 2.0)


def gaussian_blur_batch(arr: np.ndarray, sigma_h: float, sigma_w: float
                        ) -> np.ndarray:
    """Gaussian blur over the spatial axes of an NHWC batch (mirror edges)."""
    if sigma_h <= 0 and sigma_w <= 0:
        return arr
    from scipy import ndimage
    return ndimage.gaussian_filter(
        arr, sigma=(0.0, sigma_h, sigma_w, 0.0), mode="mirror")


def _weight_matrix(in_size: int, out_size: int,
                   widen: bool) -> torch.Tensor:
    """(in_size, out_size) float32 interpolation weights of one axis:
    ``jax._src.image.scale.compute_weight_mat`` with the triangle kernel,
    scale out/in and no translation, computed in float32 as there."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0) if widen else 1.0
    sample_f = ((torch.arange(out_size, dtype=torch.float32) + 0.5)
                * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32)
         [:, None]).abs() / kernel_scale
    weights = torch.clamp_min(1.0 - x, 0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps32 = float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > 1000.0 * eps32,
                          weights / torch.where(total != 0, total,
                                                torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def linear_resize(arr: np.ndarray, out_h: int, out_w: int,
                  widen: bool) -> np.ndarray:
    """Linear resampling of an NHWC float32 batch at half-pixel centres;
    ``widen`` widens the kernel by the downscale factor (antialias)."""
    x = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    wh = _weight_matrix(x.shape[1], out_h, widen)
    ww = _weight_matrix(x.shape[2], out_w, widen)
    out = torch.einsum("nhwc,hp,wq->npqc", x, wh, ww)
    return out.numpy().astype(np.float32)


def resize_batch(arr: np.ndarray, grid_size: int,
                 antialias: bool = True) -> np.ndarray:
    """Resize an NHWC batch to (grid_size, grid_size)."""
    if arr.shape[1] == grid_size and arr.shape[2] == grid_size:
        return np.asarray(arr, dtype=np.float32)
    if antialias:
        sig_h = _antialias_sigma(arr.shape[1], grid_size)
        sig_w = _antialias_sigma(arr.shape[2], grid_size)
        arr = gaussian_blur_batch(np.asarray(arr, np.float32), sig_h, sig_w)
    return linear_resize(arr, grid_size, grid_size, widen=not antialias)
