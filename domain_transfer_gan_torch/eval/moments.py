"""Extractor-free distribution distances beside proxy-FID: the port's own
copy of the JAX package's ``eval/moments.py`` (pure numpy, so the two
agree to rounding).

- :func:`channel_moment_distance` compares the per-channel pixel-value
  distributions through their first four standardized moments (mean, std,
  skewness, excess kurtosis): global tone, contrast and shape mismatches a
  feature extractor can miss.
- :func:`radial_spectrum_distance` compares orientation-averaged log power
  spectra (2-D FFT, radially binned): blur, checkerboard artifacts and
  missing high-frequency texture.

Both score SETS of images, as FID does: lower is better, 0 iff the summary
statistics match.  They draw nothing and hold no weights, and only values
computed at the same image size compare.
"""

from __future__ import annotations

import numpy as np

__all__ = ["channel_moment_distance", "radial_spectrum_distance",
           "distribution_distances"]


def _check_sets(real, fake):
    real = np.asarray(real, dtype=np.float64)
    fake = np.asarray(fake, dtype=np.float64)
    if real.ndim != 4 or fake.ndim != 4:
        raise ValueError("expected (N, H, W, C) image sets, got shapes "
                         "%s and %s" % (real.shape, fake.shape))
    if real.shape[1:] != fake.shape[1:]:
        raise ValueError("image shapes differ: %s vs %s — these distances "
                         "are only meaningful at matched resolution"
                         % (real.shape[1:], fake.shape[1:]))
    return real, fake


def _channel_moments(x):
    """(N,H,W,C) -> (C, 4) [mean, std, skew, excess kurtosis] over all
    pixels of all images per channel."""
    flat = x.reshape(-1, x.shape[-1])            # (N*H*W, C)
    mean = flat.mean(axis=0)
    centered = flat - mean
    var = np.mean(centered ** 2, axis=0)
    std = np.sqrt(var)
    safe = np.where(std > 0, std, 1.0)
    skew = np.mean(centered ** 3, axis=0) / safe ** 3
    kurt = np.mean(centered ** 4, axis=0) / safe ** 4 - 3.0
    return np.stack([mean, std, skew, kurt], axis=1)


def channel_moment_distance(real, fake) -> float:
    """Mean absolute difference of per-channel standardized moments.

    Images are expected in a bounded range (the pipeline's [-1, 1]), so
    mean/std differences are already O(1)-commensurate with the
    dimensionless skew/kurtosis terms.
    """
    real, fake = _check_sets(real, fake)
    return float(np.mean(np.abs(_channel_moments(real)
                                - _channel_moments(fake))))


def _radial_log_spectrum(x, nbins):
    """(N,H,W,C) -> (nbins,) orientation-averaged log10 power spectrum.

    Power is averaged over images and channels first (the set's expected
    spectrum), then radially binned from DC outward; log10 compresses the
    natural-image 1/f^2 decay so every band contributes comparably.
    """
    n, h, w, c = x.shape
    power = np.zeros((h, w), dtype=np.float64)
    # per-image FFT keeps peak memory at one complex image per step
    for i in range(n):
        f = np.fft.fft2(x[i], axes=(0, 1))
        power += np.mean((f * np.conj(f)).real, axis=-1)
    power /= n
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    r = np.sqrt(fy ** 2 + fx ** 2)
    # bins span DC..Nyquist (r <= 0.5*sqrt(2) at the corners)
    edges = np.linspace(0.0, r.max() + 1e-12, nbins + 1)
    idx = np.clip(np.digitize(r.ravel(), edges) - 1, 0, nbins - 1)
    p = power.ravel()
    sums = np.bincount(idx, weights=p, minlength=nbins)
    counts = np.maximum(np.bincount(idx, minlength=nbins), 1)
    return np.log10(sums / counts + 1e-12)


def radial_spectrum_distance(real, fake, nbins: int | None = None) -> float:
    """Mean absolute log10 power-spectrum difference over radial bands."""
    real, fake = _check_sets(real, fake)
    if nbins is None:
        nbins = max(8, real.shape[1] // 2)
    return float(np.mean(np.abs(_radial_log_spectrum(real, nbins)
                                - _radial_log_spectrum(fake, nbins))))


def distribution_distances(real, fake) -> dict:
    """Both corroborating distances as a dict (quality-parity harness)."""
    return {"cmd": channel_moment_distance(real, fake),
            "rsd": radial_spectrum_distance(real, fake)}
