"""``eval/moments.py`` of the port (its own numpy copy) against the JAX
package's on the same image sets: every distance within 1e-12."""

import numpy as np
import pytest

from domain_transfer_gan_tpu.eval import moments as jax_moments

from domain_transfer_gan_torch.eval import moments

from torch_port_helpers import images

ATOL = 1e-12


def _sets(c=3, hw=16):
    real = images(300, 6, hw=hw, c=c)
    fake = np.tanh(1.3 * images(301, 5, hw=hw, c=c))
    return real, fake


@pytest.mark.parametrize("c,hw", [(3, 16), (1, 64), (16, 8)])
def test_distances_match_jax(c, hw):
    real, fake = _sets(c, hw)
    for fn in ("channel_moment_distance", "radial_spectrum_distance"):
        want = getattr(jax_moments, fn)(real, fake)
        got = getattr(moments, fn)(real, fake)
        assert abs(got - want) <= ATOL, (fn, got, want)
    for nbins in (8, 13):
        want = jax_moments.radial_spectrum_distance(real, fake, nbins=nbins)
        got = moments.radial_spectrum_distance(real, fake, nbins=nbins)
        assert abs(got - want) <= ATOL
    want = jax_moments.distribution_distances(real, fake)
    got = moments.distribution_distances(real, fake)
    assert set(got) == set(want) == {"cmd", "rsd"}
    for k in want:
        assert abs(got[k] - want[k]) <= ATOL, k


def test_same_set_scores_zero_and_bad_sets_are_refused():
    real, _ = _sets()
    assert moments.channel_moment_distance(real, real) == 0.0
    assert moments.radial_spectrum_distance(real, real) == 0.0
    const = np.zeros((2, 8, 8, 3), np.float32)  # std 0: no division by it
    assert np.isfinite(moments.channel_moment_distance(const, const + 0.5))
    with pytest.raises(ValueError, match="image shapes differ"):
        moments.channel_moment_distance(real, real[:, :8])
    with pytest.raises(ValueError, match="expected"):
        moments.radial_spectrum_distance(real[0], real[0])
