"""The proxy-FID extractor of the port is the JAX package's: its parameters
are stored as data (``domain_transfer_gan_torch/eval/fid_weights.npz``,
written by :func:`write_fid_weights` below from the JAX package on the CPU)
and must equal a fresh ``init`` of the JAX net; features, proxy-FID and
``eval_fid_B`` agree with the JAX package on the same images and z; the
extractor refuses what it does not hold.

Write the file again (only when the JAX extractor changes):

    JAX_PLATFORMS=cpu python -c "import sys; sys.path.insert(0, 'tests'); \\
        import test_torch_port_fid as t; t.write_fid_weights()"
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from domain_transfer_gan_tpu.eval import fid as jax_fid

from domain_transfer_gan_torch.eval import fid

from torch_port_helpers import (  # noqa: F401 (a fixture)
    images,
    latents,
    np_tree,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PROXY_FID_RTOL = 1e-4


def jax_extractor_params(in_ch):
    """The JAX default extractor's parameters for ``in_ch`` channels, as
    its ``random_feature_extractor`` draws them."""
    variables = jax_fid._RandomFeatureNet(fid.FID_WIDTH).init(
        jax.random.PRNGKey(fid.FID_SEED),
        jnp.zeros((1, 64, 64, in_ch), jnp.float32))
    return np_tree(variables["params"])


def write_fid_weights(path=fid.FID_WEIGHTS):
    """Write the stored extractor: conv1..conv3 once (flax draws them the
    same for every input channel count), conv0 for C = 1 .. 16."""
    out = {}
    for c in range(1, fid.FID_MAX_CHANNELS + 1):
        p = jax_extractor_params(c)
        out["conv0/kernel/c%d" % c] = p["conv0"]["kernel"]
        for i in (1, 2, 3):
            for leaf in ("kernel", "bias"):
                key = "conv%d/%s" % (i, leaf)
                if key in out:
                    np.testing.assert_array_equal(out[key], p["conv%d" % i][
                        leaf])
                out[key] = p["conv%d" % i][leaf]
        out["conv0/bias"] = p["conv0"]["bias"]
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in out.items()})


@pytest.mark.parametrize("in_ch", [1, 3])
def test_stored_weights_are_the_jax_init(in_ch):
    want = jax_extractor_params(in_ch)
    stored = fid._stored()
    np.testing.assert_array_equal(stored["conv0/kernel/c%d" % in_ch],
                                  want["conv0"]["kernel"])
    np.testing.assert_array_equal(stored["conv0/bias"], want["conv0"]["bias"])
    for i in (1, 2, 3):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(stored["conv%d/%s" % (i, leaf)],
                                          want["conv%d" % i][leaf])


def test_the_file_holds_every_channel_count_once():
    stored = fid._stored()
    assert sorted(k for k in stored if k.startswith("conv0/kernel/")) == \
        sorted("conv0/kernel/c%d" % c for c in range(1, 17))
    assert len(stored) == 16 + 1 + 6
    for c in range(1, 17):
        assert stored["conv0/kernel/c%d" % c].shape == (3, 3, c, 64)
    assert stored["conv3/kernel"].shape == (3, 3, 256, 256)
    assert all(v.dtype == np.float32 for v in stored.values())


@pytest.mark.parametrize("in_ch", [1, 3])
def test_proxy_fid_matches_jax_on_the_same_images(in_ch):
    real = images(80, 40, c=in_ch)
    fake = images(81, 40, c=in_ch) * 0.7
    port_ext = fid.random_feature_extractor(device="cpu")
    want_f = jax_fid.random_feature_extractor()(real)
    got_f = port_ext(real)
    assert got_f.shape == want_f.shape == (40, 256)
    assert np.abs(got_f - want_f).max() <= 1e-5 * np.abs(want_f).max()
    want = jax_fid.compute_fid(real, fake)
    got = fid.compute_fid(real, fake, device="cpu")
    assert abs(got - want) <= PROXY_FID_RTOL * abs(want), (got, want)


def test_what_the_extractor_does_not_hold_is_refused():
    ext = fid.random_feature_extractor(device="cpu")
    with pytest.raises(ValueError, match="1 to 16 input channels, got 17"):
        ext(np.zeros((2, 16, 16, 17), np.float32))
    with pytest.raises(ValueError, match="width 8 seed 1234"):
        fid.random_feature_extractor(width=8, device="cpu")
    with pytest.raises(ValueError, match="width 64 seed 7"):
        fid.random_feature_extractor(seed=7, device="cpu")
    # a state passed in needs no stored weights
    rng = np.random.RandomState(0)
    sd = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
          for k, v in fid.RandomFeatureNet(4, 17).state_dict().items()}
    got = fid.random_feature_extractor(width=4, device="cpu", state_dict=sd)(
        np.zeros((2, 16, 16, 17), np.float32))
    assert got.shape == (2, 16)


class _Decoder:
    """What ``eval_fid_B`` asks of a model, in either package: a fixed
    function of (A, z) in place of the generator; ``zs`` are the prior
    draws it hands out."""

    def __init__(self, nlatent, zs, torch_out=True):
        self.opt = SimpleNamespace(nlatent=nlatent)
        self.device = torch.device("cpu")
        self.zs, self.torch_out = list(zs), torch_out

    def sample_prior_z(self, n):
        z = self.zs.pop(0)
        assert z.shape == (n, self.opt.nlatent)
        return z

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, np.float32))

    def predict_B(self, A, z):
        A, z = np.asarray(A, np.float32), np.asarray(z, np.float32)
        out = np.tanh(A + z.mean(axis=1)[:, None, None, None])
        return torch.from_numpy(out) if self.torch_out else jnp.asarray(out)


def test_eval_fid_B_matches_jax_on_the_same_z():
    """Both packages' eval_fid_B over the same batches and the same z (fed
    through ``sample_prior_z``), n_max cutting the last batch."""
    batches = [{"A": images(82 + i, 16), "B": images(90 + i, 16)}
               for i in range(3)]
    zs = [latents(100 + i, 16, 8) for i in range(3)]
    jm, pm = _Decoder(8, zs, torch_out=False), _Decoder(8, zs)
    want = jax_fid.eval_fid_B(batches, jm, n_max=40)
    got = fid.eval_fid_B(batches, pm, n_max=40)
    assert abs(got - want) <= PROXY_FID_RTOL * abs(want), (got, want)


def test_eval_fid_B_with_a_seed_ignores_the_models_stream():
    batches = [{"A": images(83, 8), "B": images(84, 8)}]
    a = fid.eval_fid_B(batches, _Decoder(8, []), rng_seed=5)
    b = fid.eval_fid_B(batches, _Decoder(8, []), rng_seed=5)
    c = fid.eval_fid_B(batches, _Decoder(8, []), rng_seed=6)
    assert a == b and np.isfinite(a) and c != a
