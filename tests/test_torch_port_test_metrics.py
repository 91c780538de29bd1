"""The evaluation CLI's metrics against the JAX package's functions on the
same weights and inputs (tiny nets, 64x64), each fed the JAX functions' own
random draws: ``train_logvar``, the MVGauss BPP baseline,
``sensitivity_to_edge_noise``, ``compute_train_kld``, the random-feature
FID (features and distance, the JAX extractor's parameters converted into
the port's net) and ``z_diversity_stats``.

The JAX models are built without their initializers (flax's run op by op
here): a model object gets the numpy-drawn parameters, and its key, whose
splits the port is handed as draws."""

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from domain_transfer_gan_tpu.config import TrainConfig as JaxConfig
from domain_transfer_gan_tpu.data import AlignedIterator as JaxAligned
from domain_transfer_gan_tpu.eval import diversity as jax_diversity
from domain_transfer_gan_tpu.eval import fid as jax_fid
from domain_transfer_gan_tpu.eval import metrics as jax_metrics
from domain_transfer_gan_tpu.models import api as jax_api

from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.data import AlignedIterator
from domain_transfer_gan_torch.eval import diversity, fid, metrics
from domain_transfer_gan_torch.models import create_model
from domain_transfer_gan_torch.utils.convert import \
    jax_fid_params_to_state_dict

from torch_port_helpers import (  # noqa: F401 (a fixture)
    images,
    jax_nets_and_weights,
    np_tree,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = dict(grid_size=64, ngf=4, nef=4, ndf=4, nlatent=8, batchSize=4)


def _pair(model_name, seed=60):
    """A JAX model object and a port model holding the same weights."""
    jcfg = JaxConfig(use_pallas=False, model=model_name, **TINY)
    nets, params, stats = jax_nets_and_weights(jcfg, seed)
    cls = (jax_api.AugmentedCycleGAN if model_name == "aug_cycle_gan"
           else jax_api.StochCycleGAN)
    jm = object.__new__(cls)
    jm.opt, jm.nets, jm.training, jm._jit_cache = jcfg, nets, True, {}
    jm.ignore_noise = model_name == "cycle_gan"
    jm._rng = jax.random.PRNGKey(seed)
    jm.state = SimpleNamespace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    model = create_model(TrainConfig(model=model_name, **TINY), testing=True,
                         device="cpu")
    for k in params:
        model.load_jax_params(k, params[k])
        model.load_jax_batch_stats(k, np_tree(stats[k]))
    return jm, model


def _next_keys(jm, n):
    """The next ``n`` keys ``jm.next_key()`` will hand out, without
    drawing them."""
    rng, keys = jm._rng, []
    for _ in range(n):
        rng, k = jax.random.split(rng)
        keys.append(k)
    return keys


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1e-30, np.abs(b).max()))


@pytest.mark.parametrize("model_name", ["aug_cycle_gan", "stoch_cycle_gan"])
def test_train_logvar_matches_jax(model_name, capsys):
    """Two batches, one RMSprop step each.  The UBO of step 1 (the
    starting logvar_B) agrees to 1e-5 relative; the fitted logvar_B to lr
    per entry: RMSprop's first update is 10 lr * sign(g), and g is a mean
    of per-pixel terms whose Laplace part flips sign where |B - fake_B| =
    0.1, which the two packages' ~1e-4 generator differences can move."""
    jm, model = _pair(model_name)
    A, B = images(61, 6), images(62, 6)
    draws = []
    for key in _next_keys(jm, 2):
        k_deq, k_eps = jax.random.split(key)
        draws.append((np.asarray(jax.random.uniform(
            k_deq, (3, 64, 64, 3), jnp.float32, 0.0, 1.0 / 127.5)),
            np.asarray(jax.random.normal(k_eps, (3, 8), jnp.float32))))
    want = np.asarray(jax_metrics.train_logvar(JaxAligned(A, B, 3), jm))
    j_lines = capsys.readouterr().out.splitlines()
    got = metrics.train_logvar(AlignedIterator(A, B, 3), model,
                               draws=draws).numpy()
    t_lines = capsys.readouterr().out.splitlines()
    ubo = [[float(ln.split(",")[0].split()[1]) for ln in lines]
           for lines in (t_lines, j_lines)]
    assert len(ubo[0]) == len(ubo[1]) == 2
    assert abs(ubo[0][0] - ubo[1][0]) <= 1e-5 * abs(ubo[1][0]), ubo
    assert abs(ubo[0][1] - ubo[1][1]) <= 1e-3 * abs(ubo[1][1]), ubo
    assert got.shape == want.shape == (1, 64, 64, 3)
    assert np.abs(got - want).max() <= metrics.RMS_LR * 1.001


def test_mvgauss_bpp_matches_jax():
    A, B = images(63, 7), images(64, 7)
    tA, tB = images(65, 5), images(66, 5)
    want = jax_metrics.compute_bpp_mvgauss_B(JaxAligned(A, B, 3),
                                             JaxAligned(tA, tB, 2))
    got = metrics.compute_bpp_mvgauss_B(AlignedIterator(A, B, 3),
                                        AlignedIterator(tA, tB, 2))
    assert abs(got - want) <= 1e-6 * abs(want), (got, want)


@pytest.mark.parametrize("model_name", ["stoch_cycle_gan", "aug_cycle_gan"])
def test_sensitivity_to_edge_noise_matches_jax(model_name, tmp_path):
    """The JAX noisy cycle draws a prior z then the noise per std
    (``stoch_cycle_gan``), or the noise only and the posterior mean
    (``aug_cycle_gan``); the port is handed the same draws."""
    jm, model = _pair(model_name)
    B = images(67, 3)
    stoch = model_name != "aug_cycle_gan"
    keys = iter(_next_keys(jm, 16 if stoch else 8))
    draws = []
    for _ in metrics.NOISE_STDS:
        d = {}
        if stoch:
            d["z"] = torch.from_numpy(np.asarray(jax.random.normal(
                next(keys), (3, 8))))
        d["noise"] = np.asarray(jax.random.normal(next(keys), B.shape))
        draws.append(d)
    want = jax_metrics.sensitivity_to_edge_noise(
        jm.opt, jm, B, save_path=str(tmp_path / "jax.npy"))
    got = metrics.sensitivity_to_edge_noise(
        model.opt, model, B, save_path=str(tmp_path / "port.npy"),
        draws=draws)
    assert np.abs(np.asarray(got) - np.asarray(want)).max() <= 1e-4
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), got)
    assert np.asarray(got).shape == (8, 3)


def test_compute_train_kld_matches_jax():
    jm, model = _pair("aug_cycle_gan")
    A, B = images(68, 5), images(69, 5)
    want = jax_metrics.compute_train_kld(JaxAligned(A, B, 2), jm)
    got = metrics.compute_train_kld(AlignedIterator(A, B, 2), model)
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)


@pytest.fixture(scope="module")
def extractors():
    """The JAX default extractor and the port's net holding its converted
    parameters, both on the CPU."""
    variables = jax_fid._RandomFeatureNet(64).init(
        jax.random.PRNGKey(1234), jnp.zeros((1, 64, 64, 3), jnp.float32))
    sd = jax_fid_params_to_state_dict(np_tree(variables["params"]))
    return (jax_fid.random_feature_extractor(),
            fid.random_feature_extractor(device="cpu", state_dict=sd))


def test_fid_features_and_distance_match_jax(extractors):
    jax_ext, port_ext = extractors
    real, fake = images(70, 70), images(71, 70) * 0.8
    want, got = jax_ext(real), port_ext(real)
    assert got.shape == want.shape == (70, 256)
    assert _rel(got, want) <= 1e-5
    d_want = jax_fid.compute_fid(real, fake, extractor=jax_ext)
    d_got = fid.compute_fid(real, fake, extractor=port_ext)
    assert abs(d_got - d_want) <= 1e-4 * abs(d_want), (d_got, d_want)
    mu, sigma = fid.activation_statistics(want)
    assert fid.frechet_distance(mu, sigma, mu, sigma) == pytest.approx(
        0.0, abs=1e-6)


def test_z_diversity_stats_match_jax(extractors):
    jax_ext, port_ext = extractors
    multi = images(72, 12)
    want = jax_diversity.z_diversity_stats(multi, 3, extractor=jax_ext)
    got = diversity.z_diversity_stats(multi, 3, extractor=port_ext)
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-5 * abs(w), (k, got[k], w)


def test_the_ports_own_extractor_is_seeded_lecun_normal():
    """The default extractor holds the JAX package's draw from seed 1234
    (stored, tests/test_torch_port_fid.py), flax's default conv init:
    LeCun normal, zero bias; it gives the same features on every call; a
    z-ignoring decode scores intra_z = 0."""
    sd = fid.stored_extractor_state(3)
    w = sd["conv1.weight"].numpy()
    assert abs(w.std() * math.sqrt(9 * 64) - 1.0) < 0.05
    assert float(sd["conv1.bias"].abs().max()) == 0.0
    a = fid.random_feature_extractor(device="cpu")
    b = fid.random_feature_extractor(device="cpu")
    x = images(73, 5)
    np.testing.assert_array_equal(a(x), b(x))
    same = np.repeat(images(74, 2), 3, axis=0)
    div = diversity.z_diversity_stats(same, 3, extractor=a)
    assert div["intra_z"] == 0.0 and div["inter_input"] > 0
