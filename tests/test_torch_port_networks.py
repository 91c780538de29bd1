"""The port's norm modules, residual blocks and generators against the JAX
modules, from the same numpy-drawn weights (carried across by
utils.convert.jax_params_to_state_dict) on the same numpy-drawn inputs.

fp32 on the CPU; atol 1e-4 on O(1) activations and tanh outputs (the same
convolutions and sums in another order, through up to ~14 layers).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from domain_transfer_gan_tpu.nn import blocks as jblocks
from domain_transfer_gan_tpu.nn import networks as jnets
from domain_transfer_gan_tpu.nn import norms as jnorms

from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.models import create_model
from domain_transfer_gan_torch.nn import blocks as tblocks
from domain_transfer_gan_torch.nn import networks as tnets
from domain_transfer_gan_torch.nn import norms as tnorms
from domain_transfer_gan_torch.utils.convert import jax_params_to_state_dict

from torch_port_helpers import images, latents, randomize

from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 1e-4
KEY = jax.random.PRNGKey(0)
NGF, NLATENT = 4, 8


def _load(module, params, net_name="netG_A_B"):
    module.load_state_dict(jax_params_to_state_dict(net_name, params),
                           strict=True)
    return module.eval().requires_grad_(False)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _features(seed, n=2, hw=16, c=8):
    return np.random.RandomState(seed).randn(n, hw, hw, c).astype(np.float32)


@pytest.mark.parametrize("fuse_relu", [False, True])
def test_instance_norm_module(fuse_relu):
    x = _features(0)
    jm = jnorms.InstanceNorm(8, fuse_relu=fuse_relu)
    p = randomize(jm.init(KEY, jnp.asarray(x))["params"], 1)
    want = jm.apply({"params": p}, jnp.asarray(x))
    tm = _load(tnorms.InstanceNorm(8, fuse_relu=fuse_relu), p)
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(want),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("fuse_relu", [False, True])
def test_cond_instance_norm_module(fuse_relu):
    x, z = _features(2), latents(3, 2, NLATENT)
    jm = jnorms.CondInstanceNorm(8, NLATENT, fuse_relu=fuse_relu)
    p = randomize(jm.init(KEY, jnp.asarray(x), jnp.asarray(z))["params"], 4)
    want = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(z))
    tm = _load(tnorms.CondInstanceNorm(8, NLATENT, fuse_relu=fuse_relu), p)
    got = tm(_nchw(x), torch.from_numpy(z))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("padding_type", ["reflect", "replicate", "zero"])
def test_resnet_block(padding_type):
    x = _features(5)
    jm = jblocks.ResnetBlock(8, padding_type=padding_type)
    p = randomize(jm.init(KEY, jnp.asarray(x), False)["params"], 6)
    want = jm.apply({"params": p}, jnp.asarray(x), False)
    tm = _load(tblocks.ResnetBlock(8, padding_type=padding_type), p)
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(want),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("padding_type", ["reflect", "replicate", "zero"])
def test_cin_resnet_block(padding_type):
    x, z = _features(7), latents(8, 2, NLATENT)
    jm = jblocks.CINResnetBlock(8, NLATENT, padding_type=padding_type)
    p = randomize(jm.init(KEY, jnp.asarray(x), jnp.asarray(z),
                          False)["params"], 9)
    want = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(z), False)
    tm = _load(tblocks.CINResnetBlock(8, NLATENT, padding_type=padding_type),
               p)
    got = tm(_nchw(x), torch.from_numpy(z))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_dropout_is_inactive_in_eval():
    """use_dropout keeps its module position and does nothing at
    train=False."""
    x = _features(10)
    jm = jblocks.ResnetBlock(8, use_dropout=True)
    p = randomize(jm.init(KEY, jnp.asarray(x), False)["params"], 11)
    want = jm.apply({"params": p}, jnp.asarray(x), False)
    tm = _load(tblocks.ResnetBlock(8, use_dropout=True), p)
    assert isinstance(tm.dropout, torch.nn.Dropout)
    np.testing.assert_allclose(_nhwc(tm(_nchw(x))), np.asarray(want),
                               rtol=0, atol=ATOL)


def _jax_G_A_B(n_blocks, use_pallas=False):
    return jnets.define_stochastic_G(NLATENT, 3, 3, NGF, n_blocks=n_blocks,
                                     use_pallas=use_pallas)


def _jax_G_B_A(n_blocks, use_pallas=False):
    return jnets.define_G(3, 3, NGF, n_blocks=n_blocks,
                          use_pallas=use_pallas)


@pytest.fixture(scope="module")
def cin_params():
    """JAX-structured params of G_A->B by n_blocks, numpy-drawn."""
    out = {}
    for nb in (1, 3):
        v = _jax_G_A_B(nb).init(KEY, jnp.zeros((1, 64, 64, 3)),
                                jnp.zeros((1, NLATENT)), False)
        out[nb] = randomize(v["params"], 20 + nb)
    return out


@pytest.fixture(scope="module")
def resnet_params():
    out = {}
    for nb in (1, 2):
        v = _jax_G_B_A(nb).init(KEY, jnp.zeros((1, 64, 64, 3)), False)
        out[nb] = randomize(v["params"], 30 + nb)
    return out


@pytest.mark.parametrize("n_blocks,use_pallas", [(3, False), (3, True),
                                                 (1, False)])
def test_cin_generator(cin_params, n_blocks, use_pallas):
    p = cin_params[n_blocks]
    x, z = images(40, 2), latents(41, 2, NLATENT)
    want = np.asarray(_jax_G_A_B(n_blocks, use_pallas).apply(
        {"params": p}, jnp.asarray(x), jnp.asarray(z), False))
    assert np.abs(want).mean() > 0.05  # outputs are not ~0
    net = _load(tnets.define_stochastic_G(NLATENT, 3, 3, NGF,
                                          n_blocks=n_blocks), p)
    got = net(torch.from_numpy(x), torch.from_numpy(z))
    assert got.shape == (2, 64, 64, 3) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # the plain-norm switch of the tests changes nothing on the CPU
    assert torch.equal(got, net(torch.from_numpy(x), torch.from_numpy(z),
                                plain_norm=True))
    assert tnets.count_params(net) == jnets.count_params(p)


def test_cin_generator_4d_z(cin_params):
    net = _load(tnets.define_stochastic_G(NLATENT, 3, 3, NGF, n_blocks=1),
                cin_params[1])
    x, z = images(42, 2), latents(43, 2, NLATENT)
    flat = net(torch.from_numpy(x), torch.from_numpy(z))
    four_d = net(torch.from_numpy(x),
                 torch.from_numpy(z.reshape(2, NLATENT, 1, 1)))
    assert torch.equal(flat, four_d)
    with pytest.raises(ValueError, match="z must be"):
        net(torch.from_numpy(x), torch.from_numpy(z[:, :-1]))


@pytest.mark.parametrize("n_blocks,use_pallas", [(2, False), (2, True),
                                                 (1, False)])
def test_resnet_generator(resnet_params, n_blocks, use_pallas):
    p = resnet_params[n_blocks]
    x = images(44, 2)
    want = np.asarray(_jax_G_B_A(n_blocks, use_pallas).apply(
        {"params": p}, jnp.asarray(x), False))
    assert np.abs(want).mean() > 0.05
    net = _load(tnets.define_G(3, 3, NGF, n_blocks=n_blocks), p, "netG_B_A")
    got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert tnets.count_params(net) == jnets.count_params(p)


def test_bf16_generator_tracks_jax_bf16(cin_params):
    """compute_dtype bfloat16: conv/Linear weights and activations bf16,
    norm statistics and affine fp32.  The two frameworks round at other
    places, so the port is held to the JAX bf16 net no tighter than that net
    is to its own fp32 run."""
    p = cin_params[3]
    x, z = images(45, 2), latents(46, 2, NLATENT)
    args = ({"params": p}, jnp.asarray(x), jnp.asarray(z), False)
    j32 = np.asarray(_jax_G_A_B(3).apply(*args))
    j16 = np.asarray(jnets.define_stochastic_G(
        NLATENT, 3, 3, NGF, dtype=jnp.bfloat16).apply(*args).astype(
            jnp.float32))
    net = _load(tnets.define_stochastic_G(NLATENT, 3, 3, NGF), p)
    net.place("cpu", torch.bfloat16)
    assert net.conv0.weight.dtype == torch.bfloat16
    assert net.cin0.shift_conv.weight.dtype == torch.bfloat16
    assert net.block0.norm2.scale.dtype == torch.float32
    got = net(torch.from_numpy(x), torch.from_numpy(z))
    assert got.dtype == torch.bfloat16
    budget = np.abs(j16 - j32)
    err = np.abs(got.float().numpy() - j16)
    assert err.mean() <= 2 * budget.mean() and err.max() <= 2 * budget.max()


def test_bf16_budget_at_full_width():
    """How far bfloat16 serving is from float32 at the published width
    (ngf 32, 3 blocks, nlatent 16, 64x64), measured on the JAX package's own
    generator: its bf16 run is more than 3e-2 away from its fp32 run at the
    worst pixel, so no port can be held to 3e-2 there.  chip_smoke.py's
    limits on |bf16 - fp32| must cover what the JAX package shows and the
    port, on the same weights, must stay within them."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    ngf, nlatent = 32, 16
    j_net = jnets.define_stochastic_G(nlatent, 3, 3, ngf, n_blocks=3)
    p = randomize(j_net.init(KEY, jnp.zeros((1, 64, 64, 3)),
                             jnp.zeros((1, nlatent)), False)["params"], 60)
    x, z = images(61, 2), latents(62, 2, nlatent)
    args = ({"params": p}, jnp.asarray(x), jnp.asarray(z), False)
    j32 = np.asarray(j_net.apply(*args))
    j16 = np.asarray(jnets.define_stochastic_G(
        nlatent, 3, 3, ngf, n_blocks=3, dtype=jnp.bfloat16).apply(
            *args).astype(jnp.float32))
    assert np.abs(j32).mean() > 0.05  # outputs are not ~0
    budget = np.abs(j16 - j32)
    print("JAX bf16 vs fp32 at full width: max %.4f mean %.5f"
          % (budget.max(), budget.mean()))
    assert 3e-2 < budget.max() <= smoke.BF16_MAX_ATOL
    assert budget.mean() <= smoke.BF16_MEAN_ATOL

    net = _load(tnets.define_stochastic_G(nlatent, 3, 3, ngf, n_blocks=3), p)
    t32 = net(torch.from_numpy(x), torch.from_numpy(z)).numpy()
    net.place("cpu", torch.bfloat16)
    t16 = net(torch.from_numpy(x), torch.from_numpy(z)).float().numpy()
    err = np.abs(t16 - t32)
    print("port bf16 vs fp32 at full width: max %.4f mean %.5f"
          % (err.max(), err.mean()))
    assert err.max() <= smoke.BF16_MAX_ATOL
    assert err.mean() <= smoke.BF16_MEAN_ATOL


@pytest.mark.parametrize("model", ["aug_cycle_gan", "stoch_cycle_gan",
                                   "cycle_gan"])
def test_model_predict_matches_jax_nets(cin_params, resnet_params, model):
    """create_model for the three variants; cycle_gan forces z := ones."""
    cfg = TrainConfig(model=model, grid_size=64, ngf=NGF, nlatent=NLATENT,
                      n_blocks=1, seed=3)
    m = create_model(cfg, testing=True, device="cpu")
    m.load_jax_params("netG_A_B", cin_params[1])
    m.load_jax_params("netG_B_A", resnet_params[1])
    assert m.ignore_noise == (model == "cycle_gan")
    A, B, z = images(47, 2), images(48, 2), latents(49, 2, NLATENT)
    z_used = np.ones_like(z) if model == "cycle_gan" else z
    want_B = _jax_G_A_B(1).apply({"params": cin_params[1]}, jnp.asarray(A),
                                 jnp.asarray(z_used), False)
    want_A = _jax_G_B_A(1).apply({"params": resnet_params[1]},
                                 jnp.asarray(B), False)
    np.testing.assert_allclose(m.predict_B(A, z).numpy(),
                               np.asarray(want_B), rtol=0, atol=ATOL)
    np.testing.assert_allclose(m.predict_A(B).numpy(), np.asarray(want_A),
                               rtol=0, atol=ATOL)


def test_generate_multi_and_cycle_B_multi(cin_params, resnet_params):
    cfg = TrainConfig(model="aug_cycle_gan", grid_size=64, ngf=NGF,
                      nlatent=NLATENT, n_blocks=1, seed=3)
    m = create_model(cfg, testing=True, device="cpu")
    m.load_jax_params("netG_A_B", cin_params[1])
    m.load_jax_params("netG_B_A", resnet_params[1])
    A, B, z = images(50, 2), images(51, 2), latents(52, 6, NLATENT)
    multi = m.generate_multi(A, z)
    assert multi.shape == (6, 64, 64, 3)
    # sample i is decoded with z's 3i .. 3i+2, as jnp.repeat tiles it
    want = m.predict_B(np.repeat(A, 3, axis=0), z)
    assert torch.equal(multi, want)
    fake_A, multi_B = m.generate_cycle_B_multi(B, z)
    assert torch.equal(fake_A, m.predict_A(B))
    assert torch.equal(multi_B, m.predict_B(
        fake_A.repeat_interleave(3, dim=0), z))


def test_what_waits_for_the_training_slice():
    """Every variant trains now; what still waits raises and says so."""
    kw = dict(grid_size=64, ngf=NGF, nef=NGF, ndf=NGF, nlatent=NLATENT,
              n_blocks=1)
    for model in ("stoch_cycle_gan", "cycle_gan"):
        m = create_model(TrainConfig(model=model, **kw), testing=False,
                         device="cpu")
        assert set(m.nets) == {"netG_A_B", "netG_B_A", "netD_A", "netD_B"}
        assert callable(m.train_instance) and callable(m.generate_cycle)
        assert not hasattr(m, "supervised_train_instance")
    aug = create_model(TrainConfig(model="aug_cycle_gan", **kw),
                       testing=False, device="cpu")
    assert set(aug.nets) == {"netG_A_B", "netG_B_A", "netD_A", "netD_B",
                             "netD_z_B", "netE_B"}
    assert callable(aug.supervised_train_instance)
    with pytest.raises(ValueError, match="must be >= 64"):
        create_model(TrainConfig(model="aug_cycle_gan", **dict(
            kw, grid_size=32)), testing=True, device="cpu")
    with pytest.raises(KeyError, match="unknown network"):
        jax_params_to_state_dict("netD_C", {})
    with pytest.raises(NotImplementedError, match="not implemented"):
        create_model(TrainConfig(model="pix2pix", **kw), device="cpu")


@pytest.mark.parametrize("scheme", ["reference", "sane"])
def test_init_schemes(cin_params, scheme):
    """Same names and shapes as the converted JAX tree, and the JAX init's
    distributions (the values differ: the frameworks draw other numbers from
    a seed).  The reference scheme draws kernels and InstanceNorm scales
    ~ N(0, 0.02); the sane scheme draws kernels with variance 1/fan_in
    (fan_in = kh*kw*Cin, as flax's lecun_normal on the (kh, kw, Cin, Cout)
    kernel) and sets the InstanceNorm scale to 1.  Biases and shifts are 0
    in both."""
    g = torch.Generator().manual_seed(0)
    small = tnets.define_stochastic_G(NLATENT, 3, 3, NGF, init_scheme=scheme,
                                      generator=g).state_dict()
    want = jax_params_to_state_dict("netG_A_B", cin_params[3])
    assert {k: v.shape for k, v in small.items()} == \
        {k: v.shape for k, v in want.items()}

    g = torch.Generator().manual_seed(0)
    sd = tnets.define_stochastic_G(NLATENT, 3, 3, 32, init_scheme=scheme,
                                   generator=g).state_dict()
    fan_in = {"conv2.weight": 9 * 64, "block0.conv1.weight": 9 * 128,
              "up0.weight": 9 * 128, "cin2.scale_conv.weight": NLATENT}
    for k, f in fan_in.items():
        w = sd[k].double()
        std = 0.02 if scheme == "reference" else f ** -0.5
        # 5 standard errors of the mean / 10% on the standard deviation
        assert abs(float(w.mean())) <= 5 * std / w.numel() ** 0.5, k
        assert abs(float(w.std()) - std) <= 0.1 * std, k
        if scheme == "sane":  # truncated at two standard deviations
            assert float(w.abs().max()) <= 2 * std / 0.87962566 + 1e-6, k
    scale = sd["block1.norm2.scale"]
    if scheme == "reference":
        assert abs(float(scale.std()) - 0.02) <= 0.01
        assert abs(float(scale.mean())) <= 0.01
    else:
        assert torch.equal(scale, torch.ones_like(scale))
    for k in ("conv1.bias", "cin0.shift_conv.bias", "block1.norm2.shift"):
        assert not sd[k].any(), k
    # the same seed draws the same weights, another seed other ones
    again = tnets.define_stochastic_G(
        NLATENT, 3, 3, 32, init_scheme=scheme,
        generator=torch.Generator().manual_seed(0)).state_dict()
    other = tnets.define_stochastic_G(
        NLATENT, 3, 3, 32, init_scheme=scheme,
        generator=torch.Generator().manual_seed(1)).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["conv2.weight"], other["conv2.weight"])
