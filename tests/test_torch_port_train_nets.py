"""The networks the training slice adds (both discriminators, the latent
discriminator, the latent encoder, ``--norm batch`` generators) against the
JAX package: forward parity from converted JAX params in train and eval mode,
and the batch-norm running statistics after one train-mode forward."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from domain_transfer_gan_tpu.nn import networks as jnets

from domain_transfer_gan_torch.nn import networks as tnets
from domain_transfer_gan_torch.nn.layers import Dropout
from domain_transfer_gan_torch.nn.norms import BatchNorm1d, BatchNorm2d
from domain_transfer_gan_torch.utils.convert import (
    jax_batch_stats_to_buffers,
    jax_params_to_state_dict,
)

from torch_port_helpers import images, latents, np_tree, randomize

from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 1e-4  # fp32, O(1) outputs through up to six conv + norm layers
NLATENT, NDF = 8, 4
KEY = jax.random.PRNGKey(0)

# name -> (JAX module, port module, input maker)
CASES = {
    "netD_A": lambda norm: (
        jnets.define_D_A(3, 8, norm=norm, use_sigmoid=norm == "batch"),
        tnets.define_D_A(3, 8, norm=norm, use_sigmoid=norm == "batch"),
        lambda: (images(1, 4),)),
    "netD_B": lambda norm: (
        jnets.define_D_B(3, NDF, norm=norm), tnets.define_D_B(3, NDF,
                                                              norm=norm),
        lambda: (images(2, 4),)),
    "netG_B_A": lambda norm: (
        jnets.define_G(3, 3, 4, norm=norm, n_blocks=1),
        tnets.define_G(3, 3, 4, norm=norm, n_blocks=1),
        lambda: (images(3, 4),)),
    "netD_z_B": lambda norm: (
        jnets.define_LAT_D(NLATENT, NDF, use_sigmoid=True),
        tnets.define_LAT_D(NLATENT, NDF, use_sigmoid=True),
        lambda: (latents(4, 4, NLATENT),)),
    "netE_B": lambda norm: (
        jnets.define_E(NLATENT, 6, 4), tnets.define_E(NLATENT, 6, 4),
        lambda: (images(5, 4, c=6),)),
}


def _setup(name, norm, seed):
    jm, tm, make = CASES[name](norm)
    xs = make()
    variables = jm.init(KEY, *map(jnp.asarray, xs), False)
    params = randomize(variables["params"], seed)
    stats = np_tree(variables.get("batch_stats", {}))
    rng = np.random.RandomState(seed + 1)
    # running statistics away from their (0, 1) start
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.rand(*v.shape) + 0.5 if path[-1].key == "var"
                         else 0.3 * rng.randn(*v.shape)).astype(np.float32),
        stats)
    sd = jax_params_to_state_dict(name, params)
    sd.update(jax_batch_stats_to_buffers(name, stats))
    tm.load_state_dict(sd, strict=True)
    return jm, tm, xs, params, stats


def _out(o):
    o = o if isinstance(o, tuple) else (o,)
    return [np.asarray(a) if not isinstance(a, torch.Tensor)
            else a.detach().numpy() for a in o]


@pytest.mark.parametrize("name,norm", [
    ("netD_A", "instance"), ("netD_A", "batch"), ("netD_B", "instance"),
    ("netD_B", "batch"), ("netG_B_A", "batch"), ("netD_z_B", "-"),
    ("netE_B", "-")])
def test_forward_and_running_stats(name, norm):
    jm, tm, xs, params, stats = _setup(name, norm, seed=len(name))
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    # eval mode: the running statistics are used, and stay
    want = jm.apply(variables, *map(jnp.asarray, xs), False)
    got = tm.eval()(*map(torch.from_numpy, xs))
    for g, w in zip(_out(got), _out(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    # train mode: batch statistics, and the running ones advance once
    want, mut = jm.apply(variables, *map(jnp.asarray, xs), True,
                         mutable=["batch_stats"])
    got = tm.train()(*map(torch.from_numpy, xs))
    for g, w in zip(_out(got), _out(want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    new = jax_batch_stats_to_buffers(name, np_tree(mut.get("batch_stats",
                                                           {})))
    buffers = dict(tm.named_buffers())
    assert set(new) == set(buffers)
    assert bool(stats) == (norm != "instance")
    for k, w in new.items():
        # fp32 means of at most 4 * 32 * 32 values, momentum 0.9
        np.testing.assert_allclose(buffers[k].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_running_variance_is_the_biased_one():
    """flax stores the biased batch variance in its running average;
    torch.nn.BatchNorm1d would store the unbiased one (2x at batch 2)."""
    bn = BatchNorm1d(3).train()
    x = torch.tensor([[0.0, 1.0, 2.0], [2.0, 1.0, -2.0]])
    bn(x)
    np.testing.assert_allclose(
        bn.bn.running_var.numpy(),
        0.9 * 1.0 + 0.1 * np.array([1.0, 0.0, 4.0]), rtol=1e-6)
    np.testing.assert_allclose(bn.bn.running_mean.numpy(),
                               0.1 * np.array([1.0, 1.0, 0.0]), rtol=1e-6)


def test_batch_norm_statistics_stay_float32_under_bfloat16():
    bn = BatchNorm2d(4).train()
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 4, 8, 8).astype(
        np.float32))
    y32 = bn(x)
    y16 = bn(x.to(torch.bfloat16))
    assert y16.dtype == torch.bfloat16
    assert bn.bn.running_mean.dtype == torch.float32
    assert float((y16.float() - y32).abs().max()) <= 4e-2


@pytest.mark.parametrize("name", ["netD_A", "netD_B", "netE_B", "netD_z_B"])
def test_bfloat16_compute_keeps_float32_parameters(name):
    """Training placement: parameters stay float32, the layers cast them per
    use, gradients arrive in float32."""
    _, tm, xs, _, _ = _setup(name, "instance", seed=7)
    tm.place("cpu", torch.bfloat16, cast_weights=False).train()
    out = tm(*map(torch.from_numpy, xs))
    out = out if isinstance(out, tuple) else (out,)
    assert all(o.dtype == torch.bfloat16 for o in out)
    grads = torch.autograd.grad(sum(o.float().sum() for o in out),
                                list(tm.parameters()))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(g.dtype == torch.float32 for g in grads)


@pytest.mark.parametrize("scheme", ["reference", "sane"])
def test_init_of_the_new_nets(scheme):
    """Names, shapes and the init's moments: BatchNorm2d scale ~ N(1, .02)
    and the latent discriminator's Linear ~ U(+-1/sqrt(fan_in)) under
    ``reference``; ones / LeCun-normal with zero bias under ``sane``."""
    g = torch.Generator().manual_seed(1)
    enc = tnets.define_E(NLATENT, 6, 16, init_scheme=scheme, generator=g)
    lat = tnets.define_LAT_D(16, 64, init_scheme=scheme, generator=g)
    jenc = jnets.define_E(NLATENT, 6, 16).init(
        KEY, jnp.zeros((2, 64, 64, 6)), False)
    sd = jax_params_to_state_dict("netE_B", np_tree(jenc["params"]))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in enc.named_parameters()}
    scale = enc.nr3.norm.bn.weight.detach()
    w, b = lat.fc1.weight.detach(), lat.fc1.bias.detach()
    if scheme == "reference":
        assert abs(float(scale.mean()) - 1.0) < 0.01
        assert 0.01 < float(scale.std()) < 0.03
        assert float(w.abs().max()) <= 1 / 8 and float(w.std()) > 0.06
        assert 0 < float(b.abs().max()) <= 1 / 8
    else:
        assert torch.equal(scale, torch.ones_like(scale))
        assert abs(float(w.std()) - 1 / 8) < 0.01
        assert torch.equal(b, torch.zeros_like(b))
    assert torch.equal(lat.bn1.bn.weight.detach(), torch.ones(64))


def test_dropout_masks_of_the_two_generators_are_independent():
    """Both generators draw from ONE generator stream, so they never share a
    mask; the same seed reproduces both."""
    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        w = torch.Generator().manual_seed(0)
        a = tnets.define_G(3, 3, 4, use_dropout=True, n_blocks=1,
                           init_scheme="sane", generator=w)
        b = tnets.define_G(3, 3, 4, use_dropout=True, n_blocks=1,
                           init_scheme="sane", generator=w)
        b.load_state_dict(a.state_dict())
        for net in (a, b):
            net.set_dropout_generator(gen).train()
        x = torch.from_numpy(images(6, 2))
        return a(x), b(x), a.eval()(x), b.eval()(x)

    ya, yb, ea, eb = run(5)
    assert torch.equal(ea, eb)          # same weights, dropout off
    assert float((ya - yb).abs().max()) > 0.0   # other masks in train mode
    ya2, yb2, _, _ = run(5)
    assert torch.equal(ya, ya2) and torch.equal(yb, yb2)
    drop = Dropout(0.5).train()
    drop.generator = torch.Generator().manual_seed(1)
    y = drop(torch.ones(1000))
    assert set(y.unique().tolist()) == {0.0, 2.0}
    assert 400 < int((y == 0).sum()) < 600
