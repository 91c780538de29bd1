"""The supervised step of ``aug_cycle_gan``: two steps of the port's
``supervised_train_instance`` against two steps of the JAX
``make_aug_supervised_step`` from the same weights, batch-norm statistics,
inputs, ``prior_z``, ``eps_post`` and netD_B Adam moments, and what the step
must do besides: the zero-gradient Adam step on netD_B, no ``state.step``
advance, one encoder running-statistics update per step."""

import copy

import numpy as np
import pytest
import torch

from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.models import create_model

from torch_port_helpers import (
    TINY,
    check_two_step_parity,
    images,
    latents,
    run_both_train_steps,
)

from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KEYS = ["S_A", "S_B", "KLD_z_B", "D_z_B", "gnorm_G_A_B", "gnorm_G_B_A",
        "gnorm_E_B", "gnorm_D_z_B"]


@pytest.fixture(scope="module")
def run():
    return run_both_train_steps({}, kind="sup", d_B_moments=True)


def test_two_steps_match_the_jax_step(run):
    """netD_A takes no step; netD_B moves by its zero-gradient Adam steps
    (its moments start nonzero), as the JAX step moves it."""
    check_two_step_parity(run, frozen=("netD_A",))


def test_keys_step_and_adam_counts(run):
    st = run["steps"][0]
    assert st["loss_keys"] + st["gnorm_keys"] == KEYS
    model = run["model"]
    # the supervised step advances no step count; netD_B's Adam count
    # advances with the zero-gradient step (from 3), netD_A's stays
    assert model.state.step == run["jax_step"] == 0
    counts = {k: o.count for k, o in model.state.opt_state.items()}
    assert counts == run["jax_counts"] == dict(
        netG_A_B=2, netG_B_A=2, netE_B=2, netD_z_B=2, netD_B=5, netD_A=0)


def _model(**flags):
    cfg = dict(TINY, init_scheme="sane", seed=8, **flags)
    return create_model(TrainConfig(**cfg), testing=True, device="cpu")


@pytest.mark.parametrize("stoch_enc", [False, True])
def test_encoder_statistics_advance_once(stoch_enc):
    """netE_B's running statistics after one supervised step are those of
    ONE train-mode forward on (A, B); netD_z_B's advance three times (the
    posterior and the prior in its D phase, the posterior in the G phase)."""
    m = _model(stoch_enc=stoch_enc)
    A, B = images(1, 4), images(2, 4)
    enc = copy.deepcopy(m.nets["netE_B"]).train()
    with torch.no_grad():
        enc(torch.cat([torch.from_numpy(A), torch.from_numpy(B)], dim=-1))
    before = {k: v.clone() for k, v in m.nets["netD_z_B"].named_buffers()}
    out = m.supervised_train_instance(A, B, latents(3, 4, 8),
                                      latents(4, 4, 8))
    assert list(out) == KEYS and all(np.isfinite(float(v))
                                     for v in out.values())
    assert float(out["KLD_z_B"]) > 0 and float(out["gnorm_D_z_B"]) > 0
    for k, v in enc.named_buffers():
        assert torch.equal(dict(m.nets["netE_B"].named_buffers())[k], v), k
    moved = [k for k, v in m.nets["netD_z_B"].named_buffers()
             if "running_mean" in k and not torch.equal(v, before[k])]
    assert moved


def test_zero_gradient_adam_step_on_netD_B():
    """netD_B moves by exactly Adam's update on a zero gradient: the first
    moment decays by beta1, the second by beta2, bias-corrected at the
    advanced count; before any moment exists it does not move."""
    m = _model()
    A, B = images(5, 4), images(6, 4)
    params = list(m.nets["netD_B"].parameters())
    start = [p.detach().clone() for p in params]
    m.supervised_train_instance(A, B)
    assert all(torch.equal(p, q) for p, q in zip(params, start))
    state = m.state.opt_state["netD_B"]
    assert state.count == 1 and all(float(t.abs().max()) == 0
                                    for t in state.mu + state.nu)
    g = torch.Generator().manual_seed(0)
    for t in state.mu:
        t.copy_(0.1 * torch.randn(t.shape, generator=g))
    for t in state.nu:
        t.copy_(torch.randn(t.shape, generator=g) ** 2)
    mu0 = [t.clone() for t in state.mu]
    nu0 = [t.clone() for t in state.nu]
    start = [p.detach().clone() for p in params]
    m.supervised_train_instance(A, B)
    b1, b2, lr_d, t = 0.5, 0.999, m.old_lr_d, 2
    for p, p0, mu, nu in zip(params, start, mu0, nu0):
        mu_hat = b1 * mu / (1 - b1 ** t)
        nu_hat = b2 * nu / (1 - b2 ** t)
        want = p0 - lr_d * mu_hat / (torch.sqrt(nu_hat) + 1e-8)
        torch.testing.assert_close(p.detach(), want, rtol=0, atol=1e-7)
    assert m.state.step == 0


def test_generation_helpers_of_the_augmented_model():
    """generate_noisy_cycle decodes the noisy A with the posterior z of the
    clean (A, B); generate_multi_cycle draws from the prior or, with
    ``from_prior=False``, uses the posterior."""
    m = _model()
    B = images(7, 2)
    noise = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    fake_A = m.predict_A(B)
    post = m._posterior_z(fake_A, B)
    noisy = torch.clamp(fake_A + 2 / 127.5 * torch.from_numpy(noise), -1, 1)
    assert torch.equal(m.generate_noisy_cycle(B, 2, noise),
                       m.predict_B(noisy, post))
    imgs = m.generate_multi_cycle(B, 2, from_prior=False)
    assert len(imgs) == 5
    assert torch.equal(imgs[2], m.predict_B(imgs[1], m._posterior_z(
        imgs[1], imgs[0])))
    twin = _model()
    imgs = m.generate_multi_cycle(B, 1)
    A1 = twin.predict_A(B)
    assert torch.equal(imgs[2], twin.predict_B(A1, twin.sample_prior_z(2)))
