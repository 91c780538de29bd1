"""The slice as a whole: two steps of the port's ``train_instance`` against
two steps of the JAX ``make_aug_train_step`` from the same weights, batch-norm
statistics, inputs, ``prior_z`` and ``eps_post`` (default flags; the flag
variants are in tests/test_torch_port_train_variants*.py), and the training
model's API around the step."""

import numpy as np
import pytest
import torch

from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.models import AugmentedCycleGAN, create_model

from torch_port_helpers import (
    TINY,
    check_two_step_parity,
    images,
    latents,
    run_both_train_steps,
)

from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_KEYS = ["D_A", "G_A", "Cyc_A", "Cyc_z_B", "KLD_z_B", "D_B", "G_B",
             "Cyc_B", "D_z_B", "P_t_A", "P_f_A", "P_t_B", "P_f_B"]
GNORM_KEYS = ["gnorm_G_A_B", "gnorm_G_B_A", "gnorm_E_B", "gnorm_D_B",
              "gnorm_D_z_B", "gnorm_D_A", "mu_min", "mu_max", "logvar_min",
              "logvar_max"]


@pytest.fixture(scope="module")
def run():
    return run_both_train_steps({})


def test_two_steps_match_the_jax_step(run):
    check_two_step_parity(run)


def test_keys_order_and_visuals(run):
    st = run["steps"][0]
    assert st["loss_keys"] == LOSS_KEYS and st["gnorm_keys"] == GNORM_KEYS
    assert list(st["visuals"]) == ["real_A", "fake_B", "rec_A", "real_B",
                                   "fake_A", "rec_B"]
    for v in st["visuals"].values():
        assert v.shape == (4, 64, 64, 3) and not v.requires_grad
    assert run["model"].state.step == 2
    assert all(o.count == 2 for o in run["model"].state.opt_state.values())


def test_first_step_is_tight(run):
    """Before any update the two packages see the same numbers: every loss
    within 2e-5 relative (the port's centred variance vs E[x^2] - mean^2)."""
    st = run["steps"][0]
    for k, w in st["jax_losses"].items():
        assert abs(st["losses"][k] - w) <= 2e-5 * max(1.0, abs(w)), k
    assert st["losses"]["KLD_z_B"] > 0 and st["gnorms"]["logvar_max"] == 0.0


def test_encoder_and_latent_discriminator_statistics_advance(run):
    """netE_B forwards twice per step and netD_z_B three times; the
    generators and image discriminators carry no running statistics under
    norm=instance."""
    for net in ("netE_B", "netD_z_B"):
        moved = [k for k, v in run["state"][net].items()
                 if "running_mean" in k and np.abs(v).max() > 0]
        assert moved, net
    for net in ("netG_A_B", "netG_B_A", "netD_A", "netD_B"):
        assert not [k for k in run["state"][net] if "running" in k]


def _model(**flags):
    return create_model(TrainConfig(**dict(TINY, **flags)), testing=True,
                        device="cpu")


def test_train_instance_draws_its_own_noise_and_is_seeded():
    A, B = images(0, 2), images(1, 2)
    outs = []
    for _ in range(2):
        m = _model(seed=4, init_scheme="sane", monitor_gnorm=False)
        assert isinstance(m, AugmentedCycleGAN)
        out = m.train_instance(A, B)
        assert len(out) == 2  # no gnorms when monitor_gnorm is off
        outs.append({k: float(v) for k, v in out[0].items()})
    assert outs[0] == outs[1]
    assert all(np.isfinite(v) for v in outs[0].values())
    z = m.sample_prior_z(3)
    assert z.shape == (3, 8) and not torch.equal(z, m.sample_prior_z(3))
    four_d = m._prep_prior(2, np.zeros((2, 1, 1, 8), np.float32))
    assert four_d.shape == (2, 8)


@pytest.mark.parametrize("mode", ["reference", "ratio"])
def test_d_lr_schedule_q11(mode, capsys):
    """D starts at lr / 5; the first decay sets it to the full decayed lr
    (``reference``) or keeps the ratio (``ratio``); a restored old_lr
    re-derives it on either side of the decay boundary."""
    m = _model(lr=1e-3, niter_decay=10, d_lr_mode=mode)
    assert np.isclose(m.old_lr, 1e-3) and np.isclose(m.old_lr_d, 2e-4)
    m.update_learning_rate()
    assert "update learning rate" in capsys.readouterr().out
    assert np.isclose(m.old_lr, 9e-4)
    assert np.isclose(m.old_lr_d, 9e-4 if mode == "reference" else 1.8e-4)
    want = m.old_lr_d
    m.old_lr_d = None
    m._derive_lr_d()
    assert np.isclose(m.old_lr_d, want)
    m.old_lr = 1e-3  # as restored from a checkpoint taken before decay
    m._derive_lr_d()
    assert np.isclose(m.old_lr_d, 2e-4)


def test_d_moves_a_fifth_as_far_as_g():
    """Adam's first update is about lr per coordinate: generators at lr,
    discriminators at lr / 5."""
    m = _model(lr=1e-3, init_scheme="sane", seed=2)
    before = {k: [p.detach().clone() for p in n.parameters()]
              for k, n in m.nets.items()}
    m.train_instance(images(2, 2), images(3, 2), latents(4, 2, 8),
                     latents(5, 2, 8))
    moved = {k: max(float((p - q).abs().max())
                    for p, q in zip(m.nets[k].parameters(), before[k]))
             for k in m.nets}
    for k in ("netG_A_B", "netG_B_A", "netE_B"):
        assert 0 < moved[k] <= 1e-3 * 1.01, (k, moved[k])
    for k in ("netD_A", "netD_B", "netD_z_B"):
        assert 0 < moved[k] <= 2e-4 * 1.01, (k, moved[k])


def test_eval_train_and_predict_enc_params():
    m = _model(init_scheme="sane", seed=3, use_dropout=True)
    A, B = images(6, 2), images(7, 2)
    z = latents(8, 2, 8)
    assert m.training
    assert not torch.equal(m.predict_B(A, z), m.predict_B(A, z))  # dropout
    stats = {k: v.clone() for k, v in m.nets["netE_B"].named_buffers()}
    (mu,) = m.predict_enc_params(A, B)
    assert mu.shape == (2, 8)
    for k, v in m.nets["netE_B"].named_buffers():
        assert torch.equal(v, stats[k]), k  # generation never advances them
    m.eval()
    assert torch.equal(m.predict_B(A, z), m.predict_B(A, z))
    (mu_eval,) = m.predict_enc_params(A, B)
    assert not torch.equal(mu, mu_eval)  # running vs batch statistics
    m.train()
    losses, _, _ = m.train_instance(A, B)  # outputs of predict_* may feed it
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert len(_model(stoch_enc=True).predict_enc_params(A, B)) == 2


def test_bfloat16_training_keeps_float32_masters():
    """compute_dtype=bfloat16: parameters and Adam moments stay float32,
    activations are bfloat16, losses float32 and close to the float32 step."""
    A, B = images(9, 2), images(10, 2)
    z, eps = latents(11, 2, 8), latents(12, 2, 8)
    out = {}
    for dtype in ("float32", "bfloat16"):
        m = _model(init_scheme="sane", seed=6, compute_dtype=dtype)
        losses, visuals, _ = m.train_instance(A, B, z, eps)
        out[dtype] = {k: float(v) for k, v in losses.items()}
        for net in m.nets.values():
            assert all(p.dtype == torch.float32 for p in net.parameters())
        assert all(t.dtype == torch.float32
                   for o in m.state.opt_state.values() for t in o.mu + o.nu)
        assert all(v.dtype == torch.float32 for v in losses.values())
        assert visuals["fake_B"].dtype == getattr(torch, dtype)
    for k, w in out["float32"].items():
        # 8 significant bits through ~20 layers, O(1) losses
        assert abs(out["bfloat16"][k] - w) <= 0.05 * max(1.0, abs(w)), k
