"""``stoch_cycle_gan`` and ``cycle_gan``: two steps of the port's
``StochCycleGAN.train_instance`` against two steps of the JAX
``make_stoch_train_step`` from the same weights, inputs and ``prior_z``
(the ``cycle_gan`` comparison compiles a second JAX step and runs under
``-m slow``; its cheap sibling checks the port alone), and the model API
around the step."""

import os

import numpy as np
import pytest
import torch

from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.models import StochCycleGAN, create_model

from torch_port_helpers import (
    TINY,
    check_two_step_parity,
    images,
    latents,
    run_both_train_steps,
)

from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_KEYS = ["D_A", "G_A", "Cyc_A", "D_B", "G_B", "Cyc_B", "P_t_A", "P_f_A",
             "P_t_B", "P_f_B"]
GNORM_KEYS = ["gnorm_G_A_B", "gnorm_G_B_A", "gnorm_D_B", "gnorm_D_A"]


@pytest.fixture(scope="module")
def run():
    return run_both_train_steps({"model": "stoch_cycle_gan"}, grads=True)


def test_two_steps_match_the_jax_step(run):
    """Losses, norms and parameters, and the gradients tensor by tensor.
    The generators' gradients here are mostly sums of L1 signs (the two
    cycle losses) over pixels, and the two packages' forwards differ by
    ~1e-4, so more of netG_A_B's entries than in the aug_cycle_gan step
    have a gradient smaller than the two packages' difference: 11.6 % of
    its entries end two steps more than lr / 10 apart, 5.7 % once those
    are left out of the count."""
    check_two_step_parity(run)


def test_first_step_is_tight(run):
    """Before any update every loss is within 2e-5 relative."""
    st = run["steps"][0]
    for k, w in st["jax_losses"].items():
        assert abs(st["losses"][k] - w) <= 2e-5 * max(1.0, abs(w)), k


def test_keys_order_and_visuals(run):
    st = run["steps"][0]
    assert st["loss_keys"] == LOSS_KEYS and st["gnorm_keys"] == GNORM_KEYS
    assert list(st["visuals"]) == ["real_A", "fake_B", "rec_A", "real_B",
                                   "fake_A", "rec_B"]
    for v in st["visuals"].values():
        assert v.shape == (4, 64, 64, 3) and not v.requires_grad
    model = run["model"]
    assert isinstance(model, StochCycleGAN) and not model.ignore_noise
    assert set(model.nets) == {"netG_A_B", "netG_B_A", "netD_A", "netD_B"}
    assert model.state.step == run["jax_step"] == 2
    assert {k: o.count for k, o in model.state.opt_state.items()} == \
        run["jax_counts"] == dict.fromkeys(model.nets, 2)


@pytest.mark.slow
def test_cycle_gan_two_steps_match_the_jax_step():
    """The JAX step with ``ignore_noise`` (z forced to ones inside it)."""
    run = run_both_train_steps({"model": "cycle_gan"}, grads=True)
    check_two_step_parity(run)
    assert run["model"].ignore_noise


def _model(**flags):
    cfg = dict(TINY, init_scheme="sane", seed=5, **flags)
    return create_model(TrainConfig(**cfg), testing=True, device="cpu")


def test_cycle_gan_forces_z_to_ones():
    """The port alone: a cycle_gan step, predict_B and the generation
    helpers give the same answer whatever z they are handed, and the step
    equals a stoch_cycle_gan step fed z = ones."""
    A, B = images(1, 2), images(2, 2)
    z1, z2 = latents(3, 2, 8), latents(4, 2, 8)
    out = []
    for z in (z1, z2):
        m = _model(model="cycle_gan")
        losses, visuals, gnorms = m.train_instance(A, B, z)
        out.append(({k: float(v) for k, v in losses.items()},
                    {k: float(v) for k, v in gnorms.items()}))
        assert torch.equal(m.predict_B(A, z1), m.predict_B(A, z2))
        c1, c2 = m.generate_cycle(A, B, z1), m.generate_cycle(A, B, z2)
        assert all(torch.equal(c1[k], c2[k]) for k in c1)
    assert out[0] == out[1]
    s = _model(model="stoch_cycle_gan")
    losses, _, _ = s.train_instance(A, B, np.ones_like(z1))
    assert {k: float(v) for k, v in losses.items()} == out[0][0]
    assert not torch.equal(s.predict_B(A, z1), s.predict_B(A, z2))


def test_generation_helpers():
    m = _model(model="stoch_cycle_gan")
    A, B, z = images(5, 2), images(6, 2), latents(7, 2, 8)
    cyc = m.generate_cycle(A, B, z)
    assert list(cyc) == ["real_A", "fake_B", "rec_A", "real_B", "fake_A",
                         "rec_B"]
    assert torch.equal(cyc["fake_B"], m.predict_B(A, z))
    assert torch.equal(cyc["rec_B"], m.predict_B(m.predict_A(B), z))
    # a twin of the same seed draws the same prior z's
    twin = _model(model="stoch_cycle_gan")
    imgs = m.generate_multi_cycle(B, 3)
    assert len(imgs) == 7 and torch.equal(imgs[1], m.predict_A(B))
    A1 = twin.predict_A(B)
    assert torch.equal(imgs[2], twin.predict_B(A1, twin.sample_prior_z(2)))
    # std 0: the clean cycle; noise moves A by std / 127.5 per unit
    noise = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    fake_A = m.predict_A(B)
    assert torch.equal(m.generate_noisy_cycle(B, 0, noise, z),
                       m.predict_B(fake_A, z))
    noisy = torch.clamp(fake_A + 5 / 127.5 * torch.from_numpy(noise), -1, 1)
    assert torch.equal(m.generate_noisy_cycle(B, 5, noise, z),
                       m.predict_B(noisy, z))
    assert m.generate_noisy_cycle(B, 5).shape == (2, 64, 64, 3)


def test_checkpoint_round_trip_indexed_feed_and_schedule(tmp_path, capsys):
    """save / load carry every parameter, Adam moment, step, lr and epoch;
    the device-resident feed takes the host feed's step; a checkpoint of
    another variant is refused; nets.txt lists the four nets."""
    cfg = dict(TINY, init_scheme="sane", seed=6, model="stoch_cycle_gan",
               niter_decay=4, expr_dir=str(tmp_path))
    m = create_model(TrainConfig(**cfg), device="cpu")
    with open(tmp_path / "nets.txt") as f:
        assert [ln for ln in f.read().splitlines()
                if ln.startswith("net")] == list(StochCycleGAN.net_names)
    A, B = images(9, 4), images(10, 4)
    idx_A, idx_B = np.array([2, 0]), np.array([1, 3])
    twin = create_model(TrainConfig(**cfg), testing=True, device="cpu")
    z = latents(11, 2, 8)
    got, _, _ = m.train_instance_indexed(torch.from_numpy(A),
                                         torch.from_numpy(B), idx_A, idx_B, z)
    want, _, _ = twin.train_instance(A[idx_A], B[idx_B], z)
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}
    m.update_learning_rate()
    assert "update learning rate" in capsys.readouterr().out
    m.epoch = 3
    m.save("latest", async_save=True)
    m.wait_for_saves()
    back = create_model(TrainConfig(**cfg), testing=True, device="cpu")
    back.load(str(tmp_path / "latest"))
    assert (back.state.step, back.epoch, back.old_lr, back.old_lr_d) == \
        (1, 3, m.old_lr, m.old_lr_d)
    for name, net in m.nets.items():
        mine = back.nets[name].state_dict()
        assert all(torch.equal(mine[k], v)
                   for k, v in net.state_dict().items()), name
        a, b = m.state.opt_state[name], back.state.opt_state[name]
        assert a.count == b.count == 1
        assert all(torch.equal(x, y) for x, y in zip(a.mu + a.nu,
                                                     b.mu + b.nu))
    aug = create_model(TrainConfig(**dict(cfg, model="aug_cycle_gan")),
                       testing=True, device="cpu")
    with pytest.raises(KeyError, match="holds nets"):
        aug.load(str(tmp_path / "latest"))
    assert os.path.exists(tmp_path / "latest")
