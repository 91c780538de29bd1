"""ops/numerics.py of the port against the JAX package's: values and
gradients on numpy-seeded inputs, the saturated ends of the BCE and both
sides of the clipping threshold."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from domain_transfer_gan_tpu.ops import numerics as jn

from domain_transfer_gan_torch.ops import numerics as tn

from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# float32 elementwise math and short sums on both sides
RTOL, ATOL = 1e-5, 1e-6


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _both(tfn, jfn, *arrays):
    """Value and gradients (of the sum) w.r.t. every array, port vs JAX."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = tfn(*leaves)
    grads = torch.autograd.grad(out.sum(), leaves, allow_unused=True)
    want = jfn(*map(jnp.asarray, arrays))
    jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a)),
                      argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    _close(out.detach().numpy(), want)
    for g, jg in zip(grads, jgrads):
        _close(np.zeros_like(jg) if g is None else g.numpy(), jg,
               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["log_prob_laplace", "log_prob_gaussian"])
def test_log_probs(name):
    z, mu, lv = _rand(0, 4, 8), _rand(1, 4, 8), 0.5 * _rand(2, 4, 8)
    _both(getattr(tn, name), getattr(jn, name), z, mu, lv)


def test_kld_std_gauss():
    _both(tn.kld_std_gauss, jn.kld_std_gauss, _rand(3, 4, 8),
          0.5 * _rand(4, 4, 8))


@pytest.mark.parametrize("name", ["l1_loss", "mse_loss"])
def test_image_losses(name):
    _both(getattr(tn, name), getattr(jn, name), _rand(5, 2, 8, 8, 3),
          _rand(6, 2, 8, 8, 3))


def test_gauss_reparametrize_eps_clamps_and_blocks_the_gradient():
    mu, lv, eps = 3.0 * _rand(7, 4, 8), _rand(8, 4, 8), _rand(9, 4, 8)
    _both(tn.gauss_reparametrize_eps, jn.gauss_reparametrize_eps, mu, lv, eps)
    z = tn.gauss_reparametrize_eps(*map(torch.from_numpy, (mu, lv, eps)))
    assert float(z.abs().max()) == 4.0  # some samples do hit the clamp


def test_gauss_reparametrize_draws_from_its_generator():
    mu, lv = torch.from_numpy(_rand(10, 3, 8)), torch.from_numpy(
        _rand(11, 3, 8))
    g = torch.Generator().manual_seed(5)
    a = tn.gauss_reparametrize(mu, lv, n_sample=4, generator=g)
    b = tn.gauss_reparametrize(mu, lv, n_sample=4,
                               generator=torch.Generator().manual_seed(5))
    assert a.shape == (12, 8) and torch.equal(a, b)
    assert float(a.abs().max()) <= 4.0
    # same moments as the JAX draw (other bits): mean over many samples
    many = tn.gauss_reparametrize(mu * 0.1, lv * 0.0, n_sample=4000,
                                  generator=g).reshape(3, 4000, 8).mean(1)
    _close(many.numpy(), (mu * 0.1).numpy(), rtol=0, atol=0.08)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("use_sigmoid", [False, True])
def test_criterion_gan(real, use_sigmoid):
    pred = _rand(12, 4, 13)
    if use_sigmoid:
        pred = 1.0 / (1.0 + np.exp(-pred))
    _both(lambda p: tn.criterion_gan(p, real, use_sigmoid),
          lambda p: jn.criterion_gan(p, real, use_sigmoid), pred)


@pytest.mark.parametrize("real", [False, True])
def test_bce_saturation(real):
    """p in {0, 1}: the log is clamped at -100 in the forward, the backward
    is (p - t) / max(p (1 - p), 1e-12): huge but finite."""
    pred = np.array([[0.0, 1.0, 0.5, 1e-30, 1.0 - 1e-7]], np.float32)
    leaf = torch.from_numpy(pred).requires_grad_(True)
    loss = tn.criterion_gan(leaf, real, True)
    (grad,) = torch.autograd.grad(loss, leaf)
    want = jn.criterion_gan(jnp.asarray(pred), real, True)
    jgrad = jax.grad(lambda p: jn.criterion_gan(p, real, True))(
        jnp.asarray(pred))
    assert np.isfinite(float(loss)) and np.isfinite(grad.numpy()).all()
    _close(loss.detach().numpy(), want)
    _close(grad.numpy(), jgrad, rtol=1e-5, atol=0)
    assert float(grad.abs().max()) >= 1e11  # 1 / (5 * 1e-12)


def test_criterion_gan_is_float32_under_bfloat16():
    pred = torch.from_numpy(_rand(13, 4, 5)).to(torch.bfloat16)
    assert tn.criterion_gan(pred, True, False).dtype == torch.float32


def test_global_norm():
    tree = [_rand(14, 3, 4), _rand(15, 7), _rand(16, 2, 2, 2)]
    _close(tn.global_norm([torch.from_numpy(t) for t in tree]),
           jn.global_norm([jnp.asarray(t) for t in tree]))
    assert float(tn.global_norm([])) == 0.0


@pytest.mark.parametrize("max_norm", [1e3, 0.5, 7.0])
def test_clip_grads_torchlike(max_norm):
    """Above the threshold: scaled by max / (norm + 1e-6); below: untouched.
    The norm returned is the one before clipping."""
    tree = [_rand(17, 3, 4), _rand(18, 7)]  # global norm ~ 4.2
    got, norm = tn.clip_grads_torchlike(
        [torch.from_numpy(t) for t in tree], max_norm)
    want, jnorm = jn.clip_grads_torchlike([jnp.asarray(t) for t in tree],
                                          max_norm)
    _close(norm, jnorm)
    for g, w, raw in zip(got, want, tree):
        _close(g.numpy(), w)
        if float(jnorm) <= max_norm:
            assert np.array_equal(g.numpy(), raw)
    if float(jnorm) > max_norm:
        _close(tn.global_norm(got), max_norm, rtol=1e-5)


def test_clip_differs_from_clip_grad_norm_just_below_the_threshold():
    """torch.nn.utils.clip_grad_norm_ clamps its coefficient and so scales
    by max / (norm + 1e-6) < 1 even when norm == max; the port's rule leaves
    such gradients untouched, as the JAX package's does."""
    g = torch.full((4,), 0.5)  # norm exactly 1.0
    got, _ = tn.clip_grads_torchlike([g], 1.0)
    assert torch.equal(got[0], g)


def test_nats2bpp_and_detail():
    nats = _rand(19, 5) ** 2
    _close(tn.nats2bpp(torch.from_numpy(nats), 3, 64),
           jn.nats2bpp(jnp.asarray(nats), 3, 64))
    z, mu, lv = _rand(20, 2, 12), _rand(21, 2, 12), 0.3 * _rand(22, 2, 12)
    got = tn.log_prob_gaussian_detail(*map(torch.from_numpy, (z, mu, lv)),
                                      (2, 3, 4))
    want = jn.log_prob_gaussian_detail(*map(jnp.asarray, (z, mu, lv)),
                                       (2, 3, 4))
    for g, w in zip(got, want):
        _close(g, w)
    with pytest.raises(ValueError, match="3-D"):
        tn.log_prob_gaussian_detail(*map(torch.from_numpy, (z, mu, lv)),
                                    (2, 12))
