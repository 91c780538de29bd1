"""The port's eval metrics against the JAX package's on the same weights
and inputs (tiny nets, ngf = nef = ndf = 4, 64x64, no dropout): eval_mse_A,
the UBO's RMSprop loop fed the JAX loop's own noise, padding, the running
statistics, and the PNG grid."""

import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from domain_transfer_gan_tpu.config import TrainConfig as JaxConfig
from domain_transfer_gan_tpu.data import AlignedIterator as JaxAligned
from domain_transfer_gan_tpu.eval import metrics as jax_metrics
from domain_transfer_gan_tpu.eval import visualize as jax_visualize
from domain_transfer_gan_tpu.models.state import build_networks, init_state

from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.data import AlignedIterator
from domain_transfer_gan_torch.eval import metrics, visualize
from domain_transfer_gan_torch.models import create_model

from torch_port_helpers import (  # noqa: F401 (a fixture)
    images,
    latents,
    np_tree,
    one_torch_thread,
    randomize,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = dict(model="aug_cycle_gan", grid_size=64, ngf=4, nef=4, ndf=4,
            nlatent=8, batchSize=4)
MSE_ATOL = 1e-5
# step 1 starts from the same (mu, logvar): float32 on both sides, the
# generator's variance in another form (centred vs E[x^2] - mean^2)
UBO_STEP1_RTOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """The JAX nets and a port model holding the same numpy-drawn weights."""
    jcfg = JaxConfig(use_pallas=False, **TINY)
    nets = build_networks(jcfg)
    shapes = jax.eval_shape(
        lambda key: init_state(jcfg, key, image_size=64)[1],
        jax.random.PRNGKey(0))
    blank = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   dict(shapes.params))
    params = {k: randomize(v, 40 + i)
              for i, (k, v) in enumerate(sorted(blank.items()))}
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (np.ones if path[-1].key == "var" else np.zeros)(
            v.shape, np.float32), dict(shapes.batch_stats))
    jmodel = SimpleNamespace(
        training=True, opt=jcfg, nets=nets, ignore_noise=False,
        _jit_cache={}, state=SimpleNamespace(
            params=jax.tree_util.tree_map(jnp.asarray, params),
            batch_stats=jax.tree_util.tree_map(jnp.asarray, stats)))
    model = create_model(TrainConfig(**TINY), testing=True, device="cpu")
    for k in params:
        model.load_jax_params(k, params[k])
        model.load_jax_batch_stats(k, np_tree(stats[k]))
    return jmodel, model


def test_eval_mse_A_matches_jax(pair):
    jmodel, model = pair
    A, B = images(1, 5), images(2, 5)
    want = jax_metrics.eval_mse_A(JaxAligned(A, B, batch_size=2), jmodel)
    got = metrics.eval_mse_A(AlignedIterator(A, B, batch_size=2), model)
    assert abs(got - want) <= MSE_ATOL, (got, want)


def _ubo_inputs(n, n_real, nlat):
    rng = np.random.RandomState(9)
    A, B = images(3, n), images(4, n)
    deq = rng.uniform(0, 1 / 127.5, B.shape).astype(np.float32)
    mu = (0.5 * rng.randn(n, nlat)).astype(np.float32)
    lv = np.full((n, nlat), math.log(0.01), np.float32)
    mask = (np.arange(n) < n_real).astype(np.float32)
    logvar_B = np.full((1, 64, 64, 3), math.log(0.01), np.float32)
    return A, B + deq, mu, lv, mask, logvar_B


def test_ubo_loop_matches_the_jax_loop_on_its_own_noise(pair):
    """Three steps of the JAX ``_make_ubo_chunk`` (one compiled step called
    three times, carrying its state and key) and of the port's
    ``ubo_chunk`` fed the eps that each JAX step draws, on a batch with a
    zero-weight padded row.

    Step 1 (the metrics of the starting iterate) agrees to UBO_STEP1_RTOL.
    Its gradient does not agree as tightly: the Laplace term's gradient is
    a sum over pixels of sign(B - fake_B) / 0.1 * d fake_B / dz, and the
    two packages' generators differ by up to ~1e-4 at these random weights
    (the JAX norm's E[x^2] - mean^2 variance), so a pixel whose residual is
    that close to 0 flips its sign; |g| is held within 1 % of the largest
    |g|.  RMSprop's first update is lr * g / (sqrt(0.01 g^2) + 1e-8) = 10 lr
    * sign(g) for every entry, blind to |g|: the first iterate agrees to
    1e-6.  Later updates see the ratio of this |g| to the running one, so
    the 1 % in |g| reaches the iterates (2.3e-3 seen at step 2): they are
    held to lr per entry, the later metrics to 1e-3."""
    jmodel, model = pair
    n, n_real, nlat = 4, 3, TINY["nlatent"]
    A, Bdeq, mu, lv, mask, logvar_B = _ubo_inputs(n, n_real, nlat)
    npix = 64 * 64 * 3.0
    chunk = jax_metrics._make_ubo_chunk(jmodel)
    gp = jmodel.state.params["netG_A_B"]
    gs = jmodel.state.batch_stats["netG_A_B"]
    key = jax.random.PRNGKey(123)
    j_state = [jnp.asarray(v) for v in (mu, lv, np.zeros_like(mu),
                                        np.zeros_like(lv))]
    t_state = [torch.from_numpy(v) for v in (mu, lv, np.zeros_like(mu),
                                             np.zeros_like(lv))]
    tA = torch.from_numpy(A)
    tB, tmask, tlvB = (torch.from_numpy(v) for v in (Bdeq, mask, logvar_B))
    for step in range(3):
        # the eps the JAX body draws: key, k, _ = split(key, 3)
        eps = jax.random.normal(jax.random.split(key, 3)[1], mu.shape,
                                jnp.float32)
        *j_state, key, j_ubo, j_kld = chunk(
            gp, gs, jnp.asarray(A), jnp.asarray(Bdeq), *j_state, key,
            jnp.asarray(logvar_B), jnp.asarray(mask), npix, 1)
        *t_state, t_ubo, t_kld = metrics.ubo_chunk(
            model, tA, tB, *t_state, tlvB, tmask, npix, 1,
            eps=torch.from_numpy(np.array(eps))[None])
        j_ubo, j_kld, t_ubo, t_kld = (float(v) for v in (j_ubo, j_kld,
                                                         t_ubo, t_kld))
        jm = [np.asarray(v) for v in j_state]
        tm = [v.numpy() for v in t_state]
        if step == 0:
            assert abs(t_ubo - j_ubo) <= UBO_STEP1_RTOL * abs(j_ubo)
            assert abs(t_kld - j_kld) <= UBO_STEP1_RTOL * max(1, abs(j_kld))
            for t, j in zip(tm[2:], jm[2:]):  # sq = 0.01 g^2
                gt, gj = np.sqrt(t / 0.01), np.sqrt(j / 0.01)
                assert np.abs(gt - gj).max() <= 1e-2 * gj.max()
        else:
            assert abs(t_ubo - j_ubo) <= 1e-3 * abs(j_ubo), (step, t_ubo,
                                                              j_ubo)
        for t, j in zip(tm[:2], jm[:2]):
            d = np.abs(t - j)
            assert d.max() <= (1e-6 if step == 0 else metrics.RMS_LR), (
                step, d.max())
        # the padded row moved by no gradient but its KLD's: it is masked
        assert np.isfinite(tm[0]).all()


def _padded_vs_unpadded(model, n_real, pad_to, steps):
    nlat = TINY["nlatent"]
    A, B = images(5, n_real), images(6, n_real)
    rng = np.random.RandomState(8)
    deq = rng.uniform(0, 1 / 127.5, (pad_to, 64, 64, 3)).astype(np.float32)
    eps = rng.randn(steps, pad_to, nlat).astype(np.float32)
    padded = metrics.variational_ubo(model, A, B, steps, pad_to=pad_to,
                                     dequant=deq, eps=eps)
    plain = metrics.variational_ubo(model, A, B, steps,
                                    dequant=deq[:n_real],
                                    eps=eps[:, :n_real])
    return padded, plain


def test_padded_tail_equals_unpadded(pair):
    """Zero-weight rows change nothing: the same real rows, the same noise
    on them, eval mode (so the encoder's batch norm is per sample)."""
    _, model = pair
    model.eval()
    try:
        padded, plain = _padded_vs_unpadded(model, 3, 4, steps=3)
    finally:
        model.train()
    for p, u in zip(padded, plain):
        assert abs(p - u) <= 1e-5 * max(1.0, abs(u)), (padded, plain)


def test_evals_leave_running_statistics_and_grads_alone():
    """norm=batch: eval_mse_A and eval_ubo_B in train mode use batch
    statistics but write no running statistic, and compute no parameter
    gradient."""
    model = create_model(TrainConfig(norm="batch", init_scheme="sane",
                                     seed=3, **TINY),
                         testing=True, device="cpu")
    before = {name: {k: v.clone() for k, v in net.named_buffers()}
              for name, net in model.nets.items()}
    assert any(before[n] for n in ("netG_B_A", "netE_B"))
    A, B = images(7, 5), images(8, 5)
    ds = AlignedIterator(A, B, batch_size=4)  # 4 + a padded tail of 1
    assert np.isfinite(metrics.eval_mse_A(ds, model))
    ubo, bpp, kld = metrics.eval_ubo_B(ds, model, steps=2)
    assert np.isfinite([ubo, bpp, kld]).all()
    for name, net in model.nets.items():
        for k, v in net.named_buffers():
            assert torch.equal(v, before[name][k]), (name, k)
        for p in net.parameters():
            assert p.grad is None and p.requires_grad, name
        assert net.training or name not in ("netG_B_A", "netG_A_B")


def test_generation_helpers_leave_running_statistics_alone():
    """norm=batch, train mode: predict_A / predict_B, generate_cycle,
    inference_multi and the posterior use batch statistics and write no
    running statistic, as the JAX package's helpers."""
    model = create_model(TrainConfig(norm="batch", init_scheme="sane",
                                     seed=4, **TINY),
                         testing=True, device="cpu")
    before = {name: {k: v.clone() for k, v in net.named_buffers()}
              for name, net in model.nets.items()}
    A, B = images(9, 3), images(10, 3)
    z = latents(11, 3, TINY["nlatent"])
    fake_A = model.predict_A(B)
    model.predict_B(A, z)
    vis = model.generate_cycle(A, B, z)
    multi = model.inference_multi(A, B[:2])
    assert list(vis) == ["real_A", "fake_B", "rec_A", "real_B", "fake_A",
                         "rec_B"]
    assert torch.equal(vis["fake_A"], fake_A)  # batch statistics, no drift
    assert multi.shape == (6, 64, 64, 3)
    for name, net in model.nets.items():
        for k, v in net.named_buffers():
            assert torch.equal(v, before[name][k]), (name, k)
        assert net.training


def test_png_decodes_to_the_jax_grid(tmp_path):
    """Same images in, the port's stdlib PNG and the JAX package's PIL PNG
    decode to the same pixels."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(0)
    imgs = rng.uniform(-1.3, 1.3, (7, 9, 11, 3)).astype(np.float32)
    imgs[0, 0, 0] = [-1.0, 1.0, 0.0]
    for nrow, arr in ((3, imgs), (4, imgs[..., :1])):
        ours, theirs = (str(tmp_path / n) for n in ("t.png", "j.png"))
        visualize.save_image_grid(torch.from_numpy(arr), ours, nrow=nrow)
        jax_visualize.save_image_grid(arr, theirs, nrow=nrow)
        got = np.asarray(Image.open(ours).convert("RGB"))
        want = np.asarray(Image.open(theirs).convert("RGB"))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert os.path.getsize(ours) > 0
