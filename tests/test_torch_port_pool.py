"""The fake-image pool (``models/pool.py``) against the JAX package's
``pool_query``, run eagerly, on the same images and the same (coin, slot)
draws (those of the JAX key): outputs and buffer bit-equal, through the
batch that crosses the pool-full boundary and batches whose replays pick
the same slot.  Then the pool in the port's train steps: what the
discriminators score, the fill count, the draws' source."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from domain_transfer_gan_tpu.models import pool as jax_pool

from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.models import create_model
from domain_transfer_gan_torch.models import pool

from torch_port_helpers import (  # noqa: F401 (a fixture)
    TINY,
    images,
    latents,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPE = (4, 4, 3)


def jax_draws(key, b, pool_size):
    """The (coin, slot) that JAX's pool_query draws from ``key``."""
    k_coin, k_slot = jax.random.split(key)
    return (np.asarray(jax.random.bernoulli(k_coin, 0.5, (b,))),
            np.asarray(jax.random.randint(k_slot, (b,), 0, pool_size)))


def _both(jp, tp, imgs, key):
    coin, slot = jax_draws(key, len(imgs), jp.buf.shape[0])
    jp, jout = jax_pool.pool_query(jp, jnp.asarray(imgs), key)
    tp, tout = pool.pool_query(tp, torch.from_numpy(imgs),
                               torch.from_numpy(coin.copy()),
                               torch.from_numpy(slot.copy()))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tp.buf.numpy(), np.asarray(jp.buf))
    assert tp.n == int(jp.n)
    return jp, tp, coin, slot


def _duplicate_replays(coin, slot, first):
    """Slots picked by two or more replaying elements."""
    picked = slot[first:][coin[first:]]
    return len(picked) - len(set(picked.tolist()))


@pytest.mark.parametrize("pool_size,batch", [(5, 3), (4, 8), (3, 1)])
def test_pool_query_is_the_jax_one_bit_for_bit(pool_size, batch):
    jp = jax_pool.init_pool(pool_size, SHAPE)
    tp = pool.init_pool(pool_size, SHAPE)
    crossed = dupes = 0
    for it in range(8):
        imgs = images(200 + it, batch, hw=4)
        n_before = tp.n
        jp, tp, coin, slot = _both(jp, tp, imgs, jax.random.PRNGKey(it))
        if n_before < pool_size < n_before + batch:
            crossed += 1
        dupes += _duplicate_replays(coin, slot, max(0, pool_size - n_before))
    assert tp.n == pool_size
    if batch > 1:
        assert crossed == 1
    if batch > pool_size:
        assert dupes > 0  # the later element's write must win


def test_the_later_element_wins_a_slot():
    """Hand-made draws: elements 0, 1 and 3 all replay slot 1 of a full
    pool; the replays read the slot's content from before any swap and the
    slot ends holding element 3."""
    tp = pool.init_pool(2, (1, 1, 1))
    tp, _ = pool.pool_query(tp, torch.tensor([1.0, 2.0]).reshape(2, 1, 1, 1),
                            torch.zeros(2, dtype=torch.bool),
                            torch.zeros(2, dtype=torch.long))
    imgs = torch.tensor([10.0, 11.0, 12.0, 13.0]).reshape(4, 1, 1, 1)
    coin = torch.tensor([True, True, False, True])
    slot = torch.tensor([1, 1, 1, 1])
    new, out = pool.pool_query(tp, imgs, coin, slot)
    assert out.flatten().tolist() == [2.0, 2.0, 12.0, 2.0]
    assert new.buf.flatten().tolist() == [1.0, 13.0]
    # the JAX query on the same draws
    jp = jax_pool.PoolState(buf=jnp.asarray(tp.buf.numpy()),
                            n=jnp.asarray(2, jnp.int32))
    orig = jax.random.bernoulli, jax.random.randint
    try:
        jax.random.bernoulli = lambda *a, **k: jnp.asarray(coin.numpy())
        jax.random.randint = lambda *a, **k: jnp.asarray(slot.numpy())
        jp, jout = jax_pool.pool_query(jp, jnp.asarray(imgs.numpy()),
                                       jax.random.PRNGKey(0))
    finally:
        jax.random.bernoulli, jax.random.randint = orig
    np.testing.assert_array_equal(np.asarray(jout), out.numpy())
    np.testing.assert_array_equal(np.asarray(jp.buf), new.buf.numpy())


def test_draws_come_from_the_generator():
    g = torch.Generator().manual_seed(3)
    coin, slot = pool.draw_pool(1000, 7, g, "cpu")
    assert coin.dtype == torch.bool and slot.dtype == torch.int64
    assert 0.4 < coin.float().mean() < 0.6
    assert set(slot.tolist()) == set(range(7))
    again = pool.draw_pool(1000, 7, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(coin, again[0]) and torch.equal(slot, again[1])


def _model(**flags):
    cfg = dict(TINY, init_scheme="sane", seed=1, **flags)
    return create_model(TrainConfig(**cfg), testing=True, device="cpu")


@pytest.mark.parametrize("model_name", ["aug_cycle_gan", "stoch_cycle_gan"])
def test_the_discriminators_score_the_pools_answer(monkeypatch, model_name):
    """With a pool the D phase's fakes are the pool's answer; the G phase
    scores the fresh fakes; the pools fill by the batch each step."""
    from domain_transfer_gan_torch.models import steps

    m = _model(model=model_name, pool_size=6)
    seen = []
    orig = steps.pool_query

    def spy(p, images, coin, slot):
        new, out = orig(p, images, coin, slot)
        seen.append((images.clone(), out.clone()))
        return new, out

    monkeypatch.setattr(steps, "pool_query", spy)
    A, B = images(5, 4), images(6, 4)
    draws = {k: (np.ones(4, bool), np.array([0, 1, 2, 0]))
             for k in ("fake_A", "fake_B")}
    m.train_instance(A, B, latents(7, 4, 8))
    assert [p.n for p in m.state.pools.values()] == [4, 4]
    assert all(torch.equal(i, o) for i, o in seen)  # filling: fresh fakes
    out = m.train_instance(A, B, latents(8, 4, 8), pool_draws=draws)
    assert [p.n for p in m.state.pools.values()] == [6, 6]
    fresh, answer = seen[-1]
    # elements 0, 1 insert (slots 4, 5), elements 2 and 3 replay slots 2, 0
    assert torch.equal(answer[:2], fresh[:2])
    assert not torch.equal(answer[2:], fresh[2:])
    assert torch.equal(m.state.pools["fake_B"].buf[0], fresh[3])
    assert all(np.isfinite(float(v)) for v in out[0].values())
