"""The buffered fake-image pool: the port of the JAX package's
``models/pool.py``.

The CycleGAN history trick (Shrivastava et al. / Zhu et al.): the
discriminators train on a mix of fresh fakes and fakes replayed from a
buffer.  Opt-in (``--pool_size``, default 0 = off).  Per incoming image:

- while the pool is not full: insert the image, return the image;
- otherwise, with probability 0.5, return a random pool element and put the
  incoming image in its place, else return the incoming image.

:func:`pool_query` is a pure function of the pool, the images and the two
draws (``coin``, ``slot``), so a test can hand it the draws a JAX key gives.
It keeps the JAX order: this batch's inserts land before the replay gather,
a replay reads the slot's content after those inserts, and the coin-swaps
write last.  Where several elements swap into the same slot the later one
wins.  The swaps are resolved to one writer per slot before they are
written (``index_put_`` with repeated indices is undefined on CUDA), so the
card and the CPU give the same buffer.

The buffer is NHWC ``(pool_size, H, W, C)`` float32, as the JAX package
stores it; the fill count ``n`` is a host int (it advances by the batch size
whatever the draws, so it needs no read-back).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class PoolState:
    buf: torch.Tensor   # (pool_size, H, W, C)
    n: int = 0          # filled slots


def init_pool(pool_size: int, image_shape, dtype=torch.float32,
              device="cpu") -> PoolState:
    return PoolState(buf=torch.zeros((pool_size,) + tuple(image_shape),
                                     dtype=dtype, device=device))


def draw_pool(batch: int, pool_size: int,
              generator: torch.Generator, device):
    """The draws of one query: ``coin`` ~ Bernoulli(0.5) and ``slot`` ~
    U{0, ..., pool_size - 1}, one per image, from ``generator``."""
    coin = torch.rand((batch,), device=device, generator=generator) < 0.5
    slot = torch.randint(0, pool_size, (batch,), device=device,
                         generator=generator)
    return coin, slot


@torch.no_grad()
def pool_query(pool: PoolState, images: torch.Tensor, coin: torch.Tensor,
               slot: torch.Tensor):
    """Push a batch through the pool; returns ``(new_pool, images_for_D)``.
    ``coin`` (bool) and ``slot`` (int) are per image, on the images' device.
    The returned images are in the pool's dtype, as the JAX query's."""
    pool_size, b = pool.buf.shape[0], images.shape[0]
    imgs = images.to(pool.buf.dtype)
    buf = pool.buf.clone()
    # the first n_ins images fill the next free slots, in order
    n_ins = max(0, min(b, pool_size - pool.n))
    buf[pool.n:pool.n + n_ins] = imgs[:n_ins]
    new_pool = PoolState(buf=buf, n=min(pool.n + b, pool_size))
    if n_ins == b:
        return new_pool, imgs

    replaying = coin.to(torch.bool).clone()
    replaying[:n_ins] = False
    slot = slot.to(torch.int64)
    # a replay reads the slot after this batch's inserts, before any swap
    out = torch.where(replaying.reshape(-1, 1, 1, 1), buf[slot], imgs)

    # the coin-swaps: element i writes slot[i] unless a later replaying
    # element writes the same slot
    order = torch.arange(b, device=slot.device)
    later_same = ((slot[None, :] == slot[:, None])
                  & (order[None, :] > order[:, None]) & replaying[None, :])
    writes = replaying & ~later_same.any(dim=1)
    # per slot: the one element that writes it, if any
    hit = (slot[None, :] == torch.arange(pool_size, device=slot.device)
           [:, None]) & writes[None, :]
    written = hit.any(dim=1)
    writer = hit.to(torch.int64).argmax(dim=1)
    new_pool.buf = torch.where(written.reshape(-1, 1, 1, 1), imgs[writer],
                               buf)
    return new_pool, out
