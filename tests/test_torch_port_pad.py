"""The pad wrapper (``ops/kernels/pad.py``) on the CPU: its plain path
against ``F.pad`` and against the JAX package's ``reflect_pad2d`` /
``replicate_pad2d`` and their VJP; the kernels' source map and fixed-order
gather (``csrc/pad.cu``) emulated in numpy against ``F.pad``'s CPU backward
bit for bit; the routing (a CPU tensor to ``F.pad``, a card tensor to the
launchers and nothing else); and the networks' pads going through it.  The
kernels themselves run in ``tests/test_torch_port_cuda.py`` and
``chip_smoke.py``."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.models.state import build_networks
from domain_transfer_gan_torch.ops import convs
from domain_transfer_gan_torch.ops.kernels import pad as P
from domain_transfer_gan_torch.parallel import spatial
from domain_transfer_gan_tpu.ops import convs as jax_convs

JAX_PADS = {"reflect": jax_convs.reflect_pad2d,
            "replicate": jax_convs.replicate_pad2d}
PORT_PADS = {"reflect": convs.reflect_pad2d,
             "replicate": convs.replicate_pad2d}
ATOL = 1e-6

# (left, right, top, bottom): the networks' pads (all sides; W only under
# a space axis), one-sided and uneven ones
GEOMETRIES = [(1, 1, 1, 1), (3, 3, 3, 3), (1, 1, 0, 0), (3, 3, 0, 0),
              (2, 0, 1, 3), (0, 1, 2, 0)]


def _x(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape).astype(dtype)


@pytest.mark.parametrize("mode,pad,dtype", list(itertools.product(
    ("reflect", "replicate"), (1, 3), (np.float32, np.float64))))
def test_the_plain_path_is_f_pad_and_the_jax_pad(mode, pad, dtype):
    """Forward and VJP of the port's helper (NCHW, through ``pad2d``)
    against ``F.pad`` (bit for bit) and against the JAX package's helper
    (NHWC) within 1e-6."""
    x = _x((2, 5, 9, 7), dtype, seed=pad)
    dy = _x((2, 5, 9 + 2 * pad, 7 + 2 * pad), dtype, seed=10 + pad)
    xt = torch.from_numpy(x).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    y = PORT_PADS[mode](xt, pad)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    xf = torch.from_numpy(x).requires_grad_(True)
    yf = F.pad(xf, (pad,) * 4, mode=mode)
    (gf,) = torch.autograd.grad(yf, xf, torch.from_numpy(dy))
    assert torch.equal(y.detach(), yf.detach())
    assert torch.equal(gx, gf)
    with jax.enable_x64(dtype == np.float64):
        xj = jnp.asarray(x.transpose(0, 2, 3, 1))
        yj, vjp = jax.vjp(lambda v: JAX_PADS[mode](v, pad), xj)
        (gj,) = vjp(jnp.asarray(dy.transpose(0, 2, 3, 1)))
        yj, gj = np.asarray(yj), np.asarray(gj)
    assert yj.dtype == dtype
    np.testing.assert_allclose(y.detach().numpy(), yj.transpose(0, 3, 1, 2),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(gx.numpy(), gj.transpose(0, 3, 1, 2), rtol=0,
                               atol=ATOL)


def _source(j, n, mode):
    """csrc/pad.cu::source: the input index output index j + before
    copies."""
    if mode == "reflect":
        j = np.abs(j)
        return np.where(j > n - 1, 2 * (n - 1) - j, j)
    return np.clip(j, 0, n - 1)


def _sources(i, n, before, after, mode):
    """The output indices along one axis that copy input index i, in the
    kernel's order (``reflect_sources``, or the replicated edge's range)."""
    if mode == "reflect":
        out = [before - i] if 1 <= i <= before else []
        out.append(before + i)
        if n - 1 - after <= i <= n - 2:
            out.append(before + 2 * (n - 1) - i)
        return out
    lo = 0 if i == 0 else before + i
    hi = before + n - 1 + after if i == n - 1 else before + i
    return list(range(lo, hi + 1))


def _emulated_bwd(dy, h, w, pads, mode):
    """The backward kernel's arithmetic: per input element, float32 sums
    from 0 over its output positions, rows ascending, then columns."""
    left, right, top, bottom = pads
    n, c = dy.shape[:2]
    dx = np.zeros((n, c, h, w), np.float32)
    for ih in range(h):
        for iw in range(w):
            acc = np.zeros((n, c), np.float32)
            for oh in _sources(ih, h, top, bottom, mode):
                for ow in _sources(iw, w, left, right, mode):
                    acc = acc + dy[:, :, oh, ow]
            dx[:, :, ih, iw] = acc
    return dx


@pytest.mark.parametrize("mode,pads,hw", [
    (m, p, hw) for m in ("reflect", "replicate") for p in GEOMETRIES
    for hw in ((6, 5), (4, 4))] + [("replicate", (3, 3, 3, 3), (1, 2)),
                                  ("reflect", (1, 1, 1, 1), (2, 2))])
def test_the_kernels_arithmetic_is_f_pads(mode, pads, hw):
    """The forward's source map is ``F.pad``'s, and the backward's
    fixed-order float32 gather gives ``F.pad``'s CPU backward bit for bit
    (the CPU adds in the same order)."""
    h, w = hw
    left, right, top, bottom = pads
    x = torch.from_numpy(_x((2, 3, h, w), np.float32, seed=h * w)).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    y = F.pad(x, pads, mode=mode)
    rows = _source(np.arange(h + top + bottom) - top, h, mode)
    cols = _source(np.arange(w + left + right) - left, w, mode)
    np.testing.assert_array_equal(
        x.detach().numpy()[:, :, rows][:, :, :, cols], y.detach().numpy())
    dy = _x(tuple(y.shape), np.float32, seed=7) * np.float32(1e3)
    (gx,) = torch.autograd.grad(y, x, torch.from_numpy(dy))
    np.testing.assert_array_equal(_emulated_bwd(dy, h, w, pads, mode),
                                  gx.numpy())


def test_the_wrappers_take_f_pad_on_the_cpu_and_count_nothing():
    P.reset_counts()
    x = torch.randn(2, 4, 6, 6, requires_grad=True)
    y = P.pad2d(x, (1, 1, 1, 1), "reflect")
    dy = torch.randn_like(y)
    (gx,) = torch.autograd.grad(y, x, dy)
    assert torch.equal(y, F.pad(x, (1, 1, 1, 1), mode="reflect"))
    assert torch.equal(gx, P.pad2d_bwd(dy, x.shape, (1, 1, 1, 1), "reflect"))
    assert P.pad2d.launches == P.pad2d_bwd.launches == 0
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        P._launch(x.detach(), (1, 1, 1, 1), "reflect")


@pytest.mark.parametrize("args,match", [
    (((3, 3, 3, 3), "reflect"), "smaller than the input"),
    (((1, 1, 1), "reflect"), "four widths"),
    (((1, 1, -1, 1), "replicate"), "four widths"),
    (((1, 1, 1, 1), "zeros"), "mode must be"),
])
def test_what_the_wrapper_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        P.pad2d(torch.randn(1, 2, 3, 8), *args)


class _OnCard(torch.Tensor):
    @property
    def is_cuda(self):
        return True


def test_a_card_tensor_goes_to_the_launchers_only(monkeypatch):
    """Forward and backward of a tensor that says it is on the card go to
    the launchers and to nothing else; a failing launcher fails the call."""
    calls = []

    def fwd(x, pads, mode):
        calls.append("fwd")
        return F.pad(x.as_subclass(torch.Tensor), pads, mode=mode)

    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    def bwd_boom(*a, **k):
        calls.append("bwd")
        raise RuntimeError("backward launch refused")

    monkeypatch.setattr(P, "_launch", fwd)
    monkeypatch.setattr(P, "pad2d_plain", no_plain)
    monkeypatch.setattr(P, "pad2d_bwd_plain", no_plain)
    monkeypatch.setattr(P, "_call", bwd_boom)
    monkeypatch.setattr(P, "_launchable", lambda t, what: t)
    x = torch.randn(2, 3, 5, 5).as_subclass(_OnCard).requires_grad_(True)
    y = P.pad2d(x, (1, 1, 1, 1), "replicate")
    dy = torch.ones(y.shape).as_subclass(_OnCard)
    with pytest.raises(RuntimeError, match="backward launch refused"):
        torch.autograd.grad(y, x, dy)
    assert calls == ["fwd", "bwd"]


def test_every_generator_pad_goes_through_the_wrapper(monkeypatch):
    """conv0's 3-pixel pad and two 1-pixel pads per residual block, in
    both generators."""
    seen = []

    def spy(x, pads, mode):
        seen.append((tuple(x.shape), pads, mode))
        return P.pad2d(x, pads, mode)

    monkeypatch.setattr(spatial, "pad2d", spy)
    cfg = TrainConfig(model="aug_cycle_gan", ngf=4, nlatent=8, n_blocks=2)
    nets = build_networks(cfg, torch.Generator().manual_seed(0))
    x = torch.rand(2, 64, 64, 3) * 2 - 1
    nets["netG_A_B"](x, torch.randn(2, 8))
    nets["netG_B_A"](x)
    want = [((2, 3, 64, 64), (3, 3, 3, 3), "reflect")] + \
        [((2, 16, 32, 32), (1, 1, 1, 1), "reflect")] * 4
    assert seen == want * 2
