"""The pad wrapper (``ops/kernels/pad.py``) on the CPU: its plain path
against ``F.pad`` and against the JAX package's ``reflect_pad2d`` /
``replicate_pad2d`` and their VJP; the kernels' source map and fixed-order
gather (``csrc/pad.cu``) emulated in numpy against ``F.pad``'s CPU backward
bit for bit; the band kernels' chunks (16-byte stores, the ends off 16
bytes, stepped counters) emulated against ``F.pad``; the band geometry
(``pad_plan``) at every shape the main path pads; the routing (a CPU tensor
to ``F.pad``, a card tensor to the launchers and nothing else); and the
networks' pads going through it.  The kernels themselves run in
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``."""

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

from torch_port_helpers import load_chip_smoke

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


# --- the band kernels, chunk by chunk ------------------------------------

def _pixel_word(pixel_bytes, *addrs):
    """csrc/pad.cu::pad2d_fwd's word: the widest of 16, 8, 4, 2 bytes that
    divides a pixel and both tensors' addresses."""
    return next(b for b in (16, 8, 4, 2)
                if pixel_bytes % b == 0 and all(a % b == 0 for a in addrs))


def _src(j, n, reflect):
    return int(_source(np.array(j), n, "reflect" if reflect else
                       "replicate"))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("mode", ["reflect", "replicate"])
def test_the_band_geometry_at_every_main_path_pad(backward, mode):
    """``pad_plan`` at every (shape, pads, dtype) ``chip_smoke.py`` holds
    the pads at (``PAD_SHAPES``, what the main path launches), in both
    modes: the word kernels where a pixel is a multiple of 16 bytes (and a
    backward's dy is small), else bands; every row banded exactly once;
    every band starting and ending on 16 bytes where it claims to; at least
    two bands a multiprocessor where bands of one step give that many; the
    forward's source table within its shared memory."""
    cs = load_chip_smoke()
    banded = 0
    for n, c, h, w, pads, _, dtype in sorted(cs.PAD_SHAPES, key=str):
        item = 4 if dtype == "float32" else 2
        plan = P.pad_plan((n, c, h, w), pads, mode, item, backward)
        left, right, top, bottom = pads
        ho, wo = h + top + bottom, w + left + right
        what = (n, c, h, w, pads, dtype, plan)
        words = c * item % 16 == 0 or (
            backward and n * ho * wo * c * item < P.BAND_BWD_MIN_BYTES)
        assert (plan == P.WORDS) == words, what
        if words:
            continue
        banded += 1
        length = h if backward else ho
        row = (w if backward else wo) * c * item
        assert (plan.bands - 1) * plan.rows < length <= plan.bands * \
            plan.rows, what
        assert plan.threads in (P.BAND_THREADS, 2 * P.BAND_THREADS), what
        if plan.store16:
            starts = [(s * length + b * plan.rows) * row for s in range(n)
                      for b in range(plan.bands)]
            assert all(a % 16 == 0 for a in starts), what
            assert length * row % 16 == 0, what
        step = 16 // np.gcd(row, 16) if plan.store16 else 1
        assert plan.rows % step == 0, what
        if n * -(-length // step) >= 2 * P.SMS:
            assert n * plan.bands >= 2 * P.SMS, what
        if not backward:
            assert 2 * wo * c * item <= P.TABLE_BYTES_MAX, what
    assert banded >= (6 if backward else 20)  # conv0's sites


def test_conv0s_rows_are_banded_in_pairs():
    """conv0's float32 output rows are 840 bytes: bands of an even number
    of rows start on 16 bytes (1680 = 105 * 16)."""
    plan = P.pad_plan((32, 3, 64, 64), (3,) * 4, "reflect", 4, False)
    assert plan.store16 and plan.rows % 2 == 0


def test_wide_pixels_and_small_backwards_take_the_word_kernels():
    """A residual block's 512-byte pixels take the word kernels both ways;
    conv0's backward takes them below BAND_BWD_MIN_BYTES of dy (batch 32)
    and the band kernel above it (batch 128); a forward whose source table
    would not fit at 2-byte words (a row of 65536 two-channel float32
    pixels) the word kernel."""
    for backward in (False, True):
        assert P.pad_plan((32, 128, 32, 32), (1,) * 4, "reflect", 4,
                          backward) == P.WORDS
    conv0 = ((3, 64, 64), (3,) * 4, "reflect", 4, True)
    assert P.pad_plan((32,) + conv0[0], *conv0[1:]) == P.WORDS
    assert P.pad_plan((128,) + conv0[0], *conv0[1:]).rows > 0
    assert P.pad_plan((1, 2, 2, 65536), (1,) * 4, "reflect", 4,
                      False) == P.WORDS


def _band_fwd(x, pads, mode, rows, phase=(0, 0)):
    """pad2d_band_fwd_kernel over every CTA and thread: each 16-byte
    chunk of a band's output gathered word by word (the row and column
    counters stepped as the kernel steps them), the ends off 16 bytes word
    by word; y at phase[1] mod 16 (x's phase only sets the word)."""
    left, right, top, bottom = pads
    reflect = mode == "reflect"
    n, h, w, c = x.shape
    ho, wo = h + top + bottom, w + left + right
    word = _pixel_word(c * x.itemsize, phase[0], phase[1])
    pw, v = c * x.itemsize // word, 16 // word
    in_words, out_words = w * pw, wo * pw
    xw = np.frombuffer(x.tobytes(), "u%d" % word if word < 16 else "V16")
    yw = np.zeros(n * ho * out_words, xw.dtype)
    written = np.zeros(len(yw), np.int32)
    table = [_src(j // pw - left, w, reflect) * pw + j % pw
             for j in range(out_words)]
    bands = -(-ho // rows)
    for sample, band in itertools.product(range(n), range(bands)):
        o0 = band * rows
        words = min(rows, ho - o0) * out_words
        ys = (sample * ho + o0) * out_words  # the band's first word
        head = min(words, (16 - (phase[1] + ys * word) % 16) % 16 // word)
        chunks = (words - head) // v
        tail = head + chunks * v

        def word_at(r, j):
            return xw[sample * h * in_words + _src(o0 + r - top, h, reflect)
                      * in_words + table[j]]

        for at in list(range(head)) + list(range(tail, words)):
            yw[ys + at] = word_at(at // out_words, at % out_words)
            written[ys + at] += 1
        for k in range(chunks):
            e = head + k * v
            assert (phase[1] + (ys + e) * word) % 16 == 0
            r, j = divmod(e, out_words)
            for i in range(v):
                yw[ys + e + i] = word_at(r, j)
                written[ys + e + i] += 1
                j += 1
                if j == out_words:
                    j, r = 0, r + 1
    assert (written == 1).all()
    return np.frombuffer(yw.tobytes(), x.dtype).reshape(n, ho, wo, c)


def _band_bwd(dy, h, w, pads, mode, rows, phase=0):
    """pad2d_band_bwd_kernel (float32) over every CTA and thread: each
    16-byte chunk of a band's dx (4 channels of a pixel where C % 4 == 0,
    else 4 elements one by one), each element's sum in the kernel's order;
    dx at phase mod 16."""
    left, right, top, bottom = pads
    n, ho, wo, c = dy.shape
    dx = np.zeros(n * h * w * c, np.float32)
    written = np.zeros(len(dx), np.int32)
    packed = c % 4 == 0 and phase == 0

    def element(sample, e, i0):
        pixel, ch = divmod(e, c)
        r, iw = divmod(pixel, w)
        acc = np.float32(0)
        for a in _sources(i0 + r, h, top, bottom, mode):
            for b in _sources(iw, w, left, right, mode):
                acc = np.float32(acc + dy[sample, a, b, ch])
        return acc

    for sample, band in itertools.product(range(n), range(-(-h // rows))):
        i0 = band * rows
        elems = min(rows, h - i0) * w * c
        xs = (sample * h + i0) * w * c
        head = min(elems, (16 - (phase + xs * 4) % 16) % 16 // 4)
        chunks = (elems - head) // 4
        tail = head + chunks * 4
        assert not packed or head == 0
        for e in list(range(head)) + list(range(tail, elems)) + [
                head + k * 4 + i for k in range(chunks) for i in range(4)]:
            dx[xs + e] = element(sample, e, i0)
            written[xs + e] += 1
    assert (written == 1).all()
    return dx.reshape(n, h, w, c)


@pytest.mark.parametrize("mode,pads,hw,c,dtype,rows,phase", [
    ("reflect", (3, 3, 3, 3), (9, 7), 3, np.float32, 2, (0, 0)),
    ("reflect", (3, 3, 3, 3), (9, 7), 3, np.float32, 5, (4, 8)),
    ("reflect", (1, 1, 1, 1), (6, 5), 8, np.float32, 1, (0, 12)),
    ("reflect", (3, 3, 3, 3), (9, 7), 3, np.uint16, 4, (2, 6)),
    ("reflect", (1, 1, 0, 0), (4, 6), 16, np.uint16, 1, (0, 0)),
    ("replicate", (2, 0, 1, 3), (6, 5), 4, np.float32, 3, (8, 4)),
    ("replicate", (0, 1, 2, 0), (1, 2), 3, np.float32, 1, (4, 4)),
])
def test_the_band_kernels_are_f_pads(mode, pads, hw, c, dtype, rows,
                                            phase):
    """The band kernels emulated chunk by chunk, at uneven bands and
    every phase mod 16 (the ends off 16 bytes): the forward is ``F.pad``'s
    output, the backward (float32) ``F.pad``'s CPU backward, bit for bit;
    every word and element written exactly once."""
    h, w = hw
    rng = np.random.RandomState(h * w + c + 1)
    x = rng.randint(0, 2 ** 15, (2, h, w, c)).astype(dtype) \
        if dtype == np.uint16 else rng.randn(2, h, w, c).astype(dtype)
    y = _band_fwd(x, pads, mode, rows, phase)
    xt = torch.from_numpy(x.astype(np.float32))
    want = F.pad(xt.permute(0, 3, 1, 2), pads, mode=mode).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(y.astype(np.float32), want.numpy())
    if dtype != np.float32:
        return
    xt = xt.permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    yt = F.pad(xt, pads, mode=mode)
    dy = rng.randn(*yt.shape).astype(np.float32) * np.float32(1e3)
    (gx,) = torch.autograd.grad(yt, xt, torch.from_numpy(dy))
    dx = _band_bwd(np.ascontiguousarray(dy.transpose(0, 2, 3, 1)), h, w,
                     pads, mode, rows, phase[1])
    np.testing.assert_array_equal(dx, gx.permute(0, 2, 3, 1).numpy())
