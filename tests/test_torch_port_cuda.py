"""Tests of the port that need a CUDA device and nvcc (marker ``cuda``); they
skip elsewhere.  Run them on a machine with a card:

    python -m pytest -m cuda tests/test_torch_port_cuda.py -q

This file imports nothing of the JAX package, so it also collects where flax
is not installed.  chip_smoke.py runs the full matrix and the full-width
serving and training paths; these are the small-shape versions.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from domain_transfer_gan_torch.config import (
    TrainConfig,
    load_train_config_from_expr_dir,
)
from domain_transfer_gan_torch.models import create_model
from domain_transfer_gan_torch.ops.kernels import instance_norm as K
from domain_transfer_gan_torch.ops.kernels.instance_norm import (
    instance_norm_bwd_fused,
    instance_norm_bwd_plain,
    instance_norm_fused,
    instance_norm_plain,
)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
def test_kernel_vs_plain_on_the_card():
    _need_card()
    rng = np.random.RandomState(8)
    for per_sample in (False, True):
        # float32: other summation order; bfloat16: one rounding of |y| < 8
        for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 4e-2)):
            n, c = 3, 20
            x = torch.from_numpy(rng.randn(n, 13, 13, c).astype(
                np.float32)).cuda().to(dtype)
            lead = (n, c) if per_sample else (c,)
            scale = torch.from_numpy(rng.rand(*lead).astype(
                np.float32)).cuda()
            shift = torch.from_numpy(rng.randn(*lead).astype(
                np.float32)).cuda()
            before = instance_norm_fused.launches
            got = instance_norm_fused(x, scale, shift, unbiased=True,
                                      relu=True)
            torch.cuda.synchronize()
            assert instance_norm_fused.launches == before + 1
            want = instance_norm_plain(x, scale, shift, unbiased=True,
                                       relu=True)
            assert float((got.float() - want.float()).abs().max()) <= atol


@pytest.mark.cuda
def test_generators_run_the_kernel_at_every_norm_site():
    _need_card()
    torch.backends.cudnn.allow_tf32 = False
    cfg = TrainConfig(model="aug_cycle_gan", grid_size=64, ngf=4, nlatent=8,
                      n_blocks=2, init_scheme="sane", seed=1)
    m = create_model(cfg, testing=True, device="cuda")
    rng = np.random.RandomState(9)
    A = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    z = rng.randn(2, 8).astype(np.float32)
    before = instance_norm_fused.launches
    fake_B = m.predict_B(A, z)
    assert instance_norm_fused.launches - before == 5 + 2 * 2
    before = instance_norm_fused.launches
    fake_A = m.predict_A(A)
    assert instance_norm_fused.launches - before == 5 + 2
    before = instance_norm_fused.launches
    plain_B = m.predict_B(A, z, plain_norm=True)
    plain_A = m.predict_A(A, plain_norm=True)
    assert instance_norm_fused.launches == before  # plain path: no launch
    assert float((fake_B - plain_B).abs().max()) <= 1e-4
    assert float((fake_A - plain_A).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_backward_kernel_vs_plain_on_the_card():
    """dx, dscale, dshift of the backward kernel against its plain version,
    at an odd shape (scalar loads) and an aligned one (16-byte loads), and
    HW = 1 with the unbiased divisor."""
    _need_card()
    rng = np.random.RandomState(10)
    for n, h, w, c in ((3, 13, 13, 20), (4, 8, 16, 32), (2, 1, 1, 8)):
        for affine in ("none", "channel", "sample"):
            for relu in (False, True):
                # float32: sums in another order, relative to the tensor's
                # max; bfloat16 dx: one rounding of a value below 8
                for dtype, tol in ((torch.float32, 1e-5),
                                   (torch.bfloat16, 4e-2)):
                    x = torch.from_numpy(rng.randn(n, h, w, c).astype(
                        np.float32)).cuda().to(dtype)
                    dy = torch.from_numpy(rng.randn(n, h, w, c).astype(
                        np.float32)).cuda().to(dtype)
                    scale = shift = None
                    if affine != "none":
                        lead = (c,) if affine == "channel" else (n, c)
                        scale = torch.from_numpy(rng.rand(*lead).astype(
                            np.float32) + 0.5).cuda()
                        shift = torch.from_numpy(rng.randn(*lead).astype(
                            np.float32)).cuda()
                    kw = dict(unbiased=True, relu=relu)
                    _, mean, rstd = instance_norm_plain(
                        x, scale, shift, return_stats=True, **kw)
                    before = instance_norm_bwd_fused.launches
                    got = instance_norm_bwd_fused(x, dy, mean, rstd, scale,
                                                  shift, **kw)
                    torch.cuda.synchronize()
                    assert instance_norm_bwd_fused.launches == before + 1
                    want = instance_norm_bwd_plain(x, dy, mean, rstd, scale,
                                                   shift, **kw)
                    names = ("dx", "dscale", "dshift")
                    if affine == "none":
                        assert got[1] is None and got[2] is None
                        names = names[:1]
                    for name, g, w_ in zip(names, got, want):
                        ref = max(1.0, float(w_.float().abs().max()))
                        lim = tol if name == "dx" else 1e-5
                        err = float((g.float() - w_.float()).abs().max())
                        assert err <= lim * ref, (name, n, h, w, c, affine,
                                                  relu, dtype, err)


@pytest.mark.cuda
def test_function_backward_runs_the_kernel_and_matches_autograd():
    """Through the autograd.Function: gradients of x, scale and shift from
    the two kernels against autograd of the plain forward, with a
    non-contiguous cotangent."""
    _need_card()
    rng = np.random.RandomState(11)
    n, h, w, c = 2, 8, 8, 16
    x = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32)).cuda()
    scale = torch.from_numpy(rng.rand(c).astype(np.float32) + 0.5).cuda()
    shift = torch.from_numpy(rng.randn(c).astype(np.float32)).cuda()
    # an NHWC view of an NCHW-contiguous weight: the cotangent is strided
    wgt = torch.from_numpy(rng.randn(n, c, h, w).astype(
        np.float32)).cuda().permute(0, 2, 3, 1)
    grads = []
    for fn in (instance_norm_fused, instance_norm_plain):
        leaves = [t.clone().requires_grad_(True) for t in (x, scale, shift)]
        before = (instance_norm_bwd_fused.launches,
                  instance_norm_bwd_fused.dy_copies)
        y = fn(*leaves, unbiased=False, relu=True)
        grads.append(torch.autograd.grad((y * wgt).sum(), leaves))
        after = (instance_norm_bwd_fused.launches,
                 instance_norm_bwd_fused.dy_copies)
        if fn is instance_norm_fused:
            assert after == (before[0] + 1, before[1] + 1)
        else:
            assert after == before
    for g, w_ in zip(*grads):
        assert float((g - w_).abs().max()) <= 1e-4 * max(
            1.0, float(w_.abs().max()))


@pytest.mark.cuda
def test_train_step_fused_vs_plain_on_the_card():
    """One aug_cycle_gan train step at tiny size: the model whose norms run
    the two kernels against its twin with plain norms, same weights and
    inputs; the per-step launch counts."""
    _need_card()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(model="aug_cycle_gan", grid_size=64, ngf=4, nef=4, ndf=4,
               nlatent=8, n_blocks=2, init_scheme="sane", seed=3)
    rng = np.random.RandomState(12)
    A = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    B = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    z = rng.randn(4, 8).astype(np.float32)
    eps = rng.randn(4, 8).astype(np.float32)
    fused = create_model(TrainConfig(**cfg), testing=True, device="cuda")
    plain = create_model(TrainConfig(**cfg), testing=True, device="cuda")
    f0, b0 = instance_norm_fused.launches, instance_norm_bwd_fused.launches
    lf, _, gf = fused.train_instance(A, B, z, eps)
    f1, b1 = instance_norm_fused.launches, instance_norm_bwd_fused.launches
    lp, _, gp = plain.train_instance(A, B, z, eps, plain_norm=True)
    assert (instance_norm_fused.launches,
            instance_norm_bwd_fused.launches) == (f1, b1)
    # per generator pass 9 + 7 norm sites (n_blocks = 2), per discriminator
    # pass 3 + 3: forward 16 + 6 + 6 + 16, backward 6 + 38
    assert (f1 - f0, b1 - b0) == (44, 44)
    for k in lf:
        assert np.isfinite(float(lf[k])), k
        # float32, sums in another order through ~20 layers
        assert abs(float(lf[k]) - float(lp[k])) <= 1e-4 * max(
            1.0, abs(float(lp[k]))), k
    for k in gf:
        assert abs(float(gf[k]) - float(gp[k])) <= 1e-3 * max(
            1.0, abs(float(gp[k]))), k


def _fused_vs_plain(cfg, run):
    """``run(model, plain_norm)`` -> dict of losses and norms, once on a
    model whose norms run the kernels and once on its plain-norm twin;
    returns both dicts and the (forward, backward) launches of the first."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fused = create_model(TrainConfig(**cfg), testing=True, device="cuda")
    plain = create_model(TrainConfig(**cfg), testing=True, device="cuda")
    f0, b0 = instance_norm_fused.launches, instance_norm_bwd_fused.launches
    got = run(fused, False)
    f1, b1 = instance_norm_fused.launches, instance_norm_bwd_fused.launches
    want = run(plain, True)
    assert (instance_norm_fused.launches,
            instance_norm_bwd_fused.launches) == (f1, b1)
    for k in want:
        assert np.isfinite(float(got[k])), k
        # float32, sums in another order through ~20 layers; the norms of
        # the gradients more loosely
        tol = 1e-3 if "gnorm" in k else 1e-4
        assert abs(float(got[k]) - float(want[k])) <= tol * max(
            1.0, abs(float(want[k]))), k
    return f1 - f0, b1 - b0


def _tiny_batch(seed):
    rng = np.random.RandomState(seed)
    A = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    B = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    return A, B, rng.randn(4, 8).astype(np.float32), \
        rng.randn(4, 8).astype(np.float32)


@pytest.mark.cuda
def test_stoch_step_fused_vs_plain_on_the_card():
    """One stoch_cycle_gan step at tiny size, kernels against plain norms;
    the same norm sites as the aug_cycle_gan step (its encoder and latent
    discriminator have batch norms only)."""
    _need_card()
    cfg = dict(model="stoch_cycle_gan", grid_size=64, ngf=4, ndf=4,
               nlatent=8, n_blocks=2, init_scheme="sane", seed=3)
    A, B, z, _ = _tiny_batch(15)

    def run(m, plain_norm):
        losses, _, gnorms = m.train_instance(A, B, z, plain_norm=plain_norm)
        return dict(losses, **gnorms)

    assert _fused_vs_plain(cfg, run) == (44, 44)


@pytest.mark.cuda
def test_the_jax_orbax_fixture_steps_on_the_card():
    """The JAX package's orbax checkpoint ``tests/fixtures/orbax_tiny`` read
    on the card's machine (its libzstd, the OCDBT store), every leaf held to
    its sha256, then one aug_cycle_gan step from it against its plain-norm
    twin."""
    _need_card()
    from domain_transfer_gan_torch.utils.orbax_dir import read_orbax

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "orbax_tiny")
    latest = os.path.join(fixture, "latest")
    with open(os.path.join(fixture, "leaves.json")) as f:
        want = json.load(f)
    got = {}

    def walk(node, keys=()):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, keys + (k,))
        else:
            got[".".join(keys)] = {
                "dtype": node.dtype.str, "shape": list(node.shape),
                "sha256": hashlib.sha256(node.tobytes("C")).hexdigest()}
    walk(read_orbax(latest))
    assert got == want
    opt = load_train_config_from_expr_dir(fixture)
    cfg = {f: getattr(opt, f) for f in TrainConfig.__dataclass_fields__
           if f != "expr_dir"}
    cfg["device"] = "cuda"
    A, B, z, eps = _tiny_batch(21)

    def run(m, plain_norm):
        m.load(latest)
        assert (m.state.step, m.epoch) == (40, 3)
        losses, _, gnorms = m.train_instance(A, B, z, eps,
                                             plain_norm=plain_norm)
        return dict(losses, **(gnorms or {}))

    fwd, bwd = _fused_vs_plain(cfg, run)
    assert fwd > 0 and bwd > 0


@pytest.mark.cuda
def test_supervised_step_fused_vs_plain_on_the_card():
    """One supervised step at tiny size: each generator forward and
    backward once, 9 + 7 norm sites (n_blocks = 2)."""
    _need_card()
    cfg = dict(model="aug_cycle_gan", grid_size=64, ngf=4, nef=4, ndf=4,
               nlatent=8, n_blocks=2, init_scheme="sane", seed=3)
    A, B, z, eps = _tiny_batch(16)

    def run(m, plain_norm):
        return m.supervised_train_instance(A, B, z, eps,
                                           plain_norm=plain_norm)

    assert _fused_vs_plain(cfg, run) == (16, 16)


@pytest.mark.cuda
def test_accumulation_step_fused_vs_plain_on_the_card():
    """One aug_cycle_gan --grad_accum 2 step at batch 8, tiny width,
    kernels against plain norms; per microbatch of 4 (batch norm over 2
    samples is ill-conditioned; n_blocks = 2: 9 + 7 generator sites) the D
    phase's phase 0 (16, forward only) and D_A + D_B at 8 (6), the G phase's
    phase 0 again, the cycles (32) and D_A + D_B at 4 (6)."""
    _need_card()
    cfg = dict(model="aug_cycle_gan", grid_size=64, ngf=4, nef=4, ndf=4,
               nlatent=8, n_blocks=2, init_scheme="sane", seed=3,
               grad_accum=2, batchSize=8)
    rng = np.random.RandomState(17)
    A, B = (rng.uniform(-1, 1, (8, 64, 64, 3)).astype(np.float32)
            for _ in range(2))
    z, eps = (rng.randn(8, 8).astype(np.float32) for _ in range(2))

    def run(m, plain_norm):
        losses, _, gnorms = m.train_instance(A, B, z, eps,
                                             plain_norm=plain_norm)
        return dict(losses, **gnorms)

    assert _fused_vs_plain(cfg, run) == (2 * (48 + 12), 2 * (32 + 12))


@pytest.mark.cuda
def test_remat_step_on_the_card():
    """--remat against the same step without it (cuDNN deterministic):
    the same losses, gradient norms and running statistics, with dropout;
    the recompute adds one forward launch per generator site of the four
    generator calls with a graph."""
    _need_card()
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg = dict(model="aug_cycle_gan", grid_size=64, ngf=4, nef=4, ndf=4,
                   nlatent=8, n_blocks=2, init_scheme="sane", seed=3,
                   use_dropout=1)
        A, B, z, eps = _tiny_batch(18)
        out, launches = {}, {}
        for remat in (False, True):
            m = create_model(TrainConfig(remat=remat, **cfg), testing=True,
                             device="cuda")
            f0 = instance_norm_fused.launches
            losses, _, gnorms = m.train_instance(A, B, z, eps)
            torch.cuda.synchronize()
            launches[remat] = instance_norm_fused.launches - f0
            out[remat] = (dict(losses, **gnorms),
                          [b.clone() for net in m.nets.values()
                           for b in net.buffers()])
        assert launches[True] - launches[False] == 2 * (9 + 7)
        for k, v in out[False][0].items():
            assert abs(float(out[True][0][k]) - float(v)) <= 1e-6 * max(
                1.0, abs(float(v))), k
        assert all(torch.equal(a, b) for a, b in zip(out[False][1],
                                                     out[True][1]))
    finally:
        torch.backends.cudnn.deterministic = deterministic


@pytest.mark.cuda
def test_pool_query_on_the_card_is_the_cpu_one():
    """Replays that pick the same slot resolve to the later element on the
    card as on the CPU: buffer and answer bit for bit."""
    _need_card()
    from domain_transfer_gan_torch.models import pool

    rng = np.random.RandomState(19)
    cpu, card = pool.init_pool(5, (4, 4, 3)), pool.init_pool(
        5, (4, 4, 3), device="cuda")
    for _ in range(6):
        imgs = torch.from_numpy(rng.randn(8, 4, 4, 3).astype(np.float32))
        coin = torch.from_numpy(rng.rand(8) < 0.7)
        slot = torch.from_numpy(rng.randint(0, 5, 8))
        cpu, want = pool.pool_query(cpu, imgs, coin, slot)
        card, got = pool.pool_query(card, imgs.cuda(), coin.cuda(),
                                    slot.cuda())
        assert torch.equal(got.cpu(), want)
        assert torch.equal(card.buf.cpu(), cpu.buf) and card.n == cpu.n


def _variant_plans(n, hw, c, itemsize, arrays):
    """The streaming plan and every cluster size that holds the slab."""
    plans = [K.STREAMING]
    for k in (1, 2, 4, 8, 16):
        try:
            plans.append(K.cluster_plan(n, hw, c, itemsize, arrays, 132,
                                        cluster=k))
        except ValueError:
            pass
    return plans


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 169, 20), (2, 4096, 32),
                                   (4, 16, 128), (2, 1, 8)])
def test_each_forward_variant_vs_plain(shape):
    """Both variants of the forward kernel, the cluster one at every size
    that holds the slab, against the plain version: float32 within 1e-4,
    bfloat16 within one rounding of an output below 8."""
    _need_card()
    n, hw, c = shape
    rng = np.random.RandomState(13)
    for dtype, atol in ((torch.float32, 1e-4), (torch.bfloat16, 4e-2)):
        x = torch.from_numpy(rng.randn(n, 1, hw, c).astype(
            np.float32)).cuda().to(dtype)
        scale = torch.from_numpy(rng.rand(n, c).astype(np.float32)).cuda()
        shift = torch.from_numpy(rng.randn(n, c).astype(np.float32)).cuda()
        want = instance_norm_plain(x, scale, shift, unbiased=True, relu=True,
                                   return_stats=True)
        for plan in _variant_plans(n, hw, c, x.element_size(), 1):
            before = dict(instance_norm_fused.launches_by_variant)
            got = K._launch(x, scale, shift, 1e-5, True, True, plan=plan)
            torch.cuda.synchronize()
            assert instance_norm_fused.launches_by_variant[plan.variant] == \
                before[plan.variant] + 1
            for g, w_, lim in zip(got, want, (atol, 1e-4, 1e-4)):
                err = float((g.float() - w_.float()).abs().max())
                assert err <= lim, (plan, dtype, err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 169, 20), (2, 4096, 32),
                                   (4, 16, 128), (2, 1, 8)])
def test_each_backward_variant_vs_plain(shape):
    """Both variants of the backward kernel, the cluster one at every size
    that holds x and dy, against the plain version, relative to the largest
    |value|: float32 dx and sums within 1e-5, bfloat16 dx within one
    rounding."""
    _need_card()
    n, hw, c = shape
    rng = np.random.RandomState(14)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 4e-2)):
        x = torch.from_numpy(rng.randn(n, 1, hw, c).astype(
            np.float32)).cuda().to(dtype)
        dy = torch.from_numpy(rng.randn(n, 1, hw, c).astype(
            np.float32)).cuda().to(dtype)
        scale = torch.from_numpy(rng.rand(c).astype(np.float32) + .5).cuda()
        shift = torch.from_numpy(rng.randn(c).astype(np.float32)).cuda()
        kw = dict(unbiased=True, relu=True)
        _, mean, rstd = instance_norm_plain(x, scale, shift,
                                            return_stats=True, **kw)
        want = instance_norm_bwd_plain(x, dy, mean, rstd, scale, shift, **kw)
        for plan in _variant_plans(n, hw, c, x.element_size(), 2):
            before = dict(instance_norm_bwd_fused.launches_by_variant)
            got = K._launch_bwd(x, dy, mean, rstd, scale, shift, True, True,
                                plan=plan)
            torch.cuda.synchronize()
            assert instance_norm_bwd_fused.launches_by_variant[
                plan.variant] == before[plan.variant] + 1
            for name, g, w_ in zip(("dx", "dscale", "dshift"), got, want):
                ref = max(1.0, float(w_.float().abs().max()))
                lim = tol if name == "dx" else 1e-5
                err = float((g.float() - w_.float()).abs().max())
                assert err <= lim * ref, (plan, dtype, name, err)


@pytest.mark.cuda
def test_path_shapes_take_the_cluster_variant():
    """At a generator shape the wrappers launch the cluster variant."""
    _need_card()
    x = torch.randn(4, 32, 32, 128, device="cuda", requires_grad=True)
    fwd = dict(instance_norm_fused.launches_by_variant)
    bwd = dict(instance_norm_bwd_fused.launches_by_variant)
    instance_norm_fused(x, None, None, relu=True).sum().backward()
    torch.cuda.synchronize()
    assert instance_norm_fused.launches_by_variant == dict(
        fwd, cluster=fwd["cluster"] + 1)
    assert instance_norm_bwd_fused.launches_by_variant == dict(
        bwd, cluster=bwd["cluster"] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1, 2, 3])
def test_prefetch_feed_on_the_card_is_the_synchronous_copy(size):
    """data/feed.py on the card: the batches (a short tail among them) come
    out in order, bit-equal to a synchronous copy, while the step's stream
    is kept busy and the host overwrites the arrays it handed over; each
    tensor is readable on the step's stream once handed out."""
    _need_card()
    from domain_transfer_gan_torch.data.feed import prefetch_to_device

    rng = np.random.RandomState(size)
    host = [{"A": rng.rand(k, 64, 64, 3).astype(np.float32),
             "B": rng.rand(k, 64, 64, 1).astype(np.float32)}
            for k in (8, 8, 8, 8, 8, 3)]
    want = [{k: torch.from_numpy(v.copy()).cuda() for k, v in b.items()}
            for b in host]
    busy = torch.randn(2048, 2048, device="cuda")

    def batches():
        for b in host:
            yield b
            for v in b.values():
                v.fill(-1.0)

    got = []
    for out in prefetch_to_device(batches(), "cuda", size=size):
        for _ in range(3):  # queue device work ahead of the next copies
            busy = busy @ busy / 2048.0
        got.append({k: v.clone() for k, v in out.items()})
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            assert g[k].device.type == "cuda"
            assert torch.equal(g[k], w[k]), k


class _OneSlice:
    """The split norm's collectives over a single slice: nothing to
    combine (the statistics are the slice's, the sums its own)."""

    def combine(self, mean, m2, rows):
        return mean, m2, rows

    def sum_(self, t):
        return t


@pytest.mark.cuda
def test_split_kernels_vs_their_twins_on_the_card():
    """K1-split and K2-split (four launches) against their plain twins at a
    small shape, each wrapper counting its launch."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((3, 8, 6, 16), generator=g, device="cuda")
    dy = torch.randn(x.shape, generator=g, device="cuda")
    scale = torch.rand((3, 16), generator=g, device="cuda") + 0.5
    shift = torch.randn((3, 16), generator=g, device="cuda")
    before = [w.launches for w in K.SPLIT_WRAPPERS]
    mean, m2 = K.instance_norm_partial_stats(x)
    pm, pq = K.instance_norm_partial_stats_plain(x)
    torch.testing.assert_close(mean, pm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(m2, pq, rtol=1e-5, atol=1e-4)
    rstd = torch.rsqrt(m2 / 48 * (48 / 47) + 1e-5)
    y = K.instance_norm_apply(x, mean, rstd, scale, shift, relu=True)
    torch.testing.assert_close(y, K.instance_norm_apply_plain(
        x, mean, rstd, scale, shift, relu=True), rtol=1e-5, atol=1e-5)
    sg, sgx = K.instance_norm_bwd_partial_sums(x, dy, mean, rstd, scale,
                                               shift, relu=True)
    psg, psgx = K.instance_norm_bwd_partial_sums_plain(
        x, dy, mean, rstd, scale, shift, relu=True)
    torch.testing.assert_close(sg, psg, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sgx, psgx, rtol=1e-4, atol=1e-4)
    dx = K.instance_norm_bwd_apply_dx(x, dy, mean, rstd, scale, shift, sg,
                                      sgx, 48, unbiased=True, relu=True)
    torch.testing.assert_close(dx, K.instance_norm_bwd_apply_dx_plain(
        x, dy, mean, rstd, scale, shift, sg, sgx, 48, unbiased=True,
        relu=True), rtol=1e-4, atol=1e-4)
    torch.cuda.synchronize()
    assert [w.launches for w in K.SPLIT_WRAPPERS] == [b + 1 for b in before]
    # both variants of the two reductions at a headline rank shape, a
    # 256x256 rank's and a discriminator site's, each counted by variant;
    # the cluster variant twice, bit for bit the same
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, hw, c in ((32, 512, 128), (8, 32768, 32), (32, 8, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((n, hw, 1, c), generator=g, device="cuda")
                 * 1.5 + 0.5).to(dtype)
            dy = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
            scale = torch.rand((n, c), generator=g, device="cuda") + 0.5
            shift = torch.randn((n, c), generator=g, device="cuda")
            pm, pq = K.instance_norm_partial_stats_plain(x)
            rstd = torch.rsqrt(pq / hw + 1e-5)
            psg, psgx = K.instance_norm_bwd_partial_sums_plain(
                x, dy, pm, rstd, scale, shift, relu=True)
            for arrays, plan in ((a, p) for a in (1, 2) for p in (
                    K.split_plan(n, hw, c, x.element_size(), a, sms,
                                 on_chip=True), K.SPLIT_ROWS)):
                wrapper = K.SPLIT_REDUCTIONS[arrays - 1]
                before = dict(wrapper.launches_by_variant)
                if arrays == 1:
                    def run():
                        return K.instance_norm_partial_stats(x, plan=plan)
                    want = (pm, pq)
                else:
                    def run():
                        return K.instance_norm_bwd_partial_sums(
                            x, dy, pm, rstd, scale, shift, relu=True,
                            plan=plan)
                    want = (psg, psgx)
                got = run()
                for a, b in zip(got, want):
                    torch.testing.assert_close(
                        a, b, rtol=1e-5, atol=1e-4 * max(1.0, float(
                            b.abs().max())))
                if plan.variant == "cluster":
                    assert all(torch.equal(a, b) for a, b in zip(got, run()))
                torch.cuda.synchronize()
                runs = 2 if plan.variant == "cluster" else 1
                assert wrapper.launches_by_variant[plan.variant] == \
                    before.get(plan.variant, 0) + runs


@pytest.mark.cuda
def test_the_split_function_over_one_slice_is_the_fused_norm():
    """The autograd Function of the split kernels, over one slice, gives
    the unsplit kernels' y and gradients."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((2, 8, 8, 16), generator=g, device="cuda")
    scale = (torch.rand((16,), generator=g, device="cuda") + 0.5)
    shift = torch.randn((16,), generator=g, device="cuda")
    dy = torch.randn(x.shape, generator=g, device="cuda")
    grads = []
    for split in (True, False):
        xs, ss, ts = (t.clone().requires_grad_(True)
                      for t in (x, scale, shift))
        if split:
            y = K.instance_norm_split(xs, ss, ts, _OneSlice(), relu=True)
        else:
            y = instance_norm_fused(xs, ss, ts, relu=True)
        grads.append([y] + list(torch.autograd.grad(y, (xs, ss, ts), dy)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 65536, 32), (8, 16384, 128),
                                   (2, 3969, 512)],
                         ids=lambda s: "%dx%dx%d" % s)
def test_ring_route_vs_plain(shape):
    """K1's and K2's ring route at 256x256 generator sites, where no
    cluster holds a sample's slab, and at wide rows whose ring the plan
    narrows to fit a CTA: the plan's pick, against the plain
    versions (float32 within 1e-4, dx and sums within 1e-5 of the largest
    |value|; bfloat16 within one rounding), counted once per call as
    "ring", and a repeated launch bit for bit the first."""
    _need_card()
    n, hw, c = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(hw + c)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 4e-2)):
        h = 256 if hw % 256 == 0 else int(hw ** 0.5)
        x = (torch.randn((n, h, hw // h, c), generator=g, device="cuda")
             * 1.5 + 0.5).to(dtype)
        dy = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
        scale = torch.rand((n, c), generator=g, device="cuda") + 0.5
        shift = torch.randn((n, c), generator=g, device="cuda")
        kw = dict(unbiased=True, relu=True)
        for arrays in (1, 2):
            plan = K.cluster_plan(n, hw, c, x.element_size(), arrays, sms)
            assert plan.variant == "ring"
            wrapper = (instance_norm_fused, instance_norm_bwd_fused)[
                arrays - 1]
            before = dict(wrapper.launches_by_variant)
            if arrays == 1:
                def run():
                    return K._launch(x, scale, shift, 1e-5, True, True)
                want = instance_norm_plain(x, scale, shift,
                                           return_stats=True, **kw)
                lims = (4e-2 if dtype == torch.bfloat16 else 1e-4, 1e-4,
                        1e-4)
            else:
                _, mean, rstd = instance_norm_plain(x, scale, shift,
                                                    return_stats=True, **kw)

                def run():
                    return K._launch_bwd(x, dy, mean, rstd, scale, shift,
                                         True, True)
                want = instance_norm_bwd_plain(x, dy, mean, rstd, scale,
                                               shift, **kw)
                lims = (tol, 1e-5, 1e-5)
            got = run()
            torch.cuda.synchronize()
            for gt, w_, lim in zip(got, want, lims):
                ref = 1.0 if arrays == 1 else max(
                    1.0, float(w_.float().abs().max()))
                err = float((gt.float() - w_.float()).abs().max())
                assert err <= lim * ref, (shape, dtype, arrays, err)
            assert all(torch.equal(a, b) for a, b in zip(got, run()))
            torch.cuda.synchronize()
            assert wrapper.launches_by_variant["ring"] == before["ring"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pads,mode,dtype", [
    ((4, 3, 64, 64), (3, 3, 3, 3), "reflect", torch.float32),
    ((4, 128, 32, 32), (1, 1, 1, 1), "reflect", torch.float32),
    ((4, 128, 32, 32), (1, 1, 1, 1), "reflect", torch.bfloat16),
    ((3, 16, 18, 32), (1, 1, 0, 0), "reflect", torch.float32),
    ((2, 5, 7, 6), (2, 1, 0, 3), "replicate", torch.float32),
    ((2, 3, 9, 9), (3, 3, 3, 3), "replicate", torch.bfloat16),
])
def test_pad_kernels_vs_f_pad_on_the_card(shape, pads, mode, dtype):
    """The forward is F.pad bit for bit; the backward is F.pad's within
    1e-6 of max |dx| in float32 (bfloat16: one ulp of the float32
    backward) and repeats bit for bit."""
    _need_card()
    from domain_transfer_gan_torch.ops.kernels import pad as P

    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    before = (P.pad2d.launches, P.pad2d_bwd.launches)
    y = P.pad2d(x, pads, mode)
    assert torch.equal(y, torch.nn.functional.pad(x, pads, mode=mode))
    dy = torch.randn(y.shape, generator=g, device="cuda").to(dtype)
    (dx,) = torch.autograd.grad(y, x, dy)
    again = P.pad2d_bwd(dy, shape, pads, mode)
    assert (P.pad2d.launches, P.pad2d_bwd.launches) == (before[0] + 1,
                                                        before[1] + 2)
    assert torch.equal(dx, again)
    want = P.pad2d_bwd_plain(dy.float(), shape, pads, mode)
    if dtype == torch.float32:
        assert float((dx - want).abs().max()) <= 1e-6 * float(
            want.abs().max())
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(2.0 ** -100))) - 7.0)
        assert float(((dx.float() - want.to(dtype).float()).abs()
                      / ulp).max()) <= 1.0


def _pad_case(shape, pads, mode, dtype, offset=0, seed=5):
    """x (channels_last, its data ``offset`` elements into its storage, so
    at any phase mod 16), F.pad of it, a cotangent at the same offset."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def placed(s):
        n, c, h, w = s
        flat = torch.randn(n * h * w * c + offset, generator=g,
                           device="cuda").to(dtype)
        return flat[offset:].view(n, h, w, c).permute(0, 3, 1, 2)

    x = placed(shape)
    y = torch.nn.functional.pad(x, pads, mode=mode)
    return x, y, placed(tuple(y.shape))


def _forced(monkeypatch, P, kernel):
    """Every pad launch takes ``kernel``: the band kernels (two rows a
    band, 128 threads) or the word kernels."""
    plan = P.PadPlan(2, 128, 0, False) if kernel == "band" else P.WORDS
    monkeypatch.setattr(P, "pad_plan", lambda *a, **k: plan)


def _hold_pads(P, x, want_y, dy, shape, pads, mode, dtype):
    """The forward is F.pad bit for bit; the backward repeats bit for bit
    and is F.pad's within 1e-6 of max |dx| (float32) or one ulp of the
    float32 backward (bfloat16)."""
    assert torch.equal(P._launch(x, pads, mode), want_y)
    dx, again = (P.pad2d_bwd(dy, shape, pads, mode) for _ in range(2))
    assert torch.equal(dx, again)
    want = P.pad2d_bwd_plain(dy.float(), shape, pads, mode)
    if dtype == torch.float32:
        assert float((dx - want).abs().max()) <= 1e-6 * float(
            want.abs().max())
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(2.0 ** -100))) - 7.0)
        assert float(((dx.float() - want.to(dtype).float()).abs()
                      / ulp).max()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["band", "words"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["reflect", "replicate"])
@pytest.mark.parametrize("shape,pads", [((32, 3, 64, 64), (3, 3, 3, 3)),
                                        ((32, 128, 32, 32), (1, 1, 1, 1))])
def test_pads_at_conv0s_and_a_blocks_site(shape, pads, mode, dtype, kernel,
                                          monkeypatch):
    """Both pad kernels at the generators' two pad sites at the published
    batch, each direction and mode (``_hold_pads``)."""
    _need_card()
    from domain_transfer_gan_torch.ops.kernels import pad as P

    _forced(monkeypatch, P, kernel)
    _hold_pads(P, *_pad_case(shape, pads, mode, dtype), shape, pads, mode,
               dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["band", "words"])
@pytest.mark.parametrize("shape,pads,mode,dtype,offset", [
    ((3, 3, 9, 7), (3, 3, 3, 3), "reflect", torch.float32, 1),
    ((3, 3, 9, 7), (2, 1, 3, 0), "replicate", torch.bfloat16, 3),
    ((2, 5, 6, 64), (1, 1, 1, 1), "reflect", torch.bfloat16, 7),
    ((2, 16, 18, 32), (1, 1, 0, 0), "reflect", torch.float32, 2),
])
def test_pads_at_any_phase(shape, pads, mode, dtype, offset, kernel,
                           monkeypatch):
    """Tensors whose data start off 16 bytes, so that a band's first and
    last bytes are stored apart from its 16-byte chunks (``_hold_pads``)."""
    _need_card()
    from domain_transfer_gan_torch.ops.kernels import pad as P

    _forced(monkeypatch, P, kernel)
    _hold_pads(P, *_pad_case(shape, pads, mode, dtype, offset), shape, pads,
               mode, dtype)


@pytest.mark.cuda
def test_the_pad_plan_on_the_card():
    """The wrapper's own pick at conv0's site launches the band kernel,
    at a block's the word kernels, and both give F.pad."""
    _need_card()
    from domain_transfer_gan_torch.ops.kernels import pad as P

    for shape, pads, kernel in (((32, 3, 64, 64), (3,) * 4, "band"),
                                ((32, 128, 32, 32), (1,) * 4, "words")):
        x, want_y, _ = _pad_case(shape, pads, "reflect", torch.float32)
        before = dict(P.pad2d.launches_by_kernel)
        assert torch.equal(P.pad2d(x, pads, "reflect"), want_y)
        assert P.pad2d.launches_by_kernel[kernel] == before[kernel] + 1


@pytest.mark.cuda
def test_profile_dir_after_profiler_sessions_names_k1_and_k2(tmp_path):
    """ROADMAP F7's order, short: profiler sessions in a row in one
    process, then a training CLI run with --profile_dir, whose trace must
    name K1 and K2 and whose log counts the card's kernels in it."""
    _need_card()
    import json
    import os

    from domain_transfer_gan_torch.cli.train import train_model
    from domain_transfer_gan_torch.data.synthetic import \
        write_synthetic_perfile_dataset
    from domain_transfer_gan_torch.utils import timing

    cfg = TrainConfig(model="aug_cycle_gan", grid_size=64, ngf=4, nef=4,
                      ndf=4, nlatent=8)
    m = create_model(cfg, testing=True, device="cuda")
    A = torch.rand(2, 64, 64, 3, device="cuda") * 2 - 1
    for _ in range(3):
        timing.profile_window(lambda: m.train_instance(A, A), reps=1)
    root, prof = str(tmp_path / "pf"), str(tmp_path / "prof")
    write_synthetic_perfile_dataset(root, n_train=48, n_test=8, size=64,
                                    seed=1)
    train_model(argv=[
        "--dataroot", root, "--name", "f7", "--checkpoints_dir",
        str(tmp_path), "--grid_size", "64", "--batchSize", "2", "--ngf", "4",
        "--nef", "4", "--ndf", "4", "--nlatent", "8", "--niter", "1",
        "--niter_decay", "0", "--save_epoch_freq", "0", "--eval_A_freq",
        "0", "--eval_B_freq", "0", "--display_freq", "0", "--dev_size", "8",
        "--numpy_data", "0", "--nThreads", "2", "--device", "cuda",
        "--num_devices", "1", "--profile_dir", prof])
    with open(os.path.join(prof, "trace.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    assert any("instance_norm_fwd" in n for n in names)
    assert any("instance_norm_bwd" in n for n in names)
    with open(os.path.join(str(tmp_path), "f7", "results.txt")) as f:
        log = f.read()
    assert "kernel events of the card" in log and "WARNING" not in log


@pytest.mark.cuda
def test_fid_extractor_artifact_on_the_card_against_the_builtin():
    """The JAX package's width-64 proxy net as a jax.export artifact, run by
    the port's StableHLO interpreter on the card, against the built-in
    extractor (the same weights) on the same images: features within
    1e-4 x max |feature| with TF32 off, FID within 1e-3 relative."""
    _need_card()
    from domain_transfer_gan_torch.eval import fid

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "jax_export", "proxy_w64_64x64x3.jaxexp")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.RandomState(15)
        real = rng.uniform(-1, 1, (70, 64, 64, 3)).astype(np.float32)
        fake = np.clip(real + 0.3 * rng.randn(*real.shape), -1, 1).astype(
            np.float32)
        ext = fid.load_extractor(path)  # on the card by default
        builtin = fid.random_feature_extractor()
        got, want = ext(real), builtin(real)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        a = fid.compute_fid(real, fake, ext)
        b = fid.compute_fid(real, fake, builtin)
        assert abs(a - b) <= 1e-3 * abs(b)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


@pytest.mark.cuda
def test_jax_export_directories_served_on_the_card():
    """The JAX package's tiny export directories (tests/fixtures/jax_serve,
    lowered for tpu and for cpu + tpu) behind cli/serve.py on the card,
    interpreted with TF32 off, against exp.call's committed outputs on the
    fixture's inputs (tests/fixtures/jax_serve_inputs.py): float32 within
    1e-4, bfloat16 within max 0.1 / mean 0.012; no instance-norm kernel
    launches for them."""
    _need_card()
    import importlib.util
    import io
    import threading
    import urllib.request

    from domain_transfer_gan_torch.cli.serve import build_server

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures")
    root = os.path.join(fixtures, "jax_serve")
    spec = importlib.util.spec_from_file_location(
        "jax_serve_inputs", os.path.join(fixtures, "jax_serve_inputs.py"))
    draw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(draw)
    with open(os.path.join(root, "index.json")) as f:
        index = json.load(f)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    before = (instance_norm_fused.launches, instance_norm_bwd_fused.launches)
    try:
        for name in sorted(n for n in index if index[n]["ngf"] == 4):
            d = os.path.join(root, name)
            with open(os.path.join(d, "manifest.json")) as f:
                x = draw.inputs(json.load(f), index[name]["seed"])
            srv = build_server(d, port=0)
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            try:
                got = {}
                for fn, arrays in (("predict_B", {"A": x["A"], "z": x["z"]}),
                                   ("predict_A", {"B": x["B"]})):
                    buf = io.BytesIO()
                    np.savez(buf, **arrays)
                    req = urllib.request.Request(
                        "http://127.0.0.1:%d/%s" % (srv.server_address[1],
                                                    fn),
                        data=buf.getvalue(), method="POST")
                    with urllib.request.urlopen(req, timeout=60) as resp:
                        got[fn] = np.load(io.BytesIO(resp.read()))
            finally:
                srv.shutdown()
                srv.server_close()
                thread.join(timeout=30)
            with np.load(os.path.join(root, name + ".outputs.npz")) as want:
                for fn, y in got.items():
                    err = np.abs(y - want[fn])
                    if index[name]["serve_dtype"] == "float32":
                        assert err.max() <= 1e-4, (name, fn, err.max())
                    else:
                        assert err.max() <= 0.1 and err.mean() <= 0.012, (
                            name, fn, err.max(), err.mean())
        assert (instance_norm_fused.launches,
                instance_norm_bwd_fused.launches) == before
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
