"""The launch plan of the instance-norm kernels (``cluster_plan``), on the
CPU: which variant each shape gets, that the on-chip variant's row ranges
and bulk copies are legal, and an emulation of its split reduction (per-CTA
partials over the plan's rows, in the kernel's order, added in rank order)
held to the plain versions.  No JAX: these are pure CPU torch and take well
under a second each.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from domain_transfer_gan_torch.ops.kernels import instance_norm as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132  # an H100 SXM


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
EDGE = ((2, 4096, 4), (3, 169, 20), (4, 65536, 32))
SHAPES = tuple(dict.fromkeys(CS.CHECK_SHAPES + EDGE))
# every norm site of the serving path (both dtypes, batch 32) and of the
# train steps chip_smoke.py takes (float32 at batch 32 and 128, bfloat16 at
# batch 128), per itemsize
PATH_BY_ITEMSIZE = {
    4: set(CS.PATH_SHAPES) | set(CS.train_sites(32)) | set(CS.train_sites(128)),
    2: set(CS.PATH_SHAPES) | set(CS.train_sites(128)),
}
PATH = PATH_BY_ITEMSIZE[4] | PATH_BY_ITEMSIZE[2]
GENERATOR = {s for s in PATH if s[1] >= 1024}
# the generator sites of the training CLI (float32): the eval batch of 100,
# its tail of 50, the grids at 10, 25 and 250; and those of the evaluation
# CLI besides: its batch of 200, the test set of 150, the train subset of
# 64, the inference header of 5 and the z-diversity decode of 320
CLI = {s for n in CS.CLI_BATCHES for s in CS.gen_sites(n, "B")}
TEST_CLI = {s for n in CS.TEST_CLI_BATCHES for s in CS.gen_sites(n, "B")}
# the --grad_accum 4 microbatch sites of chip_smoke.py's phase 9
EXTRAS = set(CS.EXTRAS_SHAPES)
# samples too large for any cluster at some dtype and kernel: the 256x256
# request and phase 9's 256x256 sites (ROADMAP K-a); each is streamed
HUGE = {(4, 65536, 32)} | set(CS.accum_sites(32, CS.ACCUM_K, hw=256)["fwd"])
# phase 10's tails: the per-file train step's tail of 19 (its
# discriminators' pass at 38) and the per-file eval tail of 30
P10 = set(CS.P10_SHAPES)
# phase 11's ranks: the generator sites at half the float32 batch of 32 and
# half the bfloat16 batch of 128 (all but one are sites of other phases)
P11 = set(CS.P11_SHAPES)
P11_NEW = P11 - (PATH | CLI | TEST_CLI | EXTRAS | P10)


def test_the_shapes_are_the_smoke_tests():
    assert len(SHAPES) == len(CS.CHECK_SHAPES) == \
        34 + len(CLI | TEST_CLI) + len(EXTRAS) + len(P10) + len(P11_NEW)
    assert len(P10) == 3 + 12 + 3
    assert not P10 & (PATH | CLI | TEST_CLI | EXTRAS)
    assert len(P11) == 2 * 3 and P11_NEW == {(16, 4096, 32)}
    assert P11 <= set(SHAPES)
    # microbatches of 8 at 64x64 and 256x256 (discriminators at 16 and 8),
    # a few sites shared between the two grids
    assert len(EXTRAS) == 2 * (3 + 12) - 4
    assert not EXTRAS & (PATH | CLI | TEST_CLI)
    assert len(GENERATOR) == 6 and len(PATH) == 6 + 4 * 6
    assert len(CLI) == 5 * 3 and not CLI & PATH
    assert len(TEST_CLI - CLI) == 5 * 3 and not TEST_CLI & PATH
    assert PATH | CLI | TEST_CLI <= set(SHAPES)
    assert {s for s, _, _ in STREAMED} <= PATH


# discriminator sites whose samples hold 32-256 KB of x in a batch of fewer
# samples than half the SMs, or whose slab needs a cluster of two or more
# CTAs: the plan sends them to the streaming variant, which the card
# measured faster there (PERF.md)
MID = ((256, 128), (256, 64), (225, 256), (196, 256))
STREAMED = {  # (shape, itemsize, arrays)
    ((n, hw, c), 4, arrays) for n in (32, 64) for hw, c in MID
    for arrays in (1, 2)} | {
    ((n, 225, 256), 2, 2) for n in (128, 256)} | {
    ((n, hw, c), 4, arrays) for n in (128, 256)
    for hw, c, arrays in ((256, 128, 2), (225, 256, 1), (225, 256, 2),
                          (196, 256, 2))}


@pytest.mark.parametrize("arrays", [1, 2], ids=["K1", "K2"])
@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "%dx%dx%d" % s)
def test_plan(shape, itemsize, arrays):
    n, hw, c = shape
    plan = K.cluster_plan(n, hw, c, itemsize, arrays, SMS)
    if shape in GENERATOR:
        assert plan.variant == "cluster"
        assert n * plan.cluster >= SMS
    elif shape in PATH_BY_ITEMSIZE[itemsize]:
        want = "streaming" if (shape, itemsize, arrays) in STREAMED else \
            "cluster"
        assert plan.variant == want
    elif shape in CLI | TEST_CLI and itemsize == 4:
        # at the eval batch of 100 the card measured it 1.19-1.75x faster
        # than the streaming variant (PERF.md)
        assert plan.variant == "cluster"
    if shape == (4, 65536, 32):
        assert plan == K.STREAMING  # 4-8 MB of x per sample: no cluster holds it
        with pytest.raises(ValueError):
            K.cluster_plan(n, hw, c, itemsize, arrays, SMS, on_chip=True)
    if plan.variant == "cluster":
        assert K.cluster_plan(n, hw, c, itemsize, arrays, SMS,
                              on_chip=True) == plan
    elif c * itemsize % 16 == 0:
        # a streamed path shape still has the on-chip plan the checks hold,
        # unless no cluster holds its sample
        try:
            plan = K.cluster_plan(n, hw, c, itemsize, arrays, SMS,
                                  on_chip=True)
        except ValueError:
            assert shape in HUGE
            return
    else:
        return
    row_bytes = c * itemsize
    assert plan.cluster in (1, 2, 4, 8, 16)
    assert plan.smem_bytes <= K.SMEM_PER_CTA_MAX == 227 * 1024
    assert plan.smem_bytes == K._cluster_smem_bytes(
        arrays, plan.rows, c, itemsize, plan.threads, plan.stages)
    packs = row_bytes // 16
    assert plan.threads <= 256 and plan.threads % packs == 0
    # the CTAs' rows partition [0, HW) in rank order, and so do the stages
    # of each CTA's rows
    ranges = plan.row_ranges(hw)
    assert ranges[0][0] == 0 and ranges[-1][1] == hw
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(r0 <= r1 and r1 - r0 <= plan.rows for r0, r1 in ranges)
    for first, last in ranges:
        stages = plan.stage_ranges(first, last)
        assert stages[0][0] == first and stages[-1][1] == last
        assert all(a[1] == b[0] for a, b in zip(stages, stages[1:]))
        # every bulk copy of every sample: 16-byte aligned, 16-byte multiple
        for r0, r1 in stages:
            starts = (np.arange(n, dtype=np.int64) * hw + r0) * row_bytes
            assert (starts % 16 == 0).all()
            assert (r1 - r0) * row_bytes % 16 == 0
            assert arrays * (r1 - r0) * row_bytes <= plan.smem_bytes


def test_plan_refuses_what_the_cluster_variant_does_not_take():
    # rows of 8 and 40 bytes cannot be bulk-copied row by row
    assert K.cluster_plan(2, 4096, 4, 2, 1, SMS) == K.STREAMING
    assert K.cluster_plan(3, 169, 20, 2, 2, SMS) == K.STREAMING
    # unaligned tensors
    assert K.cluster_plan(32, 4096, 32, 4, 1, SMS, False) == K.STREAMING
    with pytest.raises(ValueError):
        K.cluster_plan(4, 65536, 32, 4, 1, SMS, cluster=16)
    with pytest.raises(ValueError):
        K.cluster_plan(3, 169, 20, 2, 1, SMS, cluster=2)
    # a forced size that fits is taken as asked
    plan = K.cluster_plan(32, 4096, 32, 4, 1, SMS, cluster=16)
    assert (plan.variant, plan.cluster, plan.rows) == ("cluster", 16, 256)


def _tree(parts):
    """A binary tree over the rows of float32 ``parts`` as
    ``csrc/instance_norm_cluster.cuh::tree_over_rows`` adds them: at stride
    s = P/2 .. 1 (P the power of two >= rows) row t adds row t + s where it
    exists."""
    parts = parts.clone()
    rows = parts.shape[0]
    span = 1
    while span < rows:
        span *= 2
    s = span // 2
    while s > 0:
        hi = min(2 * s, rows)
        if hi > s:
            parts[:hi - s] = parts[:hi - s] + parts[s:hi]
        s //= 2
    return parts[0]


def _cta_total(acc, packs):
    """``tree_over_rows`` on the (TY, ...) per-thread partials of one
    channel pack: where packs divides 32, the butterfly of shuffles inside
    each warp first (row j adds row j ^ off, off = R/2 .. 1 for the R rows a
    warp holds), then the tree over the warps' rows; else the tree over all
    TY rows."""
    if packs < 32 and 32 % packs == 0:
        rows_per_warp = 32 // packs
        a = acc.reshape((-1, rows_per_warp) + acc.shape[1:])
        off = rows_per_warp // 2
        while off >= 1:
            partner = torch.arange(rows_per_warp) ^ off
            a = a + a[:, partner]
            off //= 2
        acc = a[:, 0]
    return _tree(acc)


def _cta_sums(plan, rows_fn, first, last, c, vec):
    """One CTA's total of ``rows_fn(r0, r1)`` (float32 (r1 - r0, ...)
    summands) as the kernel forms it: per thread row ty the rows ty, ty +
    TY, ... of each stage in order (``stages`` False: of the CTA's rows in
    one sweep), then ``_cta_total``."""
    packs = c // vec
    ty_count = plan.threads // packs
    acc = None
    for r0, r1 in plan.stage_ranges(first, last):
        if r1 == r0:
            continue
        vals = rows_fn(r0, r1)
        if acc is None:
            acc = torch.zeros((ty_count,) + vals.shape[1:])
        for j in range(0, r1 - r0, ty_count):
            chunk = vals[j:j + ty_count]
            acc[:chunk.shape[0]] = acc[:chunk.shape[0]] + chunk
    return None if acc is None else _cta_total(acc, packs)


def _sweep_sums(plan, rows_fn, first, last, c, vec):
    """As ``_cta_sums`` for a pass that sweeps the CTA's rows in one go."""
    single = plan._replace(stages=1)
    return _cta_sums(single, rows_fn, first, last, c, vec)


CASES = [
    # (n, h, w, c, K, unbiased): HW not divisible by K, HW = 1, C = 4 / 20
    (2, 5, 7, 8, 4, False),
    (2, 13, 13, 20, 8, True),
    (3, 1, 1, 4, 1, True),
    (2, 16, 16, 4, 16, False),
    (2, 3, 11, 32, 2, True),
    (2, 40, 40, 64, 8, False),
]


@pytest.mark.parametrize("n,h,w,c,k,unbiased", CASES)
def test_split_forward_matches_plain(n, h, w, c, k, unbiased):
    """Per CTA its sum and, about its own mean, its centered sum of squares
    M2_k; then every CTA merges the K pairs in rank order, M2 = sum_k M2_k +
    n_k (mean_k - mean)^2, and normalises."""
    rng = np.random.RandomState(n * 100 + c)
    x = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32) * 1.5 + .5)
    scale = torch.from_numpy(rng.rand(n, c).astype(np.float32) + .5)
    shift = torch.from_numpy(rng.randn(n, c).astype(np.float32))
    hw = h * w
    plan = K.cluster_plan(n, hw, c, 4, 1, SMS, cluster=k)
    xs = x.reshape(n, hw, c)
    want, wmean, wrstd = K.instance_norm_plain(
        x, scale, shift, unbiased=unbiased, relu=True, return_stats=True)
    for i in range(n):
        parts = []
        for first, last in plan.row_ranges(hw):
            if last == first:
                continue
            total = _cta_sums(plan, lambda r0, r1: xs[i, r0:r1], first,
                              last, c, 4)
            local = total / (last - first)
            m2 = _sweep_sums(plan, lambda r0, r1: (xs[i, r0:r1] - local) ** 2,
                             first, last, c, 4)
            parts.append((last - first, total, m2))
        mean = parts[0][1]
        for _, total, _ in parts[1:]:
            mean = mean + total
        mean = mean / hw
        m2 = torch.zeros(c)
        for nk, total, m2k in parts:
            d = total / nk - mean
            m2 = m2 + (m2k + nk * d * d)
        var = m2 / hw * (hw / max(hw - 1, 1) if unbiased else 1.0)
        rstd = torch.rsqrt(var + 1e-5)
        y = torch.clamp_min((xs[i] - mean) * rstd * scale[i] + shift[i], 0)
        torch.testing.assert_close(mean, wmean[i], rtol=0, atol=1e-6)
        torch.testing.assert_close(rstd, wrstd[i], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(y, want[i].reshape(hw, c), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("n,h,w,c,k,unbiased", CASES)
def test_split_backward_matches_plain(n, h, w, c, k, unbiased):
    """Per CTA the pair (dshift, dscale) of its rows; every CTA adds the K
    pairs in rank order and forms dx."""
    rng = np.random.RandomState(n * 200 + c)
    x = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32))
    dy = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32))
    scale = torch.from_numpy(rng.rand(c).astype(np.float32) + .5)
    shift = torch.from_numpy(rng.randn(c).astype(np.float32))
    hw = h * w
    kw = dict(unbiased=unbiased, relu=True)
    _, mean, rstd = K.instance_norm_plain(x, scale, shift, return_stats=True,
                                          **kw)
    want_dx, want_ds, want_dt = K.instance_norm_bwd_plain(
        x, dy, mean, rstd, scale, shift, **kw)
    plan = K.cluster_plan(n, hw, c, 4, 2, SMS, cluster=k)
    xs, gs = x.reshape(n, hw, c), dy.reshape(n, hw, c)
    for i in range(n):
        xhat = (xs[i] - mean[i]) * rstd[i]
        g = torch.where(xhat * scale + shift > 0, gs[i], torch.zeros(()))
        sums = None
        for first, last in plan.row_ranges(hw):
            part = _cta_sums(plan, lambda r0, r1: torch.stack(
                [g[r0:r1], g[r0:r1] * xhat[r0:r1]], 1), first, last, c, 4)
            if part is not None:
                sums = part if sums is None else sums + part
        dshift, dscale = sums[0], sums[1]
        dx = scale * rstd[i] * (g - dshift / hw
                                - xhat * dscale / (max(hw - 1, 1)
                                                   if unbiased else hw))
        ref = max(1.0, float(want_dx.abs().max()))
        torch.testing.assert_close(dx, want_dx[i].reshape(hw, c), rtol=0,
                                   atol=1e-5 * ref)
        # sums of up to HW products: relative to the largest |sum|
        for got, want in ((dshift, want_dt[i]), (dscale, want_ds[i])):
            torch.testing.assert_close(
                got, want, rtol=0,
                atol=1e-5 * max(1.0, float(want.abs().max())))


class _OnCard(torch.Tensor):
    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_a_refused_cluster_launch_raises(monkeypatch, direction):
    """The plan picks the cluster variant; its C entry point refuses the
    launch (as it does when no cluster of that shape can be resident): the
    wrapper raises, counts nothing, and calls no other entry point."""
    import contextlib

    called = []

    def c_function(kernel_name, fn_name, argtypes):
        def fn(*args):
            called.append(fn_name)
            return 9  # cudaErrorInvalidConfiguration
        return fn

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(K, "_c_function", c_function)
    monkeypatch.setattr(K, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    x = torch.randn(2, 8, 8, 32).as_subclass(_OnCard)
    wrapper = K.instance_norm_fused if direction == "fwd" else \
        K.instance_norm_bwd_fused
    before = (wrapper.launches, dict(wrapper.launches_by_variant))
    with pytest.raises(RuntimeError, match="cudaError 9 .*'cluster'"):
        if direction == "fwd":
            K._launch(x, None, None, 1e-5, False, False)
        else:
            stats = torch.zeros(2, 32)
            K._launch_bwd(x, x, stats, stats, None, None, False, False)
    assert called == ["instance_norm_%s_cluster" % direction]
    assert (wrapper.launches, wrapper.launches_by_variant) == before
