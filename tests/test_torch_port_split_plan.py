"""The launch plan of the split reductions (``split_plan``: K1-split's
partial statistics, K2-split's partial sums), on the CPU: which variant each
rank shape gets, that the cluster variant's rows, chunks and bulk copies are
legal, and an emulation of its reduction order (per-thread chunks, Chan's
merges, the tree, the cluster's rank order) held to the plain twins, to a
float64 reference where x sits far from 0, and, merged over two halves and
applied, to the JAX package's instance norm on the whole rows.  One small
eager JAX norm; the rest is CPU torch, well under a second each.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from domain_transfer_gan_tpu.nn.norms import instance_norm_xla

from domain_transfer_gan_torch.ops.kernels import instance_norm as K

import torch_port_ring as ring

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132  # an H100 SXM


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.mark.parametrize("arrays", [1, 2], ids=["stats", "sums"])
@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CS.SPLIT_SHAPES,
                         ids=lambda s: "%dx%dx%d" % s)
def test_split_plan(shape, itemsize, arrays):
    n, hw, c = shape
    picked = K.split_plan(n, hw, c, itemsize, arrays, SMS)
    plan = K.split_plan(n, hw, c, itemsize, arrays, SMS, on_chip=True)
    assert picked in (plan, K.SPLIT_ROWS)
    assert plan.variant == "cluster" and plan.cluster in (1, 2, 4, 8)
    assert plan.smem_bytes <= K.SMEM_PER_CTA_MAX == 227 * 1024
    assert plan.smem_bytes == K._ring_smem_bytes(
        arrays, plan.stage_rows, c, itemsize, plan.threads, plan.stages,
        plan.cluster)
    packs = c * itemsize // 16
    assert plan.threads <= 512 and plan.threads % packs == 0
    assert 1 <= plan.stages <= K.RING_STAGES_MAX
    # a sample of more than a few chunks is split until the grid has the
    # CTAs the card measured fastest (K._SPLIT_GRID_CTAS, about half an
    # H100's SMs), or the portable cluster's 8 each; never further
    chunk = K.RING_ROWS_PER_THREAD * (256 // packs)
    if hw >= 4 * chunk * 8:
        assert n * plan.cluster >= K._SPLIT_GRID_CTAS or plan.cluster == 8
    if plan.cluster > 1:
        assert n * plan.cluster // 2 < K._SPLIT_GRID_CTAS
        assert -(-hw // plan.cluster) >= 2 * chunk
    # a CTA streams rows in whole chunks of two ring slots; the partial
    # statistics of a grid smaller than the card take 512 threads a CTA
    assert plan.stages == 2
    if plan.threads == 512:
        assert arrays == 1 and n * plan.cluster < SMS
    # the CTAs' rows partition [0, HW) in rank order, and so do the chunks
    # of each CTA's rows; every bulk copy of every sample is 16-byte
    # aligned and a multiple of 16 bytes
    ranges = plan.row_ranges(hw)
    assert plan.rows * plan.cluster >= hw
    assert ranges[0][0] == 0 and ranges[-1][1] == hw
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    row_bytes = c * itemsize
    for first, last in ranges:
        chunks = plan.chunk_ranges(first, last)
        if first == last:
            assert chunks == []
            continue
        assert chunks[0][0] == first and chunks[-1][1] == last
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        for r0, r1 in chunks:
            assert 0 < r1 - r0 <= plan.stage_rows
            starts = (np.arange(n, dtype=np.int64) * hw + r0) * row_bytes
            assert (starts % 16 == 0).all()
            assert (r1 - r0) * row_bytes % 16 == 0


def test_split_plan_refuses_what_the_cluster_variant_does_not_take():
    # unaligned tensors, and rows of 40 bytes, take the streaming kernel
    assert K.split_plan(8, 32768, 32, 4, 1, SMS, aligned=False) == \
        K.SPLIT_ROWS
    assert K.split_plan(3, 169, 20, 2, 2, SMS) == K.SPLIT_ROWS
    with pytest.raises(ValueError):
        K.split_plan(3, 169, 20, 2, 2, SMS, on_chip=True)
    with pytest.raises(ValueError):
        K.split_plan(8, 32768, 32, 4, 1, SMS, aligned=False, on_chip=True)
    with pytest.raises(ValueError):
        K.ring_plan(32768, 32, 4, 1, 3)
    with pytest.raises(ValueError):
        K.ring_plan(32768, 32, 4, 1, 8, stages=K.RING_STAGES_MAX + 1)
    with pytest.raises(ValueError):  # a ring of more than 227 KB
        K.ring_plan(32768, 32, 4, 2, 1, stages=8, stage_rows=256)
    # a cluster size that fits is taken as asked
    plan = K.ring_plan(32768, 32, 4, 1, 16)
    assert (plan.variant, plan.cluster, plan.rows) == ("cluster", 16, 2048)


# the cluster variant's reduction order, emulated in float32
# (tests/torch_port_ring.py)
_emulate_stats, _emulate_sums = ring.emulate_stats, ring.emulate_sums


# (n, hw, c, dtype, cluster, stage_rows): a ragged last CTA, chunks shorter
# than a sub-chunk, several sub-chunks a chunk, empty CTAs, bfloat16 input
EMULATED = [
    (2, 290, 128, torch.float32, 4, 20),
    (3, 1000, 32, torch.float32, 2, None),
    (2, 777, 32, torch.bfloat16, 8, None),
    (2, 600, 64, torch.float32, 1, 128),
    (2, 40, 128, torch.float32, 16, None),
]


def _plan_and_threads(hw, c, dtype, arrays, cluster, stage_rows):
    item = torch.tensor([], dtype=dtype).element_size()
    plan = K.ring_plan(hw, c, item, arrays, cluster, stage_rows=stage_rows)
    packs = c * item // 16
    return plan, packs, plan.threads // packs


def _inputs(n, hw, c, dtype, seed, loc=0.5, spread=1.5):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(n, hw, c) * spread + loc).astype(
        np.float32)).to(dtype)
    return x, x.float()


@pytest.mark.parametrize("n,hw,c,dtype,cluster,stage_rows", EMULATED)
def test_emulated_partial_stats_match_the_twin(n, hw, c, dtype, cluster,
                                              stage_rows):
    x, x32 = _inputs(n, hw, c, dtype, seed=hw + c)
    plan, packs, ty = _plan_and_threads(hw, c, dtype, 1, cluster, stage_rows)
    mean, m2 = _emulate_stats(x32, plan, packs, ty)
    pm, pq = K.instance_norm_partial_stats_plain(x.reshape(n, hw, 1, c))
    # float32 rounding in another order
    torch.testing.assert_close(mean, pm, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(m2, pq, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,hw,c,dtype,cluster,stage_rows", EMULATED[:3])
def test_emulated_partial_sums_match_the_twin(n, hw, c, dtype, cluster,
                                             stage_rows):
    x, x32 = _inputs(n, hw, c, dtype, seed=7 * hw + c)
    dy = torch.from_numpy(np.random.RandomState(c).randn(n, hw, c).astype(
        np.float32)).to(dtype)
    scale = torch.rand((n, c), generator=torch.Generator().manual_seed(1))
    shift = torch.randn((n, c), generator=torch.Generator().manual_seed(2))
    pm, pq = K.instance_norm_partial_stats_plain(x.reshape(n, hw, 1, c))
    rstd = torch.rsqrt(pq / hw + 1e-5)
    plan, packs, ty = _plan_and_threads(hw, c, dtype, 2, cluster, stage_rows)
    for relu in (False, True):
        got = _emulate_sums(x32, dy.float(), pm, rstd, scale, shift, relu,
                            plan, packs, ty)
        want = K.instance_norm_bwd_partial_sums_plain(
            x.reshape(n, hw, 1, c), dy.reshape(n, hw, 1, c), pm, rstd, scale,
            shift, relu=relu)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)


def test_emulated_partial_stats_keep_their_digits_far_from_zero():
    """x = 1000 + N(0, 0.1^2): the emulated one pass stays within a few
    float32 roundings of a float64 reference, where E[x^2] - mean^2 in
    float32 keeps no digit of M2."""
    n, hw, c = 2, 4000, 32
    x, x32 = _inputs(n, hw, c, torch.float32, seed=11, loc=1000.0,
                     spread=0.1)
    plan, packs, ty = _plan_and_threads(hw, c, torch.float32, 1, 8, None)
    mean, m2 = _emulate_stats(x32, plan, packs, ty)
    x64 = x32.double()
    mean64 = x64.mean(dim=1)
    m2_64 = ((x64 - mean64[:, None]) ** 2).sum(dim=1)

    def rel(a, b):
        return float(((a.double() - b).abs() / b.abs()).max())

    assert rel(mean, mean64) < 1e-7
    assert rel(m2, m2_64) < 2e-6
    sumsq = ((x32 * x32).mean(dim=1) - x32.mean(dim=1) ** 2) * hw
    assert rel(sumsq, m2_64) > 1e-2


@pytest.mark.parametrize("unbiased,relu", [(False, False), (True, True)])
def test_emulated_halves_merged_match_the_jax_norm(unbiased, relu):
    """Two ranks' halves of every sample, each reduced as the cluster
    variant does, merged by ``combine_stats`` and applied, against the JAX
    package's instance norm on the whole rows (atol 1e-4, the port's limit
    of agreement with it)."""
    n, h, w, c = 2, 24, 20, 32
    rng = np.random.RandomState(5)
    x = rng.randn(n, h, w, c).astype(np.float32) * 1.5 + 0.5
    scale = (rng.rand(n, c) + 0.5).astype(np.float32)
    shift = rng.randn(n, c).astype(np.float32)
    xt = torch.from_numpy(x)
    halves = [t.contiguous() for t in xt.chunk(2, dim=1)]
    hw = (h // 2) * w
    plan, packs, ty = _plan_and_threads(hw, c, torch.float32, 1, 4, 16)
    stats = [_emulate_stats(t.reshape(n, hw, c), plan, packs, ty)
             for t in halves]
    mean, m2, rows = K.combine_stats([s[0] for s in stats],
                                     [s[1] for s in stats], [hw, hw])
    corr = rows / (rows - 1) if unbiased else 1.0
    rstd = torch.rsqrt(m2 / rows * corr + 1e-5)
    y = torch.cat([K.instance_norm_apply_plain(
        t, mean, rstd, torch.from_numpy(scale), torch.from_numpy(shift),
        relu=relu) for t in halves], dim=1)
    want = np.asarray(instance_norm_xla(jnp.asarray(x), jnp.asarray(scale),
                                        jnp.asarray(shift), 1e-5, unbiased,
                                        relu))
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=1e-4)
