"""The launch plan of the instance-norm kernels (``cluster_plan``), on the
CPU: which variant each shape gets, that the on-chip variant's and the ring
route's row ranges and bulk copies are legal, and emulations of their
reductions (per-CTA partials over the plan's rows, in the kernels' order,
merged in rank order; the ring route's statistics and sums, then its
row-chunked apply and dx) held to the plain versions, and the ring route
once to the JAX package's instance norm.  Pure CPU torch but for that one
JAX call; well under a second each.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

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
EDGE = ((2, 4096, 4), (3, 169, 20), (4, 65536, 32), (2, 3969, 512))
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
# request, the wide edge shape, phase 9's 256x256 sites (its --grad_accum
# microbatch, its step at batch 32)
HUGE = {(4, 65536, 32), (2, 3969, 512)} \
    | set(CS.accum_sites(32, CS.ACCUM_K, hw=256)["fwd"]) \
    | set(CS.STEP256_SHAPES)
# wide rows whose ring, as the rule would set it, needs more shared memory
# than a CTA has: the plan narrows it (the discriminators' third site at
# 256x256 with --ndf 128 --batchSize 1, and a wider sample still)
WIDE = ((2, 3969, 512), (1, 65536, 512))
# the 256x256 generator sites: the ring route's, at both dtypes and kernels
RING = {(4, 65536, 32), (8, 65536, 32), (8, 65536, 64), (8, 16384, 128),
        (32, 65536, 32), (32, 65536, 64), (32, 16384, 128)}
# phase 9's 256x256 step at batch 32, less the sites of other phases
STEP256_NEW = set(CS.STEP256_SHAPES) - (PATH | CLI | TEST_CLI | EXTRAS)
# phase 10's tails: the per-file train step's tail of 19 (its
# discriminators' pass at 38) and the per-file eval tail of 30
P10 = set(CS.P10_SHAPES)
# phase 11's ranks: the generator sites at half the float32 batch of 32 and
# half the bfloat16 batch of 128 (all but one are sites of other phases)
P11 = set(CS.P11_SHAPES)
P11_NEW = P11 - (PATH | CLI | TEST_CLI | EXTRAS | P10)


def test_the_shapes_are_the_smoke_tests():
    assert len(SHAPES) == len(CS.CHECK_SHAPES) == \
        35 + len(CLI | TEST_CLI) + len(EXTRAS) + len(P10) + len(P11_NEW) \
        + len(STEP256_NEW)
    # generator sites at 32, discriminators at 64 and 32, four of them
    # shared with phase 9's microbatch (its 16384x128 site and three of its
    # discriminators' at 32)
    assert len(CS.STEP256_SHAPES) == 3 + 12 and len(STEP256_NEW) == 9
    assert RING == set(CS.RING_SHAPES) and RING <= set(SHAPES)
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
    if shape in RING:
        # 1-8 MB of x per sample: no cluster holds it, the ring route runs
        assert plan.variant == "ring"
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


# cluster_plan's cluster sizes before the ring route was added, per shape:
# float32 K1, float32 K2, bfloat16 K1, bfloat16 K2 ("g" = 16, "-" = not the
# cluster variant)
CLUSTER_K_BEFORE = {
    (32, 4096, 32): "8888", (32, 4096, 64): "8g88", (32, 1024, 128): "8888",
    (64, 256, 64): "--11", (64, 64, 128): "1111", (64, 16, 128): "1111",
    (64, 256, 128): "----", (64, 225, 256): "----", (64, 196, 256): "----",
    (32, 256, 64): "--11", (32, 64, 128): "1111", (32, 16, 128): "1111",
    (32, 256, 128): "----", (32, 225, 256): "----", (32, 196, 256): "----",
    (128, 4096, 32): "8828", (128, 4096, 64): "8g88",
    (128, 1024, 128): "8828", (256, 256, 64): "1111", (256, 64, 128): "1111",
    (256, 16, 128): "1111", (256, 256, 128): "1-11", (256, 225, 256): "--1-",
    (256, 196, 256): "1-11", (128, 256, 64): "1111", (128, 64, 128): "1111",
    (128, 16, 128): "1111", (128, 256, 128): "1-11", (128, 225, 256): "--1-",
    (128, 196, 256): "1-11", (10, 4096, 32): "8888", (10, 4096, 64): "8g88",
    (10, 1024, 128): "8888", (25, 4096, 32): "8888", (25, 4096, 64): "8g88",
    (25, 1024, 128): "8888", (50, 4096, 32): "8848", (50, 4096, 64): "8g88",
    (50, 1024, 128): "8848", (100, 4096, 32): "8828", (100, 4096, 64): "8g88",
    (100, 1024, 128): "8828", (250, 4096, 32): "8828",
    (250, 4096, 64): "8g88", (250, 1024, 128): "8828", (5, 4096, 32): "8888",
    (5, 4096, 64): "8g88", (5, 1024, 128): "8888", (64, 4096, 32): "8848",
    (64, 4096, 64): "8g88", (64, 1024, 128): "8848", (150, 4096, 32): "8828",
    (150, 4096, 64): "8g88", (150, 1024, 128): "8828",
    (200, 4096, 32): "8828", (200, 4096, 64): "8g88",
    (200, 1024, 128): "8828", (320, 4096, 32): "8828",
    (320, 4096, 64): "8g88", (320, 1024, 128): "8828", (16, 256, 128): "----",
    (16, 256, 64): "--11", (16, 225, 256): "----", (16, 196, 256): "----",
    (16, 64, 128): "1111", (16, 16, 128): "1111", (8, 4096, 64): "8g88",
    (8, 4096, 32): "8888", (8, 1024, 128): "8888", (8, 256, 128): "----",
    (8, 256, 64): "--11", (8, 225, 256): "----", (8, 196, 256): "----",
    (8, 64, 128): "1111", (8, 16, 128): "1111", (16, 4096, 128): "g-8g",
    (16, 4096, 64): "8g88", (16, 3969, 256): "--g-", (16, 3844, 256): "--g-",
    (16, 1024, 128): "8888", (8, 65536, 64): "----", (8, 65536, 32): "----",
    (8, 16384, 128): "----", (8, 4096, 128): "g-8g", (8, 3969, 256): "--g-",
    (8, 3844, 256): "--g-", (38, 256, 128): "----", (38, 256, 64): "--11",
    (38, 225, 256): "----", (38, 196, 256): "----", (38, 64, 128): "1111",
    (38, 16, 128): "1111", (19, 4096, 64): "8g88", (19, 4096, 32): "8888",
    (19, 1024, 128): "8888", (19, 256, 128): "----", (19, 256, 64): "--11",
    (19, 225, 256): "----", (19, 196, 256): "----", (19, 64, 128): "1111",
    (19, 16, 128): "1111", (30, 4096, 32): "8888", (30, 4096, 64): "8g88",
    (30, 1024, 128): "8888", (16, 4096, 32): "8888", (64, 4096, 128): "g-8g",
    (64, 3969, 256): "--g-", (64, 3844, 256): "--g-", (32, 65536, 64): "----",
    (32, 65536, 32): "----", (32, 16384, 128): "----",
    (32, 4096, 128): "g-8g", (32, 3969, 256): "--g-", (32, 3844, 256): "--g-",
    (2, 4096, 4): "----", (3, 169, 20): "11--", (4, 65536, 32): "----",
    (8, 1, 16): "1111", (2, 3969, 512): "----",
}
_K_CODE = {"1": 1, "2": 2, "4": 4, "8": 8, "g": 16}


def test_the_cluster_plans_are_kept():
    """Every (shape, dtype, kernel) that took the cluster variant keeps it
    with the same K; the others take the streaming variant, or the ring
    route where no cluster holds the slab."""
    assert set(CLUSTER_K_BEFORE) == set(SHAPES)
    for shape, codes in CLUSTER_K_BEFORE.items():
        n, hw, c = shape
        for code, (itemsize, arrays) in zip(codes, ((4, 1), (4, 2), (2, 1),
                                                    (2, 2))):
            plan = K.cluster_plan(n, hw, c, itemsize, arrays, SMS)
            if code != "-":
                assert (plan.variant, plan.cluster) == ("cluster",
                                                        _K_CODE[code])
            elif plan.variant == "ring":
                with pytest.raises(ValueError):
                    K.cluster_plan(n, hw, c, itemsize, arrays, SMS,
                                   on_chip=True)
            else:
                assert plan == K.STREAMING


@pytest.mark.parametrize("arrays", [1, 2], ids=["K1", "K2"])
@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", sorted(HUGE | set(WIDE)),
                         ids=lambda s: "%dx%dx%d" % s)
def test_ring_route_plan(shape, itemsize, arrays):
    """Where no cluster holds a sample's slab, the ring route, with the
    grid of CTAs the plan's rule gives; the ring's shared memory fits a CTA
    (at wide rows by a narrower chunk, or fewer CTAs, than the rule's), its
    CTAs' rows, each CTA's chunks and the apply's row chunks cover HW
    exactly once, and every bulk copy is legal."""
    n, hw, c = shape
    try:
        K.cluster_plan(n, hw, c, itemsize, arrays, SMS, on_chip=True)
        return  # a cluster holds it: test_the_cluster_plans_are_kept
    except ValueError:
        pass
    plan = K.cluster_plan(n, hw, c, itemsize, arrays, SMS)
    ring = plan.ring
    assert plan.variant == "ring" and ring.variant == "cluster"
    assert plan[1:6] == (0, 0, 0, 0, 0)
    row_bytes = c * itemsize
    packs = row_bytes // 16
    thread_rows = ring.threads // packs
    # the grid the card measured fastest: about 64 CTAs (PERF.md)
    assert n * ring.cluster >= 64 or ring.cluster == 16 or \
        -(-hw // (2 * ring.cluster)) < 2 * K.RING_ROWS_PER_THREAD * (
            256 // packs) or shape in WIDE
    assert n * ring.cluster < 128 or ring.cluster == 1
    assert ring.cluster in (1, 2, 4, 8, 16)
    assert ring.smem_bytes <= K.SMEM_PER_CTA_MAX == 227 * 1024
    assert ring.smem_bytes == K._ring_smem_bytes(
        arrays, ring.stage_rows, c, itemsize, ring.threads, ring.stages,
        ring.cluster)
    assert ring.threads <= K.RING_THREADS_MAX and ring.threads % packs == 0
    if shape in WIDE:
        # narrowed as little as fits: a chunk of twice the rows does not
        assert ring.stage_rows >= thread_rows
        assert K._ring_smem_bytes(
            arrays, 2 * ring.stage_rows, c, itemsize, ring.threads,
            ring.stages, ring.cluster) > K.SMEM_PER_CTA_MAX
    covered = np.zeros(hw, dtype=np.int64)
    for first, last in ring.row_ranges(hw):
        chunks = ring.chunk_ranges(first, last)
        assert sum(r1 - r0 for r0, r1 in chunks) == last - first
        for r0, r1 in chunks:
            covered[r0:r1] += 1
            assert 0 < r1 - r0 <= ring.stage_rows
            starts = (np.arange(n, dtype=np.int64) * hw + r0) * row_bytes
            assert (starts % 16 == 0).all()
            assert (r1 - r0) * row_bytes % 16 == 0
    assert (covered == 1).all()
    covered[:] = 0
    for r0, r1 in plan.apply_ranges(hw):
        covered[r0:r1] += 1
        assert 0 < r1 - r0 <= plan.chunk_rows
    assert (covered == 1).all()
    vec, tx, chunk_rows = K.apply_grid(n, hw, c, itemsize, True, SMS,
                                       dx=arrays == 2)
    assert chunk_rows == plan.chunk_rows and vec * itemsize == 16
    assert tx >= min(packs, 32) and tx & (tx - 1) == 0


def test_the_ring_route_refuses_what_it_does_not_take():
    """Unaligned tensors and rows of other than a multiple of 16 bytes stay
    streaming at a 256x256 generator site; a ring of such rows raises;
    rows so wide that the ring fits a CTA only with fewer CTAs or a chunk
    of a quarter of its rows stay streaming, which the card measured
    faster there; and wherever the plan takes the ring route (rows of up
    to 256 packs of 16 bytes, any HW and N) its ring fits a CTA."""
    for itemsize in (4, 2):
        for arrays in (1, 2):
            assert K.cluster_plan(1, 16384, 1024, itemsize, arrays,
                                  SMS) == K.STREAMING
            assert K.cluster_plan(8, 65536, 32, itemsize, arrays, SMS,
                                  aligned=False) == K.STREAMING
            assert K.cluster_plan(8, 65536, 6, itemsize, arrays,
                                  SMS) == K.STREAMING
            with pytest.raises(ValueError):
                K.ring_plan(65536, 6, itemsize, arrays, 8)
            for packs in (1, 8, 32, 64, 128, 256):
                c = packs * 16 // itemsize
                for n in (1, 2, 8, 32):
                    for hw in (4096, 16384, 65536, 262144):
                        plan = K.cluster_plan(n, hw, c, itemsize, arrays,
                                              SMS)
                        if plan.variant == "ring":
                            assert plan.ring.smem_bytes <= \
                                K.SMEM_PER_CTA_MAX


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


@pytest.mark.parametrize("direction,shape,first", [
    ("fwd", (2, 8, 8, 32), "instance_norm_fwd_cluster"),
    ("bwd", (2, 8, 8, 32), "instance_norm_bwd_cluster"),
    ("fwd", (2, 256, 256, 32), "instance_norm_ring_stats"),
    ("bwd", (2, 256, 256, 32), "instance_norm_bwd_partial_sums_cluster"),
], ids=["fwd", "bwd", "fwd-ring", "bwd-ring"])
def test_a_refused_cluster_launch_raises(monkeypatch, direction, shape,
                                         first):
    """The plan picks the cluster variant (or the ring route); its first C
    entry point refuses the launch (as it does when no cluster of that
    shape can be resident): the wrapper raises, counts nothing, and calls
    no other entry point (the ring route's second launch neither)."""
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
    x = torch.randn(*shape).as_subclass(_OnCard)
    wrapper = K.instance_norm_fused if direction == "fwd" else \
        K.instance_norm_bwd_fused
    before = (wrapper.launches, dict(wrapper.launches_by_variant))
    variant = "ring" if "ring" in first or "sums" in first else "cluster"
    with pytest.raises(RuntimeError, match="cudaError 9 .*'%s'" % variant):
        if direction == "fwd":
            K._launch(x, None, None, 1e-5, False, False)
        else:
            stats = torch.zeros(2, 32)
            K._launch_bwd(x, x, stats, stats, None, None, False, False)
    assert called == [first]
    assert (wrapper.launches, wrapper.launches_by_variant) == before


# the ring route: (n, h, w, c, dtype, cluster, stage_rows, chunk_rows):
# a ragged last CTA, chunks shorter than a sub-chunk, empty CTAs, apply
# chunks that do not divide HW, bfloat16 input
RING_CASES = [
    (2, 17, 17, 32, torch.float32, 4, 20, 37),
    (3, 20, 50, 32, torch.float32, 2, None, 128),
    (2, 21, 37, 32, torch.bfloat16, 8, None, 100),
    (2, 15, 40, 64, torch.float32, 1, 128, 600),
    (2, 5, 8, 128, torch.float32, 16, None, 7),
]


def _ring_case(n, h, w, c, dtype, cluster, stage_rows, chunk_rows, arrays,
               seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(n, h * w, 1, c) * 1.5 + 0.5).astype(
        np.float32)).to(dtype)
    scale = torch.from_numpy(rng.rand(n, c).astype(np.float32) + .5)
    shift = torch.from_numpy(rng.randn(n, c).astype(np.float32))
    item = x.element_size()
    plan = K.ClusterPlan("ring", ring=K.ring_plan(
        h * w, c, item, arrays, cluster, stage_rows=stage_rows),
        chunk_rows=chunk_rows)
    packs = c * item // 16
    return x, scale, shift, plan, packs, plan.ring.threads // packs


def _by_chunks(plan, hw, fn, *rows):
    """``fn`` on each of the apply's row chunks of the NHWC tensors
    ``rows`` (taken as (N, HW, 1, C)), concatenated back in row order."""
    return torch.cat([fn(*(t[:, r0:r1] for t in rows))
                      for r0, r1 in plan.apply_ranges(hw)], dim=1)


@pytest.mark.parametrize("unbiased,relu", [(False, False), (True, True)])
@pytest.mark.parametrize("n,h,w,c,dtype,cluster,stage_rows,chunk_rows",
                         RING_CASES)
def test_ring_route_forward_matches_plain(n, h, w, c, dtype, cluster,
                                          stage_rows, chunk_rows, unbiased,
                                          relu):
    """K1's ring route in its order: per CTA the chunk triples of each
    thread, Chan's merges, the tree, rank 0's merge of the CTAs in rank
    order and the finalizing epilogue (mean, rstd = rsqrt(M2 / HW * corr +
    eps)); then the apply over the plan's row chunks."""
    x, scale, shift, plan, packs, ty = _ring_case(
        n, h, w, c, dtype, cluster, stage_rows, chunk_rows, 1, seed=h + c)
    hw = h * w
    mean, m2 = ring.emulate_stats(x.float().reshape(n, hw, c), plan.ring,
                                  packs, ty)
    corr = hw / max(hw - 1, 1) if unbiased else 1.0
    rstd = torch.rsqrt(m2 / float(hw) * corr + 1e-5)
    y = _by_chunks(plan, hw, lambda t: K.instance_norm_apply_plain(
        t, mean, rstd, scale, shift, relu=relu), x)
    want, wmean, wrstd = K.instance_norm_plain(
        x, scale, shift, unbiased=unbiased, relu=relu, return_stats=True)
    torch.testing.assert_close(mean, wmean, rtol=0, atol=1e-6)
    torch.testing.assert_close(rstd, wrstd, rtol=1e-5, atol=1e-6)
    # float32: another order of the sums; bfloat16: one rounding of y
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(y.float(), want.float(), rtol=tol, atol=1e-5)


@pytest.mark.parametrize("unbiased,relu", [(False, True), (True, False)])
@pytest.mark.parametrize("n,h,w,c,dtype,cluster,stage_rows,chunk_rows",
                         RING_CASES[:3])
def test_ring_route_backward_matches_plain(n, h, w, c, dtype, cluster,
                                           stage_rows, chunk_rows, unbiased,
                                           relu):
    """K2's ring route in its order: per CTA each thread's rows of each
    chunk, the tree, rank 0's sum of the CTAs in rank order (dshift, dscale);
    then dx over the plan's row chunks from those sums."""
    x, scale, shift, plan, packs, ty = _ring_case(
        n, h, w, c, dtype, cluster, stage_rows, chunk_rows, 2, seed=h * c)
    hw = h * w
    dy = torch.from_numpy(np.random.RandomState(c).randn(
        n, hw, 1, c).astype(np.float32)).to(dtype)
    kw = dict(unbiased=unbiased, relu=relu)
    _, mean, rstd = K.instance_norm_plain(x, scale, shift, return_stats=True,
                                          **kw)
    dshift, dscale = ring.emulate_sums(
        x.float().reshape(n, hw, c), dy.float().reshape(n, hw, c), mean,
        rstd, scale, shift, relu, plan.ring, packs, ty)
    dx = _by_chunks(plan, hw, lambda a, b: K.instance_norm_bwd_apply_dx_plain(
        a, b, mean, rstd, scale, shift, dshift, dscale, hw, **kw), x, dy)
    want_dx, want_ds, want_dt = K.instance_norm_bwd_plain(
        x, dy, mean, rstd, scale, shift, **kw)
    ref = max(1.0, float(want_dx.float().abs().max()))
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(dx.float(), want_dx.float(), rtol=tol,
                               atol=1e-5 * ref)
    for got, want in ((dshift, want_dt), (dscale, want_ds)):
        torch.testing.assert_close(
            got, want, rtol=0, atol=1e-5 * max(1.0, float(want.abs().max())))


@pytest.mark.parametrize("shape", [(3, 1000, 32), (2, 777, 64),
                                   (5, 64, 128)], ids=str)
def test_row_chunked_apply_and_dx_match_their_twins(shape):
    """The apply and dx launches over apply_grid's row chunks (K1-split's,
    K2-split's and the ring route's second launches) are their plain twins
    on every chunk: elementwise, so bit for bit the twins on the whole
    rows."""
    n, hw, c = shape
    rng = np.random.RandomState(hw)
    x = torch.from_numpy(rng.randn(n, hw, 1, c).astype(np.float32))
    dy = torch.from_numpy(rng.randn(n, hw, 1, c).astype(np.float32))
    scale = torch.from_numpy(rng.rand(c).astype(np.float32) + .5)
    shift = torch.from_numpy(rng.randn(c).astype(np.float32))
    mean, m2 = K.instance_norm_partial_stats_plain(x)
    rstd = torch.rsqrt(m2 / hw + 1e-5)
    sg, sgx = K.instance_norm_bwd_partial_sums_plain(x, dy, mean, rstd, scale,
                                                     shift, relu=True)
    for grid in (K._apply_tile(hw, c, 4, True, 1),
                 K._apply_tile(hw, c, 4, True, 4),
                 K.apply_grid(n, hw, c, 4, True, SMS)):
        plan = K.ClusterPlan("ring", chunk_rows=grid[2])
        y = _by_chunks(plan, hw, lambda t: K.instance_norm_apply_plain(
            t, mean, rstd, scale, shift, relu=True), x)
        assert torch.equal(y, K.instance_norm_apply_plain(
            x, mean, rstd, scale, shift, relu=True))
        dx = _by_chunks(
            plan, hw, lambda a, b: K.instance_norm_bwd_apply_dx_plain(
                a, b, mean, rstd, scale, shift, sg, sgx, 2 * hw,
                unbiased=True, relu=True), x, dy)
        assert torch.equal(dx, K.instance_norm_bwd_apply_dx_plain(
            x, dy, mean, rstd, scale, shift, sg, sgx, 2 * hw, unbiased=True,
            relu=True))


def test_ring_route_matches_the_jax_norm():
    """K1's ring route, emulated in its order (the plan's own ring and row
    chunks), against the JAX package's instance norm on the same numpy
    slab with an (N, C) affine: atol 1e-4, the limit of agreement of the
    JAX norm's E[x^2] - mean^2 variance."""
    import jax.numpy as jnp

    from domain_transfer_gan_tpu.nn.norms import instance_norm_xla

    n, hw, c = 2, 16384, 16
    rng = np.random.RandomState(16)
    x = (rng.randn(n, 128, 128, c) * 1.5 + 0.5).astype(np.float32)
    scale = (rng.rand(n, c) + 0.5).astype(np.float32)
    shift = rng.randn(n, c).astype(np.float32)
    # the ring route's plan of the shape (a cluster would hold this slab)
    plan = K._ring_route(n, hw, c, 4, 1, SMS)
    packs = c * 4 // 16
    xt = torch.from_numpy(x).reshape(n, hw, 1, c)
    mean, m2 = ring.emulate_stats(xt.reshape(n, hw, c), plan.ring, packs,
                                  plan.ring.threads // packs)
    rstd = torch.rsqrt(m2 / float(hw) * (hw / (hw - 1)) + 1e-5)
    y = _by_chunks(plan, hw, lambda t: K.instance_norm_apply_plain(
        t, mean, rstd, torch.from_numpy(scale), torch.from_numpy(shift),
        relu=True), xt)
    want = np.asarray(instance_norm_xla(jnp.asarray(x), jnp.asarray(scale),
                                        jnp.asarray(shift), 1e-5, True, True))
    np.testing.assert_allclose(y.reshape(x.shape).numpy(), want, rtol=0,
                               atol=1e-4)
