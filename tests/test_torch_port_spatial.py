"""Images sliced by rows over a space axis (``--spatial``): the halo
convolutions (``parallel/spatial.py``), the split forms of K1 and K2
through their plain twins (``ops/kernels/instance_norm.py``), ``pin_batch_only``
(``parallel/hints.py``) and the steps and evaluation over ``dp x sp`` and
``sp x tp`` against one process (step-1 gradients tensor by tensor).

The convolutions and the twins run in one process, each rank's slice cut
from the whole tensor; the rest over gloo ranks on the CPU, once per test
session."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from domain_transfer_gan_torch.ops.convs import conv_transpose2d_torch
from domain_transfer_gan_torch.ops.kernels import instance_norm as K
from domain_transfer_gan_torch.parallel import hints, selfcheck, spatial

from torch_port_helpers import (  # noqa: F401 (a fixture)
    load_chip_smoke,
    one_torch_thread,
)
from torch_port_mesh_runs import hold_job, once, run_group

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# every convolution geometry of the six networks: (name, kernel, stride,
# padding, padding mode); a "reflect"/"replicate" padding is the explicit
# pad in front of a conv without one (the stem's ReflectionPad(3) + 7x7,
# the blocks' pad-1 + 3x3)
GEOMETRIES = [
    ("stem reflect 7x7", 7, 1, 3, "reflect"),
    ("tail 7x7 p3", 7, 1, 3, "zeros"),
    ("3x3 p1", 3, 1, 1, "zeros"),
    ("3x3 s2 p1", 3, 2, 1, "zeros"),
    ("block reflect 3x3", 3, 1, 1, "reflect"),
    ("block replicate 3x3", 3, 1, 1, "replicate"),
    ("D 4x4 s2 p1", 4, 2, 1, "zeros"),
]


def _whole_conv(x, w, b, k, s, p, mode):
    if mode == "zeros":
        return F.conv2d(x, w, b, stride=s, padding=p)
    return F.conv2d(F.pad(x, (p,) * 4, mode=mode), w, b, stride=s)


def _ext(x, r, S, top, bottom, mode):
    """Rank r's slice of x extended as the exchange extends it: the
    neighbours' rows, padding at the global edges."""
    h = x.shape[2] // S
    mine = x[:, :, r * h:(r + 1) * h]
    above = (x[:, :, r * h - top:r * h] if r > 0
             else spatial._edge_rows(mine, top, mode, True))
    below = (x[:, :, (r + 1) * h:(r + 1) * h + bottom] if r < S - 1
             else spatial._edge_rows(mine, bottom, mode, False))
    return torch.cat([above, mine, below], dim=2)


@pytest.mark.parametrize("S", (2, 4))
@pytest.mark.parametrize("geo", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_a_halo_conv_is_the_whole_conv_at_its_rows(geo, S):
    _, k, s, p, mode = geo
    g = torch.Generator().manual_seed(k * 10 + s)
    x = torch.randn((2, 3, 32, 12), generator=g, dtype=torch.float64)
    w = torch.randn((5, 3, k, k), generator=g, dtype=torch.float64)
    b = torch.randn((5,), generator=g, dtype=torch.float64)
    whole = _whole_conv(x, w, b, k, s, p, mode)
    h = x.shape[2] // S
    top, bottom = spatial.halo_geometry(h, S, k, s, p)
    assert top == p and bottom == k - s - p
    ho = whole.shape[2] // S
    for r in range(S):
        got = spatial.conv_rows(_ext(x, r, S, top, bottom, mode), w, b, s,
                                p, mode)
        torch.testing.assert_close(got, whole[:, :, r * ho:(r + 1) * ho])


@pytest.mark.parametrize("S", (2, 4))
def test_the_transposed_conv_is_the_whole_one_at_its_rows(S):
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 4, 16, 8), generator=g, dtype=torch.float64)
    w = torch.randn((4, 3, 3, 3), generator=g, dtype=torch.float64)
    b = torch.randn((3,), generator=g, dtype=torch.float64)
    whole = conv_transpose2d_torch(x, w, b, 2, 1, 1)
    h = x.shape[2] // S
    top, bottom = spatial.halo_geometry(h, S, 3, 2, 1, True, 1)
    assert (top, bottom) == (0, 1)
    for r in range(S):
        got = spatial.conv_transpose_rows(
            _ext(x, r, S, top, bottom, "zeros"), w, b, 2, 1, 1, top, h)
        torch.testing.assert_close(got, whole[:, :, 2 * r * h:2 * (r + 1) * h])


def test_geometries_that_do_not_split_are_refused():
    """The PatchGAN's 4x4 stride-1 convs (H/4 - 1 rows) and the valid 4x4
    heads gather all of H instead."""
    assert spatial.halo_geometry(8, 2, 4, 1, 1) is None     # 16 -> 15 rows
    assert spatial.halo_geometry(2, 2, 4, 1, 0) is None     # 4 -> 1 row
    assert spatial.halo_geometry(1, 4, 3, 2, 1) is None     # 4 -> 2 rows / 4
    assert spatial.halo_geometry(2, 2, 7, 1, 3) is None     # halo > slice


SPLIT_CASES = [(blocks, unbiased, affine, relu, dtype)
               for blocks in (2, 4) for unbiased in (False, True)
               for affine in ("none", "channel", "sample")
               for relu in (False, True)
               for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("blocks,unbiased,affine,relu,dtype", SPLIT_CASES)
def test_the_split_twins_combine_to_the_whole_norm(blocks, unbiased, affine,
                                                   relu, dtype):
    """K1-split's and K2-split's twins on the row blocks of each sample,
    combined as the ranks combine them (Chan's merge in block order, the
    backward sums added), against ``instance_norm_plain`` and
    ``instance_norm_bwd_plain`` on the whole rows: float32 within 1e-5,
    bfloat16 within a bfloat16 rounding of the output."""
    n, h, w, c = 3, 16, 8, 6
    g = torch.Generator().manual_seed(blocks * 100 + c)
    x = (torch.randn((n, h, w, c), generator=g) * 1.5 + 0.5).to(dtype)
    dy = torch.randn((n, h, w, c), generator=g).to(dtype)
    scale = shift = None
    if affine != "none":
        lead = (c,) if affine == "channel" else (n, c)
        scale = torch.rand(lead, generator=g) + 0.5
        shift = torch.randn(lead, generator=g)
    kw = dict(unbiased=unbiased, relu=relu)
    y_ref, mean_ref, rstd_ref = K.instance_norm_plain(
        x, scale, shift, return_stats=True, **kw)
    parts = [t.contiguous() for t in x.chunk(blocks, dim=1)]
    dys = [t.contiguous() for t in dy.chunk(blocks, dim=1)]
    stats = [K.instance_norm_partial_stats_plain(t) for t in parts]
    rows = h * w // blocks
    mean, m2, total = K.combine_stats([s[0] for s in stats],
                                      [s[1] for s in stats], [rows] * blocks)
    assert total == h * w
    corr = total / (total - 1) if unbiased else 1.0
    rstd = torch.rsqrt(m2 / total * corr + 1e-5)
    torch.testing.assert_close(mean, mean_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rstd_ref, rtol=1e-5, atol=1e-5)
    y = torch.cat([K.instance_norm_apply_plain(t, mean, rstd, scale, shift,
                                               relu=relu) for t in parts], 1)
    dx_ref, ds_ref, dt_ref = K.instance_norm_bwd_plain(
        x, dy, mean, rstd, scale, shift, **kw)
    sums = [K.instance_norm_bwd_partial_sums_plain(
        t, d, mean, rstd, scale, shift, relu=relu)
        for t, d in zip(parts, dys)]
    sg = sum(s[0] for s in sums)
    sgx = sum(s[1] for s in sums)
    dx = torch.cat([K.instance_norm_bwd_apply_dx_plain(
        t, d, mean, rstd, scale, shift, sg, sgx, total, **kw)
        for t, d in zip(parts, dys)], 1)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=8e-3, atol=8e-3))
    torch.testing.assert_close(y.float(), y_ref.float(), **tol)
    torch.testing.assert_close(dx.float(), dx_ref.float(), **tol)
    torch.testing.assert_close(sg, dt_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sgx, ds_ref, rtol=1e-4, atol=1e-4)


def test_the_split_wrappers_take_their_twins_on_the_cpu():
    x = torch.randn(2, 4, 4, 8)
    assert all(torch.equal(a, b) for a, b in zip(
        K.instance_norm_partial_stats(x),
        K.instance_norm_partial_stats_plain(x)))
    assert all(w.launches == 0 for w in K.SPLIT_WRAPPERS)


class _OneSlice:
    """The split norm's collectives over a single slice."""

    def combine(self, mean, m2, rows):
        return mean, m2, rows

    def sum_(self, t):
        return t


@pytest.mark.parametrize("affine", ("channel", "sample"))
def test_the_split_function_over_one_slice_is_the_whole_norm(affine):
    """``instance_norm_split`` (the autograd Function around the four
    launches) over one slice against ``instance_norm_fused`` on the CPU:
    y and the gradients of x, scale and shift."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn((2, 8, 8, 6), generator=g)
    lead = (6,) if affine == "channel" else (2, 6)
    scale = torch.rand(lead, generator=g) + 0.5
    shift = torch.randn(lead, generator=g)
    dy = torch.randn(x.shape, generator=g)
    out = []
    for split in (True, False):
        xs, ss, ts = (t.clone().requires_grad_(True)
                      for t in (x, scale, shift))
        kw = dict(relu=True, unbiased=affine == "sample")
        y = (K.instance_norm_split(xs, ss, ts, _OneSlice(), **kw) if split
             else K.instance_norm_fused(xs, ss, ts, **kw))
        out.append([y] + list(torch.autograd.grad(y, (xs, ss, ts), dy)))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_pin_batch_only_is_the_identity_without_a_space_axis():
    x = torch.randn(2, 3, 4, 4)
    assert hints.pin_batch_only(x) is x
    with spatial.image_rows():
        assert spatial.rows_axis() is None
        assert hints.pin_batch_only(x) is x


TWO = ("sp", "sp_eval")
FOUR = ("dp_sp", "sp_tp")


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return once(tmp_path_factory, "spatial_two",
                lambda: run_group(TWO, 2, ("space_gather",)))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return once(tmp_path_factory, "spatial_four",
                lambda: run_group(FOUR, 4))


def test_pin_batch_only_gathers_the_rows(two):
    """Over a space axis of 2: every rank gets all of H, the rest of the
    network's scope is whole, and a rank's rows get back the sum of the
    ranks' gradients (each rank's loss holds the whole map)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 4, 8, 8), generator=g)
    w = torch.randn((2, 4, 8, 8), generator=g)
    for rank in two[1]:
        got = rank["space_gather"]
        np.testing.assert_array_equal(got["y"], x.numpy())
        r = got["index"]
        np.testing.assert_allclose(got["gx"], 2 * w[:, :, 4 * r:4 * r + 4],
                                   rtol=1e-6)
        assert got["whole_after"]


def test_space_steps_match_one_process(two):
    single, ranks = two[0]["sp"]
    hold_job(single, ranks)
    # the generators' norms and the discriminators' first ones ran split
    assert all(r["split_norms"] > 0 for r in ranks)
    assert single["split_norms"] == 0


def test_the_evaluation_over_space_matches_one_process(two):
    single, ranks = two[0]["sp_eval"]
    hold_job(single, ranks)
    assert all(r["split_norms"] > 0 for r in ranks)


@pytest.mark.parametrize("job", FOUR)
def test_space_with_data_or_model_matches_one_process(four, job):
    single, ranks = four[0][job]
    assert len(ranks) == 4
    hold_job(single, ranks)
    assert all(r["split_norms"] > 0 for r in ranks)


def test_the_split_shapes_are_the_smoke_tests(two):
    """The split norms a ``--spatial 2`` step runs on each rank, by (N, HW,
    C) of its rows, are ``chip_smoke.split_sites`` at the job's width and
    batch, and the evaluation's are the generators' sites halved; so at
    full width phase 12 checks the split kernels at every shape its step
    and its training CLI give them (``SPLIT_SHAPES``)."""
    cs = load_chip_smoke()
    w = selfcheck.TINY
    single, ranks = two[0]["sp"]
    steps = len(single["steps"])
    want = {s: steps * k for s, k in cs.split_sites(
        4, w["n_blocks"], w["ngf"], w["ndf"]).items()}
    assert all(r["split_shapes"] == want for r in ranks)
    assert single["split_shapes"] == {}
    single, ranks = two[0]["sp_eval"]
    want = set(cs.half_rows(cs.gen_sites(4, "B", w["ngf"], w["n_blocks"])))
    assert all(set(r["split_shapes"]) == want for r in ranks)
    full = set(cs.split_sites(cs.P12_BATCH))
    assert len(full) == 3 + 8  # 3 generator and 8 discriminator sites
    assert set(cs.p12_split_shapes()) == full | {
        s for n in cs.CLI_BATCHES for s in cs.half_rows(cs.gen_sites(n, "B"))}
    assert set(cs.p12_split_shapes()) <= set(cs.SPLIT_SHAPES)
