"""The port's instance norm against the JAX package: the plain version of
the CUDA kernel vs the Pallas kernel (interpret mode on the CPU) and vs the
XLA reference, over the case matrix of tests/test_pallas_instance_norm.py.

The CUDA kernel itself cannot run without a card; chip_smoke.py and
tests/test_torch_port_cuda.py hold it against the plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from domain_transfer_gan_tpu.nn.norms import instance_norm_xla
from domain_transfer_gan_tpu.ops.pallas import (
    instance_norm_pallas,
    pallas_supported,
)
from domain_transfer_gan_tpu.ops.pallas.instance_norm import _fwd

from domain_transfer_gan_torch.nn.norms import (
    instance_norm_ref,
    instance_norm_stats,
)
from domain_transfer_gan_torch.ops.kernels.instance_norm import (
    instance_norm_fused,
    instance_norm_plain,
    launch_geometry,
)

from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# fp32: the same arithmetic in another summation order
RTOL = ATOL = 1e-5


def _data(per_sample, n=2, h=8, w=16, c=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    lead = (n, c) if per_sample else (c,)
    scale = rng.rand(*lead).astype(np.float32)
    shift = rng.randn(*lead).astype(np.float32)
    return x, scale, shift


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("unbiased", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("per_sample", [False, True])
def test_plain_vs_pallas_and_xla(unbiased, relu, per_sample):
    x, scale, shift = _data(per_sample)
    got = instance_norm_plain(_t(x), _t(scale), _t(shift), unbiased=unbiased,
                              relu=relu).numpy()
    pallas = instance_norm_pallas(_j(x), _j(scale), _j(shift),
                                  unbiased=unbiased, relu=relu)
    xla = instance_norm_xla(_j(x), _j(scale), _j(shift), 1e-5, unbiased,
                            relu=relu)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=RTOL, atol=ATOL)


def test_plain_no_affine():
    x, _, _ = _data(False)
    got = instance_norm_plain(_t(x), None, None).numpy()
    np.testing.assert_allclose(
        got, np.asarray(instance_norm_pallas(_j(x), None, None)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(instance_norm_xla(_j(x), None, None, 1e-5, False)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("unbiased", [False, True])
def test_plain_stats_vs_pallas_fwd(unbiased):
    """mean and rstd, which the backward kernel will need, against the
    Pallas forward's own outputs."""
    x, scale, shift = _data(True, seed=3)
    n, h, w, c = x.shape
    _, mean, rstd = instance_norm_plain(_t(x), _t(scale), _t(shift),
                                        unbiased=unbiased, return_stats=True)
    _, jmean, jrstd = _fwd(_j(x.reshape(n, h * w, c)), _j(scale[:, None, :]),
                           _j(shift[:, None, :]), 1e-5, unbiased, False)
    assert mean.shape == rstd.shape == (n, c)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[:, 0, :],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[:, 0, :],
                               rtol=RTOL, atol=ATOL)


def test_plain_bf16_vs_xla():
    """bf16 in and out, fp32 statistics: one bf16 rounding of an O(1)
    output apart at most (2^-7 relative, values up to ~4)."""
    x, scale, shift = _data(True, seed=4)
    xb = _t(x).to(torch.bfloat16)
    got = instance_norm_plain(xb, _t(scale), _t(shift), unbiased=True,
                              relu=True)
    assert got.dtype == torch.bfloat16
    want = instance_norm_xla(_j(x).astype(jnp.bfloat16), _j(scale),
                             _j(shift), 1e-5, True, relu=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=2e-2)


def test_plain_takes_a_shape_the_tpu_kernel_refuses():
    """HW=4096, C=32 (the first norm site at 64x64, ngf=32) does not fit the
    TPU kernel's block budget and falls back to XLA there; the port takes
    every shape."""
    assert not pallas_supported(4096, 32)
    x, scale, shift = _data(True, n=2, h=64, w=64, c=32, seed=5)
    got = instance_norm_plain(_t(x), _t(scale), _t(shift), unbiased=True,
                              relu=True).numpy()
    want = instance_norm_xla(_j(x), _j(scale), _j(shift), 1e-5, True,
                             relu=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("unbiased", [False, True])
def test_ref_twin_vs_xla(unbiased):
    """nn.norms.instance_norm_ref / instance_norm_stats are the twins of the
    JAX instance_norm_xla / instance_norm_stats (E[x^2] - mean^2 form)."""
    import domain_transfer_gan_tpu.nn.norms as jn

    x, scale, shift = _data(False, seed=6)
    got = instance_norm_ref(_t(x), _t(scale), _t(shift), 1e-5, unbiased,
                            relu=True).numpy()
    want = instance_norm_xla(_j(x), _j(scale), _j(shift), 1e-5, unbiased,
                             relu=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    mean, rstd = instance_norm_stats(_t(x), 1e-5, unbiased)
    jmean, jrstd = jn.instance_norm_stats(_j(x), 1e-5, unbiased)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd), rtol=RTOL,
                               atol=ATOL)


def test_fused_on_cpu_is_the_plain_version():
    x, scale, shift = _data(True, seed=7)
    before = instance_norm_fused.launches
    got = instance_norm_fused(_t(x), _t(scale), _t(shift), unbiased=True,
                              relu=True)
    want = instance_norm_plain(_t(x), _t(scale), _t(shift), unbiased=True,
                               relu=True)
    assert torch.equal(got, want)
    assert instance_norm_fused.launches == before  # no kernel, no count


@pytest.mark.parametrize("bad", ["rank", "dtype", "scale_shape",
                                 "scale_only", "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, scale, shift = (_t(a) for a in _data(False))
    if bad == "rank":
        x = x[0]
    elif bad == "dtype":
        x = x.to(torch.float16)
    elif bad == "scale_shape":
        scale = scale[:-1]
    elif bad == "scale_only":
        shift = None
    elif bad == "empty":
        x = x[:0]
    with pytest.raises((ValueError, TypeError)):
        instance_norm_fused(x, scale, shift)


@pytest.mark.parametrize("n,c,itemsize,aligned,want", [
    # the three path shapes at batch 32 on a 132-SM card, float32 then bf16
    (32, 32, 4, True, (4, 2)),
    (32, 64, 4, True, (4, 2)),
    (32, 128, 4, True, (4, 2)),
    (32, 32, 2, True, (8, 2)),
    (32, 128, 2, True, (8, 2)),
    # C not a multiple of the pack, or unaligned pointers: scalar path
    (3, 20, 2, True, (1, 16)),
    (3, 20, 4, True, (4, 2)),
    (2, 4, 4, False, (1, 4)),
    # enough samples to fill the card: keep the widest tile
    (1024, 128, 4, True, (4, 32)),
])
def test_launch_geometry(n, c, itemsize, aligned, want):
    vec, tx = launch_geometry(n, c, itemsize, aligned, sm_count=132)
    assert (vec, tx) == want
    assert tx in (1, 2, 4, 8, 16, 32) and 256 % tx == 0
    assert c % vec == 0
    # a row segment is at least one 32-byte sector unless C itself is smaller
    assert tx * vec * itemsize >= min(32, c * itemsize)
