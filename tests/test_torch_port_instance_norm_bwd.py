"""The port's instance-norm backward against the JAX package: the plain
version of the CUDA backward kernel vs the Pallas backward kernel (interpret
mode on the CPU) and vs ``jax.grad`` through the XLA reference; and the
``torch.autograd.Function`` on CPU tensors, whose backward is that plain
version, vs autograd of the plain forward.

The CUDA kernel itself cannot run without a card; chip_smoke.py and
tests/test_torch_port_cuda.py hold it against the plain version there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from domain_transfer_gan_tpu.nn.norms import instance_norm_xla
from domain_transfer_gan_tpu.ops.pallas.instance_norm import _bwd, _fwd

from domain_transfer_gan_torch.ops.kernels.instance_norm import (
    instance_norm_bwd_fused,
    instance_norm_bwd_plain,
    instance_norm_fused,
    instance_norm_plain,
)

from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FWD_RTOL = 1e-4   # forward, fp32: another summation order
GRAD_RTOL = 1e-3  # gradients, fp32, relative to the tensor's largest value
AFFINES = ("none", "channel", "sample")


def _data(affine, dtype=np.float32, n=2, h=8, w=16, c=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    dy = rng.randn(n, h, w, c).astype(np.float32)
    if dtype == "bfloat16":  # values a bfloat16 holds exactly
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        dy = torch.from_numpy(dy).to(torch.bfloat16).float().numpy()
    if affine == "none":
        return x, dy, None, None
    lead = (c,) if affine == "channel" else (n, c)
    return (x, dy, (rng.rand(*lead) + 0.5).astype(np.float32),
            rng.randn(*lead).astype(np.float32))


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rtol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", AFFINES)
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("unbiased", [False, True])
def test_bwd_plain_vs_pallas_bwd(unbiased, relu, affine, dtype):
    """Same x, dy, mean, rstd, scale, shift into the Pallas backward kernel
    and the port's plain backward: dx and the per-sample dscale, dshift."""
    x, dy, scale, shift = _data(affine, dtype)
    n, h, w, c = x.shape
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ones, zeros = np.ones((n, c), np.float32), np.zeros((n, c), np.float32)
    s3 = np.broadcast_to(ones if scale is None else scale, (n, c))
    t3 = np.broadcast_to(zeros if shift is None else shift, (n, c))
    x3 = jnp.asarray(x.reshape(n, h * w, c)).astype(jdt)
    jy, jmean, jrstd = _fwd(x3, jnp.asarray(s3[:, None]),
                            jnp.asarray(t3[:, None]), 1e-5, unbiased, relu)
    jdx, jds, jdt_ = _bwd(x3, jnp.asarray(dy.reshape(n, h * w, c)).astype(jdt),
                          jmean, jrstd, jnp.asarray(s3[:, None]),
                          jnp.asarray(t3[:, None]), unbiased, relu)

    y, mean, rstd = instance_norm_plain(_t(x, tdt), _t(scale), _t(shift),
                                        unbiased=unbiased, relu=relu,
                                        return_stats=True)
    _close(mean, np.asarray(jmean)[:, 0], FWD_RTOL)
    _close(rstd, np.asarray(jrstd)[:, 0], FWD_RTOL)
    dx, ds, dt = instance_norm_bwd_plain(_t(x, tdt), _t(dy, tdt), mean, rstd,
                                         _t(scale), _t(shift),
                                         unbiased=unbiased, relu=relu)
    assert dx.dtype == tdt and ds.shape == dt.shape == (n, c)
    if dtype == "float32":
        _close(y, np.asarray(jy).reshape(x.shape), FWD_RTOL)
        _close(dx, np.asarray(jdx).reshape(x.shape), GRAD_RTOL)
    else:  # one bfloat16 rounding of values below 8
        _close(dx.float(), np.asarray(jdx.astype(jnp.float32)).reshape(
            x.shape), 4e-2)
    _close(ds, np.asarray(jds)[:, 0], GRAD_RTOL)
    _close(dt, np.asarray(jdt_)[:, 0], GRAD_RTOL)


@pytest.mark.parametrize("affine", AFFINES)
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("unbiased", [False, True])
def test_function_vs_jax_grad_of_xla_reference(unbiased, relu, affine):
    """Gradients of x, scale and shift through the port's Function (plain
    backward on the CPU; the (C,) case sums over N) against jax.grad through
    instance_norm_xla, for a random cotangent."""
    x, dy, scale, shift = _data(affine, seed=1)
    leaves = [t.requires_grad_(True) for t in (_t(x), _t(scale), _t(shift))
              if t is not None]
    args = leaves + [None] * (3 - len(leaves))
    y = instance_norm_fused(*args, unbiased=unbiased, relu=relu)
    grads = torch.autograd.grad((y * _t(dy)).sum(), leaves)

    def loss(xx, ss, tt):
        return jnp.sum(instance_norm_xla(xx, ss, tt, 1e-5, unbiased,
                                         relu=relu) * jnp.asarray(dy))
    if affine == "none":
        want = (jax.grad(lambda xx: loss(xx, None, None))(jnp.asarray(x)),)
    else:
        want = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift))
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        _close(g, w, GRAD_RTOL)


@pytest.mark.parametrize("affine", AFFINES)
def test_function_on_cpu_vs_autograd_of_plain_forward(affine):
    """The hand-derived backward against autograd of instance_norm_plain,
    float32, with a cotangent that is not contiguous in NHWC order."""
    x, dy, scale, shift = _data(affine, seed=2)
    wgt = torch.from_numpy(np.ascontiguousarray(
        dy.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    assert not wgt.is_contiguous()
    out = []
    for fn in (instance_norm_fused, instance_norm_plain):
        leaves = [t.requires_grad_(True)
                  for t in (_t(x), _t(scale), _t(shift)) if t is not None]
        args = leaves + [None] * (3 - len(leaves))
        copies = instance_norm_bwd_fused.dy_copies
        y = fn(*args, unbiased=True, relu=True)
        out.append(torch.autograd.grad((y * wgt).sum(), leaves))
        if fn is instance_norm_fused:
            assert instance_norm_bwd_fused.dy_copies == copies + 1
    assert instance_norm_bwd_fused.launches == 0  # no card, no launch
    for g, w in zip(*out):
        _close(g, w.numpy(), 1e-5)


@pytest.mark.parametrize("unbiased", [False, True])
def test_hw_equal_one(unbiased):
    """HW = 1: x - mean = 0, so y = shift and dx = 0; the unbiased divisor is
    max(HW - 1, 1) in both directions, not 0."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(3, 1, 1, 5).astype(np.float32))
    scale = torch.from_numpy(rng.rand(5).astype(np.float32) + 0.5)
    shift = torch.from_numpy(rng.randn(5).astype(np.float32))
    leaves = [t.requires_grad_(True) for t in (x, scale, shift)]
    y = instance_norm_fused(*leaves, unbiased=unbiased)
    dx, ds, dt = torch.autograd.grad(y.sum(), leaves)
    assert torch.isfinite(y).all()
    assert torch.equal(dx, torch.zeros_like(dx))
    assert torch.equal(ds, torch.zeros_like(ds))
    assert torch.equal(dt, torch.full_like(dt, 3.0))


def test_mean_and_rstd_carry_no_gradient():
    x = torch.randn(2, 4, 4, 3, requires_grad=True)
    y, mean, rstd = instance_norm_fused(x, None, None, return_stats=True)
    assert y.requires_grad and not mean.requires_grad \
        and not rstd.requires_grad


def test_bwd_wrapper_rejects_a_mismatched_cotangent():
    x = torch.randn(2, 4, 4, 3)
    _, mean, rstd = instance_norm_plain(x, None, None, return_stats=True)
    with pytest.raises(ValueError, match="must have x's shape"):
        instance_norm_bwd_fused(x, x[:, :2], mean, rstd, None, None)
