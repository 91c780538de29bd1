"""The port's conv/pad geometry helpers against the JAX package's
(ops/convs.py).  The port works on NCHW tensors with PyTorch kernel
layouts, the JAX package on NHWC with HWIO kernels; utils.convert maps the
kernels."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from domain_transfer_gan_tpu.ops import convs as jc

from domain_transfer_gan_torch.ops import convs as tc
from domain_transfer_gan_torch.utils.convert import jax_params_to_state_dict

from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL = 1e-5, 1e-5  # fp32, same sums in another order


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("pad", [0, 1, 3])
@pytest.mark.parametrize("kind", ["reflect", "replicate"])
def test_pads(pad, kind):
    x = np.random.RandomState(0).randn(2, 6, 7, 3).astype(np.float32)
    jfn = getattr(jc, kind + "_pad2d")
    tfn = getattr(tc, kind + "_pad2d")
    np.testing.assert_array_equal(_nhwc(tfn(_nchw(x), pad)),
                                  np.asarray(jfn(jnp.asarray(x), pad)))


@pytest.mark.parametrize("k,s,p", [(7, 1, 0), (3, 1, 1), (3, 2, 1),
                                   (7, 1, 3)])
def test_conv2d(k, s, p):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    w = (rng.randn(k, k, 4, 6) / k).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    sd = jax_params_to_state_dict("netG_B_A",
                                  {"conv0": {"kernel": w, "bias": b}})
    got = tc.conv2d_torch(_nchw(x), sd["conv0.weight"], sd["conv0.bias"],
                          stride=s, padding=p)
    want = jc.conv2d_torch(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           stride=s, padding=p)
    assert got.shape[2] == tc.torch_conv_out_size(16, k, s, p)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_conv_transpose2d_k3_s2_p1_op1():
    """The upsampling layer.  The JAX kernel is the forward-correlation
    kernel of the dilated input; the port's F.conv_transpose2d takes it
    flipped and as (I, O, kh, kw)."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    w = (rng.randn(3, 3, 6, 4) / 3).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    sd = jax_params_to_state_dict("netG_B_A",
                                  {"up0": {"kernel": w, "bias": b}})
    assert sd["up0.weight"].shape == (6, 4, 3, 3)
    got = tc.conv_transpose2d_torch(_nchw(x), sd["up0.weight"],
                                    sd["up0.bias"], 2, 1, 1)
    want = jc.conv_transpose2d_torch(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), 2, 1, 1)
    assert got.shape[2:] == (16, 16)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n,k,s,p,op", [(64, 3, 2, 1, 1), (32, 3, 2, 1, 1),
                                        (7, 4, 2, 1, 0)])
def test_out_sizes(n, k, s, p, op):
    assert tc.torch_conv_out_size(n, k, s, p) == \
        jc.torch_conv_out_size(n, k, s, p)
    assert tc.torch_conv_transpose_out_size(n, k, s, p, op) == \
        jc.torch_conv_transpose_out_size(n, k, s, p, op)
