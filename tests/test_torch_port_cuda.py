"""Tests of the port that need a CUDA device and nvcc (marker ``cuda``); they
skip elsewhere.  Run them on a machine with a card:

    python -m pytest -m cuda tests/test_torch_port_cuda.py -q

This file imports nothing of the JAX package, so it also collects where flax
is not installed.  chip_smoke.py runs the full matrix and the full-width
serving path; these are the small-shape versions.
"""

import numpy as np
import pytest
import torch

from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.models import create_model
from domain_transfer_gan_torch.ops.kernels.instance_norm import (
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
