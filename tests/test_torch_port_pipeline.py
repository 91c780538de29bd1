"""GPipe over the generators' residual trunks (``parallel/pipeline.py``),
over gloo ranks on the CPU at tiny width.

The engine against the sequential block loop at the JAX cases (S, M) in
{(4, 4), (2, 4), (4, 2), (2, 2)} (``tests/test_pipeline.py``): output and
the gradients of every block parameter, the input and the CIN code.  The
steps of ``aug_cycle_gan``, ``stoch_cycle_gan`` and the supervised step
over ``--pipeline 2`` (M = S and M = 2S), also composed with a data axis
over 4 ranks, with EMA, and the unpipelined generation helpers and UBO
evaluation, each against one process on the full batch."""

import numpy as np
import pytest
import torch

from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.models import create_model

import torch_port_mesh_ranks as R
from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)
from torch_port_mesh_runs import hold_job, once, run_group

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TWO = ("pp", "pp_m4", "pp_stoch", "pp_sup", "pp_ema", "pp_eval")
FOUR = ("dp_pp", "dp_pp_m4")


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return once(tmp_path_factory, "pipeline_two",
                lambda: run_group(TWO, 2, ("helpers_unpipelined",)))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return once(tmp_path_factory, "pipeline_four",
                lambda: run_group(FOUR, 4, ("engine_cases",)))


def _sequential(case):
    blocks, x, z, w = R.trunk_fixture()
    x = x.clone().requires_grad_(True)
    z = z.clone().requires_grad_(True)
    y = x
    for blk in blocks:
        y = blk(y, z, False)
    params = [p for blk in blocks for p in blk.parameters()]
    grads = torch.autograd.grad((w * y).sum(), params + [x, z])
    return {"y": y.detach().numpy(),
            "param_grads": torch.cat([g.reshape(-1)
                                      for g in grads[:-2]]).numpy(),
            "dx": grads[-2].numpy(), "dz": grads[-1].numpy()}


@pytest.mark.parametrize("case", R.ENGINE_CASES,
                         ids=["S%dM%d" % c for c in R.ENGINE_CASES])
def test_the_engine_is_the_sequential_trunk(four, case):
    """Forward to float32 rounding; every block's gradient, summed over
    the ranks (each block's only on its stage), and those of the input and
    the code, gathered, within 1e-4 relative."""
    want = _sequential(case)
    for rank in four[1]:
        got = rank["engine_cases"][case]
        np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5, atol=1e-5)
        for k in ("param_grads", "dx", "dz"):
            err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
            assert err <= 1e-4, (case, k, err)


@pytest.mark.parametrize("job", TWO[:5])
def test_pipeline_steps_match_one_process(two, job):
    single, ranks = two[0][job]
    hold_job(single, ranks)
    # every generator call of the step ran the pipeline: 4 a step (phase
    # 0 and the cycles), 2 for the supervised step
    per_step = 2 if job == "pp_sup" else 4
    assert all(r["trunk_runs"] == per_step * len(single["steps"])
               for r in ranks)
    assert single["trunk_runs"] == 0


@pytest.mark.parametrize("job", FOUR)
def test_data_times_pipe_steps_match_one_process(four, job):
    single, ranks = four[0][job]
    assert len(ranks) == 4
    hold_job(single, ranks)
    assert all(r["trunk_runs"] == 4 * len(single["steps"]) for r in ranks)


def test_the_ubo_evaluation_runs_unpipelined(two):
    """eval_mse_A and the UBO over (data, pipe): one process's numbers, and
    no trunk ran as a pipeline (the engine is step-scoped)."""
    single, ranks = two[0]["pp_eval"]
    hold_job(single, ranks)
    assert all(r["trunk_runs"] == 0 for r in ranks)


def test_the_generation_helpers_run_unpipelined(two):
    cfg = TrainConfig(model="aug_cycle_gan", grid_size=64, ngf=4, nef=4,
                      ndf=4, nlatent=8, n_blocks=4, batchSize=8,
                      init_scheme="sane", monitor_gnorm=True, seed=4,
                      device="cpu")
    model = create_model(cfg, testing=True, device="cpu")
    rng = np.random.RandomState(5)
    A = rng.uniform(-1, 1, (8, 64, 64, 3)).astype(np.float32)
    z = rng.randn(8, 8).astype(np.float32)
    want_B, want_A = model.predict_B(A, z).numpy(), model.predict_A(A).numpy()
    for rank in two[1]:
        got = rank["helpers_unpipelined"]
        np.testing.assert_allclose(got["predict_B"], want_B, rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(got["predict_A"], want_A, rtol=2e-4,
                                   atol=2e-5)
        assert got["engine_off_after"]
