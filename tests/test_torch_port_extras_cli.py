"""The step extras through the port's CLIs on the CPU (--device cpu, tiny
nets): one epoch of ``aug_cycle_gan --pool_size 8 --ema 0.999 --remat`` and
one of ``--grad_accum 2 --ema 0.9`` through the training CLI, one more of
the pool run with ``--continue_train``; ``latest`` is format 2 and carries
the pools and the shadows; the evaluation CLI's ``--use_ema 1`` scores the
swapped model (``TEST_MSE_A`` = ``eval_mse_A``) and the export CLI's
``--use_ema 1`` writes it."""

import os
import shutil

import numpy as np
import pytest
import torch

from domain_transfer_gan_torch.cli import test as test_cli
from domain_transfer_gan_torch.cli.export import load_exported
from domain_transfer_gan_torch.cli.export import main as export_main
from domain_transfer_gan_torch.cli.train import train_model
from domain_transfer_gan_torch.config import load_train_config_from_expr_dir
from domain_transfer_gan_torch.data import AlignedIterator, load_numpy_data
from domain_transfer_gan_torch.data.synthetic import write_synthetic_dataset
from domain_transfer_gan_torch.eval import eval_mse_A
from domain_transfer_gan_torch.models import create_model
from domain_transfer_gan_torch.utils import checkpoint

from torch_port_helpers import (  # noqa: F401 (a fixture)
    images,
    latents,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RUNS = {"pool": ["--pool_size", "8", "--ema", "0.999", "--remat"],
        "accum": ["--grad_accum", "2", "--ema", "0.9"]}
STEPS = 4  # 24 train images, 8 of them the dev split, batch 4


def _argv(root, ckpt, name, extra=()):
    return ["--dataroot", root, "--name", name, "--checkpoints_dir", ckpt,
            "--grid_size", "64", "--batchSize", "4", "--ngf", "4",
            "--nef", "4", "--ndf", "4", "--nlatent", "8", "--niter", "1",
            "--niter_decay", "0", "--print_freq", "8", "--display_freq",
            "16", "--save_epoch_freq", "1", "--eval_B_freq", "0",
            "--seed", "3", "--dev_size", "8", "--device", "cpu",
            "--init_scheme", "sane", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ds"))
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    write_synthetic_dataset(root, n_train=24, n_test=6, size=64)
    out = {"root": root}
    for name, flags in RUNS.items():
        model = train_model(argv=_argv(root, ckpt, name, flags))
        expr = os.path.join(ckpt, name)
        latest = os.path.join(expr, "latest")
        out[name] = {"model": model, "expr": expr, "latest": latest,
                     "payload": checkpoint.read_checkpoint(latest)}
        shutil.copyfile(latest, latest + "_epoch1")
    out["resumed"] = train_model(argv=_argv(
        root, ckpt, "pool", RUNS["pool"] + ["--continue_train",
                                            "--niter_decay", "1"]))
    return out


def _loaded(run, swap, chk="latest"):
    opt = load_train_config_from_expr_dir(run["expr"], seed=12345,
                                          device="cpu")
    model = create_model(opt, testing=True, device="cpu")
    model.load(os.path.join(run["expr"], chk))
    if swap:
        model.swap_ema()
    return model


def test_latest_carries_the_pools_and_the_shadows(runs):
    pool, acc = runs["pool"]["payload"], runs["accum"]["payload"]
    assert pool["format"] == acc["format"] == \
        "domain_transfer_gan_torch checkpoint 2"
    assert {k: (tuple(v["buf"].shape), v["n"])
            for k, v in pool["pools"].items()} == {
        "fake_A": ((8, 64, 64, 3), 8), "fake_B": ((8, 64, 64, 3), 8)}
    assert "pools" not in acc
    for payload in (pool, acc):
        assert set(payload["ema"]) == {"netG_A_B", "netG_B_A", "netE_B"}
        for net, shadow in payload["ema"].items():
            assert set(shadow) == set(payload["nets"][net]) - {
                k for k in payload["nets"][net] if "running_" in k}
            # an average of the start and STEPS updates: not the live weights
            assert any(not torch.equal(v, payload["nets"][net][k])
                       for k, v in shadow.items())
    assert runs["pool"]["model"].state.step == runs["accum"][
        "model"].state.step == STEPS
    assert runs["pool"]["model"].nets["netG_A_B"].remat


def test_resume_restores_the_pools_bit_for_bit(runs):
    saved = runs["pool"]["payload"]
    model = _loaded(runs["pool"], swap=False, chk="latest_epoch1")
    for name, pool in model.state.pools.items():
        assert torch.equal(pool.buf, saved["pools"][name]["buf"])
        assert pool.n == saved["pools"][name]["n"]
    for name, shadow in model.state.ema.items():
        names = [n for n, _ in model.nets[name].named_parameters()]
        assert all(torch.equal(t, saved["ema"][name][n])
                   for t, n in zip(shadow, names))
    resumed = runs["resumed"]
    assert (resumed.epoch, resumed.state.step) == (2, 2 * STEPS)
    with open(os.path.join(runs["pool"]["expr"], "results.txt")) as f:
        assert "resumed from" in f.read()


@pytest.mark.parametrize("name", list(RUNS))
def test_the_evaluation_cli_scores_the_shadows(runs, name):
    out = test_cli.test_model(["--chk_path", runs[name]["latest"],
                               "--dataroot", runs["root"], "--metric", "mse",
                               "--device", "cpu", "--use_ema", "1"])
    _, _, _, _, testA, testB = load_numpy_data(runs["root"], grid_size=64,
                                               dev_size=8)
    data = AlignedIterator(testA, testB, batch_size=200)
    swapped = eval_mse_A(data, _loaded(runs[name], swap=True))
    live = eval_mse_A(data, _loaded(runs[name], swap=False))
    assert abs(out["TEST_MSE_A"] - swapped) <= 1e-6 * swapped
    assert swapped != live


def test_the_export_cli_writes_the_shadows(runs, tmp_path):
    out = str(tmp_path / "export")
    export_main(["--chk_path", runs["pool"]["latest"], "--out", out,
                 "--batch", "2", "--device", "cpu", "--use_ema", "1"])
    model = _loaded(runs["pool"], swap=True)
    A, z = images(31, 2), latents(32, 2, 8)
    got = load_exported(out, "predict_B", "cpu")(model._tensor(A),
                                                 model._tensor(z))
    np.testing.assert_allclose(got.numpy(), model.predict_B(A, z).numpy(),
                               rtol=0, atol=1e-5)
    live = _loaded(runs["pool"], swap=False).predict_B(A, z).numpy()
    assert np.abs(got.numpy() - live).max() > 1e-5
