"""The port's CLIs on the per-file data path and the other new data
branches, on the CPU at tiny width: ``cli.train --numpy_data 0`` (the
threaded DataLoader, its short tail batch trained on, the supervised
DataLoader, ``--profile_dir``), ``cli.test`` on its checkpoint (its
``TEST_MSE_A`` is ``eval_mse_A`` over the same DataLoader), the supervised
set on the device under ``--device_data``, a paired-jpg folder, and
``cli.import_torch`` -> ``cli.train --continue_train``."""

import json
import os
import re

import numpy as np
import pytest
import torch

from domain_transfer_gan_torch.cli import test as test_cli
from domain_transfer_gan_torch.cli.import_torch import main as import_main
from domain_transfer_gan_torch.cli.train import train_model
from domain_transfer_gan_torch.config import TrainConfig, \
    load_train_config_from_expr_dir
from domain_transfer_gan_torch.data import DataLoader
from domain_transfer_gan_torch.data.synthetic import (
    write_synthetic_dataset,
    write_synthetic_perfile_dataset,
)
from domain_transfer_gan_torch.eval import eval_mse_A
from domain_transfer_gan_torch.models import create_model

from torch_port_helpers import load_chip_smoke
from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)
from torch_reference_fixture import build_reference_nets, \
    reference_checkpoint

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WIDTH = ["--ngf", "4", "--nef", "4", "--ndf", "4", "--nlatent", "8"]


def _argv(root, ckpt, name, batch, extra=()):
    return ["--dataroot", root, "--name", name, "--checkpoints_dir", ckpt,
            "--grid_size", "64", "--batchSize", str(batch), *WIDTH,
            "--niter", "1", "--niter_decay", "0", "--print_freq", "8",
            "--display_freq", "16", "--save_epoch_freq", "1",
            "--eval_A_freq", "1", "--eval_B_freq", "0", "--seed", "3",
            "--dev_size", "8", "--device", "cpu", "--init_scheme", "sane",
            *extra]


@pytest.fixture(scope="module")
def perfile(tmp_path_factory):
    """One epoch of --numpy_data 0 --supervised at batch 2 on 23 train
    files (11 full batches and a tail of 1), with --profile_dir."""
    root = str(tmp_path_factory.mktemp("perfile"))
    ckpt = str(tmp_path_factory.mktemp("ck"))
    write_synthetic_perfile_dataset(root, n_train=31, n_test=7, size=64,
                                    seed=6)
    prof = os.path.join(ckpt, "prof")
    model = train_model(argv=_argv(
        root, ckpt, "pf", 2, ["--numpy_data", "0", "--nThreads", "2",
                              "--supervised", "--sup_frac", "0.5",
                              "--profile_dir", prof]))
    expr = os.path.join(ckpt, "pf")
    with open(os.path.join(expr, "results.txt")) as f:
        log = f.read()
    return {"root": root, "expr": expr, "model": model, "log": log,
            "prof": prof}


def test_perfile_training_runs_every_batch(perfile):
    model, log = perfile["model"], perfile["log"]
    assert (model.epoch, model.state.step) == (1, 12)  # the tail included
    assert "#training images = 23" in log and "#test images = 7" in log
    assert "#dev images = 8" in log and "#supervised images = 11" in log
    assert re.search(r"host reader: (native|numpy \(.+\))", log)
    assert "on-device batch gather" not in log
    for ln in log.splitlines():
        if ln.startswith("(epoch: "):
            vals = [float(v) for v in re.findall(r": (-?[\d.]+(?:e-?\d+)?)",
                                                 ln.split(") ", 1)[1])]
            assert vals and np.isfinite(vals).all(), ln
    for f in ("latest", "best_A", "opt.json", "history_mse_A.npy"):
        assert os.path.exists(os.path.join(perfile["expr"], f))
    with open(os.path.join(perfile["expr"], "opt.json")) as f:
        assert json.load(f)["numpy_data"] == 0


def test_profile_dir_writes_a_chrome_trace(perfile):
    path = os.path.join(perfile["prof"], "trace.json")
    with open(path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert "profiler trace written to %s" % perfile["prof"] in perfile["log"]


@pytest.mark.parametrize("metric", ["mse", "visual"])
def test_evaluation_cli_on_the_perfile_run(perfile, metric):
    latest = os.path.join(perfile["expr"], "latest")
    out = test_cli.test_model(["--chk_path", latest, "--dataroot",
                               perfile["root"], "--metric", metric,
                               "--device", "cpu"])
    res = os.path.join(perfile["expr"], "test_res")
    if metric == "visual":
        assert os.path.getsize(os.path.join(res, "cycle_0.png")) > 0
        assert os.path.getsize(os.path.join(res, "inf_0.png")) > 0
        return
    opt = load_train_config_from_expr_dir(perfile["expr"], seed=12345,
                                          device="cpu")
    model = create_model(opt, testing=True, device="cpu")
    model.load(latest)
    test = DataLoader(opt, subset="val", unaligned=False, batchSize=200,
                      load_in_mem=False)
    assert test.batch_size == 200
    direct = eval_mse_A(test, model)
    assert out["TEST_MSE_A"] == pytest.approx(direct, rel=1e-6)
    assert np.isfinite(out["DEV_MSE_A"])


def test_supervised_set_on_the_device(tmp_path):
    root = str(tmp_path / "npz")
    write_synthetic_dataset(root, n_train=16, n_test=4, size=64)
    model = train_model(argv=_argv(
        root, str(tmp_path / "ck"), "sup", 4,
        ["--supervised", "--sup_frac", "0.5", "--device_data", "1",
         "--eval_A_freq", "0"]))
    with open(str(tmp_path / "ck" / "sup" / "results.txt")) as f:
        log = f.read()
    assert "on-device batch gather; supervised set on cpu" in log
    assert model.state.step == 2


def test_paired_jpg_folder_trains(tmp_path):
    pytest.importorskip("PIL")
    from test_torch_port_edges2shoes import write_jpg_folder
    root = write_jpg_folder(str(tmp_path / "e2s"), n_train=16, n_val=4)
    model = train_model(argv=_argv(root, str(tmp_path / "ck"), "jpg", 4,
                                   ["--eval_A_freq", "0"]))
    with open(str(tmp_path / "ck" / "jpg" / "results.txt")) as f:
        log = f.read()
    assert "paired-jpg folder" in log and "#training images = 8" in log
    assert model.state.step == 2


def test_an_imported_upstream_checkpoint_resumes_training(tmp_path):
    """cli.import_torch writes the port's latest; cli.train
    --continue_train trains the whole schedule on from it."""
    nets = build_reference_nets(zdim=8, ngf=4, ndf=4, nef=4, seed=5)
    torch.save(reference_checkpoint(nets, aug=True, adam_steps=2),
               str(tmp_path / "upstream"))
    cfg = TrainConfig(ngf=4, nef=4, ndf=4, nlatent=8, device="cpu")
    with open(str(tmp_path / "opt.json"), "w") as f:
        json.dump(vars(cfg), f)
    expr = str(tmp_path / "ck" / "migrated")
    assert import_main(["--torch_chk", str(tmp_path / "upstream"), "--out",
                        os.path.join(expr, "latest"), "--device",
                        "cpu"]) == 0
    before = {k: v.clone() for k, v in
              create_model(cfg, testing=True, device="cpu").nets[
                  "netG_A_B"].state_dict().items()}
    imported = create_model(cfg, testing=True, device="cpu")
    imported.load(os.path.join(expr, "latest"))
    root = str(tmp_path / "npz")
    write_synthetic_dataset(root, n_train=16, n_test=4, size=64)
    trained = train_model(argv=_argv(root, str(tmp_path / "ck"),
                                     "migrated", 4, ["--continue_train"]))
    with open(os.path.join(expr, "results.txt")) as f:
        assert "resumed from %s (epoch 0, step 0)" % os.path.join(
            expr, "latest") in f.read()
    assert (trained.epoch, trained.state.step) == (1, 2)
    assert trained.state.opt_state["netG_A_B"].count == 2 + 2
    w = "conv0.weight"
    moved = trained.nets["netG_A_B"].state_dict()[w]
    start = imported.nets["netG_A_B"].state_dict()[w]
    assert not torch.equal(moved, start)
    assert float((moved - start).abs().max()) < 10 * 2e-4 * 2
    assert not torch.equal(start, before[w])


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 10, rehearsed on the CPU at tiny width
# ---------------------------------------------------------------------------

class PlainCounters:
    """chip_smoke's launch counters on the CPU: the kernel wrapper's calls
    of its plain versions, by direction and (N, HW, C)."""

    def __init__(self, monkeypatch):
        from domain_transfer_gan_torch.ops.kernels import instance_norm as K
        self.seen = {"fwd": {}, "bwd": {}}
        for d, name in (("fwd", "instance_norm_plain"),
                        ("bwd", "instance_norm_bwd_plain")):
            monkeypatch.setattr(K, name, self._counting(d, getattr(K, name)))

    def _counting(self, direction, fn):
        def wrapped(x, *a, **kw):
            key = (x.shape[0], x.shape[1] * x.shape[2], x.shape[3])
            d = self.seen[direction]
            d[key] = d.get(key, 0) + 1
            return fn(x, *a, **kw)
        return wrapped

    def reset(self):
        self.seen = {"fwd": {}, "bwd": {}}

    def read(self):
        return {d: dict(v) for d, v in self.seen.items()}


TINY_WIDTH = dict(ngf=4, nef=4, ndf=4, n_blocks=3, nlatent=8)
# 15 steps of 4 (the last a tail of 3), dev 8, test 5 (one eval batch
# padded to 200)
TINY_P10 = dict(batch=4, livneh_days=30, livneh_dev=8, n_train=67,
                n_test=5, dev_size=8, n_threads=2, jpg_dev=2,
                feed_turns=("npz", "prefetch", "sync"))


def test_chip_smoke_phase10_formula_holds_a_perfile_run(tmp_path,
                                                        monkeypatch):
    """What phase 10 (b) holds the card's counters to is what a per-file
    CLI run (display on, UBO off) launches, tail batch included."""
    cs = load_chip_smoke()
    counters = PlainCounters(monkeypatch)
    p = dict(TINY_P10, n_train=8 + 3 * 4 + 3)
    root = str(tmp_path / "pf")
    write_synthetic_perfile_dataset(root, n_train=p["n_train"],
                                    n_test=p["n_test"], size=64, seed=1)
    train_model(argv=cs._p10_argv(
        root, str(tmp_path / "ck"), "pf", "cpu", TINY_WIDTH, p,
        cs.P10_FEED["prefetch"] + ["--eval_A_freq", "1",
                                   "--display_freq", str(4 * 4)]))
    assert counters.read() == cs.p10_perfile_expected(TINY_WIDTH, p,
                                                      ubo=False)


@pytest.mark.slow
def test_chip_smoke_phase10_runs_on_the_cpu(tmp_path, monkeypatch):
    """The whole of phase 10 at tiny width on the CPU (~1 min): every run
    held to its launch formula, every check of the phase passing."""
    cs = load_chip_smoke()
    counters = PlainCounters(monkeypatch)
    total, _, fig = cs.drive_phase10(torch, None, str(tmp_path), "cpu",
                                     device="cpu", width=TINY_WIDTH,
                                     p=TINY_P10, counters=counters)
    assert sum(total["fwd"].values()) > 0 and sum(total["bwd"].values()) > 0
    assert fig["upstream_round_trip_max_abs_err"] <= cs.P10_PREDICT_ATOL
    assert fig["test_mse_A_vs_eval_mse_A"] <= 1e-6
    assert set(fig["feed_images_per_s"]) == {"npz", "prefetch", "sync"}
