"""The port's training CLI end to end on the CPU (--device cpu, tiny nets):
train 1 + 1 epochs, resume for a third, export from the checkpoint with
--chk_path and answer a predict_B request over HTTP; the artifact contract
and the loss-line format are the JAX package's.  Every flag the port does
not run yet is refused by name (the other variants and the supervised
step train in tests/test_torch_port_test_cli.py).

The variational UBO evaluates at the CLI's eval batch of 100 (a tiny dev
set is padded to it), 50 steps of a forward and backward each, which takes
~30 s per eval batch on one CPU core: the tier-1 run trains with
--eval_B_freq 0 and the `slow` test runs the whole contract with it on.  The
UBO itself is held against the JAX package at small batches in
tests/test_torch_port_eval.py.
"""

import io
import json
import os
import re
import sys
import threading
import urllib.request

import numpy as np
import pytest

from domain_transfer_gan_tpu.utils import artifacts as jax_artifacts

from domain_transfer_gan_torch.cli.export import main as export_main
from domain_transfer_gan_torch.cli.serve import build_server
from domain_transfer_gan_torch.cli.train import train_model
from domain_transfer_gan_torch.config import (
    TrainConfig,
    load_train_config_from_expr_dir,
)
from domain_transfer_gan_torch.data import PILMissingError
from domain_transfer_gan_torch.data.synthetic import write_synthetic_dataset
from domain_transfer_gan_torch.models import create_model
from domain_transfer_gan_torch.utils.artifacts import format_log

from torch_port_helpers import (  # noqa: F401 (a fixture)
    images,
    latents,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# tests/test_cli.py's contract, then the vis dirs
ARTIFACTS_A = ("latest", "best_A", "best_mse_A.txt", "history_mse_A.npy",
               "nets.txt", "opt.txt", "opt.json", "opt.pkl", "results.txt",
               "results.json")
ARTIFACTS_B = ("best_B", "best_bpp_B.txt", "history_ubo_B.npy")
VIS_DIRS = ("vis_cycle", "train_vis_cycle", "vis_multi", "vis_latest",
            "vis_inf", "vis_pred_B")
LOSS_KEYS = ["D_A", "G_A", "Cyc_A", "Cyc_z_B", "KLD_z_B", "D_B", "G_B",
             "Cyc_B", "D_z_B", "P_t_A", "P_f_A", "P_t_B", "P_f_B"]
GNORM_KEYS = ["gnorm_G_A_B", "gnorm_G_B_A", "gnorm_E_B", "gnorm_D_B",
              "gnorm_D_z_B", "gnorm_D_A", "mu_min", "mu_max", "logvar_min",
              "logvar_max"]


def _argv(root, ckpt, name, eval_B_freq, extra=()):
    return ["--dataroot", root, "--name", name, "--checkpoints_dir", ckpt,
            "--grid_size", "64", "--batchSize", "4", "--ngf", "4",
            "--nef", "4", "--ndf", "4", "--nlatent", "8", "--niter", "1",
            "--niter_decay", "1", "--print_freq", "8", "--display_freq", "16",
            "--save_epoch_freq", "1", "--eval_A_freq", "1",
            "--eval_B_freq", str(eval_B_freq), "--seed", "3",
            "--dev_size", "8", "--device", "cpu",
            "--init_scheme", "sane", *extra]


def _train_resume(tmp_path_factory, eval_B_freq):
    root = str(tmp_path_factory.mktemp("ds"))
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    write_synthetic_dataset(root, n_train=24, n_test=8, size=64)
    first = train_model(argv=_argv(root, ckpt, "run", eval_B_freq,
                                   ["--device_data", "1"]))
    expr = os.path.join(ckpt, "run")
    with open(os.path.join(expr, "results.txt")) as f:
        log1 = f.read()
    second = train_model(argv=_argv(
        root, ckpt, "run", eval_B_freq,
        ["--continue_train", "--niter_decay", "2", "--device_data", "0"]))
    return {"root": root, "expr": expr, "first": first, "second": second,
            "log1": log1}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _train_resume(tmp_path_factory, eval_B_freq=0)


def _check_contract(run, with_B):
    expr = run["expr"]
    for f in ARTIFACTS_A + (ARTIFACTS_B if with_B else ()):
        assert os.path.exists(os.path.join(expr, f)), f
    for f in ARTIFACTS_B if not with_B else ():
        assert not os.path.exists(os.path.join(expr, f)), f
    for d in VIS_DIRS:
        assert os.path.isdir(os.path.join(expr, d)), d
    for png in ("cycle.png", "multi.png", "inf.png"):
        assert os.path.getsize(os.path.join(expr, "vis_latest", png)) > 0
    assert os.listdir(os.path.join(expr, "train_vis_cycle"))
    # the source snapshot: top-level modules flat, subpackages as a tree
    assert os.path.exists(os.path.join(expr, "config.py"))
    assert os.path.exists(os.path.join(expr, "cli", "train.py"))
    with open(os.path.join(expr, "results.json")) as f:
        results = json.load(f)
    assert np.isfinite(results["best_dev_mse_A"])
    hist = np.load(os.path.join(expr, "history_mse_A.npy"))
    assert hist.shape == (3, 2) and np.isfinite(hist).all()
    if with_B:
        assert np.isfinite(results["best_dev_bpp_B"])
        hub = np.load(os.path.join(expr, "history_ubo_B.npy"))
        assert hub.shape == (3, 6) and np.isfinite(hub).all()
        assert os.listdir(os.path.join(expr, "vis_pred_B"))


def test_artifact_contract_and_resume(run):
    _check_contract(run, with_B=False)
    with open(os.path.join(run["expr"], "results.txt")) as f:
        log = f.read()
    assert log.startswith(run["log1"])  # resume appends
    m = re.search(r"resumed from .*latest \(epoch (\d+), step (\d+)\)", log)
    assert m and int(m.group(1)) == 2 and int(m.group(2)) == 8
    assert "(epoch: 3, iters:" in log and "End of epoch 3 / 3" in log
    first, second = run["first"], run["second"]
    assert (first.epoch, first.state.step) == (2, 8)
    assert (second.epoch, second.state.step) == (3, 12)
    # latest holds the lr of before epoch 2's decay (the JAX CLI saves
    # before update_learning_rate); epoch 3 decays it by lr / 2
    assert second.old_lr == pytest.approx(2e-4 - 2e-4 / 2, abs=1e-12)
    assert first.old_lr == pytest.approx(0.0, abs=1e-12)


def test_log_lines_are_the_jax_format(run):
    with open(os.path.join(run["expr"], "results.txt")) as f:
        lines = f.read().splitlines()
    loss_lines = [ln for ln in lines if ln.startswith("(epoch: ")]
    assert len(loss_lines) == 6  # 4 steps of 4 images, print_freq 8, x 3
    head = re.compile(r"^\(epoch: \d+, iters: \d+, time: \d+\.\d{3}\) ")
    for ln in loss_lines:
        assert head.match(ln), ln
        body = head.sub("", ln)
        keys = re.findall(r"(\w+): (-?\d+\.\d{3}) ", body)
        assert [k for k, _ in keys] == LOSS_KEYS, ln
        assert all(np.isfinite(float(v)) for _, v in keys)
        i = lines.index(ln)
        gkeys = re.findall(r"(\w+): -?\d+\.\d{3} ", lines[i + 1])
        assert [k for k in gkeys] == GNORM_KEYS
        assert re.match(r"  throughput: \d+\.\d images/sec", lines[i + 3])
    vals = {k: float(i) / 3 for i, k in enumerate(LOSS_KEYS)}
    for prefix in (True, False):
        assert format_log(2, 40, vals, 0.123, prefix) == \
            jax_artifacts.format_log(2, 40, vals, 0.123, prefix)
    assert "DEV_MSE_A" in "\n".join(lines)


def test_export_from_checkpoint_serves_the_model(run, tmp_path):
    """export --chk_path -> HTTP server -> predict_B equals the checkpoint's
    model's predict_B."""
    latest = os.path.join(run["expr"], "latest")
    out = str(tmp_path / "export")
    export_main(["--chk_path", latest, "--out", out, "--batch", "4",
                 "--device", "cpu"])
    opt = load_train_config_from_expr_dir(run["expr"])
    model = create_model(opt, testing=True, device="cpu")
    model.load(latest)
    A, z = images(21, 3), latents(22, 3, 8)
    want = model.predict_B(A, z).numpy()

    server = build_server(out, port=0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        np.savez(buf, A=A, z=z)
        url = "http://127.0.0.1:%d/predict_B" % server.server_address[1]
        req = urllib.request.Request(url, data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = np.load(io.BytesIO(resp.read()))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    assert got.shape == (3, 64, 64, 3)
    # the server pads the request to the artifact's batch of 4; the CPU
    # convs sum in another blocking at another batch (1.2e-6 seen)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the run kept no EMA shadows: --use_ema 1 has nothing to export
    with pytest.raises(ValueError, match="--use_ema 1 needs a checkpoint "
                       "trained with --ema"):
        export_main(["--chk_path", latest, "--out", out, "--use_ema", "1",
                     "--device", "cpu"])


def test_a_paired_jpg_dataroot_is_refused_before_anything_is_written(
        tmp_path, monkeypatch):
    """A dataroot with a train/ directory and no trainA.npz is a paired-jpg
    folder, which trains where PIL exists
    (tests/test_torch_port_perfile_cli.py); without PIL it is refused by
    the module's name and nothing is written."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    root = tmp_path / "edges2shoes"
    (root / "train").mkdir(parents=True)
    argv = ["--dataroot", str(root), "--name", "r", "--checkpoints_dir",
            str(tmp_path / "ck"), "--device", "cpu"]
    with pytest.raises(PILMissingError,
                       match="the paired-jpg branch of load_edges2shoes "
                             "needs the PIL module"):
        train_model(argv=argv)
    assert not os.path.exists(str(tmp_path / "ck"))
    with pytest.raises(PILMissingError, match="PIL"):
        train_model(opt=TrainConfig(dataroot=str(root), device="cpu"))
    assert sorted(os.listdir(str(tmp_path))) == ["edges2shoes"]


# the combinations the accumulation steps refuse, as the JAX package's
# models/accum.py::_check_cfg and models/api.py::_accum_k do, when the
# model is built
ACCUM_REFUSED = [
    (["--pool_size", "4"], "--grad_accum does not compose with --pool_size"),
    (["--norm", "batch"], "--grad_accum with --norm batch"),
    (["--supervised"], "--grad_accum does not support --supervised"),
    (["--batchSize", "3"], "batch 3 not divisible by --grad_accum 2"),
]


@pytest.mark.parametrize("flags,named", ACCUM_REFUSED,
                         ids=[r[0][0] for r in ACCUM_REFUSED])
def test_accumulation_combinations_are_refused(tmp_path, flags, named):
    root = str(tmp_path / "ds")
    write_synthetic_dataset(root, n_train=10, n_test=2, size=64)
    argv = _argv(root, str(tmp_path / "ck"), "acc", 0,
                 ["--grad_accum", "2", "--dev_size", "2", *flags])
    with pytest.raises(ValueError, match=named):
        train_model(argv=argv)


def test_tpu_only_flags_are_accepted(tmp_path):
    """--host_devices and --data_axis parse and change nothing; the model
    flags of the TPU package keep their defaults."""
    from domain_transfer_gan_torch.config import TrainOptions
    cfg = TrainOptions().parse(args=[
        "--dataroot", "d", "--name", "n", "--checkpoints_dir", str(tmp_path),
        "--host_devices", "8", "--data_axis", "batch", "--use_pallas", "1"])
    assert cfg.host_devices == 8 and cfg.data_axis == "batch"
    assert cfg.use_pallas is True and cfg.device == "cuda"
    assert json.load(open(os.path.join(cfg.expr_dir, "opt.json")))[
        "use_pallas"] is True


@pytest.mark.parametrize("use_pallas", ["0", "1"])
def test_use_pallas_selects_nothing(tmp_path, monkeypatch, use_pallas):
    """--use_pallas is accepted and inert: the CLI's train steps, eval and
    visuals, and the UBO on the model it returns, call the kernel wrapper
    at every norm and never the plain twin, whatever the flag says."""
    from domain_transfer_gan_torch.eval.metrics import variational_ubo
    from domain_transfer_gan_torch.nn import norms

    fused = norms.instance_norm_fused
    calls = []

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return fused(*a, **kw)

    def refused(*a, **kw):
        raise AssertionError("the plain twin ran on the CLI's path")

    monkeypatch.setattr(norms, "instance_norm_fused", counted)
    monkeypatch.setattr(norms, "instance_norm_plain", refused)
    root = str(tmp_path / "ds")
    write_synthetic_dataset(root, n_train=10, n_test=2, size=64)
    model = train_model(argv=_argv(
        root, str(tmp_path / "ckpt"), "p", 0,
        ["--use_pallas", use_pallas, "--niter_decay", "0", "--batchSize",
         "2", "--display_freq", "4", "--dev_size", "2"]))
    n_cli = len(calls)
    A, B = images(1, 2), images(2, 2)
    variational_ubo(model, A, B, 1)
    assert n_cli > 0 and len(calls) > n_cli


@pytest.mark.slow
def test_whole_contract_with_the_ubo(tmp_path_factory):
    """The same run with eval_B every epoch: best_B, best_bpp_B.txt,
    history_ubo_B.npy and the pred_B grids too (~4 min on one CPU thread)."""
    r = _train_resume(tmp_path_factory, eval_B_freq=1)
    _check_contract(r, with_B=True)
    with open(os.path.join(r["expr"], "results.txt")) as f:
        assert f.read().count("DEV_BPP_B") == 3
