"""The training CLI on the other two variants and the supervised step, and
the evaluation CLI (``python -m domain_transfer_gan_torch.cli.test``) end to
end on the CPU (--device cpu, tiny nets): one epoch each of
``stoch_cycle_gan``, ``cycle_gan`` and ``aug_cycle_gan --supervised``, then
every ``--metric`` on each checkpoint, with the JAX CLI's printed lines and
files.  ``--metric bpp`` runs 500 UBO steps per test batch of 200 (~4 min
on one CPU thread): it runs under ``-m slow``, and its cheap sibling runs
the same code with 1 step."""

import json
import os
import re
import struct

import numpy as np
import pytest

from domain_transfer_gan_torch.cli import test as test_cli
from domain_transfer_gan_torch.cli.export import load_exported
from domain_transfer_gan_torch.cli.export import main as export_main
from domain_transfer_gan_torch.cli.train import train_model
from domain_transfer_gan_torch.config import load_train_config_from_expr_dir
from domain_transfer_gan_torch.data import AlignedIterator, load_numpy_data
from domain_transfer_gan_torch.data.synthetic import write_synthetic_dataset
from domain_transfer_gan_torch.eval import eval_mse_A
from domain_transfer_gan_torch.models import create_model
from domain_transfer_gan_torch.utils import jax_export

from torch_port_helpers import (  # noqa: F401 (a fixture)
    images,
    latents,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RUNS = {"stoch": ["--model", "stoch_cycle_gan"],
        "cycle": ["--model", "cycle_gan"],
        "sup": ["--supervised", "--sup_frac", "0.5"]}
SUP_KEYS = ["S_A", "S_B", "KLD_z_B", "D_z_B", "gnorm_G_A_B", "gnorm_G_B_A",
            "gnorm_E_B", "gnorm_D_z_B"]
VISUAL = ["cycle_0.png", "multi_0.png", "cycle_B_multi_0.png",
          "multi_cycle_0.png"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One epoch of each run (16 train images at batch 4, print every 2
    steps, one display, eval_A; eval_B off: the UBO pads to 100 images),
    on one synthetic set."""
    root = str(tmp_path_factory.mktemp("ds"))
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    write_synthetic_dataset(root, n_train=24, n_test=6, size=64)
    out = {"root": root}
    for name, flags in RUNS.items():
        argv = ["--dataroot", root, "--name", name, "--checkpoints_dir",
                ckpt, "--grid_size", "64", "--batchSize", "4", "--ngf", "4",
                "--nef", "4", "--ndf", "4", "--nlatent", "8", "--niter", "1",
                "--niter_decay", "0", "--print_freq", "8", "--display_freq",
                "16", "--save_epoch_freq", "1", "--eval_B_freq", "0",
                "--seed", "3", "--dev_size", "8", "--device", "cpu",
                "--init_scheme", "sane", "--check_numerics", "1", *flags]
        model = train_model(argv=argv)
        expr = os.path.join(ckpt, name)
        with open(os.path.join(expr, "results.txt")) as f:
            log = f.read()
        out[name] = {"model": model, "expr": expr, "log": log,
                     "latest": os.path.join(expr, "latest")}
    return out


def test_the_other_variants_and_the_supervised_step_train(runs):
    """Loss lines with each variant's keys (the supervised losses on a line
    of their own under the main ones), a checkpoint of each, and no
    posterior-z grid (vis_inf) for the variants without an encoder."""
    for name, want in (("stoch", "StochCycleGAN"), ("cycle", "StochCycleGAN"),
                       ("sup", "AugmentedCycleGAN")):
        r = runs[name]
        assert type(r["model"]).__name__ == want
        assert "model [%s] was created" % want in r["log"]
        lines = r["log"].splitlines()
        loss = [i for i, ln in enumerate(lines) if ln.startswith("(epoch:")]
        assert len(loss) == 2, name
        keys = re.findall(r"(\w+): -?\d+\.\d{3} ", lines[loss[0]])
        assert len(keys) == (13 if name == "sup" else 10), keys
        assert os.path.exists(r["latest"])
        has_inf = os.path.isdir(os.path.join(r["expr"], "vis_inf"))
        assert has_inf == (name == "sup")
        assert not os.path.exists(os.path.join(r["expr"], "vis_latest",
                                               "inf.png")) or name == "sup"
    sup_lines = runs["sup"]["log"].splitlines()
    i = next(i for i, ln in enumerate(sup_lines) if ln.startswith("(epoch:"))
    assert [k for k in re.findall(r"(\w+): -?\d+\.\d{3} ",
                                  sup_lines[i + 1])] == SUP_KEYS
    assert "#supervised images = 8" in runs["sup"]["log"]
    # 4 unsupervised steps; the supervised ones count no step
    assert runs["sup"]["model"].state.step == 4
    assert runs["sup"]["model"].state.opt_state["netE_B"].count == 8


def _test(runs, name, metric, *extra):
    return test_cli.test_model(["--chk_path", runs[name]["latest"],
                                "--dataroot", runs["root"], "--metric",
                                metric, "--device", "cpu", *extra])


def _res(runs, name, f):
    return os.path.join(runs[name]["expr"], "test_res", f)


@pytest.mark.parametrize("name", list(RUNS))
@pytest.mark.parametrize("metric", ["mse", "visual", "noise_sens",
                                    "mvgauss", "fid", "z_div"])
def test_every_metric_on_every_variant(runs, name, metric, capsys):
    out = _test(runs, name, metric)
    printed = capsys.readouterr().out
    assert "#test images = 6" in printed
    if metric == "mse":
        assert re.search(r"DEV_MSE_A: \d+\.\d{4}, TEST_MSE_A: \d+\.\d{4}",
                         printed)
        assert set(out) == {"DEV_MSE_A", "TEST_MSE_A"}
    elif metric == "visual":
        for f in VISUAL + ["inf_0.png"] * (name == "sup"):
            assert os.path.getsize(_res(runs, name, f)) > 0, f
        assert os.path.exists(_res(runs, name, "inf_0.png")) == \
            (name == "sup")
    elif metric == "noise_sens":
        res = np.load(_res(runs, name, "noise_sens.npy"))
        assert res.shape == (8, 6) and np.isfinite(res).all()
        assert not np.array_equal(res[0], res[-1])  # the noise reaches B
    elif metric == "mvgauss":
        assert re.search(r"MVGauss BPP: \d+\.\d{4}", printed)
        with open(_res(runs, name, "mvgauss_bpp.txt")) as f:
            assert float(f.read()) == pytest.approx(out["MVGAUSS_BPP_B"],
                                                    abs=1e-6)
    elif metric == "fid":
        assert re.search(r"PROXY_FID_B: \d+\.\d{4}", printed)
        with open(_res(runs, name, "fid.txt")) as f:
            assert float(f.read()) == pytest.approx(out["PROXY_FID_B"],
                                                    abs=1e-6)
        assert out["PROXY_FID_B"] > 0
    else:
        assert re.search(r"Z_DIV_RATIO: \S+ \(intra \S+ / inter \S+\)",
                         printed)
        with open(_res(runs, name, "z_diversity.json")) as f:
            div = json.load(f)
        assert set(div) == {"intra_z", "inter_input", "ratio"}
        # cycle_gan ignores z: its samples do not differ at all
        assert (div["intra_z"] == 0.0) == (name == "cycle")


def test_mse_is_eval_mse_A_on_batches_of_200(runs):
    """TEST_MSE_A is ``eval_mse_A`` of the checkpoint over the test set in
    batches of 200 (the training CLI's value comes from batches of 100)."""
    out = _test(runs, "sup", "mse")
    opt = load_train_config_from_expr_dir(runs["sup"]["expr"])
    model = create_model(opt, testing=True, device="cpu")
    model.load(runs["sup"]["latest"])
    *_, testA, testB = load_numpy_data(runs["root"], grid_size=64,
                                       dev_size=8)
    assert out["TEST_MSE_A"] == eval_mse_A(
        AlignedIterator(testA, testB, batch_size=200), model)


def test_bpp_with_a_one_step_ubo(runs, monkeypatch, capsys):
    """The bpp branch through the same code with 1 UBO step instead of 500:
    logvar_B fitted on the train subset (one batch), the verbose UBO line
    with L1, the prediction grid, TEST_BPP_B."""
    monkeypatch.setattr(test_cli, "BPP_UBO_STEPS", 1)
    out = _test(runs, "sup", "bpp")
    printed = capsys.readouterr().out
    assert re.search(r"^UBO: \S+, KLD: \S+, BPP: \S+$", printed, re.M)
    assert re.search(r"^\[1\] UBO: \S+, KLD: \S+, BPP: \S+, L1: \S+$",
                     printed, re.M)
    assert re.search(r"TEST_BPP_B: \d+\.\d{4}, TIME: ", printed)
    assert np.isfinite(out["TEST_BPP_B"]) and out["TEST_BPP_B"] > 0
    assert os.path.getsize(_res(runs, "sup", "test_pred_B_0.png")) > 0


@pytest.mark.slow
@pytest.mark.parametrize("name", ["sup", "stoch", "cycle"])
def test_bpp_with_500_steps(runs, name, capsys):
    out = _test(runs, name, "bpp")
    printed = capsys.readouterr().out
    assert len(re.findall(r"^\[\d+\] UBO: ", printed, re.M)) == 5
    assert np.isfinite(out["TEST_BPP_B"])
    for tag in ("0", "100", "500"):
        assert os.path.exists(_res(runs, name, "test_pred_B_%s.png" % tag))


@pytest.mark.parametrize("name", ["stoch", "cycle"])
def test_export_from_a_checkpoint_of_the_other_variants(runs, name,
                                                       tmp_path):
    out = str(tmp_path / "export")
    export_main(["--chk_path", runs[name]["latest"], "--out", out,
                 "--batch", "2", "--device", "cpu"])
    model = runs[name]["model"]
    A, z = images(1, 2), latents(2, 2, 8)
    got = load_exported(out, "predict_B", "cpu")(
        model._tensor(A), model._tensor(z))
    np.testing.assert_allclose(got.numpy(), model.predict_B(A, z).numpy(),
                               rtol=0, atol=1e-5)
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f)["model"] == runs[name]["model"].opt.model


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "jax_export")
# --fid_extractor artifacts the port does not run, refused by name before
# anything is read or written (tests/fixtures/make_jax_export_fixtures.py);
# cpu_tpu.jaxexp, which runs its first platform's lowering, with its
# platforms emptied (_without_platforms)
REFUSED = [
    ("custom_call_tpu.jaxexp", "custom_call to 'tpu_custom_call_fixture'"),
    ("cpu_tpu.jaxexp", "platforms = []: no platform"),
    ("sine_tpu.jaxexp", "stablehlo.sine"),
    ("two_devices.jaxexp", "nr_devices = 2"),
]


def _without_platforms(path, tmp_path):
    """A copy of the artifact at ``path`` whose platforms vector (slot 9 of
    the ``Exported`` table) holds none."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    root = jax_export._Table(bytes(data), struct.unpack_from("<I", data)[0])
    pos = root._ref(9)
    assert struct.unpack_from("<I", data, pos)[0] == 2
    struct.pack_into("<I", data, pos, 0)
    out = str(tmp_path / "no_platforms.jaxexp")
    with open(out, "wb") as f:
        f.write(bytes(data))
    return out


@pytest.mark.parametrize(
    "artifact,named", REFUSED,
    ids=["--fid_extractor"] + ["--fid_extractor-" + r[0].split(".")[0]
                               for r in REFUSED[1:]])
def test_unported_evaluations_are_refused_by_name(runs, artifact, named,
                                                  tmp_path):
    res = "refused_" + artifact.split(".")[0]
    path = os.path.join(FIXTURES, artifact)
    if artifact == "cpu_tpu.jaxexp":
        path = _without_platforms(path, tmp_path)
    with pytest.raises(ValueError) as e:
        test_cli.test_model(["--chk_path", runs["stoch"]["latest"],
                             "--dataroot", runs["root"], "--metric", "fid",
                             "--device", "cpu", "--res_dir", res,
                             "--fid_extractor", path])
    assert named in str(e.value)
    assert not os.path.exists(os.path.join(runs["stoch"]["expr"], res))


def test_fid_with_a_jax_export_extractor_prints_FID_B(runs, capsys):
    """--metric fid --fid_extractor: the JAX package's width-64 proxy net
    as a jax.export artifact, interpreted on the CPU; the same weights as
    the built-in extractor, so FID_B is PROXY_FID_B of the same images."""
    proxy = _test(runs, "sup", "fid")["PROXY_FID_B"]
    capsys.readouterr()
    out = _test(runs, "sup", "fid", "--fid_extractor",
                os.path.join(FIXTURES, "proxy_w64_64x64x3.jaxexp"))
    printed = capsys.readouterr().out
    assert re.search(r"^FID_B: \d+\.\d{4}$", printed, re.M)
    assert "PROXY_FID_B" not in printed
    assert abs(out["FID_B"] - proxy) <= 1e-4 * abs(proxy)
    with open(_res(runs, "sup", "fid.txt")) as f:
        assert float(f.read()) == pytest.approx(out["FID_B"], abs=1e-6)


def test_use_ema_without_a_shadow_is_refused(runs):
    """--use_ema 1 scores the EMA shadows; a run trained without --ema has
    none (the runs with them are in tests/test_torch_port_extras_cli.py)."""
    with pytest.raises(ValueError, match="--use_ema 1 needs a checkpoint "
                       "trained with --ema"):
        test_cli.test_model(["--chk_path", runs["stoch"]["latest"],
                             "--dataroot", runs["root"], "--metric", "mse",
                             "--device", "cpu", "--use_ema", "1"])
