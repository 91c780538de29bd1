"""The training CLI's mesh flags (``--spatial``, ``--tensor``,
``--pipeline``, ``--microbatches``) over two gloo ranks on the CPU: one
epoch each, the JAX CLI's ``SPMD over N devices (data x space x model x
pipe ...)`` line, both ranks' losses equal, and the run's ``latest`` loaded
whole by one process; ``--microbatches`` without ``--pipeline`` refused
with the JAX message.  (These replace the four refusal cases the port had
for them before it ran them.)"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from domain_transfer_gan_torch.config import load_train_config_from_expr_dir
from domain_transfer_gan_torch.data.synthetic import write_synthetic_dataset
from domain_transfer_gan_torch.models import create_model

from test_torch_port_parallel import (ONE_THREAD, RANK_TIMEOUT, ROOT, _argv,
                                      _losses, _run_cli)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_cli_data"))
    write_synthetic_dataset(root, n_train=12, n_test=4, size=64)
    return root


FLAGS = [
    ("pipeline", ["--pipeline", "2", "--n_blocks", "4"], "1x1x1x2"),
    ("microbatches", ["--pipeline", "2", "--n_blocks", "4",
                      "--microbatches", "4", "--batchSize", "8"], "1x1x1x2"),
    ("spatial", ["--spatial", "2"], "1x2x1x1"),
    ("tensor", ["--tensor", "2"], "1x1x2x1"),
]


@pytest.mark.parametrize("name,flags,mesh", FLAGS, ids=[f[0] for f in FLAGS])
def test_the_flag_trains_an_epoch_over_two_ranks(dataset, tmp_path, name,
                                                 flags, mesh):
    ckpt = str(tmp_path / "ck")
    _run_cli(_argv(dataset, ckpt, name, extra=["--num_devices", "2",
                                                *flags]))
    expr = os.path.join(ckpt, name)
    with open(os.path.join(expr, "results.txt")) as f:
        log = f.read()
    assert ("SPMD over 2 devices (data x space x model x pipe %s)" % mesh
            in log)
    mine, theirs = (_losses(os.path.join(d, "results.txt"))
                    for d in (expr, os.path.join(expr, ".worker1")))
    assert mine and mine == theirs
    # one process loads the run's latest whole
    opt = load_train_config_from_expr_dir(expr)
    one = create_model(opt, testing=True, device="cpu")
    one.load(os.path.join(expr, "latest"))
    assert all(np.isfinite(p.detach().numpy()).all()
               for net in one.nets.values() for p in net.parameters())


def test_microbatches_without_pipeline_is_the_jax_error(dataset, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD)
    argv = _argv(dataset, str(tmp_path / "ck"), "mb",
                 extra=["--num_devices", "2", "--microbatches", "2"])
    p = subprocess.Popen(
        [sys.executable, "-m", "domain_transfer_gan_torch.cli.train", *argv],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        out = p.communicate(timeout=RANK_TIMEOUT)[0]
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    assert p.returncode != 0
    assert "ValueError: --microbatches only applies to pipeline " \
        "parallelism; set --pipeline >= 2" in out


@pytest.mark.slow
def test_chip_smoke_phase12_runs_on_the_cpu(tmp_path, monkeypatch):
    """Phase 12's steps and CLI runs at tiny width on the CPU (~2 min):
    the pipeline at M = 2 and 4, the space and model axes over two ranks
    against one process, the two-process CLI epochs and their scoring."""
    import torch

    from domain_transfer_gan_torch.ops.kernels import instance_norm as K

    from torch_port_helpers import load_chip_smoke

    cs = load_chip_smoke()
    data = dict(n_train=420, n_test=50, dev_size=100)
    monkeypatch.setattr(cs, "CLI_DATA", data)
    for k, v in ONE_THREAD.items():
        monkeypatch.setenv(k, v)
    tiny = dict(ngf=4, nef=4, ndf=4, n_blocks=3, nlatent=8)
    tmp = str(tmp_path)
    write_synthetic_dataset(tmp + "/cli_data", n_train=data["n_train"],
                            n_test=data["n_test"], size=64)
    _, _, _, _, fig = cs.drive_phase12(torch, K, tmp, "cpu", device="cpu",
                                       width=tiny)
    assert set(fig["steps"]) == {j[0] for j in cs.P12_JOBS}
    assert all(v["test_mse_A_vs_one_process"] <= 1e-6
               for v in fig["cli"].values())
