"""The port's root entry points (``__graft_entry_torch__.py``) and console
scripts on the CPU: ``entry()`` against the JAX package's
``__graft_entry__.entry()`` on the same weights and inputs,
``dryrun_multichip`` over two gloo ranks, the ``dp_sp_tp`` mesh job's
layout (and, ``-m slow``, the job over 8 ranks against one process), and
every ``dtgan-torch-*`` script of ``pyproject.toml`` resolving to a
callable of the port."""

import importlib
import os
import tomllib

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
import __graft_entry_torch__ as port_entry
from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.parallel import selfcheck
from domain_transfer_gan_torch.parallel.mesh import Mesh, check_spatial
from domain_transfer_gan_torch.utils.convert import jax_params_to_state_dict
from domain_transfer_gan_tpu.models import state as jax_state

from torch_port_mesh_runs import hold_job, run_group

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {
    "dtgan-torch-train": "domain_transfer_gan_torch.cli.train:train_model",
    "dtgan-torch-test": "domain_transfer_gan_torch.cli.test:test_model",
    "dtgan-torch-export": "domain_transfer_gan_torch.cli.export:main",
    "dtgan-torch-serve": "domain_transfer_gan_torch.cli.serve:main",
    "dtgan-torch-import-torch":
        "domain_transfer_gan_torch.cli.import_torch:main",
    "dtgan-torch-export-jax": "domain_transfer_gan_torch.cli.export_jax:main",
    "dtgan-torch-prep-livneh":
        "domain_transfer_gan_torch.data.prep_livneh:main",
    "dtgan-torch-selfcheck":
        "domain_transfer_gan_torch.parallel.selfcheck:main",
}
ENTRY_ATOL = 1e-4  # the JAX norm's E[x^2] - mean^2 variance (ROADMAP)


def _inputs(x, z):
    rng = np.random.RandomState(5)
    return (rng.uniform(-1, 1, tuple(x.shape)).astype(np.float32),
            rng.randn(*z.shape).astype(np.float32))


def _hold(fn, params, jparams, want, xs, zs):
    """The port's ``fn`` on the JAX weights (``jax_params_to_state_dict``)
    against the JAX forward's ``want``."""
    carried = jax_params_to_state_dict("netG_A_B", jparams)
    assert set(carried) == set(params)
    for k, v in carried.items():
        assert v.shape == params[k].shape, k
    with torch.no_grad():
        got = fn(carried, torch.from_numpy(xs), torch.from_numpy(zs))
    assert got.shape == want.shape
    assert float(np.abs(want).std()) > 1e-3  # not a vacuous comparison
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ENTRY_ATOL)


def test_entry_is_the_jax_generator_on_the_same_weights_and_inputs():
    """``entry()``'s ``fn`` against the JAX package's ``netG_A_B`` of
    ``__graft_entry__``'s tiny config (initialised and applied in one jit),
    x and z drawn from a numpy seed; its own example args on the CPU."""
    fn, (params, x, z) = port_entry.entry(device="cpu")
    assert tuple(x.shape) == (8, 64, 64, 3) and x.dtype == torch.float32
    assert tuple(z.shape) == (8, 16) and x.device.type == "cpu"
    net = jax_state.build_networks(jax_entry._tiny_cfg())["netG_A_B"]
    xs, zs = _inputs(x, z)

    def init_and_apply(key, x, z):
        p = net.init({"params": key}, x[:2], z[:2], False)["params"]
        return p, net.apply({"params": p}, x, z, False)

    jparams, want = jax.jit(init_and_apply)(jax.random.PRNGKey(0), xs, zs)
    _hold(fn, params, jparams, np.asarray(want), xs, zs)
    # its own example args run, and the plain norms are the same function
    with torch.no_grad():
        y, yp = fn(params, x, z), fn(params, x, z, plain_norm=True)
    assert torch.isfinite(y).all() and float((y - yp).abs().max()) <= 1e-5


@pytest.mark.slow
def test_entry_is_the_jax_entry_on_the_same_weights_and_inputs():
    """The same against ``__graft_entry__.entry()`` itself, whose
    ``init_state`` initialises all six networks (30-60 s here)."""
    jfn, (jparams, jx, jz) = jax_entry.entry()
    fn, (params, x, z) = port_entry.entry(device="cpu")
    assert tuple(x.shape) == tuple(jx.shape)
    assert tuple(z.shape) == tuple(jz.shape)
    xs, zs = _inputs(x, z)
    _hold(fn, params, jparams, np.asarray(jfn(jparams, xs, zs)), xs, zs)


def test_the_entry_points_ask_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun_multichip(2)


def test_dryrun_multichip_over_two_cpu_ranks(monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # read by the spawned ranks
    losses = port_entry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "2 ranks over gloo on cpu, 0 CUDA card(s)" in out
    assert "dryrun_multichip(2) OK: D_A=" in out
    assert set(losses) == {"aug", "sup"}  # no mesh at n = 2
    assert np.isfinite(list(losses["aug"].values())).all()


@pytest.mark.parametrize("name,target", sorted(SCRIPTS.items()))
def test_every_port_script_resolves_to_a_callable_of_the_port(name, target):
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts[name] == target
    module, attr = target.split(":")
    assert module.startswith("domain_transfer_gan_torch.")
    assert callable(getattr(importlib.import_module(module), attr))


def test_the_port_scripts_are_all_listed_and_the_jax_ones_kept():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert {k for k in scripts if k.startswith("dtgan-torch-")} == set(SCRIPTS)
    jax_scripts = {k: v for k, v in scripts.items() if k not in SCRIPTS}
    assert len(jax_scripts) == 6 and all(
        v.startswith("domain_transfer_gan_tpu.") for v in jax_scripts.values())


def test_the_three_axis_job_lays_out_its_mesh_and_splits_its_batch():
    """``dp_sp_tp`` over its 8 ranks is ``data x space x model`` = 2x2x2:
    every rank holds 4 of the batch's 8 samples (its data slice) and half of
    each image's rows, and no two ranks hold the same (data, space, model)
    part."""
    flags, batch, steps, kind, world = selfcheck.MESH_JOBS["dp_sp_tp"]
    assert (flags, batch, kind, world) == ({"spatial": 2, "tensor": 2}, 8,
                                          "main", 8)
    cfg = selfcheck.job_config("dp_sp_tp")
    check_spatial(cfg, cfg.spatial)
    seen = set()
    for rank in range(world):
        m = Mesh(cfg.spatial, cfg.tensor, cfg.pipeline, world=world,
                 rank=rank, groups=False)
        assert dict(m.sizes) == {"data": 2, "space": 2, "model": 2,
                                 "pipe": 1}
        assert batch % m.batch_shards == 0 and batch // m.batch_shards == 4
        assert cfg.grid_size % m.space.size == 0
        seen.add((m.batch.index, m.space.index, m.model.index))
    assert len(seen) == world


@pytest.mark.slow
def test_the_three_axis_job_over_8_ranks_matches_one_process():
    """The ``dp_sp_tp`` job over 8 gloo ranks against one process at the
    CPU limits (``torch_port_mesh_runs.hold_job``); ~1 min."""
    runs, _ = run_group(["dp_sp_tp"], 8)
    single, ranks = runs["dp_sp_tp"]
    assert len(ranks) == 8
    hold_job(single, ranks)
    assert all(r["split_norms"] > 0 for r in ranks)


def test_the_entry_config_is_the_jax_tiny_config():
    jcfg = jax_entry._tiny_cfg()
    cfg = TrainConfig(**port_entry.ENTRY_CFG)
    for k in port_entry.ENTRY_CFG:
        assert getattr(cfg, k) == getattr(jcfg, k), k
