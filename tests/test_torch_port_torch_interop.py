"""Upstream-checkpoint interop of the port (``utils/torch_interop.py``,
``cli/import_torch.py``).

The oracle is ``tests/torch_reference_fixture.py``: torch modules with the
upstream's state-dict names and forward math, whose checkpoint is the one
upstream's ``model.save`` writes.  The port's import is held against the
JAX package's import of the same file (through ``utils/convert.py``: every
parameter, running statistic, Adam moment and count equal), against the
fixture's forwards, and through export -> import and
``cli.import_torch`` -> ``cli.train --continue_train``."""

import dataclasses
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from domain_transfer_gan_tpu.config import TrainConfig as JaxConfig
from domain_transfer_gan_tpu.models.state import init_state as jax_init
from domain_transfer_gan_tpu.utils.torch_interop import \
    import_torch_checkpoint as jax_import

from domain_transfer_gan_torch.cli.import_torch import main as import_main
from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.models import create_model
from domain_transfer_gan_torch.utils.convert import \
    jax_batch_stats_to_buffers, jax_params_to_state_dict
from domain_transfer_gan_torch.utils.torch_interop import (
    export_torch_checkpoint,
    import_torch_checkpoint,
)

from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)
from torch_reference_fixture import build_reference_nets, \
    reference_checkpoint

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ZDIM, WIDTH = 8, 4
ATOL = 1e-5


def _cfg(model="aug_cycle_gan", **kw):
    return TrainConfig(model=model, grid_size=64, ngf=WIDTH, ndf=WIDTH,
                       nef=WIDTH, nlatent=ZDIM, batchSize=4,
                       monitor_gnorm=False, seed=0, device="cpu", **kw)


def _write(tmp_path, aug=True, adam_steps=3, seed=11, name="upstream"):
    nets = build_reference_nets(zdim=ZDIM, ngf=WIDTH, ndf=WIDTH, nef=WIDTH,
                                seed=seed, aug=aug)
    ckpt = reference_checkpoint(nets, aug=aug, adam_steps=adam_steps)
    path = str(tmp_path / name)
    torch.save(ckpt, path)
    return nets, ckpt, path


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    nets, ckpt, path = _write(tmp_path_factory.mktemp("interop"))
    model = create_model(_cfg(), testing=True, device="cpu")
    report = import_torch_checkpoint(path, model)
    assert len(report) == 10 and all("imported" in r for r in report)
    return nets, ckpt, path, model


def _jax_import(path, model_name):
    """The JAX package's import of ``path`` into a zero state of the same
    architecture (its shapes from jax.eval_shape: a JAX init costs ~40 s
    here), as numpy trees."""
    jcfg = JaxConfig(model=model_name, grid_size=64, ngf=WIDTH, ndf=WIDTH,
                     nef=WIDTH, nlatent=ZDIM, batchSize=4,
                     monitor_gnorm=False, seed=0, use_pallas=False)
    shapes = jax.eval_shape(lambda k: jax_init(jcfg, k, image_size=64)[1],
                            jax.random.PRNGKey(0))
    state = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                   shapes)
    model = types.SimpleNamespace(opt=jcfg, state=state)
    jax_import(path, model)
    return jax.tree_util.tree_map(np.asarray, model.state)


@pytest.mark.parametrize("model_name", ["aug_cycle_gan", "stoch_cycle_gan"])
def test_import_equals_the_converted_jax_import(tmp_path, model_name):
    aug = model_name == "aug_cycle_gan"
    _, _, path = _write(tmp_path, aug=aug, seed=21)
    model = create_model(_cfg(model_name), testing=True, device="cpu")
    import_torch_checkpoint(path, model)
    jstate = _jax_import(path, model_name)
    assert set(jstate.params) == set(model.nets)
    for name, net in model.nets.items():
        want = jax_params_to_state_dict(name, jstate.params[name])
        want.update(jax_batch_stats_to_buffers(
            name, jstate.batch_stats.get(name, {})))
        mine = net.state_dict()
        assert set(mine) == set(want), name
        for k, v in mine.items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0,
                                       msg="%s.%s" % (name, k))
        adam, jadam = model.state.opt_state[name], jstate.opt_state[name]
        assert adam.count == int(jadam.count) == 3
        for mine_m, tree in ((adam.mu, jadam.mu), (adam.nu, jadam.nu)):
            want_m = jax_params_to_state_dict(name, tree)
            for (k, _), m in zip(net.named_parameters(), mine_m):
                torch.testing.assert_close(m, want_m[k], rtol=0, atol=0)


def _nchw(x):
    return np.transpose(x, (0, 2, 3, 1))


def test_generators_forward_as_the_fixture(imported):
    nets, _, _, model = imported
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    z = rng.randn(2, ZDIM).astype(np.float32)
    with torch.no_grad():
        ref_B = nets["netG_A_B"](torch.from_numpy(x),
                                 torch.from_numpy(z[:, :, None, None]))
        ref_A = nets["netG_B_A"](torch.from_numpy(x))
    np.testing.assert_allclose(model.predict_B(_nchw(x), z).numpy(),
                               _nchw(ref_B.numpy()), rtol=0, atol=ATOL)
    np.testing.assert_allclose(model.predict_A(_nchw(x)).numpy(),
                               _nchw(ref_A.numpy()), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["netD_A", "netD_B"])
def test_discriminators_forward_as_the_fixture(imported, name):
    nets, _, _, model = imported
    x = np.random.RandomState(2).uniform(-1, 1, (2, 3, 64, 64)) \
        .astype(np.float32)
    with torch.no_grad():
        ref = nets[name](torch.from_numpy(x)).numpy()
        got = model.nets[name](torch.from_numpy(_nchw(x))).numpy()
    np.testing.assert_allclose(got[..., 0], ref[:, 0], rtol=0, atol=ATOL)


def test_encoder_and_latent_d_use_the_imported_running_statistics(imported):
    nets, _, _, model = imported
    rng = np.random.RandomState(3)
    ab = rng.uniform(-1, 1, (4, 6, 64, 64)).astype(np.float32)
    z = rng.randn(4, ZDIM).astype(np.float32)
    for n in ("netE_B", "netD_z_B"):
        nets[n].eval()
        model.nets[n].eval()
    try:
        with torch.no_grad():
            mu_t, lv_t = nets["netE_B"](torch.from_numpy(ab))
            dz_t = nets["netD_z_B"](torch.from_numpy(z))
            mu, lv = model.nets["netE_B"](torch.from_numpy(_nchw(ab)))
            dz = model.nets["netD_z_B"](torch.from_numpy(z))
    finally:
        for n in ("netE_B", "netD_z_B"):
            nets[n].train()
            model.nets[n].train()
    for got, want in ((mu, mu_t), (lv, lv_t), (dz, dz_t)):
        np.testing.assert_allclose(got.reshape(want.shape).numpy(),
                                   want.numpy(), rtol=0, atol=ATOL)


def test_adam_moments_and_counts(imported):
    nets, ckpt, _, model = imported
    # optimizer_G_A is netG_B_A alone: its entry 0 is conv0.weight
    st = ckpt["optimizer_G_A"]["state"]
    first = st[min(st)]
    adam = model.state.opt_state["netG_B_A"]
    assert adam.count == int(first["step"]) == 3
    torch.testing.assert_close(adam.mu[0], first["exp_avg"], rtol=0, atol=0)
    torch.testing.assert_close(adam.nu[0], first["exp_avg_sq"], rtol=0,
                               atol=0)
    # optimizer_G_B is netG_A_B then netE_B: netE_B's first entry follows
    # all of netG_A_B's, and a CIN's 1x1 conv moments lose their 1x1
    n_gab = len(list(model.nets["netG_A_B"].parameters()))
    st = ckpt["optimizer_G_B"]["state"]
    torch.testing.assert_close(model.state.opt_state["netE_B"].mu[0],
                               st[sorted(st)[n_gab]]["exp_avg"], rtol=0,
                               atol=0)
    names = [k for k, _ in model.nets["netG_A_B"].named_parameters()]
    k = names.index("cin0.shift_conv.weight")
    torch.testing.assert_close(model.state.opt_state["netG_A_B"].nu[k],
                               st[sorted(st)[k]]["exp_avg_sq"][:, :, 0, 0],
                               rtol=0, atol=0)


def test_never_stepped_parameters_get_zero_moments(tmp_path):
    _, ckpt, path = _write(tmp_path, adam_steps=0)
    model = create_model(_cfg(), testing=True, device="cpu")
    for s in model.state.opt_state.values():
        for m in s.mu:
            m.fill_(1.0)
    import_torch_checkpoint(path, model)
    for s in model.state.opt_state.values():
        assert s.count == 0
        assert all(float(m.abs().max()) == 0.0 for m in s.mu + s.nu)


def test_export_is_upstream_loadable_with_alias_keys(imported, tmp_path):
    nets, _, _, model = imported
    out = str(tmp_path / "export.pt")
    report = export_torch_checkpoint(model, out)
    assert len(report) == 10
    ex = torch.load(out, weights_only=False)
    for name, net in nets.items():
        missing, unexpected = net.load_state_dict(ex[name], strict=False)
        assert not unexpected, (name, unexpected)
        assert all("num_batches_tracked" in k for k in missing), missing
    assert "model.10.1.module1.weight" in ex["netG_A_B"]
    torch.testing.assert_close(ex["netG_A_B"]["model.10.1.module1.weight"],
                               ex["netG_A_B"]["model.10.conv_block.1."
                                              "module1.weight"])
    for k in ("optimizer_G_A", "optimizer_G_B", "optimizer_D_A",
              "optimizer_D_B"):
        group = ex[k]["param_groups"][0]
        assert group["params"] == sorted(ex[k]["state"])
        assert group["lr"] == pytest.approx(
            model.old_lr_d if "D" in k else model.old_lr)


def test_export_then_import_reproduces_every_tensor(imported, tmp_path):
    _, _, _, model = imported
    out = str(tmp_path / "roundtrip.pt")
    export_torch_checkpoint(model, out)
    other = create_model(_cfg(), testing=True, device="cpu")
    import_torch_checkpoint(out, other)
    for name, net in model.nets.items():
        for k, v in net.state_dict().items():
            torch.testing.assert_close(other.nets[name].state_dict()[k], v,
                                       rtol=0, atol=0)
        a, b = model.state.opt_state[name], other.state.opt_state[name]
        assert a.count == b.count
        for x, y in zip(a.mu + a.nu, b.mu + b.nu):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_ema_shadows_start_at_the_imported_weights(imported):
    _, _, path, _ = imported
    model = create_model(_cfg(ema=0.999), testing=True, device="cpu")
    import_torch_checkpoint(path, model, import_optimizers=False)
    assert set(model.state.ema) == {"netG_A_B", "netG_B_A", "netE_B"}
    for name, shadow in model.state.ema.items():
        for s, p in zip(shadow, model.nets[name].parameters()):
            torch.testing.assert_close(s, p.detach(), rtol=0, atol=0)
    assert all(s.count == 0 for s in model.state.opt_state.values())


def test_a_wrong_architecture_is_named(imported, tmp_path):
    _, _, path, _ = imported
    wide = create_model(TrainConfig(model="aug_cycle_gan", ngf=8, ndf=WIDTH,
                                    nef=WIDTH, nlatent=ZDIM, device="cpu"),
                        testing=True, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch importing "
                       "model.1.weight -> netG_A_B.conv0.weight"):
        import_torch_checkpoint(path, wide)
    deep = create_model(_cfg(n_blocks=4), testing=True, device="cpu")
    with pytest.raises(ValueError, match="--n_blocks 4"):
        import_torch_checkpoint(path, deep)


def test_an_id_keyed_optimizer_state_is_skipped(imported, tmp_path):
    _, ckpt, _, _ = imported
    old = dict(ckpt)
    old["optimizer_D_A"] = {"state": {}, "param_groups": [{"params": [1]}]}
    del old["optimizer_G_A"]
    path = str(tmp_path / "old")
    torch.save(old, path)
    model = create_model(_cfg(), testing=True, device="cpu")
    report = import_torch_checkpoint(path, model)
    assert "skipped optimizer_G_A: not in checkpoint" in report
    assert any(r.startswith("skipped optimizer_D_A: 1 state entries")
               for r in report)


def _write_opt(expr):
    os.makedirs(expr, exist_ok=True)
    with open(os.path.join(expr, "opt.json"), "w") as f:
        json.dump(dataclasses.asdict(_cfg()), f)


def test_import_cli_then_export_cli(imported, tmp_path):
    nets, ckpt, path, model = imported
    expr = str(tmp_path / "upstream_run")
    _write_opt(expr)
    torch.save(ckpt, os.path.join(expr, "latest"))
    out = str(tmp_path / "port_run" / "latest")
    assert import_main(["--torch_chk", os.path.join(expr, "latest"),
                        "--out", out, "--device", "cpu"]) == 0
    assert os.path.exists(os.path.join(os.path.dirname(out), "opt.json"))
    loaded = create_model(_cfg(), testing=True, device="cpu")
    loaded.load(out)
    assert loaded.epoch == 0
    for name, net in model.nets.items():
        for k, v in net.state_dict().items():
            torch.testing.assert_close(loaded.nets[name].state_dict()[k], v,
                                       rtol=0, atol=0)
    back = str(tmp_path / "back.pt")
    assert import_main(["--export", "--chk", out, "--torch_out", back,
                        "--device", "cpu"]) == 0
    ex = torch.load(back, weights_only=False)
    torch.testing.assert_close(ex["netG_A_B"]["model.1.weight"],
                               ckpt["netG_A_B"]["model.1.weight"], rtol=0,
                               atol=0)


def test_the_import_cli_asks_for_the_card_by_default(imported, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, _, path, _ = imported
    expr = str(tmp_path / "upstream_run")
    _write_opt(expr)
    with pytest.raises(RuntimeError, match="asks for CUDA"):
        import_main(["--torch_chk", path, "--opt", expr, "--out",
                     str(tmp_path / "o" / "latest")])
