"""The JAX package's checkpoints in the port (``utils/flax_msgpack.py``,
``utils/convert.py``'s inverse maps, ``models.api`` ``load`` / ``save_jax``,
``cli/export_jax.py``).

The oracle is flax itself and the JAX package's own ``save`` / ``load``
(called on a shell object that holds a numpy-filled state of the tiny
architecture, its shapes from ``jax.eval_shape``: a JAX init costs ~40 s
here).  A JAX checkpoint loads into the port with every tensor equal to its
converted value; a port checkpoint written by ``export_jax`` loads into the
JAX ``load`` with every leaf equal to the port's tensor moved back; the two
writers emit the same bytes."""

import dataclasses
import json
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from domain_transfer_gan_tpu.config import TrainConfig as JaxConfig
from domain_transfer_gan_tpu.models.api import _CycleGANBase as JaxBase
from domain_transfer_gan_tpu.models.state import init_state as jax_init

from domain_transfer_gan_torch.cli.export_jax import main as export_jax_main
from domain_transfer_gan_torch.config import TrainConfig, parse_opt_file
from domain_transfer_gan_torch.models import create_model
from domain_transfer_gan_torch.utils.convert import (
    buffers_to_jax_batch_stats,
    jax_batch_stats_to_buffers,
    jax_params_to_state_dict,
    state_dict_to_jax_params,
)
from domain_transfer_gan_torch.utils.flax_msgpack import (
    MsgpackMissingError,
    read_flax,
    write_flax,
)

from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)
from torch_port_helpers import TINY, images, latents, randomize

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cfg(tmp_path, **kw):
    flags = dict(TINY, seed=0, device="cpu", monitor_gnorm=False,
                 init_scheme="sane")
    flags.update(kw)
    cfg = TrainConfig(**flags)
    cfg.expr_dir = str(tmp_path)
    return cfg


def _jax_cfg(**kw):
    flags = dict(TINY, seed=0, monitor_gnorm=False, use_pallas=False)
    flags.update(kw)
    return JaxConfig(**flags)


class _JaxShell:
    """The JAX package's checkpoint methods on a state filled by numpy."""

    save = JaxBase.save
    load = JaxBase.load
    wait_for_saves = JaxBase.wait_for_saves
    _ckpt_payload = JaxBase._ckpt_payload
    _derive_lr_d = JaxBase._derive_lr_d

    def __init__(self, opt, state, old_lr=2e-4, epoch=1):
        self.opt, self.state = opt, state
        self.old_lr, self.epoch = old_lr, epoch
        self._derive_lr_d()


_SHAPES = {}


def _jax_state(jcfg, seed=None):
    """A JAX ``TrainState`` of ``jcfg``'s architecture: zeros, or with
    ``seed`` numpy draws everywhere (moments, counts, pools and shadows
    too)."""
    key = (jcfg.model, jcfg.pool_size, jcfg.ema > 0, jcfg.norm)
    if key not in _SHAPES:
        _SHAPES[key] = jax.eval_shape(
            lambda k: jax_init(jcfg, k, image_size=64)[1],
            jax.random.PRNGKey(0))
    state = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                   _SHAPES[key])
    if seed is None:
        return state
    rng = np.random.RandomState(seed)
    params = {k: randomize(v, seed + i)
              for i, (k, v) in enumerate(sorted(state.params.items()))}

    def draw(scale, positive=False):
        def f(a):
            v = scale * rng.randn(*a.shape)
            return (np.square(v) if positive else v).astype(a.dtype)
        return f

    opt = {k: type(v)(count=np.asarray(5 + i, np.int32),
                      mu=jax.tree_util.tree_map(draw(0.1), v.mu),
                      nu=jax.tree_util.tree_map(draw(0.1, True), v.nu))
           for i, (k, v) in enumerate(sorted(state.opt_state.items()))}
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.abs if p[-1].key == "var" else np.asarray)(
            rng.randn(*a.shape)).astype(np.float32), state.batch_stats)
    pools = {k: type(v)(buf=rng.uniform(-1, 1, v.buf.shape).astype(
        np.float32), n=np.asarray(2, np.int32))
        for k, v in state.pools.items()}
    ema = {k: jax.tree_util.tree_map(draw(0.5), v)
           for k, v in state.ema.items()}
    return state.replace(params=params, opt_state=opt, batch_stats=stats,
                         pools=pools, ema=ema,
                         step=np.asarray(7, np.int32))


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """A checkpoint the JAX package's ``save`` wrote, of a tiny
    ``aug_cycle_gan`` with pools and EMA, and the state it holds."""
    d = tmp_path_factory.mktemp("jax")
    jcfg = _jax_cfg(pool_size=3, ema=0.9)
    jcfg.expr_dir = str(d)
    shell = _JaxShell(jcfg, _jax_state(jcfg, seed=3), old_lr=1.5e-4,
                      epoch=4)
    shell.save("latest")
    return str(d / "latest"), shell


def _trained_port(tmp_path, steps=1, **kw):
    """A tiny port model after ``steps`` train steps (nonzero moments,
    counts, pools and shadows)."""
    model = create_model(_cfg(tmp_path, **kw), testing=True, device="cpu")
    for it in range(steps):
        model.train_instance(images(1, 4), images(2, 4), latents(3 + it, 4, 8))
    model.epoch = 2
    return model


def _assert_trees_equal(a, b, path=()):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, a, b)
        for k in b:
            _assert_trees_equal(a[k], b[k], path + (k,))
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=str(path))


# ---------------------------------------------------------------------------
# the format
# ---------------------------------------------------------------------------

def test_the_reader_decodes_what_flax_writes(jax_file):
    path, _ = jax_file
    with open(path, "rb") as f:
        data = f.read()
    mine = read_flax(data)
    _assert_trees_equal(mine, serialization.msgpack_restore(data))
    # the JAX save writes its numbers through jax.device_get: 0-d arrays
    assert np.asarray(mine["old_lr"]).dtype == np.float64
    assert np.asarray(mine["epoch"]).dtype == np.int64
    assert isinstance(read_flax(serialization.to_bytes(
        {"x": np.float64(0.5)}))["x"], np.float64)
    assert mine["opt_state"]["netG_A_B"]["count"].dtype == np.int32


def test_flax_reads_what_the_writer_writes_byte_for_byte(jax_file):
    path, _ = jax_file
    with open(path, "rb") as f:
        data = f.read()
    tree = read_flax(data)
    assert write_flax(tree) == data
    _assert_trees_equal(serialization.msgpack_restore(write_flax(tree)),
                        tree)


def test_chunked_arrays_and_fortran_order(monkeypatch):
    from domain_transfer_gan_torch.utils import flax_msgpack

    a = np.asfortranarray(np.arange(24, dtype=np.float32).reshape(4, 6))
    tree = {"a": a, "b": {"c": np.arange(5, dtype=np.int64)},
            "s": np.float64(0.5)}
    _assert_trees_equal(serialization.msgpack_restore(write_flax(tree)),
                        tree)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 16)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
    data = write_flax(tree)
    assert data == serialization.msgpack_serialize(
        {"a": np.ascontiguousarray(a), "b": {"c": tree["b"]["c"]},
         "s": np.float64(0.5)})
    _assert_trees_equal(read_flax(data), tree)


def test_complex_values_are_refused_by_name():
    data = serialization.msgpack_serialize({"z": 1 + 2j})
    with pytest.raises(ValueError, match="complex"):
        read_flax(data)
    with pytest.raises(ValueError, match="complex"):
        write_flax({"z": 1 + 2j})


def test_a_missing_msgpack_is_refused_by_name(monkeypatch, jax_file,
                                              tmp_path):
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(MsgpackMissingError, match="needs the msgpack module"):
        read_flax(b"\x80")
    with pytest.raises(MsgpackMissingError, match="msgpack"):
        write_flax({})
    model = create_model(_cfg(tmp_path, pool_size=3, ema=0.9), testing=True,
                         device="cpu")
    with pytest.raises(MsgpackMissingError, match="msgpack"):
        model.load(jax_file[0])


def test_a_file_that_is_neither_format_is_refused_by_name(tmp_path):
    model = create_model(_cfg(tmp_path), testing=True, device="cpu")
    bad = tmp_path / "bad"
    bad.write_bytes(b"not a checkpoint at all")
    with pytest.raises(ValueError, match="neither a checkpoint of this "
                                         "package"):
        model.load(str(bad))
    # a msgpack map that is no JAX checkpoint
    bad.write_bytes(serialization.msgpack_serialize({"x": np.zeros(2)}))
    with pytest.raises(ValueError, match="not a JAX package checkpoint"):
        model.load(str(bad))


# ---------------------------------------------------------------------------
# the layout maps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["netG_A_B", "netG_B_A", "netD_A", "netD_B",
                                  "netD_z_B", "netE_B"])
def test_the_inverse_maps_invert_the_forward_ones(tmp_path, name):
    model = _trained_port(tmp_path, steps=0)
    net = model.nets[name]
    params = dict(net.named_parameters())
    back = jax_params_to_state_dict(name,
                                    state_dict_to_jax_params(name, params))
    assert set(back) == set(params)
    for k, v in params.items():
        torch.testing.assert_close(back[k], v.detach(), rtol=0, atol=0)
    stats = buffers_to_jax_batch_stats(name, net.state_dict())
    bufs = jax_batch_stats_to_buffers(name, stats)
    assert set(bufs) == {k for k, _ in net.named_buffers()}


def test_up0_goes_back_flipped():
    """``up0``'s kernel is flipped in both spatial axes on the way in, so it
    must be flipped back: a transpose alone gives the right shape in the
    wrong order."""
    k = np.random.RandomState(0).randn(3, 3, 4, 2).astype(np.float32)
    sd = jax_params_to_state_dict("netG_A_B", {"up0": {"kernel": k}})
    back = state_dict_to_jax_params("netG_A_B", sd)["up0"]["kernel"]
    np.testing.assert_array_equal(back, k)
    assert not np.array_equal(np.transpose(sd["up0.weight"].numpy(),
                                           (2, 3, 0, 1)), k)


# ---------------------------------------------------------------------------
# JAX -> port
# ---------------------------------------------------------------------------

def test_a_jax_save_loads_into_the_port(jax_file, tmp_path):
    path, shell = jax_file
    st = shell.state
    model = create_model(_cfg(tmp_path, pool_size=3, ema=0.9), testing=True,
                         device="cpu")
    model.load(path)
    for name, net in model.nets.items():
        want = jax_params_to_state_dict(name, st.params[name])
        want.update(jax_batch_stats_to_buffers(name, st.batch_stats[name]))
        got = net.state_dict()
        assert set(got) == set(want), name
        for k, v in got.items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0,
                                       msg="%s.%s" % (name, k))
        names = [n for n, _ in net.named_parameters()]
        adam, jadam = model.state.opt_state[name], st.opt_state[name]
        assert adam.count == int(jadam.count)
        for mine, tree in ((adam.mu, jadam.mu), (adam.nu, jadam.nu)):
            sd = jax_params_to_state_dict(name, tree)
            for n, t in zip(names, mine):
                torch.testing.assert_close(t, sd[n], rtol=0, atol=0)
    for name, pool in model.state.pools.items():
        np.testing.assert_array_equal(pool.buf.numpy(), st.pools[name].buf)
        assert pool.n == int(st.pools[name].n)
    assert set(model.state.ema) == set(st.ema)
    for name, shadow in model.state.ema.items():
        sd = jax_params_to_state_dict(name, st.ema[name])
        for (n, _), t in zip(model.nets[name].named_parameters(), shadow):
            torch.testing.assert_close(t, sd[n], rtol=0, atol=0)
    assert (model.state.step, model.old_lr, model.epoch) == (7, 1.5e-4, 4)
    assert model.old_lr_d == shell.old_lr_d


def test_a_pool_size_mismatch_gives_the_jax_warning(jax_file, tmp_path,
                                                    capsys):
    model = create_model(_cfg(tmp_path, pool_size=5, ema=0.9), testing=True,
                         device="cpu")
    fresh = {k: p.buf.clone() for k, p in model.state.pools.items()}
    model.load(jax_file[0])
    assert "checkpoint pool buffers do not match this config's " \
           "--pool_size; starting with fresh pools" in capsys.readouterr().out
    for k, p in model.state.pools.items():
        assert p.n == 0 and torch.equal(p.buf, fresh[k])


def test_ema_follows_the_jax_rules(tmp_path):
    """A file without shadows seeds them from the loaded parameters; a
    config without EMA drops the file's (the JAX ``load``'s two cases)."""
    jcfg = _jax_cfg()
    jcfg.expr_dir = str(tmp_path)
    _JaxShell(jcfg, _jax_state(jcfg, seed=5)).save("plain")
    model = create_model(_cfg(tmp_path, ema=0.9), testing=True, device="cpu")
    model.load(str(tmp_path / "plain"))
    for name, shadow in model.state.ema.items():
        for p, t in zip(model.nets[name].parameters(), shadow):
            assert torch.equal(p.detach(), t)
    model.save_jax(str(tmp_path / "with_ema"))
    assert "ema" in read_flax((tmp_path / "with_ema").read_bytes())
    bare = create_model(_cfg(tmp_path), testing=True, device="cpu")
    bare.load(str(tmp_path / "with_ema"))
    assert bare.state.ema == {}


def test_a_file_of_another_variant_is_refused(jax_file, tmp_path):
    model = create_model(_cfg(tmp_path, model="stoch_cycle_gan"),
                         testing=True, device="cpu")
    with pytest.raises(KeyError, match="holds nets"):
        model.load(jax_file[0])


# ---------------------------------------------------------------------------
# port -> JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [dict(pool_size=3, ema=0.9),
                                   dict(norm="batch"),
                                   dict(model="stoch_cycle_gan")],
                         ids=["pool_ema", "norm_batch", "stoch"])
def test_export_jax_goes_to_the_jax_load(tmp_path, flags):
    os.makedirs(str(tmp_path / "port"))
    model = _trained_port(tmp_path / "port", **flags)
    model.save("latest")
    with open(str(tmp_path / "port" / "opt.json"), "w") as f:
        json.dump(dataclasses.asdict(model.opt), f)
    out = str(tmp_path / "jax" / "latest")
    assert export_jax_main(["--chk_path", str(tmp_path / "port" / "latest"),
                            "--out", out, "--device", "cpu"]) == 0
    assert os.path.exists(str(tmp_path / "jax" / "opt.json"))
    jcfg = _jax_cfg(**flags)
    shell = _JaxShell(jcfg, _jax_state(jcfg))
    shell.load(out)
    st = shell.state
    assert int(st.step) == model.state.step == 1
    assert (shell.epoch, shell.old_lr) == (2, model.old_lr)
    for name, net in model.nets.items():
        params = dict(net.named_parameters())
        want = state_dict_to_jax_params(name, params)
        _assert_trees_equal(jax.tree_util.tree_map(np.asarray,
                                                   st.params[name]), want)
        _assert_trees_equal(
            jax.tree_util.tree_map(np.asarray, st.batch_stats[name]),
            buffers_to_jax_batch_stats(name, net.state_dict()))
        adam = model.state.opt_state[name]
        assert int(st.opt_state[name].count) == adam.count == 1
        for tree, moment in ((st.opt_state[name].mu, adam.mu),
                             (st.opt_state[name].nu, adam.nu)):
            _assert_trees_equal(
                jax.tree_util.tree_map(np.asarray, tree),
                state_dict_to_jax_params(name, dict(zip(params, moment))))
    for name, pool in model.state.pools.items():
        np.testing.assert_array_equal(np.asarray(st.pools[name].buf),
                                      pool.buf.numpy())
        assert int(st.pools[name].n) == pool.n == 3  # full after a step
    assert set(st.ema) == set(model.state.ema)


def test_the_port_round_trip_is_exact(tmp_path):
    """port -> flax -> port leaves every tensor, count, pool and number
    equal (the Adam moments of ``up0`` through the flip and back)."""
    model = _trained_port(tmp_path, steps=2, pool_size=3, ema=0.9)
    model.save_jax(str(tmp_path / "flax"))
    other = create_model(_cfg(tmp_path, pool_size=3, ema=0.9, seed=9),
                         testing=True, device="cpu")
    other.load(str(tmp_path / "flax"))
    for name, net in model.nets.items():
        for k, v in net.state_dict().items():
            assert torch.equal(v, other.nets[name].state_dict()[k]), k
        a, b = model.state.opt_state[name], other.state.opt_state[name]
        assert a.count == b.count == 2
        for x, y in zip(a.mu + a.nu, b.mu + b.nu):
            assert torch.equal(x, y)
    for name in model.state.ema:
        for x, y in zip(model.state.ema[name], other.state.ema[name]):
            assert torch.equal(x, y)
    for name, pool in model.state.pools.items():
        assert torch.equal(pool.buf, other.state.pools[name].buf)
        assert pool.n == other.state.pools[name].n
    assert (other.state.step, other.old_lr, other.epoch) == \
        (model.state.step, model.old_lr, model.epoch)


def test_an_opt_pkl_that_names_a_class_is_not_unpickled(tmp_path):
    path = str(tmp_path / "opt.pkl")
    with open(path, "wb") as f:
        pickle.dump({"ngf": 4, "cfg": _jax_cfg()}, f)
    with pytest.raises(pickle.UnpicklingError, match="TrainConfig"):
        parse_opt_file(path)
    with open(path, "wb") as f:
        pickle.dump({"ngf": 4, "lr": 2e-4, "name": "x"}, f)
    assert parse_opt_file(path) == {"ngf": 4, "lr": 2e-4, "name": "x"}


@pytest.mark.slow
def test_one_step_from_each_side_of_an_export_agrees(tmp_path):
    """A port checkpoint after one step, exported: one JAX step from the
    exported file and one port step from the port's own file agree within
    the step-parity limits of the two-step tests.  What the D phase
    computes before any update (its losses, the discriminators' gnorms,
    the posterior's range) is held to the step-1 limits (2e-4 / 2e-3
    relative); what the G phase computes against the just-updated
    discriminators to the step-2 limits (5e-3 / 4e-2), since this step's
    Adam update (count 2, nonzero moments) moves near-zero gradient entries
    by up to lr either way, as step 2 of those tests does; parameters within
    two Adam steps' worst case."""
    import jax.numpy as jnp

    from domain_transfer_gan_tpu.models import steps as jax_steps
    from domain_transfer_gan_tpu.models.state import build_networks

    from torch_port_helpers import FAST_COMPILE

    model = _trained_port(tmp_path)
    model.save("latest")
    model.save_jax(str(tmp_path / "jax_latest"))
    port = create_model(_cfg(tmp_path, seed=5, monitor_gnorm=True),
                        testing=True, device="cpu")
    port.load(str(tmp_path / "latest"))
    jcfg = _jax_cfg()
    shell = _JaxShell(jcfg, _jax_state(jcfg))
    shell.load(str(tmp_path / "jax_latest"))
    state = jax.tree_util.tree_map(jnp.asarray, shell.state)
    jstep = jax.jit(jax_steps.make_aug_train_step(build_networks(jcfg), jcfg),
                    compiler_options=FAST_COMPILE)
    A, B, z = images(7, 4), images(8, 4), latents(9, 4, 8)
    key = jax.random.PRNGKey(11)
    eps = np.asarray(jax.random.normal(jax.random.split(key, 5)[0], z.shape,
                                       jnp.float32))
    state, jl, _, jg = jstep(state, jnp.asarray(A), jnp.asarray(B),
                             jnp.asarray(z), jnp.float32(shell.old_lr),
                             jnp.float32(shell.old_lr_d), key)
    tl, _, tg = port.train_instance(A, B, z, eps)
    before_update = {"D_A", "D_B", "D_z_B", "P_t_A", "P_t_B", "gnorm_D_A",
                     "gnorm_D_B", "gnorm_D_z_B", "mu_min", "mu_max",
                     "logvar_min", "logvar_max"}
    for got, want, tols in ((tl, jl, (2e-4, 5e-3)), (tg, jg, (2e-3, 4e-2))):
        assert set(got) == set(want)
        for k, w in want.items():
            w, tol = float(w), tols[k not in before_update]
            assert abs(float(got[k]) - w) <= tol * max(1.0, abs(w)), (k, w)
    lr = model.old_lr
    for name, net in port.nets.items():
        want = jax_params_to_state_dict(
            name, jax.tree_util.tree_map(np.asarray, state.params[name]))
        for k, v in net.named_parameters():
            d = (v.detach() - want[k]).abs().max().item()
            assert d <= 2 * 2 * lr * 1.05, (name, k, d)
    assert int(state.step) == port.state.step == 2


def test_the_port_clis_take_a_jax_expr_dir(tmp_path):
    """A JAX-package run directory (its flax ``latest``, its opt dumps, an
    ``opt.pkl`` that names a JAX class): the port's ``cli.test`` scores the
    file and ``--continue_train`` resumes from it."""
    from domain_transfer_gan_torch.cli.test import test_model
    from domain_transfer_gan_torch.cli.train import train_model
    from domain_transfer_gan_torch.data.synthetic import \
        write_synthetic_dataset

    data = str(tmp_path / "data")
    write_synthetic_dataset(data, n_train=12, n_test=4, size=64)
    expr = tmp_path / "ck" / "jaxrun"
    expr.mkdir(parents=True)
    jcfg = _jax_cfg(monitor_gnorm=True)
    jcfg.expr_dir = str(expr)
    _JaxShell(jcfg, _jax_state(jcfg, seed=8), epoch=1).save("latest")
    with open(str(expr / "opt.json"), "w") as f:
        json.dump(dict(dataclasses.asdict(jcfg), name="jaxrun"), f,
                  default=str)
    with open(str(expr / "opt.pkl"), "wb") as f:
        pickle.dump({"cfg": jcfg}, f)
    out = test_model(["--chk_path", str(expr / "latest"), "--dataroot", data,
                      "--metric", "mse", "--device", "cpu"])
    assert np.isfinite(out["TEST_MSE_A"])
    model = train_model(argv=[
        "--dataroot", data, "--name", "jaxrun", "--checkpoints_dir",
        str(tmp_path / "ck"), "--grid_size", "64", "--batchSize", "4",
        "--ngf", "4", "--nef", "4", "--ndf", "4", "--nlatent", "8",
        "--niter", "1", "--niter_decay", "1", "--dev_size", "4",
        "--eval_B_freq", "0", "--print_freq", "4", "--device", "cpu",
        "--continue_train"])
    with open(str(expr / "results.txt")) as f:
        assert "resumed from %s (epoch 1, step 7)" % (expr / "latest") \
            in f.read()
    assert (model.epoch, model.state.step) == (2, 9)
