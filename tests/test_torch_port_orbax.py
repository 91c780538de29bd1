"""The JAX package's orbax checkpoints in the port (``utils/zstd.py``,
``utils/orbax_dir.py``, ``utils/checkpoint.py::OrbaxCheckpointer``,
``models.api`` ``save`` / ``load`` under ``--ckpt_backend orbax``, the CLIs).

The oracles are the JAX package's own ``OrbaxCheckpointer`` (its ``save``,
``restore`` and ``metadata``), its subprocess writer
``utils/_orbax_write.main`` called as it is, its ``load``, and tensorstore
for the OCDBT store and the zarr arrays underneath.  The JAX side is a
shell object holding a numpy-filled state of the tiny architecture, its
shapes from ``jax.eval_shape`` (a JAX init costs ~50 s here).  Every
comparison is bit for bit."""

import dataclasses
import fcntl
import hashlib
import json
import os
import pickle
import shutil
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domain_transfer_gan_tpu.config import TrainConfig as JaxConfig
from domain_transfer_gan_tpu.models.api import _CycleGANBase as JaxBase
from domain_transfer_gan_tpu.models.state import init_state as jax_init
from domain_transfer_gan_tpu.utils import _orbax_write
from domain_transfer_gan_tpu.utils.checkpoint import OrbaxCheckpointer \
    as JaxOrbax

from domain_transfer_gan_torch.cli.export import main as export_main
from domain_transfer_gan_torch.cli.test import test_model as run_test_cli
from domain_transfer_gan_torch.cli.train import train_model
from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.data.synthetic import write_synthetic_dataset
from domain_transfer_gan_torch.models import create_model
from domain_transfer_gan_torch.utils import orbax_dir, zstd
from domain_transfer_gan_torch.utils.convert import (
    jax_batch_stats_to_buffers,
    jax_params_to_state_dict,
)
from domain_transfer_gan_torch.utils.orbax_dir import (
    OrbaxFormatError,
    orbax_metadata,
    read_orbax,
    write_orbax,
)

from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)
from torch_port_helpers import TINY, images, latents, randomize

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "orbax_tiny")


def _once(tmp_path_factory, name, compute):
    """``compute()``'s result, computed by one worker of the session and
    read by the others."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return compute()
    path = tmp_path_factory.getbasetemp().parent / (name + ".pkl")
    with open(str(path) + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(str(path), "rb") as f:
                return pickle.load(f)
        data = compute()
        with open(str(path), "wb") as f:
            pickle.dump(data, f)
        return data


def _cfg(tmp_path, **kw):
    flags = dict(TINY, seed=0, device="cpu", monitor_gnorm=False,
                 init_scheme="sane", ckpt_backend="orbax")
    flags.update(kw)
    cfg = TrainConfig(**flags)
    cfg.expr_dir = str(tmp_path)
    return cfg


def _jax_cfg(**kw):
    flags = dict(TINY, seed=0, monitor_gnorm=False, use_pallas=False,
                 ckpt_backend="orbax")
    flags.update(kw)
    return JaxConfig(**flags)


class _JaxShell:
    """The JAX package's checkpoint methods on a state filled by numpy."""

    save = JaxBase.save
    load = JaxBase.load
    wait_for_saves = JaxBase.wait_for_saves
    _ckpt_payload = JaxBase._ckpt_payload
    _derive_lr_d = JaxBase._derive_lr_d
    _orbax = JaxBase._orbax

    def __init__(self, opt, state, old_lr=2e-4, epoch=1):
        self.opt, self.state = opt, state
        self.old_lr, self.epoch = old_lr, epoch
        self._derive_lr_d()


_SHAPES = {}


def _jax_state(jcfg, seed=None):
    """A JAX ``TrainState`` of ``jcfg``'s architecture: zeros, or with
    ``seed`` numpy draws everywhere (moments, counts, pools and shadows
    too)."""
    key = (jcfg.model, jcfg.pool_size, jcfg.ema > 0, jcfg.norm, jcfg.ngf,
           jcfg.ndf)
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


def _jax_saves(root):
    """The JAX package's two orbax layouts of one drawn state (tiny
    ``aug_cycle_gan``, pools of 3, EMA): ``jax_array``, its single-process
    save of ``jax.Array`` leaves (OCDBT, zstd); ``subprocess``, what its
    multi-host writer ``utils/_orbax_write.main`` writes from the pickled
    host payload.  Returns the paths and the state as numpy."""
    jcfg = _jax_cfg(pool_size=3, ema=0.9)
    jcfg.expr_dir = root
    state = _jax_state(jcfg, seed=3)
    shell = _JaxShell(jcfg, jax.tree_util.tree_map(jnp.asarray, state),
                      old_lr=1.5e-4, epoch=4)
    shell.save("jax_array")
    shell.wait_for_saves()
    staging = os.path.join(root, "payload.pkl")
    with open(staging, "wb") as f:
        pickle.dump(jax.device_get(shell._ckpt_payload()), f)
    _orbax_write.main(staging, os.path.join(root, "subprocess"))
    return {"root": root, "state": jax.device_get(state),
            "old_lr_d": shell.old_lr_d}


@pytest.fixture(scope="module")
def jax_saves(tmp_path_factory):
    def compute():
        root = str(tmp_path_factory.getbasetemp().parent / "orbax_jax_saves")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        return _jax_saves(root)
    return _once(tmp_path_factory, "orbax_jax_saves", compute)


def _copy(src, tmp_path, name="ckpt"):
    dst = str(tmp_path / name)
    shutil.copytree(src, dst)
    return dst


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


def _assert_port_holds(model, st):
    """Every tensor of the port model equals its converted value in the
    JAX state ``st``."""
    for name, net in model.nets.items():
        want = jax_params_to_state_dict(name, st.params[name])
        want.update(jax_batch_stats_to_buffers(name, st.batch_stats[name]))
        got = net.state_dict()
        assert set(got) == set(want), name
        for k, v in got.items():
            assert torch.equal(v, want[k]), "%s.%s" % (name, k)
        names = [n for n, _ in net.named_parameters()]
        adam, jadam = model.state.opt_state[name], st.opt_state[name]
        assert adam.count == int(jadam.count)
        for mine, tree in ((adam.mu, jadam.mu), (adam.nu, jadam.nu)):
            sd = jax_params_to_state_dict(name, tree)
            for n, t in zip(names, mine):
                assert torch.equal(t, sd[n]), (name, n)
    assert set(model.state.pools) == set(st.pools)
    for name, pool in model.state.pools.items():
        np.testing.assert_array_equal(pool.buf.numpy(), st.pools[name].buf)
        assert pool.n == int(st.pools[name].n)
    assert set(model.state.ema) == set(st.ema)
    for name, shadow in model.state.ema.items():
        sd = jax_params_to_state_dict(name, st.ema[name])
        for (n, _), t in zip(model.nets[name].named_parameters(), shadow):
            assert torch.equal(t, sd[n]), (name, n)


def _assert_models_equal(a, b):
    for name, net in a.nets.items():
        for k, v in net.state_dict().items():
            assert torch.equal(v, b.nets[name].state_dict()[k]), k
        x, y = a.state.opt_state[name], b.state.opt_state[name]
        assert x.count == y.count
        for s, t in zip(x.mu + x.nu, y.mu + y.nu):
            assert torch.equal(s, t)
    assert set(a.state.ema) == set(b.state.ema)
    for name in a.state.ema:
        for s, t in zip(a.state.ema[name], b.state.ema[name]):
            assert torch.equal(s, t)
    assert set(a.state.pools) == set(b.state.pools)
    for name, pool in a.state.pools.items():
        assert torch.equal(pool.buf, b.state.pools[name].buf)
        assert pool.n == b.state.pools[name].n
    assert (a.state.step, a.old_lr, a.epoch) == \
        (b.state.step, b.old_lr, b.epoch)


def _indirect_value(path):
    """(key, file, offset, length) of a value the store keeps outside its
    nodes, a zstd chunk of a large array."""
    store = orbax_dir._Stores(path).stores[0]
    for key, ref in sorted(store.entries.items()):
        if not isinstance(ref, bytes) and not key.endswith(".zarray"):
            return (key,) + ref
    raise AssertionError("no value outside the nodes")


# ---------------------------------------------------------------------------
# the format, against tensorstore
# ---------------------------------------------------------------------------

STORES = {
    # many versions (a version tree of arity 2) and a B-tree four nodes
    # deep, small values inline and the others in data files
    "deep": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16,
             "version_tree_arity_log2": 1,
             "compression": {"id": "zstd"}},
    "uncompressed": {"compression": None, "max_inline_value_bytes": 16},
    "zstd_level_5": {"compression": {"id": "zstd", "level": 5}},
}


@pytest.mark.parametrize("name", sorted(STORES))
def test_the_ocdbt_reader_reads_what_tensorstore_writes(tmp_path, name):
    import tensorstore as ts

    spec = {"driver": "ocdbt", "base": "file://" + str(tmp_path),
            "config": STORES[name]}
    kv = ts.KvStore.open(spec).result()
    rng = np.random.RandomState(0)
    for gen in range(5):
        with ts.Transaction() as txn:
            for i in range(40):
                key = "k%03d/%s" % (i + 40 * gen, "x" * (i % 7))
                kv.with_transaction(txn)[key] = rng.bytes(
                    int(rng.choice([3, 10, 40, 100])))
    store = orbax_dir._Ocdbt(str(tmp_path))
    keys = [k.decode() for k in kv.list().result()]
    assert sorted(store.entries) == sorted(keys)
    for k in keys:
        assert store.get(k) == kv[k], k


@pytest.mark.parametrize("kvstore", ["ocdbt", "file"])
def test_a_chunk_grid_with_edge_chunks_assembles(tmp_path, kvstore):
    """A zarr array stored as 3 x 3 chunks, the last row and column of
    them cut by the shape, one chunk never written: the missing one is the
    fill value where the writer may skip chunks, refused where it may not."""
    import tensorstore as ts

    base = {"driver": kvstore, "path": str(tmp_path) + "/"} \
        if kvstore == "file" else \
        {"driver": "ocdbt", "base": "file://" + str(tmp_path)}
    arr = ts.open({"driver": "zarr", "kvstore": base, "path": "a.b",
                   "metadata": {"shape": [7, 10], "chunks": [3, 4],
                                "dtype": "<f4", "fill_value": 0.5,
                                "compressor": {"id": "zstd", "level": 1}},
                   "create": True}).result()
    want = np.arange(70, dtype=np.float32).reshape(7, 10)
    arr[:6].write(want[:6]).result()
    want[6:] = 0.5
    store = orbax_dir._Stores(str(tmp_path)) if kvstore == "ocdbt" \
        else orbax_dir._Files(str(tmp_path))
    np.testing.assert_array_equal(
        orbax_dir._read_array(store, "a.b", complete=False), want)
    with pytest.raises(OrbaxFormatError, match="chunk a.b/2.0 is missing"):
        orbax_dir._read_array(store, "a.b", complete=True)


def test_crc32c_is_castagnoli():
    # the check value of CRC-32C (RFC 3720 B.4)
    assert orbax_dir.crc32c(b"123456789") == 0xE3069283
    assert orbax_dir.crc32c(bytes(32)) == 0x8A9136AA


# ---------------------------------------------------------------------------
# JAX -> port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["jax_array", "subprocess"])
def test_a_jax_orbax_save_loads_into_the_port(jax_saves, tmp_path, layout):
    path = os.path.join(jax_saves["root"], layout)
    values = json.load(open(os.path.join(path, orbax_dir.METADATA)))
    kinds = {v["value_metadata"]["value_type"]
             for v in values["tree_metadata"].values()}
    # the JAX payload's old_lr and epoch are numpy scalars in either
    assert ("jax.Array" in kinds) == (layout == "jax_array")
    assert os.path.exists(os.path.join(path, "_sharding")) == \
        (layout == "jax_array")
    model = create_model(_cfg(tmp_path, pool_size=3, ema=0.9), testing=True,
                         device="cpu")
    model.load(path)
    _assert_port_holds(model, jax_saves["state"])
    assert (model.state.step, model.old_lr, model.epoch) == (7, 1.5e-4, 4)
    assert model.old_lr_d == jax_saves["old_lr_d"]


@pytest.mark.parametrize("layout", ["jax_array", "subprocess"])
def test_the_reader_gives_what_orbax_restores(jax_saves, layout):
    path = os.path.join(jax_saves["root"], layout)
    mine = read_orbax(path)
    theirs = jax.device_get(JaxOrbax()._sync.restore(path))
    _assert_trees_equal(mine, theirs)
    meta = orbax_metadata(path)
    ref = JaxOrbax().metadata(path).item_metadata.tree

    def same(a, b):
        assert a.shape == tuple(b.shape) and a.dtype == np.dtype(b.dtype)
    jax.tree_util.tree_map(same, meta, ref,
                           is_leaf=lambda x: isinstance(
                               x, orbax_dir.ArrayMeta))


def test_the_root_store_and_the_writer_process_store_agree(jax_saves,
                                                           tmp_path):
    """Without the root manifest (a save whose stores were never merged)
    the writer process's store gives the same tree."""
    path = _copy(os.path.join(jax_saves["root"], "jax_array"), tmp_path)
    want = read_orbax(path)
    os.remove(os.path.join(path, "manifest.ocdbt"))
    _assert_trees_equal(read_orbax(path), want)


def test_the_committed_fixture_reads_leaf_for_leaf():
    """The JAX-written fixture (``tests/fixtures/make_orbax_tiny.py``): each
    leaf's dtype, shape and sha256 as orbax's restore gave them."""
    want = json.load(open(os.path.join(FIXTURE, "leaves.json")))
    got = {}

    def walk(node, keys=()):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, keys + (k,))
        else:
            got[".".join(keys)] = node
    walk(read_orbax(os.path.join(FIXTURE, "latest")))
    assert set(got) == set(want)
    for name, leaf in got.items():
        assert {"dtype": leaf.dtype.str, "shape": list(leaf.shape),
                "sha256": hashlib.sha256(leaf.tobytes("C")).hexdigest()} \
            == want[name], name
    opt = json.load(open(os.path.join(FIXTURE, "opt.json")))
    cfg = TrainConfig(**{f.name: opt[f.name] for f in
                         dataclasses.fields(TrainConfig) if f.name in opt})
    cfg.device = "cpu"
    model = create_model(cfg, testing=True, device="cpu")
    model.load(os.path.join(FIXTURE, "latest"))
    assert (model.state.step, model.epoch) == (40, 3)
    assert set(model.state.ema) == {"netG_A_B", "netG_B_A", "netE_B"}


# ---------------------------------------------------------------------------
# port -> JAX, port -> port
# ---------------------------------------------------------------------------

def test_a_port_directory_restores_through_the_jax_load(tmp_path):
    model = _trained_port(tmp_path, pool_size=3, ema=0.9)
    model.save("latest")
    path = str(tmp_path / "latest")
    assert sorted(os.listdir(path))[:2] == ["_CHECKPOINT_METADATA",
                                            "_METADATA"]
    jcfg = _jax_cfg(pool_size=3, ema=0.9)
    shell = _JaxShell(jcfg, _jax_state(jcfg))
    shell.load(path)
    want = model._jax_payload()
    got = jax.device_get(shell._ckpt_payload())
    got["opt_state"] = {k: {"count": v.count, "mu": v.mu, "nu": v.nu}
                        for k, v in got["opt_state"].items()}
    got["pools"] = {k: {"buf": v.buf, "n": v.n}
                    for k, v in got["pools"].items()}
    got["old_lr"], got["epoch"] = np.asarray(shell.old_lr, np.float64), \
        np.asarray(shell.epoch, np.int64)
    _assert_trees_equal(got, want)
    meta = JaxOrbax().metadata(path).item_metadata.tree
    assert tuple(meta["pools"]["fake_A"]["buf"].shape) == (3, 64, 64, 3)
    assert set(meta["ema"]) == {"netG_A_B", "netG_B_A", "netE_B"}


def test_the_port_round_trip_is_exact(tmp_path):
    """port -> orbax directory -> port, the second save asynchronous and
    over the first."""
    model = _trained_port(tmp_path, steps=2, pool_size=3, ema=0.9)
    model.save("latest", async_save=True)
    model.train_instance(images(4, 4), images(5, 4), latents(6, 4, 8))
    model.save("latest", async_save=True)
    model.wait_for_saves()
    assert [d for d in os.listdir(str(tmp_path)) if "orbax" in d] == []
    other = create_model(_cfg(tmp_path, pool_size=3, ema=0.9, seed=9),
                         testing=True, device="cpu")
    other.load(str(tmp_path / "latest"))
    assert other.state.step == 3
    _assert_models_equal(model, other)


def test_a_failed_async_save_raises_on_wait(tmp_path):
    from domain_transfer_gan_torch.utils.checkpoint import OrbaxCheckpointer

    def boom(path, tree):
        raise OSError("disk full")
    model = _trained_port(tmp_path, steps=0)
    model._orbax_ckpt = OrbaxCheckpointer()
    model._orbax_ckpt._async._write = boom
    model.save("latest", async_save=True)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        model.wait_for_saves()


def test_a_save_replaces_a_checkpoint_whole(tmp_path, monkeypatch):
    """A write that fails halfway leaves the old directory as it was and
    nothing beside it."""
    write_orbax(str(tmp_path / "latest"), {"a": np.arange(3)})

    def fail(directory, arr):
        raise OSError("disk full")
    monkeypatch.setattr(orbax_dir, "_write_array", fail)
    with pytest.raises(OSError, match="disk full"):
        write_orbax(str(tmp_path / "latest"), {"a": np.arange(5)})
    assert os.listdir(str(tmp_path)) == ["latest"]
    np.testing.assert_array_equal(read_orbax(str(tmp_path / "latest"))["a"],
                                  np.arange(3))


def test_the_writer_keeps_shapes_dtypes_and_empty_subtrees(tmp_path):
    tree = {"s": np.asarray(3, np.int32), "f": np.float64(0.5),
            "e": {}, "x": {"y": np.asfortranarray(
                np.arange(6, dtype=np.float32).reshape(2, 3))},
            "l": [np.ones(2, np.int64), np.zeros((0, 3), np.float32)]}
    write_orbax(str(tmp_path / "c"), tree)
    got = read_orbax(str(tmp_path / "c"))
    want = dict(tree, f=np.asarray(0.5))
    assert isinstance(got["l"], list) and len(got["l"]) == 2
    got["l"], want["l"] = dict(enumerate(got["l"])), dict(enumerate(tree["l"]))
    _assert_trees_equal(got, want)
    theirs = jax.device_get(JaxOrbax()._sync.restore(str(tmp_path / "c")))
    assert theirs["e"] == {} and theirs["s"].dtype == np.int32
    np.testing.assert_array_equal(theirs["x"]["y"], tree["x"]["y"])
    with pytest.raises(ValueError, match="string keys"):
        write_orbax(str(tmp_path / "d"), {"a.b": np.zeros(1)})


# ---------------------------------------------------------------------------
# the JAX load's rules
# ---------------------------------------------------------------------------

def test_ema_follows_the_jax_rules(tmp_path):
    """A directory without shadows seeds them from the loaded parameters;
    a config without EMA drops the directory's and never reads them."""
    _trained_port(tmp_path).save("plain")
    model = create_model(_cfg(tmp_path, ema=0.9), testing=True, device="cpu")
    model.load(str(tmp_path / "plain"))
    for name, shadow in model.state.ema.items():
        for p, t in zip(model.nets[name].parameters(), shadow):
            assert torch.equal(p.detach(), t)
    model.save("with_ema")
    path = str(tmp_path / "with_ema")
    assert "ema" in orbax_metadata(path)
    # a shadow's chunk spoiled: a config without EMA does not read it
    chunk = os.path.join(path, "ema.netG_A_B.conv0.kernel", "0.0.0.0")
    with open(chunk, "wb") as f:
        f.write(b"spoiled")
    bare = create_model(_cfg(tmp_path), testing=True, device="cpu")
    bare.load(path)
    assert bare.state.ema == {}
    with pytest.raises(OrbaxFormatError, match="ema.netG_A_B.conv0.kernel"):
        model.load(path)


@pytest.mark.parametrize("save_pool,load_pool", [(0, 8), (8, 0), (8, 4)])
def test_a_pool_size_change_follows_the_jax_rules(tmp_path, capsys,
                                                  save_pool, load_pool):
    """The three cases of the JAX package's own test: the JAX ``load`` and
    the port's both warn and keep this config's fresh pools."""
    model = _trained_port(tmp_path, steps=0, pool_size=save_pool)
    model.save("latest")
    path = str(tmp_path / "latest")
    warning = ("checkpoint pool buffers do not match this config's "
               "--pool_size; starting with fresh pools")
    capsys.readouterr()
    jcfg = _jax_cfg(pool_size=load_pool)
    shell = _JaxShell(jcfg, _jax_state(jcfg))
    shell.load(path)
    assert warning in capsys.readouterr().out
    assert {k: int(p.n) for k, p in shell.state.pools.items()} == \
        ({"fake_A": 0, "fake_B": 0} if load_pool else {})
    other = create_model(_cfg(tmp_path, pool_size=load_pool), testing=True,
                         device="cpu")
    fresh = {k: p.buf.clone() for k, p in other.state.pools.items()}
    other.load(path)
    assert capsys.readouterr().out.count(warning) == 1
    assert set(other.state.pools) == set(shell.state.pools)
    for k, p in other.state.pools.items():
        assert p.n == 0 and torch.equal(p.buf, fresh[k])
    for name, net in model.nets.items():
        for k, v in net.state_dict().items():
            assert torch.equal(v, other.nets[name].state_dict()[k])


def test_a_directory_of_another_variant_is_refused(jax_saves, tmp_path):
    model = create_model(_cfg(tmp_path, model="stoch_cycle_gan"),
                         testing=True, device="cpu")
    with pytest.raises(KeyError, match="holds nets"):
        model.load(os.path.join(jax_saves["root"], "jax_array"))


# ---------------------------------------------------------------------------
# refusals by name
# ---------------------------------------------------------------------------

def _spoil_crc(path):
    node = [os.path.join(path, "d", f) for f in os.listdir(
        os.path.join(path, "d"))][0]
    data = bytearray(open(node, "rb").read())
    data[20] ^= 0xFF
    open(node, "wb").write(bytes(data))


def _spoil_chunk(path):
    _, f, offset, _ = _indirect_value(path)
    data = bytearray(open(f, "rb").read())
    data[offset + 8:offset + 16] = b"\xff" * 8
    open(f, "wb").write(bytes(data))


def _new_version(path):
    f = os.path.join(path, "manifest.ocdbt")
    data = bytearray(open(f, "rb").read())
    data[12] = 7  # the format version, right after magic and length
    data[-4:] = struct.pack("<I", orbax_dir.crc32c(bytes(data[:-4])))
    open(f, "wb").write(bytes(data))


def _no_metadata(path):
    os.remove(os.path.join(path, orbax_dir.METADATA))


REFUSALS = {
    "not_a_checkpoint": (_no_metadata, OrbaxFormatError,
                         "a directory but not an orbax checkpoint"),
    "crc_mismatch": (_spoil_crc, OrbaxFormatError, "CRC-32C mismatch"),
    "corrupt_chunk": (_spoil_chunk, OrbaxFormatError, "zstd"),
    "format_version": (_new_version, OrbaxFormatError,
                       "OCDBT format version 7"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_a_bad_directory_is_refused_by_name(jax_saves, tmp_path, case):
    spoil, error, message = REFUSALS[case]
    path = _copy(os.path.join(jax_saves["root"], "jax_array"), tmp_path)
    spoil(path)
    model = create_model(_cfg(tmp_path, pool_size=3, ema=0.9), testing=True,
                         device="cpu")
    with pytest.raises(error, match=message):
        model.load(path)


@pytest.mark.parametrize("field,value,message", [
    ("dtype", ">f4", "zarr dtype '>f4'"),
    ("compressor", {"id": "blosc"}, "zarr compressor 'blosc'"),
    ("filters", [{"id": "delta"}], "zarr filters"),
    ("zarr_format", 3, "zarr format 3")])
def test_an_unknown_zarr_array_is_refused_by_name(tmp_path, field, value,
                                                  message):
    path = str(tmp_path / "c")
    write_orbax(path, {"a": np.zeros(3, np.float32)})
    f = os.path.join(path, "a", ".zarray")
    meta = json.load(open(f))
    meta[field] = value
    json.dump(meta, open(f, "w"))
    with pytest.raises(OrbaxFormatError, match=message):
        read_orbax(path)


def test_a_missing_libzstd_is_refused_by_name(jax_saves, tmp_path,
                                              monkeypatch):
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd.ctypes.util, "find_library", lambda name: None)
    monkeypatch.setattr(zstd, "LIBRARY", "libzstd-absent.so.404")
    model = create_model(_cfg(tmp_path, pool_size=3, ema=0.9), testing=True,
                         device="cpu")
    with pytest.raises(zstd.ZstdMissingError, match="needs the zstd library"):
        model.load(os.path.join(jax_saves["root"], "jax_array"))
    # the writer needs no zstd
    write_orbax(str(tmp_path / "c"), {"a": np.zeros(2)})
    np.testing.assert_array_equal(read_orbax(str(tmp_path / "c"))["a"],
                                  np.zeros(2))


def test_zstd_errors_are_named():
    with pytest.raises(zstd.ZstdError, match="not a zstd frame"):
        zstd.decompress(b"not zstd at all")
    import zstandard
    frame = zstandard.ZstdCompressor(write_content_size=False).compress(
        bytes(5000))
    assert zstd.decompress(frame) == bytes(5000)
    assert zstd.decompress(frame, 5000).tobytes() == bytes(5000)
    with pytest.raises(zstd.ZstdError, match="Destination buffer is too "
                                             "small"):
        zstd.decompress(frame, 4999)
    with pytest.raises(zstd.ZstdError, match="over 100 bytes"):
        zstd.decompress(frame, limit=100)
    with pytest.raises(zstd.ZstdError, match="truncated"):
        zstd.decompress(frame[:-3])


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_the_clis_write_resume_from_and_read_orbax_directories(tmp_path):
    """``--ckpt_backend orbax``: ``latest`` / ``best_A`` are directories,
    ``--continue_train`` resumes from ``latest``, ``cli.test`` and
    ``cli.export`` read it, and the JAX ``load`` restores it."""
    root = str(tmp_path / "data")
    write_synthetic_dataset(root, n_train=12, n_test=4, size=64)
    argv = ["--dataroot", root, "--name", "orbax", "--checkpoints_dir",
            str(tmp_path), "--grid_size", "64", "--batchSize", "4",
            "--ngf", "4", "--nef", "4", "--ndf", "4", "--nlatent", "8",
            "--niter", "1", "--niter_decay", "0", "--dev_size", "4",
            "--eval_B_freq", "0", "--display_freq", "1000", "--seed", "3",
            "--save_epoch_freq", "1",
            "--device", "cpu", "--ckpt_backend", "orbax", "--pool_size", "2",
            "--ema", "0.9"]
    first = train_model(argv=argv)
    expr = tmp_path / "orbax"
    for name in ("latest", "best_A"):
        assert orbax_dir.is_orbax_dir(str(expr / name)), name
    resumed = train_model(argv=argv[:argv.index("--niter_decay") + 1]
                          + ["1"] + argv[argv.index("--niter_decay") + 2:]
                          + ["--continue_train", "--eval_A_freq", "0"])
    text = (expr / "results.txt").read_text()
    assert "resumed from %s (epoch 1, step %d)" % (
        expr / "latest", first.state.step) in text
    assert (resumed.epoch, resumed.state.step) == (2, 2 * first.state.step)
    latest = str(expr / "latest")
    out = run_test_cli(["--chk_path", latest + "/", "--dataroot", root,
                        "--metric", "mse", "--device", "cpu"])
    assert np.isfinite(out["TEST_MSE_A"])
    export_main(["--chk_path", latest, "--out", str(tmp_path / "export"),
                 "--batch", "2", "--use_ema", "1", "--device", "cpu"])
    assert os.path.exists(str(tmp_path / "export" / "manifest.json"))
    jcfg = _jax_cfg(pool_size=2, ema=0.9)
    shell = _JaxShell(jcfg, _jax_state(jcfg))
    shell.load(latest)
    assert (int(shell.state.step), shell.epoch) == (resumed.state.step, 2)


@pytest.mark.slow
def test_a_full_width_jax_save_loads_into_the_port(tmp_path):
    """The chip's width (ngf 32, nef 32, ndf 64, 3 blocks, nlatent 16),
    the JAX package's single-process save; the tiny case is
    ``test_a_jax_orbax_save_loads_into_the_port``."""
    width = dict(ngf=32, nef=32, ndf=64, n_blocks=3, nlatent=16,
                 pool_size=50, ema=0.999)
    jcfg = _jax_cfg(**width)
    jcfg.expr_dir = str(tmp_path)
    state = _jax_state(jcfg, seed=5)
    shell = _JaxShell(jcfg, jax.tree_util.tree_map(jnp.asarray, state))
    shell.save("latest")
    shell.wait_for_saves()
    model = create_model(_cfg(tmp_path, **width), testing=True, device="cpu")
    model.load(str(tmp_path / "latest"))
    _assert_port_holds(model, state)
