"""Tensor parallelism (``--tensor``, ``parallel/mesh.py``): the shard rule
against the JAX package's ``param_shardings`` leaf for leaf, the steps and
the evaluation over ``--tensor 2`` (and ``dp x tp`` over 4 ranks) against
one process, the Adam moments and EMA shadows held as slices, and a
``--tensor 2`` checkpoint loaded whole by one process of the port and by
the JAX package's ``load``."""

import jax
import numpy as np
import pytest

from domain_transfer_gan_tpu.config import TrainConfig as JaxConfig
from domain_transfer_gan_tpu.models.state import init_state as jax_init
from domain_transfer_gan_tpu.parallel.mesh import make_mesh_axes
from domain_transfer_gan_tpu.parallel.mesh import \
    param_shardings as jax_param_shardings

from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.models import create_model
from domain_transfer_gan_torch.parallel.mesh import param_shardings
from domain_transfer_gan_torch.utils.convert import (
    jax_batch_stats_to_buffers, jax_params_to_state_dict)

from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)
from torch_port_mesh_runs import hold_job, once, run_group

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FULL = dict(ngf=32, nef=32, ndf=64, nlatent=16, n_blocks=3)


def _port_name(path):
    """The port's ``state_dict`` key of a JAX params leaf path
    (``utils/convert.py``'s naming)."""
    leaf = path[-1]
    if leaf == "kernel" or tuple(path[-2:]) == ("bn", "scale"):
        leaf = "weight"
    return ".".join(tuple(path[:-1]) + (leaf,))


@pytest.mark.parametrize("width", ("tiny", "full"))
def test_the_shard_rule_is_the_jax_rule_leaf_for_leaf(width):
    """On the JAX package's own tree (shapes from ``jax.eval_shape``, no
    compile) under an 8-device CPU mesh with ``model = 2``: a leaf is
    sliced by the port exactly where ``param_shardings`` shards it, on the
    torch dimension that holds the JAX leaf's last axis."""
    flags = FULL if width == "full" else dict(ngf=4, nef=4, ndf=4,
                                              nlatent=8, n_blocks=3)
    jcfg = JaxConfig(model="aug_cycle_gan", use_pallas=False, **flags)
    shapes = jax.eval_shape(lambda k: jax_init(jcfg, k, image_size=64)[1],
                            jax.random.PRNGKey(0)).params
    mesh = make_mesh_axes([("data", 4), ("model", 2)])
    jax_specs = jax_param_shardings(mesh, shapes, "model")
    model = create_model(TrainConfig(model="aug_cycle_gan", device="cpu",
                                     **flags), testing=True, device="cpu")
    seen = 0
    for name, net in model.nets.items():
        mine = param_shardings(net.named_parameters(), 2)
        params = dict(net.named_parameters())
        flat = jax.tree_util.tree_flatten_with_path(jax_specs[name])[0]
        assert len(flat) == len(mine), name
        for path, sharding in flat:
            keys = [p.key for p in path]
            port = _port_name(keys)
            spec = tuple(sharding.spec)
            jax_sharded = len(spec) > 0 and spec[-1] == "model"
            assert (mine[port] is not None) == jax_sharded, (name, port)
            if jax_sharded:
                seen += 1
                # the sliced torch dimension carries the JAX last axis
                jshape = shapes[name]
                for k in keys:
                    jshape = jshape[k]
                assert params[port].shape[mine[port]] == jshape.shape[-1]
    assert seen > 10


TWO = ("tp", "tp_ema", "tp_eval")
FOUR = ("dp_tp",)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return once(tmp_path_factory, "tensor_two",
                lambda: run_group(TWO, 2, ("tensor_checkpoint",)))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return once(tmp_path_factory, "tensor_four", lambda: run_group(FOUR, 4))


@pytest.mark.parametrize("job", TWO)
def test_tensor_steps_and_evaluation_match_one_process(two, job):
    """Losses, gnorms (the clip's norm over the slices), step-1 gradients
    tensor by tensor, parameters, moments and shadows gathered whole."""
    single, ranks = two[0][job]
    hold_job(single, ranks)
    assert all(r["bytes_held"] < single["bytes_held"] for r in ranks)


def test_data_times_model_matches_one_process(four):
    single, ranks = four[0]["dp_tp"]
    assert len(ranks) == 4
    hold_job(single, ranks)


def test_no_rank_holds_a_whole_sliced_leaf(two):
    """After set-up every sliced parameter, its Adam moments and its EMA
    shadow are this rank's half; the ranks hold fewer bytes than one
    process; outside a save they are slices again."""
    for rank in two[1]:
        got = rank["tensor_checkpoint"]
        assert got["held"] < got["before"]
        for net, shapes in got["sliced"].items():
            whole = got["whole"][net]
            after = got["after"][net]
            names = [k for k in whole if k in after]
            for k in names:
                if after[k].shape != whole[k].shape:
                    assert sum(a != b for a, b in zip(after[k].shape,
                                                      whole[k].shape)) == 1
                    assert after[k].size * 2 == whole[k].size
        assert any(got["sliced"].values())


def _files(tmp_path, rank):
    paths = {}
    for name, data in rank["files"].items():
        p = tmp_path / name
        p.write_bytes(data)
        paths[name] = str(p)
    return paths


def test_a_tensor_checkpoint_loads_whole_in_one_process(two, tmp_path):
    rank = two[1][0]["tensor_checkpoint"]
    paths = _files(tmp_path, rank)
    cfg = TrainConfig(model="aug_cycle_gan", grid_size=64, ngf=4, nef=4,
                      ndf=4, nlatent=8, n_blocks=3, batchSize=4, ema=0.9,
                      init_scheme="sane", seed=9, device="cpu")
    model = create_model(cfg, testing=True, device="cpu")
    model.load(paths["latest"])
    for name, net in model.nets.items():
        for k, v in net.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), rank["whole"][name][k])
        s = model.state.opt_state[name]
        for t, w in zip(s.mu + s.nu, rank["moments"][name]):
            np.testing.assert_array_equal(t.numpy(), w)
    for name, shadow in model.state.ema.items():
        for t, w in zip(shadow, rank["ema"][name]):
            np.testing.assert_array_equal(t.numpy(), w)
    # both ranks wrote the same checkpoint
    other = two[1][1]["tensor_checkpoint"]
    for name in rank["whole"]:
        for k, v in rank["whole"][name].items():
            np.testing.assert_array_equal(v, other["whole"][name][k])


def test_a_tensor_checkpoint_loads_in_the_jax_package(two, tmp_path):
    """The flax file ``save_jax`` wrote under ``--tensor 2`` through the
    JAX package's own ``load``: every parameter, statistic, moment and
    shadow is the gathered one."""
    from test_torch_port_flax_checkpoint import (_JaxShell, _jax_cfg,
                                                 _jax_state)

    rank = two[1][0]["tensor_checkpoint"]
    paths = _files(tmp_path, rank)
    jcfg = _jax_cfg(ema=0.9, init_scheme="sane")
    shell = _JaxShell(jcfg, _jax_state(jcfg))
    shell.load(paths["latest.flax"])
    st = shell.state
    for name, whole in rank["whole"].items():
        want = jax_params_to_state_dict(name, st.params[name])
        want.update(jax_batch_stats_to_buffers(name, st.batch_stats[name]))
        assert set(want) == set(whole), name
        for k, v in whole.items():
            np.testing.assert_array_equal(want[k].numpy(), v,
                                          err_msg="%s.%s" % (name, k))
        names = [k for k in whole if not k.rsplit(".", 1)[-1].startswith(
            "running_")]
        mu = jax_params_to_state_dict(name, st.opt_state[name].mu)
        got_mu = rank["moments"][name][:len(names)]
        for n, w in zip(names, got_mu):
            np.testing.assert_array_equal(mu[n].numpy(), w)
    for name, shadow in rank["ema"].items():
        sd = jax_params_to_state_dict(name, st.ema[name])
        names = [k for k in rank["whole"][name]
                 if not k.rsplit(".", 1)[-1].startswith("running_")]
        for n, w in zip(names, shadow):
            np.testing.assert_array_equal(sd[n].numpy(), w)
