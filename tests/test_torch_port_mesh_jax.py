"""The port's mesh axes against the JAX package's (slow: a JAX model init
and the step compiles of a two-device mesh per case, minutes each here; the
space axis's GSPMD compile is the slowest).

As ``test_torch_port_parallel_jax.py`` does for the data axis, one case per
axis: the JAX side is ``parallel/mesh.py::DataParallel(num_devices=2,
pipeline= | spatial= | tensor=)`` on the 8-device CPU platform that
``tests/conftest.py`` sets up, the port's side two gloo ranks in spawned
processes laid out as the same mesh (``parallel/selfcheck.py``'s
``MESH_JOBS``).  Both start from the same checkpoint, written by the JAX
package's ``save`` and read by the port's ``load``, and see the same
batches, prior z and posterior noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from domain_transfer_gan_tpu.config import TrainConfig as JaxConfig
from domain_transfer_gan_tpu.models import create_model as jax_create_model
from domain_transfer_gan_tpu.parallel import DataParallel as JaxDataParallel

from domain_transfer_gan_torch.models import create_model
from domain_transfer_gan_torch.parallel import selfcheck
from domain_transfer_gan_torch.utils.convert import (
    jax_batch_stats_to_buffers,
    jax_params_to_state_dict,
)

from torch_port_helpers import np_tree, randomize, recording_grads

ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.mark.slow
@pytest.mark.parametrize("job,steps,batch", [("pp", 2, 8), ("sp", 2, 4),
                                             ("tp", 2, 4)])
def test_two_port_ranks_match_the_jax_mesh(tmp_path, job, steps, batch):
    """The limits of ``test_torch_port_parallel_jax.py`` (losses and gnorms
    at the port-vs-JAX step-parity limits, parameters within two Adam
    steps' worst case, a tenth of a net's determined entries off by more
    than lr / 10 at most, running statistics within 1e-3), over a pipe,
    space or model axis of two devices."""
    flags = dict(selfcheck.MESH_JOBS[job][0])
    mesh_kw = {k: flags.pop(k) for k in ("spatial", "tensor", "pipeline",
                                         "microbatches") if k in flags}
    jcfg = JaxConfig(model="aug_cycle_gan", grid_size=64, batchSize=batch,
                     use_pallas=False, monitor_gnorm=True, seed=1,
                     **dict(selfcheck.TINY, **flags))
    jcfg.expr_dir = str(tmp_path)
    model = jax_create_model(jcfg, testing=True)
    params = {k: randomize(v, 5 + i)
              for i, (k, v) in enumerate(sorted(np_tree(
                  model.state.params).items()))}
    model.state = model.state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params))
    model.save("start")

    A, B, zs = selfcheck._inputs(1, batch, selfcheck.TINY["nlatent"], steps)
    # the gradients of JAX's one-device steps (a debug callback, which a
    # mesh of two devices does not take), then the same steps on the mesh
    rng = model._rng
    port_model = create_model(selfcheck.job_config(job, batch=batch),
                              testing=True, device="cpu")
    with recording_grads(port_model, params) as seen:
        for z in zs:
            model.train_instance(A, B, z)
    model.load(str(tmp_path / "start"))
    model._rng = rng
    dp = JaxDataParallel(model, num_devices=2, **mesh_kw)
    eps, jax_steps = [], []
    for z in zs:
        # the posterior noise the JAX step draws from its key
        key = jax.random.split(dp.model._rng)[1]
        eps.append(np.asarray(jax.random.normal(
            jax.random.split(key, 5)[0], z.shape, jnp.float32)))
        losses, _, gnorms = dp.train_instance(A, B, z)
        jax_steps.append({
            "losses": {k: float(v) for k, v in losses.items()},
            "gnorms": {k: float(v) for k, v in gnorms.items()}})

    ranks = selfcheck.run_ranks(
        [dict(name=job, ckpt=str(tmp_path / "start"), eps=eps, steps=steps,
              record_grads=True)],
        world=2, device="cpu", timeout=300, env=ONE_THREAD)
    mine = ranks[0][0]
    assert ranks[1][0]["steps"] == mine["steps"]
    assert len(mine["steps"]) == steps
    # the step-parity limits of the port against the JAX package
    for it, (got, want) in enumerate(zip(mine["steps"], jax_steps)):
        rl, rg = ((2e-4, 2e-3), (5e-3, 4e-2))[it]
        for what, tol in (("losses", rl), ("gnorms", rg)):
            assert set(got[what]) == set(want[what])
            for k, w in want[what].items():
                assert abs(got[what][k] - w) <= tol * max(1.0, abs(w)), (
                    it, k, got[what][k], w)
    lr = jcfg.lr
    state = dp.model.state
    for name in params:
        want = jax_params_to_state_dict(name, np_tree(state.params[name]))
        want.update(jax_batch_stats_to_buffers(
            name, np_tree(state.batch_stats[name])))
        got = mine["state"][name]
        assert set(got) == set(want), name
        jax_g = seen["jax"][name]
        port_g = [dict(zip(mine["param_names"][name], g))
                  for g in mine["grads"][name]]
        assert len(jax_g) == len(port_g) == steps
        off = total = 0
        for k, w in want.items():
            w = w.numpy()
            d = np.abs(got[k] - w)
            if "running_" in k:
                assert d.max() <= 1e-3 * max(1.0, np.abs(w).max()), (name, k)
                continue
            undetermined = np.logical_or.reduce(
                [np.abs(gj[k]) <= np.abs(gp[k] - gj[k])
                 for gj, gp in zip(jax_g, port_g)])
            assert d.max() <= 2 * 2 * lr * 1.05, (name, k, d.max())
            off += int(((d > 0.1 * lr) & ~undetermined).sum())
            total += d.size
        assert off <= 0.1 * total, (name, off, total)
