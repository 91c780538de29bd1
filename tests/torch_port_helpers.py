"""Shared helpers of the tests/test_torch_port_*.py files: numpy-seeded
inputs and weights handed to both the JAX package and the PyTorch port."""

import contextlib
import fcntl
import importlib.util
import os
import pickle

import numpy as np
import pytest
import torch

import jax


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's tiny CPU workloads on one torch thread, then restore
    the count: the test runner starts several workers on one machine, and
    each worker's default of one thread per core makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def once(tmp_path_factory, name, compute):
    """``compute()``'s result, computed by one worker of the session and
    read by the others (a lock file shared by the workers)."""
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


def load_chip_smoke():
    """``chip_smoke.py`` at the repository root, imported as a module (it
    imports torch only inside its functions)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def np_tree(tree):
    """A flax params tree as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def randomize(params, seed):
    """Replace every leaf of a params tree by O(1)-scale values drawn with
    numpy from ``seed``: kernels ~ N(0, 1/fan_in), norm scales around 1,
    biases and shifts ~ N(0, 0.1).  (The 'reference' init draws the
    InstanceNorm scale ~ N(0, 0.02), which shrinks every output toward zero
    and would hide real errors behind an absolute tolerance.)"""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:  # bias, shift
            v = 0.1 * rng.randn(*shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, np_tree(params))


def images(seed, n, hw=64, c=3):
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, hw, hw, c)).astype(np.float32)


def latents(seed, n, nlatent):
    return np.random.RandomState(seed).randn(n, nlatent).astype(np.float32)


# ---------------------------------------------------------------------------
# the two-phase train step, both packages side by side
# ---------------------------------------------------------------------------

TINY = dict(model="aug_cycle_gan", grid_size=64, ngf=4, nef=4, ndf=4,
            nlatent=8, batchSize=4)
# XLA:CPU compiles the step several times faster with its expensive passes
# off, and the numbers stay float32
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_nets_and_weights(jcfg, seed):
    """The JAX package's networks for ``jcfg`` and, as numpy trees, every
    net's parameters drawn by :func:`randomize` (from ``seed`` + the net's
    sorted index) and batch statistics (mean 0, variance 1).  Shapes come
    from ``jax.eval_shape``: running the flax initializers op by op costs
    ~25 s."""
    from domain_transfer_gan_tpu.models.state import build_networks, \
        init_state

    nets = build_networks(jcfg)
    shapes = jax.eval_shape(
        lambda key: init_state(jcfg, key, image_size=64)[1],
        jax.random.PRNGKey(0))
    blank = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   dict(shapes.params))
    params = {k: randomize(v, seed + i)
              for i, (k, v) in enumerate(sorted(blank.items()))}
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (np.ones if path[-1].key == "var" else np.zeros)(
            v.shape, np.float32), dict(shapes.batch_stats))
    return nets, params, stats


@contextlib.contextmanager
def recording_grads(model, params):
    """Record the gradient each package hands its per-net clip + Adam
    (``apply_net_update`` of either package's ``models/steps.py``, and of
    the JAX package's ``models/accum.py``), before
    clipping, as ``{net: [state_dict of the gradient, one per call]}`` under
    "jax" and "port".  The JAX step reports through a debug callback from
    inside ``jit`` (so the patch must be in place when the step is traced),
    and its net is known by its leaves' shapes, which differ between the
    nets of one step; the port's by parameter identity."""
    from domain_transfer_gan_tpu.models import accum as jax_accum
    from domain_transfer_gan_tpu.models import steps as jax_steps
    from domain_transfer_gan_torch.models import steps as port_steps
    from domain_transfer_gan_torch.utils.convert import \
        jax_params_to_state_dict

    def shapes(tree):
        return tuple(sorted(np.shape(a) for a in
                            jax.tree_util.tree_leaves(tree)))

    by_shapes = {shapes(v): k for k, v in params.items()}
    assert len(by_shapes) == len(params)
    owner = {id(p): k for k, net in model.nets.items()
             for p in net.parameters()}
    names = {k: [n for n, _ in net.named_parameters()]
             for k, net in model.nets.items()}
    out = {"jax": {}, "port": {}}

    def keep(tree):
        k = by_shapes[shapes(tree)]
        out["jax"].setdefault(k, []).append(
            {n: v.numpy() for n, v in
             jax_params_to_state_dict(k, np_tree(tree)).items()})

    jax_orig, port_orig = jax_steps.apply_net_update, \
        port_steps.apply_net_update

    def jax_update(tx, p, opt_state, grads, *rest):
        jax.debug.callback(keep, grads, ordered=True)
        return jax_orig(tx, p, opt_state, grads, *rest)

    def port_update(p, opt, grads, *rest):
        p = list(p)
        k = owner[id(p[0])]
        out["port"].setdefault(k, []).append(
            {n: g.detach().numpy().copy() for n, g in zip(names[k], grads)})
        return port_orig(p, opt, grads, *rest)

    jax_steps.apply_net_update = jax_accum.apply_net_update = jax_update
    port_steps.apply_net_update = port_update
    try:
        yield out
    finally:
        jax.effects_barrier()
        jax_steps.apply_net_update = jax_accum.apply_net_update = jax_orig
        port_steps.apply_net_update = port_orig


def run_both_train_steps(flags, n_steps=2, batch=4, seed=0, kind="main",
                         d_B_moments=False, grads=False):
    """``n_steps`` of a JAX train step and of the port's counterpart from
    identical numpy-drawn weights, batch-norm statistics, inputs,
    ``prior_z`` and ``eps_post`` (the JAX steps draw eps_post from their
    key; the same draw is handed to the port).  ``kind`` "main" is the
    two-phase step of ``flags["model"]`` (``make_aug_train_step`` or, for
    ``stoch_cycle_gan`` / ``cycle_gan``, ``make_stoch_train_step``), "sup"
    the supervised step of ``aug_cycle_gan``.  With ``grad_accum`` > 1 in
    ``flags`` the JAX side runs ``models/accum.py``'s step.  With
    ``pool_size`` / ``ema`` both packages start from the same (JAX) pools
    and shadows, and the port is handed the pool draws of the JAX key as it
    splits it (``pool_query``'s coin and slot).  With ``d_B_moments`` both
    packages start netD_B's Adam state from the same nonzero moments and a
    count of 3 (so that a zero-gradient step moves it).  With ``grads``
    the run also holds under "grads" what :func:`recording_grads` saw.

    Returns per step the two packages' losses and gnorms as dicts of floats,
    and at the end every net's parameters and running statistics, the JAX
    side converted to the port's ``state_dict`` keys, and the pools
    (``"pools"`` / ``"jax_pools"``: buffer and fill count) and EMA shadows
    (``"ema"`` / ``"jax_ema"``, by parameter name)."""
    import jax.numpy as jnp
    import optax

    from domain_transfer_gan_tpu.config import TrainConfig as JaxConfig
    from domain_transfer_gan_tpu.models import accum as jax_accum
    from domain_transfer_gan_tpu.models import steps as jax_steps
    from domain_transfer_gan_tpu.models.pool import init_pool
    from domain_transfer_gan_tpu.models.state import TrainState, adam_tx

    from domain_transfer_gan_torch.config import TrainConfig
    from domain_transfer_gan_torch.models import create_model
    from domain_transfer_gan_torch.utils.convert import (
        jax_batch_stats_to_buffers,
        jax_params_to_state_dict,
    )

    cfg = dict(TINY, **flags)
    jcfg = JaxConfig(use_pallas=False, **cfg)
    nets, params, stats = jax_nets_and_weights(jcfg, seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tx = adam_tx(jcfg.beta1)
    opt_state = {k: tx.init(jparams[k]) for k in jparams}
    model = create_model(TrainConfig(**cfg), testing=True, device="cpu")
    for k in params:
        model.load_jax_params(k, params[k])
        model.load_jax_batch_stats(k, stats[k])
    if d_B_moments:
        rng = np.random.RandomState(seed + 40)
        moments = [jax.tree_util.tree_map(
            lambda a: (scale * rng.randn(*a.shape)).astype(np.float32),
            params["netD_B"]) for scale in (0.1, 1.0)]
        moments[1] = jax.tree_util.tree_map(np.square, moments[1])
        opt_state["netD_B"] = optax.ScaleByAdamState(
            count=jnp.asarray(3, jnp.int32),
            mu=jax.tree_util.tree_map(jnp.asarray, moments[0]),
            nu=jax.tree_util.tree_map(jnp.asarray, moments[1]))
        mine = model.state.opt_state["netD_B"]
        names = [n for n, _ in model.nets["netD_B"].named_parameters()]
        for dst, tree in ((mine.mu, moments[0]), (mine.nu, moments[1])):
            sd = jax_params_to_state_dict("netD_B", tree)
            for t, n in zip(dst, names):
                t.copy_(sd[n])
        mine.count = 3
    pool_size = int(cfg.get("pool_size", 0))
    pools = {}
    if pool_size:
        pools = {k: init_pool(pool_size, (64, 64, 3))
                 for k in ("fake_A", "fake_B")}
        model.load_jax_pools(pools)
    ema = {}
    if cfg.get("ema", 0.0) > 0.0:
        ema = {k: jparams[k] for k in ("netG_A_B", "netG_B_A", "netE_B")
               if k in jparams}
        for k in ema:
            model.load_jax_ema(k, params[k])
    state = TrainState(
        params=jparams, batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state=opt_state, step=jnp.zeros((), jnp.int32), pools=pools,
        ema=ema)
    accum = int(cfg.get("grad_accum", 1)) > 1
    if kind == "sup":
        raw = jax_steps.make_aug_supervised_step(nets, jcfg)
        n_keys = 2
    elif cfg["model"] == "aug_cycle_gan":
        raw = (jax_accum.make_aug_accum_step if accum
               else jax_steps.make_aug_train_step)(nets, jcfg)
        n_keys = 5
    else:
        raw = (jax_accum.make_stoch_accum_step if accum
               else jax_steps.make_stoch_train_step)(
            nets, jcfg, ignore_noise=cfg["model"] == "cycle_gan")
        n_keys = None
    jstep = jax.jit(raw, compiler_options=FAST_COMPILE)

    def pool_draws(key, n_split):
        """pool_query's (coin, slot) of the JAX step's pool keys (the last
        two of its split)."""
        if not pool_size:
            return None
        out = {}
        for name, k in zip(("fake_A", "fake_B"),
                           jax.random.split(key, n_split)[-2:]):
            k_coin, k_slot = jax.random.split(k)
            out[name] = (np.asarray(jax.random.bernoulli(k_coin, 0.5,
                                                         (batch,))),
                         np.asarray(jax.random.randint(k_slot, (batch,), 0,
                                                       pool_size)))
        return out

    A, B = images(seed + 10, batch), images(seed + 11, batch)
    steps = []
    record = recording_grads(model, params) if grads else \
        contextlib.nullcontext()
    with record as seen:
        for it in range(n_steps):
            z = latents(seed + 20 + it, batch, cfg["nlatent"])
            key = jax.random.PRNGKey(100 + it)
            lr = (jnp.float32(model.old_lr), jnp.float32(model.old_lr_d), key)
            if n_keys is None:
                state, jl, _, jg = jstep(state, jnp.asarray(A), jnp.asarray(B),
                                         jnp.asarray(z), *lr)
                tl, tv, tg = model.train_instance(
                    A, B, z, pool_draws=pool_draws(key, 4))
            else:
                # the eps_post draw of the JAX step, as it splits its key
                k_eps = jax.random.split(key, n_keys)[0]
                eps = np.asarray(jax.random.normal(k_eps, z.shape,
                                                   jnp.float32))
                if kind == "sup":
                    state, jall = jstep(state, jnp.asarray(A), jnp.asarray(B),
                                        jnp.asarray(z), *lr)
                    tall = model.supervised_train_instance(A, B, z, eps)
                    tv = None
                    jl = {k: v for k, v in jall.items() if "gnorm" not in k}
                    jg = {k: v for k, v in jall.items() if "gnorm" in k}
                    tl = {k: v for k, v in tall.items() if "gnorm" not in k}
                    tg = {k: v for k, v in tall.items() if "gnorm" in k}
                else:
                    state, jl, _, jg = jstep(
                        state, jnp.asarray(A), jnp.asarray(B),
                        jnp.asarray(z), *lr)
                    tl, tv, tg = model.train_instance(
                        A, B, z, eps, pool_draws=pool_draws(key, n_keys))
            steps.append({
                "jax_losses": {k: float(v) for k, v in jl.items()},
                "jax_gnorms": {k: float(v) for k, v in jg.items()},
                "losses": {k: float(v) for k, v in tl.items()},
                "gnorms": {k: float(v) for k, v in tg.items()},
                "loss_keys": list(tl), "gnorm_keys": list(tg),
                "visuals": tv,
            })
    want, got = {}, {}
    for k in params:
        sd = jax_params_to_state_dict(k, np_tree(state.params[k]))
        sd.update(jax_batch_stats_to_buffers(
            k, np_tree(state.batch_stats[k])))
        want[k] = {n: v.numpy() for n, v in sd.items()}
        got[k] = {n: v.detach().numpy().copy()
                  for n, v in model.nets[k].state_dict().items()}
    names = {k: [n for n, _ in model.nets[k].named_parameters()]
             for k in model.nets}
    return {"steps": steps, "jax_state": want, "state": got, "model": model,
            "pools": {k: (v.buf.numpy().copy(), v.n)
                      for k, v in model.state.pools.items()},
            "jax_pools": {k: (np.asarray(v.buf), int(v.n))
                          for k, v in state.pools.items()},
            "ema": {k: dict(zip(names[k], (t.numpy().copy() for t in v)))
                    for k, v in model.state.ema.items()},
            "jax_ema": {k: {n: t.numpy() for n, t in jax_params_to_state_dict(
                k, np_tree(v)).items()} for k, v in state.ema.items()},
            "grads": seen, "jax_step": int(state.step),
            "jax_counts": {k: int(v.count) for k, v in
                           state.opt_state.items()},
            "start": {k: {n: v.numpy() for n, v in
                          jax_params_to_state_dict(k, params[k]).items()}
                      for k in params}}


def check_two_step_parity(run, lr=2e-4, frozen=()):
    """What every flag variant is held to.  Step 1: float32 on both sides,
    other summation orders.  Step 2 starts from parameters that already
    differ: Adam's first update is lr * g / (|g| + 1e-8), so a gradient entry
    near zero can land on the other side of zero and move its parameter by
    up to 2 * lr the other way; losses and norms of the second step are held
    to a looser tolerance for that reason, and the parameters to 2 Adam
    steps of that worst case, with at most a tenth of a network's entries
    off by more than lr / 10.  Where the run recorded its gradients
    (``grads``), they are held by :func:`check_step_grads`, and an entry
    whose gradient at either step is smaller than the two packages'
    disagreement there (its sign is not determined) is not counted in that
    tenth."""
    for it, (rl, rg) in enumerate(((2e-4, 2e-3), (5e-3, 4e-2))):
        st = run["steps"][it]
        assert set(st["losses"]) == set(st["jax_losses"])
        assert set(st["gnorms"]) == set(st["jax_gnorms"])
        for k, w in st["jax_losses"].items():
            assert np.isfinite(st["losses"][k]), (it, k)
            assert abs(st["losses"][k] - w) <= rl * max(1.0, abs(w)), (
                it, k, st["losses"][k], w)
        for k, w in st["jax_gnorms"].items():
            assert abs(st["gnorms"][k] - w) <= rg * max(1.0, abs(w)), (
                it, k, st["gnorms"][k], w)
    undetermined = check_step_grads(run) if run.get("grads") else {}
    for net, want in run["jax_state"].items():
        got, start = run["state"][net], run["start"][net]
        assert set(got) == set(want), net
        moved, total, off = 0.0, 0, 0
        for name, w in want.items():
            d = np.abs(got[name] - w)
            if name.rsplit(".", 1)[-1].startswith("running_"):
                assert d.max() <= 1e-3 * max(1.0, np.abs(w).max()), (net,
                                                                     name)
                continue
            assert d.max() <= 2 * 2 * lr * 1.05, (net, name, d.max())
            total += d.size
            off_here = d > 0.1 * lr
            if net in undetermined:
                off_here &= ~undetermined[net][name]
            off += int(off_here.sum())
            moved = max(moved, np.abs(got[name] - start[name]).max())
        # (a bias in front of an instance norm has a gradient of exactly 0
        # in exact arithmetic: Adam turns its rounding noise into +-lr)
        assert off <= 0.1 * total, (net, off, total)
        assert (moved == 0.0) == (net in frozen), (net, moved)


# The step-1 gradient of every parameter tensor, port against JAX, relative
# (L2): largest seen 6.0e-3 (stoch_cycle_gan) and 2.6e-2 (cycle_gan), both
# in netG_A_B's conditional norms; a wrong direction of the same norm is off
# by O(1)
GRAD_RTOL = 5e-2
# a tensor whose JAX gradient is below this share of its net's gradient is
# rounding noise (a bias in front of an instance norm: exactly 0 in exact
# arithmetic; seen <= 2.6e-7 of the net's norm, the smallest real one 2.2e-3)
GRAD_NOISE = 1e-5


def check_step_grads(run):
    """Hold the gradients each package handed its clip + Adam at step 1
    (from the same weights), tensor by tensor: within ``GRAD_RTOL`` (L2,
    relative) where the JAX gradient is real, and rounding noise on both
    sides where it is not.  Returns per net and tensor the entries whose
    JAX gradient at step 1 or 2 is no larger than the two packages'
    difference there."""
    jax_g, port_g = run["grads"]["jax"], run["grads"]["port"]
    assert set(jax_g) == set(port_g)
    undetermined = {}
    for net in jax_g:
        assert len(jax_g[net]) == len(port_g[net]) == len(run["steps"])
        g1j, g1p = jax_g[net][0], port_g[net][0]
        assert set(g1j) == set(g1p), net
        net_norm = np.sqrt(sum(np.sum(np.square(v)) for v in g1j.values()))
        for name, w in g1j.items():
            got, scale = g1p[name], np.linalg.norm(w)
            if scale <= GRAD_NOISE * net_norm:
                assert np.linalg.norm(got) <= GRAD_NOISE * net_norm, (
                    net, name, np.linalg.norm(got), net_norm)
            else:
                assert np.linalg.norm(got - w) <= GRAD_RTOL * scale, (
                    net, name, np.linalg.norm(got - w) / scale)
        undetermined[net] = {
            name: np.logical_or.reduce([
                np.abs(gj[name]) <= np.abs(gp[name] - gj[name])
                for gj, gp in zip(jax_g[net], port_g[net])])
            for name in g1j}
    return undetermined


def check_variant_specifics(run, flags):
    """What a flag must change, beyond agreeing with the JAX step."""
    st = run["steps"][0]
    model = run["model"]
    if flags.get("stoch_enc"):
        # a real posterior: logvar is not zeroed, the KLD is positive
        assert st["gnorms"]["logvar_max"] != 0.0
        assert st["losses"]["KLD_z_B"] > 0.0
    else:
        assert st["gnorms"]["logvar_max"] == 0.0
    z_gan_on = flags.get("z_gan", 1) and not flags.get("stoch_enc")
    # without the z-GAN netD_z_B gets zero gradients: Adam leaves it alone
    assert (st["gnorms"]["gnorm_D_z_B"] > 0.0) == bool(z_gan_on)
    assert model.nets["netE_B"].conv0.weight.shape[1] == (
        6 if flags.get("enc_A_B", 1) else 3)
    if flags.get("no_lsgan"):
        for k in ("P_t_A", "P_f_A", "P_t_B", "P_f_B"):
            assert 0.0 < st["losses"][k] < 1.0, k  # sigmoid probabilities
    batch = flags.get("norm") == "batch"
    for net in ("netG_B_A", "netD_A", "netD_B"):
        moved = [k for k, v in run["state"][net].items()
                 if k.endswith("running_mean") and np.abs(v).max() > 0]
        assert bool(moved) == batch, net
    assert not [k for k in run["state"]["netG_A_B"] if "running" in k]


def run_port_train_steps(flags, n_steps=2, batch=2, seed=0):
    """The port alone: ``n_steps`` of ``train_instance`` from seed-drawn
    weights, in the shape ``check_variant_specifics`` reads."""
    from domain_transfer_gan_torch.config import TrainConfig
    from domain_transfer_gan_torch.models import create_model

    cfg = dict(TINY, init_scheme="sane", seed=seed, **flags)
    model = create_model(TrainConfig(**cfg), testing=True, device="cpu")
    A, B = images(seed + 10, batch), images(seed + 11, batch)
    steps = []
    for it in range(n_steps):
        tl, _, tg = model.train_instance(
            A, B, latents(seed + 20 + it, batch, cfg["nlatent"]),
            latents(seed + 30 + it, batch, cfg["nlatent"]))
        steps.append({"losses": {k: float(v) for k, v in tl.items()},
                      "gnorms": {k: float(v) for k, v in tg.items()}})
    state = {k: {n: v.detach().numpy().copy()
                 for n, v in net.state_dict().items()}
             for k, net in model.nets.items()}
    return {"steps": steps, "state": state, "model": model}
