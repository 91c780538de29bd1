"""Regenerate ``tests/fixtures/orbax_tiny/``: a checkpoint directory that
the JAX package's own ``--ckpt_backend orbax`` save writes (its
``OrbaxCheckpointer``, single process, ``jax.Array`` leaves: OCDBT with
zstd, orbax's default), of a tiny ``aug_cycle_gan`` (ngf = nef = ndf = 4,
nlatent 8, EMA on), with

- ``latest/``: the checkpoint;
- ``opt.json``: its options, as the JAX training CLI writes them;
- ``leaves.json``: each leaf's dtype, shape and the sha256 of its C-order
  bytes, as orbax's own restore gives them.

The state is drawn from a seed with numpy (its shapes from
``jax.eval_shape``, no initializer runs): each leaf is 97 normal draws
repeated over its C-order entries (parameters and EMA shadows of scale
0.05, Adam first moments 1e-3, second moments the squares of such), so
that zstd keeps the directory under 1 MB.

    JAX_PLATFORMS=cpu python tests/fixtures/make_orbax_tiny.py
"""

import dataclasses
import hashlib
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "orbax_tiny")
FLAGS = dict(model="aug_cycle_gan", grid_size=64, ngf=4, nef=4, ndf=4,
             nlatent=8, batchSize=4, ema=0.9, ckpt_backend="orbax",
             use_pallas=False, seed=0)
SEED = 14
PERIOD = 97  # each leaf repeats PERIOD normal draws


def _state(jcfg):
    import jax
    import numpy as np

    from domain_transfer_gan_tpu.models.state import init_state

    shapes = jax.eval_shape(lambda k: init_state(jcfg, k, image_size=64)[1],
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(SEED)

    def draw(scale, positive=False):
        def f(a):
            v = scale * rng.randn(PERIOD)
            v = np.resize(np.square(v) if positive else v, a.shape)
            return v.astype(a.dtype)
        return f

    params = jax.tree_util.tree_map(draw(0.05), shapes.params)
    opt = {k: type(v)(count=np.asarray(5 + i, np.int32),
                      mu=jax.tree_util.tree_map(draw(1e-3), v.mu),
                      nu=jax.tree_util.tree_map(draw(1e-3, True), v.nu))
           for i, (k, v) in enumerate(sorted(shapes.opt_state.items()))}
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.ones if p[-1].key == "var" else np.zeros)(
            a.shape, a.dtype), shapes.batch_stats)
    ema = {k: jax.tree_util.tree_map(draw(0.05), v)
           for k, v in shapes.ema.items()}
    state = shapes.replace(params=params, opt_state=opt, batch_stats=stats,
                           pools={}, ema=ema, step=np.asarray(40, np.int32))
    return jax.tree_util.tree_map(jax.numpy.asarray, state)


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax
    import numpy as np
    jax.config.update("jax_platforms", "cpu")

    from domain_transfer_gan_tpu.config import TrainConfig
    from domain_transfer_gan_tpu.models.api import _CycleGANBase
    from domain_transfer_gan_tpu.utils.checkpoint import OrbaxCheckpointer

    class Shell:
        """The JAX package's checkpoint methods on a drawn state."""

        save = _CycleGANBase.save
        wait_for_saves = _CycleGANBase.wait_for_saves
        _ckpt_payload = _CycleGANBase._ckpt_payload
        _orbax = _CycleGANBase._orbax

    jcfg = TrainConfig(**FLAGS)
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    jcfg.expr_dir = OUT
    shell = Shell()
    shell.opt, shell.state = jcfg, _state(jcfg)
    shell.old_lr, shell.epoch = 1.5e-4, 3
    shell.save("latest")
    shell.wait_for_saves()
    with open(os.path.join(OUT, "opt.json"), "w") as f:
        # the directory is found by where it lies, not by a stored path
        json.dump(dict(dataclasses.asdict(jcfg), expr_dir=""), f, indent=1,
                  sort_keys=True)
    tree = OrbaxCheckpointer().restore(os.path.join(OUT, "latest"),
                                       shell._ckpt_payload())
    leaves = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        name = ".".join(getattr(k, "key", getattr(k, "name", None))
                        for k in path)
        leaves[name] = {"dtype": a.dtype.str, "shape": list(a.shape),
                        "sha256": hashlib.sha256(a.tobytes("C")).hexdigest()}
    with open(os.path.join(OUT, "leaves.json"), "w") as f:
        json.dump(leaves, f, indent=0, sort_keys=True, separators=(",", ":"))
    size = sum(os.path.getsize(os.path.join(d, n))
               for d, _, ns in os.walk(OUT) for n in ns)
    print("wrote %s: %d leaves, %d bytes" % (OUT, len(leaves), size))


if __name__ == "__main__":
    main()
