"""Regenerate ``tests/fixtures/jax_serve/``: export directories written by the
JAX package's own ``cli/export.py::export_model``, which the port's
``cli/serve.py`` serves without JAX.

Each directory holds ``predict_B.stablehlo``, ``predict_A.stablehlo`` and
``manifest.json`` as ``export_model`` writes them (the modules rewritten
without locations, :func:`make_jax_export_fixtures.with_module`, so no
source path of the machine that made them is kept).  Beside each directory
``<name>.outputs.npz`` holds ``exp.call``'s outputs, run on the CPU with the
artifact's first platform named ``cpu`` (its StableHLO has no custom call),
on the inputs ``jax_serve_inputs.py`` draws from the seed in
``index.json``.

- tiny (ngf 4, nlatent 8, 3 blocks, 64x64, batch 2): ``aug_f32_tpu``;
  ``aug_bf16_tpu`` (the same weights and inputs, ``--serve_dtype
  bfloat16``); ``cycle_f32_tpu`` (``cycle_gan``: the module drops z);
  ``aug_f32_cpu_tpu`` (lowered for ``["cpu", "tpu"]``: the module takes
  ``_platform_index``); ``aug_f32_s2_tpu`` and ``aug_bf16_s2_tpu``, a
  float32 / bfloat16 pair on the weights of seed 2, a draw whose bfloat16
  answer ``exp.call`` puts 0.14 from its float32 one.  The weights of a
  float32 directory are beside it as ``params.npz`` (flat keys in the JAX
  layout, ``netG_A_B/conv0/kernel`` ..., the file the port's ``cli.export
  --params`` reads); ``index.json`` names, for each directory, the one
  whose ``params.npz`` holds its weights (``params``) and, for a bfloat16
  one, its float32 twin (``float32``);
- full width: ``aug_full_f32_tpu``, ``aug_cycle_gan`` at ngf 32, nlatent 16,
  3 blocks, 64x64, batch 32, lowered for ``tpu``.

The generators' weights are drawn with numpy (``randomize`` of
``tests/torch_port_helpers.py``: O(1) activations, so an error is not hidden
behind outputs near zero).  The script prints each function's file size,
platforms and kept arguments, and how far the port's interpreted answer
(``cli/export.py::load_exported`` on the CPU) is from ``exp.call``'s.  For
a bfloat16 directory it also prints how far both are from the float32
``exp.call`` of the same weights, and the witness of where bfloat16 is
rounded: ``exp.call`` compiled with ``xla_allow_excess_precision`` off
(XLA then rounds after every op) and the interpreter made to round after
every op too (``Program._widened`` emptied), each against the other and
against the default ``exp.call``.

    python tests/fixtures/make_jax_serve_fixtures.py
"""

import json
import os
import shutil
import sys
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "jax_serve")

TINY = dict(grid_size=64, ngf=4, nef=4, ndf=4, nlatent=8, n_blocks=3)
FULL = dict(grid_size=64, ngf=32, nef=32, ndf=64, nlatent=16, n_blocks=3)
# name -> (model, serve dtype, platforms, widths, batch, seed); the weights
# are drawn from the seed, so directories of one seed share them
DIRS = {
    "aug_f32_tpu": ("aug_cycle_gan", "float32", ["tpu"], TINY, 2, 1),
    "aug_bf16_tpu": ("aug_cycle_gan", "bfloat16", ["tpu"], TINY, 2, 1),
    "cycle_f32_tpu": ("cycle_gan", "float32", ["tpu"], TINY, 2, 3),
    "aug_f32_cpu_tpu": ("aug_cycle_gan", "float32", ["cpu", "tpu"], TINY, 2,
                        4),
    "aug_f32_s2_tpu": ("aug_cycle_gan", "float32", ["tpu"], TINY, 2, 2),
    "aug_bf16_s2_tpu": ("aug_cycle_gan", "bfloat16", ["tpu"], TINY, 2, 2),
    "aug_full_f32_tpu": ("aug_cycle_gan", "float32", ["tpu"], FULL, 32, 5),
}


# a bfloat16 directory -> the float32 one of the same weights, whose
# params.npz holds them
TWINS = {"aug_bf16_tpu": "aug_f32_tpu", "aug_bf16_s2_tpu": "aug_f32_s2_tpu"}


def params_dir(name):
    """The directory whose ``params.npz`` holds ``name``'s weights (None at
    full width)."""
    return None if DIRS[name][3] is FULL else TWINS.get(name, name)


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    root = os.path.dirname(os.path.dirname(HERE))
    sys.path[:0] = [root, os.path.dirname(HERE), HERE]
    import dataclasses

    import jax
    import torch
    import jax.numpy as jnp
    import numpy as np
    from jax import export as jax_export

    from domain_transfer_gan_tpu.cli.export import export_model
    from domain_transfer_gan_tpu.config import TrainConfig
    from domain_transfer_gan_tpu.models import create_model
    from jax_serve_inputs import inputs
    from make_jax_export_fixtures import with_module
    from torch_port_helpers import randomize

    from domain_transfer_gan_torch.cli.export import load_exported
    from domain_transfer_gan_torch.eval.stablehlo import Program
    from domain_transfer_gan_torch.utils.convert import flatten_params

    def witness(name, d, fn, args, want):
        """Where bfloat16 is rounded: every op, in XLA and in the
        interpreter, against XLA's and the interpreter's defaults."""
        with open(os.path.join(d, fn + ".stablehlo"), "rb") as f:
            exp = jax_export.deserialize(f.read())
        on_cpu = dataclasses.replace(exp, platforms=("cpu",))
        xs = list(map(jnp.asarray, args))
        xla_each = np.asarray(jax.jit(on_cpu.call).lower(*xs).compile(
            compiler_options={"xla_allow_excess_precision": False})(*xs))
        run = load_exported(d, fn, "cpu")
        with mock.patch.object(Program, "_widened", lambda self, b: set()):
            each = load_exported(d, fn, "cpu")
        got, got_each = (f(*map(torch.from_numpy, args)).numpy()
                         for f in (run, each))
        print("%-16s %-9s rounding after every op: XLA - exp.call %.3g, "
              "interpreted - XLA %.3g, interpreted - exp.call %.3g; "
              "XLA's - the interpreter's default %.3g" % (
                  name, fn, *[np.abs(a - b).max() for a, b in (
                      (xla_each, want), (got_each, xla_each),
                      (got_each, want), (xla_each, got))]))

    jax.config.update("jax_include_full_tracebacks_in_locations", False)
    jax.config.update("jax_traceback_in_locations_limit", 0)
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    index, answers = {}, {}
    for name, (model, dtype, platforms, widths, batch, seed) in DIRS.items():
        d = os.path.join(OUT, name)
        cfg = TrainConfig(model=model, compute_dtype=dtype, use_pallas=False,
                          seed=seed, **widths)
        cfg.expr_dir = ""
        m = create_model(cfg, testing=True)
        params = dict(m.state.params)
        gens = {}
        for j, net in enumerate(("netG_A_B", "netG_B_A")):
            gens[net] = randomize(params[net], 100 * seed + j)
            params[net] = jax.tree_util.tree_map(jnp.asarray, gens[net])
        m.state = m.state.replace(params=params)
        manifest = export_model(m, d, batch=batch, platforms=platforms)
        if params_dir(name) == name:
            np.savez(os.path.join(d, "params.npz"), **flatten_params(gens))
        x = inputs(manifest, seed)
        outs = {}
        for fn, args in (("predict_B", (x["A"], x["z"])),
                         ("predict_A", (x["B"],))):
            path = os.path.join(d, fn + ".stablehlo")
            with open(path, "rb") as f:
                exp = jax_export.deserialize(f.read())
            exp = with_module(exp, exp.mlir_module())
            with open(path, "wb") as f:
                f.write(exp.serialize())
            on_cpu = dataclasses.replace(
                exp, platforms=("cpu",) + exp.platforms[1:])
            outs[fn] = np.asarray(on_cpu.call(*map(jnp.asarray, args)))
            got = load_exported(d, fn, "cpu")(*map(torch.from_numpy, args))
            answers[name, fn] = outs[fn], got.numpy()
            err = np.abs(got.numpy() - outs[fn])
            print("%-16s %-9s %8d bytes  platforms %s  kept %s  max |y| "
                  "%.4f  interpreted - exp.call: max %.3g mean %.3g"
                  % (name, fn, os.path.getsize(path), list(exp.platforms),
                     list(exp.module_kept_var_idx), np.abs(outs[fn]).max(),
                     err.max(), err.mean()))
        np.savez(os.path.join(OUT, name + ".outputs.npz"), **outs)
        index[name] = {"model": model, "serve_dtype": dtype,
                       "platforms": platforms, "batch": batch, "seed": seed,
                       "params": params_dir(name), **widths}
        if name in TWINS:
            index[name]["float32"] = TWINS[name]
            for fn, args in (("predict_B", (x["A"], x["z"])),
                             ("predict_A", (x["B"],))):
                witness(name, d, fn, args, outs[fn])
            for fn in outs:
                want = answers[TWINS[name], fn][0]
                print("%-16s %-9s from the float32 exp.call: exp.call max %.3g"
                      " mean %.3g, interpreted max %.3g mean %.3g" % (
                          name, fn, *[g(np.abs(y - want)) for y in
                                      answers[name, fn]
                                      for g in (np.max, np.mean)]))
    with open(os.path.join(OUT, "index.json"), "w") as f:
        json.dump(index, f, indent=1)
    total = sum(os.path.getsize(os.path.join(p, f))
                for p, _, fs in os.walk(OUT) for f in fs)
    print("%s: %d bytes" % (OUT, total))


if __name__ == "__main__":
    main()
