"""Serving export: write the two generators as a serving artifact.

The JAX package serialises each generator as a StableHLO module with the
parameters baked in, which any XLA runtime can run without the model code.
That format has no counterpart here that could carry a hand-built CUDA
kernel, so the port's artifact is **data**, and the port's own model code
loads it: the serving batch, dtype and architecture in ``manifest.json`` and
the weights as plain ``state_dict``s.

Artifacts written under --out:
  predict_B.pt    float32 state_dict of netG_A_B   (A + z -> fake_B)
  predict_A.pt    float32 state_dict of netG_B_A   (B -> fake_A)
  manifest.json   the JAX manifest's keys (batch, grid_size, input_nc,
                  output_nc, nlatent, model, serve_dtype, functions,
                  platforms) plus what rebuilds the nets (ngf, n_blocks,
                  norm, use_dropout, init_scheme)

The ``.pt`` files hold tensors only and are read with
``torch.load(weights_only=True)``.  ``--serve_dtype bfloat16`` makes the
loaded generators run their convs and Linear layers in bf16 (norm statistics
and affine stay fp32); the I/O contract stays float32 either way.

Usage:
  python -m domain_transfer_gan_torch.cli.export \
      --chk_path checkpoints/exp1/latest --out exp1_export \
      [--batch 32] [--serve_dtype bfloat16] [--use_ema 1] [--device cuda]

The weights come from exactly one of: ``--chk_path``, a checkpoint that the
port's training CLI wrote (its directory holds the run's ``opt.json``);
``--params``, an ``.npz`` with flat keys in the JAX package's layout
(``netG_A_B/conv0/kernel`` ...), with ``--expr_dir`` naming the directory of
``opt.json``; ``--init_seed N``, weights drawn from seed N (with
``--expr_dir``).  ``--chk_path`` may be a JAX package checkpoint as well (a
flax file, or an orbax directory of ``--ckpt_backend orbax``).
``--use_ema 1`` exports the EMA shadow weights of a run trained with
``--ema``.

Round-trip loading: :func:`load_exported`, which also loads the JAX
package's export directory (``predict_{A,B}.stablehlo``, written by its
``cli/export.py`` for any platforms) and runs it with the port's StableHLO
interpreter, without JAX.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..config import TrainConfig, load_train_config_from_expr_dir
from ..eval.stablehlo import Program
from ..models.api import DTYPES, create_model
from ..nn import networks as N
from ..utils import jax_export

_FILES = {"predict_B": "netG_A_B", "predict_A": "netG_B_A"}


def export_model(model, out_dir: str, batch: int = 32, device="cuda"):
    """Write predict_B / predict_A at a fixed serving batch; returns the
    manifest.  ``device`` names the platform the artifact is meant to be
    served on and is recorded as ``platforms``; a server on another platform
    refuses the artifact."""
    os.makedirs(out_dir, exist_ok=True)
    opt = model.opt
    hw = opt.grid_size
    manifest = {
        "batch": batch, "grid_size": hw,
        "input_nc": opt.input_nc, "output_nc": opt.output_nc,
        "nlatent": opt.nlatent, "model": opt.model,
        "serve_dtype": opt.compute_dtype,
        "functions": {
            "predict_B": {"args": [
                ["A", [batch, hw, hw, opt.input_nc], "float32"],
                ["z", [batch, opt.nlatent], "float32"]]},
            "predict_A": {"args": [
                ["B", [batch, hw, hw, opt.output_nc], "float32"]]},
        },
        "platforms": [torch.device(device).type],
        "ngf": opt.ngf, "n_blocks": opt.n_blocks, "norm": opt.norm,
        "use_dropout": bool(opt.use_dropout),
        "init_scheme": opt.init_scheme,
    }
    for fn_name, net_name in _FILES.items():
        sd = {k: v.detach().to("cpu", torch.float32).contiguous()
              for k, v in model.nets[net_name].state_dict().items()}
        torch.save(sd, os.path.join(out_dir, fn_name + ".pt"))
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def artifact_kind(out_dir: str) -> str:
    """``"pt"`` for a directory this module wrote (``predict_{A,B}.pt``),
    ``"stablehlo"`` for one the JAX package's ``cli/export.py`` wrote
    (``predict_{A,B}.stablehlo``, no ``.pt``); anything else is refused,
    naming the files found."""
    files = sorted(os.listdir(out_dir))
    kinds = [k for k in ("pt", "stablehlo")
             if any(f.endswith("." + k) for f in files)]
    if len(kinds) == 1 and all(n + "." + kinds[0] in files for n in _FILES):
        return kinds[0]
    raise ValueError(
        "%s holds %s: an export directory holds predict_B.pt and "
        "predict_A.pt (the port's cli.export) or predict_B.stablehlo and "
        "predict_A.stablehlo (the JAX package's cli.export), not both"
        % (out_dir, ", ".join(files) or "no file"))


def load_exported(out_dir: str, name: str, device="cuda"):
    """Load one exported generator; returns a callable over NHWC tensors at
    the artifact's fixed batch: ``fn(A, z)`` for ``predict_B``, ``fn(B)``
    for ``predict_A``.  The answer is a float32 tensor on ``device``.
    ``plain_norm=True`` (for tests) runs every norm through the kernel's
    plain version.

    A directory of the JAX package's export (:func:`artifact_kind`) is run
    by the StableHLO interpreter instead (:func:`_load_stablehlo`)."""
    if name not in _FILES:
        raise ValueError("unknown function %r (have %s)"
                         % (name, ", ".join(_FILES)))
    with open(os.path.join(out_dir, "manifest.json")) as f:
        m = json.load(f)
    if artifact_kind(out_dir) == "stablehlo":
        return _load_stablehlo(out_dir, name, m, device)
    kw = dict(ngf=m["ngf"], n_blocks=m["n_blocks"],
              use_dropout=m["use_dropout"], init_scheme=m["init_scheme"])
    if name == "predict_B":
        net = N.define_stochastic_G(m["nlatent"], m["input_nc"],
                                    m["output_nc"], **kw)
    else:
        net = N.define_G(m["output_nc"], m["input_nc"], norm=m["norm"], **kw)
    sd = torch.load(os.path.join(out_dir, name + ".pt"), map_location="cpu",
                    weights_only=True)
    net.load_state_dict(sd, strict=True)
    device = torch.device(device)
    net.place(device, DTYPES[m["serve_dtype"]]).eval().requires_grad_(False)
    batch = int(m["batch"])
    ones_z = name == "predict_B" and m["model"] == "cycle_gan"

    def fn(*args: torch.Tensor, plain_norm: bool = False) -> torch.Tensor:
        _check_batch(name, batch, args)
        # inference_mode is thread-local: enter it on the calling thread
        with torch.inference_mode():
            args = [a.to(device) for a in args]
            if ones_z:  # cycle_gan: z == 1
                args[1] = torch.ones_like(args[1])
            return net(*args, plain_norm=plain_norm).float()

    return fn


def _check_batch(name, batch, args):
    if any(a.shape[0] != batch for a in args):
        raise ValueError("%s was exported at batch %d, got %s"
                         % (name, batch, [tuple(a.shape) for a in args]))


def _load_stablehlo(out_dir: str, name: str, m: dict, device):
    """One function of the JAX package's export directory, run by
    ``eval/stablehlo.py::Program`` on ``device`` whatever platforms it was
    lowered for: its module is read and checked here (the envelope, the
    manifest's arguments and output, every op), and called with the
    ``_platform_index`` its platforms give and the arguments it keeps."""
    path = os.path.join(out_dir, name + ".stablehlo")
    nc = m["output_nc" if name == "predict_B" else "input_nc"]
    out_shape = [m["batch"], m["grid_size"], m["grid_size"], nc]
    exp = jax_export.check_serving(
        jax_export.load(path), m["functions"][name]["args"], out_shape,
        where=path)
    if list(exp.platforms) != m["platforms"]:
        raise jax_export.ExportFormatError(
            "%s: platforms = %s, manifest.json says %s" % (
                path, list(exp.platforms), m["platforms"]))
    program = Program(exp.mlir_module_serialized, device=device)
    lead = []
    if exp.platform_index is not None:
        lead = [torch.tensor(exp.platform_index, dtype=torch.int32,
                             device=program.device)]
    kept = exp.module_kept_var_idx
    batch = int(m["batch"])

    def fn(*args: torch.Tensor, plain_norm: bool = False) -> torch.Tensor:
        if plain_norm:
            raise ValueError(
                "plain_norm=True: %s is interpreted StableHLO, which runs no "
                "hand-written kernel, so there is no norm kernel to switch "
                "to its plain version" % path)
        _check_batch(name, batch, args)
        with torch.inference_mode():
            args = [args[i].to(program.device) for i in kept]
            return program(*lead, *args)[0].float()

    return fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chk_path", default=None,
                    help="a checkpoint of the port's training CLI "
                         "(expr_dir/latest, best_A, best_B)")
    ap.add_argument("--expr_dir", default=None,
                    help="experiment directory holding opt.json (default: "
                         "the directory of --chk_path)")
    ap.add_argument("--params", default=None,
                    help="params .npz with flat keys in the JAX package's "
                         "layout (netG_A_B/conv0/kernel ...)")
    ap.add_argument("--init_seed", type=int, default=None,
                    help="export weights drawn from this seed instead of "
                         "--params")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--serve_dtype", choices=["float32", "bfloat16"],
                    default=None, help="compute dtype of the served "
                    "generators (default: the run's compute_dtype)")
    ap.add_argument("--use_ema", type=int, choices=[0, 1], default=0,
                    help="export the EMA shadow weights (--ema runs)")
    ap.add_argument("--device", default="cuda",
                    help="where the model is built, and the platform the "
                         "artifact is served on")
    args = ap.parse_args(argv)
    sources = [a for a in (args.chk_path, args.params, args.init_seed)
               if a is not None]
    if len(sources) != 1:
        ap.error("give exactly one of --chk_path, --params and --init_seed")
    expr_dir = args.expr_dir or (os.path.dirname(os.path.abspath(
        args.chk_path)) if args.chk_path else None)
    if expr_dir is None:
        ap.error("--params and --init_seed need --expr_dir")

    opt: TrainConfig = load_train_config_from_expr_dir(expr_dir)
    if args.serve_dtype:
        opt.compute_dtype = args.serve_dtype
    if args.init_seed is not None:
        opt.seed = args.init_seed
    model = create_model(opt, testing=True, device=args.device)
    if args.chk_path is not None:
        model.load(args.chk_path)
    elif args.params is not None:
        model.load_params(args.params)
    if args.use_ema:
        if not model.state.ema:
            raise ValueError("--use_ema 1 needs a checkpoint trained with "
                             "--ema")
        model.swap_ema()
    manifest = export_model(model, args.out, batch=args.batch,
                            device=args.device)
    print("exported %s -> %s (%s)" % (
        args.chk_path or args.params or "seed %d" % opt.seed, args.out,
        ", ".join(manifest["functions"])))


if __name__ == "__main__":
    main()
