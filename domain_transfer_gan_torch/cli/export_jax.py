"""Write a checkpoint as the JAX package's own (flax msgpack), so that a run
moves from the port to the JAX package mid-training.

Reads any checkpoint the port's ``load`` takes (the port's ``torch.save``
format, a JAX-package flax file or orbax directory) and writes ``--out`` in the JAX package's
format: the tree its ``_ckpt_payload()`` serialises (params, batch_stats,
opt_state, pools, step, old_lr, epoch and, with ``--ema``, the shadows),
which its ``load`` restores and its ``--continue_train`` resumes.  The
other direction needs no tool: the port's ``load`` reads a JAX file, so
``--continue_train`` on a JAX expr_dir, ``cli/test.py --chk_path`` and
``cli/export.py --chk_path`` take one as it is.  (A run of the port with
``--ckpt_backend orbax`` writes orbax directories, which the JAX package
reads as they are.)

The architecture comes from the ``opt.json`` (or ``opt.txt``) beside the
checkpoint, or from ``--opt``.  Where ``--out``'s directory holds no
``opt.json``, the options are written there too.

    python -m domain_transfer_gan_torch.cli.export_jax \\
        --chk_path ./exp/latest --out ./exp_jax/latest [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..models import create_model
from .import_torch import _restore_cfg
from .train import _device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--chk_path", type=str, required=True,
                    help="checkpoint to convert (the port's or the JAX "
                         "package's)")
    ap.add_argument("--out", type=str, required=True,
                    help="path of the JAX-package checkpoint to write")
    ap.add_argument("--opt", type=str, default="",
                    help="opt.{json,txt} or experiment dir describing the "
                         "architecture (default: the checkpoint's dir)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device the model is built on (cpu for "
                         "tests)")
    args = ap.parse_args(argv)

    cfg = _restore_cfg(args.opt, args.chk_path, args.device)
    model = create_model(cfg, testing=True, device=_device(cfg))
    model.load(args.chk_path)
    out = os.path.abspath(args.out)
    out_dir = os.path.dirname(out)
    os.makedirs(out_dir, exist_ok=True)
    model.save_jax(out)
    opt_json = os.path.join(out_dir, "opt.json")
    if not os.path.exists(opt_json):
        with open(opt_json, "w") as f:
            json.dump(dict(vars(model.opt)), f, indent=2, default=str)
    print("wrote JAX-package checkpoint: %s (epoch %d, step %d)"
          % (out, model.epoch, int(model.state.step)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
