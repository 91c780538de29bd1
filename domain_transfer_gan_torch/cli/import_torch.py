"""Checkpoint migration between the upstream PyTorch implementation and the
port.

Forward (default): read a checkpoint that upstream's ``model.save`` wrote
(a ``torch.save`` dict of per-net state dicts and Adam states) and write it
as a checkpoint of the port (format 2) at ``--out``, with parameters,
batch-norm running statistics and Adam moments, so that
``cli/train.py --continue_train`` resumes from it and ``cli/test.py`` and
``cli/export.py`` read it.  The checkpoint records epoch ``epoch_count - 1``
(no epoch of this package trained yet), so a resumed run trains the whole
schedule from the imported weights.  Where ``--out``'s directory holds no
``opt.json``, the architecture's options are written there too.

Reverse (``--export``): write a checkpoint of the port in upstream's format.

The architecture comes from an ``opt.txt`` / ``opt.json`` / ``opt.pkl``
beside the checkpoint (upstream and the port write the same flag names) or
from ``--opt``.  The model is built on ``--device`` (default ``cuda``; the
CPU only when asked for).

    python -m domain_transfer_gan_torch.cli.import_torch \\
        --torch_chk /upstream/checkpoints/exp/latest --out ./exp/latest
    python -m domain_transfer_gan_torch.cli.import_torch --export \\
        --chk ./exp/best_B --torch_out ./exp_upstream/best_B
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from ..config import TrainConfig, load_train_config_from_expr_dir, \
    parse_opt_file
from ..models import create_model
from ..utils.torch_interop import export_torch_checkpoint, \
    import_torch_checkpoint
from .train import _device


def _restore_cfg(opt_path: str, chk_path: str, device: str) -> TrainConfig:
    if opt_path and not os.path.isdir(opt_path):
        d = parse_opt_file(opt_path)
        names = {f.name for f in dataclasses.fields(TrainConfig)}
        cfg = TrainConfig(**{k: v for k, v in d.items() if k in names})
        cfg.expr_dir = os.path.dirname(os.path.abspath(opt_path))
    else:
        cfg = load_train_config_from_expr_dir(
            opt_path or os.path.dirname(os.path.abspath(chk_path)))
    cfg.device = device
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--torch_chk", type=str, default="",
                    help="upstream torch checkpoint to import")
    ap.add_argument("--out", type=str, default="",
                    help="path of the port's checkpoint to write (default: "
                         "<torch_chk>.port)")
    ap.add_argument("--opt", type=str, default="",
                    help="opt.{txt,json,pkl} or experiment dir describing the "
                         "architecture (default: the checkpoint's dir)")
    ap.add_argument("--no_optimizers", action="store_true",
                    help="import parameters and statistics only, fresh Adam "
                         "state")
    ap.add_argument("--export", action="store_true",
                    help="reverse direction: the port's checkpoint -> torch")
    ap.add_argument("--chk", type=str, default="",
                    help="[--export] the port's checkpoint to export")
    ap.add_argument("--torch_out", type=str, default="",
                    help="[--export] upstream checkpoint to write (default: "
                         "<chk>.pt)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device the model is built on (cpu for "
                         "tests)")
    args = ap.parse_args(argv)

    if args.export:
        if not args.chk:
            ap.error("--export requires --chk")
        cfg = _restore_cfg(args.opt, args.chk, args.device)
        model = create_model(cfg, testing=True, device=_device(cfg))
        model.load(args.chk)
        out = args.torch_out or args.chk + ".pt"
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        for line in export_torch_checkpoint(model, out):
            print(line)
        print("wrote torch checkpoint:", out)
        return 0

    if not args.torch_chk:
        ap.error("--torch_chk is required (or use --export)")
    cfg = _restore_cfg(args.opt, args.torch_chk, args.device)
    model = create_model(cfg, testing=True, device=_device(cfg))
    for line in import_torch_checkpoint(
            args.torch_chk, model, import_optimizers=not args.no_optimizers):
        print(line)
    out = os.path.abspath(args.out or args.torch_chk + ".port")
    expr_dir, chk_name = os.path.split(out)
    os.makedirs(expr_dir, exist_ok=True)
    model.opt.expr_dir = expr_dir
    # the payload's epoch is the last one completed; --continue_train
    # resumes at epoch + 1
    model.epoch = model.opt.epoch_count - 1
    model.save(chk_name)
    opt_json = os.path.join(expr_dir, "opt.json")
    if not os.path.exists(opt_json):
        with open(opt_json, "w") as f:
            json.dump(dict(vars(model.opt)), f, indent=2, default=str)
    print("wrote checkpoint:", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
