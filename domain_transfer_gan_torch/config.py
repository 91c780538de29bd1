"""Typed experiment configuration.

The port keeps its own copy of the JAX package's ``TrainConfig`` with every
field under the same name and default, so an ``opt.json`` / ``opt.pkl`` /
``opt.txt`` written by either package loads here.  Fields that only steer the
TPU runtime (mesh axes, host-device emulation, Pallas switch, ...) are kept
as inert data: nothing in the port reads them.  There is no command-line
parser yet; the training slice adds it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from dataclasses import dataclass
from typing import List, Optional


def create_sub_dirs(opt, sub_dirs):
    """mkdir + setattr(opt, name, path) for each visualisation sub-directory."""
    paths = {}
    for sub_dir in sub_dirs:
        dir_path = os.path.join(opt.expr_dir, sub_dir)
        os.makedirs(dir_path, exist_ok=True)
        setattr(opt, sub_dir, dir_path)
        paths[sub_dir] = dir_path
    return paths


@dataclass
class TrainConfig:
    """All training flags, under the names and defaults of the JAX package."""

    # required
    dataroot: str = ""
    name: str = ""
    checkpoints_dir: str = "./checkpoints/"

    # data
    input_nc: int = 3
    output_nc: int = 3
    grid_size: int = 256
    numpy_data: int = 1
    nThreads: int = 4

    # exp
    seed: Optional[int] = None
    model: str = "aug_cycle_gan"   # {cycle_gan, stoch_cycle_gan, aug_cycle_gan}
    gpu_ids: str = "0"

    # supervised training
    supervised: bool = False
    sup_frac: float = 0.1
    lambda_sup_A: float = 0.1
    lambda_sup_B: float = 0.1

    # training
    batchSize: int = 32
    continue_train: bool = False
    which_epoch: str = "latest"
    epoch_count: int = 1
    niter: int = 25
    niter_decay: int = 25
    beta1: float = 0.5
    lr: float = 2e-4

    # model
    ngf: int = 32
    nef: int = 32
    ndf: int = 64
    nlatent: int = 16
    which_model_netD: str = "basic"
    which_model_netG: str = "resnet"
    norm: str = "instance"         # {instance, batch}
    use_dropout: bool = False
    max_gnorm: float = 500.0
    stoch_enc: bool = False
    z_gan: int = 1
    enc_A_B: int = 1
    no_lsgan: bool = False
    lambda_A: float = 1.0
    lambda_B: float = 1.0
    lambda_z_B: float = 0.025

    # monitoring
    monitor_gnorm: bool = True
    display_freq: int = 5000
    print_freq: int = 100
    save_epoch_freq: int = 5
    num_multi: int = 10
    eval_A_freq: int = 1
    eval_B_freq: int = 1

    # extras of the JAX package
    n_blocks: int = 3              # residual blocks per generator
    init_scheme: str = "reference"  # {reference, sane}
    use_pallas: bool = False       # inert here: the port's norms always run
    #                                the fused kernel on a CUDA tensor
    compute_dtype: str = "float32"  # {float32, bfloat16} conv compute dtype
    data_axis: str = "data"        # inert (TPU mesh)
    num_devices: int = 0           # inert (TPU mesh)
    spatial: int = 0               # inert (TPU mesh)
    tensor: int = 0                # inert (TPU mesh)
    pipeline: int = 0              # inert (TPU mesh)
    microbatches: int = 0          # inert (TPU mesh)
    host_devices: int = 0          # inert (TPU runtime)
    dev_size: int = 200
    legacy_eval_constants: bool = False
    profile_dir: str = ""
    remat: bool = False
    pool_size: int = 0
    resize_antialias: int = 1
    ckpt_backend: str = "flax"
    check_numerics: int = 0
    ema: float = 0.0
    d_lr_mode: str = "reference"
    grad_accum: int = 1
    device_data: int = -1
    device_data_max_gb: float = 2.0
    coordinator: str = ""          # inert (multi-host)
    num_processes: int = 0         # inert (multi-host)
    process_id: int = -1           # inert (multi-host)

    # derived (filled by finalize / the loaders)
    expr_dir: str = ""
    use_sigmoid: bool = False      # set from no_lsgan

    def __post_init__(self):
        self.use_sigmoid = self.no_lsgan

    @property
    def gpu_id_list(self) -> List[int]:
        out = []
        for s in str(self.gpu_ids).split(","):
            s = s.strip()
            if s and int(s) >= 0:
                out.append(int(s))
        return out

    def finalize(self, sub_dirs=None):
        """Create expr_dir, dump opt.txt/opt.json/opt.pkl, make vis dirs."""
        self.use_sigmoid = self.no_lsgan
        self.expr_dir = os.path.join(self.checkpoints_dir, self.name)
        os.makedirs(self.expr_dir, exist_ok=True)

        args = dict(vars(self))
        lines = ["------------ Options -------------"]
        for k in sorted(args):
            lines.append("%s: %s" % (str(k), str(args[k])))
        lines.append("-------------- End ----------------")
        with open(os.path.join(self.expr_dir, "opt.txt"), "wt") as f:
            f.write("\n".join(lines) + "\n")
        with open(os.path.join(self.expr_dir, "opt.json"), "wt") as f:
            json.dump(args, f, indent=2, default=str)
        with open(os.path.join(self.expr_dir, "opt.pkl"), "wb") as f:
            pickle.dump(args, f)

        if sub_dirs is not None:
            create_sub_dirs(self, sub_dirs)
        return self


def parse_opt_file(opt_path: str) -> dict:
    """Read a saved option dump (opt.json / opt.pkl / opt.txt).

    Only load an ``opt.pkl`` that this program or the JAX package wrote:
    unpickling can run code.
    """
    if opt_path.endswith(".json"):
        with open(opt_path) as f:
            return json.load(f)
    if opt_path.endswith(".pkl"):
        with open(opt_path, "rb") as f:
            return pickle.load(f)

    def parse_val(s):
        if s == "None":
            return None
        if s == "True":
            return True
        if s == "False":
            return False
        try:
            f = float(s)
        except ValueError:
            return s
        # non-finite floats and decimal notation stay float; everything
        # else round-trips through int when exact
        if "." in s or f != f or f in (float("inf"), float("-inf")):
            return f
        i = int(f)
        return i if i == f else f

    opt = {}
    with open(opt_path) as f:
        for line in f:
            if line.startswith("-----"):
                continue
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            opt[k.strip()] = parse_val(v.strip())
    return opt


def load_train_config_from_expr_dir(expr_dir: str, **overrides) -> TrainConfig:
    """Restore a TrainConfig from a saved experiment dir (opt.json preferred)."""
    for fname in ("opt.json", "opt.pkl", "opt.txt"):
        path = os.path.join(expr_dir, fname)
        if os.path.exists(path):
            d = parse_opt_file(path)
            break
    else:
        raise FileNotFoundError("no opt.{json,pkl,txt} in %s" % expr_dir)
    names = {f.name for f in dataclasses.fields(TrainConfig)}
    kwargs = {k: v for k, v in d.items() if k in names}
    kwargs.update(overrides)
    cfg = TrainConfig(**kwargs)
    cfg.expr_dir = expr_dir
    return cfg
