"""Typed experiment configuration.

The port keeps its own copy of the JAX package's ``TrainConfig`` with every
field under the same name and default, so an ``opt.json`` / ``opt.pkl`` /
``opt.txt`` written by either package loads here, plus one field of its own,
``device`` (default ``cuda``).  Fields that only steer the TPU runtime
(``host_devices``, ``data_axis``) are kept as inert data.

:class:`TrainOptions` is the training CLI's parser: the JAX package's flag
names, defaults and choices, plus ``--device``.  The instance norms always
run the hand-written CUDA kernels on a CUDA device (their plain PyTorch
versions on a CPU tensor), so ``--use_pallas`` is accepted and selects
nothing, like the TPU runtime's flags.  ``--ckpt_backend orbax`` writes the
JAX package's orbax checkpoint directories (``utils/orbax_dir.py``); no
flag is ignored silently.  ``README.md`` lists the flags that are accepted
and have no effect.

:class:`TestOptions` is the evaluation CLI's parser (:class:`TestConfig`):
the JAX package's flags with ``--device`` in place of ``--host_devices``;
``--fid_extractor`` (a ``jax.export`` file) is read by
``eval/fid.py::load_extractor``.
"""

from __future__ import annotations

import argparse
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
    num_devices: int = 0           # local ranks; 0 = every visible card
    spatial: int = 0               # ranks an image's rows are sliced over
    tensor: int = 0                # ranks the large weights are sliced over
    pipeline: int = 0              # GPipe stages of the generators' trunks
    microbatches: int = 0          # pipeline microbatches (0 = stages)
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
    coordinator: str = ""          # multi-process: host:port or "auto"
    num_processes: int = 0         # multi-process: ranks in all
    process_id: int = -1           # multi-process: this process's rank
    device: str = "cuda"           # the port's own: where the CLI runs

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
        """Create expr_dir, dump opt.txt/opt.json/opt.pkl, make vis dirs.
        Rank r > 0 of a multi-process run (``--process_id``) writes under
        ``expr_dir/.worker<r>/`` only."""
        self.use_sigmoid = self.no_lsgan
        self.expr_dir = os.path.join(self.checkpoints_dir, self.name)
        if int(self.process_id) > 0:
            self.expr_dir = os.path.join(self.expr_dir,
                                         ".worker%d" % self.process_id)
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


class _PlainUnpickler(pickle.Unpickler):
    """Unpickles builtin values only: a class or function named in the file
    (the JAX package's own, for one) is refused, never imported."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            "%s.%s in an option dump: only plain values are read (use the "
            "opt.json beside it)" % (module, name))


def parse_opt_file(opt_path: str) -> dict:
    """Read a saved option dump (opt.json / opt.pkl / opt.txt).

    An ``opt.pkl`` is read with an unpickler that imports nothing, so a
    dump that names a class (the JAX package's, say) raises instead of
    running its code.
    """
    if opt_path.endswith(".json"):
        with open(opt_path) as f:
            return json.load(f)
    if opt_path.endswith(".pkl"):
        with open(opt_path, "rb") as f:
            return _PlainUnpickler(f).load()

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


class UnportedFlagError(NotImplementedError):
    """A flag that asks for a part of the JAX package the port does not
    run, and why it will not."""


def refuse_unported(cfg: TrainConfig) -> None:
    """The training CLI runs every flag of the JAX package's; what it
    cannot run here is refused by name: a paired-jpg dataroot (a ``train/``
    directory and no ``trainA.npz``) without PIL raises
    ``data.edges2shoes.PILMissingError``.  Nothing is written before this
    check."""
    if cfg.numpy_data:
        from .data.edges2shoes import require_pil_for
        require_pil_for(cfg.dataroot)


class TrainOptions:
    """argparse shim with the JAX package's flag surface plus ``--device``."""

    def __init__(self):
        self.parser = argparse.ArgumentParser()
        self.initialized = False

    def initialize(self):
        p = self.parser
        d = TrainConfig()  # defaults from the dataclass
        p.add_argument("--dataroot", type=str, required=True, help="path to data")
        p.add_argument("--name", type=str, required=True,
                       help="name of the experiment; decides where samples/models go")
        p.add_argument("--checkpoints_dir", type=str, default=d.checkpoints_dir)
        p.add_argument("--input_nc", type=int, default=d.input_nc)
        p.add_argument("--output_nc", type=int, default=d.output_nc)
        p.add_argument("--grid_size", type=int, default=d.grid_size)
        p.add_argument("--numpy_data", type=int, choices=[0, 1], default=d.numpy_data)
        p.add_argument("--nThreads", type=int, default=d.nThreads)
        p.add_argument("--seed", type=int, default=None)
        p.add_argument("--model", type=str, default=d.model,
                       choices=["cycle_gan", "stoch_cycle_gan", "aug_cycle_gan"])
        p.add_argument("--gpu_ids", type=str, default=d.gpu_ids)
        p.add_argument("--supervised", action="store_true")
        p.add_argument("--sup_frac", type=float, default=d.sup_frac)
        p.add_argument("--lambda_sup_A", type=float, default=d.lambda_sup_A)
        p.add_argument("--lambda_sup_B", type=float, default=d.lambda_sup_B)
        p.add_argument("--batchSize", type=int, default=d.batchSize)
        p.add_argument("--continue_train", action="store_true")
        p.add_argument("--which_epoch", type=str, default=d.which_epoch)
        p.add_argument("--epoch_count", type=int, default=d.epoch_count)
        p.add_argument("--niter", type=int, default=d.niter)
        p.add_argument("--niter_decay", type=int, default=d.niter_decay)
        p.add_argument("--beta1", type=float, default=d.beta1)
        p.add_argument("--lr", type=float, default=d.lr)
        p.add_argument("--ngf", type=int, default=d.ngf)
        p.add_argument("--nef", type=int, default=d.nef)
        p.add_argument("--ndf", type=int, default=d.ndf)
        p.add_argument("--nlatent", type=int, default=d.nlatent)
        p.add_argument("--which_model_netD", type=str, default=d.which_model_netD)
        p.add_argument("--which_model_netG", type=str, default=d.which_model_netG)
        p.add_argument("--norm", type=str, default=d.norm)
        p.add_argument("--use_dropout", action="store_true")
        p.add_argument("--max_gnorm", type=float, default=d.max_gnorm)
        p.add_argument("--stoch_enc", action="store_true")
        p.add_argument("--z_gan", type=int, default=d.z_gan, choices=[0, 1])
        p.add_argument("--enc_A_B", type=int, default=d.enc_A_B, choices=[0, 1])
        p.add_argument("--no_lsgan", action="store_true")
        p.add_argument("--lambda_A", type=float, default=d.lambda_A)
        p.add_argument("--lambda_B", type=float, default=d.lambda_B)
        p.add_argument("--lambda_z_B", type=float, default=d.lambda_z_B)
        p.add_argument("--monitor_gnorm", type=bool, default=d.monitor_gnorm)
        p.add_argument("--display_freq", type=int, default=d.display_freq)
        p.add_argument("--print_freq", type=int, default=d.print_freq)
        p.add_argument("--save_epoch_freq", type=int, default=d.save_epoch_freq)
        p.add_argument("--num_multi", type=int, default=d.num_multi)
        p.add_argument("--eval_A_freq", type=int, default=d.eval_A_freq)
        p.add_argument("--eval_B_freq", type=int, default=d.eval_B_freq)
        p.add_argument("--n_blocks", type=int, default=d.n_blocks)
        p.add_argument("--init_scheme", type=str, default=d.init_scheme,
                       choices=["reference", "sane"])
        p.add_argument("--use_pallas", type=int, choices=[0, 1], default=int(d.use_pallas),
                       help="no effect here: the CUDA instance-norm kernels "
                            "always run on a CUDA device")
        p.add_argument("--compute_dtype", type=str, default=d.compute_dtype,
                       choices=["float32", "bfloat16"])
        p.add_argument("--num_devices", type=int, default=d.num_devices)
        p.add_argument("--dev_size", type=int, default=d.dev_size)
        p.add_argument("--legacy_eval_constants", action="store_true")
        p.add_argument("--remat", action="store_true")
        p.add_argument("--pool_size", type=int, default=d.pool_size)
        p.add_argument("--resize_antialias", type=int, choices=[0, 1],
                       default=d.resize_antialias)
        p.add_argument("--spatial", type=int, default=d.spatial)
        p.add_argument("--tensor", type=int, default=d.tensor)
        p.add_argument("--pipeline", type=int, default=d.pipeline)
        p.add_argument("--microbatches", type=int, default=d.microbatches)
        p.add_argument("--host_devices", type=int, default=d.host_devices,
                       help="TPU package only; no effect here")
        p.add_argument("--check_numerics", type=int, choices=[0, 1],
                       default=d.check_numerics)
        p.add_argument("--ema", type=float, default=d.ema)
        p.add_argument("--grad_accum", type=int, default=d.grad_accum)
        p.add_argument("--d_lr_mode", type=str, default=d.d_lr_mode,
                       choices=["reference", "ratio"])
        p.add_argument("--device_data", type=int, choices=[-1, 0, 1],
                       default=d.device_data)
        p.add_argument("--device_data_max_gb", type=float,
                       default=d.device_data_max_gb)
        p.add_argument("--coordinator", type=str, default=d.coordinator)
        p.add_argument("--num_processes", type=int, default=d.num_processes)
        p.add_argument("--process_id", type=int, default=d.process_id)
        p.add_argument("--ckpt_backend", type=str, default=d.ckpt_backend,
                       choices=["flax", "orbax"])
        p.add_argument("--profile_dir", type=str, default=d.profile_dir)
        p.add_argument("--data_axis", type=str, default=d.data_axis,
                       help="TPU package only; no effect here")
        p.add_argument("--device", type=str, default=d.device,
                       help="torch device the CLI trains on (cpu for tests)")
        self.initialized = True

    def parse(self, sub_dirs=None, args=None) -> TrainConfig:
        """Parse, refuse unported flags (before anything is written), print
        the options, then create the experiment dir and its option dumps."""
        if not self.initialized:
            self.initialize()
        ns = self.parser.parse_args(args)
        names = {f.name for f in dataclasses.fields(TrainConfig)}
        cfg = TrainConfig(**{k: v for k, v in vars(ns).items() if k in names})
        cfg.use_pallas = bool(ns.use_pallas)
        refuse_unported(cfg)
        print("------------ Options -------------")
        for k, v in sorted(vars(cfg).items()):
            print("%s: %s" % (str(k), str(v)))
        print("-------------- End ----------------")
        return cfg.finalize(sub_dirs=sub_dirs)


@dataclass
class TestConfig:
    """The evaluation CLI's flags, under the names and defaults of the JAX
    package's ``TestConfig``; ``--device`` takes the place of the TPU
    runtime's ``--host_devices``."""

    chk_path: str = ""
    res_dir: str = "test_res"
    train_logvar: int = 1
    dataroot: str = ""
    metric: str = "mse"  # {bpp, mse, visual, noise_sens, mvgauss, fid, z_div}
    use_ema: int = 0
    fid_extractor: str = ""
    device: str = "cuda"


class TestOptions:
    """argparse shim with the JAX evaluation CLI's flags, ``--device``
    instead of ``--host_devices``."""

    def __init__(self):
        d = TestConfig()
        p = self.parser = argparse.ArgumentParser()
        p.add_argument("--chk_path", required=True, type=str,
                       help="path to checkpoint; expr_dir is its parent")
        p.add_argument("--res_dir", type=str, default=d.res_dir)
        p.add_argument("--train_logvar", type=int, default=d.train_logvar)
        p.add_argument("--dataroot", required=True, type=str)
        p.add_argument("--metric", required=True, type=str,
                       choices=["bpp", "mse", "visual", "noise_sens",
                                "mvgauss", "fid", "z_div"])
        p.add_argument("--use_ema", type=int, choices=[0, 1],
                       default=d.use_ema)
        p.add_argument("--fid_extractor", type=str, default=d.fid_extractor)
        p.add_argument("--device", type=str, default=d.device,
                       help="torch device the CLI evaluates on (cpu for "
                            "tests)")

    def parse(self, args=None) -> TestConfig:
        return TestConfig(**vars(self.parser.parse_args(args)))
