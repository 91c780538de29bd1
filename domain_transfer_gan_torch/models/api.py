"""Inference API of the three model variants (``cycle_gan``,
``stoch_cycle_gan``, ``aug_cycle_gan``): the two generators and the calls
that only run them forward.

``create_model(opt, testing=True, device=...)`` builds ``netG_A_B`` and
``netG_B_A`` for the configured variant.  All tensors are NHWC; latent codes
are flat (N, nlatent).  Inputs may be numpy arrays or tensors; outputs are
float32 tensors on the model's device.  Everything that trains (the
discriminators, the latent encoder, steps, optimizers, checkpoints) belongs
to the training slice and raises ``NotImplementedError`` until then.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import TrainConfig
from ..nn import networks as N
from ..utils.convert import (
    GENERATOR_NETS,
    jax_params_to_state_dict,
    unflatten_params,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODELS = ("cycle_gan", "stoch_cycle_gan", "aug_cycle_gan")

_TRAINING_SLICE = ("%s belongs to the training slice of the PyTorch port "
                   "(train steps, discriminators, latent encoder, "
                   "optimizers, checkpoints), which is not ported yet")


def build_generators(cfg: TrainConfig,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.nn.Module]:
    """The two generators of the configured variant, on the CPU in fp32,
    drawn under ``cfg.init_scheme`` from ``generator``."""
    generator = generator or torch.Generator()
    return {
        "netG_A_B": N.define_stochastic_G(
            nlatent=cfg.nlatent, input_nc=cfg.input_nc,
            output_nc=cfg.output_nc, ngf=cfg.ngf,
            use_dropout=cfg.use_dropout, n_blocks=cfg.n_blocks,
            init_scheme=cfg.init_scheme, generator=generator),
        "netG_B_A": N.define_G(
            input_nc=cfg.output_nc, output_nc=cfg.input_nc, ngf=cfg.ngf,
            norm=cfg.norm, use_dropout=cfg.use_dropout,
            n_blocks=cfg.n_blocks, init_scheme=cfg.init_scheme,
            generator=generator),
    }


class GeneratorPair:
    """The generators of one model and the forward-only calls on them.

    ``ignore_noise`` makes it the deterministic ``cycle_gan`` variant: z is
    replaced by ones.
    """

    def __init__(self, opt: TrainConfig, ignore_noise: bool = False,
                 device="cuda", generator: Optional[torch.Generator] = None):
        self.opt = opt
        self.ignore_noise = ignore_noise
        self.device = torch.device(device)
        if opt.compute_dtype not in DTYPES:
            raise ValueError("compute_dtype must be one of %r, got %r"
                             % (tuple(DTYPES), opt.compute_dtype))
        self.dtype = DTYPES[opt.compute_dtype]
        if generator is None:
            generator = torch.Generator()
            generator.manual_seed(opt.seed if opt.seed is not None else 0)
        self.nets = build_generators(opt, generator)
        for net in self.nets.values():
            net.place(self.device, self.dtype).eval().requires_grad_(False)

    # -- inputs -----------------------------------------------------------
    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return x.to(self.device)

    def _prep_z(self, z) -> torch.Tensor:
        z = self._tensor(z)
        if z.dim() == 4:
            z = z.reshape(z.shape[0], -1)
        return torch.ones_like(z) if self.ignore_noise else z

    # -- forward ----------------------------------------------------------
    def predict_A(self, real_B, plain_norm: bool = False) -> torch.Tensor:
        with torch.inference_mode():
            return self.nets["netG_B_A"](
                self._tensor(real_B), plain_norm=plain_norm).float()

    def predict_B(self, real_A, z_B, plain_norm: bool = False) -> torch.Tensor:
        with torch.inference_mode():
            return self.nets["netG_A_B"](
                self._tensor(real_A), self._prep_z(z_B),
                plain_norm=plain_norm).float()

    def generate_multi(self, real_A, multi_prior_z_B) -> torch.Tensor:
        """Tile each A over its z's and decode in ONE batched forward."""
        real_A = self._tensor(real_A)
        z = self._prep_z(multi_prior_z_B)
        num = z.shape[0] // real_A.shape[0]
        return self.predict_B(real_A.repeat_interleave(num, dim=0), z)

    def generate_cycle_B_multi(self, real_B, multi_prior_z_B):
        """B -> A once, then many z's for A -> B."""
        real_B = self._tensor(real_B)
        z = self._prep_z(multi_prior_z_B)
        fake_A = self.predict_A(real_B)
        num = z.shape[0] // real_B.shape[0]
        multi_fake_B = self.predict_B(fake_A.repeat_interleave(num, dim=0), z)
        return fake_A, multi_fake_B

    # -- weights ----------------------------------------------------------
    def load_params(self, npz_path: str):
        """Load both generators from a params ``.npz`` with flat keys in the
        JAX package's layout (``netG_A_B/conv0/kernel`` ...); other nets in
        the file are ignored."""
        with np.load(npz_path) as f:
            tree = unflatten_params({k: f[k] for k in f.files})
        missing = [n for n in GENERATOR_NETS if n not in tree]
        if missing:
            raise KeyError("%s holds no parameters of %s"
                           % (npz_path, ", ".join(missing)))
        for name in GENERATOR_NETS:
            self.load_jax_params(name, tree[name])
        return self

    def load_jax_params(self, name: str, params):
        """Load one generator from its JAX ``params`` subtree."""
        # copies into the placed parameters: device and dtype stay
        self.nets[name].load_state_dict(
            jax_params_to_state_dict(name, params), strict=True)
        return self

    # -- the training slice -----------------------------------------------
    def _later(self, what):
        raise NotImplementedError(_TRAINING_SLICE % what)

    def train_instance(self, *a, **kw):
        self._later("train_instance")

    def supervised_train_instance(self, *a, **kw):
        self._later("supervised_train_instance")

    def generate_cycle(self, *a, **kw):
        self._later("generate_cycle (it needs the latent encoder)")

    def update_learning_rate(self):
        self._later("update_learning_rate")

    def save(self, *a, **kw):
        self._later("save")

    def load(self, *a, **kw):
        self._later("load (reading checkpoints; use load_params on an .npz)")


def create_model(opt: TrainConfig, testing: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None) -> GeneratorPair:
    """Model dispatch on ``opt.model``.  Only ``testing=True`` (inference)
    is ported so far."""
    if opt.model not in MODELS:
        raise NotImplementedError("Specified model is not implemented.")
    if not testing:
        raise NotImplementedError(_TRAINING_SLICE % "create_model(testing="
                                  "False)")
    return GeneratorPair(opt, ignore_noise=opt.model == "cycle_gan",
                         device=device, generator=generator)
