"""Model API of the three variants (``cycle_gan``, ``stoch_cycle_gan``,
``aug_cycle_gan``).

``create_model(opt, device=...)`` builds the configured variant:

- ``aug_cycle_gan`` -> :class:`AugmentedCycleGAN`: all six networks
  (``netG_A_B``, ``netG_B_A``, ``netD_A``, ``netD_B``, ``netD_z_B``,
  ``netE_B``), trainable, with ``train_instance`` (the two-phase step of
  ``models/steps.py``), the learning-rate schedule and the forward-only calls;
- ``stoch_cycle_gan`` / ``cycle_gan`` -> :class:`GeneratorPair`: the two
  generators, frozen, and the forward-only calls.  Their train step is not
  ported yet.

All tensors are NHWC; latent codes are flat (N, nlatent).  Inputs may be
numpy arrays or tensors; outputs are tensors on the model's device.

``AugmentedCycleGAN`` also has the generation helpers of the training CLI
(``generate_cycle``, ``inference_multi``, ``generate_multi``), the
device-resident train feed (``train_instance_indexed``) and checkpoints
(``save`` / ``load`` / ``wait_for_saves``, the port's own ``torch.save``
format).

What still raises ``NotImplementedError``: the train steps of the other two
variants and the supervised step, with their ``generate_cycle`` and
checkpoints, and reading the JAX package's checkpoints.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from ..config import TrainConfig
from ..nn import networks as N
from ..nn.networks import frozen
from ..ops.numerics import gauss_reparametrize_eps
from ..utils.checkpoint import (
    AsyncCheckpointer,
    read_checkpoint,
    to_cpu,
    write_checkpoint,
)
from ..utils.convert import (
    GENERATOR_NETS,
    jax_batch_stats_to_buffers,
    jax_params_to_state_dict,
    unflatten_params,
)
from .state import DTYPES, init_state
from .steps import make_aug_train_step

MODELS = ("cycle_gan", "stoch_cycle_gan", "aug_cycle_gan")

_NOT_PORTED = ("%s is not ported yet: the stoch_cycle_gan / cycle_gan and "
               "supervised train steps, with the generation helpers and "
               "checkpoints of those two variants, come with a later slice "
               "of the PyTorch port (ROADMAP M6)")

CKPT_FORMAT = "domain_transfer_gan_torch checkpoint 1"


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
        self.nets = self._build_nets(generator)

    def _build_nets(self, generator: torch.Generator):
        nets = build_generators(self.opt, generator)
        for net in nets.values():
            net.place(self.device, self.dtype).eval().requires_grad_(False)
        return nets

    # a frozen pair runs under inference_mode; the training model overrides
    # this, because a tensor made under inference_mode can never enter a
    # graph later
    _no_grad = staticmethod(torch.inference_mode)

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
        with self._no_grad():
            return self.nets["netG_B_A"](
                self._tensor(real_B), plain_norm=plain_norm).float()

    def predict_B(self, real_A, z_B, plain_norm: bool = False) -> torch.Tensor:
        with self._no_grad():
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

    def _load_converted(self, name: str, sd, expected, what: str):
        """Copy a converted state into the placed net (device and dtype
        stay), after checking that it names exactly the ``expected``
        entries."""
        want = {k for k, _ in expected}
        if set(sd) != want:
            raise KeyError("%s: %s and the module disagree on %s"
                           % (name, what, sorted(set(sd) ^ want)))
        self.nets[name].load_state_dict(sd, strict=False)
        return self

    def load_jax_params(self, name: str, params):
        """Load one network's parameters from its JAX ``params`` subtree."""
        return self._load_converted(
            name, jax_params_to_state_dict(name, params),
            self.nets[name].named_parameters(), "params")

    def load_jax_batch_stats(self, name: str, batch_stats):
        """Load one network's batch-norm running statistics from its JAX
        ``batch_stats`` subtree (empty for a net without batch norm)."""
        return self._load_converted(
            name, jax_batch_stats_to_buffers(name, batch_stats),
            self.nets[name].named_buffers(), "batch_stats")

    # -- what later slices port ---------------------------------------------
    def _later(self, what):
        raise NotImplementedError(_NOT_PORTED % what)

    def train_instance(self, *a, **kw):
        self._later("train_instance of %s" % self.opt.model)

    def supervised_train_instance(self, *a, **kw):
        self._later("supervised_train_instance")

    def generate_cycle(self, *a, **kw):
        self._later("generate_cycle of %s" % self.opt.model)

    def update_learning_rate(self):
        self._later("update_learning_rate of %s" % self.opt.model)

    def save(self, *a, **kw):
        self._later("save of %s" % self.opt.model)

    def load(self, *a, **kw):
        self._later("load of %s (use load_params on an .npz)"
                    % self.opt.model)


class AugmentedCycleGAN(GeneratorPair):
    """Augmented CycleGAN: the generator pair plus the latent encoder E_B,
    the three discriminators and one Adam state per network.

    Parameters and optimizer moments are float32; with
    ``compute_dtype="bfloat16"`` the layers cast them per use, and norm
    statistics, CIN scale/shift and losses stay float32.  Weights are drawn
    on the CPU from ``generator`` (seeded from ``opt.seed``), so a seed gives
    the same weights on every device; prior z, posterior noise and dropout
    masks come from a second generator on the model's device.
    """

    net_names = ("netG_A_B", "netG_B_A", "netD_A", "netD_B", "netD_z_B",
                 "netE_B")

    def __init__(self, opt: TrainConfig, testing: bool = False,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 image_size: Optional[int] = None):
        self._image_size = image_size
        super().__init__(opt, ignore_noise=False, device=device,
                         generator=generator)
        self.old_lr = opt.lr
        self.old_lr_d = opt.lr / 5.0   # the D optimizers start at lr / 5
        self.epoch = opt.epoch_count
        self.training = True
        self._noise = torch.Generator(device=self.device)
        self._noise.manual_seed(opt.seed if opt.seed is not None else 0)
        for name in GENERATOR_NETS:
            self.nets[name].set_dropout_generator(self._noise)
        self._train_step = make_aug_train_step(opt)
        if not testing and opt.expr_dir:
            with open(os.path.join(opt.expr_dir, "nets.txt"), "w") as f:
                for name in self.net_names:
                    N.print_network(name, self.nets[name], f)

    def _build_nets(self, generator: torch.Generator):
        self.state = init_state(self.opt, self.device, generator,
                                image_size=self._image_size)
        return self.state.nets

    _no_grad = staticmethod(torch.no_grad)

    # -- mode toggles -------------------------------------------------------
    def eval(self):
        self.training = False

    def train(self):
        self.training = True

    # -- forward ------------------------------------------------------------
    # In the model's mode (train-mode batch statistics while training, as
    # upstream evaluates), and never advancing a running statistic.
    def predict_A(self, real_B, plain_norm: bool = False) -> torch.Tensor:
        with frozen(self.nets["netG_B_A"], self.training):
            return super().predict_A(real_B, plain_norm)

    def predict_B(self, real_A, z_B, plain_norm: bool = False) -> torch.Tensor:
        with frozen(self.nets["netG_A_B"], self.training):
            return super().predict_B(real_A, z_B, plain_norm)

    def _encode(self, real_A, real_B, plain_norm: bool = False):
        real_A, real_B = self._tensor(real_A), self._tensor(real_B)
        enc_in = (torch.cat([real_A, real_B], dim=-1)
                  if self.opt.enc_A_B else real_B)
        with frozen(self.nets["netE_B"], self.training) as net, \
                torch.no_grad():
            mu, logvar = net(enc_in, plain_norm=plain_norm)
        return mu.float(), logvar.float()

    def predict_enc_params(self, real_A, real_B, plain_norm: bool = False):
        """(mu, logvar) of the posterior of z given (A, B) when
        ``stoch_enc``, else (mu,).  Never advances the encoder's running
        statistics."""
        mu, logvar = self._encode(real_A, real_B, plain_norm)
        if self.opt.stoch_enc:
            return mu, logvar
        return (mu,)

    def _posterior_z(self, real_A_ish, real_B) -> torch.Tensor:
        """A posterior sample of z given (A, B) under ``stoch_enc``, else
        the posterior mean."""
        mu, logvar = self._encode(real_A_ish, real_B)
        if self.opt.stoch_enc:
            eps = torch.randn(mu.shape, dtype=mu.dtype, device=mu.device,
                              generator=self._noise)
            return gauss_reparametrize_eps(mu, logvar, eps)
        return mu

    # -- generation helpers (the training CLI's visuals) --------------------
    def generate_cycle(self, real_A, real_B, prior_z_B):
        """A -> B -> A with ``prior_z_B`` and B -> A -> B with the posterior
        z of (fake_A, B); the six images in the train step's visuals order."""
        real_A, real_B = self._tensor(real_A), self._tensor(real_B)
        prior_z_B = self._prep_prior(real_A.shape[0], prior_z_B)
        fake_B = self.predict_B(real_A, prior_z_B)
        fake_A = self.predict_A(real_B)
        rec_A = self.predict_A(fake_B)
        post_z = self._posterior_z(fake_A, real_B)
        rec_B = self.predict_B(fake_A, post_z)
        return OrderedDict([("real_A", real_A), ("fake_B", fake_B),
                            ("rec_A", rec_A), ("real_B", real_B),
                            ("fake_A", fake_A), ("rec_B", rec_B)])

    def inference_multi(self, real_A, real_B):
        """Every A decoded with every z inferred from the B batch:
        (len(A) * len(B), H, W, C), A-major."""
        real_A, real_B = self._tensor(real_A), self._tensor(real_B)
        num = real_B.shape[0]
        multi_A = real_A.repeat_interleave(num, dim=0)
        fake_A = self.predict_A(real_B)
        post_z = self._posterior_z(fake_A, real_B)
        multi_z = post_z.repeat(real_A.shape[0], 1)
        return self.predict_B(multi_A, multi_z)

    # -- training -----------------------------------------------------------
    def sample_prior_z(self, batch: int) -> torch.Tensor:
        return torch.randn((batch, self.opt.nlatent), device=self.device,
                           generator=self._noise)

    def _prep_prior(self, batch: int, prior_z_B) -> torch.Tensor:
        """Draw from the prior when the caller passes None, otherwise accept
        flat (B, nz) or image-layout (B, 1, 1, nz) codes."""
        if prior_z_B is None:
            return self.sample_prior_z(batch)
        prior_z_B = self._tensor(prior_z_B)
        if prior_z_B.dim() == 4:
            prior_z_B = prior_z_B.reshape(prior_z_B.shape[0], -1)
        return prior_z_B

    def train_instance(self, real_A, real_B, prior_z_B=None, eps_post=None,
                       plain_norm: bool = False):
        """One two-phase train step.  ``eps_post`` is the noise of the
        reparametrized posterior, (B, nlatent); None draws it here.  (The
        JAX package draws it inside its step from the step's key; passing it
        lets the two packages be compared on the same noise.)  Returns
        (losses, visuals) and, with ``monitor_gnorm``, gnorms: ordered dicts
        of device tensors; nothing is read back to the host."""
        real_A, real_B = self._tensor(real_A), self._tensor(real_B)
        prior_z_B = self._prep_prior(real_A.shape[0], prior_z_B)
        eps_post = self._prep_prior(real_A.shape[0], eps_post)
        losses, visuals, gnorms = self._train_step(
            self.state, real_A, real_B, prior_z_B, eps_post,
            float(self.old_lr), float(self.old_lr_d), plain_norm)
        return self._format_train_out(losses, visuals, gnorms)

    def train_instance_indexed(self, data_A: torch.Tensor,
                               data_B: torch.Tensor, idx_A, idx_B,
                               prior_z_B=None, eps_post=None):
        """:meth:`train_instance` on rows ``idx_A`` / ``idx_B`` of a train
        set that lives on the model's device: the batch is gathered there
        (``index_select``), so only the index vectors cross from the host.
        The same rows as the host feed, so the same step."""
        idx_A = torch.as_tensor(idx_A, dtype=torch.int64).to(self.device)
        idx_B = torch.as_tensor(idx_B, dtype=torch.int64).to(self.device)
        return self.train_instance(data_A.index_select(0, idx_A),
                                   data_B.index_select(0, idx_B),
                                   prior_z_B, eps_post)

    def _format_train_out(self, losses, visuals, gnorms):
        order = ["D_A", "G_A", "Cyc_A", "Cyc_z_B", "KLD_z_B", "D_B", "G_B",
                 "Cyc_B", "D_z_B", "P_t_A", "P_f_A", "P_t_B", "P_f_B"]
        losses = OrderedDict((k, losses[k]) for k in order)
        visuals = OrderedDict((k, visuals[k]) for k in (
            "real_A", "fake_B", "rec_A", "real_B", "fake_A", "rec_B"))
        if self.opt.monitor_gnorm:
            g = OrderedDict((k, gnorms[k]) for k in (
                "gnorm_G_A_B", "gnorm_G_B_A", "gnorm_E_B", "gnorm_D_B",
                "gnorm_D_z_B", "gnorm_D_A", "mu_min", "mu_max",
                "logvar_min", "logvar_max"))
            return losses, visuals, g
        return losses, visuals

    # -- lr schedule --------------------------------------------------------
    def update_learning_rate(self):
        """Linear decay.  Upstream sets EVERY optimizer, the discriminators'
        included, to the full decayed lr, so D's initial /5 discount ends
        when decay starts; ``d_lr_mode="ratio"`` keeps D at lr / 5 of the
        decayed schedule instead."""
        lrd = self.opt.lr / self.opt.niter_decay
        lr = self.old_lr - lrd
        print("update learning rate: %f -> %f" % (self.old_lr, lr))
        self.old_lr = lr
        if self.opt.d_lr_mode == "ratio":
            self.old_lr_d = lr / 5.0
        else:
            self.old_lr_d = lr

    def _derive_lr_d(self):
        """Recompute ``old_lr_d`` from a restored ``old_lr``: ``old_lr <
        opt.lr`` iff decay has started."""
        decayed = self.old_lr < self.opt.lr
        reference = self.opt.d_lr_mode == "reference"
        self.old_lr_d = self.old_lr if (reference and decayed) \
            else self.old_lr / 5.0

    # -- checkpoints (latest / best_A / best_B) ------------------------------
    def _ckpt_payload(self) -> dict:
        """The JAX package's payload in torch form: every net's
        ``state_dict`` (parameters and batch-norm buffers), one Adam state
        per net, ``step``, ``old_lr`` and ``epoch``.  Device tensors; the
        writer copies them to the CPU."""
        return {
            "format": CKPT_FORMAT,
            "nets": {name: dict(net.state_dict())
                     for name, net in self.nets.items()},
            "opt_state": {name: {"mu": list(s.mu), "nu": list(s.nu),
                                 "count": int(s.count)}
                          for name, s in self.state.opt_state.items()},
            "step": int(self.state.step),
            "old_lr": float(self.old_lr),
            "epoch": int(self.epoch),
        }

    def save(self, chk_name: str, async_save: bool = False):
        """Write ``expr_dir/chk_name``.  With ``async_save`` the payload is
        copied to the CPU here and written by a background thread
        (``utils.checkpoint.AsyncCheckpointer``); either way the file is
        published by an atomic rename."""
        chk_path = os.path.join(self.opt.expr_dir, chk_name)
        if async_save:
            if not hasattr(self, "_async_ckpt"):
                self._async_ckpt = AsyncCheckpointer()
            self._async_ckpt.save(chk_path, self._ckpt_payload())
            return
        write_checkpoint(chk_path, to_cpu(self._ckpt_payload()))

    def wait_for_saves(self):
        """Block until every asynchronous save is on disk; re-raises a
        failed one."""
        if hasattr(self, "_async_ckpt"):
            self._async_ckpt.wait()

    def load(self, chk_path: str):
        """Restore a checkpoint written by :meth:`save`: parameters, buffers
        and Adam moments are copied into this model's tensors (device and
        dtype stay), ``step``, ``old_lr``, ``epoch`` set, ``old_lr_d``
        derived.  Raises if a net or an entry is missing or extra."""
        self.wait_for_saves()
        payload = read_checkpoint(chk_path)
        if not isinstance(payload, dict) or \
                payload.get("format") != CKPT_FORMAT:
            raise ValueError(
                "%s is not a checkpoint of this package (reading the JAX "
                "package's checkpoints is ROADMAP M15)" % chk_path)
        if set(payload["nets"]) != set(self.nets):
            raise KeyError("%s holds nets %s, the model has %s" % (
                chk_path, sorted(payload["nets"]), sorted(self.nets)))
        with torch.no_grad():
            for name, net in self.nets.items():
                net.load_state_dict(payload["nets"][name], strict=True)
                saved, state = payload["opt_state"][name], \
                    self.state.opt_state[name]
                for mine, theirs in ((state.mu, saved["mu"]),
                                     (state.nu, saved["nu"])):
                    if len(mine) != len(theirs):
                        raise KeyError("%s: Adam state of %s has %d "
                                       "tensors, the model %d" % (
                                           chk_path, name, len(theirs),
                                           len(mine)))
                    for t, v in zip(mine, theirs):
                        t.copy_(v)
                state.count = int(saved["count"])
        self.state.step = int(payload["step"])
        self.old_lr = float(payload["old_lr"])
        self.epoch = int(payload["epoch"])
        self._derive_lr_d()


def create_model(opt: TrainConfig, testing: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None, **kw):
    """Model dispatch on ``opt.model``.  ``testing`` only keeps
    ``aug_cycle_gan`` from writing ``nets.txt``; for the other two variants
    only ``testing=True`` (the frozen generator pair) is ported."""
    if opt.model not in MODELS:
        raise NotImplementedError("Specified model is not implemented.")
    if opt.model == "aug_cycle_gan":
        return AugmentedCycleGAN(opt, testing=testing, device=device,
                                 generator=generator, **kw)
    if not testing:
        raise NotImplementedError(
            _NOT_PORTED % ("create_model(testing=False) for %s" % opt.model))
    return GeneratorPair(opt, ignore_noise=opt.model == "cycle_gan",
                         device=device, generator=generator)
