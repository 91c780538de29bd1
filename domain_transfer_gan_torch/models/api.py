"""Model API of the three variants (``cycle_gan``, ``stoch_cycle_gan``,
``aug_cycle_gan``).

``create_model(opt, device=...)`` builds the configured variant, trainable
in every case:

- ``stoch_cycle_gan`` -> :class:`StochCycleGAN`: the two generators and the
  two image discriminators, the two-phase step of
  ``models/steps.py::make_stoch_train_step``;
- ``cycle_gan`` -> :class:`StochCycleGAN` with ``ignore_noise``: z is
  replaced by ones, in the step and in every generation call;
- ``aug_cycle_gan`` -> :class:`AugmentedCycleGAN`: all six networks
  (``netG_A_B``, ``netG_B_A``, ``netD_A``, ``netD_B``, ``netD_z_B``,
  ``netE_B``), the two-phase step and the supervised step.

:class:`CycleGANBase` holds what the variants share: the training state
(networks, one Adam state per network), the noise generator, the forward
calls, the learning-rate schedule, the device-resident train feed and
checkpoints (``save`` / ``load`` / ``wait_for_saves`` in the port's own
``torch.save`` format; ``load`` also reads the JAX package's flax files and
``save_jax`` writes them, ``utils/flax_msgpack.py``) and the EMA swap.
``testing`` only keeps a model from writing ``nets.txt``.  ``--grad_accum
K`` picks the steps of ``models/accum.py``.

All tensors are NHWC; latent codes are flat (N, nlatent).  Inputs may be
numpy arrays or tensors; outputs are tensors on the model's device.  Every
random draw (prior z, posterior and generation noise, dropout masks) comes
from the model's own ``torch.Generator`` on its device, seeded from
``opt.seed``; where a test needs the JAX package's draws, the call takes
them as arguments.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..config import TrainConfig
from ..nn import networks as N
from ..nn.networks import frozen
from ..ops.numerics import gauss_reparametrize_eps
from ..utils.checkpoint import (
    AsyncCheckpointer,
    OrbaxCheckpointer,
    read_checkpoint,
    to_cpu,
    write_checkpoint,
)
from ..utils.convert import (
    GENERATOR_NETS,
    buffers_to_jax_batch_stats,
    jax_batch_stats_to_buffers,
    jax_params_to_state_dict,
    jax_pool_to_port,
    port_pool_to_jax,
    state_dict_to_jax_params,
    unflatten_params,
)
from ..utils.flax_msgpack import is_flax_bytes, read_flax, write_flax
from ..utils.orbax_dir import (
    OrbaxFormatError,
    is_orbax_dir,
    orbax_metadata,
    read_orbax,
)
from .accum import make_aug_accum_step, make_stoch_accum_step
from .pool import PoolState, draw_pool
from .state import DTYPES, init_state
from .steps import (
    make_aug_supervised_step,
    make_aug_train_step,
    make_stoch_train_step,
)

MODELS = ("cycle_gan", "stoch_cycle_gan", "aug_cycle_gan")

# format 2 adds the pools and the EMA shadows; format 1 files still load
CKPT_FORMAT = "domain_transfer_gan_torch checkpoint 2"
CKPT_FORMATS = ("domain_transfer_gan_torch checkpoint 1", CKPT_FORMAT)


def _accum_k(opt: TrainConfig) -> int:
    """--grad_accum microbatch count (1 = the fused single-batch step)."""
    k = int(opt.grad_accum or 1)
    if k > 1 and opt.supervised:
        raise ValueError("--grad_accum does not support --supervised runs "
                         "(the supervised step is single-batch; drop one "
                         "of the two flags)")
    return k

VISUALS = ("real_A", "fake_B", "rec_A", "real_B", "fake_A", "rec_B")


class CycleGANBase:
    """What the variants share.

    Parameters and optimizer moments are float32; with
    ``compute_dtype="bfloat16"`` the layers cast them per use, and norm
    statistics, CIN scale/shift and losses stay float32.  Weights are drawn
    on the CPU from ``generator`` (seeded from ``opt.seed``), so a seed gives
    the same weights on every device.
    """

    net_names = ()
    ignore_noise = False

    def __init__(self, opt: TrainConfig, testing: bool = False,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 image_size: Optional[int] = None):
        self.opt = opt
        self.device = torch.device(device)
        if opt.compute_dtype not in DTYPES:
            raise ValueError("compute_dtype must be one of %r, got %r"
                             % (tuple(DTYPES), opt.compute_dtype))
        self.dtype = DTYPES[opt.compute_dtype]
        seed = opt.seed if opt.seed is not None else 0
        if generator is None:
            generator = torch.Generator()
            generator.manual_seed(seed)
        self.state = init_state(opt, self.device, generator,
                                image_size=image_size)
        self.nets = self.state.nets
        self.old_lr = opt.lr
        self.old_lr_d = opt.lr / 5.0   # the D optimizers start at lr / 5
        self.epoch = opt.epoch_count
        self.training = True
        self._noise = torch.Generator(device=self.device)
        self._noise.manual_seed(seed)
        for name in GENERATOR_NETS:
            self.nets[name].set_dropout_generator(self._noise)
        if not testing and opt.expr_dir:
            with open(os.path.join(opt.expr_dir, "nets.txt"), "w") as f:
                for name in self.net_names:
                    N.print_network(name, self.nets[name], f)

    # -- mode toggles -------------------------------------------------------
    def eval(self):
        self.training = False

    def train(self):
        self.training = True

    @torch.no_grad()
    def swap_ema(self):
        """Swap the live generator/encoder parameters with their EMA
        shadows (--ema), in place.  Call once before scoring or exporting
        the averaged weights, and once after to train on the live ones
        again.  A no-op when EMA is off."""
        for name, shadow in self.state.ema.items():
            params = list(self.nets[name].parameters())
            live = [p.clone() for p in params]
            torch._foreach_copy_(params, shadow)
            torch._foreach_copy_(shadow, live)

    # -- inputs and draws ---------------------------------------------------
    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return x.to(self.device)

    def _randn(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), device=self.device,
                           generator=self._noise)

    def sample_prior_z(self, batch: int) -> torch.Tensor:
        return self._randn((batch, self.opt.nlatent))

    def _prep_prior(self, batch: int, prior_z_B) -> torch.Tensor:
        """Draw from the prior when the caller passes None, otherwise accept
        flat (B, nz) or image-layout (B, 1, 1, nz) codes."""
        if prior_z_B is None:
            return self.sample_prior_z(batch)
        prior_z_B = self._tensor(prior_z_B)
        if prior_z_B.dim() == 4:
            prior_z_B = prior_z_B.reshape(prior_z_B.shape[0], -1)
        return prior_z_B

    def _prep_z(self, z) -> torch.Tensor:
        z = self._tensor(z)
        if z.dim() == 4:
            z = z.reshape(z.shape[0], -1)
        return torch.ones_like(z) if self.ignore_noise else z

    # -- forward ------------------------------------------------------------
    # In the model's mode (train-mode batch statistics while training, as
    # upstream evaluates), and never advancing a running statistic.
    def predict_A(self, real_B, plain_norm: bool = False) -> torch.Tensor:
        with frozen(self.nets["netG_B_A"], self.training) as net, \
                torch.no_grad():
            return net(self._tensor(real_B), plain_norm=plain_norm).float()

    def predict_B(self, real_A, z_B, plain_norm: bool = False) -> torch.Tensor:
        with frozen(self.nets["netG_A_B"], self.training) as net, \
                torch.no_grad():
            return net(self._tensor(real_A), self._prep_z(z_B),
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

    def _noisy(self, fake_A, std, noise):
        """fake_A plus ``std / 127.5`` times unit normal ``noise`` (drawn
        here when None), clipped to [-1, 1]."""
        noise = self._randn(fake_A.shape) if noise is None \
            else self._tensor(noise)
        return torch.clamp(fake_A + (std / 127.5) * noise, -1.0, 1.0)

    def _cycle_z(self, A, B, from_prior: bool) -> torch.Tensor:
        """The z that decodes A back to B in a multi or noisy cycle: a prior
        draw; a model with an encoder takes the posterior of (A, B) unless
        ``from_prior``."""
        return self.sample_prior_z(B.shape[0])

    def generate_multi_cycle(self, real_B, steps: int,
                             from_prior: bool = True):
        """[B, A1, B1, ..., A_steps, B_steps]: B -> A, then A -> B with a
        fresh prior z (or, without ``from_prior``, the posterior z of
        (A, B) where the model has one), ``steps`` times."""
        images = [self._tensor(real_B)]
        B = images[0]
        for _ in range(steps):
            A = self.predict_A(B)
            B = self.predict_B(A, self._cycle_z(A, B, from_prior))
            images.extend([A, B])
        return images

    def generate_noisy_cycle(self, real_B, std, noise=None, z=None):
        """B -> A, plus Gaussian noise of ``std`` grey levels on A, -> B
        with the z of the clean (A, B): the posterior where the model has
        one, else a prior draw.  ``noise`` (unit normal, fake_A's shape) and
        ``z`` replace the model's draws."""
        real_B = self._tensor(real_B)
        fake_A = self.predict_A(real_B)
        noisy = self._noisy(fake_A, std, noise)
        if z is None:
            z = self._cycle_z(fake_A, real_B, from_prior=False)
        return self.predict_B(noisy, z)

    # -- training -----------------------------------------------------------
    def train_instance_indexed(self, data_A: torch.Tensor,
                               data_B: torch.Tensor, idx_A, idx_B,
                               prior_z_B=None, **kw):
        """``train_instance`` on rows ``idx_A`` / ``idx_B`` of a train set
        that lives on the model's device: the batch is gathered there
        (``index_select``), so only the index vectors cross from the host.
        The same rows as the host feed, so the same step."""
        idx_A = torch.as_tensor(idx_A, dtype=torch.int64).to(self.device)
        idx_B = torch.as_tensor(idx_B, dtype=torch.int64).to(self.device)
        return self.train_instance(data_A.index_select(0, idx_A),
                                   data_B.index_select(0, idx_B),
                                   prior_z_B, **kw)

    def _pool_draws(self, batch: int, pool_draws):
        """The (coin, slot) draws of both pools for one step: from the
        model's noise generator unless the caller passes them (for tests,
        ``{"fake_A": (coin, slot), "fake_B": (coin, slot)}``); None without
        pools."""
        if not self.state.pools:
            return None
        if pool_draws is None:
            return {name: draw_pool(batch, pool.buf.shape[0], self._noise,
                                    self.device)
                    for name, pool in self.state.pools.items()}
        return {name: (torch.as_tensor(coin).to(self.device, torch.bool),
                       torch.as_tensor(slot).to(self.device, torch.int64))
                for name, (coin, slot) in pool_draws.items()}

    def _format_train_out(self, losses, visuals, gnorms, loss_keys,
                          gnorm_keys):
        losses = OrderedDict((k, losses[k]) for k in loss_keys)
        visuals = OrderedDict((k, visuals[k]) for k in VISUALS)
        if self.opt.monitor_gnorm:
            return losses, visuals, OrderedDict((k, gnorms[k])
                                                for k in gnorm_keys)
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

    # -- weights from the JAX package ----------------------------------------
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

    def load_jax_ema(self, name: str, params):
        """Set one network's EMA shadow from a JAX ``ema`` subtree (a params
        tree); the model must track EMA."""
        sd = jax_params_to_state_dict(name, params)
        names = [n for n, _ in self.nets[name].named_parameters()]
        if set(sd) != set(names):
            raise KeyError("%s: ema and the module disagree on %s"
                           % (name, sorted(set(sd) ^ set(names))))
        with torch.no_grad():
            for t, n in zip(self.state.ema[name], names):
                t.copy_(sd[n])
        return self

    def load_jax_pools(self, pools):
        """Set the pools from the JAX ``pools`` (per name a buffer
        ``(P, H, W, C)`` and a fill count ``n``) of the same sizes."""
        for name, pool in pools.items():
            buf, n = jax_pool_to_port(pool)
            mine = self.state.pools[name]
            if tuple(buf.shape) != tuple(mine.buf.shape):
                raise ValueError("pool %s: %r, the model's is %r" % (
                    name, tuple(buf.shape), tuple(mine.buf.shape)))
            self.state.pools[name] = PoolState(
                buf=buf.to(mine.buf.device, mine.buf.dtype), n=n)
        return self

    # -- checkpoints (latest / best_A / best_B) ------------------------------
    def _ckpt_payload(self) -> dict:
        """The JAX package's payload in torch form: every net's
        ``state_dict`` (parameters and batch-norm buffers), one Adam state
        per net, ``step``, ``old_lr``, ``epoch`` and, where the model has
        them, the pools (buffer and fill count each) and the EMA shadows
        (per net by parameter name).  Device tensors; the writer copies
        them to the CPU."""
        payload = {
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
        if self.state.pools:
            payload["pools"] = {name: {"buf": pool.buf, "n": int(pool.n)}
                                for name, pool in self.state.pools.items()}
        if self.state.ema:
            payload["ema"] = {
                name: dict(zip((n for n, _ in
                                self.nets[name].named_parameters()), shadow))
                for name, shadow in self.state.ema.items()}
        return payload

    def save(self, chk_name: str, async_save: bool = False):
        """Write ``expr_dir/chk_name``.  With ``async_save`` the payload is
        copied to the CPU here and written by a background thread
        (``utils.checkpoint.AsyncCheckpointer``); either way the file is
        published by an atomic rename.  Under ``--ckpt_backend orbax`` the
        checkpoint is the JAX package's payload (:meth:`_jax_payload`) as an
        orbax directory, which either package's ``load`` restores."""
        chk_path = os.path.join(self.opt.expr_dir, chk_name)
        if self.opt.ckpt_backend == "orbax":
            if not hasattr(self, "_orbax_ckpt"):
                self._orbax_ckpt = OrbaxCheckpointer()
            self._orbax_ckpt.save(chk_path, self._jax_payload(), async_save)
            return
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
        if hasattr(self, "_orbax_ckpt"):
            self._orbax_ckpt.wait()

    def _jax_payload(self) -> dict:
        """The tree the JAX package's ``_ckpt_payload()`` serialises, in its
        layouts and dtypes: ``params``, ``batch_stats`` (an entry per net,
        empty without batch norm), ``opt_state`` (per net ``count`` int32
        0-d, ``mu`` / ``nu`` params trees), ``pools`` (``{}`` without),
        ``step`` int32 0-d, ``old_lr`` float64, ``epoch`` int64 and, where
        the model has them, the ``ema`` shadows."""
        params, stats, opt = {}, {}, {}
        for name, net in self.nets.items():
            names = [n for n, _ in net.named_parameters()]
            params[name] = state_dict_to_jax_params(
                name, dict(net.named_parameters()))
            stats[name] = buffers_to_jax_batch_stats(name, net.state_dict())
            s = self.state.opt_state[name]
            opt[name] = {
                "count": np.asarray(s.count, np.int32),
                "mu": state_dict_to_jax_params(name, dict(zip(names, s.mu))),
                "nu": state_dict_to_jax_params(name, dict(zip(names, s.nu)))}
        payload = {
            "params": params, "batch_stats": stats, "opt_state": opt,
            "pools": {name: port_pool_to_jax(pool.buf, pool.n)
                      for name, pool in self.state.pools.items()},
            "step": np.asarray(self.state.step, np.int32),
            # 0-d arrays, as the JAX save writes them (through device_get)
            "old_lr": np.asarray(self.old_lr, np.float64),
            "epoch": np.asarray(self.epoch, np.int64),
        }
        if self.state.ema:
            payload["ema"] = {
                name: state_dict_to_jax_params(name, dict(zip(
                    (n for n, _ in self.nets[name].named_parameters()),
                    shadow)))
                for name, shadow in self.state.ema.items()}
        return payload

    def save_jax(self, path: str):
        """Write this model's state as a JAX-package checkpoint (flax
        msgpack) at ``path``, published by an atomic rename; the JAX
        package's ``load`` restores it."""
        self.wait_for_saves()
        data = write_flax(self._jax_payload())
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def load(self, chk_path: str):
        """Restore a checkpoint written by :meth:`save` (format 1 or 2) or
        by the JAX package (a flax msgpack file, told apart by its first
        bytes before anything is unpickled, :meth:`_load_jax`; or an orbax
        checkpoint directory, :meth:`_load_orbax`):
        parameters, buffers and Adam moments are copied into this model's
        tensors (device and dtype stay), ``step``, ``old_lr``, ``epoch`` set,
        ``old_lr_d`` derived.  Raises if a net or an entry is missing or
        extra (a checkpoint of another variant among them).  As the JAX
        package's ``load``: pools of other sizes than this config's (or none,
        in a format-1 file) are replaced by fresh ones, with a warning; the
        checkpoint's EMA shadows are restored where it has them, and where
        this config tracks EMA and the checkpoint predates it the shadows
        are seeded from the loaded parameters."""
        self.wait_for_saves()
        if os.path.isdir(chk_path):
            return self._load_orbax(chk_path)
        with open(chk_path, "rb") as f:
            head = f.read(4)
        if not head.startswith(b"PK"):
            if is_flax_bytes(head):
                with open(chk_path, "rb") as f:
                    return self._load_jax(chk_path, f.read())
            raise ValueError(
                "%s is neither a checkpoint of this package (a torch.save "
                "zip) nor one of the JAX package (flax msgpack)" % chk_path)
        payload = read_checkpoint(chk_path)
        if not isinstance(payload, dict) or \
                payload.get("format") not in CKPT_FORMATS:
            raise ValueError(
                "%s is not a checkpoint of this package (a torch.save file "
                "without its format tag)" % chk_path)
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
        self._load_pools(payload.get("pools", {}))
        self._load_ema(payload.get("ema", {}))
        self.state.step = int(payload["step"])
        self.old_lr = float(payload["old_lr"])
        self.epoch = int(payload["epoch"])
        self._derive_lr_d()


    def _load_jax(self, chk_path: str, data: bytes):
        """Restore a JAX-package flax file (:meth:`_load_jax_tree`)."""
        try:
            raw = read_flax(data)
        except (ValueError, ImportError):
            raise
        except Exception as e:  # malformed msgpack: name the file
            raise ValueError("%s is neither a checkpoint of this package nor "
                             "a readable JAX package flax checkpoint (%s)"
                             % (chk_path, e)) from e
        self._check_jax_tree(chk_path, raw, "a msgpack file")
        self._load_jax_tree(chk_path, raw)

    def _load_orbax(self, chk_path: str):
        """Restore a JAX-package orbax directory as the JAX ``load`` does:
        its metadata first (no chunk read), the nets checked against this
        model's and the EMA shadows read only where this config tracks EMA;
        then :meth:`_load_jax_tree`.  A directory that is no orbax
        checkpoint, or one of another variant, is refused by name."""
        if not is_orbax_dir(chk_path):
            raise OrbaxFormatError(
                "%s is a directory but not an orbax checkpoint (no "
                "_METADATA)" % chk_path)
        meta = orbax_metadata(chk_path)
        self._check_jax_tree(chk_path, meta, "an orbax directory")
        self._load_jax_tree(chk_path, read_orbax(
            chk_path, skip=() if self.state.ema else ("ema",)))

    def _check_jax_tree(self, chk_path: str, raw, what: str):
        if not isinstance(raw, dict) or "params" not in raw:
            raise ValueError("%s is %s but not a JAX package checkpoint (no "
                             "params)" % (chk_path, what))
        if set(raw["params"]) != set(self.nets):
            raise KeyError("%s holds nets %s, the model has %s" % (
                chk_path, sorted(raw["params"]), sorted(self.nets)))

    def _load_jax_tree(self, chk_path: str, raw: dict):
        """Restore a JAX-package checkpoint's tree by the JAX ``load``'s
        rules: every net's parameters and running statistics, the Adam
        moments (through the parameters' layout maps) and counts, ``step``,
        ``old_lr``, ``epoch``; pools of other sizes are replaced by fresh
        ones with the JAX warning; the tree's EMA shadows are taken where
        this config tracks EMA, and seeded from the loaded parameters where
        it has none."""
        stats = raw.get("batch_stats") or {}
        with torch.no_grad():
            for name, net in self.nets.items():
                sd = jax_params_to_state_dict(name, raw["params"][name])
                sd.update(jax_batch_stats_to_buffers(name,
                                                     stats.get(name) or {}))
                net.load_state_dict(sd, strict=True)
                saved, state = raw["opt_state"][name], \
                    self.state.opt_state[name]
                names = [n for n, _ in net.named_parameters()]
                for mine, tree in ((state.mu, saved["mu"]),
                                   (state.nu, saved["nu"])):
                    moment = jax_params_to_state_dict(name, tree)
                    if set(moment) != set(names):
                        raise KeyError(
                            "%s: Adam state of %s disagrees with the module "
                            "on %s" % (chk_path, name,
                                       sorted(set(moment) ^ set(names))))
                    for t, n in zip(mine, names):
                        t.copy_(moment[n])
                state.count = int(saved["count"])
        self._load_pools({name: dict(zip(("buf", "n"),
                                         jax_pool_to_port(pool)))
                          for name, pool in (raw.get("pools") or {}).items()})
        # as the JAX load: a config without EMA drops the file's shadows
        ema = (raw.get("ema") or {}) if self.state.ema else {}
        self._load_ema({name: jax_params_to_state_dict(name, tree)
                        for name, tree in ema.items()})
        self.state.step = int(raw["step"])
        self.old_lr = float(raw["old_lr"])
        self.epoch = int(raw["epoch"])
        self._derive_lr_d()

    def _load_pools(self, saved: dict):
        cur = self.state.pools
        if set(saved) != set(cur) or any(
                tuple(saved[k]["buf"].shape) != tuple(cur[k].buf.shape)
                for k in saved):
            print("warning: checkpoint pool buffers do not match this "
                  "config's --pool_size; starting with fresh pools")
            return
        for name, pool in saved.items():
            cur[name] = PoolState(
                buf=pool["buf"].to(cur[name].buf.device, cur[name].buf.dtype),
                n=int(pool["n"]))

    @torch.no_grad()
    def _load_ema(self, saved: dict):
        if not saved:
            # a config that tracks EMA, a checkpoint from before it: the
            # shadow starts at the LOADED parameters, so --use_ema scores
            # trained weights
            saved = {name: dict(self.nets[name].named_parameters())
                     for name in self.state.ema}
        ema = {}
        for name, shadow in saved.items():
            params = dict(self.nets[name].named_parameters())
            if set(shadow) != set(params):
                raise KeyError("ema of %s: the checkpoint and the module "
                               "disagree on %s" % (
                                   name, sorted(set(shadow) ^ set(params))))
            ema[name] = [shadow[n].detach().to(p.device, p.dtype).clone()
                         for n, p in params.items()]
        self.state.ema = ema


class StochCycleGAN(CycleGANBase):
    """Stochastic CycleGAN; with ``ignore_noise`` it is the deterministic
    ``cycle_gan`` variant (z forced to ones)."""

    net_names = ("netG_A_B", "netG_B_A", "netD_A", "netD_B")

    def __init__(self, opt: TrainConfig, ignore_noise: bool = False, **kw):
        self.ignore_noise = ignore_noise
        super().__init__(opt, **kw)
        self._train_step = (
            make_stoch_accum_step(opt, ignore_noise) if _accum_k(opt) > 1
            else make_stoch_train_step(opt, ignore_noise))

    def train_instance(self, real_A, real_B, prior_z_B=None,
                       plain_norm: bool = False, pool_draws=None):
        """One two-phase train step.  ``pool_draws`` replaces the pools'
        draws (see :meth:`_pool_draws`).  Returns (losses, visuals) and,
        with ``monitor_gnorm``, gnorms: ordered dicts of device tensors."""
        real_A, real_B = self._tensor(real_A), self._tensor(real_B)
        prior_z_B = self._prep_prior(real_A.shape[0], prior_z_B)
        losses, visuals, gnorms = self._train_step(
            self.state, real_A, real_B, prior_z_B, float(self.old_lr),
            float(self.old_lr_d), plain_norm,
            self._pool_draws(real_A.shape[0], pool_draws))
        return self._format_train_out(
            losses, visuals, gnorms,
            ("D_A", "G_A", "Cyc_A", "D_B", "G_B", "Cyc_B", "P_t_A", "P_f_A",
             "P_t_B", "P_f_B"),
            ("gnorm_G_A_B", "gnorm_G_B_A", "gnorm_D_B", "gnorm_D_A"))

    def generate_cycle(self, real_A, real_B, prior_z_B):
        """A -> B -> A and B -> A -> B, both with ``prior_z_B``; the six
        images in the train step's visuals order."""
        real_A, real_B = self._tensor(real_A), self._tensor(real_B)
        z = self._prep_z(prior_z_B)
        fake_B = self.predict_B(real_A, z)
        fake_A = self.predict_A(real_B)
        rec_A = self.predict_A(fake_B)
        rec_B = self.predict_B(fake_A, z)
        return OrderedDict(zip(VISUALS, (real_A, fake_B, rec_A, real_B,
                                         fake_A, rec_B)))


class AugmentedCycleGAN(CycleGANBase):
    """Augmented CycleGAN: the generator pair plus the latent encoder E_B,
    the three discriminators and one Adam state per network."""

    net_names = ("netG_A_B", "netG_B_A", "netD_A", "netD_B", "netD_z_B",
                 "netE_B")

    def __init__(self, opt: TrainConfig, **kw):
        super().__init__(opt, **kw)
        self._train_step = (make_aug_accum_step(opt) if _accum_k(opt) > 1
                            else make_aug_train_step(opt))
        self._sup_step = make_aug_supervised_step(opt)

    # -- the posterior ------------------------------------------------------
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
            return gauss_reparametrize_eps(mu, logvar, self._randn(mu.shape))
        return mu

    # -- generation helpers -------------------------------------------------
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
        return OrderedDict(zip(VISUALS, (real_A, fake_B, rec_A, real_B,
                                         fake_A, rec_B)))

    def _cycle_z(self, A, B, from_prior: bool) -> torch.Tensor:
        """The posterior z of (A, B), or a prior draw with ``from_prior``."""
        if from_prior:
            return super()._cycle_z(A, B, True)
        return self._posterior_z(A, B)

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
    def train_instance(self, real_A, real_B, prior_z_B=None, eps_post=None,
                       plain_norm: bool = False, pool_draws=None):
        """One two-phase train step.  ``eps_post`` is the noise of the
        reparametrized posterior, (B, nlatent); None draws it here.  (The
        JAX package draws it inside its step from the step's key; passing it
        lets the two packages be compared on the same noise.)
        ``pool_draws`` replaces the pools' draws likewise.  Returns
        (losses, visuals) and, with ``monitor_gnorm``, gnorms: ordered dicts
        of device tensors; nothing is read back to the host."""
        real_A, real_B = self._tensor(real_A), self._tensor(real_B)
        prior_z_B = self._prep_prior(real_A.shape[0], prior_z_B)
        eps_post = self._prep_prior(real_A.shape[0], eps_post)
        losses, visuals, gnorms = self._train_step(
            self.state, real_A, real_B, prior_z_B, eps_post,
            float(self.old_lr), float(self.old_lr_d), plain_norm,
            self._pool_draws(real_A.shape[0], pool_draws))
        return self._format_train_out(
            losses, visuals, gnorms,
            ("D_A", "G_A", "Cyc_A", "Cyc_z_B", "KLD_z_B", "D_B", "G_B",
             "Cyc_B", "D_z_B", "P_t_A", "P_f_A", "P_t_B", "P_f_B"),
            ("gnorm_G_A_B", "gnorm_G_B_A", "gnorm_E_B", "gnorm_D_B",
             "gnorm_D_z_B", "gnorm_D_A", "mu_min", "mu_max", "logvar_min",
             "logvar_max"))

    def supervised_train_instance(self, real_A, real_B, prior_z_B=None,
                                  eps_post=None, plain_norm: bool = False):
        """One supervised step on the paired batch (real_A, real_B);
        ``prior_z_B`` and ``eps_post`` as for :meth:`train_instance`.
        Returns the ordered dict ``S_A S_B KLD_z_B D_z_B gnorm_G_A_B
        gnorm_G_B_A gnorm_E_B gnorm_D_z_B`` of device tensors."""
        real_A, real_B = self._tensor(real_A), self._tensor(real_B)
        prior_z_B = self._prep_prior(real_A.shape[0], prior_z_B)
        eps_post = self._prep_prior(real_A.shape[0], eps_post)
        losses = self._sup_step(self.state, real_A, real_B, prior_z_B,
                                eps_post, float(self.old_lr),
                                float(self.old_lr_d), plain_norm)
        return OrderedDict((k, losses[k]) for k in (
            "S_A", "S_B", "KLD_z_B", "D_z_B", "gnorm_G_A_B", "gnorm_G_B_A",
            "gnorm_E_B", "gnorm_D_z_B"))


def create_model(opt: TrainConfig, testing: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None, **kw):
    """Model dispatch on ``opt.model``; ``testing`` only keeps the model
    from writing ``nets.txt``."""
    kw.update(testing=testing, device=device, generator=generator)
    if opt.model == "stoch_cycle_gan":
        return StochCycleGAN(opt, **kw)
    if opt.model == "cycle_gan":
        return StochCycleGAN(opt, ignore_noise=True, **kw)
    if opt.model == "aug_cycle_gan":
        return AugmentedCycleGAN(opt, **kw)
    raise NotImplementedError("Specified model is not implemented.")
