"""Training state: the networks and their per-network optimizers.

Optimizer semantics follow the JAX package's ``models/state.py``:

- Adam(beta1 = opt.beta1, beta2 = 0.999, eps = 1e-8 outside the sqrt), the
  bias-corrected moments as ``optax.scale_by_adam`` forms them;
- one optimizer state per network, and per-NETWORK global-norm clipping to
  ``max_gnorm`` (``ops.numerics.clip_grads_torchlike``) before Adam;
- the learning rates are per-call values (generators and encoder at ``lr``,
  discriminators at ``lr_d``), so a decay schedule driven from outside never
  touches optimizer state.

Unlike the JAX package, whose state is an immutable pytree, the port updates
parameters and moments in place: ``apply_net_update`` mutates its arguments.
Parameters and moments are float32 whatever the compute dtype.

The opt-in extras live here too: the fake-image pools (``--pool_size``,
``models/pool.py``), the EMA shadows of the generators and the encoder
(``--ema``, :func:`ema_update`) and ``--remat``, which runs the two
generators under ``torch.utils.checkpoint`` while grad is enabled
(``nn.networks._Net._maybe_remat``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..config import TrainConfig
from ..nn import networks as N
from ..ops.numerics import clip_grads_torchlike
from .pool import PoolState, init_pool

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the nets an EMA shadow tracks, where the model has them
EMA_NETS = ("netG_A_B", "netG_B_A", "netE_B")


@dataclass
class AdamState:
    """First and second moments of one network's parameters, in
    ``net.parameters()`` order, and the number of updates taken."""

    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int = 0


@dataclass
class TrainState:
    """Networks by name ('netG_A_B', 'netG_B_A', 'netD_A', 'netD_B' and, for
    aug_cycle_gan, 'netE_B', 'netD_z_B'), one :class:`AdamState` each, the
    number of train steps taken, the fake-image pools ('fake_A', 'fake_B';
    empty without ``--pool_size``) and the EMA shadows (per tracked net its
    parameters' shadows in ``net.parameters()`` order; empty without
    ``--ema``).  Batch-norm running statistics are buffers of the
    networks."""

    nets: Dict[str, nn.Module]
    opt_state: Dict[str, AdamState]
    step: int = 0
    pools: Dict[str, PoolState] = field(default_factory=dict)
    ema: Dict[str, List[torch.Tensor]] = field(default_factory=dict)


@torch.no_grad()
def ema_update(ema: Dict[str, List[torch.Tensor]], nets: Dict[str, nn.Module],
               decay: float) -> None:
    """One EMA step over the tracked nets, in place and in float32:
    ``e = decay * e + (1 - decay) * p`` for every parameter (not the
    buffers).  A no-op when EMA is off (empty ``ema`` or ``decay <= 0``)."""
    if not ema or decay <= 0.0:
        return
    for name, shadow in ema.items():
        torch._foreach_mul_(shadow, decay)
        torch._foreach_add_(shadow, list(nets[name].parameters()),
                            alpha=1.0 - decay)


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(mu=[torch.zeros_like(p) for p in params],
                     nu=[torch.zeros_like(p) for p in params])


@torch.no_grad()
def apply_net_update(params: Sequence[torch.Tensor], opt: AdamState,
                     grads: Sequence[torch.Tensor], lr: float,
                     max_gnorm: float, beta1: float,
                     beta2: float = 0.999, eps: float = 1e-8,
                     gnorm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """clip (torch-style) -> Adam -> ``p -= lr * update``, in place on
    ``params`` and ``opt``.  Returns the pre-clip gradient norm as a 0-dim
    device tensor; nothing is read back to the host.  ``gnorm``: the
    gradient's global norm where the caller computed it (slices over a
    model axis), else computed here."""
    params = list(params)
    grads, gnorm = clip_grads_torchlike(grads, max_gnorm, gnorm)
    opt.count += 1
    torch._foreach_mul_(opt.mu, beta1)
    torch._foreach_add_(opt.mu, grads, alpha=1.0 - beta1)
    torch._foreach_mul_(opt.nu, beta2)
    torch._foreach_addcmul_(opt.nu, grads, grads, value=1.0 - beta2)
    # update = mu_hat / (sqrt(nu_hat) + eps)
    denom = torch._foreach_div(opt.nu, 1.0 - beta2 ** opt.count)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_addcdiv_(params, opt.mu, denom,
                            value=-lr / (1.0 - beta1 ** opt.count))
    return gnorm


def build_networks(cfg: TrainConfig,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, nn.Module]:
    """The networks of the configured model variant, on the CPU in float32,
    drawn under ``cfg.init_scheme`` from ``generator``.  D_A's width is
    hard-wired to 32 as upstream; the encoder sees ``input_nc + output_nc``
    channels when ``enc_A_B``."""
    generator = generator or torch.Generator()
    kw = dict(init_scheme=cfg.init_scheme, generator=generator)
    nets = {
        "netG_A_B": N.define_stochastic_G(
            nlatent=cfg.nlatent, input_nc=cfg.input_nc,
            output_nc=cfg.output_nc, ngf=cfg.ngf,
            use_dropout=cfg.use_dropout, n_blocks=cfg.n_blocks, **kw),
        "netG_B_A": N.define_G(
            input_nc=cfg.output_nc, output_nc=cfg.input_nc, ngf=cfg.ngf,
            norm=cfg.norm, use_dropout=cfg.use_dropout,
            n_blocks=cfg.n_blocks, **kw),
        "netD_A": N.define_D_A(input_nc=cfg.input_nc, ndf=32, norm=cfg.norm,
                               use_sigmoid=cfg.use_sigmoid, **kw),
        "netD_B": N.define_D_B(input_nc=cfg.output_nc, ndf=cfg.ndf,
                               norm=cfg.norm, use_sigmoid=cfg.use_sigmoid,
                               **kw),
    }
    if cfg.model == "aug_cycle_gan":
        enc_input_nc = cfg.output_nc + (cfg.input_nc if cfg.enc_A_B else 0)
        # the encoder's flatten assumes 64x64 inputs; at any other
        # resolution the final feature map is averaged instead
        nets["netE_B"] = N.define_E(
            nlatent=cfg.nlatent, input_nc=enc_input_nc, nef=cfg.nef,
            norm="batch", adaptive_pool=cfg.grid_size != 64, **kw)
        nets["netD_z_B"] = N.define_LAT_D(
            nlatent=cfg.nlatent, ndf=cfg.ndf, use_sigmoid=cfg.use_sigmoid,
            **kw)
    return nets


def init_state(cfg: TrainConfig, device="cuda",
               generator: Optional[torch.Generator] = None,
               image_size: Optional[int] = None) -> TrainState:
    """Networks on ``device`` (float32 parameters, computing in
    ``cfg.compute_dtype``), fresh optimizer states and, where the config
    asks for them, empty pools and EMA shadows equal to the parameters."""
    hw = image_size or cfg.grid_size
    if hw < 64:
        raise ValueError(
            "grid_size/image_size must be >= 64 (got %d): the reference's "
            "edges-discriminator and latent-encoder heads collapse a 4x"
            "stride-2 stack into a valid 4x4 conv, which is empty below "
            "64px" % hw)
    if cfg.compute_dtype not in DTYPES:
        raise ValueError("compute_dtype must be one of %r, got %r"
                         % (tuple(DTYPES), cfg.compute_dtype))
    nets = build_networks(cfg, generator)
    for net in nets.values():
        net.place(torch.device(device), DTYPES[cfg.compute_dtype],
                  cast_weights=False)
    if cfg.remat:
        for name in ("netG_A_B", "netG_B_A"):
            nets[name].remat = True
    opt_state = {name: adam_init(list(net.parameters()))
                 for name, net in nets.items()}
    pools = {}
    if cfg.pool_size > 0:
        pools = {
            "fake_A": init_pool(cfg.pool_size, (hw, hw, cfg.input_nc),
                                device=device),
            "fake_B": init_pool(cfg.pool_size, (hw, hw, cfg.output_nc),
                                device=device),
        }
    ema = {}
    if cfg.ema > 0.0:
        ema = {name: [p.detach().clone() for p in nets[name].parameters()]
               for name in EMA_NETS if name in nets}
    return TrainState(nets=nets, opt_state=opt_state, pools=pools, ema=ema)
