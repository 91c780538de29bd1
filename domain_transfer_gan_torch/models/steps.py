"""The train steps of the three model variants.

The port of the JAX package's ``models/steps.py``: ``make_stoch_train_step``
(``stoch_cycle_gan``, and ``cycle_gan`` under ``ignore_noise``),
``make_aug_train_step`` (``aug_cycle_gan``) and ``make_aug_supervised_step``
(its supervised step on paired batches).  Each runs the whole D-then-G
sequence of one iteration, with no read-back to the host.  What must hold
for the two-phase steps, and does (named for ``aug_cycle_gan``; the stoch
step has no encoder and no latent discriminator):

- the shared forward of ``netG_A_B``, ``netG_B_A`` and ``netE_B`` runs ONCE;
  the D phase sees its outputs detached, the G phase backpropagates through
  its graph;
- the three discriminators are updated (per-network clip + Adam at ``lr_d``)
  BEFORE the G phase scores the fakes against them;
- G-phase gradients are taken w.r.t. the generator and encoder parameters
  only (``torch.autograd.grad`` with explicit inputs), so no discriminator
  gradient accumulates anywhere;
- one z sample (``eps_post``) serves both phases;
- batch-norm running statistics advance once per forward, in the JAX step's
  order (``netD_z_B``: posterior, prior, G phase; ``netE_B``: shared
  forward, z-cycle);
- losses, visuals and gnorms carry the JAX step's keys and come back as
  device tensors.

With ``--pool_size`` the D phase scores the pools' answers
(:func:`models.pool.pool_query` on the detached fakes, with the draws the
model hands in) in place of the fresh fakes; the G phase still scores the
fresh fakes.  With ``--ema`` every step ends with
:func:`models.state.ema_update`.

Over a mesh of ranks (``parallel/mesh.py``) each rank runs this same step
on its part of the batch and differentiates its own loss.  Under a space
axis a term over row-sliced tensors (the image L1 cycles) is the mean over
the rank's rows, the slices being equal, and a term computed after a
gather (the edges discriminator's logit, the PatchGAN map past its
gathered layers, ``netE_B``'s mu / logvar and everything of z: the z-cycle,
KLD, ``netD_z_B``) is the same on every space rank; every collective's
backward sums what the ranks hand it, so the mean over the space ranks of
their gradients, taken with the data axis's in :func:`_apply`, is one
process's gradient, and neither kind of term is counted S times.

The loss assembly of the two phases (:func:`encode`, :func:`d_losses`,
:func:`g_losses`) is shared with the ``--grad_accum`` steps of
``models/accum.py``, which run it per microbatch.  The supervised step is
described where it is made.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import torch

from ..config import TrainConfig
from ..parallel import multihost
from ..parallel.mesh import slices_of
from ..ops.numerics import (
    criterion_gan,
    gauss_reparametrize_eps,
    kld_std_gauss,
    l1_loss,
    log_prob_gaussian,
)
from .pool import pool_query
from .state import TrainState, apply_net_update, ema_update

D_NAMES = ("netD_A", "netD_B", "netD_z_B")
G_NAMES = ("netG_A_B", "netG_B_A", "netE_B")


def flat2d(x: torch.Tensor) -> torch.Tensor:
    """Collapse a discriminator prediction map to (B, -1)."""
    return x.reshape(x.shape[0], -1)


def make_score_pair(nets, concat_d: bool, plain_norm: bool = False):
    """(fake_pred, real_pred) scorer for an image discriminator: one
    concatenated fake|real forward when the norms are per-sample (the same
    numbers, half the launches), two forwards otherwise (batch norm couples
    the samples of a batch, and its statistics advance per forward)."""
    def score_pair(name, fake, real):
        net = nets[name]
        if concat_d:
            pred = net(torch.cat([fake, real], dim=0), plain_norm=plain_norm)
            pf, pt = pred.chunk(2, dim=0)
            return flat2d(pf), flat2d(pt)
        pf = net(fake, plain_norm=plain_norm)
        pt = net(real, plain_norm=plain_norm)
        return flat2d(pf), flat2d(pt)
    return score_pair


def _params(nets, names) -> Dict[str, List[torch.Tensor]]:
    return {k: list(nets[k].parameters()) for k in names}


def _grads(loss, params: Dict[str, List[torch.Tensor]]):
    """d loss / d params per network; a parameter the loss does not reach
    gets zeros (the JAX step differentiates w.r.t. the whole tree)."""
    flat = [p for ps in params.values() for p in ps]
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    got = [torch.zeros_like(p) if g is None else g
           for p, g in zip(flat, got)]
    out, i = {}, 0
    for k, ps in params.items():
        out[k] = got[i:i + len(ps)]
        i += len(ps)
    return out


def _apply(state: TrainState, grads: Dict[str, List[torch.Tensor]],
           lr: float, cfg: TrainConfig,
           gnorms: Dict[str, torch.Tensor]) -> None:
    """Per-net clip + Adam at ``lr`` with ``grads`` (by net name); each
    net's pre-clip norm goes to ``gnorms["gnorm_" + short]``.  On a rank's
    part of a global batch (``multihost.sharded``) each net's gradients
    are first averaged, in one flat all-reduce, over the ranks that hold
    the same model slice (``data x space x pipe``, ``parallel/mesh.py``),
    so the clip sees the global gradient; under a model axis the leaves it
    leaves whole are averaged over every rank (:func:`_reduce_sliced`) and
    the clip's norm sums the sliced leaves' squares over the model ranks
    and counts the whole leaves once."""
    mesh = multihost.shard_info()
    for k, g in grads.items():
        net = state.nets[k]
        axis, dims = slices_of(net) or (None, {})
        sliced = [d is not None for d in dims.values()]
        gnorm = None
        if any(sliced):
            g = _reduce_sliced(g, sliced, mesh)
            gnorm = sliced_global_norm(g, sliced, axis)
        elif mesh is not None:
            g = multihost.all_reduce_mean_list(g, mesh.replica)
        extra = {} if gnorm is None else {"gnorm": gnorm}
        gnorms["gnorm_" + k[3:]] = apply_net_update(
            list(net.parameters()), state.opt_state[k], g, lr,
            cfg.max_gnorm, cfg.beta1, **extra)


def _reduce_sliced(grads, sliced: List[bool], mesh):
    """A net's gradients under a model axis: the slices averaged over the
    ranks holding the same slice (``data x space x pipe``), the whole
    leaves over every rank.  The model ranks compute a whole leaf's
    gradient alike up to the rounding of the card's own reductions, so the
    mean over them too keeps their copies of it equal."""
    if mesh is None:
        return list(grads)
    parts = [g for g, s in zip(grads, sliced) if s]
    whole = [g for g, s in zip(grads, sliced) if not s]
    parts = multihost.all_reduce_mean_list(parts, mesh.replica)
    if whole:
        whole = multihost.all_reduce_mean_list(whole)
    it_p, it_w = iter(parts), iter(whole)
    return [next(it_p) if s else next(it_w) for s in sliced]


def sliced_global_norm(grads: List[torch.Tensor], sliced: List[bool],
                       axis) -> torch.Tensor:
    """The global norm of a net's gradient whose leaves ``sliced`` are
    this rank's slices over the model ``axis``: their squares summed over
    it, the whole leaves' counted once."""
    zero = grads[0].new_zeros((), dtype=torch.float32)
    part = sum((g.float().pow(2).sum() for g, s in zip(grads, sliced) if s),
               zero)
    whole = sum((g.float().pow(2).sum() for g, s in zip(grads, sliced)
                 if not s), zero)
    part = multihost.all_reduce_(part.reshape(1).clone(), axis=axis)[0]
    return torch.sqrt(part + whole)


def _update(state: TrainState, names, loss, lr: float, cfg: TrainConfig,
            gnorms: Dict[str, torch.Tensor]) -> None:
    """d loss / d params of the nets ``names``, then :func:`_apply`."""
    _apply(state, _grads(loss, _params(state.nets, names)), lr, cfg, gnorms)


def _d_fakes(state: TrainState, fake_A, fake_B, pool_draws):
    """What the D phase scores as fakes: the detached fakes, or with pools
    the pools' answers to them (the pools advance in place).  On a rank's
    part the pools answer the gathered fakes (all rows under a space axis,
    every batch slice) with the full batch's draws and the rank takes its
    part, so every rank's pools stay the single process's."""
    fake_A, fake_B = fake_A.detach(), fake_B.detach()
    if not state.pools:
        return fake_A, fake_B
    mesh = multihost.shard_info()
    out = []
    for name, fake in (("fake_A", fake_A), ("fake_B", fake_B)):
        if mesh is not None:
            fake = multihost.all_gather_cat(fake, mesh.space, 1)
            fake = multihost.all_gather_cat(fake, mesh.batch)
        state.pools[name], d_fake = pool_query(state.pools[name], fake,
                                               *pool_draws[name])
        if mesh is not None:
            b, sp = mesh.batch, mesh.space
            d_fake = multihost.local_rows(d_fake, b.index, b.size)
            d_fake = multihost.local_rows(d_fake, sp.index, sp.size, 1)
        out.append(d_fake)
    return tuple(out)


def _detached(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in d.items()}


def encode(cfg: TrainConfig, nets, fake_A, real_B, eps_post,
           plain_norm: bool = False):
    """The encoder's posterior of (fake_A, real_B): (post_z, mu,
    logvar_eff), float32; without ``stoch_enc`` post_z is mu and
    logvar_eff is zeros."""
    enc_in = torch.cat([fake_A, real_B], dim=-1) if cfg.enc_A_B else real_B
    mu, logvar = nets["netE_B"](enc_in, plain_norm=plain_norm)
    mu, logvar = mu.float(), logvar.float()
    if cfg.stoch_enc:
        return gauss_reparametrize_eps(mu, logvar, eps_post), mu, logvar
    return mu, mu, logvar * 0.0


def d_losses(cfg: TrainConfig, nets, score_pair, fakes, reals,
             latent=None, plain_norm: bool = False):
    """The D phase's loss: the image discriminators on ``fakes`` = (fake_A,
    fake_B) against ``reals`` = (real_A, real_B) and, given ``latent`` =
    (post_z, prior_z), the latent discriminator on the detached posterior
    against the prior.  Returns (loss, logged losses, detached)."""
    gan = functools.partial(criterion_gan, use_sigmoid=cfg.use_sigmoid)
    (fake_A, fake_B), (real_A, real_B) = fakes, reals
    pf_A, pt_A = score_pair("netD_A", fake_A, real_A)
    pf_B, pt_B = score_pair("netD_B", fake_B, real_B)
    loss_D_A = 0.5 * (gan(pf_A, False) + gan(pt_A, True))
    loss_D_B = 0.5 * (gan(pf_B, False) + gan(pt_B, True))
    loss = loss_D_A + loss_D_B
    logged = {"D_A": loss_D_A, "D_B": loss_D_B,
              "P_t_A": pt_A.float().mean(), "P_t_B": pt_B.float().mean()}
    if latent is not None:
        post_z, prior_z = latent
        pz_post = nets["netD_z_B"](post_z.detach(), plain_norm=plain_norm)
        pz_prior = nets["netD_z_B"](prior_z, plain_norm=plain_norm)
        loss_D_z_B = 0.5 * (gan(pz_post, False) + gan(pz_prior, True))
        if cfg.z_gan and not cfg.stoch_enc:
            loss = loss + loss_D_z_B
        logged["D_z_B"] = loss_D_z_B
    return loss, _detached(logged)


def g_losses(cfg: TrainConfig, nets, fakes, reals, prior_z, post=None,
             plain_norm: bool = False):
    """The G phase's loss: the phase-0 ``fakes`` = (fake_A, fake_B) scored
    by the (updated) image discriminators, and the A and B cycles against
    ``reals``.  Given ``post`` = (post_z, mu, logvar_eff) of :func:`encode`,
    also the latent GAN term, the z-cycle (the encoder recovering
    ``prior_z`` from fake_B) and the KLD, and rec_B decodes fake_A with
    post_z; else with ``prior_z``.  The nets run in the JAX step's order.
    Returns (loss, logged losses detached, (rec_A, rec_B))."""
    gan = functools.partial(criterion_gan, use_sigmoid=cfg.use_sigmoid)
    kw = dict(plain_norm=plain_norm)
    (fake_A, fake_B), (real_A, real_B) = fakes, reals
    pf_A = nets["netD_A"](fake_A, **kw)
    loss_G_A = gan(flat2d(pf_A), True)
    pf_B = nets["netD_B"](fake_B, **kw)
    loss_G_B = gan(flat2d(pf_B), True)
    logged = {"G_A": loss_G_A, "G_B": loss_G_B,
              "P_f_A": pf_A.float().mean(), "P_f_B": pf_B.float().mean()}
    if post is not None:
        post_z, mu_r, logvar_r_eff = post
        loss_G_z_B = gan(nets["netD_z_B"](post_z, **kw), True)

    rec_A = nets["netG_B_A"](fake_B, **kw)
    loss_cycle_A = l1_loss(rec_A, real_A)
    if post is None:
        rec_B = nets["netG_A_B"](fake_A, prior_z, **kw)
    else:
        # z-cycle: recover the prior z from (A, fake_B)
        enc_in2 = (torch.cat([real_A, fake_B], dim=-1) if cfg.enc_A_B
                   else fake_B)
        mu_f, logvar_f = nets["netE_B"](enc_in2, **kw)
        mu_f, logvar_f = mu_f.float(), logvar_f.float()
        if cfg.stoch_enc:
            loss_cycle_z_B = -1.0 * torch.mean(
                log_prob_gaussian(prior_z, mu_f, logvar_f))
        else:
            loss_cycle_z_B = l1_loss(mu_f, prior_z)
        kld_z_B = torch.mean(kld_std_gauss(mu_r, logvar_r_eff))
        rec_B = nets["netG_A_B"](fake_A, post_z, **kw)
    loss_cycle_B = l1_loss(rec_B, real_B)

    loss = (loss_G_A + loss_G_B + loss_cycle_A * cfg.lambda_A
            + loss_cycle_B * cfg.lambda_B)
    logged.update({"Cyc_A": loss_cycle_A, "Cyc_B": loss_cycle_B})
    if post is not None:
        loss = loss + loss_cycle_z_B * cfg.lambda_z_B
        if cfg.stoch_enc:
            loss = loss + kld_z_B * cfg.lambda_z_B
        if cfg.z_gan and not cfg.stoch_enc:
            loss = loss + loss_G_z_B
        logged.update({"Cyc_z_B": loss_cycle_z_B, "KLD_z_B": kld_z_B})
    return loss, _detached(logged), (rec_A, rec_B)


def _visuals(real_A, real_B, fakes, recs):
    (fake_A, fake_B), (rec_A, rec_B) = fakes, recs
    return {"real_A": real_A, "fake_B": fake_B.detach(),
            "rec_A": rec_A.detach(), "real_B": real_B,
            "fake_A": fake_A.detach(), "rec_B": rec_B.detach()}


def make_stoch_train_step(cfg: TrainConfig, ignore_noise: bool):
    """The two-phase step of ``stoch_cycle_gan`` (``cycle_gan`` under
    ``ignore_noise``, where prior z is replaced by ones): the generators'
    shared forward once, the two image discriminators on the detached fakes,
    then the generators against the updated discriminators with the A and B
    cycles (rec_B decodes fake_A with the prior z)."""
    concat_d = cfg.norm != "batch"

    def step(state: TrainState, real_A, real_B, prior_z, lr: float,
             lr_d: float, plain_norm: bool = False, pool_draws=None):
        """One iteration, in place on ``state``; arguments as for the
        ``aug_cycle_gan`` step, without ``eps_post``.  Returns (losses,
        visuals, gnorms), dicts of device tensors."""
        nets = state.nets
        kw = dict(plain_norm=plain_norm)
        for net in nets.values():
            net.train()
        if ignore_noise:
            prior_z = torch.ones_like(prior_z)
        reals = real_A, real_B

        # ----- shared forward (phase 0), its graph kept for the G phase ---
        fake_B = nets["netG_A_B"](real_A, prior_z, **kw)
        fake_A = nets["netG_B_A"](real_B, **kw)
        fakes = fake_A, fake_B

        # ----- phase 1: discriminators on detached fakes ------------------
        loss_D, d_logged = d_losses(
            cfg, nets, make_score_pair(nets, concat_d, plain_norm),
            _d_fakes(state, fake_A, fake_B, pool_draws), reals,
            plain_norm=plain_norm)
        gnorms = {}
        _update(state, ("netD_A", "netD_B"), loss_D, lr_d, cfg, gnorms)

        # ----- phase 2: generators vs the UPDATED discriminators ----------
        loss_G, g_logged, recs = g_losses(cfg, nets, fakes, reals, prior_z,
                                          plain_norm=plain_norm)
        _update(state, ("netG_A_B", "netG_B_A"), loss_G, lr, cfg, gnorms)
        state.step += 1
        ema_update(state.ema, nets, cfg.ema)
        return (dict(d_logged, **g_logged),
                _visuals(real_A, real_B, fakes, recs), gnorms)

    return step


def make_aug_train_step(cfg: TrainConfig):
    # netD_z_B uses BatchNorm1d: always separate forwards
    concat_d = cfg.norm != "batch"

    def step(state: TrainState, real_A, real_B, prior_z, eps_post,
             lr: float, lr_d: float, plain_norm: bool = False,
             pool_draws=None):
        """One iteration, in place on ``state``.  real_A/real_B: NHWC float32
        on the nets' device; prior_z, eps_post: (B, nlatent); lr, lr_d:
        Python floats.  ``plain_norm`` sends every instance norm through its
        plain version (the twin the kernels are held against).
        ``pool_draws`` (with pools): ``{"fake_A": (coin, slot), "fake_B":
        (coin, slot)}``.  Returns (losses, visuals, gnorms), dicts of device
        tensors."""
        nets = state.nets
        kw = dict(plain_norm=plain_norm)
        for net in nets.values():
            net.train()
        reals = real_A, real_B

        # ----- shared forward (phase 0), its graph kept for the G phase ---
        fake_B = nets["netG_A_B"](real_A, prior_z, **kw)
        fake_A = nets["netG_B_A"](real_B, **kw)
        post = encode(cfg, nets, fake_A, real_B, eps_post, plain_norm)
        fakes = fake_A, fake_B

        # ----- phase 1: discriminators on detached inputs -----------------
        loss_D, d_logged = d_losses(
            cfg, nets, make_score_pair(nets, concat_d, plain_norm),
            _d_fakes(state, fake_A, fake_B, pool_draws), reals,
            latent=(post[0], prior_z), plain_norm=plain_norm)
        gnorms = {}
        _update(state, D_NAMES, loss_D, lr_d, cfg, gnorms)

        # ----- phase 2: generators/encoder vs the UPDATED discriminators --
        loss_G, g_logged, recs = g_losses(cfg, nets, fakes, reals, prior_z,
                                          post=post, plain_norm=plain_norm)
        _update(state, G_NAMES, loss_G, lr, cfg, gnorms)
        state.step += 1
        ema_update(state.ema, nets, cfg.ema)

        with torch.no_grad():
            _, mu_r, logvar_r_eff = post
            gnorms.update({
                "mu_min": mu_r.min(), "mu_max": mu_r.max(),
                "logvar_min": logvar_r_eff.min(),
                "logvar_max": logvar_r_eff.max(),
            })
        return (dict(d_logged, **g_logged),
                _visuals(real_A, real_B, fakes, recs), gnorms)

    return step


def make_aug_supervised_step(cfg: TrainConfig):
    """The supervised step of ``aug_cycle_gan`` on a paired batch: the
    encoder's posterior z of (A, B), the latent discriminator on it (its D
    phase, then the generators' z-GAN term against the updated net), and L1
    losses of both generators against the pair.

    - The encoder runs ONCE, with its graph: its batch norm advances its
      running statistics once per step, as the JAX step's (whose two encoder
      forwards XLA merges into one); the D phase sees ``post_z`` detached.
    - ``netD_z_B``'s statistics thread from its D phase into the G phase.
    - ``netD_B`` takes an Adam step with a zero gradient at ``lr_d``: the
      upstream shares one optimizer between ``netD_B`` and ``netD_z_B``, so
      momentum decay and bias correction move ``netD_B`` and its Adam count
      advances.
    - ``state.step`` does not advance (the JAX step sets no ``step``).
    """
    gan = functools.partial(criterion_gan, use_sigmoid=cfg.use_sigmoid)
    stoch_enc = bool(cfg.stoch_enc)
    z_gan = bool(cfg.z_gan)

    def step(state: TrainState, real_A, real_B, prior_z, eps_post,
             lr: float, lr_d: float, plain_norm: bool = False):
        """One supervised iteration, in place on ``state``; arguments as for
        the two-phase step.  Returns the losses and gnorms as one dict of
        device tensors."""
        nets = state.nets
        kw = dict(plain_norm=plain_norm)
        for net in nets.values():
            net.train()

        post_z, mu, logvar_eff = encode(cfg, nets, real_A, real_B, eps_post,
                                        plain_norm)

        # ----- the latent discriminator on the detached posterior ---------
        pz_post = nets["netD_z_B"](post_z.detach(), **kw)
        pz_prior = nets["netD_z_B"](prior_z, **kw)
        loss_D_z_B = 0.5 * (gan(pz_post, False) + gan(pz_prior, True))
        gnorms = {}
        _update(state, ("netD_z_B",), loss_D_z_B, lr_d, cfg, gnorms)
        d_B = list(nets["netD_B"].parameters())
        apply_net_update(d_B, state.opt_state["netD_B"],
                         [torch.zeros_like(p) for p in d_B], lr_d,
                         cfg.max_gnorm, cfg.beta1)

        # ----- generators and encoder -------------------------------------
        pred_B = nets["netG_A_B"](real_A, post_z, **kw)
        pred_A = nets["netG_B_A"](real_B, **kw)
        loss_sup_A = l1_loss(pred_A, real_A)
        loss_sup_B = l1_loss(pred_B, real_B)
        loss_G_z_B = gan(nets["netD_z_B"](post_z, **kw), True)
        kld_z_B = torch.mean(kld_std_gauss(mu, logvar_eff))
        loss_G = loss_sup_A * cfg.lambda_sup_A + loss_sup_B * cfg.lambda_sup_B
        if stoch_enc:
            loss_G = loss_G + kld_z_B * cfg.lambda_z_B
        if z_gan and not stoch_enc:
            loss_G = loss_G + loss_G_z_B
        _update(state, G_NAMES, loss_G, lr, cfg, gnorms)
        ema_update(state.ema, nets, cfg.ema)

        losses = _detached({"S_A": loss_sup_A, "S_B": loss_sup_B,
                            "KLD_z_B": kld_z_B, "D_z_B": loss_D_z_B})
        losses.update(gnorms)
        return losses

    return step
