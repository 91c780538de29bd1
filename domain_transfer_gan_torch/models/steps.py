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

All config switches (stoch_enc / z_gan / enc_A_B / use_sigmoid / norm /
ignore_noise) are read once when the step is made.  The supervised step is
described where it is made.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import torch

from ..config import TrainConfig
from ..ops.numerics import (
    criterion_gan,
    gauss_reparametrize_eps,
    kld_std_gauss,
    l1_loss,
    log_prob_gaussian,
)
from .state import TrainState, apply_net_update

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


def _update(state: TrainState, names, loss, lr: float, cfg: TrainConfig,
            gnorms: Dict[str, torch.Tensor]) -> None:
    """d loss / d params of the nets ``names``, then per-net clip + Adam at
    ``lr``; each net's pre-clip norm goes to ``gnorms["gnorm_" + short]``."""
    params = _params(state.nets, names)
    grads = _grads(loss, params)
    for k in names:
        gnorms["gnorm_" + k[3:]] = apply_net_update(
            params[k], state.opt_state[k], grads[k], lr, cfg.max_gnorm,
            cfg.beta1)


def make_stoch_train_step(cfg: TrainConfig, ignore_noise: bool):
    """The two-phase step of ``stoch_cycle_gan`` (``cycle_gan`` under
    ``ignore_noise``, where prior z is replaced by ones): the generators'
    shared forward once, the two image discriminators on the detached fakes,
    then the generators against the updated discriminators with the A and B
    cycles (rec_B decodes fake_A with the prior z)."""
    gan = functools.partial(criterion_gan, use_sigmoid=cfg.use_sigmoid)
    concat_d = cfg.norm != "batch"

    def step(state: TrainState, real_A, real_B, prior_z, lr: float,
             lr_d: float, plain_norm: bool = False):
        """One iteration, in place on ``state``; arguments as for the
        ``aug_cycle_gan`` step, without ``eps_post``.  Returns (losses,
        visuals, gnorms), dicts of device tensors."""
        nets = state.nets
        kw = dict(plain_norm=plain_norm)
        for net in nets.values():
            net.train()
        if ignore_noise:
            prior_z = torch.ones_like(prior_z)

        # ----- shared forward (phase 0), its graph kept for the G phase ---
        fake_B = nets["netG_A_B"](real_A, prior_z, **kw)
        fake_A = nets["netG_B_A"](real_B, **kw)

        # ----- phase 1: discriminators on detached fakes ------------------
        score_pair = make_score_pair(nets, concat_d, plain_norm)
        pf_A, pt_A = score_pair("netD_A", fake_A.detach(), real_A)
        pf_B, pt_B = score_pair("netD_B", fake_B.detach(), real_B)
        loss_D_A = 0.5 * (gan(pf_A, False) + gan(pt_A, True))
        loss_D_B = 0.5 * (gan(pf_B, False) + gan(pt_B, True))
        P_t_A, P_t_B = pt_A.float().mean(), pt_B.float().mean()
        gnorms = {}
        _update(state, ("netD_A", "netD_B"), loss_D_A + loss_D_B, lr_d, cfg,
                gnorms)

        # ----- phase 2: generators vs the UPDATED discriminators ----------
        pf_A = nets["netD_A"](fake_A, **kw)
        loss_G_A = gan(flat2d(pf_A), True)
        pf_B = nets["netD_B"](fake_B, **kw)
        loss_G_B = gan(flat2d(pf_B), True)
        rec_A = nets["netG_B_A"](fake_B, **kw)
        loss_cycle_A = l1_loss(rec_A, real_A)
        rec_B = nets["netG_A_B"](fake_A, prior_z, **kw)
        loss_cycle_B = l1_loss(rec_B, real_B)
        loss_G = (loss_G_A + loss_G_B + loss_cycle_A * cfg.lambda_A
                  + loss_cycle_B * cfg.lambda_B)
        _update(state, ("netG_A_B", "netG_B_A"), loss_G, lr, cfg, gnorms)
        state.step += 1

        with torch.no_grad():
            losses = {
                "D_A": loss_D_A, "G_A": loss_G_A, "Cyc_A": loss_cycle_A,
                "D_B": loss_D_B, "G_B": loss_G_B, "Cyc_B": loss_cycle_B,
                "P_t_A": P_t_A, "P_f_A": pf_A.float().mean(),
                "P_t_B": P_t_B, "P_f_B": pf_B.float().mean(),
            }
            losses = {k: v.detach() for k, v in losses.items()}
            visuals = {"real_A": real_A, "fake_B": fake_B.detach(),
                       "rec_A": rec_A.detach(), "real_B": real_B,
                       "fake_A": fake_A.detach(), "rec_B": rec_B.detach()}
        return losses, visuals, gnorms

    return step


def make_aug_train_step(cfg: TrainConfig):
    gan = functools.partial(criterion_gan, use_sigmoid=cfg.use_sigmoid)
    stoch_enc = bool(cfg.stoch_enc)
    z_gan = bool(cfg.z_gan)
    enc_A_B = bool(cfg.enc_A_B)
    # netD_z_B uses BatchNorm1d: always separate forwards
    concat_d = cfg.norm != "batch"

    def step(state: TrainState, real_A, real_B, prior_z, eps_post,
             lr: float, lr_d: float, plain_norm: bool = False):
        """One iteration, in place on ``state``.  real_A/real_B: NHWC float32
        on the nets' device; prior_z, eps_post: (B, nlatent); lr, lr_d:
        Python floats.  ``plain_norm`` sends every instance norm through its
        plain version (the twin the kernels are held against).  Returns
        (losses, visuals, gnorms), dicts of device tensors."""
        nets = state.nets
        kw = dict(plain_norm=plain_norm)
        for net in nets.values():
            net.train()

        def posterior(a_img, b_img):
            enc_in = torch.cat([a_img, b_img], dim=-1) if enc_A_B else b_img
            mu, logvar = nets["netE_B"](enc_in, **kw)
            mu, logvar = mu.float(), logvar.float()
            if stoch_enc:
                return (gauss_reparametrize_eps(mu, logvar, eps_post), mu,
                        logvar)
            return mu, mu, logvar * 0.0

        # ----- shared forward (phase 0), its graph kept for the G phase ---
        fake_B = nets["netG_A_B"](real_A, prior_z, **kw)
        fake_A = nets["netG_B_A"](real_B, **kw)
        post_z, mu_r, logvar_r_eff = posterior(fake_A, real_B)

        # ----- phase 1: discriminators on detached inputs -----------------
        score_pair = make_score_pair(nets, concat_d, plain_norm)
        pf_A, pt_A = score_pair("netD_A", fake_A.detach(), real_A)
        pf_B, pt_B = score_pair("netD_B", fake_B.detach(), real_B)
        pz_post = nets["netD_z_B"](post_z.detach(), **kw)
        pz_prior = nets["netD_z_B"](prior_z, **kw)
        loss_D_A = 0.5 * (gan(pf_A, False) + gan(pt_A, True))
        loss_D_B = 0.5 * (gan(pf_B, False) + gan(pt_B, True))
        loss_D_z_B = 0.5 * (gan(pz_post, False) + gan(pz_prior, True))
        loss_D = loss_D_A + loss_D_B
        if z_gan and not stoch_enc:
            loss_D = loss_D + loss_D_z_B
        P_t_A, P_t_B = pt_A.float().mean(), pt_B.float().mean()

        gnorms = {}
        _update(state, D_NAMES, loss_D, lr_d, cfg, gnorms)

        # ----- phase 2: generators/encoder vs the UPDATED discriminators --
        pf_A = nets["netD_A"](fake_A, **kw)
        loss_G_A = gan(flat2d(pf_A), True)
        pf_B = nets["netD_B"](fake_B, **kw)
        loss_G_B = gan(flat2d(pf_B), True)
        loss_G_z_B = gan(nets["netD_z_B"](post_z, **kw), True)

        rec_A = nets["netG_B_A"](fake_B, **kw)
        loss_cycle_A = l1_loss(rec_A, real_A)

        # z-cycle: recover the prior z from (A, fake_B)
        enc_in2 = torch.cat([real_A, fake_B], dim=-1) if enc_A_B else fake_B
        mu_f, logvar_f = nets["netE_B"](enc_in2, **kw)
        mu_f, logvar_f = mu_f.float(), logvar_f.float()
        if stoch_enc:
            loss_cycle_z_B = -1.0 * torch.mean(
                log_prob_gaussian(prior_z, mu_f, logvar_f))
        else:
            loss_cycle_z_B = l1_loss(mu_f, prior_z)

        kld_z_B = torch.mean(kld_std_gauss(mu_r, logvar_r_eff))

        rec_B = nets["netG_A_B"](fake_A, post_z, **kw)
        loss_cycle_B = l1_loss(rec_B, real_B)

        loss_G = (loss_G_A + loss_G_B
                  + loss_cycle_A * cfg.lambda_A
                  + loss_cycle_B * cfg.lambda_B
                  + loss_cycle_z_B * cfg.lambda_z_B)
        if stoch_enc:
            loss_G = loss_G + kld_z_B * cfg.lambda_z_B
        if z_gan and not stoch_enc:
            loss_G = loss_G + loss_G_z_B

        _update(state, G_NAMES, loss_G, lr, cfg, gnorms)
        state.step += 1

        with torch.no_grad():
            gnorms.update({
                "mu_min": mu_r.min(), "mu_max": mu_r.max(),
                "logvar_min": logvar_r_eff.min(),
                "logvar_max": logvar_r_eff.max(),
            })
            losses = {
                "D_A": loss_D_A, "G_A": loss_G_A, "Cyc_A": loss_cycle_A,
                "Cyc_z_B": loss_cycle_z_B, "KLD_z_B": kld_z_B,
                "D_B": loss_D_B, "G_B": loss_G_B, "Cyc_B": loss_cycle_B,
                "D_z_B": loss_D_z_B,
                "P_t_A": P_t_A, "P_f_A": pf_A.float().mean(),
                "P_t_B": P_t_B, "P_f_B": pf_B.float().mean(),
            }
            losses = {k: v.detach() for k, v in losses.items()}
            visuals = {"real_A": real_A, "fake_B": fake_B.detach(),
                       "rec_A": rec_A.detach(), "real_B": real_B,
                       "fake_A": fake_A.detach(), "rec_B": rec_B.detach()}
        return losses, visuals, gnorms

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
    enc_A_B = bool(cfg.enc_A_B)

    def step(state: TrainState, real_A, real_B, prior_z, eps_post,
             lr: float, lr_d: float, plain_norm: bool = False):
        """One supervised iteration, in place on ``state``; arguments as for
        the two-phase step.  Returns the losses and gnorms as one dict of
        device tensors."""
        nets = state.nets
        kw = dict(plain_norm=plain_norm)
        for net in nets.values():
            net.train()

        enc_in = torch.cat([real_A, real_B], dim=-1) if enc_A_B else real_B
        mu, logvar = nets["netE_B"](enc_in, **kw)
        mu, logvar = mu.float(), logvar.float()
        if stoch_enc:
            post_z, logvar_eff = gauss_reparametrize_eps(mu, logvar,
                                                         eps_post), logvar
        else:
            post_z, logvar_eff = mu, logvar * 0.0

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

        losses = {"S_A": loss_sup_A, "S_B": loss_sup_B, "KLD_z_B": kld_z_B,
                  "D_z_B": loss_D_z_B}
        losses = {k: v.detach() for k, v in losses.items()}
        losses.update(gnorms)
        return losses

    return step
