"""Gradient accumulation: the port of the JAX package's ``models/accum.py``.

``--grad_accum K`` runs the two-phase step over K microbatches of B / K
samples and applies each phase's optimizers once, to the microbatch mean of
the gradients, so the activation memory is that of a microbatch while the
step sees the whole batch.  Relative to the fused steps
(``models/steps.py``):

- the phases stay as they are: the discriminators update on the mean
  gradient over detached phase-0 fakes, then the generators and the encoder
  on the mean gradient scored against the UPDATED discriminators; clipping
  and Adam apply once per phase, to the mean;
- microbatch j is the samples ``j, j + K, j + 2K, ...`` of the batch (the
  JAX package's interleaved split), and the visuals come back in the
  batch's order;
- with instance norms only (the default) every loss is a per-sample mean,
  so the step equals the fused step at the whole batch;
- the encoder's and the latent discriminator's batch norms see microbatch
  statistics.  In the D phase the encoder's forward discards its
  running-statistics update (it reads the step-entry statistics, as the JAX
  step does), and ``netD_z_B`` advances twice per microbatch (posterior,
  prior); in the G phase the encoder advances twice per microbatch
  (posterior, z-cycle) and ``netD_z_B`` once;
- the phase-0 forward runs again inside the G phase, per microbatch, with
  the dropout masks of its D-phase run (the state of the dropout generator
  saved before microbatch j's D-phase forward is restored for it); the
  cycle forwards draw fresh masks from where the stream had got to;
- ``eps_post`` is drawn for the whole batch by the caller and split;
  ``mu`` / ``logvar`` ranges are taken over all microbatches.

Refused when the model is built (as the JAX package's ``_check_cfg``): the
fake-image pool, ``--norm batch``, pipeline parallelism and a batch size
that K does not divide; ``--supervised`` is refused by ``models.api``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..config import TrainConfig
from ..nn.norms import running_stats_held
from .state import TrainState, ema_update
from .steps import (
    D_NAMES,
    G_NAMES,
    _apply,
    _grads,
    _params,
    d_losses,
    encode,
    g_losses,
    make_score_pair,
)


def _check_cfg(cfg: TrainConfig, what: str) -> int:
    k = int(cfg.grad_accum or 1)
    if k < 2:
        raise ValueError("%s needs --grad_accum >= 2 (got %d)" % (what, k))
    if cfg.pool_size > 0:
        raise ValueError("--grad_accum does not compose with --pool_size: "
                         "the reference's fake-image pool pushes/samples "
                         "once per step, which has no per-microbatch "
                         "equivalent")
    if cfg.norm == "batch":
        raise ValueError("--grad_accum with --norm batch would switch the "
                         "main networks to per-microbatch statistics; use "
                         "instance norms or drop --grad_accum")
    if cfg.pipeline and cfg.pipeline > 1:
        raise ValueError("--grad_accum does not compose with --pipeline "
                         "(the GPipe schedule already owns the microbatch "
                         "split; raise --microbatches instead)")
    _check_batch(cfg.batchSize, k)
    return k


def _check_batch(batch: int, k: int) -> None:
    if batch % k:
        raise ValueError("batch %d not divisible by --grad_accum %d"
                         % (batch, k))


def _split_micro(x: torch.Tensor, k: int) -> List[torch.Tensor]:
    """Microbatch j of (B, ...) is rows j, j + K, ... (B / K of them)."""
    b = x.shape[0]
    view = x.reshape((b // k, k) + tuple(x.shape[1:]))
    return [view[:, j].contiguous() for j in range(k)]


def _merge_micro(chunks: List[torch.Tensor]) -> torch.Tensor:
    """The microbatches' rows back in the batch's order."""
    return torch.stack(chunks, dim=1).reshape(
        (-1,) + tuple(chunks[0].shape[1:]))


def _add(acc: Optional[Dict], new: Dict) -> Dict:
    """Sum of dicts of tensors or of lists of tensors, key by key."""
    if acc is None:
        return new
    for k, v in new.items():
        if isinstance(v, list):
            torch._foreach_add_(acc[k], v)
        else:
            acc[k] = acc[k] + v
    return acc


def _mean(acc: Dict, k: int) -> Dict:
    out = {}
    for name, v in acc.items():
        out[name] = (torch._foreach_div(v, float(k)) if isinstance(v, list)
                     else v / k)
    return out


class _Masks:
    """Where the dropout masks come from: the state of the nets' dropout
    generator (nothing to do without one)."""

    def __init__(self, gen: Optional[torch.Generator]):
        self.gen = gen

    def get(self):
        return self.gen.get_state() if self.gen is not None else None

    def set(self, state):
        if self.gen is not None:
            self.gen.set_state(state)


def _merged_visuals(real_A, real_B, vis):
    merged = {k: _merge_micro(v) for k, v in vis.items()}
    return {"real_A": real_A, "fake_B": merged["fake_B"],
            "rec_A": merged["rec_A"], "real_B": real_B,
            "fake_A": merged["fake_A"], "rec_B": merged["rec_B"]}


def _keep(vis: Dict[str, List[torch.Tensor]], fakes, recs) -> None:
    (fake_A, fake_B), (rec_A, rec_B) = fakes, recs
    for name, v in (("fake_B", fake_B), ("fake_A", fake_A),
                    ("rec_A", rec_A), ("rec_B", rec_B)):
        vis[name].append(v.detach())


def make_stoch_accum_step(cfg: TrainConfig, ignore_noise: bool):
    """Accumulated variant of ``steps.make_stoch_train_step`` (same
    signature)."""
    k_micro = _check_cfg(cfg, "stoch accumulation step")
    d_names, g_names = ("netD_A", "netD_B"), ("netG_A_B", "netG_B_A")

    def step(state: TrainState, real_A, real_B, prior_z, lr: float,
             lr_d: float, plain_norm: bool = False, pool_draws=None):
        _check_batch(real_A.shape[0], k_micro)
        nets = state.nets
        kw = dict(plain_norm=plain_norm)
        for net in nets.values():
            net.train()
        if ignore_noise:
            prior_z = torch.ones_like(prior_z)
        rA, rB, pz = (_split_micro(x, k_micro)
                      for x in (real_A, real_B, prior_z))
        masks = _Masks(nets["netG_A_B"].dropout_generator)
        score_pair = make_score_pair(nets, True, plain_norm)

        def fakes(j):
            fake_B = nets["netG_A_B"](rA[j], pz[j], **kw)
            return nets["netG_B_A"](rB[j], **kw), fake_B

        # ----- phase 1: D gradients accumulated over microbatches ---------
        d_params = _params(nets, d_names)
        starts, d_grads, d_loss = [], None, None
        for j in range(k_micro):
            starts.append(masks.get())
            with torch.no_grad():
                fake = fakes(j)
            loss_D, logged = d_losses(cfg, nets, score_pair, fake,
                                      (rA[j], rB[j]), plain_norm=plain_norm)
            d_grads = _add(d_grads, _grads(loss_D, d_params))
            d_loss = _add(d_loss, logged)
        gnorms = {}
        _apply(state, _mean(d_grads, k_micro), lr_d, cfg, gnorms)

        # ----- phase 2: G gradients vs the UPDATED discriminators ---------
        g_params = _params(nets, g_names)
        cursor, g_grads, g_loss = masks.get(), None, None
        vis = {"fake_B": [], "fake_A": [], "rec_A": [], "rec_B": []}
        for j in range(k_micro):
            masks.set(starts[j])
            fake = fakes(j)
            masks.set(cursor)
            loss_G, logged, recs = g_losses(cfg, nets, fake, (rA[j], rB[j]),
                                            pz[j], plain_norm=plain_norm)
            cursor = masks.get()
            g_grads = _add(g_grads, _grads(loss_G, g_params))
            g_loss = _add(g_loss, logged)
            _keep(vis, fake, recs)
        _apply(state, _mean(g_grads, k_micro), lr, cfg, gnorms)
        state.step += 1
        ema_update(state.ema, nets, cfg.ema)

        losses = dict(_mean(d_loss, k_micro), **_mean(g_loss, k_micro))
        return losses, _merged_visuals(real_A, real_B, vis), gnorms

    return step


def make_aug_accum_step(cfg: TrainConfig):
    """Accumulated variant of ``steps.make_aug_train_step`` (same
    signature)."""
    k_micro = _check_cfg(cfg, "aug accumulation step")

    def step(state: TrainState, real_A, real_B, prior_z, eps_post,
             lr: float, lr_d: float, plain_norm: bool = False,
             pool_draws=None):
        _check_batch(real_A.shape[0], k_micro)
        nets = state.nets
        kw = dict(plain_norm=plain_norm)
        for net in nets.values():
            net.train()
        rA, rB, pz, eps = (_split_micro(x, k_micro)
                           for x in (real_A, real_B, prior_z, eps_post))
        masks = _Masks(nets["netG_A_B"].dropout_generator)
        score_pair = make_score_pair(nets, True, plain_norm)

        def phase0(j):
            fake_B = nets["netG_A_B"](rA[j], pz[j], **kw)
            fake_A = nets["netG_B_A"](rB[j], **kw)
            post = encode(cfg, nets, fake_A, rB[j], eps[j], plain_norm)
            return (fake_A, fake_B), post

        # ----- phase 1: D gradients accumulated over microbatches ---------
        d_params = _params(nets, D_NAMES)
        starts, d_grads, d_loss = [], None, None
        mus, logvars = [], []
        for j in range(k_micro):
            starts.append(masks.get())
            # the encoder's update of its running statistics is discarded
            with torch.no_grad(), running_stats_held(nets["netE_B"]):
                fake, (post_z, mu, logvar_eff) = phase0(j)
            mus.append(mu)
            logvars.append(logvar_eff)
            loss_D, logged = d_losses(cfg, nets, score_pair, fake,
                                      (rA[j], rB[j]), latent=(post_z, pz[j]),
                                      plain_norm=plain_norm)
            d_grads = _add(d_grads, _grads(loss_D, d_params))
            d_loss = _add(d_loss, logged)
        gnorms = {}
        _apply(state, _mean(d_grads, k_micro), lr_d, cfg, gnorms)

        # ----- phase 2: G/E gradients vs the UPDATED discriminators -------
        g_params = _params(nets, G_NAMES)
        cursor, g_grads, g_loss = masks.get(), None, None
        vis = {"fake_B": [], "fake_A": [], "rec_A": [], "rec_B": []}
        for j in range(k_micro):
            masks.set(starts[j])
            fake, post = phase0(j)
            masks.set(cursor)
            loss_G, logged, recs = g_losses(cfg, nets, fake, (rA[j], rB[j]),
                                            pz[j], post=post,
                                            plain_norm=plain_norm)
            cursor = masks.get()
            g_grads = _add(g_grads, _grads(loss_G, g_params))
            g_loss = _add(g_loss, logged)
            _keep(vis, fake, recs)
        _apply(state, _mean(g_grads, k_micro), lr, cfg, gnorms)
        state.step += 1
        ema_update(state.ema, nets, cfg.ema)

        with torch.no_grad():
            mu_all, lv_all = torch.stack(mus), torch.stack(logvars)
            gnorms.update({"mu_min": mu_all.min(), "mu_max": mu_all.max(),
                           "logvar_min": lv_all.min(),
                           "logvar_max": lv_all.max()})
        losses = dict(_mean(d_loss, k_micro), **_mean(g_loss, k_micro))
        return losses, _merged_visuals(real_A, real_B, vis), gnorms

    return step
