"""Evaluation metrics, the port of the JAX package's ``eval/metrics.py``:
``eval_mse_A`` and the variational upper bound (UBO) on -log p(B | A) of
the training CLI (``variational_ubo``, ``eval_ubo_B``), and the evaluation
CLI's others: the decoder's pixelwise logvar fitted on train data
(``train_logvar``), the multivariate-Gaussian BPP baseline
(``train_mvgauss_B``, ``eval_bpp_mvgauss_B``, ``compute_bpp_mvgauss_B``),
the sensitivity of the B -> A -> B cycle to noise on A
(``sensitivity_to_edge_noise``) and ``compute_train_kld``.

The UBO is an RMSprop optimisation of per-sample (mu, logvar) *through* the
frozen ``netG_A_B``: each step is one generator forward and one backward
whose gradient flows only to z (through the conditional instance norms'
per-sample scale/shift), so on the card every step launches the forward
and the backward instance-norm kernel at each of the generator's norm
sites.  torch-RMSprop semantics exactly: alpha = 0.99, eps = 1e-8 outside
the square root, lr = 1e-2, ``sq = alpha sq + (1 - alpha) g^2`` then
``p -= lr g / (sqrt(sq) + eps)``.

What holds as in the JAX package:

- nets run in train mode when ``model.training`` is set (upstream never
  switched them to eval mode) and write no batch-norm running statistics;
  no parameter gradient is computed (``torch.autograd.grad`` w.r.t.
  ``(mu, logvar)`` only, the generator's parameters frozen meanwhile);
- ``npix`` comes from the image shape, or is upstream's 64 * 64 * 3 under
  ``legacy_eval_constants``;
- a short batch is padded with copies of its first sample to the dataset's
  batch size and those rows get zero weight, so the metrics equal an
  unpadded run's (the dequantisation noise is drawn at the padded shape);
- the metrics returned are those of the last iterate (the values before the
  final update);
- the host reads results once per chunk of 100 steps, never per step;
- over ranks (a ``parallel.DataParallel`` model) ``eval_mse_A`` and the UBO
  compute on each rank's part of a batch, as the JAX package's mesh does:
  the batch sliced over the batch axes (``data``, or ``data x pipe``), the
  rows too under a space axis, through the same sharded layers (halo
  convolutions, split norms, channel slices under a model axis); the UBO
  pads to a multiple of the batch slices, draws its noise for the whole
  batch and slices it, sums each (mu, logvar) gradient's row shares over
  the space ranks, and sums its masked means over the ranks that hold
  parts of the batch; the visuals are decoded from the gathered
  (mu, logvar).  A batch that does not fit the mesh is computed whole on
  every rank.  The pipeline is step-scoped: evaluation never runs it.

The random draws (dequantisation noise, the reparametrisation's eps, the
noise of a noisy cycle) come from the model's ``torch.Generator`` (the
baseline's from a ``np.random.RandomState(0)``, as the JAX package's); each
may be passed instead, so a test can feed the JAX package's draws.  ``plain_norm=True``
runs every norm through its plain version (a check's twin; the CLI never
asks for it).
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Optional

import numpy as np
import torch

from ..nn.networks import frozen
from ..parallel import multihost
from ..parallel.multihost import all_reduce_, local_rows
from ..ops.numerics import (
    gauss_reparametrize_eps,
    kld_std_gauss,
    log_prob_gaussian,
    log_prob_laplace,
)
from .visualize import visualize_data

RMS_ALPHA = 0.99
RMS_EPS = 1e-8
RMS_LR = 1e-2
CHUNK = 100  # the host reads the metrics (and dumps visuals) this often


def _npix(model, real_B) -> float:
    if getattr(model.opt, "legacy_eval_constants", False):
        return 64 * 64 * 3
    return float(np.prod(real_B.shape[1:]))


# ---------------------------------------------------------------------------
# MSE_A
# ---------------------------------------------------------------------------

def _ranks(model):
    """The ``parallel.DataParallel`` wrapper when the model is one over
    several ranks, else None."""
    return model if getattr(model, "world", 1) > 1 else None


def eval_mse_A(dataset, model) -> float:
    """Mean over batches of mean((netG_B_A(B) - A)^2).  Over ranks
    (``parallel.DataParallel``) a batch that divides is computed as slices
    and its mean taken over the ranks."""
    dp = _ranks(model)
    vals = []
    with frozen(model.nets["netG_B_A"], bool(model.training)) as net, \
            torch.no_grad():
        for batch in dataset:
            B, A = model._tensor(batch["B"]), model._tensor(batch["A"])
            if dp is not None and dp.fits(B):
                with dp.sharded():
                    pred_A = net(dp.local_image(B)).float()
                    v = torch.mean((pred_A - dp.local_image(A)) ** 2)
                vals.append(dp.mean_over_ranks({"v": v})["v"])
                continue
            pred_A = net(B).float()
            vals.append(torch.mean((pred_A - A) ** 2))
    # one read for the whole dataset; averaged in float64 like np.mean
    return float(np.mean(torch.stack(vals).cpu().numpy().astype(np.float64)))


# ---------------------------------------------------------------------------
# variational UBO / BPP
# ---------------------------------------------------------------------------

def ubo_chunk(model, real_A, real_B_deq, mu, logvar, sq_mu, sq_lv,
              logvar_B, mask, npix: float, steps: int, eps=None,
              plain_norm: bool = False, denom=None, mesh=None):
    """``steps`` RMSprop steps on (mu, logvar) from the given state.

    ``eps``: None (drawn per step from the model's generator) or a
    (steps, n, nlatent) tensor of these rows.  Returns the new (mu, logvar,
    sq_mu, sq_lv) and the masked-mean UBO and KLD of the last step's
    iterate, all device tensors.  ``mesh`` (``parallel.mesh.Mesh``): the
    rows are this rank's part of a global batch whose mask sums to
    ``denom`` (its batch slice; under a space axis its image rows, the
    (mu, logvar) rows whole on every space rank); each step's noise is
    drawn for the global batch and sliced, each gradient of (mu, logvar)
    is the sum of the space ranks' shares (a sample's other gradients are
    its own), and the returned means are summed over the ranks holding
    parts."""
    net = model.nets["netG_A_B"]
    ignore_noise = getattr(model, "ignore_noise", False)
    denom = mask.sum() if denom is None else denom
    shards = mesh.batch.size if mesh is not None else 1
    space = mesh.space if mesh is not None else None
    share = 1.0 / space.size if space is not None else 1.0
    ubo_m = kld_m = None
    scope = (multihost.sharded(mesh) if mesh is not None
             else contextlib.nullcontext())
    with frozen(net, bool(model.training)), torch.enable_grad(), scope:
        for s in range(steps):
            if eps is not None:
                e = eps[s]
            else:
                e = torch.randn((shards * mu.shape[0],) + tuple(mu.shape[1:]),
                                dtype=mu.dtype, device=mu.device,
                                generator=model._noise)
                if mesh is not None:
                    e = local_rows(e, mesh.batch.index, shards)
            mu_ = mu.detach().requires_grad_(True)
            lv_ = logvar.detach().requires_grad_(True)
            z = gauss_reparametrize_eps(mu_, lv_, e)
            if ignore_noise:
                z = torch.ones_like(z)
            fake_B = net(real_A, z, plain_norm=plain_norm).float()
            lp = log_prob_laplace(real_B_deq, fake_B, logvar_B)
            lp = lp.reshape(lp.shape[0], -1).sum(dim=1)
            kld = kld_std_gauss(mu_, lv_)
            # a space rank's share: its rows' log-density, and the terms
            # every space rank computes alike divided among them
            ubo = -lp + share * (kld + npix * math.log(127.5))
            ubo_m = (ubo * mask).sum() / denom
            kld_m = (share * kld * mask).sum() / denom
            g_mu, g_lv = torch.autograd.grad(ubo_m, (mu_, lv_))
            if space is not None and space.size > 1:
                g = all_reduce_(torch.stack([g_mu, g_lv]), axis=space)
                g_mu, g_lv = g[0], g[1]
            with torch.no_grad():
                sq_mu = RMS_ALPHA * sq_mu + (1 - RMS_ALPHA) * g_mu ** 2
                sq_lv = RMS_ALPHA * sq_lv + (1 - RMS_ALPHA) * g_lv ** 2
                mu = mu - RMS_LR * g_mu / (torch.sqrt(sq_mu) + RMS_EPS)
                logvar = logvar - RMS_LR * g_lv / (torch.sqrt(sq_lv)
                                                   + RMS_EPS)
    ubo_m, kld_m = ubo_m.detach(), kld_m.detach()
    if mesh is not None:
        ubo_m, kld_m = all_reduce_(torch.stack([ubo_m, kld_m]),
                                   axis=mesh.replica).unbind()
    return mu, logvar, sq_mu, sq_lv, ubo_m, kld_m


def variational_ubo(model, real_A, real_B, steps: int,
                    visualize: bool = False, vis_name=None, vis_path=None,
                    verbose: bool = False, logvar_B=None, vis_batch: int = 25,
                    compute_l1: bool = False, pad_to: Optional[int] = None,
                    dequant=None, eps=None, plain_norm: bool = False):
    """Iterative variational upper bound on -log p(B|A); returns (ubo, kld,
    bpp) of the final iterate.  A batch shorter than ``pad_to`` is padded
    with zero-weight rows.  ``dequant`` (the padded batch's shape) and
    ``eps`` ((steps, n, nlatent)) replace the model's draws."""
    if visualize and (vis_name is None or vis_path is None):
        raise ValueError("visualize needs vis_name and vis_path")
    real_A, real_B = model._tensor(real_A), model._tensor(real_B)
    n_real = real_A.shape[0]
    dp = _ranks(model)
    if dp is not None and not dp.fits(real_A[:1].expand(
            dp.mesh.batch_shards, *real_A.shape[1:])):
        dp = None  # rows that do not split: whole on every rank
    if dp is not None:
        # over ranks: the pad target rounded up to a multiple of the batch
        # slices, so that the zero-weight rows absorb the remainder
        k = dp.mesh.batch_shards
        pad_to = -(-max(pad_to or n_real, n_real) // k) * k
    if pad_to is not None and n_real < pad_to:
        pad = pad_to - n_real
        real_A = torch.cat([real_A, real_A[:1].expand(pad, *real_A.shape[1:])])
        real_B = torch.cat([real_B, real_B[:1].expand(pad, *real_B.shape[1:])])
    n = real_A.shape[0]
    dev = real_B.device
    mask = (torch.arange(n, device=dev) < n_real).to(real_B.dtype)
    vis_batch = min(vis_batch, n_real)
    nlat = model.opt.nlatent
    npix = _npix(model, real_B)

    if dequant is None:
        dequant = torch.rand(real_B.shape, dtype=real_B.dtype, device=dev,
                             generator=model._noise) * (1.0 / 127.5)
    real_B_deq = real_B + model._tensor(dequant)

    if logvar_B is None:
        logvar_B = torch.full((1,) + tuple(real_B.shape[1:]),
                              math.log(0.01), dtype=real_B.dtype, device=dev)
    else:
        logvar_B = model._tensor(logvar_B)
        if logvar_B.dim() == 4 and logvar_B.shape[-1] != real_B.shape[-1]:
            logvar_B = logvar_B.permute(0, 2, 3, 1)  # NCHW compat

    # q's parameters start at zeros / log(0.01), the encoder's if present
    mu = torch.zeros((n, nlat), dtype=real_B.dtype, device=dev)
    logvar = torch.full((n, nlat), math.log(0.01), dtype=real_B.dtype,
                        device=dev)
    if "netE_B" in model.nets:
        params = model.predict_enc_params(real_A, real_B, plain_norm)
        mu = params[0]
        if len(params) == 2:
            logvar = params[1]
    sq_mu = torch.zeros_like(mu)
    sq_lv = torch.zeros_like(logvar)
    if eps is not None:
        eps = model._tensor(eps)
    # over ranks every rank steps its part of the batch; the slices of
    # (mu, logvar) are gathered where the whole batch is read
    mesh, chunk_in, denom = None, (real_A, real_B_deq, mask), None
    if dp is not None:
        mesh, denom = dp.mesh, mask.sum()
        chunk_in = (dp.local_image(real_A), dp.local_image(real_B_deq),
                    dp.local_rows(mask))
        sp = mesh.space
        if sp.size > 1 and logvar_B.shape[1] > 1:
            logvar_B = local_rows(logvar_B, sp.index, sp.size, 1)
        mu, logvar = dp.local_rows(mu), dp.local_rows(logvar)
        sq_mu, sq_lv = dp.local_rows(sq_mu), dp.local_rows(sq_lv)
        if eps is not None:
            eps = torch.stack([dp.local_rows(e) for e in eps])

    def whole(t):
        return dp.gather(t) if dp is not None else t

    def posterior_sample():
        if not model.opt.stoch_enc:
            return whole(mu)
        mu_all, logvar_all = whole(mu), whole(logvar)
        e = torch.randn(mu_all.shape, dtype=mu_all.dtype, device=dev,
                        generator=model._noise)
        return gauss_reparametrize_eps(mu_all, logvar_all, e)

    def vis_dump(tag):
        z_vis = posterior_sample()[:vis_batch]
        vis_B = model.predict_B(real_A[:vis_batch], z_vis, plain_norm)
        save_path = os.path.join(vis_path, "%s_%s.png" % (vis_name, tag))
        visualize_data(model.opt, [real_A[:vis_batch], real_B[:vis_batch],
                                   vis_B], real_A[:vis_batch].shape,
                       save_path)

    if visualize:
        vis_dump("0")

    done = 0
    ubo_val = kld_val = float("nan")
    while done < steps:
        todo = min(CHUNK, steps - done)
        chunk_eps = None if eps is None else eps[done:done + todo]
        mu, logvar, sq_mu, sq_lv, ubo_dev, kld_dev = ubo_chunk(
            model, chunk_in[0], chunk_in[1], mu, logvar, sq_mu, sq_lv,
            logvar_B, chunk_in[2], npix, todo, chunk_eps, plain_norm,
            denom=denom, mesh=mesh)
        done += todo
        ubo_val, kld_val = torch.stack([ubo_dev, kld_dev]).tolist()
        bpp = ubo_val / (npix * math.log(2.0))
        if verbose:
            msg = "[%d] UBO: %.4f, KLD: %.4f, BPP: %.4f" % (done, ubo_val,
                                                            kld_val, bpp)
            if compute_l1:
                # a stochastic encoder scores a fresh posterior sample, a
                # deterministic one the posterior mean
                rec_B = model.predict_B(real_A, posterior_sample(),
                                        plain_norm)
                msg += ", L1: %.4f" % float(torch.mean(torch.abs(
                    real_B_deq[:n_real] - rec_B[:n_real])))
            print(msg)
        if visualize and done % CHUNK == 0:
            vis_dump(str(done))

    bpp = ubo_val / (npix * math.log(2.0))
    return ubo_val, kld_val, bpp


def eval_ubo_B(dataset, model, steps: int = 500, visualize: bool = False,
               vis_name=None, vis_path=None, verbose: bool = False,
               logvar_B=None, vis_batch: int = 25, compute_l1: bool = False):
    """Mean UBO / BPP / KLD over the dataset.  With ``visualize`` every
    batch writes its grids under the same file names, so the files show the
    last batch, as upstream's do."""
    ubo_B, bpp_B, kld_B = [], [], []
    pad_to = getattr(dataset, "batch_size", None)
    for batch in dataset:
        ubo, kld, bpp = variational_ubo(
            model, batch["A"], batch["B"], steps, visualize, vis_name,
            vis_path, verbose, logvar_B, vis_batch, compute_l1,
            pad_to=pad_to)
        ubo_B.append(ubo)
        bpp_B.append(bpp)
        kld_B.append(kld)
    return float(np.mean(ubo_B)), float(np.mean(bpp_B)), float(np.mean(kld_B))


# ---------------------------------------------------------------------------
# decoder logvar fitted on train data
# ---------------------------------------------------------------------------

def train_logvar(dataset, model, epochs: int = 1, verbose: bool = True,
                 draws=None):
    """Fit the decoder's pixelwise logvar_B (1, H, W, C) on train data: one
    RMSprop step per batch on the batch's mean UBO, everything else frozen.

    Per batch: dequantise B, decode fake_A = G_B_A(B), take z from the
    encoder's posterior of (fake_A, B) (mu = 0 without an encoder, logvar =
    log 0.01 unless ``stoch_enc``), decode fake_B = G_A_B(fake_A, z).  The
    generators and the encoder run without a graph: only logvar_B gets a
    gradient.  Prints the per-batch ``UBO/KLD/BPP`` line unless
    ``verbose=False``.  ``draws`` (an iterable of (dequant, eps) per batch)
    replaces the model's draws."""
    draws = iter(draws) if draws is not None else None
    logvar_B = sq = None
    for _ in range(epochs):
        for batch in dataset:
            real_B = model._tensor(batch["B"])
            if logvar_B is None:
                logvar_B = torch.full((1,) + tuple(real_B.shape[1:]),
                                      math.log(0.01), dtype=real_B.dtype,
                                      device=real_B.device)
                sq = torch.zeros_like(logvar_B)
            npix = _npix(model, real_B)
            dequant, eps = next(draws) if draws is not None else (None, None)
            if dequant is None:
                dequant = torch.rand(real_B.shape, device=real_B.device,
                                     generator=model._noise) / 127.5
            rb = real_B + model._tensor(dequant)
            fake_A = model.predict_A(rb)
            n = rb.shape[0]
            if "netE_B" in model.nets:
                mu, logvar = model._encode(fake_A, rb)
                if not model.opt.stoch_enc:
                    logvar = torch.full_like(logvar, math.log(0.01))
            else:
                mu = torch.zeros((n, model.opt.nlatent), device=rb.device)
                logvar = torch.full_like(mu, math.log(0.01))
            eps = model._randn(mu.shape) if eps is None else model._tensor(eps)
            fake_B = model.predict_B(
                fake_A, gauss_reparametrize_eps(mu, logvar, eps))
            kld = kld_std_gauss(mu, logvar)
            lv = logvar_B.detach().requires_grad_(True)
            with torch.enable_grad():
                lp = log_prob_laplace(rb, fake_B, lv)
                lp = lp.reshape(n, -1).sum(dim=1)
                ubo = torch.mean((-lp + kld) + npix * math.log(127.5))
                (g,) = torch.autograd.grad(ubo, (lv,))
            with torch.no_grad():
                sq = RMS_ALPHA * sq + (1 - RMS_ALPHA) * g ** 2
                logvar_B = logvar_B - RMS_LR * g / (torch.sqrt(sq) + RMS_EPS)
            if verbose:
                u, k = torch.stack([ubo.detach(), kld.mean()]).tolist()
                print("UBO: %.4f, KLD: %.4f, BPP: %.4f"
                      % (u, k, u / (npix * math.log(2.0))))
    return logvar_B


# ---------------------------------------------------------------------------
# the multivariate-Gaussian BPP baseline (host-side numpy)
# ---------------------------------------------------------------------------

def train_mvgauss_B(dataset):
    """Pixelwise mean and variance of B over the dataset (means of batch
    means, as upstream)."""
    b_mean, n = 0.0, 0
    for batch in dataset:
        b_mean = b_mean + np.mean(np.asarray(batch["B"]), axis=0,
                                  keepdims=True)
        n += 1
    b_mean = b_mean / n
    b_var = 0.0
    for batch in dataset:
        b_var = b_var + np.mean(
            (np.asarray(batch["B"]) - b_mean) ** 2, axis=0, keepdims=True)
    b_var = b_var / n
    return b_mean, b_var


def eval_bpp_mvgauss_B(dataset, mu, logvar, npix=None, rng=None):
    """Bits per pixel of dequantised B under N(mu, exp(logvar)), the mean
    over batches; the dequantisation noise comes from ``rng`` (default
    ``np.random.RandomState(0)``)."""
    rng = rng or np.random.RandomState(0)
    mu = torch.from_numpy(np.asarray(mu, np.float32))
    logvar = torch.from_numpy(np.asarray(logvar, np.float32))
    bpp = []
    for batch in dataset:
        real_B = np.asarray(batch["B"])
        np_here = npix or float(np.prod(real_B.shape[1:]))
        real_B = real_B + rng.uniform(0, 1.0 / 127.5,
                                      real_B.shape).astype(real_B.dtype)
        nll = -log_prob_gaussian(torch.from_numpy(real_B), mu,
                                 logvar).numpy()
        nll = nll.reshape(real_B.shape[0], -1).sum(1) \
            + np_here * math.log(127.5)
        bpp.append(nll.mean() / (np_here * math.log(2)))
    return float(np.mean(bpp))


def compute_bpp_mvgauss_B(dataset_train, dataset_test, npix=None):
    """The baseline fitted on ``dataset_train``, scored on
    ``dataset_test``."""
    mvg_mean, mvg_var = train_mvgauss_B(dataset_train)
    mvg_logvar = np.log(mvg_var + 1e-5)
    bpp = eval_bpp_mvgauss_B(dataset_test, mvg_mean, mvg_logvar, npix)
    print("MVGauss BPP: %.4f" % bpp)
    return bpp


# ---------------------------------------------------------------------------
# noise sensitivity, and the train KL
# ---------------------------------------------------------------------------

NOISE_STDS = (0, 0.1, 0.2, 0.5, 1, 2, 3, 5)  # grey levels of 255


def sensitivity_to_edge_noise(opt, model, data_B, save_path="noise_sens.npy",
                              draws=None):
    """Per-sample L1(real_B, rec_B) / npix of the B -> A -> B cycle with
    Gaussian noise of each of ``NOISE_STDS`` on the intermediate fake_A;
    the curve (one row per std) is saved to ``save_path`` and returned.
    ``draws`` (one dict of ``generate_noisy_cycle`` keyword arguments per
    std) replaces the model's draws."""
    real_B = model._tensor(data_B)
    npix = (64 * 64 * 3 if getattr(opt, "legacy_eval_constants", False)
            else float(np.prod(real_B.shape[1:])))
    sums = []
    for i, std in enumerate(NOISE_STDS):
        rec_B = model.generate_noisy_cycle(
            real_B, std, **(draws[i] if draws is not None else {}))
        sums.append(torch.sum(torch.abs(real_B - rec_B), dim=(1, 2, 3))
                    / npix)
    res = torch.stack(sums).cpu().numpy().tolist()  # one read
    np.save(save_path.replace(".npy", ""), res)
    return res


def compute_train_kld(train_dataset, model, max_batches: int = 100):
    """Mean over batches of the KL of the encoder's posterior mean of
    (G_B_A(B), B) with the variance of its deterministic case (logvar 0)
    from N(0, I), on up to ``max_batches`` + 1 batches."""
    train_kl = []
    for i, batch in enumerate(train_dataset):
        real_B = model._tensor(batch["B"])
        fake_A = model.predict_A(real_B)
        mu = model.predict_enc_params(fake_A, real_B)[0]
        train_kl.append(torch.mean(kld_std_gauss(mu, 0.0 * mu)))
        if i == max_batches:
            break
    # one read; averaged in float64 like np.mean of floats
    kl = float(np.mean(torch.stack(train_kl).cpu().numpy().astype(
        np.float64)))
    print("train KL:", kl)
    return kl
