"""Data parallelism over ranks: the port of the JAX package's
``parallel/mesh.py::DataParallel``.

The JAX class shards every batch on axis 0 over a 1-D device mesh and lets
XLA turn the loss means into collectives.  Here each rank is a process
(``parallel/multihost.py``) that holds the whole model, replicated, and
:class:`DataParallel` wraps it so that one step over ranks IS the
single-process step on the full batch:

- each rank computes on its contiguous slice of axis 0 of the batch (the
  JAX sharding);
- every random draw of a step (``prior_z``, ``eps_post``, the pools' coin
  and slot, the dropout masks) is made for the FULL batch from the model's
  noise generator, seeded alike on every rank, and sliced, so the ranks
  stay in step and draw what one process draws;
- inside the step (``multihost.sharded``): gradients are averaged over
  ranks, one flat all-reduce per network and phase, before the per-network
  clip (``models/steps.py::_apply``), so the pre-clip norm is the global
  one; batch norm normalizes with global statistics and advances its
  running averages from them (``nn/norms.py``); the pools answer the
  all-gathered fakes with the full batch's draws, and each rank takes its
  slice of the answer, so the pools stay identical on every rank;
- the returned losses are global means (the posterior's range a global
  min / max); the visuals are this rank's slice (:meth:`gather` collects
  them);
- ``predict_A`` / ``predict_B`` / ``generate_multi`` shard a batch that
  divides over the ranks and gather the answer, and compute it whole on
  every rank otherwise (``_maybe_shard``'s rule);
- every other attribute is the wrapped model's (``__getattr__`` /
  ``__setattr__`` delegate, as the JAX class does), so ``save``, ``load``,
  ``epoch`` and the generation helpers act on it.

``eval/metrics.py`` shards its batches through :meth:`local_rows` /
:meth:`mean_over_ranks` when handed the wrapper.  The batch size must
divide over the ranks (the training CLI computes the full batch on every
rank, unsharded, where it does not).
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from . import multihost

# gnorm-dict entries that are extrema over the batch, not means
_MINS = ("mu_min", "logvar_min")
_MAXS = ("mu_max", "logvar_max")


class DataParallel:
    """Wraps a model of ``models.api`` for training over the ranks of the
    process group (one model per rank, all replicas equal)."""

    _own_attrs = frozenset({"model", "rank", "world"})

    def __init__(self, model):
        self.model = model
        self.rank = multihost.process_index()
        self.world = multihost.process_count()

    @property
    def n_devices(self) -> int:
        return self.world

    # -- slices --------------------------------------------------------------
    def divides(self, n: int) -> bool:
        return n % self.world == 0

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        return multihost.local_rows(x, self.rank, self.world)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's slice, concatenated in rank order."""
        return multihost.all_gather_cat(x)

    def gather_visuals(self, visuals):
        return OrderedDict((k, self.gather(v)) for k, v in visuals.items())

    def mean_over_ranks(self, values):
        """The mean over ranks of a dict of 0-d tensors, in one all-reduce
        (``gnorm_*`` entries are global already and pass through)."""
        keys = [k for k in values if not k.startswith("gnorm")]
        out = OrderedDict(values)
        if keys:
            stacked = torch.stack([values[k].float().reshape(())
                                   for k in keys])
            multihost.all_reduce_(stacked).div_(self.world)
            out.update(zip(keys, stacked.unbind()))
        return out

    def sharded(self):
        return multihost.sharded()

    # -- training ------------------------------------------------------------
    def _draws(self, batch: int, prior_z_B, eps_post, pool_draws):
        """The step's draws for the full batch, in the single-process order
        (prior, posterior noise, pools); a draw passed in is taken as it
        is."""
        m = self.model
        prior = m._prep_prior(batch, prior_z_B)
        eps = m._prep_prior(batch, eps_post) if "netE_B" in m.nets else None
        return prior, eps, m._pool_draws(batch, pool_draws)

    def _extrema(self, gnorms):
        names = [k for k in _MINS + _MAXS if k in gnorms]
        if not names:
            return gnorms
        # one MIN all-reduce: the maxima negated
        signed = torch.stack([gnorms[k] if k in _MINS else -gnorms[k]
                              for k in names])
        multihost.all_reduce_(signed, op=torch.distributed.ReduceOp.MIN)
        out = OrderedDict(gnorms)
        for k, v in zip(names, signed.unbind()):
            out[k] = v if k in _MINS else -v
        return out

    def _step(self, local_A, local_B, batch: int, prior_z_B, eps_post,
              plain_norm: bool, pool_draws):
        m = self.model
        prior, eps, pool_draws = self._draws(batch, prior_z_B, eps_post,
                                             pool_draws)
        kw = dict(plain_norm=plain_norm, pool_draws=pool_draws)
        if eps is not None:
            kw["eps_post"] = self.local_rows(eps)
        with multihost.sharded():
            out = m.train_instance(local_A, local_B, self.local_rows(prior),
                                   **kw)
        losses, visuals = self.mean_over_ranks(out[0]), out[1]
        if len(out) == 3:
            return losses, visuals, self._extrema(out[2])
        return losses, visuals

    def train_instance(self, real_A, real_B, prior_z_B=None, eps_post=None,
                       plain_norm: bool = False, pool_draws=None):
        """The wrapped model's step on this rank's slice; arguments and
        draws are the full batch's."""
        m = self.model
        real_A, real_B = m._tensor(real_A), m._tensor(real_B)
        return self._step(self.local_rows(real_A), self.local_rows(real_B),
                          real_A.shape[0], prior_z_B, eps_post, plain_norm,
                          pool_draws)

    def train_instance_indexed(self, data_A, data_B, idx_A, idx_B,
                               prior_z_B=None, **kw):
        """``train_instance`` on rows ``idx_A`` / ``idx_B`` of a train set
        on this rank's device: only this rank's rows are gathered."""
        m = self.model
        idx_A = torch.as_tensor(idx_A, dtype=torch.int64).to(m.device)
        idx_B = torch.as_tensor(idx_B, dtype=torch.int64).to(m.device)
        return self._step(data_A.index_select(0, self.local_rows(idx_A)),
                          data_B.index_select(0, self.local_rows(idx_B)),
                          idx_A.shape[0], prior_z_B, kw.get("eps_post"),
                          kw.get("plain_norm", False), kw.get("pool_draws"))

    def supervised_train_instance(self, real_A, real_B, prior_z_B=None,
                                  eps_post=None, plain_norm: bool = False):
        m = self.model
        real_A, real_B = m._tensor(real_A), m._tensor(real_B)
        batch = real_A.shape[0]
        if not self.divides(batch):  # a short supervised batch: whole
            return m.supervised_train_instance(real_A, real_B, prior_z_B,
                                               eps_post, plain_norm)
        prior = m._prep_prior(batch, prior_z_B)
        eps = m._prep_prior(batch, eps_post)
        with multihost.sharded():
            losses = m.supervised_train_instance(
                self.local_rows(real_A), self.local_rows(real_B),
                self.local_rows(prior), self.local_rows(eps), plain_norm)
        return self.mean_over_ranks(losses)

    # -- sharded inference ---------------------------------------------------
    def _sharded_call(self, fn, x, *rest, **kw):
        if not self.divides(x.shape[0]):
            return fn(x, *rest, **kw)
        with multihost.sharded():
            y = fn(self.local_rows(x),
                   *(self.local_rows(r) for r in rest), **kw)
            return self.gather(y)

    def predict_A(self, real_B, plain_norm: bool = False):
        return self._sharded_call(self.model.predict_A,
                                  self.model._tensor(real_B),
                                  plain_norm=plain_norm)

    def predict_B(self, real_A, z_B, plain_norm: bool = False):
        return self._sharded_call(self.model.predict_B,
                                  self.model._tensor(real_A),
                                  self.model._tensor(z_B),
                                  plain_norm=plain_norm)

    def generate_multi(self, real_A, multi_prior_z_B):
        real_A = self.model._tensor(real_A)
        z = self.model._prep_z(multi_prior_z_B)
        num = z.shape[0] // real_A.shape[0]
        return self.predict_B(real_A.repeat_interleave(num, dim=0), z)

    # -- everything else is the model's --------------------------------------
    def __getattr__(self, name):
        return getattr(self.model, name)

    def __setattr__(self, name, value):
        # the training loop's writes such as ``model.epoch = epoch`` land on
        # the model that save() serialises, not on the wrapper
        if name in DataParallel._own_attrs or name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            setattr(self.model, name, value)
