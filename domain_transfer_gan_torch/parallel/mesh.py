"""The rank mesh and training over it: the port of the JAX package's
``parallel/mesh.py`` (``make_mesh_axes``, ``param_shardings``, the batch
and space shardings, ``DataParallel``).

The JAX package runs one SPMD program over a device mesh with up to four
axes and lets XLA place the communication.  Here each device is a rank (a
process, ``parallel/multihost.py``) and the communication is written out.
:class:`Mesh` lays the ``world`` ranks out row-major over the axes
``data x space x model x pipe`` (the order ``DataParallel`` appends them in
JAX); a rank's coordinates come from its index, and every line of the mesh
through a rank is a ``torch.distributed`` group (every rank creates every
group, in one order).  :class:`DataParallel` wraps a model so that one step
over the mesh IS the single-process step on the full batch:

- **data** (and **pipe**): each rank computes on its contiguous slice of
  axis 0 of the batch, sliced over ``data`` or, with a pipe axis, over
  ``(data, pipe)`` jointly (the JAX ``self.axis``);
- **space** (``--spatial S``): images are also sliced by rows (NHWC axis 1,
  the JAX ``batch_sharding(space_axis=)``); convolutions exchange halo
  rows with their neighbours (``parallel/spatial.py``), instance norms
  combine per-row statistics over the space group (the split forms of K1
  and K2, ``ops/kernels/instance_norm.py``), and the heads that collapse
  the image gather all of H first (``parallel/hints.py``);
- **model** (``--tensor T``): every parameter leaf the JAX rule
  (:func:`param_shardings`) shards is held as this rank's slice of its
  output channels, with its Adam moments and EMA shadow; a layer with such a
  weight computes its slice of channels and all-gathers them
  (``nn/layers.py``); the per-net clip sums the sharded leaves' squares over
  the model group;
- **pipe** (``--pipeline P``): the generators' residual trunks run as a
  GPipe schedule over the pipe group (``parallel/pipeline.py``); everything
  else is data-parallel over ``(data, pipe)``.

Every random draw of a step (``prior_z``, ``eps_post``, the pools' coin and
slot, the dropout masks) is made for the FULL batch from the model's noise
generator, seeded alike on every rank, and sliced (by rows too under a
space axis), so the ranks draw what one process draws.  Inside the step
(``multihost.sharded(mesh)``) each rank differentiates its own loss, whose
terms are means over its part; gradients are averaged per network over the
ranks that hold the same model slice (``data x space x pipe``) before the
per-network clip (``models/steps.py::_apply``), which makes them the
single process's: a term's share on a space rank is its mean over the
rank's rows, and every collective's backward sums what the ranks hand it.
The returned losses are global means; the visuals are this rank's part
(:meth:`gather_visuals` collects them).

``predict_A`` / ``predict_B`` / ``generate_multi`` and ``eval/metrics.py``
shard a batch that fits the mesh (its batch divides over the batch axes and,
under a space axis, its rows over the space ranks) and compute it whole on
every rank otherwise (``_maybe_shard``'s rule); they never run the
pipeline.  Every other attribute is the wrapped model's, as in JAX; under a
model axis ``save``, ``save_jax`` and ``load`` gather the shards into one
process's tensors and slice them again.
"""

from __future__ import annotations

import contextlib
import itertools
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from . import multihost
from .multihost import Axis

# gnorm-dict entries that are extrema over the batch, not means
_MINS = ("mu_min", "logvar_min")
_MAXS = ("mu_max", "logvar_max")

AXES = ("data", "space", "model", "pipe")
# the joint lines a step communicates over: the batch is sliced over
# (data, pipe); a gradient is averaged over the ranks holding the same
# model slice
JOINT = {"batch": ("data", "pipe"), "replica": ("data", "space", "pipe")}


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

def mesh_sizes(world: int, spatial: int = 0, tensor: int = 0,
               pipeline: int = 0) -> "OrderedDict[str, int]":
    """The axis sizes of a mesh of ``world`` ranks (an axis of size 0 or 1
    is off), in the JAX order; raises the JAX message where the world does
    not divide."""
    per = max(spatial, 1) * max(tensor, 1) * max(pipeline, 1)
    if world % per != 0:
        raise ValueError("devices (%d) not divisible by spatial*tensor*pipe "
                         "(%d)" % (world, per))
    return OrderedDict((("data", world // per), ("space", max(spatial, 1)),
                        ("model", max(tensor, 1)), ("pipe", max(pipeline, 1))))


def coords_of(rank: int, sizes) -> Dict[str, int]:
    """A rank's coordinate on each axis: the mesh is row-major in
    ``AXES`` order (``pipe`` fastest)."""
    out, rest = {}, rank
    for name in reversed(AXES):
        out[name] = rest % sizes[name]
        rest //= sizes[name]
    return {name: out[name] for name in AXES}


def rank_of(coords, sizes) -> int:
    r = 0
    for name in AXES:
        r = r * sizes[name] + coords[name]
    return r


def line(rank: int, sizes, axes) -> Tuple[Tuple[int, ...], int]:
    """The ranks of the line through ``rank`` along ``axes`` (the other
    coordinates fixed), in row-major order of ``axes``, and ``rank``'s place
    on it."""
    mine = coords_of(rank, sizes)
    ranks = []
    for values in itertools.product(*(range(sizes[a]) for a in axes)):
        c = dict(mine)
        c.update(zip(axes, values))
        ranks.append(rank_of(c, sizes))
    return tuple(ranks), ranks.index(rank)


def all_lines(sizes, axes) -> List[Tuple[int, ...]]:
    """Every line of the mesh along ``axes``, in one order for every
    rank."""
    world = 1
    for v in sizes.values():
        world *= v
    seen, out = set(), []
    for r in range(world):
        ranks, _ = line(r, sizes, axes)
        if ranks not in seen:
            seen.add(ranks)
            out.append(ranks)
    return out


class Mesh:
    """``world`` ranks as ``data x space x model x pipe``.  Attributes:
    ``sizes``, ``coords`` (this rank's), and one :class:`multihost.Axis` per
    line through this rank: ``data``, ``space``, ``model``, ``pipe``,
    ``batch`` (``data x pipe``, the batch's slices) and ``replica`` (``data
    x space x pipe``, the ranks that hold the same model slice).  With
    ``groups`` (and a process group up) every line's group is created, by
    every rank in the same order; without, the axes carry no group (layout
    only)."""

    def __init__(self, spatial: int = 0, tensor: int = 0, pipeline: int = 0,
                 world: Optional[int] = None, rank: Optional[int] = None,
                 groups: bool = True):
        self.world = multihost.process_count() if world is None else world
        self.rank = multihost.process_index() if rank is None else rank
        self.sizes = mesh_sizes(self.world, spatial, tensor, pipeline)
        self.coords = coords_of(self.rank, self.sizes)
        lines = dict({a: (a,) for a in AXES}, **JOINT)
        made = {}
        if groups and self.world > 1:
            import torch.distributed as dist

            for name, axes in lines.items():
                for ranks in all_lines(self.sizes, axes):
                    if 1 < len(ranks) < self.world and ranks not in made:
                        made[ranks] = dist.new_group(list(ranks))
        for name, axes in lines.items():
            ranks, index = line(self.rank, self.sizes, axes)
            setattr(self, name, Axis(ranks, index, made.get(ranks)))

    @property
    def batch_shards(self) -> int:
        return self.batch.size

    def describe(self) -> str:
        s = self.sizes
        if s["space"] * s["model"] * s["pipe"] == 1:
            return "data-parallel"
        return "data x space x model x pipe %dx%dx%dx%d" % tuple(
            s[a] for a in AXES)


def check_pipeline(cfg, pipeline: int, microbatches: int = 0,
                   spatial: int = 0, tensor: int = 0) -> None:
    """The JAX ``DataParallel``'s refusals, with its messages."""
    pipe = pipeline if pipeline and pipeline > 1 else 0
    if microbatches and microbatches > 1 and not pipe:
        raise ValueError("--microbatches only applies to pipeline "
                         "parallelism; set --pipeline >= 2")
    if not pipe:
        return
    if (spatial and spatial > 1) or (tensor and tensor > 1):
        raise ValueError("--pipeline is mutually exclusive with "
                         "--spatial/--tensor")
    if cfg is None:
        return
    if getattr(cfg, "remat", False):
        raise ValueError("--pipeline is incompatible with --remat (lifted "
                         "remat cannot take the trunk closure argument)")
    if getattr(cfg, "use_dropout", False):
        raise ValueError("--pipeline requires --use_dropout off (no rng "
                         "plumbing into the manual pipeline region)")
    if getattr(cfg, "norm", "instance") != "instance":
        raise ValueError("--pipeline requires per-sample (instance) "
                         "generator norms")
    if getattr(cfg, "n_blocks", 0) % pipe != 0:
        raise ValueError("--pipeline %d must divide n_blocks %d"
                         % (pipe, cfg.n_blocks))


def check_spatial(cfg, spatial: int) -> None:
    """Row slices the generators can keep end to end: every generator
    activation (the image, and the trunk at half its size) divides over the
    space ranks, and a rank holds at least the 4 rows the 7x7 stem's
    reflection needs.  (The JAX package lets GSPMD pad uneven shards; the
    port's halo exchange takes even slices.)"""
    if not spatial or spatial < 2 or cfg is None:
        return
    g = int(getattr(cfg, "grid_size", 64))
    if g % (2 * spatial) != 0 or g // spatial < 4:
        raise ValueError("--spatial %d needs grid_size %d to divide into %d "
                         "row slices of at least 4 rows, half of them too"
                         % (spatial, g, spatial))


# ---------------------------------------------------------------------------
# the tensor-parallel rule
# ---------------------------------------------------------------------------

def param_shardings(named_params, n: int, min_size: int = 1024):
    """The JAX ``param_shardings`` rule over a net's ``named_parameters``:
    per name the torch dimension this leaf is sliced on over a model axis of
    ``n`` ranks, or None (replicated).  A leaf is sliced when it has at
    least ``min_size`` elements and its last axis *in the JAX layout* (read
    through ``utils.convert``'s layout map: output channels of a conv, the
    features of a Dense) divides by ``n``."""
    from ..utils.convert import flax_last_axis_dim

    out = OrderedDict()
    for name, p in named_params:
        dim = flax_last_axis_dim(name, tuple(p.shape))
        out[name] = (dim if p.dim() >= 1 and p.numel() >= min_size
                     and p.shape[dim] % n == 0 else None)
    return out


def shard_slice(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """This rank's slice of ``t`` along ``dim``, as a tensor of its own."""
    return multihost.local_rows(t, axis.index, axis.size, dim).clone()


# every net over a model axis, and every layer holding a leaf it slices:
# (the model axis, {parameter name: sliced dimension or None}), names
# relative to the module; what the layers, the clip and the checks look up
_SLICES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def slices_of(module) -> Optional[Tuple[Axis, Dict[str, Optional[int]]]]:
    """(model axis, the sliced dimension of each of ``module``'s
    parameters by name) for a net over a model axis or a layer holding a
    slice, else None."""
    return _SLICES.get(module)


class TensorShards:
    """The parameter leaves a model axis slices, and the moves between one
    process's tensors and this rank's slices: :meth:`shard` (set-up: params,
    Adam moments and EMA shadows become slices; nothing whole is kept) and
    :meth:`whole` (a context in which they are whole again, gathered over
    the model group, and sliced anew after: a checkpoint's save or load)."""

    def __init__(self, state, axis: Axis):
        self.state, self.axis = state, axis
        self.dims = {name: param_shardings(net.named_parameters(),
                                           axis.size)
                     for name, net in state.nets.items()}

    def _leaves(self):
        """(net name, parameter index, dim, list holder, index in it) for
        every sliced leaf: the parameter, its Adam moments, its shadow."""
        for name in self.state.nets:
            dims = list(self.dims[name].values())
            for i, dim in enumerate(dims):
                if dim is None:
                    continue
                yield name, i, dim

    def _set(self, fn):
        st = self.state
        with torch.no_grad():
            for name, i, dim in self._leaves():
                p = list(st.nets[name].parameters())[i]
                p.data = fn(p.data, dim)
                opt = st.opt_state[name]
                opt.mu[i] = fn(opt.mu[i], dim)
                opt.nu[i] = fn(opt.nu[i], dim)
                if name in st.ema:
                    st.ema[name][i] = fn(st.ema[name][i], dim)

    def shard(self):
        """Slice every sharded leaf, and enter the nets and the layers that
        hold one in the map :func:`slices_of` reads."""
        self._set(lambda t, dim: shard_slice(t, dim, self.axis))
        for name, net in self.state.nets.items():
            dims = self.dims[name]
            _SLICES[net] = (self.axis, dims)
            for mname, m in net.named_modules():
                if not mname:
                    continue
                own = {leaf: dims.get(mname + "." + leaf)
                       for leaf in ("weight", "bias")}
                if any(d is not None for d in own.values()):
                    _SLICES[m] = (self.axis, own)

    @contextlib.contextmanager
    def whole(self):
        self._set(lambda t, dim: multihost.all_gather_cat(
            t.contiguous(), self.axis, dim))
        try:
            yield
        finally:
            self._set(lambda t, dim: shard_slice(t, dim, self.axis))


def state_bytes(state) -> int:
    """Bytes of parameters, Adam moments and EMA shadows of a
    ``TrainState`` (on this rank: its slices under a model axis)."""
    n = 0
    for name, net in state.nets.items():
        opt = state.opt_state[name]
        tensors = list(net.parameters()) + opt.mu + opt.nu + \
            list(state.ema.get(name, ()))
        n += sum(t.numel() * t.element_size() for t in tensors)
    return n


# ---------------------------------------------------------------------------
# the model over the mesh
# ---------------------------------------------------------------------------

class DataParallel:
    """Wraps a model of ``models.api`` for training over the ranks of the
    process group as a ``data x space x model x pipe`` mesh.  ``spatial``,
    ``tensor`` and ``pipeline`` (0 or 1: off) and ``microbatches`` (0: the
    stage count) as in the JAX class; ``num_devices`` (default: every
    rank) must equal the world."""

    _own_attrs = frozenset({"model", "mesh", "rank", "world", "engine",
                            "shards"})

    def __init__(self, model, num_devices: int = 0, spatial: int = 0,
                 tensor: int = 0, pipeline: int = 0, microbatches: int = 0):
        from .pipeline import PipelineEngine

        opt = getattr(model, "opt", None)
        check_pipeline(opt, pipeline, microbatches, spatial, tensor)
        check_spatial(opt, spatial)
        world = multihost.process_count()
        if num_devices and num_devices != world:
            raise ValueError("num_devices %d is not the %d ranks of the "
                             "process group" % (num_devices, world))
        self.model = model
        self.mesh = Mesh(spatial, tensor, pipeline)
        self.rank, self.world = self.mesh.rank, self.mesh.world
        self.engine = None
        if self.mesh.sizes["pipe"] > 1:
            self.engine = PipelineEngine(
                self.mesh.pipe, int(microbatches) if microbatches and
                microbatches > 1 else self.mesh.sizes["pipe"])
        self.shards = None
        if self.mesh.sizes["model"] > 1:
            self.shards = TensorShards(model.state, self.mesh.model)
            self.shards.shard()

    @property
    def n_devices(self) -> int:
        return self.world

    # -- slices --------------------------------------------------------------
    def divides(self, n: int) -> bool:
        return n % self.mesh.batch_shards == 0

    def fits(self, x: torch.Tensor) -> bool:
        """Whether an NHWC batch divides over the batch axes and, under a
        space axis, its rows into the slices the generators keep."""
        if not self.divides(x.shape[0]):
            return False
        s = self.mesh.sizes["space"]
        return s == 1 or (x.dim() == 4 and x.shape[1] % (2 * s) == 0
                          and x.shape[1] // s >= 4)

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of axis 0 (the batch)."""
        b = self.mesh.batch
        return multihost.local_rows(x, b.index, b.size)

    def local_image(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of an NHWC batch: its batch slice and, under a
        space axis, its rows."""
        x = self.local_rows(x)
        s = self.mesh.space
        return x if s.size == 1 else multihost.local_rows(x, s.index,
                                                          s.size, 1)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every batch slice, concatenated in order."""
        return multihost.all_gather_cat(x, self.mesh.batch)

    def gather_image(self, x: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`local_image`."""
        s = self.mesh.space
        if s.size > 1:
            x = multihost.all_gather_cat(x, s, 1)
        return self.gather(x)

    def gather_visuals(self, visuals):
        return OrderedDict((k, self.gather_image(v))
                           for k, v in visuals.items())

    def mean_over_ranks(self, values):
        """The mean over ranks of a dict of 0-d tensors, in one all-reduce
        (``gnorm_*`` entries are global already and pass through).  A
        rank's value is its part's mean (a mean over its rows under a space
        axis, whose slices are equal) or the same on every rank of a line,
        so the mean over every rank is the global mean."""
        keys = [k for k in values if not k.startswith("gnorm")]
        out = OrderedDict(values)
        if keys:
            stacked = torch.stack([values[k].float().reshape(())
                                   for k in keys])
            multihost.all_reduce_(stacked).div_(self.world)
            out.update(zip(keys, stacked.unbind()))
        return out

    def sharded(self):
        return multihost.sharded(self.mesh)

    def step_scope(self):
        """A train step's context: the mesh's layout, and the pipeline
        (step-scoped, as the JAX contextvar)."""
        return multihost.sharded(self.mesh, self.engine)

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
        with self.step_scope():
            out = m.train_instance(local_A, local_B, self.local_rows(prior),
                                   **kw)
        losses, visuals = self.mean_over_ranks(out[0]), out[1]
        if len(out) == 3:
            return losses, visuals, self._extrema(out[2])
        return losses, visuals

    def _check_batch(self, x: torch.Tensor) -> None:
        if not self.fits(x):
            raise ValueError(
                "a batch of %r does not divide over the mesh %s"
                % (tuple(x.shape), dict(self.mesh.sizes)))

    def train_instance(self, real_A, real_B, prior_z_B=None, eps_post=None,
                       plain_norm: bool = False, pool_draws=None):
        """The wrapped model's step on this rank's part; arguments and
        draws are the full batch's."""
        m = self.model
        real_A, real_B = m._tensor(real_A), m._tensor(real_B)
        self._check_batch(real_A)
        return self._step(self.local_image(real_A), self.local_image(real_B),
                          real_A.shape[0], prior_z_B, eps_post, plain_norm,
                          pool_draws)

    def train_instance_indexed(self, data_A, data_B, idx_A, idx_B,
                               prior_z_B=None, **kw):
        """``train_instance`` on rows ``idx_A`` / ``idx_B`` of a train set
        on this rank's device: only this rank's part is gathered."""
        m = self.model
        idx_A = torch.as_tensor(idx_A, dtype=torch.int64).to(m.device)
        idx_B = torch.as_tensor(idx_B, dtype=torch.int64).to(m.device)
        if not self.divides(idx_A.shape[0]):
            raise ValueError("a batch of %d does not divide over %d batch "
                             "slices" % (idx_A.shape[0],
                                         self.mesh.batch_shards))
        s = self.mesh.space

        def part(data, idx):
            x = data.index_select(0, self.local_rows(idx))
            return x if s.size == 1 else multihost.local_rows(
                x, s.index, s.size, 1)

        return self._step(part(data_A, idx_A), part(data_B, idx_B),
                          idx_A.shape[0], prior_z_B, kw.get("eps_post"),
                          kw.get("plain_norm", False), kw.get("pool_draws"))

    def supervised_train_instance(self, real_A, real_B, prior_z_B=None,
                                  eps_post=None, plain_norm: bool = False):
        m = self.model
        real_A, real_B = m._tensor(real_A), m._tensor(real_B)
        batch = real_A.shape[0]
        if not self.fits(real_A):  # a short supervised batch: whole
            return m.supervised_train_instance(real_A, real_B, prior_z_B,
                                               eps_post, plain_norm)
        prior = m._prep_prior(batch, prior_z_B)
        eps = m._prep_prior(batch, eps_post)
        with self.step_scope():
            losses = m.supervised_train_instance(
                self.local_image(real_A), self.local_image(real_B),
                self.local_rows(prior), self.local_rows(eps), plain_norm)
        return self.mean_over_ranks(losses)

    # -- sharded inference ---------------------------------------------------
    def _sharded_call(self, fn, x, *rest, **kw):
        if not self.fits(x):
            return fn(x, *rest, **kw)
        with self.sharded():
            y = fn(self.local_image(x),
                   *(self.local_rows(r) for r in rest), **kw)
            return self.gather_image(y)

    def predict_A(self, real_B, plain_norm: bool = False):
        return self._sharded_call(self.model.predict_A,
                                  self.model._tensor(real_B),
                                  plain_norm=plain_norm)

    def predict_B(self, real_A, z_B, plain_norm: bool = False):
        return self._sharded_call(self.model.predict_B,
                                  self.model._tensor(real_A),
                                  self.model._prep_z(z_B),
                                  plain_norm=plain_norm)

    def generate_multi(self, real_A, multi_prior_z_B):
        real_A = self.model._tensor(real_A)
        z = self.model._prep_z(multi_prior_z_B)
        num = z.shape[0] // real_A.shape[0]
        return self.predict_B(real_A.repeat_interleave(num, dim=0), z)

    # -- checkpoints: one process's tensors ----------------------------------
    def _whole(self):
        if self.shards is None:
            return contextlib.nullcontext()
        return self.shards.whole()

    def save(self, chk_name: str, async_save: bool = False):
        with self._whole():
            # the payload is copied to the host before the shards return
            return self.model.save(chk_name, async_save=async_save)

    def save_jax(self, path: str):
        with self._whole():
            return self.model.save_jax(path)

    def load(self, chk_path: str):
        with self._whole():
            return self.model.load(chk_path)

    def bytes_held(self) -> int:
        """Bytes of parameters, Adam moments and EMA shadows on this
        rank."""
        return state_bytes(self.model.state)

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


__all__ = ["AXES", "DataParallel", "Mesh", "TensorShards", "check_pipeline",
           "check_spatial", "coords_of", "line", "mesh_sizes",
           "param_shardings", "slices_of", "state_bytes"]
