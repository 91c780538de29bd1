"""Ranks and their collectives: the port of the JAX package's
``parallel/multihost.py``.

The JAX package runs one SPMD program over a device mesh (every host's
devices, XLA collectives).  The port runs one rank per device, each a
process, joined by ``torch.distributed``:

- :func:`initialize` joins (or creates) the process group: ``coordinator``
  ("host:port"), ``num_processes`` and ``process_id`` all given, or
  ``coordinator="auto"`` under torchrun (``MASTER_ADDR`` / ``MASTER_PORT``
  / ``RANK`` / ``WORLD_SIZE``, the counterpart of a TPU pod's
  auto-detection).  A partial spec raises ``ValueError``, as in JAX;
- the backend is chosen from the layout before the group starts
  (:func:`choose_backend`): NCCL where every rank of a host has a card of
  its own, gloo on the CPU and where ranks share a card (NCCL refuses two
  ranks on one device).  Nothing retries with another backend, and nothing
  moves to the CPU;
- the collectives (:func:`all_reduce_`, :func:`all_gather_cat`,
  :func:`broadcast_`, the point-to-point :func:`exchange`) take device
  tensors and an :class:`Axis` (a line of ``parallel.mesh.Mesh``; default:
  every rank); under gloo a CUDA tensor goes through a host copy.  The
  differentiable ones: :func:`all_reduce_sum` (batch norm's statistics),
  :func:`gather_dim` (an all-gather along a dimension whose backward hands
  each rank its part's gradient) and :func:`copy_to` (the identity whose
  backward sums over an axis: a channel-sliced layer's input);
- :func:`sharded` marks the code that computes on this rank's part of a
  global batch (``parallel.mesh.DataParallel`` enters it with its mesh):
  there batch norm takes global statistics, dropout masks and pool draws
  are the rank's part of the full batch's, gradients are averaged over
  ranks (``models/steps.py``), and under a space axis the networks slice
  their images by rows (``parallel/hints.py``).  Outside it (one process,
  or a batch computed whole on every rank) nothing communicates, except a
  layer whose weight a model axis slices.

``process_count`` / ``is_primary`` / ``to_host`` / ``to_host_tree`` are the
JAX module's helpers: the primary rank owns the artifact directory,
``to_host`` all-gathers a sharded tensor to every rank as numpy.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "is_primary", "process_count", "process_index",
           "to_host", "to_host_tree", "choose_backend", "ranks_per_host",
           "local_rank", "check_spec", "free_port", "sharded", "shard_info",
           "scope", "all_reduce_", "all_reduce_sum", "all_gather_cat",
           "all_reduce_mean_list", "local_rows", "shutdown", "Axis",
           "world_axis", "all_gather_list", "broadcast_", "exchange",
           "gather_dim", "copy_to"]

_LOOPBACK = ("127.0.0.1", "localhost", "::1", "[::1]")
# seconds any collective may wait for the other ranks before it raises
TIMEOUT_S = 600


def choose_backend(device_type: str, ranks_per_host: int,
                   cards_per_host: int) -> str:
    """``nccl`` where every rank on a host has a CUDA card of its own,
    ``gloo`` on the CPU and where ranks would share a card."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if 1 <= ranks_per_host <= cards_per_host else "gloo"


def ranks_per_host(coordinator: str, num_processes: int) -> int:
    """How many ranks run on this host: torchrun's ``LOCAL_WORLD_SIZE``;
    else all of them when the coordinator is this host's loopback address,
    one otherwise (one process per host)."""
    if os.environ.get("LOCAL_WORLD_SIZE"):
        return int(os.environ["LOCAL_WORLD_SIZE"])
    host = coordinator.rsplit(":", 1)[0]
    return num_processes if host in _LOOPBACK else 1


def local_rank(process_id: int, cards: int) -> int:
    """This rank's card on its host: torchrun's ``LOCAL_RANK``, else
    ``process_id`` modulo the cards."""
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    return process_id % max(cards, 1)


def free_port() -> int:
    """A TCP port on this host's loopback address that was free a moment
    ago, for a coordinator that this host starts."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_spec(coordinator: str, num_processes: int, process_id: int) -> bool:
    """Whether the flags ask for several processes; a partial spec raises
    the JAX package's ``ValueError``."""
    if coordinator == "auto":
        return True
    if not coordinator and num_processes <= 1 and process_id < 0:
        return False
    # all three or none: a partial spec that ran single-process would leave
    # every host believing it is primary and writing the same directory
    if not coordinator or num_processes <= 1 or \
            not (0 <= process_id < num_processes):
        raise ValueError(
            "multi-host needs --coordinator host:port, --num_processes > 1 "
            "AND --process_id in [0, num_processes); got coordinator=%r "
            "num_processes=%r process_id=%r (or use --coordinator auto "
            "under torchrun)" % (coordinator, num_processes, process_id))
    return True


def initialize(coordinator: str = "", num_processes: int = 0,
               process_id: int = -1, backend: str = "gloo") -> bool:
    """Join the process group; False (and nothing done) for a
    single-process spec.  ``backend`` comes from :func:`choose_backend`."""
    if not check_spec(coordinator, num_processes, process_id):
        return False
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if coordinator == "auto":
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="tcp://" + coordinator,
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    return True


def shutdown() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_primary() -> bool:
    """True on the rank that owns the artifact directory."""
    return process_index() == 0


# ---------------------------------------------------------------------------
# where the code computes on this rank's slice of a global batch
# ---------------------------------------------------------------------------


class Axis(NamedTuple):
    """One line of the rank mesh through this rank: the global ranks along
    it in order, this rank's place among them, and its process group (None:
    the default group, which is the whole world)."""

    ranks: Tuple[int, ...]
    index: int
    pg: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    def peer(self, index: int) -> int:
        """The global rank at ``index`` along this line."""
        return self.ranks[index]


def world_axis() -> Axis:
    """Every rank, in rank order (the default group)."""
    return Axis(tuple(range(process_count())), process_index(), None)


class _Scope:
    """What the code deep inside the networks reads of the step it runs
    in: ``mesh`` (the layout, inside :func:`sharded`), ``engine`` (the
    pipeline of a train step, ``parallel/pipeline.py``) and ``rows`` (the
    space axis while the current network's activation is this rank's rows,
    ``parallel/spatial.py``).  Module state on purpose: the process group
    it qualifies is global to the process, and the batch norms, dropout
    masks, convolutions and trunks that read it sit where no argument
    reaches."""

    __slots__ = ("mesh", "engine", "rows")

    def __init__(self):
        self.mesh = self.engine = self.rows = None


_SCOPE = _Scope()


def scope() -> _Scope:
    return _SCOPE


@contextlib.contextmanager
def sharded(mesh=None, engine=None):
    """Inside: this rank computes its part of a global batch as ``mesh``
    (``parallel.mesh.Mesh``) lays it out: batch-coupled operations act on
    the global batch, images are sliced by rows over a space axis, and the
    generators' trunks run as a pipeline on ``engine`` (a train step's).
    A no-op with one rank or without a mesh."""
    prev = (_SCOPE.mesh, _SCOPE.engine, _SCOPE.rows)
    many = process_count() > 1
    _SCOPE.mesh = mesh if many else None
    _SCOPE.engine = engine if many else None
    _SCOPE.rows = None
    try:
        yield
    finally:
        _SCOPE.mesh, _SCOPE.engine, _SCOPE.rows = prev


def shard_info():
    """The layout inside :func:`sharded` with more than one rank (an object
    with ``batch``, ``space``, ``model``, ``pipe`` and ``replica`` axes),
    else None."""
    return _SCOPE.mesh


def local_rows(x: torch.Tensor, rank: int, world: int,
               dim: int = 0) -> torch.Tensor:
    """Part ``rank`` of ``world`` contiguous parts of ``x`` along ``dim``
    (axis 0: the JAX batch sharding); the length must divide by
    ``world``."""
    n = x.shape[dim] // world
    if n * world != x.shape[dim]:
        raise ValueError("a %s of %d does not divide over %d ranks"
                         % ("batch" if dim == 0 else "dimension %d" % dim,
                            x.shape[dim], world))
    return x.narrow(dim, rank * n, n)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

# wall seconds spent inside collectives while ``timing[0]`` is on (each
# call synchronizes the device before and after, so only for measuring)
timing = [False]
collective_seconds = [0.0]


@contextlib.contextmanager
def _timed(t: torch.Tensor):
    if not timing[0]:
        yield
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    start = time.perf_counter()
    try:
        yield
    finally:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        collective_seconds[0] += time.perf_counter() - start


def _axis(axis: Optional[Axis]) -> Axis:
    return world_axis() if axis is None else axis


def _staged(t: torch.Tensor, axis: Optional[Axis] = None) -> bool:
    """Whether ``t`` must go through the host (gloo with a CUDA tensor)."""
    pg = None if axis is None else axis.pg
    return t.is_cuda and dist.get_backend(pg) == "gloo"


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM,
                axis: Optional[Axis] = None) -> torch.Tensor:
    """In place over the ranks of ``axis`` (default: every rank); returns
    ``t``."""
    axis = _axis(axis)
    if axis.size == 1:
        return t
    with _timed(t):
        if _staged(t, axis):
            host = t.cpu()
            dist.all_reduce(host, op=op, group=axis.pg)
            t.copy_(host)
        else:
            dist.all_reduce(t, op=op, group=axis.pg)
    return t


def all_gather_list(x: torch.Tensor,
                    axis: Optional[Axis] = None) -> List[torch.Tensor]:
    """Every rank's ``x`` (equal shapes) along ``axis``, in its order."""
    axis = _axis(axis)
    x = x.contiguous()
    if axis.size == 1:
        return [x]
    with _timed(x):
        staged = _staged(x, axis)
        src = x.cpu() if staged else x
        parts = [torch.empty_like(src) for _ in range(axis.size)]
        dist.all_gather(parts, src, group=axis.pg)
        if staged:
            parts = [p.to(x.device) for p in parts]
        return parts


def all_gather_cat(x: torch.Tensor, axis: Optional[Axis] = None,
                   dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim``, in the
    order of ``axis`` (default: every rank), on every rank."""
    parts = all_gather_list(x, axis)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def broadcast_(t: torch.Tensor, src: int,
               axis: Optional[Axis] = None) -> torch.Tensor:
    """``t`` of the rank at place ``src`` of ``axis``, in place on every
    rank of it; returns ``t``."""
    axis = _axis(axis)
    if axis.size == 1:
        return t
    with _timed(t):
        if _staged(t, axis):
            host = t.cpu()
            dist.broadcast(host, src=axis.peer(src), group=axis.pg)
            t.copy_(host)
        else:
            dist.broadcast(t, src=axis.peer(src), group=axis.pg)
    return t


def exchange(sends, recvs, axis: Axis) -> None:
    """Point to point along ``axis``: ``sends`` maps a place on the axis to
    the tensor this rank sends it, ``recvs`` a place to the tensor this rank
    receives from it (filled in place).  Every send and receive is posted
    before any is waited on, so a ring of neighbours cannot deadlock; the
    two sides of a pair must name each other."""
    if not sends and not recvs:
        return
    any_t = next(iter(list(sends.values()) + list(recvs.values())))
    with _timed(any_t):
        staged = _staged(any_t, axis)
        out = {k: (v.new_empty(v.shape, device="cpu") if staged else v)
               for k, v in recvs.items()}
        src = {k: (v.detach().contiguous().cpu() if staged
                   else v.detach().contiguous()) for k, v in sends.items()}
        if not staged and dist.get_backend(axis.pg) == "nccl":
            ops = [dist.P2POp(dist.irecv, t, axis.peer(k), axis.pg)
                   for k, t in out.items()]
            ops += [dist.P2POp(dist.isend, t, axis.peer(k), axis.pg)
                    for k, t in src.items()]
            works = dist.batch_isend_irecv(ops)
        else:
            works = [dist.irecv(t, axis.peer(k), group=axis.pg)
                     for k, t in out.items()]
            works += [dist.isend(t, axis.peer(k), group=axis.pg)
                      for k, t in src.items()]
        for w in works:
            w.wait()
        if staged:
            for k, t in recvs.items():
                t.copy_(out[k])


def all_reduce_mean_list(tensors: Sequence[torch.Tensor],
                         axis: Optional[Axis] = None) -> List[torch.Tensor]:
    """The mean over the ranks of ``axis`` (default: every rank) of each
    tensor, in ONE flat all-reduce."""
    tensors = list(tensors)
    axis = _axis(axis)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, axis=axis)
    flat.div_(axis.size)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks whose backward sums the incoming gradients over ranks
    (each rank differentiates its own loss; their gradients meet here)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_(x.clone(), axis=axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), axis=ctx.axis), None


def all_reduce_sum(x: torch.Tensor,
                   axis: Optional[Axis] = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (default: every rank),
    differentiable."""
    return _AllReduceSum.apply(x, axis)


class _GatherDim(torch.autograd.Function):
    """All-gather along ``dim``; the backward hands each rank the gradient
    of its own part: summed over the ranks first where each rank's
    gradient is a share of the whole (``summed``), taken as it is where
    every rank holds the whole gradient already."""

    @staticmethod
    def forward(ctx, x, axis, dim, summed):
        ctx.axis, ctx.dim, ctx.summed = axis, dim, summed
        ctx.n = x.shape[dim]
        return all_gather_cat(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.summed:
            g = all_reduce_(g.clone(), axis=ctx.axis)
        return (g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n),
                None, None, None)


def gather_dim(x: torch.Tensor, axis: Axis, dim: int,
               summed: bool = True) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` concatenated along ``dim``,
    differentiable (:class:`_GatherDim`)."""
    if axis.size == 1:
        return x
    return _GatherDim.apply(x, axis, dim, summed)


class _CopyTo(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the ranks of
    ``axis``: the input of a layer whose ranks each compute a part of its
    output from all of it."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), axis=ctx.axis), None


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    if axis.size == 1:
        return x
    return _CopyTo.apply(x, axis)


def to_host(x) -> np.ndarray:
    """A tensor computed on this rank's slice, gathered from every rank, as
    numpy on every rank; a numpy array or a replicated tensor outside
    :func:`sharded` comes back as it is."""
    if isinstance(x, torch.Tensor):
        mesh = shard_info()
        if mesh is not None:
            x = all_gather_cat(x, mesh.batch)
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_host_tree(tree):
    """:func:`to_host` over nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: to_host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host_tree(v) for v in tree)
    return to_host(tree)
