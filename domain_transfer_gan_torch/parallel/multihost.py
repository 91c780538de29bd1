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
  :func:`all_reduce_sum`, the differentiable one batch norm uses) take
  device tensors; under gloo a CUDA tensor goes through a host copy;
- :func:`sharded` marks the code that computes on this rank's slice of a
  global batch (``parallel.mesh.DataParallel`` enters it): there batch
  norm takes global statistics, dropout masks and pool draws are the
  rank's slice of the full batch's, gradients are averaged over ranks
  (``models/steps.py``).  Outside it (one process, or a batch computed
  whole on every rank) nothing communicates.

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
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "is_primary", "process_count", "process_index",
           "to_host", "to_host_tree", "choose_backend", "ranks_per_host",
           "local_rank", "check_spec", "free_port", "sharded", "shard_info",
           "all_reduce_", "all_reduce_sum", "all_gather_cat",
           "all_reduce_mean_list", "local_rows", "shutdown"]

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

# module state on purpose: the process group it qualifies is global to the
# process, and the batch norms and dropout masks that read it sit deep
# inside the networks, where no argument reaches
_SHARDED = [False]


@contextlib.contextmanager
def sharded():
    """Inside: batch-coupled operations act on the global batch."""
    prev = _SHARDED[0]
    _SHARDED[0] = process_count() > 1
    try:
        yield
    finally:
        _SHARDED[0] = prev


def shard_info() -> Optional[Tuple[int, int]]:
    """(rank, world) inside :func:`sharded` with more than one rank, else
    None."""
    if not _SHARDED[0]:
        return None
    return process_index(), process_count()


def local_rows(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous slice of axis 0 (the JAX sharding);
    the length must divide by ``world``."""
    n = x.shape[0] // world
    if n * world != x.shape[0]:
        raise ValueError("a batch of %d does not divide over %d ranks"
                         % (x.shape[0], world))
    return x[rank * n:(rank + 1) * n]


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


def _staged(t: torch.Tensor) -> bool:
    """Whether ``t`` must go through the host (gloo with a CUDA tensor)."""
    return t.is_cuda and dist.get_backend() == "gloo"


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over every rank; returns ``t``."""
    with _timed(t):
        if _staged(t):
            host = t.cpu()
            dist.all_reduce(host, op=op)
            t.copy_(host)
        else:
            dist.all_reduce(t, op=op)
    return t


def all_gather_cat(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along axis 0, in rank
    order, on every rank."""
    x = x.contiguous()
    world = process_count()
    with _timed(x):
        if _staged(x):
            parts = [torch.empty_like(x, device="cpu") for _ in range(world)]
            dist.all_gather(parts, x.cpu())
            return torch.cat(parts).to(x.device)
        out = torch.empty((world * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x)
        return out


def all_reduce_mean_list(tensors: Sequence[torch.Tensor]
                         ) -> List[torch.Tensor]:
    """The mean over ranks of each tensor, in ONE flat all-reduce."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat)
    flat.div_(process_count())
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks whose backward sums the incoming gradients over ranks
    (each rank differentiates its own loss; their gradients meet here)."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ranks, differentiable."""
    return _AllReduceSum.apply(x)


def to_host(x) -> np.ndarray:
    """A tensor computed on this rank's slice, gathered from every rank, as
    numpy on every rank; a numpy array or a replicated tensor outside
    :func:`sharded` comes back as it is."""
    if isinstance(x, torch.Tensor):
        if shard_info() is not None:
            x = all_gather_cat(x)
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_host_tree(tree):
    """:func:`to_host` over nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: to_host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host_tree(v) for v in tree)
    return to_host(tree)
