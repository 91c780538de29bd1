"""Pipeline parallelism (GPipe) for the generators' residual trunks: the
port of the JAX package's ``parallel/pipeline.py``.

The trunk is the ``n_blocks`` identical residual blocks at ``4*ngf``
channels and H/2; every block maps ``(B, 4*ngf, H/2, W/2)`` to the same
shape, so a pipe axis of S stages can split it evenly: stage ``s`` holds
blocks ``[s*bps, (s+1)*bps)`` (``bps = n_blocks / S``).  Everything else
(stems, tails, discriminators, encoder) stays data-parallel over
``(data, pipe)``: each rank computes its own slice of the batch.

:class:`_GPipe` runs a generator's trunk over the pipe group as one
autograd node, in the JAX engine's schedule:

- entry: the stem's output (this rank's slice) is all-gathered over the
  pipe group into the data group's batch B and cut into M microbatches (M
  defaults to the stage count, ``--microbatches`` raises it); the CIN code
  ``z`` is gathered and cut alongside;
- forward: T = M + S - 1 ticks; at tick t stage s runs its blocks on
  microbatch t - s (where that is one), receiving it from stage s - 1 and
  sending its result to stage s + 1; the last stage banks the results;
- exit: the last stage broadcasts the trunk's output over the pipe group and
  each rank keeps its slice for the tail;
- backward: the schedule mirrored.  The slices' gradients are gathered to
  the last stage; each stage takes the microbatches in reverse order,
  receives the gradient of its output from stage s + 1, differentiates its
  blocks' graph of that microbatch (kept from the forward) and sends the
  gradient of its input to stage s - 1; stage 0's input gradients are
  broadcast and each rank keeps its slice, the CIN code's are summed over
  the stages.  Every rank walks the microbatches in one order, so each
  receive meets its send.

A block's parameters get a gradient only on their stage, the sum over the
data group's slices; averaged over every rank of ``data x pipe`` with the
other parameters (``models/steps.py::_apply``) that is one process's
gradient, since each data group contributes it once.

Per-sample ops only (convs, instance norms), so microbatching is the full
batch's arithmetic up to the batch the convolutions see.  The pipeline is
refused with batch-norm or dropout trunks, ``--remat``, ``--spatial`` and
``--tensor`` (``parallel.mesh.check_pipeline``), and it is step-scoped: the
generation helpers and the evaluation run unpipelined.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from . import multihost
from .multihost import Axis

# trunks run as a pipeline in this process (read by the checks)
trunk_runs = [0]


class PipelineEngine:
    """The pipe axis and the microbatch count.  ``n_micro`` defaults to the
    stage count (the least that keeps every stage busy in steady state);
    more microbatches shrink the bubble (S-1)/(M+S-1)."""

    def __init__(self, axis: Axis, n_micro: int):
        self.axis = axis
        self.n_micro = int(n_micro)

    @property
    def n_stages(self) -> int:
        return self.axis.size

    @property
    def stage(self) -> int:
        return self.axis.index


def active_engine() -> Optional[PipelineEngine]:
    """The train step's engine (``multihost.sharded(mesh, engine)``), or
    None: the generators run their trunks as a loop."""
    return multihost.scope().engine


def stage_blocks(blocks: List[torch.nn.Module], n_stages: int,
                 stage: int) -> List[torch.nn.Module]:
    """Stage ``stage``'s blocks (``_stack_stages``' split, with its
    divisibility error)."""
    n = len(blocks)
    if n % n_stages != 0:
        raise ValueError("pipeline: n_blocks %d not divisible by pipe stages "
                         "%d" % (n, n_stages))
    bps = n // n_stages
    return blocks[stage * bps:(stage + 1) * bps]


def schedule(n_micro: int, n_stages: int, stage: int) -> List[int]:
    """The microbatch stage ``stage`` runs at each of the M + S - 1 ticks
    (-1: a bubble)."""
    out = []
    for t in range(n_micro + n_stages - 1):
        m = t - stage
        out.append(m if 0 <= m < n_micro else -1)
    return out


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """An NCHW activation as a contiguous NHWC tensor: what travels between
    ranks (one layout on every rank), and the networks' channels_last
    memory, so no copy there."""
    return x.permute(0, 2, 3, 1).contiguous()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _send(x: torch.Tensor, peer: int, axis: Axis) -> None:
    multihost.exchange({peer: _nhwc(x)}, {}, axis)


def _recv(like: torch.Tensor, peer: int, axis: Axis) -> torch.Tensor:
    """An NHWC tensor of ``like``'s shape from ``peer``."""
    buf = torch.empty(like.shape, dtype=like.dtype, device=like.device)
    multihost.exchange({}, {peer: buf}, axis)
    return buf


class _GPipe(torch.autograd.Function):
    """The trunk over the pipe group (see the module's docstring).  Inputs:
    this rank's slice ``h`` of the trunk input (NCHW), its slice ``z`` of
    the CIN code (or an empty tensor), the engine, the function of this
    stage's blocks, then this stage's parameters.  Between ranks every
    activation travels as NHWC."""

    @staticmethod
    def forward(ctx, h, z, engine, run_stage, *params):
        axis, S, s, M = engine.axis, engine.n_stages, engine.stage, \
            engine.n_micro
        b = h.shape[0]
        h_all = multihost.all_gather_cat(_nhwc(h), axis)
        use_z = z.numel() > 0
        z_all = multihost.all_gather_cat(z, axis) if use_z else None
        B = h_all.shape[0]
        if B % M != 0:
            raise ValueError(
                "pipeline: per-data-group batch %d not divisible by "
                "microbatches %d (batchSize / data-axis size must be a "
                "multiple of --microbatches)" % (B, M))
        mb = B // M
        ctx.saved = []
        out = []
        trunk_runs[0] += 1
        for m in schedule(M, S, s):
            if m < 0:  # a bubble tick: nothing to run on this stage
                continue
            rows = slice(m * mb, (m + 1) * mb)
            x = h_all[rows] if s == 0 else _recv(h_all[rows], s - 1, axis)
            x = _nchw(x).detach().requires_grad_(True)
            zm = None
            if use_z:
                zm = z_all[rows].detach().requires_grad_(z.requires_grad)
            with torch.enable_grad():
                y = run_stage(x, zm)
            ctx.saved.append((m, x, zm, y))
            if s < S - 1:
                _send(y.detach(), s + 1, axis)
            else:
                out.append(_nhwc(y.detach()))
        full = torch.cat(out) if s == S - 1 else torch.empty_like(h_all)
        multihost.broadcast_(full, S - 1, axis)
        ctx.engine, ctx.b, ctx.mb, ctx.use_z = engine, b, mb, use_z
        ctx.z_shape, ctx.params = tuple(z.shape), params
        mine = full[axis.index * b:(axis.index + 1) * b]
        return _nchw(mine).clone()

    @staticmethod
    def backward(ctx, g):
        engine = ctx.engine
        axis, S, s = engine.axis, engine.n_stages, engine.stage
        b, mb = ctx.b, ctx.mb
        g_all = multihost.all_gather_cat(_nhwc(g), axis)
        dh_all = torch.zeros_like(g_all)
        B = g_all.shape[0]
        dz_all = None
        params = list(ctx.params)
        dparams = [torch.zeros_like(p) for p in params]
        for m, x, zm, y in reversed(ctx.saved):
            rows = slice(m * mb, (m + 1) * mb)
            gy = g_all[rows] if s == S - 1 else _recv(g_all[rows], s + 1,
                                                      axis)
            with_z = zm is not None and zm.requires_grad
            inputs = [x] + ([zm] if with_z else []) + params
            got = torch.autograd.grad(y, inputs, _nchw(gy),
                                      allow_unused=True)
            k = 2 if with_z else 1
            if with_z and got[1] is not None:
                if dz_all is None:
                    dz_all = got[1].new_zeros((B,) + ctx.z_shape[1:])
                dz_all[rows] += got[1]
            for i, gp in enumerate(got[k:]):
                if gp is not None:
                    dparams[i] += gp
            if s > 0:
                _send(got[0], s - 1, axis)
            else:
                dh_all[rows] = _nhwc(got[0])
        ctx.saved = None
        multihost.broadcast_(dh_all, 0, axis)
        dh = _nchw(dh_all[axis.index * b:(axis.index + 1) * b])
        dz = None
        if ctx.use_z and ctx.needs_input_grad[1]:
            if dz_all is None:  # this stage's blocks took no code
                dz_all = g.new_zeros((B,) + ctx.z_shape[1:])
            multihost.all_reduce_(dz_all, axis=axis)
            dz = dz_all[axis.index * b:(axis.index + 1) * b]
        return (dh, dz, None, None) + tuple(dparams)


def gpipe_trunk(engine: PipelineEngine, blocks: List[torch.nn.Module],
                h: torch.Tensor, z: Optional[torch.Tensor],
                plain_norm: bool) -> torch.Tensor:
    """``blocks`` applied in turn to ``h`` (with the CIN code ``z`` where
    the blocks take one), as a GPipe schedule over the engine's pipe
    axis."""
    mine = stage_blocks(blocks, engine.n_stages, engine.stage)

    def run_stage(x, zm):
        for blk in mine:
            x = blk(x, zm, plain_norm) if z is not None else \
                blk(x, plain_norm)
        return x

    params = [p for blk in mine for p in blk.parameters()]
    zz = z if z is not None else h.new_zeros((0,))
    return _GPipe.apply(h, zz, engine, run_stage, *params)
