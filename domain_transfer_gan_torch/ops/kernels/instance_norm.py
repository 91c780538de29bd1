"""Fused instance norm (+affine, +ReLU), forward and backward: the Hopper
kernels' wrappers, their plain PyTorch versions and the
``torch.autograd.Function`` that binds them.

``instance_norm_fused`` is the port's counterpart of
``domain_transfer_gan_tpu/ops/pallas/instance_norm.py::instance_norm_pallas``.
On a CUDA tensor its forward launches the hand-written kernel of
``csrc/instance_norm.cu`` and its backward the one of
``csrc/instance_norm_bwd.cu``, or they raise; on a CPU tensor they compute
the plain versions ``instance_norm_plain`` and ``instance_norm_bwd_plain``
(the hand-derived backward, not autograd of the forward).  There is no way
from a kernel to its plain version.

Each kernel has three variants, and :func:`cluster_plan` picks one per
shape: the on-chip one ("cluster") splits a sample's HW rows over a
thread-block cluster that holds the whole slab in shared memory, so x (and
dy) are read from device memory once; the ring route ("ring", two
launches) streams a sample's rows once through the ring of the split
reductions over a cluster (statistics, or the backward's two sums), then
applies them over a grid of row chunks, where no cluster holds the slab;
the streaming one (one block per sample and channel tile looping over HW,
geometry from :func:`launch_geometry`) takes every shape, and runs where
its rows are not a multiple of 16 bytes or the tensors are unaligned, and
at the mid-size shapes where the card measured it faster.  A refused launch
raises; nothing moves to another variant.

Each wrapper counts its calls (``instance_norm_fused.launches``,
``instance_norm_bwd_fused.launches``, the same per ``(N, HW, C)`` in
``launches_by_shape`` and per variant in ``launches_by_variant``): each is
one kernel launch, but for the ring route's, which is two (the ring, then
the apply / dx);
``instance_norm_bwd_fused.dy_copies`` counts the incoming gradients that had
to be copied into NHWC order first.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import build

KERNEL_NAME = "instance_norm"
BWD_KERNEL_NAME = "instance_norm_bwd"

_MIN_SEGMENT_BYTES = 32  # one memory sector: narrowest row segment of a tile
# threads of a streaming, apply or dx block (csrc/instance_norm_common.cuh::
# kThreads), and the most of a cluster CTA (instance_norm_cluster.cuh::
# kClusterThreadsMax)
_THREADS = 256

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()


def _check_affine(scale, shift, n: int, c: int, device) -> None:
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift must both be given or both be None")
    if scale is None:
        return
    for name, t in (("scale", scale), ("shift", shift)):
        if t.device != device:
            raise ValueError("%s is on %s, x on %s" % (name, t.device, device))
        if t.shape != (c,) and t.shape != (n, c):
            raise ValueError("%s must be None, (C,)=(%d,) or (N, C)=(%d, %d), "
                             "got %r" % (name, c, n, c, tuple(t.shape)))
    if scale.shape != shift.shape:
        raise ValueError("scale %r and shift %r must have one shape"
                         % (tuple(scale.shape), tuple(shift.shape)))


def _check_x(x: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError("x must be NHWC (N, H, W, C), got shape %r"
                         % (tuple(x.shape),))
    if x.dtype not in _DTYPE_CODE:
        raise TypeError("x must be float32 or bfloat16, got %s" % x.dtype)
    if x.numel() == 0:
        raise ValueError("x must not be empty, got shape %r"
                         % (tuple(x.shape),))


def instance_norm_plain(x: torch.Tensor, scale: Optional[torch.Tensor],
                        shift: Optional[torch.Tensor], *, eps: float = 1e-5,
                        unbiased: bool = False, relu: bool = False,
                        return_stats: bool = False):
    """Plain PyTorch version of the kernel, same arithmetic: fp32 statistics,
    variance as the mean of squared centered values (times HW/(HW-1) when
    ``unbiased``), affine, optional ReLU, output in x's dtype.

    x: NHWC.  scale/shift: None, (C,) or (N, C).  With ``return_stats`` also
    returns ``mean`` and ``rstd`` as (N, C) fp32.
    """
    _check_x(x)
    n, h, w, c = x.shape
    hw = h * w
    _check_affine(scale, shift, n, c, x.device)
    x32 = x.reshape(n, hw, c).to(torch.float32)
    mean = x32.mean(dim=1, keepdim=True)
    centered = x32 - mean
    var = (centered * centered).mean(dim=1, keepdim=True)
    if unbiased:
        var = var * (hw / max(hw - 1, 1))
    rstd = torch.rsqrt(var + eps)
    y = centered * rstd
    if scale is not None:
        # (C,) broadcasts over N and HW, (N, C) over HW
        y = (y * scale.to(torch.float32).reshape(-1, 1, c)
             + shift.to(torch.float32).reshape(-1, 1, c))
    if relu:
        y = torch.clamp_min(y, 0.0)
    y = y.to(x.dtype).reshape(n, h, w, c)
    if return_stats:
        return y, mean[:, 0, :], rstd[:, 0, :]
    return y


def launch_geometry(n: int, c: int, itemsize: int, aligned: bool,
                    sm_count: int) -> Tuple[int, int]:
    """``(vec, tx)`` for a launch: elements per thread along C and threads
    along C.  A block covers ``tx * vec`` channels of one sample.

    ``vec`` is the number of elements in 16 bytes when C is a multiple of it
    and the pointers are 16-byte aligned, else 1.  ``tx`` starts at the
    power of two that covers C (at most 32) and is halved while the grid has
    fewer than two blocks per SM, as long as a row segment of the tile stays
    at least one 32-byte sector wide.
    """
    wide = 16 // itemsize
    vec = wide if (aligned and c % wide == 0) else 1
    packs = -(-c // vec)
    tx = 1
    while tx < 32 and tx < packs:
        tx *= 2
    while (tx > 1 and n * -(-packs // tx) < 2 * sm_count
           and (tx // 2) * vec * itemsize >= _MIN_SEGMENT_BYTES):
        tx //= 2
    return vec, tx


class ClusterPlan(NamedTuple):
    """How a kernel runs one shape.  ``variant`` is ``"cluster"`` (the
    on-chip kernels: ``cluster`` CTAs per sample, each holding ``rows`` rows
    of x, and of dy for the backward, in ``smem_bytes`` of shared memory,
    copied in ``stages`` bulk copies, ``threads`` threads), ``"ring"`` (two
    launches: the split reductions' ring over whole samples, ``ring`` a
    :class:`SplitPlan`; then the apply / dx over a grid of (sample,
    ``chunk_rows`` rows, channel tile); the other fields are 0) or
    ``"streaming"`` (the kernels that loop over HW, geometry from
    :func:`launch_geometry`; the other fields are 0)."""

    variant: str
    cluster: int = 0
    rows: int = 0
    stages: int = 0
    threads: int = 0
    smem_bytes: int = 0
    ring: Optional["SplitPlan"] = None
    chunk_rows: int = 0

    def row_ranges(self, hw: int) -> List[Tuple[int, int]]:
        """``[first, last)`` rows of each CTA of a cluster, in rank order."""
        return [(min(k * self.rows, hw), min((k + 1) * self.rows, hw))
                for k in range(self.cluster)]

    def stage_ranges(self, first: int, last: int) -> List[Tuple[int, int]]:
        """``[r0, r1)`` rows of each bulk copy of the CTA owning
        ``[first, last)`` (the kernels skip empty ones)."""
        per = -(-(last - first) // self.stages)
        out = []
        for s in range(self.stages):
            r0 = min(first + s * per, last)
            out.append((r0, min(r0 + per, last)))
        return out

    def apply_ranges(self, hw: int) -> List[Tuple[int, int]]:
        """The ring route's apply / dx: ``[r0, r1)`` rows of each block's
        row chunk of a sample."""
        return [(r, min(r + self.chunk_rows, hw))
                for r in range(0, hw, self.chunk_rows)]


STREAMING = ClusterPlan("streaming")
VARIANTS = ("cluster", "ring", "streaming")

SMEM_PER_CTA_MAX = 232448  # 227 KB: what an H100 CTA may opt in to
CLUSTER_MAX = 16           # needs the non-portable cluster attribute above 8
_CLUSTER_PORTABLE = 8
_STAGE_BYTES = 16 << 10    # target size of one bulk copy
_MAX_STAGES = 4
# K grows from the smallest cluster that holds the slab only for large slabs
# (PERF.md has the sweep): from _FILL_SLAB_BYTES of x per sample, until the
# grid has a CTA for every SM; from _SPLIT_SLAB_BYTES of x (and dy), until a
# CTA holds _SPLIT_CTA_BYTES, so that two or more CTAs share an SM
_FILL_SLAB_BYTES = 256 << 10
_SPLIT_SLAB_BYTES = 512 << 10
_SPLIT_CTA_BYTES = 64 << 10
# samples of more than this and less than _FILL_SLAB_BYTES of x take the
# streaming variant in a batch of fewer samples than half the SMs, or where
# their slab needs a cluster of more than one CTA (PERF.md)
_MID_SLAB_BYTES = 32 << 10


def _cluster_smem_bytes(arrays: int, rows: int, c: int, itemsize: int,
                        threads: int, stages: int) -> int:
    """Dynamic shared memory of a cluster CTA, as
    ``csrc/instance_norm_cluster.cuh::cluster_layout`` lays it out: the slab,
    3 C partials, 2 C totals, the tree (one row of C * arrays floats per warp
    where C / vec divides 32, else per thread row), the barriers."""
    packs = c * itemsize // 16
    tree_rows = threads // 32 if 32 % packs == 0 and packs < 32 else \
        threads // packs
    return (arrays * rows * c * itemsize + 5 * c * 4
            + tree_rows * c * arrays * 4 + stages * 8)


@functools.lru_cache(maxsize=None)
def cluster_plan(n: int, hw: int, c: int, itemsize: int, arrays: int,
                 sm_count: int, aligned: bool = True,
                 cluster: Optional[int] = None,
                 on_chip: bool = False) -> ClusterPlan:
    """The plan of one launch: the on-chip variant where a sample's slab fits
    a cluster and the card measured it faster, the ring route where no
    cluster holds it, else the streaming one.
    ``arrays`` is 1 for the forward (x), 2 for the backward (x and dy).

    The on-chip and ring variants need rows of a multiple of 16 bytes (C *
    itemsize) and 16-byte aligned tensors, so that every row boundary is a
    legal bulk copy boundary.  Its cluster size K is the smallest power of
    two whose CTAs' slabs fit ``SMEM_PER_CTA_MAX``, doubled, up to the
    portable 8, while a sample's x of ``_FILL_SLAB_BYTES`` or more leaves
    the grid N * K with fewer CTAs than the card has SMs, and while a slab
    (x, and dy for the backward) of ``_SPLIT_SLAB_BYTES`` or more leaves a
    CTA more than ``_SPLIT_CTA_BYTES``.  Every CTA a cluster adds costs time
    (a cluster of one is an ordinary launch), so K stays as small as that
    allows.  No K up to 16 fits: the ring route (:func:`_ring_route`), which
    an H100 measured 1.1-13x faster than the streaming variant at every
    such shape ``chip_smoke.py`` times (the 256x256 generator sites, the
    discriminator sites of its 256x256 steps; ``ring_sweeps.py``, PERF.md),
    unless wide rows leave no ring that fits a CTA well, which take the
    streaming variant.

    Mid-size samples, of more than ``_MID_SLAB_BYTES`` and less than
    ``_FILL_SLAB_BYTES`` of x, take the streaming variant in two cases: in a
    batch of fewer samples than half the SMs (the float32 discriminator
    sites of a batch of 32), whose cluster grid has at most one CTA on at
    most half the SMs, each loading its whole slab before it writes while
    the streaming grid overlaps the loads and stores of a thousand blocks;
    and where the slab needs a cluster of more than one CTA, whose launch
    and exchange cost more there than the re-reads from L2 they save.  The
    card measured the streaming variant faster in both (PERF.md).

    ``on_chip`` forces the on-chip variant with the K above, ``cluster``
    forces K as well (checks and measurements of other plans); they raise
    if the variant cannot run so.
    """
    row_bytes = c * itemsize
    packs = row_bytes // 16
    forced = cluster is not None or on_chip
    if not aligned or row_bytes % 16 or packs > _THREADS:
        if forced:
            raise ValueError("the cluster variant does not take C=%d at %d "
                             "bytes (aligned=%s)" % (c, itemsize, aligned))
        return STREAMING
    threads = packs * (_THREADS // packs)

    def cta_bytes(k):
        return arrays * -(-hw // k) * row_bytes

    def plan(k):
        rows = -(-hw // k)
        stages = max(1, min(_MAX_STAGES, rows, -(-cta_bytes(k)
                                                 // _STAGE_BYTES)))
        smem = _cluster_smem_bytes(arrays, rows, c, itemsize, threads, stages)
        if smem > SMEM_PER_CTA_MAX:
            return None
        return ClusterPlan("cluster", k, rows, stages, threads, smem)

    if cluster is not None:
        got = plan(cluster) if cluster in (1, 2, 4, 8, 16) else None
        if got is None:
            raise ValueError("no cluster of %r CTAs holds a (%d, %d) slab of "
                             "%d arrays" % (cluster, hw, c, arrays))
        return got
    k = 1
    while k <= CLUSTER_MAX and plan(k) is None:
        k *= 2
    if k > CLUSTER_MAX:
        if forced:
            raise ValueError("no cluster holds a (%d, %d) slab of %d arrays"
                             % (hw, c, arrays))
        return _ring_route(n, hw, c, itemsize, arrays, sm_count) or STREAMING
    slab = cta_bytes(1)
    x_slab = slab // arrays
    if (not forced and _MID_SLAB_BYTES < x_slab < _FILL_SLAB_BYTES
            and (2 * n < sm_count or k > 1)):
        return STREAMING
    while (k < _CLUSTER_PORTABLE and x_slab >= _FILL_SLAB_BYTES
           and n * k < sm_count):
        k *= 2
    while (k < _CLUSTER_PORTABLE and slab >= _SPLIT_SLAB_BYTES
           and cta_bytes(k) > _SPLIT_CTA_BYTES):
        k *= 2
    return plan(k)


# the apply / dx grid (ring_sweeps.py's grids and ring sweeps,
# PERF.md): rows of every thread row a block owns, by itemsize and launch;
# halved while the grid has fewer blocks than the card has SMs
_APPLY_ROWS_PER_THREAD = {(4, False): 4, (4, True): 4, (2, False): 8,
                          (2, True): 32}


# the chunk halvings the ring route's ring may take to fit a CTA (wide rows)
_RING_ROUTE_CUTS = 1


def _ring_route(n: int, hw: int, c: int, itemsize: int, arrays: int,
                sm_count: int, cuts: Optional[int] = _RING_ROUTE_CUTS
                ) -> Optional[ClusterPlan]:
    """The ring route's plan of K1 (``arrays`` 1) or K2 (2) on ``(n, hw,
    c)``, rows of a multiple of 16 bytes: the ring of :func:`split_plan`'s
    rule over whole samples with clusters of up to 16 CTAs, then the apply
    / dx over :func:`apply_grid`'s row chunks.  None where that ring fits a
    CTA only with its chunk cut more than ``cuts`` times or with fewer CTAs
    (``cuts`` None: as often as it must).  An H100 measured the streaming
    variant faster there (``ring_sweeps.py ring --wide``, C = 1024: 1.4-3.2x
    at three of four cases, 1.14x slower at the fourth), and the route
    faster where one cut was enough (C = 512: 1.2-4.0x at seven of eight
    cases, 1 % slower at the eighth; PERF.md).

    K gives the grid about ``_SPLIT_GRID_CTAS`` CTAs (:func:`_ring_cluster`),
    the threads and the chunk are :func:`_split_ring`'s for that K.  In an
    H100's sweep of every (shape, dtype, kernel) of the 256x256 steps that
    no cluster holds (``ring_sweeps.py``, PERF.md) it was the fastest ring
    at 38 of 56 and within 11 % of it at the rest."""
    k = _ring_cluster(n, hw, c, itemsize, CLUSTER_MAX)
    ring = _split_ring(n, hw, c, itemsize, arrays, sm_count, k, cuts)
    if ring is None:
        return None
    chunk_rows = apply_grid(n, hw, c, itemsize, True, sm_count,
                            arrays == 2)[2]
    return ClusterPlan("ring", ring=ring, chunk_rows=chunk_rows)


def apply_grid(n: int, hw: int, c: int, itemsize: int, aligned: bool,
               sm_count: int, dx: bool = False) -> Tuple[int, int, int]:
    """``(vec, tx, chunk_rows)`` of an apply launch (``dx`` False: K1-split's
    and the ring route's ``instance_norm_apply``; True: K2's
    ``instance_norm_bwd_apply_dx``) over a grid of (sample, row chunk,
    channel tile) blocks of 256 threads, as :func:`_apply_tile` lays it out
    for a number of rows of every thread row.

    That number is what an H100 measured fastest at the split and 256x256
    shapes (``_APPLY_ROWS_PER_THREAD``): 4 in float32; in bfloat16, whose
    threads each load the statistics and affine of 8 channels before their
    rows, 8 for the apply and 32 for dx; halved while the grid has fewer
    blocks than ``sm_count``."""
    per = _APPLY_ROWS_PER_THREAD[(itemsize, bool(dx))]
    while True:
        vec, tx, chunk_rows = _apply_tile(hw, c, itemsize, aligned, per)
        if per == 1 or n * -(-c // (vec * tx)) * -(-hw // chunk_rows) \
                >= sm_count:
            return vec, tx, chunk_rows
        per //= 2


def _apply_tile(hw: int, c: int, itemsize: int, aligned: bool,
                rows_per_thread: int) -> Tuple[int, int, int]:
    """``(vec, tx, chunk_rows)`` of an apply / dx block: ``vec`` as in
    :func:`launch_geometry`, ``tx`` the power of two that covers C / vec (at
    most 32: whole rows of up to 32 packs, so a warp's loads are
    contiguous), and ``chunk_rows`` = ``rows_per_thread`` rows of every
    thread row, at most HW."""
    wide = 16 // itemsize
    vec = wide if (aligned and c % wide == 0) else 1
    packs = -(-c // vec)
    tx = 1
    while tx < 32 and tx < packs:
        tx *= 2
    return vec, tx, min(hw, _THREADS // tx * rows_per_thread)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


_P, _I = ctypes.c_void_p, ctypes.c_int
# instance_norm_fwd(x, scale, shift, y, mean, rstd; n, hw, c, affine_stride,
#                   dtype, vec, tx; eps; unbiased, relu; stream)
_FWD_ARGTYPES = [_P] * 6 + [_I] * 7 + [ctypes.c_float, _I, _I, _P]
# instance_norm_fwd_cluster(x, scale, shift, y, mean, rstd; n, hw, c,
#     affine_stride, dtype, cluster, rows, stages, threads, smem_bytes; eps;
#     unbiased, relu; stream)
_FWD_CLUSTER_ARGTYPES = [_P] * 6 + [_I] * 10 + [ctypes.c_float, _I, _I, _P]
# instance_norm_bwd(x, dy, mean, rstd, scale, shift, dx, dscale, dshift; n, hw,
#                   c, affine_stride, dtype, vec, tx, unbiased, relu; stream)
_BWD_ARGTYPES = [_P] * 9 + [_I] * 9 + [_P]
# instance_norm_bwd_cluster(x, dy, mean, rstd, scale, shift, dx, dscale,
#     dshift; n, hw, c, affine_stride, dtype, cluster, rows, stages, threads,
#     smem_bytes, unbiased, relu; stream)
_BWD_CLUSTER_ARGTYPES = [_P] * 9 + [_I] * 12 + [_P]
# instance_norm_ring_stats(x, mean, rstd; n, hw, c, dtype, cluster, rows,
#     stages, stage_rows, threads, smem_bytes; eps; unbiased; stream)
_RING_STATS_ARGTYPES = [_P] * 3 + [_I] * 10 + [ctypes.c_float, _I, _P]


def _c_function(kernel_name: str, fn_name: str, argtypes):
    """The C entry point ``fn_name`` of ``csrc/<kernel_name>.cu``."""
    fn = getattr(build.load_library(kernel_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _affine_pointers(scale, shift, c: int):
    """(scale tensor, shift tensor, stride) as the kernels read the affine:
    fp32, contiguous, ``scale[n * stride + c]``."""
    if scale is None:
        return None, None, 0
    # no-ops for the fp32 parameters and maps the norm modules pass
    scale = scale.detach().to(torch.float32).contiguous()
    shift = shift.detach().to(torch.float32).contiguous()
    return scale, shift, (c if scale.dim() == 2 else 0)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_launchable(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise RuntimeError("the instance-norm %s kernel needs a CUDA tensor, "
                           "got one on %s" % (what, x.device))
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor (strides %r for "
                         "shape %r)" % (x.stride(), tuple(x.shape)))
    if max(x.shape[0], x.shape[1] * x.shape[2], x.shape[3]) >= 2 ** 31:
        raise ValueError("a dimension of x exceeds int32: %r"
                         % (tuple(x.shape),))


def _count(wrapper, key, variant: str) -> None:
    with _count_lock:
        wrapper.launches += 1
        by_shape = wrapper.launches_by_shape
        by_shape[key] = by_shape.get(key, 0) + 1
        by_variant = wrapper.launches_by_variant
        by_variant[variant] = by_variant.get(variant, 0) + 1


def _plan_for(x: torch.Tensor, arrays: int, aligned: bool,
              plan: Optional[ClusterPlan]):
    """The plan of a launch on x (``plan`` if given), and the geometry
    ``(vec, tx)`` it needs: the streaming variant's, or the ring route's
    apply / dx tile."""
    n, h, w, c = x.shape
    sm_count = _sm_count(x.device.index)
    if plan is None:
        plan = cluster_plan(n, h * w, c, x.element_size(), arrays, sm_count,
                            aligned)
    if plan.variant != "streaming" and not aligned:
        raise ValueError("the %s variant needs 16-byte aligned tensors"
                         % plan.variant)
    if plan.variant == "ring":
        vec, tx, _ = apply_grid(n, h * w, c, x.element_size(), True,
                                sm_count, arrays == 2)
    else:
        vec, tx = launch_geometry(n, c, x.element_size(), aligned, sm_count)
    return plan, vec, tx


def _cluster_args(plan: ClusterPlan):
    return (plan.cluster, plan.rows, plan.stages, plan.threads,
            plan.smem_bytes)


def _launch(x: torch.Tensor, scale: Optional[torch.Tensor],
            shift: Optional[torch.Tensor], eps: float, unbiased: bool,
            relu: bool, plan: Optional[ClusterPlan] = None):
    """Launch the forward kernel on x's device and current stream, the
    variant :func:`cluster_plan` picks (or ``plan``).  Raises when x is not
    a contiguous CUDA tensor or the launch is refused."""
    _check_launchable(x, "forward")
    n, h, w, c = x.shape
    hw = h * w
    scale, shift, affine_stride = _affine_pointers(scale, shift, c)
    y = torch.empty_like(x)
    mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty((n, c), dtype=torch.float32, device=x.device)
    aligned = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    plan, vec, tx = _plan_for(x, 1, aligned, plan)
    dtype = _DTYPE_CODE[x.dtype]
    head = (x.data_ptr(), _ptr(scale), _ptr(shift), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), n, hw, c, affine_stride, dtype)
    tail = (float(eps), int(unbiased), int(relu))
    # the kernel must be launched with x's device current
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.variant == "cluster":
            fn = _c_function(KERNEL_NAME, "instance_norm_fwd_cluster",
                             _FWD_CLUSTER_ARGTYPES)
            err = fn(*head, *_cluster_args(plan), *tail, stream)
        elif plan.variant == "ring":
            # the ring's statistics (mean, rstd), then the row-gridded apply
            fn = _c_function(KERNEL_NAME, "instance_norm_ring_stats",
                             _RING_STATS_ARGTYPES)
            err = fn(x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n, hw,
                     c, dtype, *plan.ring[1:], float(eps), int(unbiased),
                     stream)
            if err == 0:
                fn = _c_function(KERNEL_NAME, "instance_norm_apply",
                                 _APPLY_ARGTYPES)
                err = fn(x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                         _ptr(scale), _ptr(shift), y.data_ptr(), n, hw, c,
                         affine_stride, dtype, vec, tx, plan.chunk_rows,
                         int(relu), stream)
        else:
            fn = _c_function(KERNEL_NAME, "instance_norm_fwd", _FWD_ARGTYPES)
            err = fn(*head, vec, tx, *tail, stream)
    if err != 0:
        raise RuntimeError(
            "instance_norm_fwd launch failed with cudaError %d for x %r %s, "
            "%r (streaming vec=%d tx=%d)"
            % (err, tuple(x.shape), x.dtype, plan, vec, tx))
    _count(instance_norm_fused, (n, hw, c), plan.variant)
    return y, mean, rstd


def instance_norm_bwd_plain(x: torch.Tensor, dy: torch.Tensor,
                            mean: torch.Tensor, rstd: torch.Tensor,
                            scale: Optional[torch.Tensor],
                            shift: Optional[torch.Tensor], *,
                            unbiased: bool = False, relu: bool = False):
    """Plain PyTorch version of the backward kernel, same arithmetic in fp32
    (the collapsed form stated in ``csrc/instance_norm_bwd.cu``).

    x, dy: NHWC; mean, rstd: (N, C) fp32 as the forward returned them;
    scale/shift: None, (C,) or (N, C).  Returns ``dx`` (x's shape and dtype)
    and per-sample ``dscale``, ``dshift`` (N, C) fp32: for a per-channel
    affine the caller sums them over N.
    """
    _check_x(x)
    n, h, w, c = x.shape
    hw = h * w
    _check_affine(scale, shift, n, c, x.device)
    if dy.shape != x.shape:
        raise ValueError("dy %r must have x's shape %r"
                         % (tuple(dy.shape), tuple(x.shape)))
    x32 = x.reshape(n, hw, c).to(torch.float32)
    g = dy.reshape(n, hw, c).to(torch.float32)
    rstd3 = rstd.reshape(n, 1, c)
    xhat = (x32 - mean.reshape(n, 1, c)) * rstd3
    if scale is None:
        s = torch.ones((1, 1, c), dtype=torch.float32, device=x.device)
        t = torch.zeros((1, 1, c), dtype=torch.float32, device=x.device)
    else:
        s = scale.to(torch.float32).reshape(-1, 1, c)
        t = shift.to(torch.float32).reshape(-1, 1, c)
    if relu:
        g = torch.where(xhat * s + t > 0.0, g, torch.zeros_like(g))
    dshift = g.sum(dim=1, keepdim=True)
    dscale = (g * xhat).sum(dim=1, keepdim=True)
    divisor = max(hw - 1, 1) if unbiased else hw
    dx = (s * rstd3) * (g - dshift * (1.0 / hw) - xhat * (dscale / divisor))
    return (dx.to(x.dtype).reshape(n, h, w, c), dscale[:, 0, :],
            dshift[:, 0, :])


def _launch_bwd(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                rstd: torch.Tensor, scale: Optional[torch.Tensor],
                shift: Optional[torch.Tensor], unbiased: bool, relu: bool,
                plan: Optional[ClusterPlan] = None):
    """Launch the backward kernel on x's device and current stream, the
    variant :func:`cluster_plan` picks (or ``plan``).  Raises when x or dy
    is not a contiguous CUDA tensor or the launch is refused."""
    _check_launchable(x, "backward")
    n, h, w, c = x.shape
    hw = h * w
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError("dy must be contiguous with x's shape, dtype and "
                         "device: got %r %s %s strides %r for x %r %s %s"
                         % (tuple(dy.shape), dy.dtype, dy.device, dy.stride(),
                            tuple(x.shape), x.dtype, x.device))
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.shape != (n, c) or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError("%s must be a contiguous (N, C) fp32 tensor on "
                             "x's device, got %r %s %s"
                             % (name, tuple(t.shape), t.dtype, t.device))
    scale, shift, affine_stride = _affine_pointers(scale, shift, c)
    dx = torch.empty_like(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, dx))
    plan, vec, tx = _plan_for(x, 2, aligned, plan)
    dscale = dshift = None
    if scale is not None or plan.variant == "ring":
        # the ring route's sums are its dx's too: kept without an affine
        dscale = torch.empty((n, c), dtype=torch.float32, device=x.device)
        dshift = torch.empty((n, c), dtype=torch.float32, device=x.device)
    dtype = _DTYPE_CODE[x.dtype]
    ptrs = (x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            _ptr(scale), _ptr(shift))
    head = ptrs + (dx.data_ptr(), _ptr(dscale), _ptr(dshift), n, hw, c,
                   affine_stride, dtype)
    tail = (int(unbiased), int(relu))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.variant == "cluster":
            fn = _c_function(BWD_KERNEL_NAME, "instance_norm_bwd_cluster",
                             _BWD_CLUSTER_ARGTYPES)
            err = fn(*head, *_cluster_args(plan), *tail, stream)
        elif plan.variant == "ring":
            # the ring's sums dshift = sum dy', dscale = sum dy' * xhat,
            # then the row-gridded dx from them
            fn = _c_function(BWD_KERNEL_NAME,
                             "instance_norm_bwd_partial_sums_cluster",
                             _PSUMS_CLUSTER_ARGTYPES)
            err = fn(*ptrs, dshift.data_ptr(), dscale.data_ptr(), n, hw, c,
                     affine_stride, dtype, *plan.ring[1:], int(relu),
                     stream)
            if err == 0:
                fn = _c_function(BWD_KERNEL_NAME,
                                 "instance_norm_bwd_apply_dx",
                                 _APPLY_DX_ARGTYPES)
                err = fn(*ptrs, dshift.data_ptr(), dscale.data_ptr(),
                         dx.data_ptr(), n, hw, c, hw, affine_stride, dtype,
                         vec, tx, plan.chunk_rows, *tail, stream)
            if scale is None:
                dscale = dshift = None
        else:
            fn = _c_function(BWD_KERNEL_NAME, "instance_norm_bwd",
                             _BWD_ARGTYPES)
            err = fn(*head, vec, tx, *tail, stream)
    if err != 0:
        raise RuntimeError(
            "instance_norm_bwd launch failed with cudaError %d for x %r %s, "
            "%r (streaming vec=%d tx=%d)"
            % (err, tuple(x.shape), x.dtype, plan, vec, tx))
    _count(instance_norm_bwd_fused, (n, hw, c), plan.variant)
    return dx, dscale, dshift


def instance_norm_bwd_fused(x: torch.Tensor, dy: torch.Tensor,
                            mean: torch.Tensor, rstd: torch.Tensor,
                            scale: Optional[torch.Tensor],
                            shift: Optional[torch.Tensor], *,
                            unbiased: bool = False, relu: bool = False):
    """Backward of :func:`instance_norm_fused` for the cotangent ``dy`` of y.

    Returns ``dx`` and per-sample ``dscale``, ``dshift`` (N, C) fp32 (both
    None without an affine).  A CUDA tensor goes to the kernel, a CPU tensor
    to :func:`instance_norm_bwd_plain`.  ``dy`` in another memory order than
    x's is copied into it first (counted in ``dy_copies``).
    """
    _check_x(x)
    if not dy.is_contiguous():
        dy = dy.contiguous()
        with _count_lock:
            instance_norm_bwd_fused.dy_copies += 1
    if not x.is_cuda:
        dx, dscale, dshift = instance_norm_bwd_plain(
            x, dy, mean, rstd, scale, shift, unbiased=unbiased, relu=relu)
        if scale is None:
            dscale = dshift = None
        return dx, dscale, dshift
    n, _, _, c = x.shape
    _check_affine(scale, shift, n, c, x.device)
    return _launch_bwd(x, dy, mean, rstd, scale, shift, unbiased, relu)


instance_norm_bwd_fused.launches = 0
instance_norm_bwd_fused.launches_by_shape = {}
instance_norm_bwd_fused.launches_by_variant = dict.fromkeys(VARIANTS, 0)
instance_norm_bwd_fused.dy_copies = 0


class _InstanceNorm(torch.autograd.Function):
    """Binds the two wrappers, as ``_in_core``'s ``custom_vjp`` does in the
    TPU package: forward saves x, mean, rstd and the affine, backward hands
    them to the backward wrapper."""

    @staticmethod
    def forward(ctx, x, scale, shift, eps, unbiased, relu):
        if x.is_cuda:
            y, mean, rstd = _launch(x, scale, shift, eps, unbiased, relu)
        else:
            y, mean, rstd = instance_norm_plain(
                x, scale, shift, eps=eps, unbiased=unbiased, relu=relu,
                return_stats=True)
        ctx.save_for_backward(x, mean, rstd, scale, shift)
        ctx.unbiased, ctx.relu = unbiased, relu
        ctx.mark_non_differentiable(mean, rstd)
        return y, mean, rstd

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, _dmean, _drstd):
        x, mean, rstd, scale, shift = ctx.saved_tensors
        dx, dscale, dshift = instance_norm_bwd_fused(
            x, dy, mean, rstd, scale, shift, unbiased=ctx.unbiased,
            relu=ctx.relu)
        if scale is not None and scale.dim() == 1:
            # per-channel parameters: the kernel answers per sample
            dscale, dshift = dscale.sum(0), dshift.sum(0)
        if scale is not None:
            dscale, dshift = dscale.to(scale.dtype), dshift.to(shift.dtype)
        if not ctx.needs_input_grad[0]:
            dx = None
        return dx, dscale, dshift, None, None, None


def instance_norm_fused(x: torch.Tensor, scale: Optional[torch.Tensor],
                        shift: Optional[torch.Tensor], *, eps: float = 1e-5,
                        unbiased: bool = False, relu: bool = False,
                        return_stats: bool = False):
    """Fused instance norm on NHWC input.

    scale/shift: None (no affine), (C,) per-channel, or (N, C) per-sample
    (the conditional-instance-norm case).  Output has x's dtype; with
    ``return_stats`` also returns ``mean`` and ``rstd`` (N, C) fp32.

    A CUDA tensor goes to the kernel (``instance_norm_fused.launches`` counts
    the launches, ``launches_by_shape`` the same per ``(N, HW, C)``), a CPU
    tensor to :func:`instance_norm_plain`.  Differentiable in x, scale and
    shift: the backward is :func:`instance_norm_bwd_fused`.
    """
    _check_x(x)
    n, _, _, c = x.shape
    _check_affine(scale, shift, n, c, x.device)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, scale, shift)):
        y, mean, rstd = _InstanceNorm.apply(x, scale, shift, float(eps),
                                            bool(unbiased), bool(relu))
    elif x.is_cuda:
        # nothing to differentiate (serving): skip the Function's host cost
        y, mean, rstd = _launch(x, scale, shift, eps, unbiased, relu)
    else:
        y, mean, rstd = instance_norm_plain(
            x, scale, shift, eps=eps, unbiased=unbiased, relu=relu,
            return_stats=True)
    if return_stats:
        return y, mean, rstd
    return y


instance_norm_fused.launches = 0
instance_norm_fused.launches_by_shape = {}
instance_norm_fused.launches_by_variant = dict.fromkeys(VARIANTS, 0)


# ---------------------------------------------------------------------------
# The split forms (K1-split, K2-split): an activation sliced by rows over
# ranks (``--spatial``).  Each rank holds some of every sample's rows, so the
# statistics and the backward's two sums are formed from per-rank partials
# combined over the space group between two launches (``csrc/
# instance_norm.cu`` and ``csrc/instance_norm_bwd.cu``, the K1-split and
# K2-split sections; K1's and K2's ring route launches the same kernels
# over whole samples, counted as its own).  Each entry point has a wrapper
# (CUDA tensor: its kernel, or it raises; CPU tensor: its plain twin) that
# counts its launches in ``launches`` / ``launches_by_shape`` /
# ``launches_by_variant`` as the unsplit wrappers do.  The two reductions
# (partial statistics, partial sums) have two variants each, and
# :func:`split_plan` picks one per shape: the cluster one (a sample's rows
# on the rank split over a thread-block cluster, streamed once through a
# ring in shared memory) and the "rows" one (one block per sample and
# channel tile looping over the rows).
# ---------------------------------------------------------------------------

# instance_norm_partial_stats(x, mean, m2; n, hw, c, dtype, vec, tx; stream)
_PSTATS_ARGTYPES = [_P] * 3 + [_I] * 6 + [_P]
# instance_norm_partial_stats_cluster(x, mean, m2; n, hw, c, dtype, cluster,
#     rows, stages, stage_rows, threads, smem_bytes; stream)
_PSTATS_CLUSTER_ARGTYPES = [_P] * 3 + [_I] * 10 + [_P]
# instance_norm_apply(x, mean, rstd, scale, shift, y; n, hw, c,
#                     affine_stride, dtype, vec, tx, chunk_rows, relu; stream)
_APPLY_ARGTYPES = [_P] * 6 + [_I] * 9 + [_P]
# instance_norm_bwd_partial_sums(x, dy, mean, rstd, scale, shift, sum_g,
#     sum_gx; n, hw, c, affine_stride, dtype, vec, tx, relu; stream)
_PSUMS_ARGTYPES = [_P] * 8 + [_I] * 8 + [_P]
# instance_norm_bwd_partial_sums_cluster(x, dy, mean, rstd, scale, shift,
#     sum_g, sum_gx; n, hw, c, affine_stride, dtype, cluster, rows, stages,
#     stage_rows, threads, smem_bytes, relu; stream)
_PSUMS_CLUSTER_ARGTYPES = [_P] * 8 + [_I] * 12 + [_P]
# instance_norm_bwd_apply_dx(x, dy, mean, rstd, scale, shift, sum_g, sum_gx,
#     dx; n, hw, c, hw_total, affine_stride, dtype, vec, tx, chunk_rows,
#     unbiased, relu; stream)
_APPLY_DX_ARGTYPES = [_P] * 9 + [_I] * 11 + [_P]


class SplitPlan(NamedTuple):
    """How a split reduction (K1-split's partial statistics, K2-split's
    partial sums) runs one shape.  ``variant`` is ``"cluster"`` (the ring
    kernels of ``csrc/instance_norm_cluster.cuh``: ``cluster`` CTAs per
    sample, each owning ``rows`` rows and streaming them through a ring of
    ``stages`` slots of ``stage_rows`` rows, ``threads`` threads,
    ``smem_bytes`` of shared memory) or ``"rows"`` (the first, streaming
    kernels, one block per sample and channel tile, geometry from
    :func:`launch_geometry`; the other fields are 0)."""

    variant: str
    cluster: int = 0
    rows: int = 0
    stages: int = 0
    stage_rows: int = 0
    threads: int = 0
    smem_bytes: int = 0

    def row_ranges(self, hw: int) -> List[Tuple[int, int]]:
        """``[first, last)`` rows of each CTA of a cluster, in rank order."""
        return [(min(k * self.rows, hw), min((k + 1) * self.rows, hw))
                for k in range(self.cluster)]

    def chunk_ranges(self, first: int, last: int) -> List[Tuple[int, int]]:
        """``[r0, r1)`` rows of each chunk the CTA owning ``[first, last)``
        streams through its ring, in order."""
        return [(r, min(r + self.stage_rows, last))
                for r in range(first, last, self.stage_rows)]


SPLIT_ROWS = SplitPlan("rows")

RING_ROWS_PER_THREAD = 4  # csrc/instance_norm_cluster.cuh::kRingRowsPerThread
RING_STAGES_MAX = 8       # ::kRingStagesMax
RING_THREADS_MAX = 512    # ::kRingThreadsMax
_RING_STAGES = 2          # slots of a ring: the card measured two fastest


def _ring_smem_bytes(arrays: int, stage_rows: int, c: int, itemsize: int,
                     threads: int, stages: int, cluster: int) -> int:
    """Dynamic shared memory of a ring CTA, as
    ``csrc/instance_norm_cluster.cuh::ring_layout`` lays it out: the ring,
    3 C partials per CTA of the cluster, the tree (one row of 3 C floats per
    warp where C / vec divides 32, else per thread row), the barriers."""
    packs = c * itemsize // 16
    tree_rows = threads // 32 if 32 % packs == 0 and packs < 32 else \
        threads // packs
    return (stages * arrays * stage_rows * c * itemsize + cluster * 3 * c * 4
            + tree_rows * c * 3 * 4 + stages * 8)


def ring_plan(hw: int, c: int, itemsize: int, arrays: int, cluster: int,
              stages: int = _RING_STAGES,
              stage_rows: Optional[int] = None,
              threads: int = _THREADS) -> SplitPlan:
    """The cluster variant's plan with ``cluster`` CTAs per sample of
    ``threads`` threads (rounded down to a multiple of the C / vec channel
    packs): each owns ``ceil(hw / cluster)`` rows; a chunk is
    ``stage_rows`` rows (default: ``RING_ROWS_PER_THREAD`` rows of every
    thread, 16 KB of each array at 256 threads, or the CTA's rows if
    fewer); the ring has ``stages`` slots.  Raises ValueError for a plan
    the kernels do not take."""
    row_bytes = c * itemsize
    packs = row_bytes // 16
    if row_bytes % 16 or packs > threads or threads > RING_THREADS_MAX:
        raise ValueError("the cluster variant does not take C=%d at %d bytes "
                         "with %d threads" % (c, itemsize, threads))
    if cluster not in (1, 2, 4, 8, 16):
        raise ValueError("a cluster of %r CTAs" % (cluster,))
    threads = packs * (threads // packs)
    rows = -(-hw // cluster)
    if stage_rows is None:
        stage_rows = min(rows, RING_ROWS_PER_THREAD * (threads // packs))
    if not 1 <= stages <= RING_STAGES_MAX or stage_rows < 1:
        raise ValueError("a ring of %r slots of %r rows" % (stages,
                                                             stage_rows))
    smem = _ring_smem_bytes(arrays, stage_rows, c, itemsize, threads, stages,
                            cluster)
    if smem > SMEM_PER_CTA_MAX:
        raise ValueError("a ring of %d slots of %d rows of %d arrays needs "
                         "%d bytes of shared memory" % (
                             stages, stage_rows, arrays, smem))
    return SplitPlan("cluster", cluster, rows, stages, stage_rows, threads,
                     smem)


# split_plan's rule, measured on an H100 at every rank shape phase 12 gives
# the split reductions (``ring_sweeps.py splits``, PERF.md): the
# cluster grows while the grid has fewer than _SPLIT_GRID_CTAS CTAs; the
# partial statistics take 512 threads where the grid has fewer CTAs than
# the card has SMs and a CTA streams at least _SPLIT_WIDE_CTA_BYTES; a
# chunk is doubled where the CTA holds four or more
_SPLIT_GRID_CTAS = 64
_SPLIT_WIDE_CTA_BYTES = 256 << 10


def _ring_cluster(n: int, hw: int, c: int, itemsize: int,
                  k_max: int) -> int:
    """The ring's cluster size: the smallest power of two, up to ``k_max``,
    that gives the grid of N * K CTAs at least ``_SPLIT_GRID_CTAS``, as long
    as each CTA keeps two chunks of rows."""
    chunk = RING_ROWS_PER_THREAD * (_THREADS // (c * itemsize // 16))
    k = 1
    while (k < k_max and n * k < _SPLIT_GRID_CTAS
           and -(-hw // (2 * k)) >= 2 * chunk):
        k *= 2
    return k


def _split_ring(n: int, hw: int, c: int, itemsize: int, arrays: int,
                sm_count: int, k: int,
                cuts: Optional[int] = None) -> Optional[SplitPlan]:
    """The ring of a cluster of ``k`` CTAs under split_plan's rule.  Where
    its CTA would need more than ``SMEM_PER_CTA_MAX`` of shared memory (wide
    rows: the ring holds two chunks of each array, and rank 0 the partials
    of all K CTAs), the chunk is halved, down to one row of every thread
    row, and failing that K is halved and the chunk tried anew.  With
    ``cuts`` given, None where that takes more than ``cuts`` halvings;
    without, as many as it takes: a CTA of one such row fits at K = 1 for
    any row the ring takes (at most 256 packs of 16 bytes)."""
    row_bytes = c * itemsize
    packs = row_bytes // 16
    cta_rows = -(-hw // k)
    threads = _THREADS
    if (arrays == 1 and n * k < sm_count
            and cta_rows * row_bytes >= _SPLIT_WIDE_CTA_BYTES):
        threads = RING_THREADS_MAX
    chunk = RING_ROWS_PER_THREAD * (threads // packs)
    if cta_rows >= 4 * chunk:
        chunk *= 2
    rows = min(chunk, cta_rows)
    while _ring_smem_bytes(arrays, rows, c, itemsize,
                           packs * (threads // packs), _RING_STAGES,
                           k) > SMEM_PER_CTA_MAX:
        if cuts is not None:
            if cuts == 0:
                return None
            cuts -= 1
        if rows > threads // packs:
            rows //= 2
        elif k > 1:
            k //= 2
            rows = min(chunk, -(-hw // k))
        else:
            break  # ring_plan raises
    return ring_plan(hw, c, itemsize, arrays, k, stage_rows=rows,
                     threads=threads)


@functools.lru_cache(maxsize=None)
def split_plan(n: int, hw: int, c: int, itemsize: int, arrays: int,
               sm_count: int, aligned: bool = True,
               on_chip: bool = False) -> SplitPlan:
    """The plan of a split reduction's launch on a rank's rows ``(n, hw,
    c)``: ``arrays`` is 1 for K1-split's partial statistics (x), 2 for
    K2-split's partial sums (x and dy).

    The variant is a test of legality, not of speed: the cluster variant
    needs rows of a multiple of 16 bytes (C * itemsize) and 16-byte aligned
    tensors, so that every row boundary is a legal bulk copy boundary;
    shapes without them take the ``"rows"`` variant (the first, streaming
    kernels), and every other shape takes the cluster variant.  In the
    sweep of every (shape, dtype, reduction) case phase 12 gives the
    reductions (``ring_sweeps.py splits``, PERF.md) an H100 measured
    that variant faster in 108 of the 116, several times faster at a
    256x256 rank's shapes, and 1.6-16 % slower in the other eight, each
    under 0.09 ms.  No observable of the shape separates those eight (the
    partial statistics lose at (10, 512, 128) and win at (32, 512, 128)),
    so the rule accepts those losses.

    What the card measured fastest sets the ring
    (``ring_sweeps.py splits``): the cluster size K is the smallest
    power of two, up to the portable 8, that gives the grid of N * K CTAs
    at least ``_SPLIT_GRID_CTAS`` (about half an H100's SMs; more CTAs, each
    with less to stream, measured slower), as long as each CTA keeps at
    least two chunks of rows; the partial statistics, whose one pass does
    more arithmetic per byte, run 512 threads a CTA where the grid has
    fewer CTAs than the card has SMs and each streams 256 KB or more; a
    chunk is ``RING_ROWS_PER_THREAD`` rows of every thread, doubled where a
    CTA holds four or more; the ring has two slots.

    ``on_chip`` forces the cluster variant with the K above (checks and
    measurements of that variant where the rule picks ``"rows"``); it
    raises if the variant cannot run so.  A plan of another K is
    :func:`ring_plan`'s.
    """
    row_bytes = c * itemsize
    if not aligned or row_bytes % 16 or row_bytes // 16 > _THREADS:
        if on_chip:
            raise ValueError("the cluster variant does not take C=%d at %d "
                             "bytes (aligned=%s)" % (c, itemsize, aligned))
        return SPLIT_ROWS
    k = _ring_cluster(n, hw, c, itemsize, _CLUSTER_PORTABLE)
    return _split_ring(n, hw, c, itemsize, arrays, sm_count, k)


def instance_norm_partial_stats_plain(x: torch.Tensor):
    """Plain twin of K1-split's first launch: per (sample, channel) the
    mean and the centered sum of squares M2 over this slice's HW rows,
    (N, C) fp32 each."""
    _check_x(x)
    n, h, w, c = x.shape
    x32 = x.reshape(n, h * w, c).to(torch.float32)
    mean = x32.mean(dim=1, keepdim=True)
    d = x32 - mean
    return mean[:, 0, :], (d * d).sum(dim=1)


def instance_norm_apply_plain(x, mean, rstd, scale, shift, *,
                              relu: bool = False):
    """Plain twin of K1-split's second launch: ``(x - mean) * rstd``, the
    affine ((C,) or (N, C)), the optional ReLU, in x's dtype."""
    _check_x(x)
    n, h, w, c = x.shape
    _check_affine(scale, shift, n, c, x.device)
    x32 = x.reshape(n, h * w, c).to(torch.float32)
    y = (x32 - mean.reshape(n, 1, c)) * rstd.reshape(n, 1, c)
    if scale is not None:
        y = (y * scale.to(torch.float32).reshape(-1, 1, c)
             + shift.to(torch.float32).reshape(-1, 1, c))
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype).reshape(n, h, w, c)


def _xhat_and_grad(x, dy, mean, rstd, scale, shift, relu):
    n, h, w, c = x.shape
    x32 = x.reshape(n, h * w, c).to(torch.float32)
    g = dy.reshape(n, h * w, c).to(torch.float32)
    xhat = (x32 - mean.reshape(n, 1, c)) * rstd.reshape(n, 1, c)
    if scale is None:
        s = torch.ones((1, 1, c), dtype=torch.float32, device=x.device)
        t = torch.zeros((1, 1, c), dtype=torch.float32, device=x.device)
    else:
        s = scale.to(torch.float32).reshape(-1, 1, c)
        t = shift.to(torch.float32).reshape(-1, 1, c)
    if relu:
        g = torch.where(xhat * s + t > 0.0, g, torch.zeros_like(g))
    return xhat, g, s


def instance_norm_bwd_partial_sums_plain(x, dy, mean, rstd, scale, shift, *,
                                         relu: bool = False):
    """Plain twin of K2-split's first launch: per (sample, channel) the sums
    of dy' and dy' * xhat over this slice's rows (dy' masked by the
    recomputed ReLU), (N, C) fp32 each."""
    _check_x(x)
    xhat, g, _ = _xhat_and_grad(x, dy, mean, rstd, scale, shift, relu)
    return g.sum(dim=1), (g * xhat).sum(dim=1)


def instance_norm_bwd_apply_dx_plain(x, dy, mean, rstd, scale, shift, sum_g,
                                     sum_gx, hw_total: int, *,
                                     unbiased: bool = False,
                                     relu: bool = False):
    """Plain twin of K2-split's second launch: dx of this slice's rows from
    the global sums over a sample's ``hw_total`` rows (the collapsed form of
    :func:`instance_norm_bwd_plain`)."""
    _check_x(x)
    n, h, w, c = x.shape
    xhat, g, s = _xhat_and_grad(x, dy, mean, rstd, scale, shift, relu)
    divisor = max(hw_total - 1, 1) if unbiased else hw_total
    dx = (s * rstd.reshape(n, 1, c)) * (
        g - sum_g.reshape(n, 1, c) * (1.0 / hw_total)
        - xhat * (sum_gx.reshape(n, 1, c) / divisor))
    return dx.to(x.dtype).reshape(n, h, w, c)


def combine_stats(means, m2s, counts):
    """Chan et al.'s merge of per-slice statistics, in slice order: the
    mean and the centered sum of squares about it over all the slices'
    rows.  ``means``, ``m2s``: sequences of (N, C) fp32; ``counts``: rows
    per slice.  Returns (mean, M2, total count)."""
    total = sum(counts)
    acc = None
    for m, k in zip(means, counts):
        acc = m * float(k) if acc is None else acc + m * float(k)
    mean = acc / float(total)
    m2 = None
    for m, q, k in zip(means, m2s, counts):
        d = m - mean
        term = q + float(k) * d * d
        m2 = term if m2 is None else m2 + term
    return mean, m2, total


def _split_launch(x, fn_name, argtypes, lib, *args, plan=SPLIT_ROWS):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _c_function(lib, fn_name, argtypes)(*args, stream)
    if err != 0:
        raise RuntimeError("%s launch failed with cudaError %d for x %r %s, "
                           "%r" % (fn_name, err, tuple(x.shape), x.dtype,
                                   plan))


def _split_geometry(x, *others):
    aligned = all(t.data_ptr() % 16 == 0 for t in (x,) + others)
    return launch_geometry(x.shape[0], x.shape[3], x.element_size(), aligned,
                           _sm_count(x.device.index))


def _apply_geometry(x, dx, *others):
    """``(vec, tx, chunk_rows)`` of an apply (``dx`` False) or dx launch on
    x (and ``others``): :func:`apply_grid`'s."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x,) + others)
    n, h, w, c = x.shape
    return apply_grid(n, h * w, c, x.element_size(), aligned,
                      _sm_count(x.device.index), dx)


def _split_plan_for(x, arrays: int, plan: Optional[SplitPlan], *others):
    """The plan of a split reduction's launch on x (and ``others``, read
    beside it): ``plan`` if given, else :func:`split_plan`'s."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x,) + others)
    if plan is None:
        n, h, w, c = x.shape
        return split_plan(n, h * w, c, x.element_size(), arrays,
                          _sm_count(x.device.index), aligned)
    if plan.variant == "cluster" and not aligned:
        raise ValueError("the cluster variant needs 16-byte aligned tensors")
    return plan


def _count_split(wrapper, x, variant: str = "rows") -> None:
    n, h, w, c = x.shape
    with _count_lock:
        wrapper.launches += 1
        key = (n, h * w, c)
        wrapper.launches_by_shape[key] = \
            wrapper.launches_by_shape.get(key, 0) + 1
        wrapper.launches_by_variant[variant] = \
            wrapper.launches_by_variant.get(variant, 0) + 1


def instance_norm_partial_stats(x: torch.Tensor, *,
                                plan: Optional[SplitPlan] = None):
    """K1-split, first launch (see :func:`instance_norm_partial_stats_plain`
    for what it computes): the variant :func:`split_plan` picks, or
    ``plan``."""
    _check_x(x)
    if not x.is_cuda:
        return instance_norm_partial_stats_plain(x)
    _check_launchable(x, "partial-statistics")
    n, h, w, c = x.shape
    mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
    m2 = torch.empty_like(mean)
    plan = _split_plan_for(x, 1, plan)
    head = (x.data_ptr(), mean.data_ptr(), m2.data_ptr(), n, h * w, c,
            _DTYPE_CODE[x.dtype])
    if plan.variant == "cluster":
        _split_launch(x, "instance_norm_partial_stats_cluster",
                      _PSTATS_CLUSTER_ARGTYPES, KERNEL_NAME, *head,
                      *plan[1:], plan=plan)
    else:
        _split_launch(x, "instance_norm_partial_stats", _PSTATS_ARGTYPES,
                      KERNEL_NAME, *head, *_split_geometry(x))
    _count_split(instance_norm_partial_stats, x, plan.variant)
    return mean, m2


def instance_norm_apply(x, mean, rstd, scale, shift, *, relu: bool = False):
    """K1-split, second launch (:func:`instance_norm_apply_plain`), over the
    grid :func:`apply_grid` gives."""
    _check_x(x)
    n, h, w, c = x.shape
    _check_affine(scale, shift, n, c, x.device)
    if not x.is_cuda:
        return instance_norm_apply_plain(x, mean, rstd, scale, shift,
                                         relu=relu)
    _check_launchable(x, "apply")
    scale, shift, stride = _affine_pointers(scale, shift, c)
    mean, rstd = mean.contiguous(), rstd.contiguous()
    y = torch.empty_like(x)
    vec, tx, chunk_rows = _apply_geometry(x, False, y)
    _split_launch(x, "instance_norm_apply", _APPLY_ARGTYPES, KERNEL_NAME,
                  x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), _ptr(scale),
                  _ptr(shift), y.data_ptr(), n, h * w, c, stride,
                  _DTYPE_CODE[x.dtype], vec, tx, chunk_rows, int(relu))
    _count_split(instance_norm_apply, x)
    return y


def instance_norm_bwd_partial_sums(x, dy, mean, rstd, scale, shift, *,
                                   relu: bool = False,
                                   plan: Optional[SplitPlan] = None):
    """K2-split, first launch
    (:func:`instance_norm_bwd_partial_sums_plain`): the variant
    :func:`split_plan` picks, or ``plan``."""
    _check_x(x)
    n, h, w, c = x.shape
    _check_affine(scale, shift, n, c, x.device)
    dy = dy.contiguous()
    if not x.is_cuda:
        return instance_norm_bwd_partial_sums_plain(
            x, dy, mean, rstd, scale, shift, relu=relu)
    _check_launchable(x, "partial-sums")
    scale, shift, stride = _affine_pointers(scale, shift, c)
    mean, rstd = mean.contiguous(), rstd.contiguous()
    sum_g = torch.empty((n, c), dtype=torch.float32, device=x.device)
    sum_gx = torch.empty_like(sum_g)
    plan = _split_plan_for(x, 2, plan, dy)
    head = (x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            _ptr(scale), _ptr(shift), sum_g.data_ptr(), sum_gx.data_ptr(), n,
            h * w, c, stride, _DTYPE_CODE[x.dtype])
    if plan.variant == "cluster":
        _split_launch(x, "instance_norm_bwd_partial_sums_cluster",
                      _PSUMS_CLUSTER_ARGTYPES, BWD_KERNEL_NAME, *head,
                      *plan[1:], int(relu), plan=plan)
    else:
        _split_launch(x, "instance_norm_bwd_partial_sums", _PSUMS_ARGTYPES,
                      BWD_KERNEL_NAME, *head, *_split_geometry(x, dy),
                      int(relu))
    _count_split(instance_norm_bwd_partial_sums, x, plan.variant)
    return sum_g, sum_gx


def instance_norm_bwd_apply_dx(x, dy, mean, rstd, scale, shift, sum_g,
                               sum_gx, hw_total: int, *,
                               unbiased: bool = False, relu: bool = False):
    """K2-split, second launch (:func:`instance_norm_bwd_apply_dx_plain`),
    over the grid :func:`apply_grid` gives."""
    _check_x(x)
    n, h, w, c = x.shape
    _check_affine(scale, shift, n, c, x.device)
    dy = dy.contiguous()
    if not x.is_cuda:
        return instance_norm_bwd_apply_dx_plain(
            x, dy, mean, rstd, scale, shift, sum_g, sum_gx, hw_total,
            unbiased=unbiased, relu=relu)
    _check_launchable(x, "apply-dx")
    scale, shift, stride = _affine_pointers(scale, shift, c)
    mean, rstd = mean.contiguous(), rstd.contiguous()
    sum_g, sum_gx = sum_g.contiguous(), sum_gx.contiguous()
    dx = torch.empty_like(x)
    vec, tx, chunk_rows = _apply_geometry(x, True, dy, dx)
    _split_launch(x, "instance_norm_bwd_apply_dx", _APPLY_DX_ARGTYPES,
                  BWD_KERNEL_NAME, x.data_ptr(), dy.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr(), _ptr(scale), _ptr(shift),
                  sum_g.data_ptr(), sum_gx.data_ptr(), dx.data_ptr(), n,
                  h * w, c, int(hw_total), stride, _DTYPE_CODE[x.dtype], vec,
                  tx, chunk_rows, int(unbiased), int(relu))
    _count_split(instance_norm_bwd_apply_dx, x)
    return dx


SPLIT_WRAPPERS = (instance_norm_partial_stats, instance_norm_apply,
                  instance_norm_bwd_partial_sums, instance_norm_bwd_apply_dx)
# the two reductions, which have a cluster variant beside the "rows" one
SPLIT_REDUCTIONS = (instance_norm_partial_stats,
                    instance_norm_bwd_partial_sums)
for _w in SPLIT_WRAPPERS:
    _w.launches = 0
    _w.launches_by_shape = {}
    _w.launches_by_variant = {}

class _InstanceNormSplit(torch.autograd.Function):
    """K1-split and K2-split behind one autograd node.  ``reducer`` does the
    collectives between the launches: ``combine(mean, m2, rows)`` returns
    the global (mean, M2, rows) of the slices' statistics, ``sum_(t)`` sums
    a tensor over the slices.  The backward's dx comes from the global
    sums; dscale and dshift are this slice's share (its rows' sums), which
    the caller's gradient reduction adds up.  ``plain`` runs the plain
    twins."""

    @staticmethod
    def forward(ctx, x, scale, shift, eps, unbiased, relu, reducer, plain):
        n, h, w, c = x.shape
        if plain:
            mean_l, m2_l = instance_norm_partial_stats_plain(x)
        else:
            mean_l, m2_l = instance_norm_partial_stats(x)
        mean, m2, rows = reducer.combine(mean_l, m2_l, h * w)
        correction = rows / max(rows - 1, 1) if unbiased else 1.0
        rstd = torch.rsqrt(m2 / float(rows) * correction + eps)
        apply = instance_norm_apply_plain if plain else instance_norm_apply
        y = apply(x, mean, rstd, scale, shift, relu=relu)
        ctx.save_for_backward(x, mean, rstd, scale, shift)
        ctx.unbiased, ctx.relu, ctx.rows = unbiased, relu, rows
        ctx.reducer, ctx.plain = reducer, plain
        ctx.mark_non_differentiable(mean, rstd)
        return y, mean, rstd

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, _dmean, _drstd):
        x, mean, rstd, scale, shift = ctx.saved_tensors
        dy = dy.contiguous()
        if ctx.plain:
            sums, dx_fn = instance_norm_bwd_partial_sums_plain, \
                instance_norm_bwd_apply_dx_plain
        else:
            sums, dx_fn = instance_norm_bwd_partial_sums, \
                instance_norm_bwd_apply_dx
        sum_g, sum_gx = sums(x, dy, mean, rstd, scale, shift, relu=ctx.relu)
        total = ctx.reducer.sum_(torch.stack([sum_g, sum_gx]))
        dx = dx_fn(x, dy, mean, rstd, scale, shift, total[0], total[1],
                   ctx.rows, unbiased=ctx.unbiased, relu=ctx.relu)
        dscale = dshift = None
        if scale is not None:
            dscale, dshift = sum_gx, sum_g
            if scale.dim() == 1:
                dscale, dshift = dscale.sum(0), dshift.sum(0)
            dscale, dshift = dscale.to(scale.dtype), dshift.to(shift.dtype)
        if not ctx.needs_input_grad[0]:
            dx = None
        return dx, dscale, dshift, None, None, None, None, None


def instance_norm_split(x: torch.Tensor, scale, shift, reducer, *,
                        eps: float = 1e-5, unbiased: bool = False,
                        relu: bool = False, plain: bool = False):
    """Instance norm of this slice's rows of an NHWC activation whose rows
    are spread over ranks (``reducer``: the collectives over them, as
    :class:`_InstanceNormSplit` takes them); differentiable in x, scale and
    shift.  Returns y."""
    _check_x(x)
    n, _, _, c = x.shape
    _check_affine(scale, shift, n, c, x.device)
    with _count_lock:
        key = (n, x.shape[1] * x.shape[2], c)
        by = instance_norm_split.calls_by_shape
        by[key] = by.get(key, 0) + 1
    y, _, _ = _InstanceNormSplit.apply(x, scale, shift, float(eps),
                                       bool(unbiased), bool(relu), reducer,
                                       bool(plain))
    return y


# norms computed in split form in this process by (N, HW, C) of the slice
# (either device; the kernels' launches are counted by their own wrappers)
instance_norm_split.calls_by_shape = {}
