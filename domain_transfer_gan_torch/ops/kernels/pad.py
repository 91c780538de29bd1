"""Reflection and replication padding of an NCHW activation: the Hopper
kernels' wrappers, their plain PyTorch versions and the
``torch.autograd.Function`` that binds them.

The networks pad before every 3x3 and 7x7 convolution of the generators
(``parallel/spatial.py::conv2d_layer``, and along W under a space axis,
``conv_rows``).  ``pad2d`` takes ``F.pad``'s arguments for those two modes.
On a CUDA tensor its forward launches the kernel ``pad2d_fwd`` of
``csrc/pad.cu`` and its backward ``pad2d_bwd``, or they raise; on a CPU
tensor it is ``F.pad`` itself (whose CPU backward adds in a fixed order).
There is no way from a kernel to its plain version.

The kernels replace no TPU kernel: ``F.pad``'s CUDA backward adds the
border's gradients with atomics in an order that changes from run to run,
and the kernel's backward gathers them in a fixed order instead, so a train
step or a UBO step repeats bit for bit (``csrc/pad.cu`` says how).

The kernels take activations in ``torch.channels_last`` memory, the
networks' layout, and write their outputs so; a tensor in another memory
order is copied into it first (counted in ``pad2d.copies``).  Each wrapper
counts its launches (``pad2d.launches``, ``pad2d_bwd.launches``, the same
per ``(N, C, H, W, pads, mode, dtype)`` of the input in
``launches_by_shape`` and per kernel, band or words, in
``launches_by_kernel``).

:func:`pad_plan` owns the kernels' geometry: which kernel a launch takes
(the band kernels, one CTA per (sample, band of rows), or the word
kernels), the band's row count and the CTA's threads.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .instance_norm import _c_function

KERNEL_NAME = "pad"
MODES = {"reflect": 0, "replicate": 1}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
# pad2d_fwd(x, y; n, h, w, c, itemsize, top, bottom, left, right, mode,
#           rows, threads; stream); pad2d_bwd(dy, dx; n, h, w, c, dtype,
#           top, bottom, left, right, mode, rows, threads; stream)
_ARGTYPES = [_P] * 2 + [_I] * 12 + [_P]

SMS = 132  # an H100 SXM's multiprocessors
# The rule an H100 measured (ring_sweeps.py pads --bands, PERF.md): the
# band kernels where a pixel is not a multiple of 16 bytes (conv0's 12- and
# 6-byte pixels), the backward's only where it also reads at least
# BAND_BWD_MIN_BYTES of dy; the word kernels elsewhere (a 16-byte pixel's
# forward is a 16-byte streaming copy already).  A forward band holds at
# most BAND_BYTES_PER_THREAD output bytes a thread, a backward band at most
# BAND_BWD_ELEMENTS elements; at least one step of rows, and fewer rows
# where the launch would have fewer than two bands a multiprocessor.
BAND_BWD_MIN_BYTES = 6 << 20
BAND_BYTES_PER_THREAD = 56
BAND_BWD_ELEMENTS = 512
BAND_THREADS = 128  # the forward's with 2-byte words: 256
TABLE_BYTES_MAX = 49152  # csrc/pad.cu::kTableBytesMax


class PadPlan(NamedTuple):
    """A launch's geometry: ``rows`` of a sample a band CTA takes (output
    rows forward, input rows backward; 0 for the word kernels), its
    ``threads``, ``bands`` a sample, and whether every band starts and ends
    on 16 bytes (``store16``: no word stored alone)."""
    rows: int
    threads: int
    bands: int
    store16: bool


WORDS = PadPlan(0, 0, 0, False)


def _word(pixel_bytes: int) -> int:
    """csrc/pad.cu::pad2d_fwd's word for aligned tensors: the widest of 16,
    8, 4, 2 bytes that divides a pixel."""
    return next(b for b in (16, 8, 4, 2) if pixel_bytes % b == 0)


@functools.lru_cache(maxsize=None)
def pad_plan(shape, pads, mode: str, itemsize: int, backward: bool,
             sms: int = SMS) -> PadPlan:
    """The geometry of the forward (``backward`` False) or backward launch
    at an input of ``shape`` (N, C, H, W) padded by ``pads`` (left, right,
    top, bottom) in ``mode`` (the rule does not depend on it), for 16-byte
    aligned tensors of ``itemsize``-byte elements.

    A band is rows of one sample (the forward's output rows, the backward's
    input rows), whose output is one contiguous span, one CTA each.  Its row
    count is a multiple of ``16 / gcd(row bytes, 16)``, so that every band
    starts on 16 bytes (conv0's 840-byte output rows: an even count), where
    the sample's rows allow it (``store16``)."""
    n, c, h, w = (int(s) for s in shape)
    left, right, top, bottom = pads
    ho, wo = h + top + bottom, w + left + right
    pixel = c * itemsize
    # (the forward's source table takes 4 bytes a word of an output row, at
    # most 2 * wo * pixel bytes: 2-byte words, whatever the alignment)
    if pixel % 16 == 0 or (
            backward and n * ho * wo * pixel < BAND_BWD_MIN_BYTES) or (
            not backward and 2 * wo * pixel > TABLE_BYTES_MAX):
        return WORDS
    length = h if backward else ho  # the rows banded
    row = (w if backward else wo) * pixel  # bytes of a row of the output
    step = 16 // math.gcd(row, 16)
    store16 = length * row % 16 == 0
    if not store16:
        step = 1
    threads = 2 * BAND_THREADS if not backward and _word(pixel) == 2 \
        else BAND_THREADS
    most = BAND_BWD_ELEMENTS // (w * c) if backward \
        else BAND_BYTES_PER_THREAD * threads // row
    rows = max(step, most // step * step)
    while rows > step and n * -(-length // rows) < 2 * sms:
        rows -= step
    return PadPlan(rows, threads, -(-length // rows), store16)


_count_lock = threading.Lock()


def _check(x: torch.Tensor, pads: Sequence[int], mode: str) -> Tuple[int, ...]:
    """``pads`` as ``(left, right, top, bottom)``, checked as ``F.pad``
    checks them for these modes."""
    if mode not in MODES:
        raise ValueError("mode must be one of %s, got %r" % (sorted(MODES),
                                                             mode))
    if x.dim() != 4:
        raise ValueError("x must be NCHW, got shape %r" % (tuple(x.shape),))
    pads = tuple(int(p) for p in pads)
    if len(pads) != 4 or min(pads) < 0:
        raise ValueError("pads must be four widths >= 0 (left, right, top, "
                         "bottom), got %r" % (pads,))
    h, w = x.shape[2], x.shape[3]
    if mode == "reflect" and (max(pads[:2]) >= w or max(pads[2:]) >= h):
        raise ValueError("reflection pads %r must be smaller than the input's "
                         "(H, W) = (%d, %d)" % (pads, h, w))
    return pads


def pad2d_plain(x: torch.Tensor, pads: Sequence[int],
                mode: str) -> torch.Tensor:
    """Plain PyTorch version of the forward: ``F.pad``."""
    return F.pad(x, tuple(pads), mode=mode)


def pad2d_bwd_plain(dy: torch.Tensor, shape, pads: Sequence[int],
                    mode: str) -> torch.Tensor:
    """Plain PyTorch version of the backward: the gradient of
    :func:`pad2d_plain` at an input of ``shape`` for the cotangent ``dy``
    (on the card by ``F.pad``'s own backward, with its atomics)."""
    x = torch.zeros(shape, dtype=dy.dtype, device=dy.device,
                    requires_grad=True)
    with torch.enable_grad():
        y = pad2d_plain(x, pads, mode)
    return torch.autograd.grad(y, x, dy)[0]


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    if t.is_contiguous(memory_format=torch.channels_last):
        return t
    with _count_lock:
        pad2d.copies += 1
    return t.contiguous(memory_format=torch.channels_last)


def _launchable(t: torch.Tensor, what: str) -> torch.Tensor:
    if not t.is_cuda:
        raise RuntimeError("the pad %s kernel needs a CUDA tensor, got one on "
                           "%s" % (what, t.device))
    if t.dtype not in _DTYPE_CODE:
        raise TypeError("the pad kernels take float32 or bfloat16, got %s"
                        % t.dtype)
    if t.numel() >= 2 ** 31:
        raise ValueError("the pad kernels take fewer than 2**31 elements, got "
                         "%r" % (tuple(t.shape),))
    return _channels_last(t)


def _count(wrapper, shape, pads, mode, dtype, kernel: str) -> None:
    key = tuple(shape) + (tuple(pads), mode, str(dtype).split(".")[-1])
    with _count_lock:
        wrapper.launches += 1
        wrapper.launches_by_shape[key] = \
            wrapper.launches_by_shape.get(key, 0) + 1
        wrapper.launches_by_kernel[kernel] += 1


def _call(fn_name: str, src: torch.Tensor, dst: torch.Tensor, shape,
          code: int, pads, mode: str) -> str:
    """Launch ``fn_name`` (forward or backward, by the name's end) at an
    input of ``shape`` under :func:`pad_plan`'s geometry; returns which
    kernel it launched, ``"band"`` or ``"words"``."""
    from .instance_norm import _sm_count

    n, c, h, w = shape
    left, right, top, bottom = pads
    plan = pad_plan(tuple(shape), tuple(pads), mode, src.element_size(),
                    fn_name.endswith("bwd"), _sm_count(src.device.index))
    with torch.cuda.device(src.device):
        err = _c_function(KERNEL_NAME, fn_name, _ARGTYPES)(
            src.data_ptr(), dst.data_ptr(), n, h, w, c, code, top, bottom,
            left, right, MODES[mode], plan.rows, plan.threads,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("%s launch failed with cudaError %d for an input "
                           "of %r %s, pads %r, %s, %r"
                           % (fn_name, err, tuple(shape), src.dtype, pads,
                              mode, plan))
    return "band" if plan.rows else "words"


def _launch(x: torch.Tensor, pads, mode: str) -> torch.Tensor:
    """Launch the forward kernel on x's device and current stream."""
    x = _launchable(x, "forward")
    n, c, h, w = x.shape
    left, right, top, bottom = pads
    y = torch.empty((n, c, h + top + bottom, w + left + right),
                    dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    kernel = _call("pad2d_fwd", x, y, x.shape, x.element_size(), pads, mode)
    _count(pad2d, x.shape, pads, mode, x.dtype, kernel)
    return y


def pad2d_bwd(dy: torch.Tensor, shape, pads: Sequence[int],
              mode: str) -> torch.Tensor:
    """Backward of :func:`pad2d` at an input of ``shape`` (N, C, H, W) for
    the cotangent ``dy`` of its output.  A CUDA tensor goes to the kernel
    (``pad2d_bwd.launches`` counts it), a CPU tensor to
    :func:`pad2d_bwd_plain`."""
    shape = tuple(int(s) for s in shape)
    pads = tuple(int(p) for p in pads)
    if not dy.is_cuda:
        return pad2d_bwd_plain(dy, shape, pads, mode)
    dy = _launchable(dy, "backward")
    n, c, h, w = shape
    left, right, top, bottom = pads
    if tuple(dy.shape) != (n, c, h + top + bottom, w + left + right):
        raise ValueError("dy %r is not the output of an input %r padded by %r"
                         % (tuple(dy.shape), shape, pads))
    dx = torch.empty(shape, dtype=dy.dtype, device=dy.device,
                     memory_format=torch.channels_last)
    kernel = _call("pad2d_bwd", dy, dx, shape, _DTYPE_CODE[dy.dtype], pads,
                   mode)
    _count(pad2d_bwd, shape, pads, mode, dy.dtype, kernel)
    return dx


pad2d_bwd.launches = 0
pad2d_bwd.launches_by_shape = {}
pad2d_bwd.launches_by_kernel = {"band": 0, "words": 0}


class _Pad(torch.autograd.Function):
    """Binds the two kernels: the backward needs only the input's shape."""

    @staticmethod
    def forward(ctx, x, pads, mode):
        ctx.shape, ctx.pads, ctx.mode = tuple(x.shape), pads, mode
        return _launch(x, pads, mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        return pad2d_bwd(dy, ctx.shape, ctx.pads, ctx.mode), None, None


def pad2d(x: torch.Tensor, pads: Sequence[int], mode: str) -> torch.Tensor:
    """``F.pad(x, pads, mode=mode)`` of an NCHW ``x`` for ``mode``
    ``"reflect"`` or ``"replicate"``, ``pads`` = ``(left, right, top,
    bottom)``.  A CUDA tensor goes to the kernels (the output in
    ``channels_last`` memory; differentiable, the backward by
    :func:`pad2d_bwd`), a CPU tensor to :func:`pad2d_plain`."""
    pads = _check(x, pads, mode)
    if not x.is_cuda:
        return pad2d_plain(x, pads, mode)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Pad.apply(x, pads, mode)
    return _launch(x, pads, mode)


pad2d.launches = 0
pad2d.launches_by_shape = {}
pad2d.launches_by_kernel = {"band": 0, "words": 0}
pad2d.copies = 0

WRAPPERS = (pad2d, pad2d_bwd)


def reset_counts() -> None:
    """Every count of both wrappers to 0."""
    with _count_lock:
        for wrapper in WRAPPERS:
            wrapper.launches = 0
            wrapper.launches_by_shape = {}
            wrapper.launches_by_kernel = {"band": 0, "words": 0}
        pad2d.copies = 0

