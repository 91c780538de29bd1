"""Images sliced by rows over a space axis (``--spatial``): the row scope
of a network, the halo exchange and the convolutions over it.

Under a space axis of S ranks (``parallel/mesh.py``) every image is held
by rows: rank r has rows ``[r*h, (r+1)*h)`` of each sample, ``h = H / S``.
A network marks its image path with :func:`image_rows`: inside, its
activations are this rank's rows of the global image (:func:`rows_axis`
returns the space axis, kept in the step's scope,
``multihost.sharded``) until :func:`gather_rows` makes them whole.  The
layers read it: convolutions exchange halo rows or, where their output rows
would not split evenly over the ranks, gather first
(:func:`conv2d_layer`, :func:`conv_transpose2d_layer`); instance norms
take their split forms, batch norms reduce over ``data x space``
(``nn/norms.py``); dropout masks are sliced by rows (``nn/layers.py``).

The gather's backward sums the gradient each space rank computed for the
whole map (each rank differentiates its own loss, in which a term computed
after the gather appears whole) and keeps this rank's rows, so the gradient
averaged over the space ranks is one process's.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.convs import conv_transpose2d_torch
from ..ops.kernels.pad import pad2d
from . import multihost
from .multihost import Axis


# ---------------------------------------------------------------------------
# the row scope of a network
# ---------------------------------------------------------------------------

def space_axis() -> Optional[Axis]:
    """The space axis of the step's mesh, or None without one."""
    mesh = multihost.shard_info()
    if mesh is None or mesh.space.size == 1:
        return None
    return mesh.space


@contextlib.contextmanager
def image_rows(sliced: bool = True):
    """A network's scope: its input image is sliced by rows over the space
    axis, if there is one (``sliced=False``: a network of vectors, the same
    on every space rank)."""
    scope = multihost.scope()
    prev = scope.rows
    scope.rows = space_axis() if sliced else None
    try:
        yield
    finally:
        scope.rows = prev


def rows_axis() -> Optional[Axis]:
    """The space axis while the activation is this rank's rows, else
    None."""
    return multihost.scope().rows


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """All of H of an NCHW activation sliced by rows, on every space rank
    (differentiable); the rest of the network's scope computes it whole.
    The identity where the activation is whole already."""
    scope = multihost.scope()
    axis = scope.rows
    if axis is None:
        return x
    scope.rows = None
    # gathered as NHWC (the channels_last memory of the networks' NCHW)
    y = multihost.gather_dim(x.permute(0, 2, 3, 1), axis, 1, summed=True)
    return y.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# convolution layers
# ---------------------------------------------------------------------------

_MODES = {"zero": "zeros", "zeros": "zeros", "reflect": "reflect",
          "replicate": "replicate"}


def conv2d_layer(x: torch.Tensor, w: torch.Tensor, b, stride: int = 1,
                 padding: int = 0, pre_pad: int = 0,
                 pad_mode: str = "zeros") -> torch.Tensor:
    """A convolution layer's arithmetic: ``pre_pad`` rows and columns of
    ``pad_mode`` padding (``reflect``, ``replicate`` or ``zero``) in front of
    ``F.conv2d(x, w, b, stride, padding)``.  Under a space axis
    (:func:`rows_axis`) the activation is this rank's rows: the
    halo rows come from the neighbours, or, where the output rows would not
    split evenly, all of H is gathered first and the rest of the network
    computes it whole."""
    mode = _MODES[pad_mode]
    axis = rows_axis()
    if axis is not None:
        pad, m = (pre_pad, mode) if pre_pad else (padding, "zeros")
        y = halo_conv2d(x, w, b, axis, stride, pad, m)
        if y is not None:
            return y
        x = gather_rows(x)
    if pre_pad:
        if mode == "zeros":
            return F.conv2d(x, w, b, stride=stride, padding=pre_pad)
        x = pad2d(x, (pre_pad,) * 4, mode)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def conv_transpose2d_layer(x: torch.Tensor, w: torch.Tensor, b,
                           stride: int, padding: int,
                           output_padding: int) -> torch.Tensor:
    """``ops.convs.conv_transpose2d_torch``, at this rank's output rows
    under a space axis (as :func:`conv2d_layer`)."""
    axis = rows_axis()
    if axis is not None:
        y = halo_conv_transpose2d(x, w, b, axis, stride, padding,
                                  output_padding)
        if y is not None:
            return y
        x = gather_rows(x)
    return conv_transpose2d_torch(x, w, b, stride, padding,
                                  output_padding)


# ---------------------------------------------------------------------------
# An activation sliced by rows over a space axis (``--spatial``): halo rows
# ---------------------------------------------------------------------------
#
# Under a space axis of S ranks an NCHW activation of H rows is held as S
# equal slices of h = H / S rows, rank r holding rows [r*h, (r+1)*h).  A
# convolution whose output rows split the same way (H_out / S rows a rank,
# each rank's block of output rows made from its own block of input rows
# and a few rows on either side) computes its rows from this rank's slice
# and the "halo" rows its neighbours send it: `top` rows from the rank
# above, `bottom` from the rank below.  Padding (zero, reflection or
# replication) applies only at the global top and bottom rows; along W every
# rank has the whole row.  Each rank receives exactly the rows its output
# rows need, and the backward sends their gradients back to the owners.


class _Halo(torch.autograd.Function):
    """Rows of the neighbours: ``(above, below)``, the last ``top`` rows of
    the previous rank's slice and the first ``bottom`` rows of the next
    one's (empty at the global edges).  Backward: each halo's gradient goes
    back to the rank that sent the rows and is added to their gradient."""

    @staticmethod
    def forward(ctx, x, axis, top, bottom):
        r, S = axis.index, axis.size
        n, c, h, w = x.shape
        ctx.axis, ctx.top, ctx.bottom, ctx.shape = axis, top, bottom, x.shape
        above = x.new_empty((n, c, top if r > 0 else 0, w))
        below = x.new_empty((n, c, bottom if r < S - 1 else 0, w))
        sends, recvs = {}, {}
        if r > 0:
            if top:
                recvs[r - 1] = above
            if bottom:
                sends[r - 1] = x[:, :, :bottom]
        if r < S - 1:
            if bottom:
                recvs[r + 1] = below
            if top:
                sends[r + 1] = x[:, :, h - top:]
        multihost.exchange(sends, recvs, axis)
        return above, below

    @staticmethod
    def backward(ctx, g_above, g_below):
        axis, top, bottom = ctx.axis, ctx.top, ctx.bottom
        r, S = axis.index, axis.size
        n, c, h, w = ctx.shape
        like = g_above if g_above is not None else g_below
        dx = like.new_zeros((n, c, h, w))
        sends, recvs = {}, {}
        first = last = None
        if r > 0:
            if top:
                sends[r - 1] = (g_above if g_above is not None
                                else like.new_zeros((n, c, top, w)))
            if bottom:
                first = recvs[r - 1] = like.new_empty((n, c, bottom, w))
        if r < S - 1:
            if bottom:
                sends[r + 1] = (g_below if g_below is not None
                                else like.new_zeros((n, c, bottom, w)))
            if top:
                last = recvs[r + 1] = like.new_empty((n, c, top, w))
        multihost.exchange(sends, recvs, axis)
        if first is not None:
            dx[:, :, :bottom] += first
        if last is not None:
            dx[:, :, h - top:] += last
        return dx, None, None, None


def _edge_rows(x: torch.Tensor, n_rows: int, mode: str, top: bool):
    """The padding rows beyond the global top (or bottom) edge of the slice
    holding it, as ``F.pad`` would add them."""
    if n_rows == 0:
        return x[:, :, :0]
    h = x.shape[2]
    if mode == "reflect":
        rows = x[:, :, 1:n_rows + 1] if top else x[:, :, h - 1 - n_rows:h - 1]
        return rows.flip(2)
    if mode == "replicate":
        row = x[:, :, :1] if top else x[:, :, h - 1:]
        return row.expand(-1, -1, n_rows, -1)
    return x.new_zeros((x.shape[0], x.shape[1], n_rows, x.shape[3]))


def halo_rows(x: torch.Tensor, axis, top: int, bottom: int, mode: str):
    """This rank's slice extended by ``top`` rows above and ``bottom``
    below: the neighbours' rows, or padding at the global edges."""
    above, below = _Halo.apply(x, axis, top, bottom)
    if axis.index == 0:
        above = _edge_rows(x, top, mode, True)
    if axis.index == axis.size - 1:
        below = _edge_rows(x, bottom, mode, False)
    return torch.cat([above, x, below], dim=2)


def halo_geometry(h: int, S: int, k: int, s: int, p: int, transposed=False,
                  output_padding: int = 0):
    """``(top, bottom)`` halo rows for a (transposed) convolution of kernel
    ``k``, stride ``s``, padding ``p`` over S slices of ``h`` rows, or None
    where its output rows do not split into S blocks that each come from
    one input block and rows of its two neighbours."""
    H = h * S
    if transposed:
        H_out = (H - 1) * s - 2 * p + k + output_padding
        if H_out != H * s:
            return None
        top, bottom = max(0, (k - 1 - p) // s), (p - 1) // s + 1
    else:
        H_out = (H + 2 * p - k) // s + 1
        if H_out % S != 0 or (H_out // S) * s != h:
            return None
        top, bottom = p, k - s - p
    if top > h - 1 or bottom > h - 1 or bottom < 0:
        return None
    return top, bottom


def halo_conv2d(x, weight, bias, axis, stride: int, pad: int, mode: str):
    """``F.conv2d`` of the global activation, padded by ``pad`` (``mode``:
    ``zeros``, ``reflect`` or ``replicate``), at this rank's output rows;
    None where :func:`halo_geometry` refuses the geometry."""
    geo = halo_geometry(x.shape[2], axis.size, weight.shape[2], stride, pad)
    if geo is None:
        return None
    return conv_rows(halo_rows(x, axis, geo[0], geo[1], mode), weight, bias,
                     stride, pad, mode)


def conv_rows(ext, weight, bias, stride: int, pad: int, mode: str):
    """The convolution of a slice extended by its halo rows: padding along
    W only (the rows beyond the global edges are in ``ext`` already)."""
    if mode == "zeros":
        return F.conv2d(ext, weight, bias, stride=stride, padding=(0, pad))
    ext = pad2d(ext, (pad, pad, 0, 0), mode)
    return F.conv2d(ext, weight, bias, stride=stride)


def halo_conv_transpose2d(x, weight, bias, axis, stride: int, padding: int,
                          output_padding: int):
    """``ops.convs.conv_transpose2d_torch`` of the global activation at
    this rank's output rows (rows ``[r*h*s, (r+1)*h*s)``); None where the
    geometry does not split."""
    h, k = x.shape[2], weight.shape[2]
    geo = halo_geometry(h, axis.size, k, stride, padding, True,
                        output_padding)
    if geo is None:
        return None
    top, bottom = geo
    # missing rows beyond the global edges add nothing: zeros
    ext = halo_rows(x, axis, top, bottom, "zeros")
    return conv_transpose_rows(ext, weight, bias, stride, padding,
                               output_padding, top, h)


def conv_transpose_rows(ext, weight, bias, stride: int, padding: int,
                        output_padding: int, top: int, h: int):
    """The transposed convolution of a slice of ``h`` rows extended by
    ``top`` halo rows above (and its rows below), cropped to the slice's
    ``h * stride`` output rows."""
    full = F.conv_transpose2d(ext, weight, bias, stride=stride,
                              padding=(0, padding),
                              output_padding=(0, output_padding))
    first = padding + top * stride
    return full[:, :, first:first + h * stride]
