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
from a kernel to its plain version.  Unlike the TPU kernels, which refuse
blocks that do not fit their on-chip memory, the CUDA kernels loop over the
spatial extent and take every ``HW`` and ``C``.

Each wrapper counts its launches (``instance_norm_fused.launches``,
``instance_norm_bwd_fused.launches``, and the same per ``(N, HW, C)`` in
``launches_by_shape``); ``instance_norm_bwd_fused.dy_copies`` counts the
incoming gradients that had to be copied into NHWC order first.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import build

KERNEL_NAME = "instance_norm"
BWD_KERNEL_NAME = "instance_norm_bwd"

_MIN_SEGMENT_BYTES = 32  # one memory sector: narrowest row segment of a tile

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


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


_P, _I = ctypes.c_void_p, ctypes.c_int
# instance_norm_fwd(x, scale, shift, y, mean, rstd; n, hw, c, affine_stride,
#                   dtype, vec, tx; eps; unbiased, relu; stream)
_FWD_ARGTYPES = [_P] * 6 + [_I] * 7 + [ctypes.c_float, _I, _I, _P]
# instance_norm_bwd(x, dy, mean, rstd, scale, shift, dx, dscale, dshift; n, hw,
#                   c, affine_stride, dtype, vec, tx, unbiased, relu; stream)
_BWD_ARGTYPES = [_P] * 9 + [_I] * 9 + [_P]


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


def _count(wrapper, key) -> None:
    with _count_lock:
        wrapper.launches += 1
        by_shape = wrapper.launches_by_shape
        by_shape[key] = by_shape.get(key, 0) + 1


def _launch(x: torch.Tensor, scale: Optional[torch.Tensor],
            shift: Optional[torch.Tensor], eps: float, unbiased: bool,
            relu: bool):
    """Launch the forward kernel on x's device and current stream.  Raises
    when x is not a contiguous CUDA tensor or the launch is refused."""
    _check_launchable(x, "forward")
    n, h, w, c = x.shape
    hw = h * w
    scale, shift, affine_stride = _affine_pointers(scale, shift, c)
    y = torch.empty_like(x)
    mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty((n, c), dtype=torch.float32, device=x.device)
    aligned = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    vec, tx = launch_geometry(n, c, x.element_size(), aligned,
                              _sm_count(x.device.index))
    fn = _c_function(KERNEL_NAME, "instance_norm_fwd", _FWD_ARGTYPES)
    # the kernel must be launched with x's device current
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), _ptr(scale), _ptr(shift), y.data_ptr(),
                 mean.data_ptr(), rstd.data_ptr(), n, hw, c, affine_stride,
                 _DTYPE_CODE[x.dtype], vec, tx, float(eps), int(unbiased),
                 int(relu), stream)
    if err != 0:
        raise RuntimeError(
            "instance_norm_fwd launch failed with cudaError %d for x %r %s, "
            "vec=%d tx=%d" % (err, tuple(x.shape), x.dtype, vec, tx))
    _count(instance_norm_fused, (n, hw, c))
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
                shift: Optional[torch.Tensor], unbiased: bool, relu: bool):
    """Launch the backward kernel on x's device and current stream.  Raises
    when x or dy is not a contiguous CUDA tensor or the launch is refused."""
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
    dscale = dshift = None
    if scale is not None:
        dscale = torch.empty((n, c), dtype=torch.float32, device=x.device)
        dshift = torch.empty((n, c), dtype=torch.float32, device=x.device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, dx))
    vec, tx = launch_geometry(n, c, x.element_size(), aligned,
                              _sm_count(x.device.index))
    fn = _c_function(BWD_KERNEL_NAME, "instance_norm_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dy.data_ptr(), mean.data_ptr(),
                 rstd.data_ptr(), _ptr(scale), _ptr(shift), dx.data_ptr(),
                 _ptr(dscale), _ptr(dshift), n, hw, c, affine_stride,
                 _DTYPE_CODE[x.dtype], vec, tx, int(unbiased), int(relu),
                 stream)
    if err != 0:
        raise RuntimeError(
            "instance_norm_bwd launch failed with cudaError %d for x %r %s, "
            "vec=%d tx=%d" % (err, tuple(x.shape), x.dtype, vec, tx))
    _count(instance_norm_bwd_fused, (n, hw, c))
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
