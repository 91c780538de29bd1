"""Fused instance norm (+affine, +ReLU): the Hopper kernel's wrapper and its
plain PyTorch version.

``instance_norm_fused`` is the port's counterpart of
``domain_transfer_gan_tpu/ops/pallas/instance_norm.py::instance_norm_pallas``
(forward only for now).  On a CUDA tensor it launches the hand-written kernel
of ``csrc/instance_norm.cu`` or raises; on a CPU tensor it computes the plain
version.  There is no fallback from one to the other.  Unlike the TPU kernel,
which refuses blocks that do not fit its on-chip memory, the CUDA kernel loops
over the spatial extent and takes every ``HW`` and ``C``.

The backward kernel comes with the training slice; until then a call that
would need a gradient on the card raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from . import build

KERNEL_NAME = "instance_norm"

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


def _c_function():
    fn = build.load_library(KERNEL_NAME).instance_norm_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, scale: Optional[torch.Tensor],
            shift: Optional[torch.Tensor], eps: float, unbiased: bool,
            relu: bool):
    """Launch the CUDA kernel on x's device and current stream.  Raises when
    x is not a contiguous CUDA tensor or the launch is refused."""
    if not x.is_cuda:
        raise RuntimeError("the instance-norm kernel needs a CUDA tensor, "
                           "got one on %s" % x.device)
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor (strides %r for "
                         "shape %r)" % (x.stride(), tuple(x.shape)))
    n, h, w, c = x.shape
    hw = h * w
    if max(n, hw, c) >= 2 ** 31:
        raise ValueError("a dimension of x exceeds int32: %r"
                         % (tuple(x.shape),))
    if scale is None:
        scale_ptr = shift_ptr = None
        affine_stride = 0
    else:
        # no-ops for the fp32 parameters and maps the norm modules pass
        scale = scale.to(torch.float32).contiguous()
        shift = shift.to(torch.float32).contiguous()
        scale_ptr, shift_ptr = scale.data_ptr(), shift.data_ptr()
        affine_stride = c if scale.dim() == 2 else 0
    y = torch.empty_like(x)
    mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty((n, c), dtype=torch.float32, device=x.device)
    aligned = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    vec, tx = launch_geometry(n, c, x.element_size(), aligned,
                              _sm_count(x.device.index))
    fn = _c_function()
    # the kernel must be launched with x's device current
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), scale_ptr, shift_ptr, y.data_ptr(),
                 mean.data_ptr(), rstd.data_ptr(), n, hw, c, affine_stride,
                 _DTYPE_CODE[x.dtype], vec, tx, float(eps), int(unbiased),
                 int(relu), stream)
    if err != 0:
        raise RuntimeError(
            "instance_norm_fwd launch failed with cudaError %d for x %r %s, "
            "vec=%d tx=%d" % (err, tuple(x.shape), x.dtype, vec, tx))
    with _count_lock:
        instance_norm_fused.launches += 1
        by_shape = instance_norm_fused.launches_by_shape
        by_shape[(n, hw, c)] = by_shape.get((n, hw, c), 0) + 1
    return y, mean, rstd


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
    tensor to :func:`instance_norm_plain`.
    """
    _check_x(x)
    if not x.is_cuda:
        return instance_norm_plain(x, scale, shift, eps=eps,
                                   unbiased=unbiased, relu=relu,
                                   return_stats=return_stats)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, scale, shift)):
        raise NotImplementedError(
            "instance_norm_fused has no backward on CUDA yet: the backward "
            "kernel (the TPU package's _bwd_kernel) is ported with the "
            "training slice; call under torch.inference_mode() or "
            "torch.no_grad()")
    n, _, _, c = x.shape
    _check_affine(scale, shift, n, c, x.device)
    y, mean, rstd = _launch(x, scale, shift, eps, unbiased, relu)
    if return_stats:
        return y, mean, rstd
    return y


instance_norm_fused.launches = 0
instance_norm_fused.launches_by_shape = {}
