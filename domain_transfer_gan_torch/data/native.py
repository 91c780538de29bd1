"""ctypes bindings for the native (C++) host reader, ``csrc/npz_loader.cc``:
.npz/.npy reads (ZIP and npy parsing, zlib inflate, conversion to float32)
and the bundles' normalization, threaded over samples.

The source is compiled at first use with ``g++ -O3 -shared -fPIC ... -lz``
into the build directory of the CUDA kernels (``ops/kernels/build.py::
build_dir``, ``build/`` at the repository root) as
``npz_loader-<hash>.so``, the hash covering the source, the flags and the
host's architecture; an unchanged source is reused.  Nothing is built at
import time.

This is a host tier that gives the same arrays as numpy, so a failed build
is not an error: every caller falls back to its numpy path, as the JAX
package's reader does.  The fallback is visible, though:
:func:`native_available` says whether the library loaded and
:func:`build_error` why it did not (the compiler's output, or None).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

from ..ops.kernels.build import build_dir

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "npz_loader.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-lz", "-lpthread")

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_ERROR: Optional[str] = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS + (platform.machine(),))
                       .encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir(), "npz_loader-%s.so" % h.hexdigest()[:16])


def _build() -> str:
    """Compile the source unless its library is there; returns its path or
    raises ``RuntimeError`` with the compiler's output."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH")
    os.makedirs(build_dir(), exist_ok=True)
    tmp = "%s.tmp%d.%d" % (lib, os.getpid(), threading.get_ident())
    cmd = [cxx, *CXX_FLAGS, _SRC, "-o", tmp, *LIBS]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=300)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError("%s failed:\n%s" % (" ".join(cmd), proc.stdout))
    os.replace(tmp, lib)  # atomic: a reader never sees half a file
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p, i64, i64p = (ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                       ctypes.POINTER(ctypes.c_int64))
    lib.npz_read_f32_ex.restype = ctypes.c_int
    lib.npz_read_f32_ex.argtypes = [ctypes.c_char_p, ctypes.c_char_p, f32p,
                                    i64, i64p, ctypes.POINTER(ctypes.c_char)]
    lib.npz_load_batch_f32.restype = ctypes.c_int
    lib.npz_load_batch_f32.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), i64, ctypes.c_char_p, f32p, i64,
        i64, i64, ctypes.c_int, ctypes.c_int]
    lib.batch_normalize_f32.restype = None
    lib.batch_normalize_f32.argtypes = [f32p, i64, i64, i64, ctypes.c_int]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built if need be; None (and :func:`build_error`
    set) when it cannot be built or loaded.  Tried once per process."""
    global _LIB, _TRIED, _ERROR
    with _lock:
        if not _TRIED:
            _TRIED = True
            try:
                _LIB = _bind(ctypes.CDLL(_build()))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _ERROR = str(e)
        return _LIB


def native_available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the native reader is not in use (None when it is, or before the
    first :func:`get_lib`)."""
    return _ERROR


def reader_name() -> str:
    """'native' or 'numpy (<first line of the reason>)': what the loaders
    read with in this process, for a log line."""
    if native_available():
        return "native"
    return "numpy (%s)" % (build_error() or "").strip().splitlines()[0]


def read_npz_f32(path: str, member: str = "data", return_kind: bool = False):
    """One npz member (or a bare .npy) as float32 through the native reader;
    with ``return_kind`` also the source dtype's kind ('f', 'i', 'u', 'b'),
    so that a caller keeps integer-image scaling (uint8 -> /255).  None (or
    (None, None)) when the library is missing or the file is malformed."""
    lib = get_lib()
    fail = (None, None) if return_kind else None
    if lib is None:
        return fail
    shape = (ctypes.c_int64 * 8)()
    kind = ctypes.c_char(b"f")
    ndim = lib.npz_read_f32_ex(path.encode(), member.encode(), None, 0, shape,
                               ctypes.byref(kind))
    if ndim < 0:
        return fail
    out = np.empty(tuple(shape[i] for i in range(ndim)), dtype=np.float32)
    if lib.npz_read_f32_ex(path.encode(), member.encode(),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           out.size, shape, ctypes.byref(kind)) < 0:
        return fail
    return (out, kind.value.decode()) if return_kind else out


def load_batch_f32(paths: Sequence[str], h: int, w: int, c: int,
                   member: str = "data", normalize: bool = True,
                   n_threads: int = 0) -> Optional[np.ndarray]:
    """Threaded read of same-shaped per-file samples into (n, h, w, c), each
    optionally normalized; None on any failure."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, h, w, c), dtype=np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.npz_load_batch_f32(
        arr, n, member.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, c,
        int(normalize), n_threads)
    return out if rc == 0 else None


def normalize_batch_inplace(arr: np.ndarray, n_threads: int = 0) -> bool:
    """The bundles' normalization of a C-contiguous float32 NHWC batch, in
    place; False (and ``arr`` untouched) without the library."""
    lib = get_lib()
    if lib is None or arr.dtype != np.float32 or arr.ndim != 4 \
            or not arr.flags.c_contiguous:
        return False
    n, h, w, c = arr.shape
    lib.batch_normalize_f32(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            n, h * w, c, n_threads)
    return True
