"""Zstandard frames decoded by the system's ``libzstd``, bound with ctypes.

orbax compresses every node of its OCDBT key-value store and every zarr
chunk with zstd.  This module is the port's one route to those bytes: the
shared library ``libzstd.so.1`` that the C library's package installs
(``ldconfig -p | grep zstd``), never a Python package.  Where the library
cannot be loaded, :func:`decompress` raises :class:`ZstdMissingError`.

``decompress(src, size=None, limit=...)`` decodes every frame in ``src``:

- with ``size``, the output must be exactly ``size`` bytes (a zarr chunk,
  whose size its shape gives);
- else with the size the frame header records, where it records one;
- else (orbax's OCDBT nodes carry none) through the streaming decoder, the
  output held to ``limit`` bytes.

Errors name the decoder's own message (``ZSTD_getErrorName``).
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

LIBRARY = "libzstd.so.1"
CONTENTSIZE_UNKNOWN = 2 ** 64 - 1
CONTENTSIZE_ERROR = 2 ** 64 - 2

_lib = None


class ZstdMissingError(ImportError):
    """The orbax checkpoint format needs the system's ``libzstd``."""


class ZstdError(ValueError):
    """Bytes that do not decode as zstd frames of the expected size."""


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _libzstd():
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("zstd") or LIBRARY
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        raise ZstdMissingError(
            "reading an orbax checkpoint needs the zstd library %s, which "
            "cannot be loaded here (%s)" % (LIBRARY, e)) from e
    size_t, ptr = ctypes.c_size_t, ctypes.c_void_p
    for fn, res, args in (
            ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [ptr, size_t]),
            ("ZSTD_decompress", size_t, [ptr, size_t, ptr, size_t]),
            ("ZSTD_isError", ctypes.c_uint, [size_t]),
            ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
            ("ZSTD_createDStream", ptr, []),
            ("ZSTD_freeDStream", size_t, [ptr]),
            ("ZSTD_initDStream", size_t, [ptr]),
            ("ZSTD_DStreamOutSize", size_t, []),
            ("ZSTD_decompressStream", size_t,
             [ptr, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)])):
        f = getattr(lib, fn)
        f.restype, f.argtypes = res, args
    _lib = lib
    return lib


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ZstdError("%s: %s" % (
            what, lib.ZSTD_getErrorName(code).decode("ascii", "replace")))
    return code


def _stream(lib, src: bytes, limit: int) -> bytes:
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("ZSTD_createDStream")
    try:
        _check(lib, lib.ZSTD_initDStream(stream), "zstd stream")
        step = lib.ZSTD_DStreamOutSize()
        inp = _InBuffer(ctypes.cast(ctypes.c_char_p(src), ctypes.c_void_p),
                        len(src), 0)
        pieces, total, pending = [], 0, 1
        while inp.pos < inp.size or pending:
            buf = ctypes.create_string_buffer(step)
            out = _OutBuffer(ctypes.addressof(buf), step, 0)
            before = inp.pos
            pending = _check(lib, lib.ZSTD_decompressStream(
                stream, ctypes.byref(out), ctypes.byref(inp)),
                "zstd stream")
            total += out.pos
            if total > limit:
                raise ZstdError("a zstd frame decodes to over %d bytes"
                                % limit)
            pieces.append(buf.raw[:out.pos])
            if pending and inp.pos == before and out.pos == 0:
                raise ZstdError("a truncated zstd frame")
        return b"".join(pieces)
    finally:
        lib.ZSTD_freeDStream(stream)


def decompress(src: bytes, size: int = None, limit: int = 1 << 31):
    """The bytes the zstd frames in ``src`` hold (a ``bytes`` object, or
    with ``size`` a uint8 numpy array of exactly ``size`` bytes)."""
    lib = _libzstd()
    src = bytes(src)
    if size is None:
        content = lib.ZSTD_getFrameContentSize(src, len(src))
        if content == CONTENTSIZE_ERROR:
            raise ZstdError("not a zstd frame")
        if content == CONTENTSIZE_UNKNOWN:
            return _stream(lib, src, limit)
        if content > limit:
            raise ZstdError("a zstd frame of %d bytes, over %d"
                            % (content, limit))
        return decompress(src, int(content), limit).tobytes()
    out = np.empty(size, np.uint8)
    got = _check(lib, lib.ZSTD_decompress(
        out.ctypes.data, size, src, len(src)), "zstd")
    if got != size:
        raise ZstdError("zstd frames of %d bytes where %d were expected"
                        % (got, size))
    return out
