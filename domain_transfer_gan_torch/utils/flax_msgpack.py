"""The port's own reader and writer of flax's msgpack checkpoint format.

The JAX package writes its checkpoints with
``flax.serialization.to_bytes(payload)``: a msgpack map of string keys whose
leaves are

- an array: ``ExtType(1, packb((shape, dtype_name, raw C-order bytes)))``;
- a numpy scalar (``np.float64`` ``old_lr``, ``np.int64`` ``epoch``):
  ``ExtType(3, ...)``, the same bytes of a 0-d array;
- an array over 2**30 bytes: a dict ``{"__msgpack_chunked_array__": True,
  "shape": {"0": ...}, "chunks": {"0": flat piece, ...}}``;
- a Python complex: ``ExtType(2, ...)``, refused here by name (no
  checkpoint of the package holds one).

Tuples and lists are stored as dicts keyed ``"0"``, ``"1"``, ...; an optax
``ScaleByAdamState`` as the dict ``{"count", "mu", "nu"}``.  This module
needs ``msgpack`` and numpy only (never flax or JAX); where ``msgpack`` is
missing both directions raise :class:`MsgpackMissingError`.

``read_flax(data)`` gives nested dicts of numpy arrays (scalars as numpy
scalars); ``write_flax(tree)`` serialises nested dicts of numpy arrays and
numpy scalars the way ``to_bytes`` does, so
``flax.serialization.msgpack_restore`` reads the bytes back.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30  # flax's limit per leaf, in bytes


class MsgpackMissingError(ImportError):
    """The flax checkpoint format needs the ``msgpack`` module."""


def _msgpack():
    try:
        import msgpack
    except ImportError as e:
        raise MsgpackMissingError(
            "reading or writing the JAX package's flax checkpoints needs the "
            "msgpack module, which cannot be imported here") from e
    return msgpack


def _array_from_bytes(msgpack, data: bytes) -> np.ndarray:
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) \
        else dtype_name
    if name == "bfloat16":
        raise ValueError("a bfloat16 array in a flax checkpoint: numpy has "
                         "no such dtype and the JAX package stores float32")
    dtype = np.dtype(name)
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def _array_to_bytes(msgpack, arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured arrays cannot go into a "
                         "flax checkpoint (dtype %s)" % arr.dtype)
    # C order, whatever the array's own layout
    return msgpack.packb((list(arr.shape), arr.dtype.name,
                          np.ascontiguousarray(arr).tobytes("C")),
                         use_bin_type=True)


def _unchunk(node: Mapping) -> np.ndarray:
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def _restore(node):
    if isinstance(node, dict):
        if CHUNKED in node:
            return _unchunk(node)
        return {k: _restore(v) for k, v in node.items()}
    return node


def read_flax(data: bytes) -> dict:
    """The tree ``flax.serialization.to_bytes`` wrote into ``data``."""
    msgpack = _msgpack()

    def ext_hook(code, payload):
        if code == EXT_NDARRAY:
            return _array_from_bytes(msgpack, payload)
        if code == EXT_NPSCALAR:
            return _array_from_bytes(msgpack, payload)[()]
        if code == EXT_COMPLEX:
            raise ValueError("a complex value in a flax checkpoint: the port "
                             "reads real arrays only")
        raise ValueError("unknown msgpack extension type %d in a flax "
                         "checkpoint" % code)

    return _restore(msgpack.unpackb(data, ext_hook=ext_hook, raw=False,
                                    strict_map_key=False))


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
    flat = np.ascontiguousarray(arr).reshape(-1)
    pieces = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): p for i, p in enumerate(pieces)}}


def _prepare(node):
    if isinstance(node, Mapping):
        return {str(k): _prepare(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return {str(i): _prepare(v) for i, v in enumerate(node)}
    if isinstance(node, np.ndarray) and node.nbytes > MAX_CHUNK_SIZE:
        return _chunk(node)
    return node


def write_flax(tree: Mapping) -> bytes:
    """``tree`` (nested dicts of numpy arrays and numpy scalars; tuples and
    lists become ``"0"``-keyed dicts) in flax's msgpack format."""
    msgpack = _msgpack()

    def default(x):
        if isinstance(x, np.ndarray):
            return msgpack.ExtType(EXT_NDARRAY, _array_to_bytes(msgpack, x))
        if isinstance(x, np.generic):
            return msgpack.ExtType(EXT_NPSCALAR,
                                   _array_to_bytes(msgpack, np.asarray(x)))
        if isinstance(x, complex):
            raise ValueError("complex values are not written to a flax "
                             "checkpoint by the port")
        raise TypeError("cannot write %r to a flax checkpoint" % type(x))

    return msgpack.packb(_prepare(tree), default=default, strict_types=True)


def is_flax_bytes(head: bytes) -> bool:
    """Whether a file's first bytes open a msgpack map (a flax checkpoint),
    as opposed to a ``torch.save`` zip (``PK``)."""
    return bool(head) and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf))
