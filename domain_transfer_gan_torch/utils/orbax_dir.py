"""The port's reader and writer of orbax checkpoint directories.

The JAX package's ``--ckpt_backend orbax`` saves each checkpoint (``latest``,
``best_A``, ``best_B``) as a directory that orbax's
``StandardCheckpointHandler`` writes.  This module reads and writes such
directories with numpy and the standard library alone (zstd through
``utils/zstd.py``, the system's ``libzstd``), never orbax, tensorstore,
zarr or numcodecs.

What a directory holds:

- ``_METADATA``: JSON, one entry per leaf of the saved tree under its
  stringified key path, ``"('opt_state', 'netD_A', 'count')"``, with the
  path's keys (``key_type`` 2 a dict key, 1 a sequence index) and the
  leaf's ``value_type`` (``jax.Array``, ``np.ndarray``, ``scalar``, or
  ``Dict`` / ``List`` / ``None`` for an empty subtree, which has no data);
  ``"use_ocdbt"`` says how the arrays are stored;
- ``_CHECKPOINT_METADATA``: JSON, the handler's name and timestamps;
- a **zarr v2** array per leaf under its dotted name
  (``params.netG_A_B.conv0.kernel``): ``<name>/.zarray`` (shape, chunks,
  dtype, compressor ``zstd`` or none, C order) and one value per chunk,
  keyed ``0`` for a 0-d array, ``i.j`` for a 2-d one;
- where ``use_ocdbt`` (orbax's default), those keys live in an **OCDBT**
  store (:class:`_Ocdbt`): ``manifest.ocdbt`` at the root (and one per
  writer process under ``ocdbt.process_<i>/``) names the root of a B-tree
  whose nodes, in files under ``d/``, map each key to its value, inline or
  a byte range of a data file; else each key is a file of its own
  (``<name>/.zarray``, ``<name>/0.0``);
- ``_sharding`` and ``array_metadatas/`` (a ``jax.Array`` save's), which
  this module does not need.

``read_orbax(path)`` gives the saved tree as nested dicts (and lists) of
numpy arrays, ``{}`` for an empty subtree; ``orbax_metadata(path)`` the
same tree with :class:`ArrayMeta` leaves (shape and dtype, from the
``.zarray`` files: no chunk is read).  ``write_orbax(path, tree)`` writes
orbax's ``use_ocdbt=False`` layout, each array one uncompressed chunk, and
publishes the directory by renames, so an existing checkpoint of that name
is replaced whole or not at all.  The JAX package's ``OrbaxCheckpointer``
restores what it writes.

Anything this module does not know (an OCDBT format version, a manifest
kind, a zarr dtype, compressor, filter or order) is refused with a
:class:`OrbaxFormatError` that names it, as is a checksum or a length that
does not match.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
import time
from typing import Mapping

import numpy as np

from . import zstd

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
KEY_SEQUENCE, KEY_DICT = 1, 2
EMPTY_VALUES = {"Dict": dict, "List": list, "None": lambda: None}
ARRAY_VALUES = ("jax.Array", "np.ndarray", "scalar")
DTYPES = frozenset(("<f2", "<f4", "<f8", "|i1", "<i2", "<i4", "<i8", "|u1",
                    "<u2", "<u4", "<u8", "|b1"))

MANIFEST_MAGIC, NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
COMPRESSIONS = {0: "none", 1: "zstd"}


class OrbaxFormatError(ValueError):
    """A directory that is not an orbax checkpoint this module reads."""


@dataclasses.dataclass(frozen=True)
class ArrayMeta:
    """A leaf of :func:`orbax_metadata`: what the array on disk holds."""

    shape: tuple
    dtype: np.dtype


# ---------------------------------------------------------------------------
# CRC-32C (Castagnoli), which closes every OCDBT manifest and node
# ---------------------------------------------------------------------------

def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# OCDBT
# ---------------------------------------------------------------------------

class _Bytes:
    """A cursor over a decoded manifest or node."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OrbaxFormatError("%s ends early" % self.what)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise OrbaxFormatError("%s: a varint over 64 bits"
                                       % self.what)

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise OrbaxFormatError("%s: %d bytes left over"
                                   % (self.what, len(self.data) - self.pos))


def _prefixed(cur: _Bytes, n: int, extra: bool = False):
    """``n`` strings stored as OCDBT stores keys and paths: the length each
    shares with the one before, their own lengths (and, for ``extra``, a
    column of ``n`` varints between those and the bytes), then the bytes.
    Returns (the strings, the column or None)."""
    shared = [0] + cur.varints(max(n - 1, 0))
    own = cur.varints(n)
    column = cur.varints(n) if extra else None
    out, prev = [], b""
    for s, o in zip(shared, own):
        if s > len(prev):
            raise OrbaxFormatError("%s: a prefix longer than its key"
                                   % cur.what)
        prev = prev[:s] + cur.take(o)
        out.append(prev)
    return out, column


def _data_files(cur: _Bytes) -> list:
    """The data file table: each file's path relative to its store."""
    n = cur.varint()
    paths, base_lengths = _prefixed(cur, n, extra=True)
    for p, b in zip(paths, base_lengths):
        if b > len(p):
            raise OrbaxFormatError("%s: a base path longer than its path"
                                   % cur.what)
    return [p.decode() for p in paths]


def _unframe(blob: bytes, magic: int, what: str, limit: int) -> bytes:
    """The body of a manifest or node: magic, length, format version and
    compression checked, the CRC-32C at its end verified, zstd undone."""
    if len(blob) < 18:
        raise OrbaxFormatError("%s: %d bytes, too short" % (what, len(blob)))
    got_magic, length = struct.unpack(">I", blob[:4])[0], \
        struct.unpack("<Q", blob[4:12])[0]
    if got_magic != magic:
        raise OrbaxFormatError("%s: magic %08x, not %08x"
                               % (what, got_magic, magic))
    if length != len(blob):
        raise OrbaxFormatError("%s: length field %d, %d bytes"
                               % (what, length, len(blob)))
    crc = struct.unpack("<I", blob[-4:])[0]
    if crc32c(blob[:-4]) != crc:
        raise OrbaxFormatError("%s: CRC-32C mismatch" % what)
    cur = _Bytes(blob[12:-4], what)
    version = cur.varint()
    if version != 0:
        raise OrbaxFormatError("%s: OCDBT format version %d, this reader "
                               "knows version 0" % (what, version))
    method = cur.varint()
    if method not in COMPRESSIONS:
        raise OrbaxFormatError("%s: unknown compression %d" % (what, method))
    body = cur.data[cur.pos:]
    if method == 1:
        try:
            body = zstd.decompress(body, limit=limit)
        except zstd.ZstdError as e:
            raise OrbaxFormatError("%s: %s" % (what, e)) from e
    return body


class _Ocdbt:
    """The keys of an OCDBT store, read from its manifest down the B-tree
    of its newest version: ``entries[key]`` is the value's bytes (inline)
    or ``(file, offset, length)``."""

    def __init__(self, root: str):
        self.root = root
        self.entries = {}
        path = os.path.join(root, "manifest.ocdbt")
        with open(path, "rb") as f:
            body = _unframe(f.read(), MANIFEST_MAGIC, path, 1 << 26)
        cur = _Bytes(body, path)
        cur.take(16)  # the store's uuid
        kind = cur.varint()
        if kind != 0:
            raise OrbaxFormatError("%s: manifest kind %d (numbered "
                                   "manifests) is not read" % (path, kind))
        cur.varint()  # max_inline_value_bytes
        self.node_limit = cur.varint()  # max_decoded_node_bytes
        cur.u8()  # version_tree_arity_log2
        method = cur.varint()
        if method not in COMPRESSIONS:
            raise OrbaxFormatError("%s: unknown compression %d"
                                   % (path, method))
        if method == 1:
            cur.u32()  # the zstd level
        files = _data_files(cur)
        # the newest versions, inline; the older ones' version-tree nodes
        n = cur.varint()
        generation = cur.varints(n)
        height = [cur.u8() for _ in range(n)]
        fid, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
        num_keys = cur.varints(n)
        cur.varints(2 * n)  # tree bytes, indirect value bytes
        cur.take(8 * n)  # commit times
        m = cur.varint()
        for _ in range(5):  # generation, file, offset, length, count
            cur.varints(m)
        cur.take(9 * m)  # commit times, heights
        cur.end()
        if n == 0:
            raise OrbaxFormatError("%s: a store with no version" % path)
        newest = max(range(n), key=generation.__getitem__)
        if num_keys[newest]:
            self._node(self._file(files, fid[newest], path), offset[newest],
                       length[newest], height[newest], b"")

    def _file(self, files, index: int, what: str) -> str:
        if index >= len(files):
            raise OrbaxFormatError("%s: data file %d of %d"
                                   % (what, index, len(files)))
        rel = files[index]
        if os.path.isabs(rel) or ".." in rel.split("/"):
            raise OrbaxFormatError("%s: data file %r outside the store"
                                   % (what, rel))
        return os.path.join(self.root, rel)

    def _node(self, path: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        what = "%s@%d" % (path, offset)
        blob = _read_range(path, offset, length)
        cur = _Bytes(_unframe(blob, NODE_MAGIC, what, self.node_limit), what)
        if cur.u8() != height:
            raise OrbaxFormatError("%s: a node of another height" % what)
        files = _data_files(cur)
        n = cur.varint()
        keys, common = _prefixed(cur, n, extra=height > 0)
        if height > 0:
            fid, off, size = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(3 * n)  # keys, tree bytes, indirect value bytes
            cur.end()
            for i in range(n):
                self._node(self._file(files, fid[i], what), off[i], size[i],
                           height - 1, prefix + keys[i][:common[i]])
            return
        size = cur.varints(n)
        kind = cur.varints(n)
        if set(kind) - {0, 1}:
            raise OrbaxFormatError("%s: unknown value kinds %s"
                                   % (what, sorted(set(kind) - {0, 1})))
        indirect = [i for i in range(n) if kind[i]]
        fid = cur.varints(len(indirect))
        off = cur.varints(len(indirect))
        for i, f, o in zip(indirect, fid, off):
            self.entries[(prefix + keys[i]).decode()] = (
                self._file(files, f, what), o, size[i])
        for i in range(n):
            if not kind[i]:
                self.entries[(prefix + keys[i]).decode()] = cur.take(size[i])
        cur.end()

    def get(self, key: str):
        ref = self.entries.get(key)
        if ref is None or isinstance(ref, bytes):
            return ref
        return _read_range(*ref)


def _read_range(path: str, offset: int, length: int) -> bytes:
    with open(path, "rb") as f:
        f.seek(offset)
        data = f.read(length)
    if len(data) != length:
        raise OrbaxFormatError("%s: %d bytes at %d, %d there"
                               % (path, length, offset, len(data)))
    return data


class _Stores:
    """The OCDBT stores of a checkpoint: the root one, or where the writer
    processes' stores were never merged into it, theirs together."""

    def __init__(self, path: str):
        if os.path.exists(os.path.join(path, "manifest.ocdbt")):
            roots = [path]
        else:
            roots = sorted(
                os.path.join(path, d) for d in os.listdir(path)
                if d.startswith("ocdbt.process_")
                and os.path.exists(os.path.join(path, d, "manifest.ocdbt")))
        if not roots:
            raise OrbaxFormatError("%s: an OCDBT checkpoint with no "
                                   "manifest.ocdbt" % path)
        self.stores = [_Ocdbt(r) for r in roots]

    def get(self, key: str):
        for s in self.stores:
            value = s.get(key)
            if value is not None:
                return value
        return None


class _Files:
    """orbax's ``use_ocdbt=False`` layout: a key is a file."""

    def __init__(self, path: str):
        self.path = path

    def get(self, key: str):
        p = os.path.join(self.path, *key.split("/"))
        if not os.path.isfile(p):
            return None
        with open(p, "rb") as f:
            return f.read()


# ---------------------------------------------------------------------------
# zarr v2
# ---------------------------------------------------------------------------

def _zarray(store, name: str) -> dict:
    raw = store.get(name + "/.zarray")
    if raw is None:
        raise OrbaxFormatError("no array %r in the checkpoint" % name)
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError("%s: zarr format %r, this reader knows 2"
                               % (name, meta.get("zarr_format")))
    if meta.get("dtype") not in DTYPES:
        raise OrbaxFormatError("%s: zarr dtype %r is not read"
                               % (name, meta.get("dtype")))
    if meta.get("filters"):
        raise OrbaxFormatError("%s: zarr filters %r are not read"
                               % (name, meta["filters"]))
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError("%s: zarr compressor %r is not read"
                               % (name, comp.get("id")))
    if meta.get("order", "C") not in ("C", "F"):
        raise OrbaxFormatError("%s: zarr order %r" % (name, meta["order"]))
    if len(meta["chunks"]) != len(meta["shape"]):
        raise OrbaxFormatError("%s: chunks %r for shape %r"
                               % (name, meta["chunks"], meta["shape"]))
    return meta


def _read_array(store, name: str, complete: bool) -> np.ndarray:
    """The array ``name``, assembled from its chunk grid.  A chunk that is
    not stored is the fill value (zarr's rule) unless ``complete`` (the
    writer stored every chunk), where it is refused."""
    meta = _zarray(store, name)
    dtype = np.dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dtype)
    sep = meta.get("dimension_separator", ".")
    nbytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = "%s/%s" % (name, sep.join(map(str, idx)) if idx else "0")
        raw = store.get(key)
        if raw is None:
            if complete:
                raise OrbaxFormatError("%s: chunk %s is missing" % (name, key))
            continue
        try:
            if meta.get("compressor") is None:
                if len(raw) != nbytes:
                    raise OrbaxFormatError(
                        "%s: %d bytes where %d were expected"
                        % (key, len(raw), nbytes))
                buf = np.frombuffer(raw, np.uint8)
            else:
                buf = zstd.decompress(raw, nbytes)
        except zstd.ZstdError as e:
            raise OrbaxFormatError("%s: %s" % (key, e)) from e
        block = buf.view(dtype).reshape(chunks, order=meta.get("order", "C"))
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        out[region] = block[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    return out


def _array_meta(store, name: str) -> ArrayMeta:
    meta = _zarray(store, name)
    return ArrayMeta(tuple(meta["shape"]), np.dtype(meta["dtype"]))


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------

def is_orbax_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, METADATA))


def _open(path: str):
    if not is_orbax_dir(path):
        raise OrbaxFormatError(
            "%s is a directory but not an orbax checkpoint (no %s)"
            % (path, METADATA))
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise OrbaxFormatError("%s: zarr v3 arrays are not read" % path)
    store = _Stores(path) if meta.get("use_ocdbt", True) else _Files(path)
    return meta, store


def _leaves(meta: dict):
    """(keys, value type) of each entry of ``_METADATA``."""
    for entry in meta["tree_metadata"].values():
        keys = []
        for k in entry["key_metadata"]:
            if k["key_type"] not in (KEY_SEQUENCE, KEY_DICT):
                raise OrbaxFormatError("unknown key type %r"
                                       % k["key_type"])
            keys.append(int(k["key"]) if k["key_type"] == KEY_SEQUENCE
                        else str(k["key"]))
        kind = entry["value_metadata"]["value_type"]
        if kind not in EMPTY_VALUES and kind not in ARRAY_VALUES:
            raise OrbaxFormatError("a leaf of value type %r is not read"
                                   % kind)
        yield tuple(keys), kind


def _nest(pairs) -> dict:
    """Nested dicts from (keys, value) pairs; a node whose keys are all
    sequence indices becomes a list."""
    root = {}
    for keys, value in pairs:
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [fix(node[i]) for i in sorted(node)]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _read(path: str, leaf, skip=()) -> dict:
    meta, store = _open(path)
    complete = meta.get("store_array_data_equal_to_fill_value", False)
    pairs = []
    for keys, kind in _leaves(meta):
        if keys[:1] and keys[0] in skip:
            continue
        if kind in EMPTY_VALUES:
            pairs.append((keys, EMPTY_VALUES[kind]()))
            continue
        pairs.append((keys, leaf(store, ".".join(map(str, keys)), kind,
                             complete)))
    return _nest(pairs)


def read_orbax(path: str, skip=()) -> dict:
    """The tree saved in the orbax checkpoint directory ``path``: nested
    dicts (lists where orbax recorded sequence keys) of numpy arrays, the
    ``scalar`` leaves as numpy scalars.  Top-level entries named in
    ``skip`` are not read."""
    def leaf(store, name, kind, complete):
        arr = _read_array(store, name, complete)
        return arr[()] if kind == "scalar" else arr
    return _read(path, leaf, skip)


def orbax_metadata(path: str) -> dict:
    """The tree of :func:`read_orbax` with an :class:`ArrayMeta` for each
    array: read from ``_METADATA`` and the ``.zarray`` files alone."""
    return _read(path, lambda store, name, kind, complete:
                 _array_meta(store, name))


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

def _flatten(node, keys=()):
    """(keys, key types, leaf) of a tree of dicts, lists, tuples and numpy
    values, dict keys in sorted order (as orbax's flattening gives them);
    an empty dict or sequence is a leaf of its own."""
    if isinstance(node, Mapping):
        if not node:
            yield keys, "Dict"
        for k in sorted(node):
            if not isinstance(k, str) or "/" in k or "." in k:
                raise ValueError("the orbax writer takes string keys "
                                 "without '/' or '.', not %r" % (k,))
            yield from _flatten(node[k], keys + ((k, KEY_DICT),))
        return
    if isinstance(node, (list, tuple)):
        if not node:
            yield keys, "List"
        for i, v in enumerate(node):
            yield from _flatten(v, keys + ((str(i), KEY_SEQUENCE),))
        return
    arr = np.asarray(node)
    if arr.dtype.str not in DTYPES:
        raise ValueError("the orbax writer takes numeric arrays, not %s at %r"
                         % (arr.dtype, [k for k, _ in keys]))
    yield keys, arr


def _write_dir(out: str, tree) -> None:
    os.makedirs(out)
    t0 = time.time_ns()
    entries = {}
    for keys, leaf in _flatten(tree):
        if not keys:
            raise ValueError("the orbax writer takes a tree, not a leaf")
        names = tuple(k for k, _ in keys)
        entry = {"key_metadata": [{"key": k, "key_type": t}
                                  for k, t in keys]}
        if isinstance(leaf, str):
            entry["value_metadata"] = {"value_type": leaf,
                                       "skip_deserialize": True}
        else:
            entry["value_metadata"] = {"value_type": "np.ndarray",
                                       "skip_deserialize": False}
            _write_array(os.path.join(out, ".".join(names)), leaf)
        entries[str(names)] = entry
    with open(os.path.join(out, METADATA), "w") as f:
        json.dump({"tree_metadata": entries, "use_ocdbt": False,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    with open(os.path.join(out, CHECKPOINT_METADATA), "w") as f:
        json.dump({"item_handlers": HANDLER, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": t0,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)


def _write_array(directory: str, arr: np.ndarray) -> None:
    os.makedirs(directory)
    meta = {"chunks": [max(d, 1) for d in arr.shape], "compressor": None,
            "dimension_separator": ".", "dtype": arr.dtype.str,
            "fill_value": None, "filters": None, "order": "C",
            "shape": list(arr.shape), "zarr_format": 2}
    with open(os.path.join(directory, ".zarray"), "w") as f:
        json.dump(meta, f, separators=(",", ":"), sort_keys=True)
    if arr.size:
        with open(os.path.join(directory, ".".join("0" * max(arr.ndim, 1))),
                  "wb") as f:
            f.write(arr.tobytes("C"))


def write_orbax(path: str, tree) -> None:
    """Write ``tree`` (nested dicts, lists and tuples of numpy arrays and
    numpy scalars) as an orbax checkpoint directory at ``path``: built
    beside it, then published by renames, so an existing ``path`` is
    replaced only once the new directory is whole."""
    path = os.path.abspath(path)
    stamp = "%d.%d" % (time.time_ns(), os.getpid())
    tmp = "%s.orbax-checkpoint-tmp-%s" % (path, stamp)
    try:
        _write_dir(tmp, tree)
        if os.path.lexists(path):
            old = "%s.orbax-checkpoint-old-%s" % (path, stamp)
            os.rename(path, old)
            os.rename(tmp, path)
            if os.path.isdir(old) and not os.path.islink(old):
                shutil.rmtree(old)
            else:
                os.remove(old)
        else:
            os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise

