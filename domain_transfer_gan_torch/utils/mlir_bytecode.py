"""A reader of MLIR bytecode, the format of a StableHLO portable artifact.

The module inside a ``jax.export`` artifact (``utils/jax_export.py``) is
MLIR bytecode, written as the public "MLIR Bytecode Format" document
(mlir.llvm.org/docs/BytecodeFormat) describes it.  This module reads that
container with the standard library alone, no MLIR binding:

- the header: magic ``ML\\xefR``, the bytecode version (0 to 6 are read),
  the producer string (``StableHLO_v1.13.4``);
- the sections, each ``id | aligned << 7``, a length, an alignment and
  its ``0xCB`` padding where the high bit says so: the string table
  (section 0), the dialects and op names (1, with each dialect's version
  section, 7), the attributes and types (2) and their offsets (3), the IR
  (4), the resources (5, 6; read only to refuse what is in them) and the
  properties (8);
- the IR: ops with their name, location, attribute dictionary,
  properties, result types, operands, successors, use-list orders and
  regions; blocks with their arguments; values numbered in definition
  order within each isolated-from-above scope, a nested region's after
  its parent's; the isolated regions (a function's body, a reduction's),
  which bytecode 2 and later store as a section of their own for lazy
  loading, read from that section.

Integers are MLIR's **prefix varints**: the count of trailing zero bits
of the first byte, plus one, is the length in bytes (a first byte of 0
means eight more); the value is the little-endian bytes shifted right by
that length.  A signed varint is zigzag-encoded on top.

Attributes and types are decoded **lazily**: the offset section gives
every entry's bytes and whether a dialect's custom encoding (else the
textual form) is used, and :meth:`Bytecode.attr` / :meth:`Bytecode.type`
decode one only when asked, through the decoder registered for its
dialect (``builtin`` here, ``vhlo`` in ``utils/vhlo.py``).  Locations are
never decoded.

Everything this reader does not know is refused by name with a
:class:`BytecodeError`: a version, a section id, a dialect without a
decoder, an attribute or type code.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

MAGIC = b"ML\xefR"
MAX_VERSION = 6

# section ids
S_STRING, S_DIALECT, S_ATTR_TYPE, S_ATTR_TYPE_OFFSET, S_IR = 0, 1, 2, 3, 4
S_RESOURCE, S_RESOURCE_OFFSET, S_DIALECT_VERSIONS, S_PROPERTIES = 5, 6, 7, 8
N_SECTIONS = 9
ALIGNMENT_BYTE = 0xCB

# bytecode versions at which the encoding changed
V_DIALECT_VERSIONING, V_LAZY_LOADING, V_USE_LIST_ORDERING = 1, 2, 3
V_ELIDE_UNKNOWN_BLOCK_ARG_LOCATION, V_NATIVE_PROPERTIES = 4, 5

# an op's encoding mask
HAS_ATTRS, HAS_RESULTS, HAS_OPERANDS, HAS_SUCCESSORS = 0x01, 0x02, 0x04, 0x08
HAS_INLINE_REGIONS, HAS_USE_LIST_ORDERS, HAS_PROPERTIES = 0x10, 0x20, 0x40


class BytecodeError(ValueError):
    """Bytes that are not MLIR bytecode this reader knows."""


class Reader:
    """A cursor over ``buf[pos:end]``; ``base`` is the offset of the whole
    bytecode in ``buf``, which section alignment is counted from."""

    __slots__ = ("buf", "pos", "end", "base")

    def __init__(self, buf, pos: int = 0, end: Optional[int] = None,
                 base: int = 0):
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end
        self.base = base

    def empty(self) -> bool:
        return self.pos >= self.end

    def _need(self, n: int) -> None:
        if self.pos + n > self.end:
            raise BytecodeError("bytecode ends %d bytes early at offset %d"
                                % (self.pos + n - self.end, self.pos))

    def byte(self) -> int:
        self._need(1)
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def bytes(self, n: int):
        self._need(n)
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def varint(self) -> int:
        self._need(1)
        first = self.buf[self.pos]
        if first == 0:
            self._need(9)
            v = int.from_bytes(self.buf[self.pos + 1:self.pos + 9], "little")
            self.pos += 9
            return v
        n = (first & -first).bit_length()
        self._need(n)
        v = int.from_bytes(self.buf[self.pos:self.pos + n], "little") >> n
        self.pos += n
        return v

    def svarint(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def varint_flag(self) -> Tuple[int, bool]:
        v = self.varint()
        return v >> 1, bool(v & 1)

    def cstring(self) -> str:
        end = bytes(self.buf[self.pos:self.end]).find(b"\0")
        if end < 0:
            raise BytecodeError("unterminated string at offset %d" % self.pos)
        s = bytes(self.buf[self.pos:self.pos + end]).decode("utf-8")
        self.pos += end + 1
        return s

    def section(self) -> Tuple[int, "Reader"]:
        head = self.byte()
        length = self.varint()
        sid, aligned = head & 0x7F, bool(head & 0x80)
        if sid >= N_SECTIONS:
            raise BytecodeError("unknown bytecode section id %d" % sid)
        if aligned:
            align = self.varint()
            if align & (align - 1):
                raise BytecodeError("section alignment %d is not a power of 2"
                                    % align)
            while (self.pos - self.base) % align:
                if self.byte() != ALIGNMENT_BYTE:
                    raise BytecodeError("bad alignment padding at offset %d"
                                        % (self.pos - 1))
        self._need(length)
        sub = Reader(self.buf, self.pos, self.pos + length, self.base)
        self.pos += length
        return sid, sub


@dataclasses.dataclass
class Block:
    args: List[Tuple[int, int]]  # (value id, type index)
    ops: List["Op"]


@dataclasses.dataclass
class Region:
    blocks: List[Block]


@dataclasses.dataclass
class Op:
    name: str                 # "dialect.op", e.g. "vhlo.add_v1"
    attr_dict: Optional[int]  # index of its attribute dictionary
    props: Optional[List[int]]  # its properties' varints (see _blob)
    result_types: List[int]   # type indices
    results: List[int]        # value ids
    operands: List[int]       # value ids
    successors: List[int]
    regions: List[Region]


@dataclasses.dataclass
class _Entry:
    dialect: str
    custom: bool
    data: object  # memoryview of the entry's bytes


# decoders of a dialect's attributes / types: (bytecode, reader) -> value
AttrDecoder = Callable[["Bytecode", Reader], object]
_ATTR_DECODERS: Dict[str, AttrDecoder] = {}
_TYPE_DECODERS: Dict[str, AttrDecoder] = {}


def register_dialect(name: str, attr: AttrDecoder, typ: AttrDecoder) -> None:
    """Decode the custom encodings of dialect ``name``'s attributes and
    types with ``attr`` and ``typ``."""
    _ATTR_DECODERS[name] = attr
    _TYPE_DECODERS[name] = typ


class Bytecode:
    """A parsed MLIR bytecode buffer: ``version``, ``producer``,
    ``dialects`` (name -> its version section's bytes or None), and
    ``top``, the ops of the top-level block (a ``builtin.module``)."""

    def __init__(self, data: bytes):
        buf = memoryview(bytes(data))
        if bytes(buf[:4]) != MAGIC:
            raise BytecodeError("not MLIR bytecode: the file starts %r, not %r"
                                % (bytes(buf[:4]), MAGIC))
        r = Reader(buf, 4)
        self.version = r.varint()
        self.producer = r.cstring()
        if self.version > MAX_VERSION:
            raise BytecodeError(
                "MLIR bytecode version %d from %s: this reader knows "
                "versions 0 to %d" % (self.version, self.producer,
                                      MAX_VERSION))
        secs: Dict[int, Reader] = {}
        while not r.empty():
            sid, sub = r.section()
            secs[sid] = sub
        for sid in (S_STRING, S_DIALECT, S_ATTR_TYPE, S_ATTR_TYPE_OFFSET,
                    S_IR):
            if sid not in secs:
                raise BytecodeError("bytecode from %s has no section %d"
                                    % (self.producer, sid))
        self._strings(secs[S_STRING])
        self._dialects(secs[S_DIALECT])
        self._props: List[Reader] = []
        if S_PROPERTIES in secs:
            self._properties(secs[S_PROPERTIES])
        res = secs.get(S_RESOURCE_OFFSET)
        if res is not None and not res.empty() and res.varint():
            raise BytecodeError(
                "bytecode from %s carries resources (dense_resource "
                "constants), which this reader does not take" % self.producer)
        self._offsets(secs[S_ATTR_TYPE_OFFSET], secs[S_ATTR_TYPE])
        self._attr_cache: Dict[int, object] = {}
        self._type_cache: Dict[int, object] = {}
        self.top = self._ir(secs[S_IR])

    # -- tables ------------------------------------------------------------
    def _strings(self, r: Reader) -> None:
        n = r.varint()
        sizes = [r.varint() for _ in range(n)]
        end = r.end
        strings = [""] * n
        for i, size in zip(range(n - 1, -1, -1), sizes):
            start = end - size
            if start < r.pos:
                raise BytecodeError("string table overruns its section")
            strings[i] = bytes(r.buf[start:end - 1]).decode("utf-8")
            end = start
        self.strings = strings

    def string(self, r: Reader) -> str:
        i = r.varint()
        if i >= len(self.strings):
            raise BytecodeError("string index %d of %d" % (i,
                                                           len(self.strings)))
        return self.strings[i]

    def _dialects(self, r: Reader) -> None:
        n = r.varint()
        self.dialect_names: List[str] = []
        self.dialects: Dict[str, Optional[object]] = {}
        for _ in range(n):
            if self.version < V_DIALECT_VERSIONING:
                name, versioned = self.string(r), False
            else:
                idx, versioned = r.varint_flag()
                name = self.strings[idx]
            ver = None
            if versioned:
                sid, sub = r.section()
                if sid != S_DIALECT_VERSIONS:
                    raise BytecodeError("dialect %s: expected its version "
                                        "section, got section %d"
                                        % (name, sid))
                ver = sub.buf[sub.pos:sub.end]
            self.dialect_names.append(name)
            self.dialects[name] = ver
        self.op_names: List[str] = []
        if self.version >= V_ELIDE_UNKNOWN_BLOCK_ARG_LOCATION:
            r.varint()  # the number of op names, a size hint
        while not r.empty():
            dialect = self._dialect_ref(r)
            for _ in range(r.varint()):
                if self.version < V_NATIVE_PROPERTIES:
                    name = self.string(r)
                else:
                    idx, _registered = r.varint_flag()
                    name = self.strings[idx]
                self.op_names.append(dialect + "." + name)

    def _dialect_ref(self, r: Reader) -> str:
        i = r.varint()
        if i >= len(self.dialect_names):
            raise BytecodeError("dialect index %d of %d"
                                % (i, len(self.dialect_names)))
        return self.dialect_names[i]

    def _properties(self, r: Reader) -> None:
        n = r.varint()
        for _ in range(n):
            start = r.pos
            r.bytes(r.varint())
            self._props.append(Reader(r.buf, start, r.pos, r.base))

    def _offsets(self, r: Reader, data: Reader) -> None:
        n_attrs, n_types = r.varint(), r.varint()
        base, cur = data.pos, 0

        def entries(n):
            out = []
            while len(out) < n:
                dialect = self._dialect_ref(r)
                for _ in range(r.varint()):
                    size, custom = r.varint_flag()
                    if base + cur + size > data.end:
                        raise BytecodeError("attribute/type entry overruns "
                                            "its section")
                    out.append(_Entry(dialect, custom, data.buf[
                        base + cur:base + cur + size]))
                    advance(size)
            return out

        def advance(size):
            nonlocal cur
            cur += size

        self._attr_entries = entries(n_attrs)
        self._type_entries = entries(n_types)

    # -- attributes and types ---------------------------------------------
    def attr(self, i: int):
        """The decoded attribute at index ``i`` (cached)."""
        if i not in self._attr_cache:
            self._attr_cache[i] = self._decode(i, self._attr_entries,
                                               _ATTR_DECODERS, "attribute")
        return self._attr_cache[i]

    def type(self, i: int):
        """The decoded type at index ``i`` (cached)."""
        if i not in self._type_cache:
            self._type_cache[i] = self._decode(i, self._type_entries,
                                               _TYPE_DECODERS, "type")
        return self._type_cache[i]

    def _decode(self, i, entries, decoders, what):
        if i >= len(entries):
            raise BytecodeError("%s index %d of %d" % (what, i, len(entries)))
        e = entries[i]
        if not e.custom:
            text = bytes(e.data).rstrip(b"\0").decode("utf-8", "replace")
            raise BytecodeError("%s %s is stored as text, which this reader "
                                "does not parse (producer %s)"
                                % (what, text, self.producer))
        dec = decoders.get(e.dialect)
        if dec is None:
            raise BytecodeError("no decoder of the %s dialect's %ss "
                                "(producer %s)" % (e.dialect, what,
                                                   self.producer))
        return dec(self, Reader(e.data))

    def attr_ref(self, r: Reader):
        return self.attr(r.varint())

    def type_ref(self, r: Reader):
        return self.type(r.varint())

    # -- the IR ------------------------------------------------------------
    def _ir(self, r: Reader) -> List[Op]:
        return self._block(r, _Scope()).ops

    def _block(self, r: Reader, scope: "_Scope") -> Block:
        n_ops, has_args = r.varint_flag()
        args = []
        if has_args:
            for _ in range(r.varint()):
                if self.version >= V_ELIDE_UNKNOWN_BLOCK_ARG_LOCATION:
                    t, has_loc = r.varint_flag()
                    if has_loc:
                        r.varint()
                else:
                    t = r.varint()
                    r.varint()
                args.append((scope.define(), t))
            if self.version >= V_USE_LIST_ORDERING and r.byte():
                self._use_list_orders(r, len(args))
        ops = [self._op(r, scope) for _ in range(n_ops)]
        return Block(args, ops)

    @staticmethod
    def _use_list_orders(r: Reader, n_values: int) -> None:
        """Skip the use-list orders of ``n_values`` values (a count and
        each value's index only where there are several)."""
        for _ in range(r.varint() if n_values > 1 else 1):
            if n_values > 1:
                r.varint()  # the value's index
            n, _is_index_pairs = r.varint_flag()
            for _ in range(n):
                r.varint()

    def _op(self, r: Reader, scope: "_Scope") -> Op:
        idx = r.varint()
        if idx >= len(self.op_names):
            raise BytecodeError("op name index %d of %d"
                                % (idx, len(self.op_names)))
        name = self.op_names[idx]
        mask = r.byte()
        r.varint()  # location, never decoded
        attr_dict = r.varint() if mask & HAS_ATTRS else None
        props = None
        if mask & HAS_PROPERTIES:
            # in the properties section: a registered op's attributes, each
            # an attribute index, in the order of their names sorted
            pi = r.varint()
            if pi >= len(self._props):
                raise BytecodeError("%s: properties index %d of %d"
                                    % (name, pi, len(self._props)))
            props = _blob(self._props[pi])
        result_types = ([r.varint() for _ in range(r.varint())]
                        if mask & HAS_RESULTS else [])
        operands = ([scope.use(r.varint()) for _ in range(r.varint())]
                    if mask & HAS_OPERANDS else [])
        successors = ([r.varint() for _ in range(r.varint())]
                      if mask & HAS_SUCCESSORS else [])
        if mask & HAS_USE_LIST_ORDERS:
            self._use_list_orders(r, len(result_types))
        n_regions, isolated = 0, False
        if mask & HAS_INLINE_REGIONS:
            n_regions, isolated = r.varint_flag()
        results = [scope.define() for _ in result_types]
        regions = []
        if n_regions:
            rr, inner = r, scope
            if isolated:
                inner = _Scope()
                if self.version >= V_LAZY_LOADING:
                    sid, rr = r.section()
                    if sid != S_IR:
                        raise BytecodeError("%s: expected an IR section for "
                                            "its regions, got %d"
                                            % (name, sid))
            regions = [self._region(rr, inner) for _ in range(n_regions)]
        return Op(name, attr_dict, props, result_types, results, operands,
                  successors, regions)

    def _region(self, r: Reader, scope: "_Scope") -> Region:
        n_blocks = r.varint()
        if n_blocks == 0:
            return Region([])
        n_values = r.varint()
        scope.push(n_values)
        blocks = [self._block(r, scope) for _ in range(n_blocks)]
        scope.pop(n_values)
        return Region(blocks)


def _blob(r: Reader) -> List[int]:
    """A properties entry (its size, then its bytes) as the varints it
    holds: for a VHLO op, its attributes' indices (each required, so
    none carries a presence flag)."""
    r = Reader(r.buf, r.pos, r.end, r.base)
    size = r.varint()
    sub = Reader(r.buf, r.pos, r.pos + size, r.base)
    out = []
    while not sub.empty():
        out.append(sub.varint())
    return out


class _Scope:
    """The value numbering of one isolated-from-above scope: a region
    reserves its values' ids when it is entered, after its parent's; they
    are handed out in definition order and freed when it is left."""

    def __init__(self):
        self.size = 0
        self.next: List[int] = [0]

    def push(self, n: int) -> None:
        self.next.append(self.size)
        self.size += n

    def pop(self, n: int) -> None:
        self.size -= n
        self.next.pop()

    def define(self) -> int:
        v = self.next[-1]
        self.next[-1] += 1
        return v

    def use(self, v: int) -> int:
        if v >= self.size:
            raise BytecodeError("value %d used where %d are defined"
                                % (v, self.size))
        return v
