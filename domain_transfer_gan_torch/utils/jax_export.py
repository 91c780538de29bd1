"""The envelope of a ``jax.export`` artifact, read without JAX or flatbuffers.

The JAX package's ``eval/fid.py::save_extractor`` writes
``jax.export.export(jax.jit(fn))(spec).serialize()``: a **flatbuffer** whose
root table, ``Exported``, holds the traced function's description and its
StableHLO module (MLIR bytecode of the VHLO dialect, a StableHLO portable
artifact, read by ``utils/mlir_bytecode.py`` and ``utils/vhlo.py``).  This
module reads the flatbuffer with ``struct`` alone (the schema is jax's
``jax/_src/export/serialization.fbs``, serialization versions 1 to 6):

======  ==============================  ===============================
 slot    field                           read as
======  ==============================  ===============================
 0       serialization_version           uint16
 1       function_name                   string
 2, 4    in_tree, out_tree               PyTreeDef tables
 3, 5    in_avals, out_avals             AbstractValue tables: shape
                                         (strings), dtype (enum)
 6, 18   nr_devices (short, and uint32)  the uint32 where set
 9       platforms                       strings
 10, 11  ordered / unordered effects     Effect tables (type names)
 12      disabled_checks                 DisabledSafetyCheck tables
 13      mlir_module_serialized          bytes
 14      calling_convention_version      uint16
 15      module_kept_var_idx             uint16s
 16      uses_global_constants           bool
======  ==============================  ===============================

(the shardings, slots 7 and 8, and the ``vjp``, slot 17, are not read).

Two checks hold an artifact, each refusing by the field's name and value.
:func:`check`, the envelope, holds every artifact: a serialization version
this reader knows, a calling convention of 9 or 10, ``nr_devices`` 1 (no
sharded export), no effect, at least one platform, no symbolic
(shape-polymorphic) dimension and only ``utils/vhlo.py``'s dtypes.  A
contract then holds what the caller runs: :func:`check_extractor`
``save_extractor``'s (one ``(batch, H, W, C)`` array in, one array out,
``--fid_extractor``), :func:`check_serving` the JAX package's
``cli/export.py::export_model``'s (the arguments of its manifest, one
float32 image batch out).

**The platform an artifact was lowered for does not matter** as long as
its module holds no ``custom_call``: StableHLO without custom calls means
the same on every device, and the interpreter checks the whole module for
custom calls at load (refusing one by its target's name).  So an artifact
of any platforms, ``tpu`` included, is taken and run on the card: of a
multi-platform one the ``cuda`` lowering where it lists one, else the
first platform's.  Its index among the platforms is passed as the module's
first argument, ``_platform_index`` (:attr:`Exported.platform_index`).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence, Tuple

SERIALIZATION_VERSIONS = range(1, 7)  # jax 0.4.x .. 0.9: the schema above
CALLING_CONVENTIONS = (9, 10)

# jax's DType enum -> the element type names of utils/vhlo.py
DTYPES = {0: "i1", 1: "i8", 2: "i16", 3: "i32", 4: "i64", 5: "ui8",
          6: "ui16", 7: "ui32", 8: "ui64", 9: "f16", 10: "f32", 11: "f64",
          14: "bf16"}
DTYPE_NAMES = {12: "complex64", 13: "complex128", 15: "int4", 16: "uint4",
               17: "float8_e4m3b11fnuz", 18: "float8_e4m3fn",
               19: "float8_e4m3fnuz", 20: "float8_e5m2",
               21: "float8_e5m2fnuz", 22: "float0", 23: "float8_e4m3",
               24: "float8_e3m4", 25: "float8_e8m0fnu", 26: "float4_e2m1fn",
               27: "key<fry>", 28: "key<rbg>", 29: "key<unsafe_rbg>"}
TREE_KINDS = ("leaf", "none", "tuple", "list", "dict", "custom")
CHECK_KINDS = ("platform", "custom_call", "shape_assertions")


class ExportFormatError(ValueError):
    """An artifact that is not a ``jax.export`` file this reader knows, or
    one the port does not run; the message names the field."""


class _Table:
    """A flatbuffer table at ``pos`` in ``buf``."""

    __slots__ = ("buf", "pos", "vt", "vt_len")

    def __init__(self, buf: bytes, pos: int):
        if not 0 <= pos <= len(buf) - 4:
            raise ExportFormatError("flatbuffer table at %d of a %d-byte "
                                    "file" % (pos, len(buf)))
        self.buf, self.pos = buf, pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        if not 0 <= self.vt <= len(buf) - 4:
            raise ExportFormatError("flatbuffer vtable at %d" % self.vt)
        self.vt_len = struct.unpack_from("<H", buf, self.vt)[0]

    def _field(self, slot: int) -> int:
        """The field's position, or 0 where it is absent."""
        o = 4 + 2 * slot
        if o >= self.vt_len:
            return 0
        off = struct.unpack_from("<H", self.buf, self.vt + o)[0]
        return self.pos + off if off else 0

    def scalar(self, slot: int, fmt: str, default=0):
        p = self._field(slot)
        return struct.unpack_from("<" + fmt, self.buf, p)[0] if p else default

    def _ref(self, slot: int) -> int:
        p = self._field(slot)
        return p + struct.unpack_from("<I", self.buf, p)[0] if p else 0

    def table(self, slot: int) -> Optional["_Table"]:
        p = self._ref(slot)
        return _Table(self.buf, p) if p else None

    def _vector(self, slot: int) -> Tuple[int, int]:
        p = self._ref(slot)
        if not p:
            return 0, 0
        n = struct.unpack_from("<I", self.buf, p)[0]
        return p + 4, n

    def bytes(self, slot: int) -> bytes:
        p, n = self._vector(slot)
        if p + n > len(self.buf):
            raise ExportFormatError("a %d-byte vector past the file's end"
                                    % n)
        return bytes(self.buf[p:p + n])

    def string(self, slot: int) -> str:
        return self.bytes(slot).decode("utf-8")

    def scalars(self, slot: int, fmt: str) -> List[int]:
        p, n = self._vector(slot)
        return list(struct.unpack_from("<%d%s" % (n, fmt), self.buf, p))

    def _refs(self, slot: int) -> List[int]:
        p, n = self._vector(slot)
        return [p + 4 * i + struct.unpack_from("<I", self.buf, p + 4 * i)[0]
                for i in range(n)]

    def tables(self, slot: int) -> List["_Table"]:
        return [_Table(self.buf, q) for q in self._refs(slot)]

    def strings(self, slot: int) -> List[str]:
        out = []
        for q in self._refs(slot):
            n = struct.unpack_from("<I", self.buf, q)[0]
            out.append(bytes(self.buf[q + 4:q + 4 + n]).decode("utf-8"))
        return out


@dataclasses.dataclass(frozen=True)
class Aval:
    """An input or output: its shape (the strings jax writes, ints where
    they are) and its element type (``utils/vhlo.py``'s name, or jax's
    where that has none)."""

    shape: Tuple[object, ...]
    dtype: str


@dataclasses.dataclass
class Exported:
    """The fields of a ``jax.export`` artifact this reader takes."""

    serialization_version: int
    function_name: str
    in_tree: str   # e.g. "((*,), {})"; "*" is a leaf
    out_tree: str
    in_avals: Tuple[Aval, ...]
    out_avals: Tuple[Aval, ...]
    platforms: Tuple[str, ...]
    ordered_effects: Tuple[str, ...]
    unordered_effects: Tuple[str, ...]
    disabled_checks: Tuple[str, ...]
    nr_devices: int
    calling_convention_version: int
    module_kept_var_idx: Tuple[int, ...]
    uses_global_constants: bool
    mlir_module_serialized: bytes

    @property
    def platform_index(self) -> Optional[int]:
        """:func:`lowering_index` of its platforms."""
        return lowering_index(self.platforms)


def lowering_index(platforms: Sequence[str]) -> Optional[int]:
    """The index of the lowering to run, passed as the module's
    ``_platform_index`` argument: ``cuda``'s where ``platforms`` lists it,
    else 0, the first platform's; None for a single-platform export, whose
    module takes no such argument."""
    if len(platforms) == 1:
        return None
    if "cuda" in platforms:
        return list(platforms).index("cuda")
    return 0


def _tree(t: Optional[_Table], depth: int = 0) -> str:
    """A PyTreeDef as text: ``*`` a leaf, tuples and lists in brackets,
    dicts with their keys, a custom node by its name."""
    if t is None or depth > 64:
        return "?"
    kind = t.scalar(0, "b")
    kids = [_tree(c, depth + 1) for c in t.tables(1)]
    if kind == 0:
        return "*"
    if kind == 1:
        return "None"
    if kind == 2:
        return "(%s)" % ("".join(k + "," for k in kids) if len(kids) == 1
                         else ", ".join(kids))
    if kind == 3:
        return "[%s]" % ", ".join(kids)
    if kind == 4:
        keys = t.strings(2)
        return "{%s}" % ", ".join("%r: %s" % (k, v)
                                  for k, v in zip(keys, kids))
    if kind == 5:
        return "%s(%s)" % (t.string(3), ", ".join(kids))
    return "<kind %d>" % kind


def _aval(t: _Table) -> Aval:
    shape = tuple(int(d) if d.lstrip("-").isdigit() else d
                  for d in t.strings(1))
    code = t.scalar(2, "b")
    return Aval(shape, DTYPES.get(code, DTYPE_NAMES.get(code,
                                                        "dtype %d" % code)))


def _check(t: _Table) -> str:
    kind = t.scalar(0, "b")
    name = CHECK_KINDS[kind] if kind < len(CHECK_KINDS) else str(kind)
    target = t.string(1)
    return "%s(%s)" % (name, target) if target else name


def read(data: bytes) -> Exported:
    """The fields of the serialized ``jax.export`` artifact ``data``."""
    buf = bytes(data)
    if len(buf) < 8:
        raise ExportFormatError("a %d-byte file is no jax.export artifact"
                                % len(buf))
    root = _Table(buf, struct.unpack_from("<I", buf, 0)[0])
    return Exported(
        serialization_version=root.scalar(0, "H"),
        function_name=root.string(1),
        in_tree=_tree(root.table(2)),
        out_tree=_tree(root.table(4)),
        in_avals=tuple(_aval(t) for t in root.tables(3)),
        out_avals=tuple(_aval(t) for t in root.tables(5)),
        platforms=tuple(root.strings(9)),
        ordered_effects=tuple(t.string(0) for t in root.tables(10)),
        unordered_effects=tuple(t.string(0) for t in root.tables(11)),
        disabled_checks=tuple(_check(t) for t in root.tables(12)),
        nr_devices=root.scalar(18, "I") or root.scalar(6, "h"),
        calling_convention_version=root.scalar(14, "H"),
        module_kept_var_idx=tuple(root.scalars(15, "H")),
        uses_global_constants=bool(root.scalar(16, "B")),
        mlir_module_serialized=root.bytes(13),
    )


def _refuse(where, field, value, why):
    raise ExportFormatError("%s: %s = %s: %s" % (where, field, value, why))


def check(exp: Exported, where: str = "the artifact") -> Exported:
    """Refuse, by the field's name and value, an envelope the port does not
    run (see the module's docstring); return ``exp``."""
    if exp.serialization_version not in SERIALIZATION_VERSIONS:
        _refuse(where, "serialization_version", exp.serialization_version,
                "this reader knows versions %d to %d"
                % (SERIALIZATION_VERSIONS[0], SERIALIZATION_VERSIONS[-1]))
    if exp.calling_convention_version not in CALLING_CONVENTIONS:
        _refuse(where, "calling_convention_version",
                exp.calling_convention_version,
                "this reader runs versions %s" % (CALLING_CONVENTIONS,))
    if exp.nr_devices != 1:
        _refuse(where, "nr_devices", exp.nr_devices,
                "a sharded export; the port runs one device's")
    for field in ("ordered_effects", "unordered_effects"):
        if getattr(exp, field):
            _refuse(where, field, list(getattr(exp, field)),
                    "an export with effects; the port runs pure functions")
    if not exp.platforms:
        _refuse(where, "platforms", [], "no platform")
    for field in ("in_avals", "out_avals"):
        for a in getattr(exp, field):
            if not all(isinstance(d, int) for d in a.shape):
                _refuse(where, field, "%s%s" % (a.dtype, list(a.shape)),
                        "a symbolic (shape-polymorphic) dimension")
            if a.dtype not in DTYPES.values():
                _refuse(where, field, "%s%s" % (a.dtype, list(a.shape)),
                        "an element type the port does not run")
    return exp


def check_extractor(exp: Exported, where: str = "the artifact") -> Exported:
    """``save_extractor``'s contract: one array in, one array out, no input
    kept beyond it; return ``exp``."""
    if exp.in_tree != "((*,), {})" or len(exp.in_avals) != 1:
        _refuse(where, "in_tree", exp.in_tree,
                "the function must take one array")
    if exp.out_tree != "*" or len(exp.out_avals) != 1:
        _refuse(where, "out_tree", exp.out_tree,
                "the function must return one array")
    if not set(exp.module_kept_var_idx) <= {0}:
        _refuse(where, "module_kept_var_idx", list(exp.module_kept_var_idx),
                "inputs beyond the one array")
    return exp


def _avals(avals):
    return ["%s%s" % (a.dtype, list(a.shape)) for a in avals]


def check_serving(exp: Exported, args, out_shape,
                  where: str = "the artifact") -> Exported:
    """``export_model``'s contract: the arguments its manifest names
    (``functions[name]["args"]``, ``[name, shape, "float32"]`` each) in, one
    float32 array of ``out_shape`` out; return ``exp``.  The module takes
    the arguments ``module_kept_var_idx`` keeps."""
    if not all(len(a) == 3 and a[2] == "float32" for a in args):
        _refuse(where, "the manifest's args", args,
                "each is [name, shape, \"float32\"]")
    tree = "((%s), {})" % ("*," if len(args) == 1
                           else ", ".join("*" for _ in args))
    if exp.in_tree != tree:
        _refuse(where, "in_tree", exp.in_tree,
                "the manifest names %d arguments, %s"
                % (len(args), ", ".join(a[0] for a in args)))
    want = _avals(Aval(tuple(a[1]), "f32") for a in args)
    if _avals(exp.in_avals) != want:
        _refuse(where, "in_avals", _avals(exp.in_avals),
                "the manifest's args are %s" % want)
    want = _avals([Aval(tuple(out_shape), "f32")])
    if exp.out_tree != "*" or _avals(exp.out_avals) != want:
        _refuse(where, "out_avals", _avals(exp.out_avals),
                "the manifest gives %s" % want)
    if not set(exp.module_kept_var_idx) <= set(range(len(args))):
        _refuse(where, "module_kept_var_idx", list(exp.module_kept_var_idx),
                "indices beyond the %d arguments" % len(args))
    return exp


def load(path: str) -> Exported:
    """Read the artifact at ``path`` and :func:`check` its envelope."""
    with open(path, "rb") as f:
        return check(read(f.read()), where=path)
