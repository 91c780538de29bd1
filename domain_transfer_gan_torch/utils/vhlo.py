"""The VHLO dialect's bytecode: the types, attributes and ops of a StableHLO
portable artifact, decoded for ``eval/stablehlo.py``.

A ``jax.export`` artifact's module (``utils/jax_export.py``) is StableHLO
serialized as **VHLO**, its versioned twin (ops ``vhlo.add_v1``,
``vhlo.tanh_v2``, ...), in MLIR bytecode (``utils/mlir_bytecode.py``).
This module registers the decoders of the ``vhlo`` dialect's custom
encodings, and of the few ``builtin`` attributes that appear beside them
(the module's attribute dictionary), with that reader:

- element types ``f32 bf16 f16 f64``, ``i1`` (``bool_v1``), the signless
  integers ``i8 .. i64`` and the unsigned ``ui8 .. ui64``; ranked tensor
  types; function types;
- attributes: array, bool, string, integer, float, type, dictionary,
  ``tensor_v1`` dense data (a splat is one element's bytes; ``i1`` is
  packed eight to a byte, least significant bit first, and a single byte
  0x00 or 0xFF is a splat), the enums of ``comparison_direction``,
  ``comparison_type`` and ``precision``, and ``result_accuracy``;
- each op's attributes: VHLO ops store them as native properties, the
  attribute indices in the order of the attribute names sorted, so each
  op the interpreter runs has its names here (:data:`OP_ATTRS`), and an
  op of another version (a ``_v2`` from a newer producer) is refused.

Integers and floats of an attribute are written as MLIR's ``APInt``: one
byte up to 8 bits, a signed varint up to 64 bits (a float's bits).

The producers read are StableHLO 1.0 to 1.13 (``StableHLO_v1.x.y``, the
header's producer string).  A complex type, an attribute or type code
outside the above, an op outside :data:`OP_ATTRS`, and a producer outside
that range are refused by name with a :class:`VhloError` that names the
producer.
"""

from __future__ import annotations

import dataclasses
import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import mlir_bytecode as mb
from .mlir_bytecode import Bytecode, BytecodeError, Reader

PRODUCER = re.compile(r"StableHLO_v(\d+)\.(\d+)\.(\d+)$")
PRODUCERS = ((1, 0), (1, 13))  # the StableHLO versions read, inclusive


class VhloError(BytecodeError):
    """A StableHLO artifact that uses what this reader does not know."""


@dataclasses.dataclass(frozen=True)
class TensorType:
    shape: Tuple[int, ...]
    dtype: str  # an element type name, e.g. "f32", "i1", "ui8"

    def __str__(self):
        return "tensor<%s>" % "x".join([str(d) for d in self.shape]
                                       + [self.dtype])


@dataclasses.dataclass(frozen=True)
class FunctionType:
    inputs: Tuple[object, ...]
    results: Tuple[object, ...]


@dataclasses.dataclass(frozen=True)
class Enum:
    kind: str   # "comparison_direction", "comparison_type", "precision"
    value: str  # e.g. "GT"


# vhlo type codes (stablehlo/dialect/VhloBytecode.cpp)
_SCALAR_TYPES = {0: "i1", 2: "bf16", 3: "f16", 4: "f32", 5: "f64",
                 11: "i8", 12: "i16", 13: "i32", 14: "i64",
                 16: "ui8", 17: "ui16", 18: "ui32", 19: "ui64"}
_TYPE_NAMES = {1: "complex_v1", 6: "f8E4M3FN_v1", 7: "f8E5M2_v1",
               9: "index_v1", 10: "i4_v1", 15: "ui4_v1",
               21: "ranked tensor with an encoding", 22: "token_v1",
               23: "tuple_v1", 24: "uniform_quant_v1",
               25: "unranked_tensor_v1", 26: "witness_v1"}
T_FUNCTION, T_RANKED_TENSOR, T_NONE = 8, 20, 33

# vhlo attribute codes
A_ARRAY, A_BOOL, A_COMPARISON_DIRECTION, A_COMPARISON_TYPE = 1, 2, 3, 4
A_DICTIONARY, A_FLOAT, A_INTEGER, A_PRECISION, A_STRING = 6, 8, 9, 11, 14
A_TENSOR, A_TYPE, A_RESULT_ACCURACY_MODE, A_RESULT_ACCURACY = 15, 17, 19, 20
_ATTR_NAMES = {5: "custom_call_api_version_v1", 7: "fft_type_v1",
               10: "output_operand_alias_v1", 12: "rng_algorithm_v1",
               13: "rng_distribution_v1", 16: "transpose_v1",
               18: "type_extensions_v1 (bounded dynamic shapes)"}
_ENUMS = {
    A_COMPARISON_DIRECTION: ("comparison_direction",
                             ("EQ", "NE", "GE", "GT", "LE", "LT")),
    A_COMPARISON_TYPE: ("comparison_type",
                        ("NOTYPE", "FLOAT", "TOTALORDER", "SIGNED",
                         "UNSIGNED")),
    A_PRECISION: ("precision", ("DEFAULT", "HIGH", "HIGHEST")),
    A_RESULT_ACCURACY_MODE: ("result_accuracy_mode",
                             ("DEFAULT", "HIGHEST", "TOLERANCE")),
}

# element type -> (torch dtype, bytes per element, numpy dtype of the bytes)
DTYPES = {
    "i1": (torch.bool, 1, np.bool_), "f32": (torch.float32, 4, np.float32),
    "bf16": (torch.bfloat16, 2, np.uint16),
    "f16": (torch.float16, 2, np.float16), "f64": (torch.float64, 8,
                                                   np.float64),
    "i8": (torch.int8, 1, np.int8), "i16": (torch.int16, 2, np.int16),
    "i32": (torch.int32, 4, np.int32), "i64": (torch.int64, 8, np.int64),
    "ui8": (torch.uint8, 1, np.uint8), "ui16": (torch.uint16, 2, np.uint16),
    "ui32": (torch.uint32, 4, np.uint32), "ui64": (torch.uint64, 8,
                                                   np.uint64),
}
_WIDTH = {"i1": 1, "bf16": 16, "f16": 16, "f32": 32, "f64": 64, "i8": 8,
          "i16": 16, "i32": 32, "i64": 64, "ui8": 8, "ui16": 16, "ui32": 32,
          "ui64": 64}

# each op the interpreter runs, by VHLO name, and its attributes' names
OP_ATTRS: Dict[str, Tuple[str, ...]] = {
    "func_v1": ("sym_name", "function_type", "sym_visibility", "arg_attrs",
                "res_attrs"),
    "call_v1": ("callee",),
    "return_v1": (),
    "case_v1": (),
    "constant_v1": ("value",),
    "iota_v1": ("iota_dimension",),
    "convert_v1": (),
    "reshape_v1": (),
    "broadcast_in_dim_v1": ("broadcast_dimensions",),
    "transpose_v1": ("permutation",),
    "slice_v1": ("start_indices", "limit_indices", "strides"),
    "concatenate_v1": ("dimension",),
    "pad_v1": ("edge_padding_low", "edge_padding_high", "interior_padding"),
    "select_v1": (),
    "compare_v1": ("comparison_direction", "compare_type"),
    "clamp_v1": (),
    "dot_general_v1": ("lhs_batching_dimensions", "rhs_batching_dimensions",
                       "lhs_contracting_dimensions",
                       "rhs_contracting_dimensions", "precision_config"),
    "dot_general_v2": ("lhs_batching_dimensions", "rhs_batching_dimensions",
                       "lhs_contracting_dimensions",
                       "rhs_contracting_dimensions", "precision_config",
                       "lhs_precision_type", "rhs_precision_type",
                       "accumulation_type", "lhs_component_count",
                       "rhs_component_count", "num_primitive_operations",
                       "allow_imprecise_accumulation"),
    "convolution_v1": ("window_strides", "padding", "lhs_dilation",
                       "rhs_dilation", "window_reversal",
                       "input_batch_dimension", "input_feature_dimension",
                       "input_spatial_dimensions",
                       "kernel_input_feature_dimension",
                       "kernel_output_feature_dimension",
                       "kernel_spatial_dimensions", "output_batch_dimension",
                       "output_feature_dimension",
                       "output_spatial_dimensions", "feature_group_count",
                       "batch_group_count", "precision_config"),
    "reduce_v1": ("dimensions",),
    "reverse_v1": ("dimensions",),
    "reduce_window_v1": ("window_dimensions", "window_strides",
                         "base_dilations", "window_dilations", "padding"),
    "custom_call_v1": ("call_target_name", "has_side_effect",
                       "backend_config", "api_version",
                       "called_computations", "operand_layouts",
                       "result_layouts", "output_operand_aliases"),
}
for _name in ("add", "subtract", "multiply", "divide", "maximum", "minimum",
              "negate", "abs", "and", "or", "not", "power"):
    OP_ATTRS[_name + "_v1"] = ()
for _name in ("exponential", "log", "sqrt", "rsqrt", "tanh", "logistic"):
    OP_ATTRS[_name + "_v1"] = ()
    OP_ATTRS[_name + "_v2"] = ("result_accuracy",)


def check_producer(bc: Bytecode) -> Tuple[int, int, int]:
    """The producer's StableHLO version; a producer outside
    :data:`PRODUCERS` is refused."""
    m = PRODUCER.match(bc.producer)
    if m is None:
        raise VhloError("the module's producer %r is not StableHLO "
                        "(StableHLO_v1.x.y)" % bc.producer)
    ver = tuple(int(g) for g in m.groups())
    if not PRODUCERS[0] <= ver[:2] <= PRODUCERS[1]:
        raise VhloError("producer %s: this reader reads StableHLO %d.%d to "
                        "%d.%d" % ((bc.producer,) + PRODUCERS[0]
                                   + PRODUCERS[1]))
    return ver


def op_kind(bc: Bytecode, op: mb.Op) -> str:
    """``op``'s VHLO name without the dialect (``add_v1``), refused where
    this reader does not know it."""
    dialect, _, name = op.name.partition(".")
    if dialect != "vhlo" or name not in OP_ATTRS:
        base = re.sub(r"_v\d+$", "", name)
        known = sorted(k for k in OP_ATTRS if re.sub(r"_v\d+$", "", k)
                       == base)
        if dialect == "vhlo" and known:
            raise VhloError("op %s (producer %s): this reader knows %s only"
                            % (op.name, bc.producer, ", ".join(
                                "vhlo." + k for k in known)))
        raise VhloError("op %s (producer %s) is not one this reader "
                        "knows" % (op.name, bc.producer))
    return name


def op_attr(bc: Bytecode, op: mb.Op, name: str):
    """The attribute ``name`` of a VHLO op, decoded."""
    kind = op_kind(bc, op)
    names = sorted(OP_ATTRS[kind])
    props = op.props or []
    if len(props) != len(names):
        raise VhloError("op %s (producer %s) has %d attributes; this reader "
                        "knows %d: %s" % (op.name, bc.producer, len(props),
                                          len(names), ", ".join(names)))
    return bc.attr(props[names.index(name)])


# -- types -----------------------------------------------------------------
def _type(bc: Bytecode, r: Reader):
    code = r.varint()
    if code in _SCALAR_TYPES:
        return _SCALAR_TYPES[code]
    if code == T_RANKED_TENSOR:
        shape = tuple(r.svarint() for _ in range(r.varint()))
        elt = bc.type_ref(r)
        if not isinstance(elt, str):
            raise VhloError("a tensor of %s (producer %s)" % (elt,
                                                              bc.producer))
        return TensorType(shape, elt)
    if code == T_NONE:
        return None
    if code == T_FUNCTION:
        inputs = tuple(bc.type_ref(r) for _ in range(r.varint()))
        results = tuple(bc.type_ref(r) for _ in range(r.varint()))
        return FunctionType(inputs, results)
    raise VhloError("vhlo type %s (code %d, producer %s) is not one this "
                    "reader decodes" % (_TYPE_NAMES.get(code, "?"), code,
                                        bc.producer))


def _width(bc: Bytecode, t) -> int:
    if t not in _WIDTH:
        raise VhloError("a scalar attribute of type %s (producer %s)"
                        % (t, bc.producer))
    return _WIDTH[t]


def _apint(r: Reader, width: int) -> int:
    """An APInt of ``width`` (at most 64) bits as its unsigned value."""
    v = r.byte() if width <= 8 else r.svarint()
    return v & ((1 << width) - 1)


def _float(bits: int, dtype: str) -> float:
    if dtype == "f32":
        return struct.unpack("<f", struct.pack("<I", bits))[0]
    if dtype == "f64":
        return struct.unpack("<d", struct.pack("<Q", bits))[0]
    if dtype == "f16":
        return float(np.array([bits], np.uint16).view(np.float16)[0])
    if dtype == "bf16":
        return struct.unpack("<f", struct.pack("<I", bits << 16))[0]
    raise VhloError("a float attribute of type %s" % dtype)


def _integer(bits: int, dtype: str):
    if dtype == "i1":
        return bool(bits)
    width = _WIDTH[dtype]
    if not dtype.startswith("ui") and bits >> (width - 1):
        return bits - (1 << width)
    return bits


def dense(data: bytes, typ: TensorType) -> torch.Tensor:
    """The CPU tensor that ``tensor_v1`` raw ``data`` of type ``typ``
    holds."""
    if typ.dtype not in DTYPES:
        raise VhloError("a constant of element type %s" % typ.dtype)
    tdtype, size, npdtype = DTYPES[typ.dtype]
    n = int(np.prod(typ.shape, dtype=np.int64))
    if typ.dtype == "i1":
        if len(data) == 1 and data[0] in (0, 0xFF):
            flat = np.full(n, bool(data[0]))
        elif len(data) == (n + 7) // 8:
            flat = np.unpackbits(np.frombuffer(data, np.uint8),
                                 bitorder="little")[:n].astype(bool)
        else:
            raise VhloError("an i1 constant of %d elements in %d bytes"
                            % (n, len(data)))
    else:
        flat = np.frombuffer(data, npdtype)
        if len(data) == size and n != 1:
            flat = np.full(n, flat[0], npdtype)
        elif len(data) != n * size:
            raise VhloError("a %s constant of %d elements in %d bytes"
                            % (typ.dtype, n, len(data)))
    t = torch.from_numpy(np.array(flat, copy=True).reshape(typ.shape))
    return t.view(torch.bfloat16) if typ.dtype == "bf16" else t


# -- attributes ------------------------------------------------------------
def _attr(bc: Bytecode, r: Reader):
    code = r.varint()
    if code == A_ARRAY:
        return [bc.attr_ref(r) for _ in range(r.varint())]
    if code == A_BOOL:
        return bool(r.varint())
    if code in _ENUMS:
        kind, values = _ENUMS[code]
        v = r.varint()
        if v >= len(values):
            raise VhloError("%s value %d (producer %s)" % (kind, v,
                                                           bc.producer))
        return Enum(kind, values[v])
    if code == A_DICTIONARY:
        out = {}
        for _ in range(r.varint()):
            k = bc.attr_ref(r)
            out[k] = bc.attr_ref(r)
        return out
    if code == A_FLOAT:
        t = bc.type_ref(r)
        return _float(_apint(r, _width(bc, t)), t)
    if code == A_INTEGER:
        t = bc.type_ref(r)
        return _integer(_apint(r, _width(bc, t)), t)
    if code == A_STRING:
        return bc.string(r)
    if code == A_TENSOR:
        t = bc.type_ref(r)
        return dense(bytes(r.bytes(r.varint())), t)
    if code == A_TYPE:
        return bc.type_ref(r)
    if code == A_RESULT_ACCURACY:
        atol, rtol, ulps = r.varint(), r.varint(), r.varint()
        return ("result_accuracy", atol, rtol, ulps, bc.attr_ref(r))
    raise VhloError("vhlo attribute %s (code %d, producer %s) is not one "
                    "this reader decodes" % (_ATTR_NAMES.get(code, "?"),
                                             code, bc.producer))


# builtin attribute and type codes (mlir/IR/BuiltinDialectBytecode.td)
B_ARRAY, B_DICTIONARY, B_STRING, B_STRING_WITH_TYPE = 0, 1, 2, 3
B_FLAT_SYMBOL_REF, B_TYPE, B_UNIT, B_INTEGER = 4, 6, 7, 8
B_INTEGER_TYPE = 0


def _builtin_attr(bc: Bytecode, r: Reader):
    code = r.varint()
    if code == B_ARRAY:
        return [bc.attr_ref(r) for _ in range(r.varint())]
    if code == B_DICTIONARY:
        out = {}
        for _ in range(r.varint()):
            k = bc.attr_ref(r)
            out[k] = bc.attr_ref(r)
        return out
    if code in (B_STRING, B_STRING_WITH_TYPE, B_FLAT_SYMBOL_REF):
        return bc.string(r) if code != B_FLAT_SYMBOL_REF else bc.attr_ref(r)
    if code == B_TYPE:
        return bc.type_ref(r)
    if code == B_UNIT:
        return True
    if code == B_INTEGER:
        t = bc.type_ref(r)
        return _integer(_apint(r, _width(bc, t)), t)
    raise VhloError("builtin attribute code %d (producer %s) is not one "
                    "this reader decodes" % (code, bc.producer))


def _builtin_type(bc: Bytecode, r: Reader):
    code = r.varint()
    if code == B_INTEGER_TYPE:
        v = r.varint()  # width << 2 | signedness: signless, signed, unsigned
        return ("i", "i", "ui", "?")[v & 3] + str(v >> 2)
    raise VhloError("builtin type code %d (producer %s) is not one this "
                    "reader decodes" % (code, bc.producer))


mb.register_dialect("vhlo", _attr, _type)
mb.register_dialect("builtin", _builtin_attr, _builtin_type)


def parse_module(data: bytes) -> Bytecode:
    """The bytecode of a StableHLO portable artifact, its producer
    checked."""
    bc = Bytecode(data)
    check_producer(bc)
    missing = {"vhlo"} - set(bc.dialects)
    if missing:
        raise VhloError("the module (producer %s) has no vhlo dialect: "
                        "dialects %s" % (bc.producer, sorted(bc.dialects)))
    return bc


def functions(bc: Bytecode) -> Dict[str, mb.Op]:
    """The module's ``vhlo.func_v1`` ops by ``sym_name``."""
    if len(bc.top) != 1 or bc.top[0].name != "builtin.module":
        raise VhloError("the top level holds %s, not one builtin.module"
                        % [op.name for op in bc.top])
    out = {}
    for block in bc.top[0].regions[0].blocks:
        for op in block.ops:
            if op_kind(bc, op) != "func_v1":
                raise VhloError("the module holds %s beside its functions"
                                % op.name)
            out[op_attr(bc, op, "sym_name")] = op
    return out


def tensor_types(bc: Bytecode, idx: List[int]) -> List[TensorType]:
    out = []
    for i in idx:
        t = bc.type(i)
        if not isinstance(t, TensorType):
            raise VhloError("a value of type %s (producer %s)" % (
                t, bc.producer))
        out.append(t)
    return out


def dims(a) -> Optional[List[int]]:
    """An array-of-integers attribute (a 1-d i64 ``tensor_v1`` or an
    array) as a list."""
    if isinstance(a, torch.Tensor):
        return [int(v) for v in a.reshape(-1).tolist()]
    if isinstance(a, list):
        return [int(v) for v in a]
    raise VhloError("expected a list of integers, got %r" % (a,))
