"""An interpreter of a StableHLO module on torch tensors: how the port runs a
``jax.export`` artifact without JAX, a feature extractor
(``--fid_extractor``) or the JAX package's serving export (``cli/serve.py``
on a directory of ``predict_{A,B}.stablehlo``).

``Program(data, device)`` takes the module's bytes (a StableHLO portable
artifact, read by ``utils/mlir_bytecode.py`` and ``utils/vhlo.py``) and
**checks the whole module at load**, before any input is seen: every op
of every function must be one of the set below, with attributes this
interpreter takes, or a :class:`StableHLOError` names it (a
``custom_call`` by its ``call_target_name``: a TPU Pallas kernel is a
``tpu_custom_call``, which no card runs).  Constants (and ``iota``s) move
to ``device`` once, at load.  ``program(*args)`` then runs ``main``
eagerly on ``device``, op by op, and returns its results.  Nothing falls
back to the CPU.

The ops, by StableHLO name: ``constant iota convert reshape
broadcast_in_dim transpose reverse slice concatenate pad select compare add
subtract multiply divide maximum minimum negate abs and or not
exponential log sqrt rsqrt tanh logistic power clamp dot_general
convolution reduce reduce_window case call return`` (``func.call`` and
``func.return`` are ``vhlo.call_v1`` / ``vhlo.return_v1`` too).

- ``convolution`` is ``F.conv2d`` (cuDNN on the card): two spatial
  dimensions in any ``dimension_numbers``, window strides, padding
  (negative crops), lhs dilation (zeros between the input's elements),
  rhs dilation, window reversal and ``feature_group_count``; a
  ``batch_group_count`` above 1 and one or three spatial dimensions are
  refused.  ``dot_general`` is ``torch.matmul`` over the batch,
  free and contracting dimensions.  The JAX package computes both outside
  any Pallas kernel, so the library's kernels are the right ones here.
  TF32 follows torch's own switches (``torch.backends.cudnn.allow_tf32``,
  ``torch.backends.cuda.matmul.allow_tf32``).
- ``reduce`` and ``reduce_window`` take one operand and a body of one
  ``add``, ``maximum``, ``minimum``, ``multiply``, ``and`` or ``or`` of
  its two arguments, recognised at load and run as the tensor reduction
  (``sum``, ``amax``, ...), never per element; any other body (an argmax's
  compare and select) is refused with its ops listed.
- ``reverse`` is one ``torch.flip`` over its dimensions (none: the
  identity).
- ``case`` reads its index on the host (one synchronisation) and runs
  one branch; an index out of range runs the last, as StableHLO says.
- bfloat16 follows XLA's float normalization, as ``exp.call`` computes
  it: an op of bfloat16 result is computed in float32 and rounded to
  bfloat16 for its users, except that a ``convert`` of it to float32 takes
  the float32 value unrounded (XLA's ``FloatNormalization`` hands such a
  convert the wide result).  The JAX norm's ``x.astype(float32)`` after a
  bfloat16 bias add reads that add unrounded, as on XLA.
- Integer ``divide`` truncates toward zero, as StableHLO's does; a
  ``compare`` of type TOTALORDER orders floats by IEEE 754's totalOrder
  (:func:`total_order_key`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
from torch.nn import functional as F

from ..utils import mlir_bytecode as mb
from ..utils import vhlo
from ..utils.vhlo import TensorType, dims, op_attr

# the op set, by VHLO name without its version
OPS = ("constant", "iota", "convert", "reshape", "broadcast_in_dim",
       "transpose", "reverse", "slice", "concatenate", "pad", "select",
       "compare", "add", "subtract", "multiply", "divide", "maximum",
       "minimum", "negate", "abs", "and", "or", "not", "exponential",
       "log", "sqrt", "rsqrt", "tanh", "logistic", "power", "clamp",
       "dot_general", "convolution", "reduce", "reduce_window", "case",
       "call", "return")


# ops that only move or pick values: a bfloat16 result of one is exact,
# so it is never widened
_MOVES = ("constant", "iota", "convert", "reshape", "broadcast_in_dim",
          "transpose", "reverse", "slice", "concatenate", "pad", "case",
          "call", "return")


class StableHLOError(vhlo.VhloError):
    """A module that holds what this interpreter does not run."""


def _is_int(t: torch.dtype) -> bool:
    return not t.is_floating_point and t != torch.bool


def _divide(a, b):
    if _is_int(a.dtype):
        return torch.div(a, b, rounding_mode="trunc")
    return a / b


def _bitwise(fn_bool, fn_int):
    def op(a, b):
        return fn_bool(a, b) if a.dtype == torch.bool else fn_int(a, b)
    return op


_ELEMENTWISE: Dict[str, Callable] = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": _divide, "maximum": torch.maximum, "minimum": torch.minimum,
    "power": torch.pow,
    "and": _bitwise(torch.logical_and, torch.bitwise_and),
    "or": _bitwise(torch.logical_or, torch.bitwise_or),
    "negate": torch.neg, "abs": torch.abs, "exponential": torch.exp,
    "log": torch.log, "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
    "tanh": torch.tanh, "logistic": torch.sigmoid,
    "not": lambda a: (torch.logical_not(a) if a.dtype == torch.bool
                      else torch.bitwise_not(a)),
    "select": torch.where,
    "clamp": lambda lo, x, hi: torch.minimum(torch.maximum(x, lo), hi),
}
_COMPARE = {"EQ": torch.eq, "NE": torch.ne, "GE": torch.ge, "GT": torch.gt,
            "LE": torch.le, "LT": torch.lt}
_INT_OF = {torch.float16: torch.int16, torch.bfloat16: torch.int16,
           torch.float32: torch.int32, torch.float64: torch.int64}


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """Signed integers that order floats as IEEE 754's totalOrder does
    (-NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN): a ``compare`` of
    ``comparison_type`` TOTALORDER compares these."""
    if x.dtype not in _INT_OF:
        return x
    bits = _INT_OF[x.dtype]
    i = x.view(bits)
    width = torch.iinfo(bits).bits
    return i ^ ((i >> (width - 1)) & torch.iinfo(bits).max)


def _prod(x, dims_):
    """The product over ``dims_`` (torch.prod takes one dimension)."""
    keep = [d for d in range(x.dim()) if d not in dims_]
    x = x.permute(keep + list(dims_))
    return x.reshape([x.shape[i] for i in range(len(keep))] + [-1]).prod(-1)


# a reduction body's op -> (reduce over dims, combine two values)
_REDUCERS = {
    "add": (lambda x, d: x.sum(d), torch.add),
    "maximum": (lambda x, d: x.amax(d), torch.maximum),
    "minimum": (lambda x, d: x.amin(d), torch.minimum),
    "multiply": (_prod, torch.mul),
    "and": (lambda x, d: _each_dim(torch.all, x, d), _ELEMENTWISE["and"]),
    "or": (lambda x, d: _each_dim(torch.any, x, d), _ELEMENTWISE["or"]),
}


def _each_dim(fn, x, dims_):
    """``fn`` over each of ``dims_`` in turn (``all`` / ``any`` take one
    dimension)."""
    for d in sorted(dims_, reverse=True):
        x = fn(x, d)
    return x


def _interior(x: torch.Tensor, fill: torch.Tensor,
              interior: Sequence[int]) -> torch.Tensor:
    """``x`` with ``interior[d]`` copies of ``fill`` between neighbours
    along each dimension d."""
    if not any(interior):
        return x
    shape = [n + max(n - 1, 0) * k for n, k in zip(x.shape, interior)]
    out = fill.to(x.dtype).expand(shape).clone()
    out[tuple(slice(None, None, k + 1) for k in interior)] = x
    return out


def _edge(x: torch.Tensor, fill: torch.Tensor, low: Sequence[int],
          high: Sequence[int]) -> torch.Tensor:
    """``x`` padded with ``fill`` by ``low`` / ``high`` on each dimension,
    a negative amount cropping."""
    crop = tuple(slice(max(-lo, 0), n - max(-hi, 0))
                 for n, lo, hi in zip(x.shape, low, high))
    x = x[crop]
    if not any(lo > 0 or hi > 0 for lo, hi in zip(low, high)):
        return x
    shape = [n + max(lo, 0) + max(hi, 0)
             for n, lo, hi in zip(x.shape, low, high)]
    out = fill.to(x.dtype).expand(shape).clone()
    out[tuple(slice(max(lo, 0), max(lo, 0) + n)
              for n, lo in zip(x.shape, low))] = x
    return out


class _Func:
    """One function: its argument ids, and its body as steps."""

    def __init__(self, args: List[int], steps: list, results: List[int]):
        self.args, self.steps, self.results = args, steps, results


class Program:
    """A StableHLO module checked at load and run with torch on
    ``device``; ``program(*args)`` is ``main``'s results."""

    def __init__(self, data: bytes, device="cuda"):
        # the device as its tensors report it ("cuda" -> "cuda:0")
        self.device = torch.empty(0, device=device).device
        self.bc = vhlo.parse_module(data)
        self.producer = self.bc.producer
        self._func_ops = vhlo.functions(self.bc)
        if "main" not in self._func_ops:
            raise StableHLOError("the module (producer %s) has no main "
                                 "function: %s" % (self.producer,
                                                   sorted(self._func_ops)))
        self.funcs: Dict[str, _Func] = {}
        for name in self._func_ops:
            self.funcs[name] = self._compile_func(name)
        self.in_types = list(op_attr(self.bc, self._func_ops["main"],
                                     "function_type").inputs)

    # -- load --------------------------------------------------------------
    def _refuse(self, op: mb.Op, why: str):
        raise StableHLOError("%s (%s, producer %s): %s" % (
            stablehlo_name(op.name), op.name, self.producer, why))

    def _kind(self, op: mb.Op) -> str:
        dialect, _, vname = op.name.partition(".")
        base = vname.rsplit("_v", 1)[0]
        if dialect == "vhlo" and base == "custom_call":
            target = op_attr(self.bc, op, "call_target_name")
            raise StableHLOError(
                "custom_call to %r (producer %s): a custom call is code for "
                "one platform (a tpu_custom_call is a TPU Pallas kernel), "
                "which this interpreter does not run" % (target,
                                                         self.producer))
        if dialect != "vhlo" or base not in OPS:
            raise StableHLOError(
                "%s (%s, producer %s) is not an op this interpreter runs; "
                "it runs %s" % (stablehlo_name(op.name), op.name,
                                self.producer, " ".join(OPS)))
        vhlo.op_kind(self.bc, op)  # refuses a version it does not know
        return base

    def _compile_func(self, name: str) -> _Func:
        op = self._func_ops[name]
        region = op.regions[0] if op.regions else None
        if region is None or len(region.blocks) != 1:
            self._refuse(op, "function %s has %d blocks; one is run"
                         % (name, len(region.blocks) if region else 0))
        block = region.blocks[0]
        self._wide = self._widened(block)
        steps, results = self._compile_block(block)
        return _Func([v for v, _ in block.args], steps, results)

    def _widened(self, block: mb.Block) -> set:
        """The bfloat16 results that a ``convert`` to float32 reads, of ops
        that compute: they are kept in float32 beside their rounded value
        (XLA's float normalization)."""
        computed, read_wide = set(), set()

        def walk(ops):
            for op in ops:
                kind = self._kind(op)
                outs = self._out(op)
                if (kind not in _MOVES and len(outs) == 1
                        and outs[0].dtype == "bf16"):
                    computed.add(op.results[0])
                if kind == "convert" and outs[0].dtype == "f32":
                    read_wide.update(op.operands)
                for region in op.regions:
                    for b in region.blocks:
                        walk(b.ops)
        walk(block.ops)
        return computed & read_wide

    def _compile_block(self, block: mb.Block):
        steps, results = [], None
        for op in block.ops:
            kind = self._kind(op)
            if kind == "return":
                results = list(op.operands)
                continue
            operands, outs = list(op.operands), list(op.results)
            if kind == "convert":
                operands = [("f32", v) if v in self._wide else v
                            for v in operands]
            wide = bool(outs) and outs[0] in self._wide
            if wide:
                outs.append(("f32", outs[0]))
            steps.append((self._compile_op(op, kind, wide), operands, outs))
        if results is None:
            raise StableHLOError("a block (producer %s) without a return"
                                 % self.producer)
        return steps, results

    def _attr(self, op, name):
        return op_attr(self.bc, op, name)

    def _out(self, op) -> List[TensorType]:
        return vhlo.tensor_types(self.bc, op.result_types)

    def _dtype(self, t: TensorType) -> torch.dtype:
        if t.dtype not in vhlo.DTYPES:
            raise StableHLOError("element type %s (producer %s)"
                                 % (t.dtype, self.producer))
        return vhlo.DTYPES[t.dtype][0]

    def _compile_op(self, op: mb.Op, kind: str, wide=False) -> Callable:
        """``op`` as a step; ``wide``: computed in float32, returning its
        bfloat16 result and the float32 value."""
        run = self._step(op, kind, wide)
        if not wide:
            return run

        def widened(*xs):
            (y,) = run(*[x.float() if x.dtype == torch.bfloat16 else x
                         for x in xs])
            return [y.to(torch.bfloat16), y]
        return widened

    def _step(self, op: mb.Op, kind: str, wide: bool) -> Callable:
        if op.successors:
            self._refuse(op, "successors (branching between blocks)")
        outs = self._out(op)
        # the type a convolution or dot_general computes and returns
        dt = torch.float32 if wide else self._dtype(outs[0])
        if kind == "constant":
            value = self._attr(op, "value").to(self.device)
            return lambda: [value]
        if kind == "iota":
            (t,) = outs
            d = self._attr(op, "iota_dimension")
            shape = [1] * len(t.shape)
            shape[d] = t.shape[d]
            value = (torch.arange(t.shape[d], device=self.device)
                     .to(self._dtype(t)).reshape(shape).expand(t.shape)
                     .contiguous())
            return lambda: [value]
        if kind == "convert":
            dt = self._dtype(outs[0])
            return lambda x: [x.to(dt)]
        if kind == "reshape":
            shape = outs[0].shape
            return lambda x: [x.reshape(shape)]
        if kind == "broadcast_in_dim":
            return self._broadcast(op, outs[0])
        if kind == "transpose":
            perm = dims(self._attr(op, "permutation"))
            return lambda x: [x.permute(perm)]
        if kind == "reverse":
            rdims = dims(self._attr(op, "dimensions"))
            if not rdims:
                return lambda x: [x]
            return lambda x: [x.flip(rdims)]
        if kind == "slice":
            idx = tuple(slice(a, b, c) for a, b, c in zip(
                dims(self._attr(op, "start_indices")),
                dims(self._attr(op, "limit_indices")),
                dims(self._attr(op, "strides"))))
            return lambda x: [x[idx]]
        if kind == "concatenate":
            d = self._attr(op, "dimension")
            return lambda *xs: [torch.cat(xs, d)]
        if kind == "pad":
            low = dims(self._attr(op, "edge_padding_low"))
            high = dims(self._attr(op, "edge_padding_high"))
            inner = dims(self._attr(op, "interior_padding"))
            return lambda x, v: [_edge(_interior(x, v, inner), v, low, high)]
        if kind == "compare":
            fn = _COMPARE[self._attr(op, "comparison_direction").value]
            if self._attr(op, "compare_type").value == "TOTALORDER":
                return lambda a, b: [fn(total_order_key(a),
                                        total_order_key(b))]
            return lambda a, b: [fn(a, b)]
        if kind in _ELEMENTWISE:
            fn = _ELEMENTWISE[kind]
            return lambda *xs: [fn(*xs)]
        if kind == "dot_general":
            return self._dot_general(op, outs[0].shape, dt)
        if kind == "convolution":
            return self._convolution(op, dt)
        if kind in ("reduce", "reduce_window"):
            if len(op.operands) != 2:
                self._refuse(op, "%d operands and body %s; one operand is "
                             "run" % (len(op.operands) // 2,
                                      _body_ops(op)))
            body = self._body(op)
            if kind == "reduce":
                return self._reduce(op, body)
            return self._reduce_window(op, body)
        if kind == "case":
            branches = []
            for region in op.regions:
                if len(region.blocks) != 1 or region.blocks[0].args:
                    self._refuse(op, "a branch of %d blocks with arguments"
                                 % len(region.blocks))
                branches.append(self._compile_block(region.blocks[0]))
            return ("case", branches)
        if kind == "call":
            callee = self._attr(op, "callee")
            if callee not in self._func_ops:
                self._refuse(op, "calls %s, which the module does not hold"
                             % callee)
            return ("call", callee)
        raise AssertionError(kind)  # every kind of OPS is handled above

    def _broadcast(self, op, out: TensorType):
        bdims = dims(self._attr(op, "broadcast_dimensions"))
        order = sorted(range(len(bdims)), key=lambda i: bdims[i])
        shape = list(out.shape)

        def run(x):
            if order != list(range(len(order))):
                x = x.permute(order)
            view = [1] * len(shape)
            for i, d in enumerate(sorted(bdims)):
                view[d] = x.shape[i]
            return [x.reshape(view).expand(shape)]
        return run

    def _dot_general(self, op, shape, dt: torch.dtype):
        lb = dims(self._attr(op, "lhs_batching_dimensions"))
        rb = dims(self._attr(op, "rhs_batching_dimensions"))
        lc = dims(self._attr(op, "lhs_contracting_dimensions"))
        rc = dims(self._attr(op, "rhs_contracting_dimensions"))
        shape = list(shape)

        def run(a, b):
            la = [d for d in range(a.dim()) if d not in lb + lc]
            ra = [d for d in range(b.dim()) if d not in rb + rc]
            nb = math.prod(a.shape[d] for d in lb)
            k = math.prod(a.shape[d] for d in lc)
            m = math.prod(a.shape[d] for d in la)
            n = math.prod(b.shape[d] for d in ra)
            cdt = dt if dt.is_floating_point else torch.float64
            a2 = a.permute(lb + la + lc).reshape(nb, m, k).to(cdt)
            b2 = b.permute(rb + rc + ra).reshape(nb, k, n).to(cdt)
            return [torch.matmul(a2, b2).to(dt).reshape(shape)]
        return run

    def _convolution(self, op, dt: torch.dtype):
        a = {n: self._attr(op, n) for n in vhlo.OP_ATTRS["convolution_v1"]}
        spatial = dims(a["input_spatial_dimensions"])
        if len(spatial) != 2:
            self._refuse(op, "%d spatial dimensions; two are run"
                         % len(spatial))
        if a["batch_group_count"] != 1:
            self._refuse(op, "batch_group_count %d; 1 is run"
                         % a["batch_group_count"])
        in_perm = [a["input_batch_dimension"],
                   a["input_feature_dimension"]] + spatial
        k_perm = [a["kernel_output_feature_dimension"],
                  a["kernel_input_feature_dimension"]] + dims(
                      a["kernel_spatial_dimensions"])
        o_order = [a["output_batch_dimension"],
                   a["output_feature_dimension"]] + dims(
                       a["output_spatial_dimensions"])
        o_perm = [o_order.index(d) for d in range(len(o_order))]
        strides = dims(a["window_strides"])
        pad = [tuple(p) for p in a["padding"].reshape(-1, 2).tolist()]
        lhs_dil = dims(a["lhs_dilation"])
        rhs_dil = dims(a["rhs_dilation"])
        flip = [i + 2 for i, r in enumerate(a["window_reversal"].tolist())
                if r]
        groups = a["feature_group_count"]
        # symmetric padding without lhs dilation is conv2d's own
        native = all(d == 1 for d in lhs_dil) and all(
            lo == hi >= 0 for lo, hi in pad)

        def run(x, w):
            x = x.permute(in_perm).to(dt)
            w = w.permute(k_perm).to(dt)
            if flip:
                w = w.flip(flip)
            if native:
                y = F.conv2d(x, w, stride=strides, padding=[p[0] for p in pad],
                             dilation=rhs_dil, groups=groups)
                return [y.permute(o_perm)]
            zero = x.new_zeros(())
            x = _interior(x, zero, [0, 0] + [d - 1 for d in lhs_dil])
            x = _edge(x, zero, [0, 0] + [p[0] for p in pad],
                      [0, 0] + [p[1] for p in pad])
            y = F.conv2d(x, w, stride=strides, dilation=rhs_dil,
                         groups=groups)
            return [y.permute(o_perm)]
        return run

    def _body(self, op) -> str:
        """The one op of a reduction body, checked."""
        region = op.regions[0] if len(op.regions) == 1 else None
        ops = region.blocks[0].ops if region and len(region.blocks) == 1 \
            else []
        if len(ops) == 2 and ops[1].name == "vhlo.return_v1":
            body, ret = ops
            args = [v for v, _ in region.blocks[0].args]
            base = body.name.partition(".")[2].rsplit("_v", 1)[0]
            if (base in _REDUCERS and body.operands == args
                    and ret.operands == body.results):
                return base
        self._refuse(op, "a body of %s; one of %s of its two arguments is "
                     "run" % (_body_ops(op), ", ".join(_REDUCERS)))

    def _reduce(self, op, body: str):
        red, comb = _REDUCERS[body]
        rdims = dims(self._attr(op, "dimensions"))

        def run(x, init):
            y = red(x, rdims) if rdims else x
            return [comb(y, init).to(x.dtype)]
        return run

    def _reduce_window(self, op, body: str):
        red, comb = _REDUCERS[body]
        window = dims(self._attr(op, "window_dimensions"))
        strides = dims(self._attr(op, "window_strides"))
        base = dims(self._attr(op, "base_dilations"))
        wdil = dims(self._attr(op, "window_dilations"))
        pad = self._attr(op, "padding").reshape(-1, 2).tolist()
        rank = len(window)

        def run(x, init):
            x = _interior(x, init, [b - 1 for b in base])
            x = _edge(x, init, [p[0] for p in pad], [p[1] for p in pad])
            for d in range(rank):
                span = (window[d] - 1) * wdil[d] + 1
                x = x.unfold(d, span, strides[d])
                if wdil[d] > 1:
                    x = x[..., ::wdil[d]]
            y = red(x, list(range(rank, 2 * rank)))
            return [comb(y, init).to(init.dtype)]
        return run

    # -- run ---------------------------------------------------------------
    def __call__(self, *args: torch.Tensor) -> List[torch.Tensor]:
        if len(args) != len(self.in_types):
            raise ValueError("main takes %d arguments, got %d"
                             % (len(self.in_types), len(args)))
        for i, (x, t) in enumerate(zip(args, self.in_types)):
            if tuple(x.shape) != tuple(t.shape) or x.dtype != self._dtype(t):
                raise ValueError("argument %d of main is %s, got %s %s"
                                 % (i, t, x.dtype, tuple(x.shape)))
            if x.device != self.device:
                raise ValueError("argument %d is on %s; the program runs on "
                                 "%s" % (i, x.device, self.device))
        return self._call("main", list(args))

    def _call(self, name: str, args: List[torch.Tensor]):
        fn = self.funcs[name]
        env = dict(zip(fn.args, args))
        self._run(fn.steps, env)
        return [env[v] for v in fn.results]

    def _run(self, steps, env):
        for step, operands, results in steps:
            xs = [env[v] for v in operands]
            if isinstance(step, tuple):
                if step[0] == "call":
                    ys = self._call(step[1], xs)
                else:  # case
                    branches = step[1]
                    i = int(xs[0])
                    if not 0 <= i < len(branches):
                        i = len(branches) - 1
                    b_steps, b_results = branches[i]
                    self._run(b_steps, env)
                    ys = [env[v] for v in b_results]
            else:
                ys = step(*xs)
            for v, y in zip(results, ys):
                env[v] = y


def stablehlo_name(vname: str) -> str:
    """``vhlo.add_v1`` -> ``stablehlo.add``."""
    dialect, _, name = vname.partition(".")
    base = name.rsplit("_v", 1)[0]
    if dialect != "vhlo":
        return vname
    if base in ("func", "call", "return"):
        return "func." + base
    return "stablehlo." + base


def _body_ops(op: mb.Op) -> List[str]:
    return [stablehlo_name(o.name) for r in op.regions for b in r.blocks
            for o in b.ops]
