"""The port's ``--fid_extractor``: ``jax.export`` artifacts read without JAX
(``utils/jax_export.py``, ``utils/mlir_bytecode.py``, ``utils/vhlo.py``) and
run by the StableHLO interpreter (``eval/stablehlo.py``) through
``eval/fid.py::load_extractor``, against JAX on the same artifacts.

The artifacts are ``tests/fixtures/jax_export/``, written by
``tests/fixtures/make_jax_export_fixtures.py`` from the JAX package's own
``save_extractor`` and its lines.  Each artifact's ``exp.call`` output on
numpy-seeded inputs is computed once per test session (one JAX compile
each, shared by the workers); the ``tpu`` artifacts run there with their
platform set to ``cpu``, which their StableHLO (no custom call) allows.
An artifact of several platforms none of which is ``cuda`` (``cpu_tpu``)
runs its first platform's lowering.

Tolerances: the interpreted outputs agree with ``exp.call`` within
1e-5 x max|output| (the same float32 ops in another order), the bfloat16 /
float16 function of ``ops_tiny`` too: the interpreter rounds a bfloat16
chain where XLA's float normalization does (``eval/stablehlo.py``).  FID
through both packages' ``load_extractor`` agrees within 1e-4 relative.
"""

import dataclasses
import os
import re
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import export as jax_export

from domain_transfer_gan_tpu.eval import fid as jax_fid
from domain_transfer_gan_torch.eval import fid, stablehlo
from domain_transfer_gan_torch.eval.stablehlo import Program, StableHLOError
from domain_transfer_gan_torch.utils import jax_export as J
from domain_transfer_gan_torch.utils import vhlo

from torch_port_helpers import once
from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "jax_export")
PROXY = os.path.join(FIXTURES, "proxy_w64_64x64x3.jaxexp")
TAKEN = ["proxy_w64_64x64x3", "inception_tiny_tpu", "ops_tiny_tpu",
         "ops_tiny_cuda_tpu", "logistic_tpu", "x64_tpu", "cpu_tpu"]
ALL = TAKEN + ["sine_tpu", "argmax_tpu", "custom_call_tpu", "two_devices"]


def _path(name):
    return os.path.join(FIXTURES, name + ".jaxexp")


def _bytes(name):
    with open(_path(name), "rb") as f:
        return f.read()


def _on_cpu(exp):
    """``exp`` runnable by this CPU jax: its first platform named cpu."""
    return dataclasses.replace(exp, platforms=("cpu",) + exp.platforms[1:])


def _input(name):
    shape = J.read(_bytes(name)).in_avals[0].shape
    return np.random.RandomState(15).randn(*shape).astype(np.float32)


def _jax_outputs():
    out = {}
    for name in TAKEN:
        if name == "ops_tiny_cuda_tpu":
            continue  # the same function as ops_tiny_tpu
        exp = _on_cpu(jax_export.deserialize(_bytes(name)))
        out[name] = np.asarray(exp.call(jnp.asarray(_input(name))))
    out["ops_tiny_cuda_tpu"] = out["ops_tiny_tpu"]
    rng = np.random.RandomState(16)
    real = rng.uniform(-1, 1, (70, 64, 64, 3)).astype(np.float32)
    fake = np.clip(real + 0.3 * rng.randn(*real.shape), -1, 1).astype(
        np.float32)
    ext = jax_fid.load_extractor(PROXY)
    out["fid"] = (real, fake, ext(real), jax_fid.compute_fid(real, fake,
                                                             ext))
    return out


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    return once(tmp_path_factory, "jax_export_outputs", _jax_outputs)


def _program(name):
    exp = J.check_extractor(J.check(J.read(_bytes(name))))
    return exp, Program(exp.mlir_module_serialized, device="cpu")


def _run(name):
    exp, prog = _program(name)
    args = [torch.from_numpy(_input(name))]
    if exp.platform_index is not None:
        args.insert(0, torch.tensor(exp.platform_index, dtype=torch.int32))
    return prog(*args)[0].numpy()


@pytest.mark.parametrize("name", ALL)
def test_envelope_fields_match_jax(name):
    data = _bytes(name)
    got, want = J.read(data), jax_export.deserialize(data)
    assert got.function_name == want.fun_name
    assert "PyTreeDef(%s)" % got.in_tree == str(want.in_tree)
    assert "PyTreeDef(%s)" % got.out_tree == str(want.out_tree)
    for mine, theirs in ((got.in_avals, want.in_avals),
                         (got.out_avals, want.out_avals)):
        assert [(a.shape, a.dtype) for a in mine] == [
            (tuple(b.shape), {"float32": "f32"}[b.dtype.name])
            for b in theirs]
    assert got.platforms == tuple(want.platforms)
    assert got.nr_devices == want.nr_devices
    assert got.ordered_effects == got.unordered_effects == ()
    assert len(want.ordered_effects) == len(want.unordered_effects) == 0
    assert got.calling_convention_version == \
        want.calling_convention_version
    assert got.module_kept_var_idx == tuple(want.module_kept_var_idx)
    assert got.uses_global_constants == want.uses_global_constants
    assert got.disabled_checks == tuple(
        str(c).replace(":", "(") + (")" if ":" in str(c) else "")
        for c in want.disabled_safety_checks)
    assert got.mlir_module_serialized == want.mlir_module_serialized
    assert got.serialization_version in J.SERIALIZATION_VERSIONS


def _generic_ops(exp):
    """Each function's ops in jax's own printing of the module, in generic
    form (nested regions' ops after their op), by function name."""
    from jax._src.interpreters import mlir
    from jax._src.lib.mlir import ir

    with mlir.make_ir_context():
        text = ir.Module.parse(exp.mlir_module()).operation.get_asm(
            print_generic_op_form=True, enable_debug_info=False)
    funcs, cur = {}, None
    for line in text.splitlines():
        for op in re.findall(r'"([a-z_]+\.[a-z_]+)"\(', line):
            if op == "func.func":
                cur = re.search(r'sym_name = "([^"]+)"', line).group(1)
                funcs[cur] = []
            elif op != "builtin.module":
                funcs[cur].append(op)
    return funcs


def _op_sequence(func):
    """The StableHLO names of a parsed function's ops in order, nested
    regions' ops after their op."""
    out = []

    def walk(ops):
        for op in ops:
            out.append(stablehlo.stablehlo_name(op.name))
            for r in op.regions:
                for b in r.blocks:
                    walk(b.ops)

    for b in func.regions[0].blocks:
        walk(b.ops)
    return out


def _norm(ops):
    return ["return" if o.endswith(".return") else o for o in ops]


@pytest.mark.parametrize("name", TAKEN + ["sine_tpu", "argmax_tpu",
                                          "custom_call_tpu"])
def test_parsed_op_sequence_matches_jax_text(name):
    data = _bytes(name)
    bc = vhlo.parse_module(J.read(data).mlir_module_serialized)
    want = _generic_ops(jax_export.deserialize(data))
    got = {n: _op_sequence(op) for n, op in vhlo.functions(bc).items()}
    assert sorted(got) == sorted(want)
    for n in want:
        assert _norm(got[n]) == _norm(want[n]), n


def test_proxy_constants_are_fid_weights_bit_for_bit():
    """The width-64 artifact's kernels are fid_weights.npz's conv0 (C = 3)
    to conv3: the weights the port's built-in extractor uses."""
    _, prog = _program("proxy_w64_64x64x3")
    consts = [op_const for op_const in _constants(prog)
              if op_const.dim() == 4]
    stored = fid._stored()
    want = [stored["conv0/kernel/c3"]] + [stored["conv%d/kernel" % i]
                                          for i in (1, 2, 3)]
    by_shape = {tuple(c.shape): c.numpy() for c in consts}
    assert sorted(by_shape) == sorted(tuple(w.shape) for w in want)
    for w in want:
        got = by_shape[tuple(w.shape)]
        assert got.dtype == w.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), w.view(np.uint32))


def _constants(prog):
    bc = prog.bc
    out = []

    def walk(ops):
        for op in ops:
            if op.name == "vhlo.constant_v1":
                out.append(vhlo.op_attr(bc, op, "value"))
            for r in op.regions:
                for b in r.blocks:
                    walk(b.ops)

    for f in vhlo.functions(bc).values():
        walk([f])
    return out


@pytest.mark.parametrize("name", TAKEN)
def test_interpreted_outputs_match_exp_call(jax_out, name):
    want = jax_out[name]
    got = _run(name)
    assert got.shape == want.shape and got.dtype == want.dtype
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    tol = np.full(want.shape, 1e-5 * np.abs(want[fin]).max())
    err = np.abs(np.where(fin, got, 0) - np.where(fin, want, 0))
    assert (err <= tol).all(), float((err - tol).max())


def test_compute_fid_through_both_load_extractors(jax_out):
    real, fake, want_f, want = jax_out["fid"]
    ext = fid.load_extractor(PROXY, device="cpu")
    got_f = ext(real)  # 70 images: a chunk of 64 and one padded
    assert got_f.shape == want_f.shape == (70, 256)
    assert np.abs(got_f - want_f).max() <= 1e-5 * np.abs(want_f).max()
    got = fid.compute_fid(real, fake, ext)
    assert abs(got - want) <= 1e-4 * abs(want)
    # the same weights as the built-in extractor: FID_B == PROXY_FID_B
    builtin = fid.random_feature_extractor(device="cpu")
    assert np.abs(builtin(real) - got_f).max() <= 1e-5 * np.abs(
        got_f).max()
    proxy = fid.compute_fid(real, fake, builtin)
    assert abs(proxy - got) <= 1e-4 * abs(got)
    # torch tensors too, and any N
    t = ext(torch.from_numpy(real[:3]))
    assert np.abs(t - got_f[:3]).max() <= 1e-5 * np.abs(want_f).max()


def _patched(name, field_slot, fmt, value):
    """The artifact with one scalar field of its Exported table
    rewritten."""
    data = bytearray(_bytes(name))
    root = J._Table(bytes(data), struct.unpack_from("<I", data, 0)[0])
    pos = root._field(field_slot)
    assert pos, field_slot
    struct.pack_into("<" + fmt, data, pos, value)
    return bytes(data)


def _no_platforms(name):
    """The artifact with its platforms vector emptied."""
    data = bytearray(_bytes(name))
    root = J._Table(bytes(data), struct.unpack_from("<I", data, 0)[0])
    pos = root._ref(9)
    assert pos and struct.unpack_from("<I", data, pos)[0] == 2
    struct.pack_into("<I", data, pos, 0)
    return bytes(data)


def _replaced(name, old, new):
    data = _bytes(name)
    assert data.count(old) == 1 and len(old) == len(new)
    return data.replace(old, new)


class _Effect(jax._src.effects.Effect):
    """An effect jax can serialize (a nullary constructor)."""

    def __eq__(self, other):
        return type(other) is _Effect

    def __hash__(self):
        return 15


def _with_effects():
    exp = jax_export.deserialize(_bytes("logistic_tpu"))
    return dataclasses.replace(exp, ordered_effects=(_Effect(),)).serialize()


def _two_args():
    spec = jax.ShapeDtypeStruct((2, 3), jnp.float32)
    return jax_export.export(jax.jit(lambda a, b: a + b),
                             platforms=("tpu",))(spec, spec).serialize()


def _conv(**kw):
    """A tpu export of one convolution the interpreter refuses."""
    from jax import lax

    rank = kw.pop("rank", 2)
    lhs = jax.ShapeDtypeStruct((2, 4) + (6,) * rank, jnp.float32)
    w = jnp.ones((4, 4 // kw.get("feature_group_count", 1)) + (3,) * rank,
                 jnp.float32)
    if "batch_group_count" in kw:
        w = jnp.ones((4, 4) + (3,) * rank, jnp.float32)
    fn = lambda x: lax.conv_general_dilated(  # noqa: E731
        x, w, (1,) * rank, "SAME", **kw)
    return jax_export.export(jax.jit(fn), platforms=("tpu",))(
        lhs).serialize()


# (artifact bytes, the error, what its message must name)
REFUSALS = {
    "unknown_op": (lambda: _bytes("sine_tpu"), StableHLOError,
                   ["stablehlo.sine", "vhlo.sine_v2"]),
    "custom_call": (lambda: _bytes("custom_call_tpu"), StableHLOError,
                    ["custom_call", "'tpu_custom_call_fixture'"]),
    "platforms": (lambda: _no_platforms("cpu_tpu"), J.ExportFormatError,
                  ["platforms = []", "no platform"]),
    "nr_devices": (lambda: _bytes("two_devices"), J.ExportFormatError,
                   ["nr_devices = 2"]),
    "reduce_body": (lambda: _bytes("argmax_tpu"), StableHLOError,
                    ["stablehlo.reduce", "stablehlo.select",
                     "stablehlo.compare"]),
    "effects": (_with_effects, J.ExportFormatError, ["ordered_effects"]),
    "in_tree": (_two_args, J.ExportFormatError,
                ["in_tree = ((*, *), {})"]),
    "serialization_version": (
        lambda: _patched("logistic_tpu", 0, "H", 99), J.ExportFormatError,
        ["serialization_version = 99"]),
    "calling_convention": (
        lambda: _patched("logistic_tpu", 14, "H", 7), J.ExportFormatError,
        ["calling_convention_version = 7"]),
    "op_version": (
        lambda: _replaced("logistic_tpu", b"logistic_v2", b"logistic_v9"),
        vhlo.VhloError, ["vhlo.logistic_v9", "vhlo.logistic_v2",
                         "StableHLO_v1.13"]),
    "conv_1d": (lambda: _conv(rank=1), StableHLOError,
                ["stablehlo.convolution", "1 spatial dimensions"]),
    "conv_3d": (lambda: _conv(rank=3), StableHLOError,
                ["stablehlo.convolution", "3 spatial dimensions"]),
    "batch_group_count": (lambda: _conv(batch_group_count=2),
                          StableHLOError,
                          ["stablehlo.convolution", "batch_group_count 2"]),
    "producer": (
        lambda: _replaced("logistic_tpu", b"StableHLO_v1.13",
                          b"StableHLO_v1.99"),
        vhlo.VhloError, ["StableHLO_v1.99"]),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refused_at_load_by_name(case, tmp_path):
    make, error, named = REFUSALS[case]
    path = str(tmp_path / (case + ".jaxexp"))
    with open(path, "wb") as f:
        f.write(make())
    with pytest.raises(error) as e:
        fid.load_extractor(path, device="cpu")
    for n in named:
        assert n in str(e.value), (n, str(e.value))


def test_totalorder_compare_orders_floats_as_ieee_total_order():
    """-NaN < -inf < -1.5 < -0 < +0 < 1 < inf < +NaN in every float type
    (the NaNs made from their bits: conversions may drop a NaN's sign)."""
    nans = {torch.float32: (torch.int32, 0x7FC00000),
            torch.float64: (torch.int64, 0x7FF8000000000000),
            torch.float16: (torch.int16, 0x7E00),
            torch.bfloat16: (torch.int16, 0x7FC0)}
    for dtype, (bits, nan) in nans.items():
        width = torch.iinfo(bits).bits
        sign = -(1 << (width - 1))
        mid = torch.tensor([float("-inf"), -1.5, -0.0, 0.0, 1.0,
                            float("inf")]).to(dtype)
        x = torch.cat([torch.tensor([sign | nan], dtype=bits).view(dtype),
                       mid, torch.tensor([nan], dtype=bits).view(dtype)])
        keys = stablehlo.total_order_key(x)
        assert bool((keys[1:] > keys[:-1]).all()), dtype


def test_a_wrong_image_shape_raises_jaxs_message():
    images = np.zeros((3, 64, 64, 3), np.float32)
    path = _path("inception_tiny_tpu")
    with pytest.raises(ValueError) as want:
        jax_fid.load_extractor(path)(images)
    ext = fid.load_extractor(path, device="cpu")
    with pytest.raises(ValueError) as got:
        ext(images)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        ext(torch.from_numpy(images))
    assert str(got.value) == str(want.value)


def test_the_extractor_asks_for_the_card_and_does_not_fall_back():
    """Without a device the extractor is built on CUDA; here, with no card,
    building it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        fid.load_extractor(PROXY)
    exp, prog = _program("logistic_tpu")
    with pytest.raises(ValueError, match="is on cpu; the program runs on "
                       "meta"):
        Program(exp.mlir_module_serialized, device="meta")(
            torch.zeros(2, 3))
