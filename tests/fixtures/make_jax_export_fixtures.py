"""Regenerate ``tests/fixtures/jax_export/``: ``jax.export`` artifacts that
the port's ``--fid_extractor`` reader is held to.

- ``proxy_w64_64x64x3.jaxexp``: the JAX package's own ``save_extractor``
  of its random-feature net (``_RandomFeatureNet(64)``, ``PRNGKey(1234)``)
  at sample shape (64, 64, 3) and batch 64, lowered for the default
  platform here (``cpu``): the weights of ``eval/fid_weights.npz``'s
  ``conv0`` (C = 3) to ``conv3``;
- ``inception_tiny_tpu.jaxexp``: an Inception-shaped flax net at narrow
  widths (bilinear resize, strided VALID conv, inference batch norm, ReLU,
  1×1 conv, max and average pools with SAME padding, a grouped conv,
  concatenate, mean, dense, tanh, sigmoid, gelu), lowered for ``tpu`` by
  ``save_extractor``'s own lines;
- ``ops_tiny_tpu.jaxexp``: small functions that, with the net, emit every
  op of the interpreter's set (each called as a private function), lowered
  for ``tpu``; ``ops_tiny_cuda_tpu.jaxexp`` the same for ``("cuda",
  "tpu")``, which takes the ``_platform_index`` argument;
  ``logistic_tpu.jaxexp`` the one op of the set that jax never emits
  (:func:`logistic_export`); ``x64_tpu.jaxexp`` float64 and int64
  (:func:`x64_tiny`); ``cpu_tpu.jaxexp`` two platforms, neither ``cuda``
  (the first one's lowering runs);
- refused: ``custom_call_tpu.jaxexp`` (a ``custom_call`` to
  ``tpu_custom_call_fixture``, exported with that safety check disabled),
  ``two_devices.jaxexp`` (``nr_devices`` 2, over two CPU devices),
  ``sine_tpu.jaxexp`` (an op outside the set) and ``argmax_tpu.jaxexp``
  (a ``reduce`` whose body is not one op).

Every module is written without locations (:func:`with_module`), so no
source path of the machine that made it is kept.  The script prints each
module's op set (``exp.mlir_module()``) and
asserts that the artifacts taken cover the interpreter's set.

    python tests/fixtures/make_jax_export_fixtures.py
"""

import os
import re
import sys

# two host devices for the nr_devices = 2 artifact; set before jax starts
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
os.environ["JAX_PLATFORMS"] = "cpu"

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "jax_export")
SEED = 15

# the ops the port's interpreter runs (eval/stablehlo.py), by StableHLO name
OP_SET = {
    "constant", "iota", "convert", "reshape", "broadcast_in_dim",
    "transpose", "reverse", "slice", "concatenate", "pad", "select",
    "compare", "add", "subtract", "multiply", "divide", "maximum", "minimum",
    "negate", "abs", "and", "or", "not", "exponential", "log", "sqrt", "rsqrt", "tanh",
    "logistic", "power", "clamp", "dot_general", "convolution", "reduce",
    "reduce_window", "case", "call", "return"}


def op_set(exp):
    """The StableHLO / func ops of an export's module, by short name."""
    text = exp.mlir_module()
    ops = set(re.findall(r"\bstablehlo\.([a-z_]+)", text))
    ops |= set(re.findall(r"(?:=|^)\s*(call|return)\b", text, re.M))
    ops |= {m for m in re.findall(r"^\s*(?:%\S+ = )?(call|return)\b", text,
                                  re.M)}
    return ops


def inception_tiny():
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    class Net(nn.Module):
        @nn.compact
        def __call__(self, x):
            n = x.shape[0]
            x = jax.image.resize(x, (n, 24, 24, x.shape[-1]), "bilinear")
            x = nn.Conv(8, (3, 3), strides=(2, 2), padding="VALID")(x)
            x = nn.BatchNorm(use_running_average=True)(x)
            x = nn.relu(x)
            b1 = nn.relu(nn.Conv(4, (1, 1))(x))
            b2 = nn.max_pool(x, (3, 3), strides=(1, 1), padding="SAME")
            b3 = nn.avg_pool(x, (3, 3), strides=(1, 1), padding="SAME",
                             count_include_pad=False)
            b4 = nn.Conv(8, (3, 3), padding="SAME", feature_group_count=2)(x)
            x = jnp.concatenate([b1, b2, b3, b4], axis=-1)
            x = nn.max_pool(x, (2, 2), strides=(2, 2))
            x = jnp.mean(x, axis=(1, 2))
            x = nn.Dense(16)(x)
            return jnp.concatenate([jnp.tanh(x), nn.sigmoid(x), nn.gelu(x)],
                                   axis=-1)

    return Net()


def ops_tiny(x):
    """(2, 6, 6, 3) f32 -> (2, D) f32 through every op the net leaves out."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    @jax.jit
    def elementwise(x):
        a = jnp.abs(x) + 0.5
        y = jnp.log(a) + jnp.sqrt(a) - lax.rsqrt(a) + jnp.exp(-a)
        y = y + jnp.power(a, x) + jax.nn.sigmoid(x) * jnp.tanh(x)
        y = jnp.maximum(y, -x) - jnp.minimum(y, 2 * x) / (a + 1.0)
        y = lax.clamp(-2.0, y, 3.0) + lax.clamp(-x, y, x + 1)
        m = (x > 0.1) | (x < -0.7)
        m = m & ~(x > 1.0)
        return jnp.where(m, y, -y)

    @jax.jit
    def integers(x):
        i = (x * 7).astype(jnp.int32)
        j = lax.div(i, 3) + i * 2 - (i & 5) | 8
        u = (jnp.abs(x) * 40).astype(jnp.uint8)
        v = lax.div(~u, jnp.uint8(3)) + (u > 20).astype(jnp.uint8)
        k = jnp.where(i > j, i, -j).astype(jnp.int8)
        bits = jnp.asarray(np.array([1, 0, 0, 1, 1, 0, 1, 0, 1, 1, 1] * 2,
                                    bool)[:18].reshape(1, 1, 6, 3))
        b = bits != (x > 0)
        return (j.astype(jnp.float32) + v.astype(jnp.float32)
                + k.astype(jnp.float32) + b.astype(jnp.float32))

    @jax.jit
    def low_precision(x):
        h = x.astype(jnp.bfloat16) * jnp.bfloat16(1.5) + jnp.bfloat16(0.25)
        f = x.astype(jnp.float16) * jnp.float16(-0.75)
        return h.astype(jnp.float32) + f.astype(jnp.float32)

    @jax.jit
    def shapes(x):
        t = lax.slice(jnp.transpose(x, (0, 3, 1, 2)), (0, 0, 1, 1),
                      (x.shape[0], 3, 6, 6), (1, 1, 2, 1))
        p = lax.pad(t, jnp.float32(0.5), ((0, 0, 0), (1, -1, 0),
                                          (2, 1, 1), (0, 1, 0)))
        q = jnp.reshape(p, (x.shape[0], -1))[:, :60]
        k = jnp.broadcast_to(jnp.arange(4, dtype=jnp.float32),
                             (x.shape[0], 4))
        return jnp.concatenate([q, k], axis=1)

    @jax.jit
    def reductions(x):
        return jnp.concatenate([
            jnp.min(x, axis=(1, 2)), jnp.prod(1 + 0.1 * x, axis=(1, 3)),
            jnp.all(x > -1.5, axis=(1, 2)).astype(jnp.float32),
            jnp.any(x > 1.2, axis=(2, 3))[:, :3].astype(jnp.float32),
            lax.reduce_window(x, -jnp.inf, lax.max, (1, 3, 2, 1),
                              (1, 2, 1, 1), ((0, 0), (1, 1), (0, 1), (0, 0)),
                              base_dilation=(1, 1, 2, 1),
                              window_dilation=(1, 1, 2, 1)
                              ).reshape(x.shape[0], -1)[:, :20],
            lax.reduce_window(x, jnp.inf, lax.min, (1, 2, 2, 1),
                              (1, 1, 2, 1), "VALID").reshape(
                                  x.shape[0], -1)[:, :20],
            lax.reduce_window(x, 0.0, lax.add, (1, 2, 3, 3),
                              (1, 2, 2, 1), "SAME").reshape(
                                  x.shape[0], -1)[:, :20],
        ], axis=1)

    @jax.jit
    def linear(x):
        a = x.reshape(x.shape[0], 12, 9)
        bmm = jnp.einsum("bij,bkj->bik", a, a[:, :5] * 0.1,
                         precision=lax.Precision.HIGHEST)
        w = jnp.asarray(np.linspace(-1, 1, 3 * 4 * 2 * 2, dtype=np.float32)
                        .reshape(4, 3, 2, 2))
        nchw = jnp.transpose(x, (0, 3, 1, 2))
        c1 = lax.conv_general_dilated(nchw, w, (1, 2), ((1, 0), (2, 1)),
                                      lhs_dilation=(2, 1),
                                      rhs_dilation=(1, 2),
                                      dimension_numbers=("NCHW", "OIHW",
                                                         "NCHW"))
        wg = jnp.asarray(np.linspace(-0.5, 0.7, 2 * 3 * 1 * 6,
                                     dtype=np.float32).reshape(2, 3, 1, 6))
        c2 = lax.conv_general_dilated(x, wg, (2, 1), "SAME",
                                      dimension_numbers=("NHWC", "HWIO",
                                                         "NHWC"),
                                      feature_group_count=3)
        return jnp.concatenate([bmm.reshape(x.shape[0], -1),
                                c1.reshape(x.shape[0], -1),
                                c2.reshape(x.shape[0], -1)], axis=1)

    @jax.jit
    def flips(x):
        n = x.shape[0]
        return jnp.concatenate([jnp.flip(x, axis=(1, 2)).reshape(n, -1),
                                lax.rev(x, (0, 3)).reshape(n, -1)[:, :20]],
                               axis=1)

    @jax.jit
    def branches(x):
        s = jnp.sum(x > 0).astype(jnp.int32)
        i = (s > 30).astype(jnp.int32) + (s > 40).astype(jnp.int32)
        y = lax.switch(i, [lambda v: v * 2.0, lambda v: v - 1.0,
                           lambda v: jnp.tanh(v)], x)
        return lax.cond(jnp.mean(x) > 0, lambda v: v + 1.0,
                        lambda v: v * 0.5, y)

    n = x.shape[0]
    parts = [elementwise(x), integers(x), low_precision(x), shapes(x),
             reductions(x), linear(x), branches(x), flips(x)]
    return jnp.concatenate([p.reshape(n, -1) for p in parts], axis=1)


def x64_tiny(x):
    """(2, 5) f32 -> (2, 5) f32 through float64 and int64 (traced with
    ``jax.enable_x64``)."""
    import jax.numpy as jnp
    from jax import lax

    d = x.astype(jnp.float64) * 1.25 + jnp.float64(1e-3)
    i = (x * 1000).astype(jnp.int64) * jnp.int64(3_000_000_000)
    i = lax.div(i, jnp.int64(7))
    return (jnp.tanh(d) + i.astype(jnp.float64) * 1e-12).astype(
        jnp.float32)


def with_module(exp, text):
    """``exp`` with its module replaced by StableHLO ``text``, printed
    without locations and serialized by jax's own lines."""
    import dataclasses

    from jax._src.export import _export
    from jax._src.interpreters import mlir
    from jax._src.lib.mlir import ir

    with mlir.make_ir_context():
        module = ir.Module.parse(text)
        module = ir.Module.parse(
            module.operation.get_asm(enable_debug_info=False))
        return dataclasses.replace(
            exp, mlir_module_serialized=_export._module_to_bytecode(module))


def logistic_export(export):
    """jax lowers ``lax.logistic`` to negate, exponential, add and divide;
    this artifact's module is jax's own for ``2 * tanh(x)`` with the tanh
    written as ``stablehlo.logistic``."""
    import jax.numpy as jnp

    exp = export(lambda x: 2.0 * jnp.tanh(x), (2, 3), ("tpu",))
    text = exp.mlir_module()
    assert text.count("stablehlo.tanh") == 1
    return with_module(exp, text.replace("stablehlo.tanh",
                                         "stablehlo.logistic"))


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import export as jax_export

    from domain_transfer_gan_tpu.eval.fid import (_RandomFeatureNet,
                                                  save_extractor)

    # no source file paths in the modules' locations
    jax.config.update("jax_include_full_tracebacks_in_locations", False)
    jax.config.update("jax_traceback_in_locations_limit", 0)

    os.makedirs(OUT, exist_ok=True)

    def path(name):
        return os.path.join(OUT, name)

    def export(fn, shape, platforms, **kw):
        # save_extractor's lines, with the platforms given
        spec = jax.ShapeDtypeStruct(shape, jnp.float32)
        return jax_export.export(jax.jit(fn), platforms=platforms,
                                 **kw)(spec)

    def write(name, exp):
        exp = with_module(exp, exp.mlir_module())
        with open(path(name), "wb") as f:
            f.write(exp.serialize())
        ops = op_set(exp)
        print("%-28s %8d bytes  platforms %s  ops %s"
              % (name, os.path.getsize(path(name)), exp.platforms,
                 " ".join(sorted(ops))))
        return ops

    net = _RandomFeatureNet(64)
    variables = net.init(jax.random.PRNGKey(1234),
                         jnp.zeros((1, 64, 64, 3), jnp.float32))
    save_extractor(lambda x: net.apply(variables, x), (64, 64, 3),
                   path("proxy_w64_64x64x3.jaxexp"), batch=64)
    with open(path("proxy_w64_64x64x3.jaxexp"), "rb") as f:
        covered = write("proxy_w64_64x64x3.jaxexp",
                        jax_export.deserialize(f.read()))

    inc = inception_tiny()
    iv = inc.init(jax.random.PRNGKey(SEED), jnp.zeros((1, 20, 20, 3)))
    rng = np.random.RandomState(SEED)
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape)
                              .astype(np.float32)), iv["batch_stats"])
    iv = {"params": iv["params"], "batch_stats": stats}
    covered |= write("inception_tiny_tpu.jaxexp",
                     export(lambda x: inc.apply(iv, x), (4, 20, 20, 3),
                            ("tpu",)))
    covered |= write("ops_tiny_tpu.jaxexp",
                     export(ops_tiny, (2, 6, 6, 3), ("tpu",)))
    write("ops_tiny_cuda_tpu.jaxexp",
          export(ops_tiny, (2, 6, 6, 3), ("cuda", "tpu")))
    covered |= write("logistic_tpu.jaxexp", logistic_export(export))
    with jax.enable_x64(True):
        covered |= write("x64_tpu.jaxexp", export(x64_tiny, (2, 5),
                                                  ("tpu",)))
    covered |= write("cpu_tpu.jaxexp",
                     export(lambda x: jnp.tanh(x), (2, 3), ("cpu", "tpu")))
    missing = OP_SET - covered
    assert not missing, "ops of the set no artifact emits: %s" % missing
    print("covered: every op of the set;",
          "beyond it:", " ".join(sorted(covered - OP_SET)) or "nothing")

    # refused
    write("sine_tpu.jaxexp", export(lambda x: jnp.sin(x), (2, 3), ("tpu",)))
    write("argmax_tpu.jaxexp",
          export(lambda x: jnp.argmax(x, axis=1).astype(jnp.float32),
                 (2, 3), ("tpu",)))

    def custom(x):
        return jax.ffi.ffi_call("tpu_custom_call_fixture",
                                jax.ShapeDtypeStruct(x.shape, x.dtype))(x)

    write("custom_call_tpu.jaxexp",
          export(custom, (2, 3), ("tpu",), disabled_checks=[
              jax_export.DisabledSafetyCheck.custom_call(
                  "tpu_custom_call_fixture")]))

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("d",))
    sharding = jax.sharding.NamedSharding(mesh,
                                          jax.sharding.PartitionSpec("d"))
    two = jax_export.export(jax.jit(lambda x: x * 2.0,
                                    in_shardings=sharding,
                                    out_shardings=sharding))(
        jax.ShapeDtypeStruct((4, 3), jnp.float32, sharding=sharding))
    assert two.nr_devices == 2
    write("two_devices.jaxexp", two)


if __name__ == "__main__":
    main()
