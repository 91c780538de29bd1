"""The JAX package's export directory served by the port without JAX:
``cli/serve.py`` on a directory of ``predict_{A,B}.stablehlo`` that the JAX
package's ``cli/export.py::export_model`` wrote (``tests/fixtures/jax_serve/``,
regenerated by ``tests/fixtures/make_jax_serve_fixtures.py``), run by the
StableHLO interpreter (``eval/stablehlo.py``) on the CPU.

- Each tiny directory's interpreted ``predict_B`` / ``predict_A`` against
  ``exp.call`` on the same inputs, computed live by one JAX compile (all
  twelve functions in one ``jax.jit``, shared by the workers).  float32:
  atol 1e-4, the limit that the JAX norm's E[x^2] - mean^2 sets
  (``ROADMAP.md``, "Limits of agreement"; the readings are up to 6.4e-5,
  the bfloat16 answer of the same weights 0.047-0.144);
  the interpreter's own float32 rounding is held tighter, within 1e-5 x
  max|y| of the same module run in float64.  bfloat16: max <= 0.1 and mean
  <= 0.012 from the bfloat16 ``exp.call`` (the serving limits of
  ``ROADMAP.md``).
- bfloat16 against the float32 ``exp.call`` of the same weights: mean <=
  0.012, and max <= 0.1 where the JAX package's own bfloat16 ``exp.call``
  is within it.  On the seed-2 draw (``aug_bf16_s2_tpu``) it is not: its
  own bfloat16 answer is 0.144 from its float32 one, and the port's
  answers are held no farther than that.
- The HTTP answers of a server on each directory against those of the
  port's own artifact, exported by the port's ``cli.export --params`` from
  the weights' ``params.npz`` (float32 atol 1e-4, bfloat16 max 0.1 /
  mean 0.012); padding and chunking, z drawn in the port's
  server's stream, concurrent requests, the bad requests, and the refusals
  by name.
- ``reverse`` (the reflect pads' op) against ``np.flip`` over every subset
  of four dimensions.
"""

import dataclasses
import importlib.util
import io
import json
import os
import shutil
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from itertools import combinations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import export as jax_export

from domain_transfer_gan_torch.cli import serve
from domain_transfer_gan_torch.cli.export import load_exported
from domain_transfer_gan_torch.cli.export import main as export_main
from domain_transfer_gan_torch.cli.serve import build_server
from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.eval.stablehlo import Program, StableHLOError
from domain_transfer_gan_torch.utils import jax_export as J
from domain_transfer_gan_torch.utils import vhlo

from torch_port_helpers import once
from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures")
ROOT = os.path.join(FIXTURES, "jax_serve")
TINY = ["aug_f32_tpu", "aug_bf16_tpu", "cycle_f32_tpu", "aug_f32_cpu_tpu",
        "aug_f32_s2_tpu", "aug_bf16_s2_tpu"]
FNS = ("predict_B", "predict_A")
F32_ATOL = 1e-4
BF16_MAX, BF16_MEAN = 0.1, 0.012
with open(os.path.join(ROOT, "index.json")) as _f:
    INDEX = json.load(_f)
FLOAT32 = [n for n in TINY if INDEX[n]["serve_dtype"] == "float32"]
BFLOAT16 = [n for n in TINY if n not in FLOAT32]


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(FIXTURES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


inputs = _module("jax_serve_inputs").inputs


def _dir(name):
    return os.path.join(ROOT, name)


def _manifest(name):
    with open(os.path.join(_dir(name), "manifest.json")) as f:
        return json.load(f)


def _args(name, fn):
    x = inputs(_manifest(name), INDEX[name]["seed"])
    return (x["A"], x["z"]) if fn == "predict_B" else (x["B"],)


def _jax_outputs():
    """``exp.call`` of every tiny function, the ``tpu`` lowerings run with
    their first platform named ``cpu``, in one ``jax.jit``."""
    calls = []
    for name in TINY:
        for fn in FNS:
            with open(os.path.join(_dir(name), fn + ".stablehlo"), "rb") as f:
                exp = jax_export.deserialize(f.read())
            exp = dataclasses.replace(
                exp, platforms=("cpu",) + exp.platforms[1:])
            calls.append(((name, fn), exp, _args(name, fn)))

    @jax.jit
    def run(args):
        return [exp.call(*a) for (_, exp, _), a in zip(calls, args)]

    outs = run([[jnp.asarray(a) for a in args] for _, _, args in calls])
    return {key: np.asarray(y) for (key, _, _), y in zip(calls, outs)}


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    return once(tmp_path_factory, "jax_serve_outputs", _jax_outputs)


def _interpreted(name, fn):
    f = load_exported(_dir(name), fn, "cpu")
    return f(*map(torch.from_numpy, _args(name, fn))).numpy()


def _bf16_held(got, want, what, max_limit=BF16_MAX):
    err = np.abs(got - want)
    assert err.max() <= max_limit and err.mean() <= BF16_MEAN, (
        what, float(err.max()), float(err.mean()), max_limit)


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("name", TINY)
def test_interpreted_generators_match_exp_call(jax_out, name, fn):
    want = jax_out[name, fn]
    got = _interpreted(name, fn)
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(want).mean() > 0.05  # O(1) answers, no error hidden
    if name in FLOAT32:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    else:
        _bf16_held(got, want, "against the bfloat16 exp.call")


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("name", BFLOAT16)
def test_bfloat16_against_the_float32_exp_call(jax_out, name, fn):
    """The serving limit of a bfloat16 artifact: its answer against the
    float32 ``exp.call`` of the same weights and inputs, at ROADMAP's 0.1
    max, or, where the JAX package's own bfloat16 answer is farther than
    that (the seed-2 draw's ``predict_B`` only), no farther than it."""
    want = jax_out[INDEX[name]["float32"], fn]
    spread = float(np.abs(jax_out[name, fn] - want).max())
    assert (spread > BF16_MAX) == (
        (name, fn) == ("aug_bf16_s2_tpu", "predict_B")), (name, fn, spread)
    _bf16_held(_interpreted(name, fn), want, "against float32",
               max(BF16_MAX, spread))


@pytest.mark.parametrize("name", TINY)
def test_committed_outputs_are_exp_calls(jax_out, name):
    """The outputs the card's check reads are exp.call's."""
    with np.load(os.path.join(ROOT, name + ".outputs.npz")) as f:
        for fn in FNS:
            np.testing.assert_allclose(f[fn], jax_out[name, fn], rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("name", FLOAT32)
def test_float32_rounding_against_the_module_in_float64(monkeypatch, name,
                                                        fn):
    """The interpreter's own float32 error: the same module run with every
    float32 value held in float64 (constants promoted at their first op)."""
    got = _interpreted(name, fn)
    monkeypatch.setitem(vhlo.DTYPES, "f32",
                        (torch.float64,) + vhlo.DTYPES["f32"][1:])
    exp = J.load(os.path.join(_dir(name), fn + ".stablehlo"))
    prog = Program(exp.mlir_module_serialized, device="cpu")
    lead = [] if exp.platform_index is None else [
        torch.tensor(exp.platform_index, dtype=torch.int32)]
    args = [torch.from_numpy(a).double() for a in _args(name, fn)]
    exact = prog(*lead, *[args[i] for i in exp.module_kept_var_idx])[0]
    assert exact.dtype == torch.float64
    exact = exact.numpy()
    assert np.abs(got - exact).max() <= 1e-5 * np.abs(exact).max()


# ---------------------------------------------------------------------------
# the HTTP server
# ---------------------------------------------------------------------------

class _Running:
    def __init__(self, export_dir):
        self.srv = build_server(export_dir, port=0, device="cpu")
        self.url = "http://127.0.0.1:%d" % self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _own_artifact(name, tmp):
    """The port's own artifact of the directory's weights: opt.json of the
    same configuration, then ``cli.export --params``."""
    i = INDEX[name]
    cfg = TrainConfig(dataroot="/d", name=name, checkpoints_dir=str(tmp),
                      model=i["model"], grid_size=i["grid_size"],
                      ngf=i["ngf"], nef=i["nef"], ndf=i["ndf"],
                      nlatent=i["nlatent"], n_blocks=i["n_blocks"])
    cfg.finalize()
    out = str(tmp / (name + "_own"))
    export_main(["--expr_dir", cfg.expr_dir, "--params",
                 os.path.join(_dir(i["params"]), "params.npz"), "--out", out,
                 "--batch", str(i["batch"]), "--serve_dtype",
                 i["serve_dtype"], "--device", "cpu"])
    return out


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """A server on each tiny JAX directory and one on the port's own
    artifact of the same weights."""
    tmp = tmp_path_factory.mktemp("jax_serve")
    running = {}
    try:
        for name in TINY:
            running[name] = _Running(_dir(name))
            own = _own_artifact(name, tmp)
            running[name + "_own"] = _Running(own)
            running[name + "_own"].dir = own
        yield running
    finally:
        for r in running.values():
            r.close()


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _post(url, **arrays):
    req = urllib.request.Request(url, data=_npz(**arrays), method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return np.load(io.BytesIO(resp.read()))


def _images(seed, n, c=3):
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, 64, 64, c)).astype(np.float32)


def _latents(seed, n):
    return np.random.RandomState(seed).randn(n, 8).astype(np.float32)


@pytest.mark.parametrize("name", TINY)
def test_http_answers_match_the_ports_own_artifact(servers, name):
    A, B, z = _images(70, 5), _images(71, 5), _latents(72, 5)
    for path, arrays in (("/predict_B", dict(A=A, z=z)),
                         ("/predict_A", dict(B=B))):
        got = _post(servers[name].url + path, **arrays)
        want = _post(servers[name + "_own"].url + path, **arrays)
        assert got.shape == (5, 64, 64, 3) and got.dtype == np.float32
        if name in FLOAT32:
            np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
        else:
            _bf16_held(got, want, path)


def test_http_get_is_the_jax_manifest_as_written(servers):
    with urllib.request.urlopen(servers["aug_f32_tpu"].url + "/",
                                timeout=30) as resp:
        assert json.loads(resp.read()) == _manifest("aug_f32_tpu")


@pytest.mark.parametrize("n", [1, 2, 5])
def test_http_pads_and_chunks(servers, n):
    """Below the serving batch of 2 the tail is zero-padded, above it the
    request is chunked: the answers are the interpreted function's on each
    padded chunk."""
    fn = load_exported(_dir("aug_f32_tpu"), "predict_B", "cpu")
    A, z = _images(80 + n, n), _latents(90 + n, n)
    got = _post(servers["aug_f32_tpu"].url + "/predict_B", A=A, z=z)
    assert got.shape == (n, 64, 64, 3)
    pad = (-n) % 2
    Ap = np.concatenate([A, np.zeros((pad, 64, 64, 3), np.float32)])
    zp = np.concatenate([z, np.zeros((pad, 8), np.float32)])
    want = np.concatenate([
        fn(torch.from_numpy(Ap[i:i + 2]), torch.from_numpy(zp[i:i + 2]))
        .numpy() for i in range(0, n + pad, 2)])[:n]
    np.testing.assert_array_equal(got, want)


def test_z_is_drawn_in_the_ports_server_stream(servers):
    """A fresh server on the JAX directory and one on the port's artifact
    draw the same z for requests without one (RandomState(0), in request
    order), so their answers agree as with z given."""
    A = _images(3, 3)
    fresh = [_Running(_dir("aug_f32_tpu")),
             _Running(servers["aug_f32_tpu_own"].dir)]
    try:
        got = [[_post(r.url + "/predict_B", A=A) for _ in range(2)]
               for r in fresh]
    finally:
        for r in fresh:
            r.close()
    (jax1, jax2), (own1, own2) = got
    assert np.abs(jax1 - jax2).max() > 1e-3  # a fresh z each request
    np.testing.assert_allclose(jax1, own1, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(jax2, own2, rtol=0, atol=F32_ATOL)
    rng = np.random.RandomState(0)
    fn = load_exported(_dir("aug_f32_tpu"), "predict_B", "cpu")
    for y in (jax1, jax2):
        z = rng.randn(3, 8).astype(np.float32)
        Ap = np.concatenate([A, np.zeros_like(A[:1])])
        zp = np.concatenate([z, np.zeros_like(z[:1])])
        want = np.concatenate([
            fn(torch.from_numpy(Ap[i:i + 2]), torch.from_numpy(zp[i:i + 2]))
            .numpy() for i in (0, 2)])[:3]
        np.testing.assert_array_equal(y, want)


def test_http_concurrent_requests(servers):
    """Eight clients at once on one server each get their own answer."""
    url = servers["aug_f32_cpu_tpu"].url + "/predict_B"
    fn = load_exported(_dir("aug_f32_cpu_tpu"), "predict_B", "cpu")
    batches = [(_images(100 + i, 2), _latents(110 + i, 2)) for i in range(8)]
    with ThreadPoolExecutor(max_workers=8) as ex:
        got = list(ex.map(lambda b: _post(url, A=b[0], z=b[1]), batches))
    for (A, z), y in zip(batches, got):
        np.testing.assert_array_equal(
            y, fn(torch.from_numpy(A), torch.from_numpy(z)).numpy())


@pytest.mark.parametrize("case,code", [
    ("malformed body", 400), ("wrong image shape", 400),
    ("wrong z shape", 400), ("unknown POST", 404)])
def test_http_bad_requests(servers, case, code):
    url, data = servers["cycle_f32_tpu"].url + "/predict_B", None
    if case == "malformed body":
        data = b"not-an-npz"
    elif case == "wrong image shape":
        data = _npz(A=np.zeros((2, 32, 32, 3), np.float32))
    elif case == "wrong z shape":
        data = _npz(A=np.zeros((2, 64, 64, 3), np.float32),
                    z=np.zeros((2, 5), np.float32))
    else:
        url, data = url[:-len("predict_B")] + "nope", _npz(A=np.zeros(1))
    req = urllib.request.Request(url, data=data, method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == code


# ---------------------------------------------------------------------------
# refusals, each by name
# ---------------------------------------------------------------------------

def _custom_call_predict_A():
    def custom(x):
        return jax.ffi.ffi_call("tpu_custom_call_fixture",
                                jax.ShapeDtypeStruct(x.shape, x.dtype))(x)

    spec = jax.ShapeDtypeStruct((2, 64, 64, 3), jnp.float32)
    return jax_export.export(
        jax.jit(custom), platforms=("tpu",),
        disabled_checks=[jax_export.DisabledSafetyCheck.custom_call(
            "tpu_custom_call_fixture")])(spec).serialize()


def _edit(d, case):
    if case == "manifest args":
        m = _manifest("aug_f32_tpu")
        m["functions"]["predict_A"]["args"][0][1][0] = 3
        (d / "manifest.json").write_text(json.dumps(m))
        return J.ExportFormatError, ["predict_A.stablehlo", "in_avals",
                                     "f32[3, 64, 64, 3]"]
    if case == "manifest platforms":
        m = _manifest("aug_f32_tpu")
        m["platforms"] = ["cuda"]
        (d / "manifest.json").write_text(json.dumps(m))
        return J.ExportFormatError, ["platforms = ['tpu']",
                                     "manifest.json says ['cuda']"]
    if case == "both kinds":
        (d / "predict_B.pt").write_bytes(b"")
        return ValueError, ["predict_B.pt", "predict_B.stablehlo", "not both"]
    if case == "neither kind":
        for fn in FNS:
            (d / (fn + ".stablehlo")).unlink()
        return ValueError, ["holds manifest.json:"]
    if case == "custom call":
        (d / "predict_A.stablehlo").write_bytes(_custom_call_predict_A())
        return StableHLOError, ["custom_call", "'tpu_custom_call_fixture'"]
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["manifest args", "manifest platforms",
                                  "both kinds", "neither kind",
                                  "custom call"])
def test_refused_before_the_socket_binds(tmp_path, monkeypatch, case):
    d = tmp_path / "export"
    shutil.copytree(_dir("aug_f32_tpu"), d)
    (d / "params.npz").unlink()
    error, named = _edit(d, case)
    bound = []
    monkeypatch.setattr(serve, "ThreadingHTTPServer",
                        lambda *a: bound.append(a))
    with pytest.raises(error) as e:
        build_server(str(d), port=0, device="cpu")
    for n in named:
        assert n in str(e.value), (n, str(e.value))
    assert not bound


def test_plain_norm_is_refused_on_an_interpreted_artifact():
    fn = load_exported(_dir("aug_f32_tpu"), "predict_B", "cpu")
    A, z = (torch.from_numpy(a) for a in _args("aug_f32_tpu", "predict_B"))
    with pytest.raises(ValueError, match="plain_norm=True: .* interpreted "
                       "StableHLO"):
        fn(A, z, plain_norm=True)
    with pytest.raises(ValueError, match="exported at batch 2"):
        fn(A[:1], z[:1])


def test_a_card_is_asked_for_and_nothing_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        build_server(_dir("aug_f32_tpu"), port=0)  # the cuda default


# ---------------------------------------------------------------------------
# reverse
# ---------------------------------------------------------------------------

SUBSETS = [s for k in range(5) for s in combinations(range(4), k)]


@pytest.fixture(scope="module")
def rev_module():
    """jax's module of ``lax.rev`` over dimension 0 of a (2, 3, 4, 5)
    array, as text, and its export."""
    spec = jax.ShapeDtypeStruct((2, 3, 4, 5), jnp.float32)
    exp = jax_export.export(jax.jit(lambda x: jax.lax.rev(x, (0,))),
                            platforms=("tpu",))(spec)
    text = exp.mlir_module()
    assert text.count("dims = [0]") == 1
    return exp, text


@pytest.mark.parametrize("dims", SUBSETS, ids=lambda s: "dims%s" % (s,))
def test_reverse_matches_np_flip(rev_module, dims):
    exp, text = rev_module
    text = text.replace("dims = [0]",
                        "dims = [%s]" % ", ".join(map(str, dims)))
    exp = _module("make_jax_export_fixtures").with_module(exp, text)
    got = J.check(J.read(exp.serialize()))
    prog = Program(got.mlir_module_serialized, device="cpu")
    x = np.random.RandomState(len(dims)).randn(2, 3, 4, 5).astype(np.float32)
    y = prog(torch.from_numpy(x))[0].numpy()
    np.testing.assert_array_equal(y, np.flip(x, dims) if dims else x)
