"""The serving slice of the port as a whole, on the CPU: export a tiny model,
serve it from a real ThreadingHTTPServer on an ephemeral port, and repeat the
cases of tests/test_serve.py; one case holds the HTTP answers against the JAX
model's predict_B / predict_A on the same weights."""

import io
import json
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from domain_transfer_gan_tpu.config import TrainConfig as JaxTrainConfig
from domain_transfer_gan_tpu.models import create_model as jax_create_model

from domain_transfer_gan_torch.cli.export import (
    export_model,
    load_exported,
    main as export_main,
)
from domain_transfer_gan_torch.cli.serve import build_server
from domain_transfer_gan_torch.config import (
    TrainConfig,
    load_train_config_from_expr_dir,
)
from domain_transfer_gan_torch.models import create_model
from domain_transfer_gan_torch.utils.convert import flatten_params

from torch_port_helpers import images, latents, randomize

from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = dict(model="aug_cycle_gan", grid_size=64, ngf=4, nef=4, ndf=4,
            nlatent=8)
BATCH = 4


@pytest.fixture(scope="module")
def jax_model():
    """The JAX model with numpy-drawn O(1) generator weights."""
    cfg = JaxTrainConfig(use_pallas=False, seed=11, **TINY)
    cfg.expr_dir = ""
    m = jax_create_model(cfg, testing=True)
    params = dict(m.state.params)
    for i, name in enumerate(("netG_A_B", "netG_B_A")):
        params[name] = jax.tree_util.tree_map(
            jnp.asarray, randomize(params[name], 60 + i))
    m.state = m.state.replace(params=params)
    return m


@pytest.fixture(scope="module")
def served(tmp_path_factory, jax_model):
    out = tmp_path_factory.mktemp("export")
    m = create_model(TrainConfig(seed=11, **TINY), testing=True,
                     device="cpu")
    for name in ("netG_A_B", "netG_B_A"):
        m.load_jax_params(name, jax.tree_util.tree_map(
            np.asarray, dict(jax_model.state.params[name])))
    export_model(m, str(out), batch=BATCH, device="cpu")
    srv = build_server(str(out), port=0, device="cpu")  # ephemeral port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield str(out), "http://127.0.0.1:%d" % srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


def _post(url, arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return np.load(io.BytesIO(resp.read()))


def _call(fn, *arrays):
    return fn(*[torch.from_numpy(a) for a in arrays]).numpy()


def test_serve_manifest(served):
    out, base = served
    with urllib.request.urlopen(base + "/", timeout=30) as resp:
        manifest = json.loads(resp.read())
    assert manifest["batch"] == BATCH and manifest["nlatent"] == 8
    assert set(manifest["functions"]) == {"predict_B", "predict_A"}
    assert manifest["platforms"] == ["cpu"]
    # the JAX manifest's keys plus what rebuilds the nets
    assert {"batch", "grid_size", "input_nc", "output_nc", "nlatent", "model",
            "serve_dtype", "functions", "platforms", "ngf", "n_blocks",
            "norm", "use_dropout", "init_scheme"} <= set(manifest)
    assert manifest["functions"]["predict_B"]["args"] == [
        ["A", [BATCH, 64, 64, 3], "float32"], ["z", [BATCH, 8], "float32"]]
    # the weights are plain tensors, readable with weights_only=True
    sd = torch.load(out + "/predict_B.pt", weights_only=True)
    assert all(v.dtype == torch.float32 for v in sd.values())


def test_serve_rejects_platform_mismatch(served, tmp_path):
    """An artifact exported for another platform fails at server BUILD time
    with a re-export hint, not with a 500 on every request."""
    out, _ = served
    bad = tmp_path / "bad"
    shutil.copytree(out, bad)
    mani = json.loads((bad / "manifest.json").read_text())
    mani["platforms"] = ["cuda"]
    (bad / "manifest.json").write_text(json.dumps(mani))
    with pytest.raises(ValueError, match="re-export with `--device cpu`"):
        build_server(str(bad), port=0, device="cpu")


def test_entry_points_default_to_cuda(served):
    """Every entry point runs on the card unless the caller asks for the
    CPU; without a card the default refuses rather than falling back."""
    import inspect

    from domain_transfer_gan_torch.cli import serve

    for fn in (export_model, load_exported, build_server, create_model,
               serve.ExportedEndpoint.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        out, _ = served
        with pytest.raises(ValueError, match="exported for platforms"):
            build_server(out, port=0)  # a cpu artifact, the cuda default


def test_serve_matches_exported_fn(served):
    out, base = served
    A, z = images(0, BATCH), latents(1, BATCH, 8)
    got = _post(base + "/predict_B", {"A": A, "z": z})
    want = _call(load_exported(out, "predict_B", "cpu"), A, z)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="exported at batch"):
        _call(load_exported(out, "predict_B", "cpu"), A[:2], z[:2])


@pytest.mark.parametrize("n", [1, 3, 4, 7, 9])
def test_serve_pads_and_chunks_any_batch(served, n):
    """tail-pad below the serving batch, chunk + pad above it."""
    out, base = served
    fn = load_exported(out, "predict_A", "cpu")
    B = images(10 + n, n)
    got = _post(base + "/predict_A", {"B": B})
    assert got.shape == (n, 64, 64, 3) and got.dtype == np.float32
    pad = np.concatenate([B, np.zeros((-n % BATCH, 64, 64, 3), np.float32)])
    want = np.concatenate([_call(fn, pad[i:i + BATCH])
                           for i in range(0, len(pad), BATCH)])[:n]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_serve_samples_z_when_absent(served):
    out, base = served
    A = images(2, 2)
    y1 = _post(base + "/predict_B", {"A": A})
    y2 = _post(base + "/predict_B", {"A": A})
    assert y1.shape == (2, 64, 64, 3)
    # fresh prior draws per request -> stochastically different outputs
    assert np.abs(y1 - y2).max() > 1e-6
    # a fresh server draws the JAX server's sequence: RandomState(0), in
    # request order
    srv = build_server(out, port=0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = "http://127.0.0.1:%d/predict_B" % srv.server_address[1]
        got = [_post(url, {"A": A}), _post(url, {"A": A})]
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    rng = np.random.RandomState(0)
    fn = load_exported(out, "predict_B", "cpu")
    for y in got:
        z = rng.randn(2, 8).astype(np.float32)
        pad = lambda a: np.concatenate(
            [a, np.zeros((BATCH - 2,) + a.shape[1:], np.float32)])
        np.testing.assert_allclose(y, _call(fn, pad(A), pad(z))[:2],
                                   rtol=1e-6, atol=1e-6)


def test_serve_concurrent_requests(served):
    """ThreadingHTTPServer runs each request on a new thread: 8 concurrent
    clients each get their own correct batch back (inference mode is entered
    per call, the generators and the z-sampling rng are shared)."""
    from concurrent.futures import ThreadPoolExecutor

    out, base = served
    fn = load_exported(out, "predict_B", "cpu")
    batches = [(images(20 + i, 2), latents(30 + i, 2, 8)) for i in range(8)]

    def call(ab):
        A, z = ab
        return _post(base + "/predict_B", {"A": A, "z": z})

    with ThreadPoolExecutor(max_workers=8) as ex:
        got = list(ex.map(call, batches))
    for (A, z), y in zip(batches, got):
        want = _call(fn, np.concatenate([A, np.zeros_like(A)]),
                     np.concatenate([z, np.zeros_like(z)]))[:2]
        np.testing.assert_allclose(y, want, rtol=1e-6, atol=1e-6)


def _status(url, data=None):
    req = urllib.request.Request(url, data=data,
                                 method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


@pytest.mark.parametrize("case,code", [
    ("malformed body", 400), ("missing array", 400), ("wrong z shape", 400),
    ("wrong image shape", 400), ("no sample", 400), ("unknown GET", 404),
    ("unknown POST", 404)])
def test_serve_rejects_bad_requests(served, case, code):
    _, base = served
    f32 = np.float32
    url, data = base + "/predict_B", None
    if case == "malformed body":
        data = b"not-an-npz"
    elif case == "missing array":
        data = _npz(w=np.zeros((2, 8), f32))
    elif case == "wrong z shape":
        data = _npz(A=np.zeros((2, 64, 64, 3), f32), z=np.zeros((2, 5), f32))
    elif case == "wrong image shape":  # a 400, not a 500 from the model
        data = _npz(A=np.zeros((2, 32, 32, 3), f32))
    elif case == "no sample":
        data = _npz(A=np.zeros((0, 64, 64, 3), f32))
    elif case == "unknown GET":
        url = base + "/nope"
    elif case == "unknown POST":
        url, data = base + "/nope", _npz(A=np.zeros((1, 64, 64, 3), f32))
    assert _status(url, data) == code


def test_http_answers_match_the_jax_model(served, jax_model):
    """The slice end to end against the reference: the port's HTTP answers
    vs the JAX model's predict_B / predict_A on the same weights and inputs
    (fp32 on the CPU, tanh outputs of O(1) scale, atol 1e-4)."""
    _, base = served
    A, B, z = images(40, 5), images(41, 5), latents(42, 5, 8)
    want_B = np.asarray(jax_model.predict_B(A, z))
    want_A = np.asarray(jax_model.predict_A(B))
    assert np.abs(want_B).mean() > 0.05 and np.abs(want_A).mean() > 0.05
    np.testing.assert_allclose(_post(base + "/predict_B", {"A": A, "z": z}),
                               want_B, rtol=0, atol=1e-4)
    np.testing.assert_allclose(_post(base + "/predict_A", {"B": B}),
                               want_A, rtol=0, atol=1e-4)


def test_export_cli_params_npz_seed_and_serve_dtype(tmp_path, jax_model):
    """export.main reads <expr_dir>/opt.json and either a params .npz in the
    JAX layout or --init_seed; --serve_dtype bfloat16 keeps the float32 I/O
    contract; a cycle_gan artifact replaces z by ones."""
    cfg = TrainConfig(dataroot="/d", name="exp_srv",
                      checkpoints_dir=str(tmp_path), seed=5, **TINY)
    cfg.finalize()
    assert load_train_config_from_expr_dir(cfg.expr_dir).ngf == 4
    npz = tmp_path / "params.npz"
    np.savez(npz, **flatten_params({
        name: jax.tree_util.tree_map(np.asarray, dict(p))
        for name, p in jax_model.state.params.items()}))
    A, z = images(50, 2), latents(51, 2, 8)

    out32, out16, outseed = (str(tmp_path / d) for d in ("e32", "e16", "es"))
    common = ["--expr_dir", cfg.expr_dir, "--batch", "2", "--device", "cpu"]
    export_main(common + ["--params", str(npz), "--out", out32])
    export_main(common + ["--params", str(npz), "--out", out16,
                          "--serve_dtype", "bfloat16"])
    export_main(common + ["--init_seed", "9", "--out", outseed])
    with pytest.raises(SystemExit):
        export_main(common + ["--out", out32])  # neither weights nor seed

    y32 = _call(load_exported(out32, "predict_B", "cpu"), A, z)
    direct = create_model(TrainConfig(**TINY), testing=True, device="cpu")
    for name in ("netG_A_B", "netG_B_A"):
        direct.load_jax_params(name, jax.tree_util.tree_map(
            np.asarray, dict(jax_model.state.params[name])))
    np.testing.assert_array_equal(y32, direct.predict_B(A, z).numpy())
    y16 = load_exported(out16, "predict_B", "cpu")(torch.from_numpy(A),
                                                   torch.from_numpy(z))
    assert y16.dtype == torch.float32
    with open(out16 + "/manifest.json") as f:
        assert json.load(f)["serve_dtype"] == "bfloat16"
    err = np.abs(y16.numpy() - y32)
    assert 0 < err.max() < 0.1 and err.mean() < 0.02  # bf16 rounding only

    yseed = _call(load_exported(outseed, "predict_B", "cpu"), A, z)
    m = create_model(TrainConfig(seed=9, **TINY), testing=True, device="cpu")
    np.testing.assert_array_equal(yseed, m.predict_B(A, z).numpy())

    # cycle_gan: the artifact ignores the z it is given
    mc = create_model(TrainConfig(seed=9, **{**TINY, "model": "cycle_gan"}),
                      testing=True, device="cpu")
    outc = str(tmp_path / "ec")
    export_model(mc, outc, batch=2, device="cpu")
    fn = load_exported(outc, "predict_B", "cpu")
    np.testing.assert_array_equal(_call(fn, A, z), _call(fn, A, 0 * z))
    np.testing.assert_array_equal(_call(fn, A, z),
                                  mc.predict_B(A, np.ones_like(z)).numpy())
