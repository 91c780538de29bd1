"""The port stands alone: importing it pulls in nothing of JAX or of the JAX
package, chip_smoke.py names neither, and the kernel wrapper raises rather
than falls back when a launch is asked for without a card."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import domain_transfer_gan_torch
from domain_transfer_gan_torch.ops.kernels import build
from domain_transfer_gan_torch.ops.kernels import instance_norm as K

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
             "zstandard", "zarr", "numcodecs", "flatbuffers", "mlir",
             "domain_transfer_gan_tpu")


def _modules():
    names = ["domain_transfer_gan_torch"]
    for m in pkgutil.walk_packages(domain_transfer_gan_torch.__path__,
                                   "domain_transfer_gan_torch."):
        names.append(m.name)
    return names


def test_every_module_imports_without_jax():
    """In a fresh interpreter: import every module of the port, then look
    at sys.modules."""
    names = _modules()
    assert {"domain_transfer_gan_torch.cli.serve",
            "domain_transfer_gan_torch.cli.export",
            "domain_transfer_gan_torch.ops.kernels.instance_norm",
            "domain_transfer_gan_torch.ops.kernels.build",
            "domain_transfer_gan_torch.ops.numerics",
            "domain_transfer_gan_torch.nn.layers",
            "domain_transfer_gan_torch.models.state",
            "domain_transfer_gan_torch.models.steps",
            "domain_transfer_gan_torch.cli.train",
            "domain_transfer_gan_torch.data.npz",
            "domain_transfer_gan_torch.data.resize",
            "domain_transfer_gan_torch.data.iterators",
            "domain_transfer_gan_torch.data.synthetic",
            "domain_transfer_gan_torch.eval.metrics",
            "domain_transfer_gan_torch.eval.visualize",
            "domain_transfer_gan_torch.utils.artifacts",
            "domain_transfer_gan_torch.utils.checkpoint",
            "domain_transfer_gan_torch.utils.profiling",
            "domain_transfer_gan_torch.cli.test",
            "domain_transfer_gan_torch.eval.fid",
            "domain_transfer_gan_torch.eval.diversity",
            "domain_transfer_gan_torch.eval.moments",
            "domain_transfer_gan_torch.models.pool",
            "domain_transfer_gan_torch.models.accum",
            "domain_transfer_gan_torch.data.folder",
            "domain_transfer_gan_torch.data.native",
            "domain_transfer_gan_torch.data.feed",
            "domain_transfer_gan_torch.data.edges2shoes",
            "domain_transfer_gan_torch.data.climate",
            "domain_transfer_gan_torch.data.prep_livneh",
            "domain_transfer_gan_torch.utils.torch_interop",
            "domain_transfer_gan_torch.cli.import_torch",
            "domain_transfer_gan_torch.utils.flax_msgpack",
            "domain_transfer_gan_torch.utils.orbax_dir",
            "domain_transfer_gan_torch.utils.zstd",
            "domain_transfer_gan_torch.cli.export_jax",
            "domain_transfer_gan_torch.parallel",
            "domain_transfer_gan_torch.parallel.multihost",
            "domain_transfer_gan_torch.parallel.mesh",
            "domain_transfer_gan_torch.parallel.selfcheck",
            "domain_transfer_gan_torch.parallel.pipeline",
            "domain_transfer_gan_torch.parallel.hints",
            "domain_transfer_gan_torch.parallel.spatial",
            "domain_transfer_gan_torch.ops.kernels.pad",
            "domain_transfer_gan_torch.utils.timing",
            "domain_transfer_gan_torch.utils.jax_export",
            "domain_transfer_gan_torch.utils.mlir_bytecode",
            "domain_transfer_gan_torch.utils.vhlo",
            "domain_transfer_gan_torch.eval.stablehlo"} <= set(names)
    code = (
        "import importlib, sys\n"
        "for n in %r: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n" % (names, FORBIDDEN))
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", ["chip_smoke.py",
                                  "__graft_entry_torch__.py"] + sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(os.path.join(ROOT, "domain_transfer_gan_torch"))
    for f in fs if f.endswith(".py")))
def test_source_names_no_jax_import(path):
    """By text: no import of JAX, flax, optax, orbax, tensorstore, zstandard,
    zarr, numcodecs, flatbuffers, an MLIR binding or the JAX package."""
    with open(os.path.join(ROOT, path)) as f:
        src = f.read()
    pat = re.compile(r"^\s*(?:import|from)\s+(%s)\b" % "|".join(FORBIDDEN),
                     re.M)
    assert not pat.findall(src), path


def test_the_root_entry_points_import_without_jax():
    """In a fresh interpreter: ``__graft_entry_torch__`` (and the port it
    reaches) leaves nothing of JAX in sys.modules."""
    code = ("import sys, __graft_entry_torch__\n"
            "import domain_transfer_gan_torch.ops.kernels.pad\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
            "print('BAD', bad)\n"
            "sys.exit(1 if bad else 0)\n" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_never_calls_a_library_norm_or_compile():
    """The wrapper's kernel is the hand-written one: nothing in the package
    reaches for F.instance_norm / group_norm / torch.compile."""
    pat = re.compile(r"instance_norm\(|group_norm\(|torch\.compile|"
                     r"F\.batch_norm\(")
    pkg = os.path.join(ROOT, "domain_transfer_gan_torch")
    for d, _, fs in os.walk(pkg):
        for f in fs:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    hits = [m for m in pat.findall(fh.read())]
                assert not hits, (f, hits)


def test_the_jax_export_extractor_runs_on_cuda_by_default():
    """``--fid_extractor``'s reader and interpreter ask for the card unless
    the caller names another device."""
    import inspect

    from domain_transfer_gan_torch.eval import fid, stablehlo
    for fn in (fid.load_extractor, stablehlo.Program.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_train_cli_asks_for_cuda_and_does_not_fall_back(tmp_path):
    """Without --device the training CLI runs on CUDA; here, with no card,
    it raises instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from domain_transfer_gan_torch.cli.train import train_model
    from domain_transfer_gan_torch.config import TrainConfig
    assert TrainConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="asks for CUDA"):
        train_model(argv=["--dataroot", str(tmp_path / "none"), "--name",
                          "n", "--checkpoints_dir", str(tmp_path)])
    assert not os.path.exists(str(tmp_path / "n" / "results.txt"))


def test_launcher_raises_without_a_card():
    """Asked to launch on a tensor that is not on a card, the launcher
    raises; it never computes the plain version instead."""
    x = torch.randn(2, 4, 4, 8)
    before = K.instance_norm_fused.launches
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        K._launch(x, None, None, 1e-5, False, False)
    assert K.instance_norm_fused.launches == before


def test_cuda_dispatch_does_not_fall_back(monkeypatch):
    """A tensor that says it is on the card goes to the launcher and to
    nothing else: with the launcher failing, the wrapper fails."""
    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    def boom(*a, **k):
        raise RuntimeError("launch refused")

    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(K, "_launch", boom)
    monkeypatch.setattr(K, "instance_norm_plain", no_plain)
    x = torch.randn(2, 4, 4, 8).as_subclass(OnCard)
    with pytest.raises(RuntimeError, match="launch refused"):
        K.instance_norm_fused(x, None, None)


def test_grad_on_the_card_goes_to_the_backward_launcher_only(monkeypatch):
    """A gradient asked for on a tensor that says it is on the card goes to
    the backward launcher and to nothing else.  With that launcher failing the backward fails; it never computes
    the plain backward instead."""
    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    plain, plain_bwd = K.instance_norm_plain, K.instance_norm_bwd_plain
    launched = []

    def fake_forward_launch(x, scale, shift, eps, unbiased, relu):
        launched.append("fwd")
        return plain(x, scale, shift, eps=eps, unbiased=unbiased, relu=relu,
                     return_stats=True)

    def boom(*a, **k):
        launched.append("bwd")
        raise RuntimeError("backward launch refused")

    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain backward")

    monkeypatch.setattr(K, "_launch", fake_forward_launch)
    monkeypatch.setattr(K, "_launch_bwd", boom)
    monkeypatch.setattr(K, "instance_norm_bwd_plain", no_plain)
    x = torch.randn(2, 4, 4, 8).as_subclass(OnCard).requires_grad_(True)
    before = K.instance_norm_bwd_fused.launches
    y = K.instance_norm_fused(x, None, None)
    with pytest.raises(RuntimeError, match="backward launch refused"):
        y.sum().backward()
    assert launched == ["fwd", "bwd"]
    assert K.instance_norm_bwd_fused.launches == before
    monkeypatch.undo()
    # and the launcher itself refuses a tensor that is not on a card
    x = torch.randn(2, 4, 4, 8)
    _, mean, rstd = plain(x, None, None, return_stats=True)
    with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
        K._launch_bwd(x, x, mean, rstd, None, None, False, False)
    assert plain_bwd(x, x, mean, rstd, None, None)[0].shape == x.shape


# the name this test had while a gradient on the card was still refused;
# both names select the same test
test_grad_on_the_card_is_refused_until_the_backward_kernel = \
    test_grad_on_the_card_goes_to_the_backward_launcher_only


def test_build_needs_nvcc_only_at_first_launch(monkeypatch, tmp_path):
    """Importing the kernel modules builds nothing; a build without nvcc
    raises KernelCompileError with the reason; a failing nvcc raises with its
    output."""
    assert build.kernel_names() == ["instance_norm", "instance_norm_bwd", "pad"]
    for name in build.kernel_names():
        assert os.path.isfile(build.source_path(name))
    assert build.build_dir() == os.path.join(ROOT, "build")
    monkeypatch.setattr(build, "build_dir", lambda: str(tmp_path))
    monkeypatch.setattr(build, "_find_nvcc", lambda: "/bin/false")
    with pytest.raises(build.KernelCompileError, match="nvcc failed"):
        build.compile_kernel("instance_norm")
    with pytest.raises(build.KernelCompileError, match="nvcc failed"):
        build.compile_all()  # one nvcc per source, started together
    assert os.listdir(tmp_path) == []  # nothing half-built is left behind
    monkeypatch.undo()
    if not any(os.access(os.path.join(p, "nvcc"), os.X_OK)
               for p in os.environ.get("PATH", "").split(os.pathsep)
               + ["/usr/local/cuda/bin"]):
        monkeypatch.setattr(build, "build_dir", lambda: str(tmp_path))
        monkeypatch.delenv("CUDA_HOME", raising=False)
        monkeypatch.delenv("CUDA_PATH", raising=False)
        with pytest.raises(build.KernelCompileError, match="nvcc not found"):
            build.load_library("instance_norm")
