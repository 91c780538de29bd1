"""The port's native host reader (``csrc/npz_loader.cc`` through
``data/native.py``): built with g++ into the build directory, bit-equal to
numpy and to the JAX package's normalization, the JAX package's rejections
of malformed files (tests/test_data.py) against the port's copy, and a
visible numpy fallback when the build fails."""

import os
import struct
import zipfile

import numpy as np
import pytest

from domain_transfer_gan_tpu.data.npz import normalize_bundle as \
    jax_normalize

from domain_transfer_gan_torch.data import folder, native
from domain_transfer_gan_torch.data.npz import normalize_bundle
from domain_transfer_gan_torch.data.synthetic import \
    make_synthetic_livneh_pair
from domain_transfer_gan_torch.ops.kernels.build import build_dir


@pytest.fixture(scope="module")
def lib():
    """The library, built from the port's source (g++ and zlib are on every
    machine the port runs on; a missing one fails here with the reason)."""
    lib = native.get_lib()
    assert lib is not None, native.build_error()
    return lib


def test_the_library_is_built_into_the_build_dir(lib):
    path = native.library_path()
    assert os.path.dirname(path) == build_dir()
    assert os.path.basename(path).startswith("npz_loader-")
    assert os.path.exists(path)
    assert native.native_available() and native.build_error() is None
    assert native.reader_name() == "native"


ARRAYS = {
    "float32": np.random.RandomState(0).randn(4, 5, 3).astype(np.float32),
    "float64": np.random.RandomState(1).randn(6, 2),
    "uint8": np.random.RandomState(2).randint(0, 256, (3, 3, 3),
                                              dtype=np.uint8),
    "int16": np.arange(-12, 12, dtype=np.int16).reshape(2, 3, 4),
    "int64": np.arange(10, dtype=np.int64),
    "bool": np.array([[True, False], [False, True]]),
    "fortran": np.asfortranarray(np.random.RandomState(3).rand(3, 4)),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
@pytest.mark.parametrize("container", ["savez", "savez_compressed", "npy"])
def test_reads_what_numpy_reads(lib, tmp_path, name, container):
    x = ARRAYS[name]
    if container == "npy":
        path = str(tmp_path / "x.npy")
        np.save(path, x)
    else:
        path = str(tmp_path / "x.npz")
        getattr(np, container)(path, data=x)
    got, kind = native.read_npz_f32(path, return_kind=True)
    if name == "fortran":  # not read natively: the loader's numpy path
        assert got is None and kind is None
    else:
        assert kind == x.dtype.kind
        np.testing.assert_array_equal(got, x.astype(np.float32))
        assert got.dtype == np.float32 and got.shape == x.shape
    # the per-file loader's read, native or numpy, gives the same array
    mine = folder._load_arr(path)
    want = x if name == "uint8" else x.astype(np.float32)
    np.testing.assert_array_equal(mine.astype(np.float32),
                                  want.astype(np.float32))


def _edge_batch(seed):
    A, _ = make_synthetic_livneh_pair(5, size=8, seed=seed)
    A[1] = 7.0               # a constant sample: 0/0 -> 0
    A[2, 0, 0, 0] = np.inf   # inf scrubbed to FLT_MAX before the min-max
    A[3, :, :, 1] = -np.inf
    return A


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normalization_is_the_numpy_and_jax_one(lib, seed):
    A = _edge_batch(seed)
    with np.errstate(over="ignore", invalid="ignore"):
        want = normalize_bundle(A, use_native=False)
        jax_want = jax_normalize(A, use_native=False)
    got = normalize_bundle(A)  # the native path
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_want)
    assert np.isfinite(got).all() and got.dtype == np.float32


@pytest.mark.parametrize("normalize", [False, True])
def test_batch_read(lib, tmp_path, normalize):
    A = _edge_batch(4)
    paths = []
    for i, x in enumerate(A):
        paths.append(str(tmp_path / ("%d.npz" % i)))
        np.savez(paths[-1], data=x)
    got = native.load_batch_f32(paths, 8, 8, 4, normalize=normalize,
                                n_threads=2)
    if normalize:
        with np.errstate(over="ignore", invalid="ignore"):
            want = normalize_bundle(A, use_native=False)
    else:
        want = A
    np.testing.assert_array_equal(got, want)


def test_rejects_corrupt_and_overdeep_files(lib, tmp_path):
    ok = str(tmp_path / "ok.npz")
    np.savez(ok, data=np.arange(12, dtype=np.float32).reshape(3, 4))
    np.testing.assert_array_equal(
        native.read_npz_f32(ok),
        np.arange(12, dtype=np.float32).reshape(3, 4))
    nine = str(tmp_path / "nine.npy")
    np.save(nine, np.zeros((1,) * 9, np.float32))
    assert native.read_npz_f32(nine) is None

    with zipfile.ZipFile(str(tmp_path / "c.npz"), "w",
                         zipfile.ZIP_DEFLATED) as z:
        z.writestr("data.npy", open(nine, "rb").read())
    blob = bytearray(open(str(tmp_path / "c.npz"), "rb").read())
    i = blob.find(b"PK\x03\x04")
    struct.pack_into("<I", blob, i + 22, 0xFFFFFFFF)  # lie about raw size
    corrupt = str(tmp_path / "corrupt.npz")
    open(corrupt, "wb").write(bytes(blob))
    assert native.read_npz_f32(corrupt) is None
    # one bad file fails the batch cleanly, the process survives
    assert native.load_batch_f32([ok, corrupt], 3, 4, 1,
                                 normalize=False) is None


def test_random_mutations_never_crash(lib, tmp_path):
    rng = np.random.RandomState(0)
    src = str(tmp_path / "fz.npz")
    np.savez(src, data=rng.rand(8, 8, 3).astype(np.float32))
    blob = bytearray(open(src, "rb").read())
    mut = str(tmp_path / "fz_mut.npz")
    for _ in range(150):
        b = bytearray(blob)
        for _ in range(rng.randint(1, 8)):
            b[rng.randint(len(b))] = rng.randint(256)
        open(mut, "wb").write(bytes(b))
        native.read_npz_f32(mut)  # any result is fine; returning is the test


def test_rejects_a_shape_the_payload_does_not_hold(lib, tmp_path):
    p = str(tmp_path / "x.npy")
    np.save(p, np.zeros((4, 4), np.float32))
    blob = open(p, "rb").read()
    open(str(tmp_path / "big.npy"), "wb").write(
        blob.replace(b"(4, 4)", b"(4,44)"))   # 176 elements > 16
    assert native.read_npz_f32(str(tmp_path / "big.npy")) is None
    open(str(tmp_path / "bad.npy"), "wb").write(
        blob.replace(b"(4, 4)", b"(4, x)"))
    assert native.read_npz_f32(str(tmp_path / "bad.npy")) is None


def test_a_failed_build_falls_back_to_numpy_visibly(tmp_path, monkeypatch):
    """No compiler: the readers fall back to numpy with the same arrays, and
    the reason is kept for the CLI's log line."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_ERROR", None)
    monkeypatch.setattr(native, "library_path",
                        lambda: str(tmp_path / "absent.so"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert native.get_lib() is None and not native.native_available()
    assert "no-such-compiler" in native.build_error()
    assert native.reader_name().startswith("numpy (")
    A = _edge_batch(5)
    with np.errstate(over="ignore", invalid="ignore"):
        np.testing.assert_array_equal(normalize_bundle(A),
                                      normalize_bundle(A, use_native=False))
    path = str(tmp_path / "x.npz")
    np.savez(path, data=A[0])
    np.testing.assert_array_equal(folder._load_arr(path), A[0])
    assert native.read_npz_f32(path) is None
