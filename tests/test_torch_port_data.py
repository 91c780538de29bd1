"""The port's data package against the JAX package's: the npz loader, its
normalization, the seed-123 permutation, the iterators, the synthetic
dataset (all bit for bit) and the resize (within tests/test_resize.py's
tightest bound, rtol 1e-5 / atol 1e-6: float32 sums in another order)."""

import functools
import os

import numpy as np
import pytest

from domain_transfer_gan_tpu.data import iterators as jax_iterators
from domain_transfer_gan_tpu.data import npz as jax_npz
from domain_transfer_gan_tpu.data import resize as jax_resize
from domain_transfer_gan_tpu.data import synthetic as jax_synthetic

from domain_transfer_gan_torch.data import iterators, npz, resize, synthetic

from torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("n", [0, 1, 2, 7, 200, 1013])
def test_py2_seed123_permutation_is_the_jax_one(n):
    got = npz.py2_seed123_permutation(n)
    np.testing.assert_array_equal(got, jax_npz.py2_seed123_permutation(n))
    assert got.dtype == np.int64


def _raw(seed, shape):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-50, 300, shape).astype(np.float64)
    flat = x.reshape(-1)
    flat[rng.rand(flat.size) < 0.05] = np.nan
    flat[rng.rand(flat.size) < 0.01] = np.inf
    flat[rng.rand(flat.size) < 0.01] = -np.inf
    x[0] = 7.0  # a constant sample: hi == lo
    return x


@pytest.mark.parametrize("shape", [(4, 9, 11, 3), (5, 8, 6), (3, 6, 6, 1)])
def test_normalize_bundle_is_the_jax_numpy_path(shape):
    x = _raw(sum(shape), shape)
    got = npz.normalize_bundle(x)
    want = jax_npz.normalize_bundle(x, use_native=False)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("npz"))
    rng = np.random.RandomState(4)
    for name, n in (("trainA", 30), ("trainB", 30), ("testA", 7),
                    ("testB", 7)):
        # 4 channels (the loader keeps 3), NaNs, a foreign dtype
        x = rng.uniform(0, 9, (n, 16, 16, 4)).astype(np.float64)
        x[rng.rand(*x.shape) < 0.02] = np.nan
        np.savez(os.path.join(root, name + ".npz"), data=x)
    return root


@pytest.mark.parametrize("grid_size,antialias", [(None, True), (16, True),
                                                 (8, True)])
def test_load_numpy_data_is_the_jax_one(bundle_dir, grid_size, antialias,
                                        monkeypatch):
    # the JAX side's numpy path (its native loader is bit-exact with it)
    monkeypatch.setattr(jax_npz, "normalize_bundle", functools.partial(
        jax_npz.normalize_bundle, use_native=False))
    got = npz.load_numpy_data(bundle_dir, grid_size=grid_size, dev_size=5,
                              antialias=antialias)
    want = jax_npz.load_numpy_data(bundle_dir, grid_size=grid_size,
                                   dev_size=5, antialias=antialias)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert got[0].shape[0] == 25 and got[2].shape[0] == 5
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        if grid_size in (None, 16):  # no resampling: bit for bit
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("in_hw,out", [((16, 16), 40), ((40, 40), 16),
                                       ((64, 64), 32), ((50, 37), 17)])
def test_resize_matches_the_jax_resize(in_hw, out, antialias):
    x = np.random.RandomState(out).uniform(
        -1, 1, (2,) + in_hw + (3,)).astype(np.float32)
    got = resize.resize_batch(x, out, antialias=antialias)
    want = jax_resize.resize_batch(x, out, antialias=antialias)
    assert got.shape == want.shape == (2, out, out, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_resize_same_size_is_identity():
    x = np.random.RandomState(0).uniform(-1, 1, (2, 8, 8, 3))
    got = resize.resize_batch(x, 8)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.astype(np.float32))


def test_antialias_branch_is_not_the_widened_kernel():
    """The two branches really differ on a downscale (the test above would
    pass vacuously if both called one path)."""
    x = np.random.RandomState(1).uniform(-1, 1, (1, 40, 40, 3)).astype(
        np.float32)
    a = resize.resize_batch(x, 16, antialias=True)
    b = resize.resize_batch(x, 16, antialias=False)
    assert np.abs(a - b).max() > 1e-3


def _batches(it, n):
    out = []
    for _ in range(n):
        try:
            out.append(next(it))
        except StopIteration:
            out.append("stop")
    return out


@pytest.mark.parametrize("kind", ["aligned", "aligned_shuffle", "unaligned",
                                  "unaligned_indices"])
def test_iterators_draw_the_jax_batches(kind):
    """Same np.random state in, same batches in the same order out, across
    two epochs, with the short tail (aligned) and the last-batch backoff
    (unaligned)."""
    A = np.arange(23 * 2, dtype=np.float32).reshape(23, 2)
    B = -A
    seqs = []
    for mod in (iterators, jax_iterators):
        np.random.seed(17)
        if kind.startswith("aligned"):
            it = mod.AlignedIterator(A, B, batch_size=5,
                                     shuffle=kind.endswith("shuffle"))
        else:
            it = mod.UnalignedIterator(A, B, batch_size=5)
            it.yield_indices = kind.endswith("indices")
        seqs.append(_batches(it, 12))
    got, want = seqs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, str):
            assert g == w
            continue
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    if kind == "unaligned_indices":
        assert got[0]["A_idx"].dtype == np.int64
        rows = got[0]["A_idx"]
        np.random.seed(17)
        plain = next(iterators.UnalignedIterator(A, B, batch_size=5))
        np.testing.assert_array_equal(A[rows], plain["A"])


def test_synthetic_pair_and_dataset_are_the_jax_ones(tmp_path):
    got = synthetic.make_synthetic_pair(5, size=16, seed=3)
    want = jax_synthetic.make_synthetic_pair(5, size=16, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    synthetic.write_synthetic_dataset(str(tmp_path / "a"), n_train=6,
                                      n_test=3, size=16)
    jax_synthetic.write_synthetic_dataset(str(tmp_path / "b"), n_train=6,
                                          n_test=3, size=16)
    for f in ("trainA", "trainB", "testA", "testB"):
        with np.load(str(tmp_path / "a" / (f + ".npz"))) as a, \
                np.load(str(tmp_path / "b" / (f + ".npz"))) as b:
            np.testing.assert_array_equal(a["data"], b["data"])
