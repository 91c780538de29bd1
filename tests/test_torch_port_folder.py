"""The per-file dataset and its threaded loader (``data/folder.py``) and the
synthetic writers (``data/synthetic.py``) of the port against the JAX
package's, on the same seeded files: writers bit-equal, items and batches
bit-equal (the shuffle and the seeded unaligned B draws included), and the
JAX package's per-file fault F4 kept on both sides."""

import os
import random
import threading
import types

import numpy as np
import pytest

from domain_transfer_gan_tpu.data import folder as jax_folder
from domain_transfer_gan_tpu.data import synthetic as jax_synth

from domain_transfer_gan_torch.data import folder, synthetic


def _opt(root, grid_size=16, dev_size=3, n_threads=1):
    return types.SimpleNamespace(dataroot=str(root), grid_size=grid_size,
                                 dev_size=dev_size, resize_antialias=1,
                                 nThreads=n_threads)


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def perfile(tmp_path_factory):
    """A per-file set of 13 train and 5 test samples, 16x16, from seed 4."""
    root = tmp_path_factory.mktemp("perfile")
    synthetic.write_synthetic_perfile_dataset(str(root), n_train=13,
                                              n_test=5, size=16, seed=4)
    return root


@pytest.mark.parametrize("n,size,seed", [(3, 16, 0), (5, 8, 7), (2, 32, 3)])
def test_livneh_pair_is_bit_equal_to_jax(n, size, seed):
    for mine, theirs in zip(
            synthetic.make_synthetic_livneh_pair(n, size, seed),
            jax_synth.make_synthetic_livneh_pair(n, size, seed)):
        _equal(mine, theirs)  # NaN in the same cells: equal_nan by default
        assert np.isnan(mine).any()


@pytest.mark.parametrize("writer,kw", [
    ("write_synthetic_livneh_dataset", dict(n_train=4, n_test=2, size=8,
                                            seed=1)),
    ("write_synthetic_perfile_dataset", dict(n_train=4, n_test=2, size=8,
                                             seed=2)),
    ("write_synthetic_perfile_dataset", dict(n_train=3, n_test=1, size=8,
                                             channels=1, seed=5)),
])
def test_writers_write_the_jax_files(tmp_path, writer, kw):
    getattr(synthetic, writer)(str(tmp_path / "port"), **kw)
    getattr(jax_synth, writer)(str(tmp_path / "jax"), **kw)
    names = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "port")
                   for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    assert names == sorted(
        os.path.relpath(os.path.join(d, f), tmp_path / "jax")
        for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert names
    for name in names:
        with np.load(tmp_path / "port" / name) as a, \
                np.load(tmp_path / "jax" / name) as b:
            assert a.files == b.files == ["data"]
            _equal(a["data"], b["data"])


@pytest.mark.parametrize("subset", ["train", "dev", "test", "val"])
@pytest.mark.parametrize("load_in_mem", [True, False])
def test_items_are_the_jax_items(perfile, subset, load_in_mem):
    opt = _opt(perfile)
    mine = folder.NumpyDataset(opt, subset, unaligned=False,
                               load_in_mem=load_in_mem)
    theirs = jax_folder.NumpyDataset(opt, subset, unaligned=False,
                                     load_in_mem=load_in_mem)
    assert len(mine) == len(theirs) == {"train": 10, "dev": 3, "test": 5,
                                        "val": 5}[subset]
    for i in range(len(mine)):
        a, b = mine[i], theirs[i]
        _equal(a["A"], b["A"])
        _equal(a["B"], b["B"])
        assert a["A"].shape == (16, 16, 3)


@pytest.mark.parametrize("fraction", [0.5, 0.2])
def test_fraction_and_seeded_unaligned_draws(perfile, fraction):
    opt = _opt(perfile)
    mine = folder.NumpyDataset(opt, "train", unaligned=True,
                               fraction=fraction, seed=9)
    theirs = jax_folder.NumpyDataset(opt, "train", unaligned=True,
                                     fraction=fraction, seed=9)
    assert len(mine) == len(theirs) == int(10 * fraction)
    for i in range(2 * len(mine)):
        a, b = mine[i], theirs[i]
        _equal(a["A"], b["A"])
        _equal(a["B"], b["B"])


def _batches(loader):
    return [(b["A"], b["B"]) for b in loader]


@pytest.mark.parametrize("n_threads", [1, 4])
@pytest.mark.parametrize("shuffle", [False, True])
def test_aligned_batches_are_the_jax_batches(perfile, n_threads, shuffle):
    """The shuffle draws from numpy's global generator in both packages;
    aligned items are the same at any thread count."""
    opt = _opt(perfile, n_threads=n_threads)
    np.random.seed(3)
    mine = _batches(folder.DataLoader(opt, "train", False, 4,
                                      shuffle=shuffle))
    np.random.seed(3)
    theirs = _batches(jax_folder.DataLoader(opt, "train", False, 4,
                                            shuffle=shuffle))
    assert [len(a) for a, _ in mine] == [4, 4, 2]  # the short tail batch
    assert len(mine) == len(theirs)
    for (a, b), (c, d) in zip(mine, theirs):
        _equal(a, c)
        _equal(b, d)


@pytest.mark.parametrize("n_threads", [1, 4])
def test_unaligned_batches_with_seeded_draws_are_the_jax_ones(perfile,
                                                              n_threads):
    """The JAX loader draws B on its worker threads (in whatever order they
    run), the port on the producer in item order: the port's batches at any
    thread count are the JAX loader's at one."""
    np.random.seed(5)
    loader = folder.DataLoader(_opt(perfile, n_threads=n_threads), "train",
                               True, 3, shuffle=True)
    loader.dataset._rng = random.Random(11)
    mine = _batches(loader)
    np.random.seed(5)
    jloader = jax_folder.DataLoader(_opt(perfile, n_threads=1), "train",
                                    True, 3, shuffle=True)
    jloader.dataset._rng = random.Random(11)
    theirs = _batches(jloader)
    assert len(mine) == len(theirs) == 4
    for (a, b), (c, d) in zip(mine, theirs):
        _equal(a, c)
        _equal(b, d)


def test_loader_surface(perfile):
    opt = _opt(perfile, n_threads=2)
    loader = folder.DataLoader(opt, "val", False, 2, drop_last=True)
    assert loader.batch_size == 2 and len(loader) == 5
    assert [len(b["A"]) for b in loader] == [2, 2]
    assert [len(b["A"]) for b in loader.load_data()] == [2, 2]
    # an abandoned iterator releases its producer thread
    before = threading.active_count()
    it = iter(folder.DataLoader(opt, "train", False, 1))
    next(it)
    it.close()
    assert threading.active_count() <= before


def test_a_failing_read_reaches_the_consumer(perfile, monkeypatch):
    loader = folder.DataLoader(_opt(perfile, n_threads=2), "val", False, 2,
                               load_in_mem=False)

    def broken(path):
        raise OSError("unreadable %s" % path)

    monkeypatch.setattr(folder, "_load_arr", broken)
    with pytest.raises(OSError, match="unreadable"):
        list(loader)


@pytest.mark.parametrize("dtype", [np.uint8, np.float64])
def test_uint8_and_float64_files_as_jax_reads_them(tmp_path, dtype):
    rng = np.random.RandomState(0)
    for sub in ("trainA", "trainB"):
        os.makedirs(tmp_path / sub)
        for i in range(3):
            x = (rng.rand(8, 8, 3) * 255).astype(dtype)
            np.savez(tmp_path / sub / ("%d.npz" % i), data=x)
    opt = _opt(tmp_path, grid_size=8, dev_size=0)
    mine = folder.NumpyDataset(opt, "train", unaligned=False)
    theirs = jax_folder.NumpyDataset(opt, "train", unaligned=False)
    for i in range(3):
        _equal(mine[i]["A"], theirs[i]["A"])
    assert mine[0]["A"].dtype == np.float32


def test_a_resized_item_matches_jax(perfile):
    """grid_size 32 from 16x16 files: the port's resize against
    jax.image.resize (the resize's own limit, tests/test_torch_port_data)."""
    opt = _opt(perfile, grid_size=32)
    a = folder.NumpyDataset(opt, "test", unaligned=False)[1]
    b = jax_folder.NumpyDataset(opt, "test", unaligned=False)[1]
    assert a["A"].shape == (32, 32, 3)
    np.testing.assert_allclose(a["A"], b["A"], rtol=0, atol=1e-5)


def test_f4_both_packages_keep_nan_and_four_channels(tmp_path):
    """ROADMAP F4, a fault of the JAX package kept for parity: a per-file
    Livneh-shaped set is neither scrubbed of NaN, nor min-max normalized,
    nor capped at 3 channels on the per-file path, in either package."""
    A, B = synthetic.make_synthetic_livneh_pair(6, size=16, seed=2)
    for sub, arr in (("trainA", A), ("trainB", B)):
        os.makedirs(tmp_path / sub)
        for i, x in enumerate(arr):
            np.savez(tmp_path / sub / ("%05d.npz" % i), data=x)
    opt = _opt(tmp_path, dev_size=0)
    mine = folder.NumpyDataset(opt, "train", unaligned=False)[0]
    theirs = jax_folder.NumpyDataset(opt, "train", unaligned=False)[0]
    _equal(mine["A"], theirs["A"])
    _equal(mine["B"], theirs["B"])
    assert mine["A"].shape == (16, 16, 4) and mine["B"].shape == (16, 16, 1)
    assert np.isnan(mine["A"]).any() and np.isnan(mine["B"]).any()
    finite = mine["A"][np.isfinite(mine["A"])]
    assert finite.min() < -1.0  # (x - 0.5) / 0.5 of unnormalized values
