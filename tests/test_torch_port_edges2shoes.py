"""The edges2shoes loader of the port against the JAX package's: a tiny
PIL-written paired-jpg folder (train/ + val/ or test/) and the npz-bundle
branch give equal arrays; without PIL the jpg branch, and both CLIs on
such a folder, refuse with the module's name before writing anything."""

import os
import sys

import numpy as np
import pytest

from domain_transfer_gan_tpu.data import load_edges2shoes as jax_load

from domain_transfer_gan_torch.cli import test as test_cli
from domain_transfer_gan_torch.cli.train import train_model
from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.data import PILMissingError, \
    load_edges2shoes
from domain_transfer_gan_torch.data.synthetic import write_synthetic_dataset


def write_jpg_folder(root, val="val", n_train=6, n_val=3, seed=4):
    from PIL import Image
    rng = np.random.RandomState(seed)
    for sub, n in (("train", n_train), (val, n_val)):
        os.makedirs(os.path.join(root, sub))
        for i in range(n):
            img = (rng.rand(32, 64, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, sub, "%d.jpg" % i))
    return root


@pytest.mark.parametrize("val,size,dev", [("val", 16, 2), ("test", 8, 1),
                                          ("val", 32, 0)])
def test_paired_jpg_folder_is_the_jax_one(tmp_path, val, size, dev):
    pytest.importorskip("PIL")
    root = write_jpg_folder(str(tmp_path / "e2s"), val)
    mine = load_edges2shoes(root, size=size, dev_size=dev)
    theirs = jax_load(root, size=size, dev_size=dev)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert mine[0].shape == (6 - dev, size, size, 3)
    assert mine[4].shape == (3, size, size, 3)
    assert -1.0 <= mine[0].min() and mine[0].max() <= 1.0


def test_npz_branch_is_the_jax_one(tmp_path):
    write_synthetic_dataset(str(tmp_path), n_train=6, n_test=2, size=16)
    for a, b in zip(load_edges2shoes(str(tmp_path), size=16, dev_size=2),
                    jax_load(str(tmp_path), size=16, dev_size=2)):
        np.testing.assert_array_equal(a, b)


def test_a_root_without_either_layout_is_named(tmp_path):
    with pytest.raises(FileNotFoundError, match="neither trainA.npz nor"):
        load_edges2shoes(str(tmp_path))


@pytest.fixture
def no_pil(monkeypatch):
    """An interpreter where ``import PIL`` fails."""
    for name in [m for m in sys.modules if m == "PIL" or
                 m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "PIL", None)


def test_without_pil_the_jpg_branch_names_the_module(tmp_path, no_pil):
    (tmp_path / "train").mkdir()
    (tmp_path / "val").mkdir()
    with pytest.raises(PILMissingError, match="needs the PIL module"):
        load_edges2shoes(str(tmp_path))
    assert issubclass(PILMissingError, ImportError)


def test_without_pil_the_training_cli_refuses_before_writing(tmp_path,
                                                             no_pil):
    root = tmp_path / "edges2shoes"
    (root / "train").mkdir(parents=True)
    argv = ["--dataroot", str(root), "--name", "r", "--checkpoints_dir",
            str(tmp_path / "ck"), "--device", "cpu"]
    with pytest.raises(PILMissingError, match="PIL"):
        train_model(argv=argv)
    with pytest.raises(PILMissingError, match="PIL"):
        train_model(opt=TrainConfig(dataroot=str(root), device="cpu"))
    assert sorted(os.listdir(str(tmp_path))) == ["edges2shoes"]


def test_without_pil_the_evaluation_cli_refuses_before_writing(tmp_path,
                                                               no_pil):
    root = tmp_path / "edges2shoes"
    (root / "train").mkdir(parents=True)
    expr = tmp_path / "run"
    expr.mkdir()
    (expr / "opt.json").write_text('{"model": "aug_cycle_gan"}')
    with pytest.raises(PILMissingError, match="PIL"):
        test_cli.test_model(["--chk_path", str(expr / "latest"),
                             "--dataroot", str(root), "--metric", "mse",
                             "--device", "cpu"])
    assert sorted(os.listdir(str(expr))) == ["opt.json"]
