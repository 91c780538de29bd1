"""The prefetching host feed (``data/feed.py``) and the training CLI's use
of it, on the CPU: there it passes the batches through untouched, in order,
and the CLI with its feed swapped for a synchronous copy per step (how
``chip_smoke.py`` times that way) trains the same model as with the feed.  Its streams, events and pinned buffers
are held on the card by ``tests/test_torch_port_cuda.py``."""

import random

import numpy as np
import pytest
import torch

from domain_transfer_gan_torch.cli.train import full_batches, train_model
from domain_transfer_gan_torch.data import folder
from domain_transfer_gan_torch.data.feed import prefetch_to_device
from domain_transfer_gan_torch.data.synthetic import \
    write_synthetic_perfile_dataset

from torch_port_helpers import load_chip_smoke
from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _batches(n, sizes=None):
    rng = np.random.RandomState(0)
    sizes = sizes or [3] * n
    return [{"A": rng.rand(k, 4, 4, 3).astype(np.float32),
             "B": rng.rand(k, 4, 4, 1).astype(np.float32)} for k in sizes]


@pytest.mark.parametrize("size", [1, 2, 3])
def test_on_the_cpu_the_batches_pass_through(size):
    batches = _batches(5)
    out = list(prefetch_to_device(iter(batches), "cpu", size=size))
    assert len(out) == 5
    assert all(a is b for a, b in zip(out, batches))


def test_a_size_below_one_is_refused():
    with pytest.raises(ValueError, match="size must be >= 1"):
        list(prefetch_to_device(iter(_batches(1)), "cpu", size=0))


def test_full_batches_drops_only_mismatched_pairs():
    batches = _batches(3, [4, 4, 2])
    batches.append({"A": batches[0]["A"], "B": batches[2]["B"]})
    kept = list(full_batches(batches))
    assert [len(b["A"]) for b in kept] == [4, 4, 2]  # the tail is trained


def test_the_synchronous_copy_and_the_feed_train_the_same_model(
        tmp_path, monkeypatch):
    """The CLI through its feed, and through chip_smoke.py's pass-through
    (each step copies its host batch synchronously), trains one model."""
    from domain_transfer_gan_torch.cli import train as train_cli
    cs = load_chip_smoke()
    # the CLI's unaligned B draws are unseeded (random.Random(None)), as in
    # the JAX package: seed them so that the two runs draw the same batches
    real = random.Random
    monkeypatch.setattr(folder.random, "Random",
                        lambda seed=None: real(7 if seed is None else seed))
    root = str(tmp_path / "pf")
    write_synthetic_perfile_dataset(root, n_train=14, n_test=2, size=64,
                                    seed=1)
    models = []
    for way in ("sync", "prefetch"):
        argv = ["--dataroot", root, "--name", way,
                "--checkpoints_dir", str(tmp_path / "ck"), "--grid_size",
                "64", "--batchSize", "4", "--ngf", "4", "--nef", "4",
                "--ndf", "4", "--nlatent", "8", "--niter", "1",
                "--niter_decay", "0", "--print_freq", "0",
                "--display_freq", "0", "--save_epoch_freq", "0",
                "--eval_A_freq", "0", "--eval_B_freq", "0", "--seed", "3",
                "--dev_size", "4", "--numpy_data", "0", "--nThreads", "1",
                "--device", "cpu"]
        if way == "sync":
            with cs.synchronous_feed(train_cli):
                assert train_cli.prefetch_to_device is not \
                    prefetch_to_device
                models.append(train_model(argv=argv))
        else:
            models.append(train_model(argv=argv))
    assert train_cli.prefetch_to_device is prefetch_to_device
    a, b = models
    assert a.state.step == b.state.step == 3
    for name, net in a.nets.items():
        for k, v in net.state_dict().items():
            assert torch.equal(v, b.nets[name].state_dict()[k]), (name, k)

