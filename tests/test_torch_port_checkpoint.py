"""Checkpoints of the port: a bit-exact save / load round trip of a trained
model (every parameter, batch-norm buffer and Adam moment, step, old_lr,
epoch), the async writer's atomic publish and its error path, and the
refusal of what is not a checkpoint of this package."""

import os

import numpy as np
import pytest
import torch

from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.models import create_model
from domain_transfer_gan_torch.utils import checkpoint

from torch_port_helpers import (  # noqa: F401 (a fixture)
    TINY,
    images,
    latents,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _model(tmp_path, **kw):
    cfg = TrainConfig(init_scheme="sane", seed=kw.pop("seed", 1),
                      checkpoints_dir=str(tmp_path), name="ck",
                      **dict(TINY, **kw))
    cfg.finalize()
    return create_model(cfg, testing=True, device="cpu")


def _state(model):
    """Everything a checkpoint must restore, as numpy copies."""
    out = {"step": model.state.step, "old_lr": model.old_lr,
           "old_lr_d": model.old_lr_d, "epoch": model.epoch}
    for name, net in model.nets.items():
        for k, v in net.state_dict().items():
            out["%s/%s" % (name, k)] = v.detach().numpy().copy()
        s = model.state.opt_state[name]
        out["%s/count" % name] = s.count
        for i, (m, v) in enumerate(zip(s.mu, s.nu)):
            out["%s/mu%d" % (name, i)] = m.numpy().copy()
            out["%s/nu%d" % (name, i)] = v.numpy().copy()
    return out


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, (k, got[k], w)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two train steps, batch-norm nets included, then the lr decayed once:
    every part of the payload holds something a fresh model does not."""
    tmp = tmp_path_factory.mktemp("ck")
    m = _model(tmp, norm="batch")
    for it in range(2):
        m.train_instance(images(it, 4), images(it + 5, 4),
                         latents(it, 4, 8), latents(it + 9, 4, 8))
    m.epoch = 7
    m.opt.niter_decay = 3
    m.update_learning_rate()
    return tmp, m


@pytest.mark.parametrize("async_save", [False, True])
def test_round_trip_is_bit_exact(trained, async_save):
    tmp, m = trained
    name = "latest" if async_save else "best_A"
    m.save(name, async_save=async_save)
    m.wait_for_saves()
    want = _state(m)
    fresh = _model(tmp, norm="batch", seed=99)
    assert fresh.state.step == 0
    fresh.load(os.path.join(m.opt.expr_dir, name))
    _assert_same(_state(fresh), want)
    assert fresh.old_lr_d == fresh.old_lr < m.opt.lr  # decay had started


def test_the_file_reads_with_weights_only(trained):
    tmp, m = trained
    m.save("best_B")
    payload = torch.load(os.path.join(m.opt.expr_dir, "best_B"),
                         weights_only=True)
    assert set(payload) == {"format", "nets", "opt_state", "step", "old_lr",
                            "epoch"}
    assert set(payload["nets"]) == set(m.nets)
    assert payload["step"] == 2 and payload["epoch"] == 7
    assert all(t.device.type == "cpu"
               for t in payload["nets"]["netE_B"].values())


def test_async_save_snapshots_before_the_model_moves_on(trained, tmp_path):
    """The writer copies to the CPU at save(): an in-place update after it
    does not reach the file."""
    _, m = trained
    ck = checkpoint.AsyncCheckpointer()
    w = torch.zeros(3)
    ck.save(str(tmp_path / "snap"), {"w": w})
    w.add_(1.0)
    ck.wait()
    assert torch.equal(checkpoint.read_checkpoint(str(tmp_path / "snap"))["w"],
                       torch.zeros(3))
    ck.close()


def test_failed_async_write_keeps_latest_and_raises_at_wait(
        tmp_path, monkeypatch):
    m = _model(tmp_path)
    m.save("latest", async_save=True)
    m.wait_for_saves()
    path = os.path.join(m.opt.expr_dir, "latest")
    before = open(path, "rb").read()

    def broken_save(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", broken_save)
    m.state.step = 5
    m.save("latest", async_save=True)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        m.wait_for_saves()
    assert open(path, "rb").read() == before
    assert not os.path.exists(path + ".tmp")
    monkeypatch.undo()
    m.wait_for_saves()  # the error was handed over once
    m.load(path)
    assert m.state.step == 0


def test_load_refuses_foreign_files(tmp_path):
    m = _model(tmp_path)
    bad = str(tmp_path / "foreign")
    torch.save({"params": {}}, bad)
    with pytest.raises(ValueError, match="not a checkpoint of this package"):
        m.load(bad)
    m.save("other")
    other = _model(tmp_path / "x", norm="batch")
    with pytest.raises(RuntimeError):  # batch-norm buffers the file lacks
        other.load(os.path.join(m.opt.expr_dir, "other"))
