"""The training CLI's ``--profile_dir`` window on the CPU (ROADMAP F7):
profiler sessions in a row, as ``chip_smoke.py``'s phase 9 runs them before
phase 10's window, then the window's start, its trace written and the log
line that counts the card's kernels in it (none here: the CPU has no card,
and only a card's run warns of an empty trace)."""

import io
import json
import os

import torch
from torch.profiler import ProfilerActivity, profile

from domain_transfer_gan_torch.cli import train


def _work():
    x = torch.randn(64, 64)
    for _ in range(3):
        x = torch.tanh(x @ x.T / 64)
    return x


def test_sessions_in_a_row_then_the_window(tmp_path):
    for _ in range(3):  # phase 9's sessions: each a profiler of its own
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _work()
        assert any(e.name == "aten::mm" for e in prof.events())
    device = torch.device("cpu")
    log = io.StringIO()
    for run in range(2):  # the window twice in one process
        out = str(tmp_path / ("prof%d" % run))
        window = train.start_profiler(device)
        _work()
        train.write_trace(log, window, device, out)
        with open(os.path.join(out, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == "aten::mm" for e in events)
        assert not any(e.get("cat") == "kernel" for e in events)
        assert "profiler trace written to %s: 0 kernel events of the card\n" \
            % out in log.getvalue()
    assert "WARNING" not in log.getvalue()


def test_a_cards_empty_trace_is_not_silent(tmp_path, monkeypatch):
    """On a CUDA device a trace without kernels says so in the log."""
    monkeypatch.setattr(train, "stop_profiler", lambda *a: ("trace.json", 0))
    log = io.StringIO()
    train.write_trace(log, None, torch.device("cuda"), str(tmp_path))
    assert log.getvalue() == ("profiler trace written to %s: 0 kernel events "
                              "of the card (WARNING: none)\n" % tmp_path)
    monkeypatch.setattr(train, "stop_profiler",
                        lambda *a: ("trace.json", 17316))
    log = io.StringIO()
    train.write_trace(log, None, torch.device("cuda"), str(tmp_path))
    assert log.getvalue().endswith(": 17316 kernel events of the card\n")
