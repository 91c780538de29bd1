"""Data parallelism over ranks (``parallel/multihost.py``,
``parallel/mesh.py::DataParallel``, the gradient reduction in
``models/steps.py``, global batch norm, the pools, the sharded evaluation,
the training CLI's ``--num_devices`` and multi-process flags).

Two gloo ranks on the CPU, at tiny width, each in a spawned process on its
half of the batch, against one process on the full batch with the same
weights, data and noise (``parallel/selfcheck.py``: every variant's step,
the supervised step, ``--norm batch``, dropout, the pool with EMA,
``--grad_accum 2``, one batch-norm pass, ``eval_mse_A`` and the UBO).  The
ranks run once per test session, whichever worker asks first (a lock file
shared by the workers); every rank process is killed on its own timeout.
"""

import os
import re
import signal
import subprocess
import sys
import threading

import pytest
import torch

from domain_transfer_gan_torch.cli.train import local_ranks, train_model
from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.data.synthetic import write_synthetic_dataset
from domain_transfer_gan_torch.nn.layers import Dropout
from domain_transfer_gan_torch.parallel import multihost, selfcheck

from torch_port_helpers import load_chip_smoke
from torch_port_helpers import once as _once
from torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 240  # seconds; a pair of ranks takes ~8 s here
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


# two groups, each one pair of rank processes (~8 s apiece here)
GROUPS = (("aug", "stoch", "cycle", "sup", "batch_norm", "dropout"),
          ("norm_batch", "pool", "accum", "eval"))


def _run_group(names):
    jobs = [dict(name=n, record_grads=True) for n in names]
    singles = {}

    def one_process():
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            for job in jobs:
                singles[job["name"]] = selfcheck.run_job(**job)
        finally:
            torch.set_num_threads(threads)

    t = threading.Thread(target=one_process)
    t.start()
    try:
        ranks = selfcheck.run_ranks(jobs, world=2, device="cpu",
                                    timeout=RANK_TIMEOUT, env=ONE_THREAD)
    finally:
        t.join()
    return {job["name"]: (singles[job["name"]], [r[i] for r in ranks])
            for i, job in enumerate(jobs)}


@pytest.fixture(scope="module")
def runs_0(tmp_path_factory):
    return _once(tmp_path_factory, "data_parallel_runs_0",
                 lambda: _run_group(GROUPS[0]))


@pytest.fixture(scope="module")
def runs_1(tmp_path_factory):
    return _once(tmp_path_factory, "data_parallel_runs_1",
                 lambda: _run_group(GROUPS[1]))


@pytest.fixture
def runs(request):
    return request.getfixturevalue(
        "runs_%d" % (request.node.callspec.params.get("job", "pool")
                     not in GROUPS[0]))


def test_the_groups_cover_every_job():
    assert sorted(GROUPS[0] + GROUPS[1]) == sorted(selfcheck.JOBS)


@pytest.mark.parametrize("job", [j for g in GROUPS for j in g])
def test_two_ranks_match_one_process_on_the_full_batch(runs, job):
    """Step-1 losses within 1e-5 and gnorms within 1e-4 relative, later
    steps within the two-step parity limits, parameters by
    ``check_two_step_parity``'s rule, running statistics and the
    evaluation's numbers likewise; the two ranks equal bit for bit."""
    single, ranks = runs[job]
    worst = selfcheck.compare(single, ranks, selfcheck.LIMITS["cpu"])
    assert len(ranks) == 2
    if selfcheck.JOBS[job][3] in ("main", "sup"):
        assert len(single["steps"]) == selfcheck.JOBS[job][2]
    assert worst["loss1"] <= 1e-5 and worst["gnorm1"] <= 1e-4


def test_batch_norm_takes_global_statistics(runs_0):
    """One train-mode pass of the batch-norm nets over two halves equals
    the pass over the whole batch, running statistics included."""
    single, ranks = runs_0["batch_norm"]
    selfcheck.compare(single, ranks, selfcheck.LIMITS["cpu"])
    key = "netE_B.nr1.norm.bn.running_var"
    assert key in single["stats1"]
    assert abs(ranks[0]["stats1"][key] - single["stats1"][key]).max() < 1e-6


def test_the_pools_are_the_single_process_pools(runs_1):
    single, ranks = runs_1["pool"]
    for r in ranks:
        for name, (buf, n) in single["pools"].items():
            assert r["pools"][name][1] == n == 3
    assert (ranks[0]["pools"]["fake_A"][0] == ranks[1]["pools"]["fake_A"][0]
            ).all()


# ---------------------------------------------------------------------------
# the pieces, without processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [("127.0.0.1:1234", 0, -1),
                                  ("", 2, 0), ("", 0, 1),
                                  ("127.0.0.1:1234", 2, 2)],
                         ids=["no_count", "no_coordinator", "id_alone",
                              "id_out_of_range"])
def test_initialize_refuses_a_partial_spec(spec):
    with pytest.raises(ValueError, match=re.escape(
            "multi-host needs --coordinator host:port, --num_processes > 1 "
            "AND --process_id in [0, num_processes)")):
        multihost.initialize(*spec)


def test_initialize_without_a_spec_is_single_process():
    assert multihost.initialize() is False
    assert multihost.process_count() == 1 and multihost.is_primary()


@pytest.mark.parametrize("layout,want", [
    (("cpu", 2, 0), "gloo"), (("cuda", 1, 1), "nccl"),
    (("cuda", 2, 1), "gloo"), (("cuda", 2, 2), "nccl"),
    (("cuda", 4, 2), "gloo"), (("cuda", 1, 0), "gloo")])
def test_the_backend_follows_the_layout(layout, want):
    assert multihost.choose_backend(*layout) == want


def test_ranks_per_host(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert multihost.ranks_per_host("127.0.0.1:9", 2) == 2
    assert multihost.ranks_per_host("localhost:9", 3) == 3
    assert multihost.ranks_per_host("10.0.0.7:9", 4) == 1
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert multihost.ranks_per_host("10.0.0.7:9", 4) == 2


def test_num_devices_counts_like_jax(monkeypatch):
    """0 is every visible card on CUDA (one process on the CPU); more than
    are visible is refused by name."""
    assert local_ranks(TrainConfig(device="cpu")) == 1
    assert local_ranks(TrainConfig(device="cpu", num_devices=3)) == 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert local_ranks(TrainConfig(device="cuda")) == 4
    assert local_ranks(TrainConfig(device="cuda", num_devices=2)) == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--num_devices 2 asks for 2 CUDA "
                                         "cards, but 1 are visible"):
        local_ranks(TrainConfig(device="cuda", num_devices=2))


def test_dropout_on_a_slice_keeps_the_full_batch_mask(monkeypatch):
    """On rank 1 of 2 the mask is rows 2-3 of the mask one process draws
    for the batch of 4, and the generator ends where it would."""
    drop = Dropout(0.5)
    x = torch.ones(4, 3, 5, 5)
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(7)
    g2.manual_seed(7)
    drop.generator = g1
    full = drop(x)
    layout = type("Layout", (), {"batch": multihost.Axis((0, 1), 1)})()
    monkeypatch.setattr(multihost, "shard_info", lambda: layout)
    drop.generator = g2
    assert torch.equal(drop(x[2:]), full[2:])
    assert torch.equal(g1.get_state(), g2.get_state())


def test_a_failing_rank_ends_the_run():
    """A rank that raises ends the run with the error, without waiting for
    the timeout."""
    with pytest.raises(RuntimeError, match="ranks failed"):
        selfcheck.run_ranks([dict(name="no such job")], world=2,
                            device="cpu", timeout=RANK_TIMEOUT,
                            env=ONE_THREAD)


def test_local_rows_refuses_a_batch_that_does_not_divide():
    with pytest.raises(ValueError, match="a batch of 3 does not divide "
                                         "over 2 ranks"):
        multihost.local_rows(torch.zeros(3, 2), 0, 2)
    assert multihost.local_rows(torch.arange(6), 2, 3).tolist() == [4, 5]


# ---------------------------------------------------------------------------
# the training CLI over ranks
# ---------------------------------------------------------------------------

def _argv(root, ckpt, name, batch=4, extra=(), seed=3):
    return ["--dataroot", root, "--name", name, "--checkpoints_dir", ckpt,
            "--grid_size", "64", "--batchSize", str(batch), "--ngf", "4",
            "--nef", "4", "--ndf", "4", "--nlatent", "8", "--niter", "1",
            "--niter_decay", "0", "--print_freq", str(batch),
            "--display_freq", str(2 * batch), "--save_epoch_freq", "1",
            "--dev_size", "4", "--eval_B_freq", "0", "--device", "cpu",
            *(["--seed", str(seed)] if seed is not None else []), *extra]


def _losses(path):
    """The loss lines of a results.txt without their timings."""
    with open(path) as f:
        return [re.sub(r"time: [0-9.]+", "", line) for line in f
                if "D_A:" in line or "gnorm_" in line]


def _written(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_data"))
    write_synthetic_dataset(root, n_train=12, n_test=4, size=64)
    return root


def _check_two_ranks(ckpt, name):
    expr = os.path.join(ckpt, name)
    worker = os.path.join(expr, ".worker1")
    assert os.listdir(ckpt) == [name]
    for d in (expr, worker):
        for f in ("latest", "best_A", "results.txt", "history_mse_A.npy"):
            assert os.path.exists(os.path.join(d, f)), (d, f)
    with open(os.path.join(expr, "results.txt")) as f:
        log = f.read()
    assert "SPMD over 2 devices (data-parallel)" in log
    assert "rank 0 of 2 on cpu (gloo)" in log
    mine, theirs = (_losses(os.path.join(d, "results.txt"))
                    for d in (expr, worker))
    assert mine and mine == theirs
    # rank 1 wrote only under .worker1/
    outside = [p for p in _written(expr) if not p.startswith(".worker1")]
    assert all(not p.startswith(".worker") for p in outside)


def _run_cli(argv):
    """The training CLI in a process of its own session, so that on its
    timeout the ranks it spawned are killed with it; returns its output."""
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD)
    p = subprocess.Popen(
        [sys.executable, "-m", "domain_transfer_gan_torch.cli.train", *argv],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        out = p.communicate(timeout=RANK_TIMEOUT)[0]
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    assert p.returncode == 0, out[-3000:]
    return out


def test_num_devices_2_on_the_cpu(dataset, tmp_path):
    ckpt = str(tmp_path / "ck")
    _run_cli(_argv(dataset, ckpt, "dp", extra=("--num_devices", "2")))
    _check_two_ranks(ckpt, "dp")


def _two_processes(dataset, ckpt, name, batch=4, seed=3):
    """The training CLI as ranks 0 and 1 of two processes (the multi-host
    flags), each killed on its own timeout; returns their outputs."""
    flags = ["--coordinator", "127.0.0.1:%d" % multihost.free_port(),
             "--num_processes", "2"]
    env = dict(os.environ, PYTHONPATH=ROOT, **ONE_THREAD)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "domain_transfer_gan_torch.cli.train",
         *_argv(dataset, ckpt, name, batch=batch, seed=seed,
                extra=flags + ["--process_id", str(r)])],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    return outs


def test_two_processes_with_the_multi_host_flags(dataset, tmp_path):
    ckpt = str(tmp_path / "ck")
    outs = _two_processes(dataset, ckpt, "mp")
    _check_two_ranks(ckpt, "mp")
    assert "backend gloo" in outs[1]
    # the option dumps of rank 1 live in its own directory
    assert os.path.exists(os.path.join(ckpt, "mp", ".worker1", "opt.json"))


def test_a_batch_that_does_not_divide_runs_unsharded(dataset, tmp_path):
    """Without --seed too: the ranks share rank 0's seed, so they draw the
    same batches and log the same losses."""
    ckpt = str(tmp_path / "ck")
    _two_processes(dataset, ckpt, "odd", batch=3, seed=None)
    with open(os.path.join(ckpt, "odd", "results.txt")) as f:
        log = f.read()
    assert "WARNING: 2 devices visible but batchSize 3 does not divide " \
           "the batch-sharding axes (2) — running UNSHARDED" in log
    assert "SPMD over" not in log
    assert _losses(os.path.join(ckpt, "odd", "results.txt")) == _losses(
        os.path.join(ckpt, "odd", ".worker1", "results.txt"))


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 11, its formulas and a rehearsal on the CPU
# ---------------------------------------------------------------------------

TINY_WIDTH = dict(ngf=4, nef=4, ndf=4, n_blocks=3, nlatent=8)


class _PlainCounts:
    """The kernel wrapper's calls of its plain versions on the CPU, by
    direction and (N, HW, C): what its launches on the card would be."""

    def __init__(self, monkeypatch):
        from domain_transfer_gan_torch.ops.kernels import instance_norm as K
        self.seen = {"fwd": {}, "bwd": {}}
        for d, name in (("fwd", "instance_norm_plain"),
                        ("bwd", "instance_norm_bwd_plain")):
            monkeypatch.setattr(K, name, self._counting(d, getattr(K, name)))

    def _counting(self, direction, fn):
        def wrapped(x, *a, **kw):
            key = (x.shape[0], x.shape[1] * x.shape[2], x.shape[3])
            self.seen[direction][key] = self.seen[direction].get(key, 0) + 1
            return fn(x, *a, **kw)
        return wrapped

    def reset(self):
        self.seen = {"fwd": {}, "bwd": {}}

    def read(self):
        return {d: dict(v) for d, v in self.seen.items()}


@pytest.mark.parametrize("job", ["aug", "norm_batch", "pool", "batch_norm",
                                 "eval"])
def test_chip_smoke_holds_a_rank_to_the_half_batch_structure(job,
                                                             monkeypatch):
    """A rank launches what one process launches on its half of the batch
    (data parallelism adds collectives only): what phase 11 holds each
    rank's counters to."""
    cs = load_chip_smoke()
    counts = _PlainCounts(monkeypatch)
    if job == "eval":
        selfcheck.run_job("eval", batch=2, ubo_steps=3)
        want = cs.p11_eval_expected(4, 3, TINY_WIDTH)
    else:
        selfcheck.run_job(job, batch=2, steps=2)
        want = cs.p11_rank_expected(job, 4, steps=2, width=TINY_WIDTH)
    assert counts.read() == want


@pytest.mark.slow
def test_chip_smoke_phase11_runs_on_the_cpu(tmp_path, monkeypatch):
    """The whole of phase 11 at tiny width on the CPU (~3 min), after a
    one-epoch stand-in for phase 7's run: the flax round trip and resume,
    the two-process CLI, the steps over two ranks against one process."""
    cs = load_chip_smoke()
    data = dict(n_train=420, n_test=50, dev_size=100)
    monkeypatch.setattr(cs, "CLI_DATA", data)
    # at width 4 the bfloat16 step's netG_A_B gradient explodes by step 3
    # in one process as well (1.9e11 here): the card runs that job at full
    # width, where phase 5 holds it
    monkeypatch.setattr(cs, "P11_JOBS", tuple(
        j for j in cs.P11_JOBS if j[2] == "float32"))
    for k, v in ONE_THREAD.items():
        monkeypatch.setenv(k, v)
    counts = _PlainCounts(monkeypatch)
    tmp = str(tmp_path)
    write_synthetic_dataset(tmp + "/cli_data", n_train=data["n_train"],
                            n_test=data["n_test"], size=64)
    train_model(argv=cs._cli_argv(tmp + "/cli_data", tmp + "/cli_runs", "cpu",
                                  TINY_WIDTH, ["--niter_decay", "0"]))
    totals, _, fig = cs.drive_phase11(torch, None, tmp, "cpu", device="cpu",
                                      width=TINY_WIDTH, counters=counts)
    assert fig["flax_round_trip_max_abs_err"] == 0.0
    assert fig["two_process_test_mse_A_vs_one_process"] <= 1e-6
    assert set(fig["steps"]) == {j[0] for j in cs.P11_JOBS} | {"eval_B"}
    assert "aug_float32" in fig["steps"]
    assert sum(totals["float32"]["fwd"].values()) > 0
    assert fig["nccl"].startswith("not run")


def test_to_host_outside_a_shard_is_a_copy():
    """One process (or a batch computed whole): ``to_host`` reads the value
    as it is, through trees too."""
    t = torch.arange(6.0).reshape(3, 2)
    tree = multihost.to_host_tree({"a": t, "b": [t[:1], t.numpy()]})
    assert (tree["a"] == t.numpy()).all() and tree["b"][0].shape == (1, 2)
    assert (tree["b"][1] == t.numpy()).all()
    with multihost.sharded():  # one process: nothing to gather
        assert multihost.shard_info() is None
        assert (multihost.to_host(t) == t.numpy()).all()
