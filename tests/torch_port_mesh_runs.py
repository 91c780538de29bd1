"""The mesh tests' shared runs: ``parallel/selfcheck.py``'s mesh jobs over
gloo ranks on the CPU against one process, computed once per test session
whichever worker asks first (``test_torch_port_parallel.py::_once``), each
rank process killed on its own timeout."""

import fcntl
import os
import pickle
import re
import threading

import numpy as np
import torch

from domain_transfer_gan_torch.parallel import selfcheck

import torch_port_mesh_ranks
from torch_port_helpers import GRAD_NOISE, GRAD_RTOL

RANK_TIMEOUT = 300  # seconds; four ranks take ~20 s here
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
MOMENTS_RTOL = 0.15  # relative L2 per net of the Adam moments after 2 steps


def once(tmp_path_factory, name, compute):
    """``compute()``'s result, computed by one worker of the session and
    read by the others."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return compute()
    path = tmp_path_factory.getbasetemp().parent / (name + ".pkl")
    with open(str(path) + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(str(path), "rb") as f:
                return pickle.load(f)
        data = compute()
        with open(str(path), "wb") as f:
            pickle.dump(data, f)
        return data


def run_group(names, world, extras=()):
    """The mesh jobs ``names`` over ``world`` ranks (then the rank
    functions ``extras``) and in one process alongside: ({job: (single,
    ranks)}, [each rank's {extra: result}])."""
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
        ranks = selfcheck.run_rank_fn(
            torch_port_mesh_ranks.jobs_then, (jobs, tuple(extras)), world,
            "cpu", timeout=RANK_TIMEOUT, env=ONE_THREAD)
    finally:
        t.join()
    runs = {job["name"]: (singles[job["name"]], [r[0][i] for r in ranks])
            for i, job in enumerate(jobs)}
    return runs, [r[1] for r in ranks]


def as_named(run):
    """selfcheck's recorded gradients as check_step_grads' per-update
    {tensor name: array} dicts."""
    names = run["param_names"]
    return {net: [dict(zip(names[net], upd)) for upd in ups]
            for net, ups in run["grads"].items()}


# biases whose layer feeds an instance norm: their gradient is 0 in exact
# arithmetic (the norm removes a per-channel constant), rounding on both
# sides, and it moves with the summation order of every sum behind it
ZERO_IN_EXACT = {
    "netG_A_B": r"^(conv[0-3]|up0|block\d+\.conv[12])\.bias$",
    "netG_B_A": r"^(conv[0-3]|up0|block\d+\.conv2)\.bias$",
    "netD_A": r"^conv[1-3]\.bias$",
    "netD_B": r"^conv[1-3]\.bias$",
}
ROUNDING = 1e-4  # such a gradient's size, relative to its net's


def check_step1_grads(single, rank):
    """The gradients each run handed a net's clip + Adam at step 1, tensor
    by tensor: ``check_step_grads``' rule (within GRAD_RTOL, L2, where the
    single process's gradient is real, both at rounding level where it is
    not); a gradient that is 0 in exact arithmetic (``ZERO_IN_EXACT``,
    instance-norm configurations) at rounding level on both sides."""
    want_all, got_all = as_named(single), as_named(rank)
    assert set(want_all) == set(got_all)
    instance = single.get("norm", "instance") == "instance"
    for net, ups in want_all.items():
        want, got = ups[0], got_all[net][0]
        assert set(want) == set(got), net
        net_norm = np.sqrt(sum(np.sum(np.square(v)) for v in want.values()))
        zero = ZERO_IN_EXACT.get(net) if instance else None
        for name, w in want.items():
            g, scale = got[name], np.linalg.norm(w)
            if zero and re.match(zero, name):
                assert max(scale, np.linalg.norm(g)) <= ROUNDING * net_norm, (
                    net, name, scale / net_norm)
            elif scale <= GRAD_NOISE * net_norm:
                assert np.linalg.norm(g) <= GRAD_NOISE * net_norm, (
                    net, name, np.linalg.norm(g), net_norm)
            else:
                assert np.linalg.norm(g - w) <= GRAD_RTOL * scale, (
                    net, name, np.linalg.norm(g - w) / scale)


def hold_job(single, ranks):
    """A job over the mesh against one process: ``selfcheck.compare`` at
    the CPU limits (the EMA shadows by their displacement from the start,
    ``selfcheck.hold_shadows``), the step-1 gradients tensor by tensor
    (``check_step_grads``), the Adam moments whole."""
    worst = selfcheck.compare(single, ranks, selfcheck.LIMITS["cpu"])
    if single["steps"]:
        check_step1_grads(single, ranks[0])
    # the moments after the last step follow gradients taken at weights
    # Adam moved apart (the stoch step's netG_A_B gradient is mostly L1
    # signs: 5 % apart after 2 steps); a slice put back in the wrong place
    # would be O(1) off
    for net, want in single["moments"].items():
        got = ranks[0]["moments"][net]
        assert [g.shape for g in got] == [w.shape for w in want], net
        num = np.sqrt(sum(np.sum((g - w) ** 2) for g, w in zip(got, want)))
        den = np.sqrt(sum(np.sum(w ** 2) for w in want))
        assert num <= MOMENTS_RTOL * max(den, 1e-12), (net, num / den)
    return worst
