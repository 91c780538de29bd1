"""Training over a mesh of ranks held against one process, on any device.

Runs the same jobs (a few train steps of a configuration, or the sharded
evaluation) once in this process on the full batch and once over ``world``
ranks, each rank a process started with ``spawn`` that computes on its
part through ``parallel.DataParallel``, and compares them: losses and
gradient norms per step, every parameter and running statistic after the
last step, the pools and EMA shadows, the evaluation's numbers.  The ranks
must also agree with each other bit for bit (one all-reduced gradient, one
update).  Every job's weights, inputs and noise come from its seed.

``JOBS`` are data-parallel over any world; ``MESH_JOBS`` lay their ranks
out as a ``data x space x model x pipe`` mesh (``--spatial``, ``--tensor``,
``--pipeline``, ``--microbatches`` in the job's flags) and name the world
they take: ``pp*`` the GPipe trunks (M = S and M = 2S, the stoch and
supervised steps, EMA, the unpipelined evaluation), ``sp*`` the row slices,
``tp*`` the channel slices, ``dp_*`` / ``sp_tp`` two axes over 4 ranks,
``dp_sp_tp`` all three SPMD axes over 8 (``data x space x model``, 2x2x2).

    python -m domain_transfer_gan_torch.parallel.selfcheck --device cpu
    python -m domain_transfer_gan_torch.parallel.selfcheck --device cpu \\
        --jobs pp,pp_m4,sp,tp,pp_eval,sp_eval,tp_eval
    python -m domain_transfer_gan_torch.parallel.selfcheck --device cpu \\
        --world 4 --jobs dp_pp,dp_pp_m4,dp_sp,dp_tp,sp_tp
    python -m domain_transfer_gan_torch.parallel.selfcheck --device cpu \\
        --jobs dp_sp_tp
    python -m domain_transfer_gan_torch.parallel.selfcheck --device cuda \\
        --width full --jobs aug,norm_batch,pool

``run_job`` runs one job in the calling process (``DataParallel`` when the
process group is up); ``run_ranks`` starts the ranks, waits for them (a
rank still running after ``timeout`` seconds is killed, and so are the
others) and returns what each rank saw; ``compare`` holds a rank's results
to the single process's.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.kernels import pad as pad_kernels
from . import multihost, pipeline

TINY = dict(ngf=4, nef=4, ndf=4, nlatent=8, n_blocks=3)
FULL = dict(ngf=32, nef=32, ndf=64, nlatent=16, n_blocks=3)

# name -> (config flags, batch, steps, kind)
JOBS = {
    "aug": ({}, 4, 2, "main"),
    "stoch": ({"model": "stoch_cycle_gan"}, 4, 2, "main"),
    "cycle": ({"model": "cycle_gan"}, 4, 2, "main"),
    "sup": ({}, 4, 2, "sup"),
    "norm_batch": ({"norm": "batch"}, 4, 2, "main"),
    "dropout": ({"use_dropout": True}, 4, 2, "main"),
    "pool": ({"pool_size": 3, "ema": 0.9}, 4, 2, "main"),
    "accum": ({"grad_accum": 2}, 8, 2, "main"),
    "eval": ({}, 4, 3, "eval"),
    "batch_norm": ({"norm": "batch"}, 4, 1, "norm"),
}

_PP = {"n_blocks": 4, "pipeline": 2}
# name -> (config flags, batch, steps, kind, world): jobs over a mesh
MESH_JOBS = {
    "pp": (_PP, 8, 2, "main", 2),
    "pp_m4": (dict(_PP, microbatches=4), 8, 2, "main", 2),
    "pp_stoch": (dict(_PP, model="stoch_cycle_gan"), 8, 2, "main", 2),
    "pp_sup": (_PP, 8, 2, "sup", 2),
    "pp_ema": (dict(_PP, ema=0.9), 8, 2, "main", 2),
    "pp_eval": (_PP, 8, 3, "eval", 2),
    "sp": ({"spatial": 2}, 4, 2, "main", 2),
    "sp_eval": ({"spatial": 2}, 4, 3, "eval", 2),
    "tp": ({"tensor": 2}, 4, 2, "main", 2),
    "tp_eval": ({"tensor": 2}, 4, 3, "eval", 2),
    "tp_ema": ({"tensor": 2, "ema": 0.9}, 4, 2, "main", 2),
    "dp_pp": (_PP, 8, 2, "main", 4),
    "dp_pp_m4": (dict(_PP, microbatches=4), 8, 2, "main", 4),
    "dp_sp": ({"spatial": 2}, 4, 2, "main", 4),
    "dp_tp": ({"tensor": 2}, 4, 2, "main", 4),
    "sp_tp": ({"spatial": 2, "tensor": 2}, 4, 2, "main", 4),
    "dp_sp_tp": ({"spatial": 2, "tensor": 2}, 8, 2, "main", 8),
}


def _job(name: str):
    """(flags, batch, steps, kind) of a job of either table."""
    if name in JOBS:
        return JOBS[name]
    return MESH_JOBS[name][:4]


# (step-1 losses, step-1 gnorms, later steps' losses, later gnorms),
# relative, as phase 5 of chip_smoke.py holds its twins; the CPU's are
# tighter (the same float32 code, other summation orders only)
LIMITS = {
    "cpu": (1e-5, 1e-4, 5e-3, 4e-2),
    "float32": (1e-4, 2e-3, 1e-2, 2e-1),
    "bfloat16": (1e-2, 8e-2, 5e-2, 5e-1),
}
# a batch-norm pass from equal weights: its statistics and loss, relative
BN_RTOL = 1e-5
# the UBO after one RMSprop step and after the last, relative (phase 7 of
# chip_smoke.py holds the kernels against the plain norms so)
UBO_RTOL = (1e-5, 1e-3)
LR = 2e-4  # the jobs' Adam learning rate (the configs' default)
# the EMA shadows' difference, relative L2, over their displacement from
# the start (:func:`hold_shadows`)
EMA_DISP_RTOL = 0.3


def job_config(name: str, width=TINY, device="cpu", batch=None,
               compute_dtype="float32", seed=0, **extra):
    """The ``TrainConfig`` of job ``name``."""
    from ..config import TrainConfig

    flags, default_batch, _, _ = _job(name)
    cfg = dict(model="aug_cycle_gan", grid_size=64, init_scheme="sane",
               monitor_gnorm=True, seed=seed, device=str(device),
               batchSize=batch or default_batch,
               compute_dtype=compute_dtype)
    cfg.update(width)
    cfg.update(flags)
    cfg.update(extra)
    cfg.pop("supervised", None)
    return TrainConfig(**cfg)


def _inputs(seed: int, n: int, nlatent: int, steps: int):
    rng = np.random.RandomState(seed)
    A = rng.uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32)
    B = rng.uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32)
    zs = [rng.randn(n, nlatent).astype(np.float32) for _ in range(steps)]
    return A, B, zs


def _launch_counts(what="launches_by_shape"):
    from ..ops.kernels.instance_norm import (instance_norm_bwd_fused,
                                             instance_norm_fused)
    return {"fwd": dict(getattr(instance_norm_fused, what)),
            "bwd": dict(getattr(instance_norm_bwd_fused, what))}


def _split_counts(what="launches_by_shape"):
    from ..ops.kernels.instance_norm import SPLIT_WRAPPERS
    return {w.__name__: dict(getattr(w, what)) for w in SPLIT_WRAPPERS}


def _split_norms():
    """The split norms of this process by (N, HW, C)."""
    from ..ops.kernels.instance_norm import instance_norm_split
    return dict(instance_norm_split.calls_by_shape)


def _reset_counts():
    from ..ops.kernels.instance_norm import (SPLIT_WRAPPERS,
                                             instance_norm_bwd_fused,
                                             instance_norm_fused,
                                             instance_norm_split)
    for w in (instance_norm_fused, instance_norm_bwd_fused):
        w.launches = 0
        w.launches_by_shape = {}
        w.launches_by_variant = {}
    for w in SPLIT_WRAPPERS:
        w.launches = 0
        w.launches_by_shape = {}
        w.launches_by_variant = {}
    instance_norm_split.calls_by_shape = {}


def _floats(d) -> Dict[str, float]:
    keys = list(d)
    vals = torch.stack([torch.as_tensor(d[k]).float().reshape(())
                        for k in keys]).tolist()
    return dict(zip(keys, vals))


def _norm_pass(model, A, B) -> dict:
    """One train-mode forward of the batch-norm nets (``netG_B_A`` under
    ``--norm batch``, ``netE_B``) and the gradients of a sum of their
    outputs' mean squares, averaged over ranks as a step averages them:
    the loss, the gradients and the running statistics it leaves."""
    nets = model.state.nets
    sharded = multihost.process_count() > 1
    scope = contextlib.nullcontext()
    if sharded:
        A, B = model.local_image(A), model.local_image(B)
        scope = model.sharded()
    with scope:
        params = [p for k in ("netG_B_A", "netE_B")
                  for p in nets[k].parameters()]
        mu, logvar = nets["netE_B"](torch.cat([A, B], dim=-1))
        loss = (nets["netG_B_A"](B).float() ** 2).mean() + \
            (mu.float() ** 2).mean() + (logvar.float() ** 2).mean()
        grads = torch.autograd.grad(loss, params)
        if sharded:
            grads = multihost.all_reduce_mean_list(grads)
            loss = multihost.all_reduce_(loss.detach().clone()) / \
                multihost.process_count()
    return {"norm_loss": float(loss.detach()),
            "norm_grads": [g.detach().float().cpu().numpy() for g in grads],
            "stats1": _running_stats(nets)}


def _running_stats(nets) -> Dict[str, np.ndarray]:
    return {"%s.%s" % (k, n): v.detach().float().cpu().numpy()
            for k, net in nets.items() for n, v in net.named_buffers()
            if n.rsplit(".", 1)[-1].startswith("running_")}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _whole_grads(net, grads):
    """A net's gradients as one process holds them: the slices a model axis
    holds gathered over it."""
    from .mesh import slices_of

    sliced = slices_of(net)
    if sliced is None:
        return list(grads)
    axis, dims = sliced
    return [g if d is None else multihost.all_gather_cat(
        g.contiguous(), axis, d) for g, d in zip(grads, dims.values())]


@contextlib.contextmanager
def _recording_grads(state, seen):
    """Record the gradients every network's update applies (after the
    mean over ranks; whole under a model axis), per step, as numpy:
    ``seen[net]`` is a list with one list of arrays per update."""
    from ..models import steps as steps_mod

    orig = steps_mod.apply_net_update
    names = {id(s): k for k, s in state.opt_state.items()}

    def recording(params, opt, grads, *a, **kw):
        name = names[id(opt)]
        seen.setdefault(name, []).append(
            [g.detach().float().cpu().numpy()
             for g in _whole_grads(state.nets[name], grads)])
        return orig(params, opt, grads, *a, **kw)

    steps_mod.apply_net_update = recording
    try:
        yield seen
    finally:
        steps_mod.apply_net_update = orig


def _whole(model):
    """A context in which a model over a mesh holds one process's tensors
    (``DataParallel._whole``)."""
    from .mesh import DataParallel

    if isinstance(model, DataParallel):
        return model._whole()
    return contextlib.nullcontext()


def _shadows(state):
    """The EMA shadows as numpy copies (the updates are in place)."""
    return {k: [t.detach().cpu().numpy().copy() for t in v]
            for k, v in state.ema.items()}


def run_job(name: str, device="cpu", width=TINY, batch=None, steps=None,
            compute_dtype="float32", seed=0, ubo_steps=3,
            record_grads=False, ckpt=None, eps=None, **extra) -> dict:
    """One job in this process: over the process group's ranks when there
    are several, else on the full batch.  ``ckpt`` (a checkpoint either
    package wrote) replaces the seed's weights; ``eps`` (one (batch,
    nlatent) array per step) replaces the posterior noise draws.  Returns
    per step the losses and gnorms (floats) and the wall ms of the step,
    the final state (numpy), the launch counts by shape and the seconds
    spent in collectives; with ``record_grads`` the gradients of every
    update too."""
    _, _, default_steps, kind = _job(name)
    cfg = job_config(name, width, device, batch, compute_dtype, seed,
                     **extra)
    steps = steps or default_steps
    on_card = torch.device(device).type == "cuda"
    if on_card:  # full float32 on the card
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    # the evaluation with cuDNN's algorithms pinned on the card: its numbers
    # repeat bit for bit from run to run (the UBO's RMSprop steps turn a
    # last-bit difference into one of ~1e-4)
    keep = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = keep or (on_card and kind == "eval")
    try:
        return _run_job(device, cfg, kind, steps, seed, ubo_steps,
                        record_grads, ckpt, eps)
    finally:
        torch.backends.cudnn.deterministic = keep


def _run_job(device, cfg, kind, steps, seed, ubo_steps, record_grads, ckpt,
             eps) -> dict:
    from ..eval.metrics import eval_mse_A, variational_ubo
    from ..models import create_model
    from .mesh import DataParallel, state_bytes

    model = create_model(cfg, testing=True, device=device)
    if ckpt is not None:
        model.load(ckpt)
    if multihost.process_count() > 1:
        model = DataParallel(model, spatial=cfg.spatial, tensor=cfg.tensor,
                             pipeline=cfg.pipeline,
                             microbatches=cfg.microbatches)
    A, B, zs = _inputs(seed + 1, cfg.batchSize, cfg.nlatent, steps)
    A, B = model._tensor(A), model._tensor(B)
    out = {"steps": [], "ms": [], "ema_decay": cfg.ema}
    with _whole(model):  # the shadows' start, to hold their displacement
        out["ema_start"] = _shadows(model.state)
    _sync(device)
    _reset_counts()
    pipeline.trunk_runs[0] = 0
    multihost.collective_seconds[0] = 0.0
    multihost.timing[0] = torch.device(device).type == "cuda"
    seen = {}
    with contextlib.ExitStack() as stack:
        stack.callback(multihost.timing.__setitem__, 0, False)
        if record_grads:
            stack.enter_context(_recording_grads(model.state, seen))
        if kind == "norm":
            out.update(_norm_pass(model, A, B))
        if kind == "eval":
            out["mse"] = eval_mse_A([{"A": A, "B": B}], model)
            for key, n in (("ubo1", 1), ("ubo", ubo_steps)):
                ubo, kld, bpp = variational_ubo(model, A, B, n,
                                                pad_to=cfg.batchSize)
                out[key] = {"ubo": ubo, "kld": kld, "bpp": bpp}
        for it, z in enumerate(zs if kind in ("main", "sup") else ()):
            e = None if eps is None else eps[it]
            t0 = time.perf_counter()
            if kind == "sup":
                res = model.supervised_train_instance(A, B, z, e)
                losses = {k: v for k, v in res.items()
                          if not k.startswith("gnorm")}
                gnorms = {k: v for k, v in res.items()
                          if k.startswith("gnorm")}
            elif e is not None:
                losses, _, gnorms = model.train_instance(A, B, z,
                                                         eps_post=e)
            else:
                losses, _, gnorms = model.train_instance(A, B, z)
            _sync(device)
            out["ms"].append(1e3 * (time.perf_counter() - t0))
            out["steps"].append({"losses": _floats(losses),
                                 "gnorms": _floats(gnorms)})
            if "stats1" not in out:
                out["stats1"] = _running_stats(model.state.nets)
    out["grads"] = seen
    out["norm"] = cfg.norm
    out["param_names"] = {k: [n for n, _ in net.named_parameters()]
                          for k, net in model.state.nets.items()}
    out["collective_s"] = multihost.collective_seconds[0]
    out["launches"] = _launch_counts()
    out["launches_by_variant"] = _launch_counts("launches_by_variant")
    # the pad kernels' launches of this process so far (a rank's total in
    # its last job's result)
    out["pad_launches"] = {w.__name__: dict(w.launches_by_shape)
                           for w in pad_kernels.WRAPPERS}
    out["split_launches"] = _split_counts()
    out["split_variants"] = _split_counts("launches_by_variant")
    out["trunk_runs"] = pipeline.trunk_runs[0]
    out["split_shapes"] = _split_norms()
    out["split_norms"] = sum(out["split_shapes"].values())
    state = model.state
    out["bytes_held"] = state_bytes(state)
    with _whole(model):  # one process's tensors under a model axis
        out["state"] = {k: {n: v.detach().float().cpu().numpy()
                            for n, v in net.state_dict().items()}
                        for k, net in state.nets.items()}
        out["ema"] = _shadows(state)
        out["moments"] = {k: [t.cpu().numpy() for t in s.mu + s.nu]
                          for k, s in state.opt_state.items()}
    out["pools"] = {k: (p.buf.cpu().numpy(), p.n)
                    for k, p in state.pools.items()}
    out["counts"] = {k: s.count for k, s in state.opt_state.items()}
    return out


def _rank_main(rank: int, world: int, coordinator: str, backend: str,
               device: str, target, args, out_dir: str) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        dev = torch.device("cuda", multihost.local_rank(rank, n))
        if backend == "nccl":
            torch.cuda.set_device(dev)
    multihost.initialize(coordinator, world, rank, backend=backend)
    try:
        result = target(dev, *args)
        # every rank done (on the rank's device: NCCL takes no CPU tensor)
        multihost.all_reduce_(torch.zeros(1, device=dev))
    finally:
        multihost.shutdown()
    torch.save(result, os.path.join(out_dir, "rank%d.pt" % rank))


def _run_jobs(device, jobs):
    return [run_job(device=device, **job) for job in jobs]


def run_ranks(jobs: List[dict], world: int = 2, device: str = "cpu",
              backend: Optional[str] = None, timeout: float = 300.0,
              env: Optional[Dict[str, str]] = None) -> List[List[dict]]:
    """Run ``jobs`` (keyword arguments of :func:`run_job`) over ``world``
    ranks in as many spawned processes; returns each rank's results.  The
    backend is chosen from the layout unless given."""
    return run_rank_fn(_run_jobs, (jobs,), world, device, backend, timeout,
                       env)


def run_rank_fn(target, args=(), world: int = 2, device: str = "cpu",
                backend: Optional[str] = None, timeout: float = 300.0,
                env: Optional[Dict[str, str]] = None) -> list:
    """``target(device, *args)`` on each of ``world`` ranks, each a spawned
    process in the process group (``target`` must be importable by name);
    returns each rank's result.  A rank still running after ``timeout``
    seconds is killed, and so are the others; so is every rank once one
    fails."""
    import torch.multiprocessing as mp

    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = backend or multihost.choose_backend(dev.type, world, cards)
    coordinator = "127.0.0.1:%d" % multihost.free_port()
    ctx = mp.get_context("spawn")
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    with tempfile.TemporaryDirectory() as out_dir:
        try:
            procs = [ctx.Process(target=_rank_main, args=(
                r, world, coordinator, backend, device, target, args,
                out_dir)) for r in range(world)]
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        # wait for all; a rank that fails leaves the others waiting in a
        # collective, so the first failure (or the timeout) ends them all
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs) and \
                    time.monotonic() < deadline and \
                    not any(p.exitcode for p in procs):
                time.sleep(0.1)
        finally:
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
            for p in alive:
                p.join()
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode and p not in alive]
        if bad:
            raise RuntimeError("ranks failed (rank, exit code): %r; the "
                               "others were killed" % bad)
        if alive:
            raise TimeoutError("%d of %d ranks still ran after %.0f s; "
                               "killed" % (len(alive), world, timeout))
        return [torch.load(os.path.join(out_dir, "rank%d.pt" % r),
                           weights_only=False) for r in range(world)]


def _undetermined(single: dict, mine: dict, net: str):
    """Per parameter name of ``net``, the entries whose gradient at some
    update was no larger than the two runs' disagreement on it."""
    a, b = single["grads"].get(net), mine["grads"].get(net)
    if not a or not b:
        return {}
    out = {}
    for upd_a, upd_b in zip(a, b):
        for name, ga, gb in zip(single["param_names"][net], upd_a, upd_b):
            und = np.abs(ga) <= np.abs(ga - gb)
            out[name] = out[name] | und if name in out else und
    return out


def hold_shadows(got, want, start, decay: float, steps: int,
                 lr: float = LR) -> float:
    """A net's EMA shadows (one array per parameter) against another run's
    from the same start, by their displacement from ``start``: the
    relative L2 of the difference over the displacement of ``want`` within
    ``EMA_DISP_RTOL``, at most a tenth of the entries off by more than
    (1 - decay) lr / 10 (the parameters' own share of ``compare``'s limit,
    scaled by the shadow's weight on them), and none off by more than the
    shadow of the parameters' bound (2 t lr after step t).  A shadow left
    at its start reads 1 on the relative L2, one updated with decay and
    1 - decay swapped about 5; where the parameters part by Adam's +-lr on
    a few entries it reads about 0.1.  Raises AssertionError; returns the
    relative L2."""
    bound = 1.05 * (1 - decay) * sum(
        decay ** (steps - t) * 2 * t * lr for t in range(1, steps + 1))
    gap2 = moved2 = 0.0
    off = total = 0
    assert len(got) == len(want) == len(start)
    for i, (g, w, s0) in enumerate(zip(got, want, start)):
        assert g.shape == w.shape, ("shadow", i, g.shape, w.shape)
        gap = np.abs(g - w)
        assert gap.max() <= bound, ("shadow", i, float(gap.max()), bound)
        gap2 += float(np.sum(np.square(gap)))
        moved2 += float(np.sum(np.square(w - s0)))
        off += int((gap > 0.1 * (1 - decay) * lr).sum())
        total += gap.size
    assert moved2 > 0.0, "the shadows never moved"
    rel = float(np.sqrt(gap2 / moved2))
    assert rel <= EMA_DISP_RTOL, ("shadow displacement", rel)
    assert off <= 0.1 * total, ("shadow entries off", off, total)
    return rel


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(1.0, abs(b))


def compare(single: dict, ranks: List[dict], limits=LIMITS["cpu"],
            params: bool = True) -> dict:
    """Hold the ranks' results of one job to the single process's: the
    ranks equal to each other bit for bit; losses and gnorms per step
    within ``limits``; a batch-norm pass (global statistics from equal
    weights) with its loss and running statistics within ``BN_RTOL`` and
    its gradient within ``limits[1]``; the running statistics of a train
    step at the later steps' loss limit (the step's later forwards see
    weights that Adam moved apart); parameters within two Adam steps'
    worst case (near-zero gradient entries take +-lr whichever side
    rounding puts them), with at most a tenth of each net's entries off by
    more than lr / 10, not counting, where both runs recorded their
    gradients, the entries whose gradient at some update was no larger than
    the two runs' disagreement on it (its sign is not determined); the EMA
    shadows by their displacement from the start (:func:`hold_shadows`);
    pools and Adam counts equal; the evaluation's MSE within ``limits[0]``, its
    bound after one RMSprop step and after the last within ``UBO_RTOL``
    (RMSprop's first update is lr * sign(g), so later iterates part where a
    gradient entry sits at 0).  With ``params=False`` the parameters and
    shadows are not held (a run that recorded no gradients).  Raises
    AssertionError; returns the largest deviations seen."""
    lr, step_stats_rtol = LR, limits[2]
    first = ranks[0]
    for other in ranks[1:]:
        assert other["steps"] == first["steps"], "ranks disagree on losses"
        for net, sd in first["state"].items():
            for k, v in sd.items():
                assert np.array_equal(v, other["state"][net][k]), (
                    "ranks disagree on %s.%s" % (net, k))
    worst = {"loss1": 0.0, "gnorm1": 0.0, "loss": 0.0, "gnorm": 0.0,
             "param": 0.0, "stats": 0.0}
    for it, (mine, want) in enumerate(zip(first["steps"], single["steps"])):
        later = it > 0
        for what, lim in (("losses", limits[2 * later]),
                          ("gnorms", limits[2 * later + 1])):
            assert set(mine[what]) == set(want[what]), what
            for k, w in want[what].items():
                d = _rel(mine[what][k], w)
                key = ("loss" if what == "losses" else "gnorm") + \
                    ("" if later else "1")
                worst[key] = max(worst[key], d)
                assert d <= lim, ("step %d %s %s: %r vs %r" % (
                    it + 1, what, k, mine[what][k], w))
    assert len(first["steps"]) == len(single["steps"])
    if "mse" in single:
        worst["mse"] = _rel(first["mse"], single["mse"])
        assert worst["mse"] <= limits[0], ("mse", worst["mse"])
    for key, tol in zip(("ubo1", "ubo"), UBO_RTOL):
        for k, w in single.get(key, {}).items():
            d = _rel(first[key][k], w)
            worst[key] = max(worst.get(key, 0.0), d)
            assert d <= tol, (key, k, first[key][k], w)
    tight = "norm_loss" in single
    for k, w in single.get("stats1", {}).items():
        rel = float(np.abs(first["stats1"][k] - w).max()) / max(
            1.0, float(np.abs(w).max()))
        worst["stats"] = max(worst["stats"], rel)
        assert rel <= (BN_RTOL if tight else step_stats_rtol), (
            "step 1", k, rel)
    if tight:
        assert _rel(first["norm_loss"], single["norm_loss"]) <= BN_RTOL
        # a bias in front of a batch norm has a gradient of exactly 0 in
        # exact arithmetic: its rounding noise is held against the whole
        # gradient's size
        # (the whole gradient within limits[1], as a step's gnorms; a
        # tensor of it within ten times that)
        total = float(np.sqrt(sum(np.sum(w * w)
                                  for w in single["norm_grads"])))
        diff = float(np.sqrt(sum(np.sum((g - w) ** 2) for g, w in zip(
            first["norm_grads"], single["norm_grads"]))))
        worst["gnorm1"] = diff / total
        assert diff <= limits[1] * total, ("batch-norm pass gradient",
                                           diff / total)
        for g, w in zip(first["norm_grads"], single["norm_grads"]):
            rel = float(np.linalg.norm(g - w)) / max(
                float(np.linalg.norm(w)), 1e-3 * total)
            assert rel <= 10 * limits[1], ("batch-norm pass tensor", rel)
    for net, want in single["state"].items():
        got = first["state"][net]
        off = total = 0
        undetermined = _undetermined(single, first, net)
        for k, w in want.items():
            d = np.abs(got[k] - w)
            if k.rsplit(".", 1)[-1].startswith("running_"):
                rel = float(d.max()) / max(1.0, float(np.abs(w).max()))
                assert rel <= step_stats_rtol, (net, k, rel)
                continue
            if not params:
                continue
            if k in undetermined:
                d = np.where(undetermined[k], 0.0, d)
            worst["param"] = max(worst["param"], float(d.max()))
            assert d.max() <= 2 * 2 * lr * 1.05, (net, k, float(d.max()))
            off += int((d > 0.1 * lr).sum())
            total += d.size
        assert off <= 0.1 * max(total, 1), (net, off, total)
    for net, want in single["ema"].items() if params else ():
        worst["ema"] = max(worst.get("ema", 0.0), hold_shadows(
            first["ema"][net], want, single["ema_start"][net],
            single["ema_decay"], len(single["steps"]), lr))
    assert first["counts"] == single["counts"]
    for k, (buf, n) in single["pools"].items():
        # fakes of generators that Adam moved apart, per slot: a wrong slot
        # or a wrong replay would differ by O(1) on average
        d = float(np.abs(first["pools"][k][0] - buf).reshape(
            len(buf), -1).mean(axis=1).max())
        worst["pool"] = max(worst.get("pool", 0.0), d)
        assert first["pools"][k][1] == n and d <= 1e-2, (k, d)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=0,
                    help="ranks (default: the jobs' own world, 2 for JOBS)")
    ap.add_argument("--width", choices=["tiny", "full"], default="tiny")
    ap.add_argument("--jobs", default=",".join(JOBS))
    ap.add_argument("--batch", type=int, default=0,
                    help="the global batch of every job (default: each "
                         "job's own)")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    width = FULL if args.width == "full" else TINY
    names = args.jobs.split(",")
    if not args.world:
        worlds = {MESH_JOBS[n][4] if n in MESH_JOBS else 2 for n in names}
        if len(worlds) != 1:
            raise SystemExit("the jobs take worlds %s: run them apart, or "
                             "name --world" % sorted(worlds))
        args.world = worlds.pop()
    jobs = [dict(name=n, width=width, record_grads=True,
                 batch=args.batch or None, steps=args.steps or None)
            for n in names]
    t0 = time.perf_counter()
    singles = [run_job(device=args.device, **j) for j in jobs]
    t1 = time.perf_counter()
    ranks = run_ranks(jobs, args.world, args.device, timeout=args.timeout)
    print("one process %.1f s, %d ranks %.1f s" % (
        t1 - t0, args.world, time.perf_counter() - t1))
    limits = LIMITS["cpu" if args.device == "cpu" else "float32"]
    failed = 0
    backend = multihost.choose_backend(torch.device(args.device).type,
                                       args.world,
                                       torch.cuda.device_count())
    print("%d ranks over %s on %s" % (args.world, backend, args.device))
    # on the card cuDNN's gradients differ with the batch a rank sees, and
    # after Adam's first steps more than a tenth of netG_A_B's entries part
    # by over lr / 10 (18-24 % seen over NCCL): there the parameters are
    # left to the later steps' losses and gnorms
    params = args.device == "cpu"
    for i, job in enumerate(jobs):
        try:
            worst = compare(singles[i], [r[i] for r in ranks], limits,
                            params=params)
        except AssertionError as e:
            failed += 1
            print("%-10s FAILED  %s" % (job["name"], e))
            continue
        ms = [np.median(r[i]["ms"][1:]) for r in ranks if r[i]["ms"][1:]]
        print("%-10s ok  %s%s" % (job["name"], ", ".join(
            "%s %.2e" % kv for kv in worst.items()),
            "; step ms one process %.1f, per rank %s" % (
                np.median(singles[i]["ms"][1:]),
                " ".join("%.1f" % m for m in ms)) if ms else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
