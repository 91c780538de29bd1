#!/usr/bin/env python3
"""Sweeps on one NVIDIA Hopper card behind the rules of the instance-norm
ring route, of the apply / dx grid and of the split reductions' plans
(``cluster_plan`` / ``_ring_route``, ``apply_grid`` and ``split_plan`` in
``domain_transfer_gan_torch/ops/kernels/instance_norm.py``) and of the pad
kernels' bands (``ops/kernels/pad.py::pad_plan``), the repeat check of the
selfcheck's eval job, and ROADMAP F7's trace check.  Run from the
repository root:

    python3 ring_sweeps.py ring [--wide] [--out FILE]
    python3 ring_sweeps.py grids [--out FILE]
    python3 ring_sweeps.py splits [--out FILE]
    python3 ring_sweeps.py eval [--deterministic] [--plain-pads] [--out FILE]
    python3 ring_sweeps.py pads [--bands] [--out FILE]
    python3 ring_sweeps.py trace [--runs N] [--out FILE]

``ring`` times, at every 256x256 shape no cluster holds (``--wide``: at
the wide rows whose ring is narrowed to fit, ``WIDE_SHAPES``), the
streaming variant, the ring route (its ring narrowed as far as it must
be), the ring half under every ring of 1-16 CTAs and the apply / dx half
under each grid; ``grids`` times the split apply / dx at every split shape
under each grid; ``splits`` times the split reductions under every plan;
``eval`` runs the selfcheck's eval job twice (cuDNN pinned by the job) and
an aug_cycle_gan float32 step twice from one state, and says whether each
pair repeats bit for bit (``--deterministic``: under
``torch.use_deterministic_algorithms(True)``, with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``, so that the first op without a
deterministic implementation raises and names itself; ``--plain-pads``:
the pads through ``F.pad`` as before the pad kernels, ROADMAP F5);
``pads`` times both pad kernels beside ``F.pad`` and the float32 step at
32 with its pads through each, in turns (``--bands``: and both kernels at
every pad shape of the main path under each band geometry); ``trace``
runs ``chip_smoke.py``'s order in one process (the steps of phases 4-8,
then N times phase 9's profiler sessions and phase 10 (b)'s training CLI
epoch with ``--profile_dir``) and says of each trace whether it names K1
and K2, and what it holds.  Each logs a line per row and writes the rows
to ``--out`` as JSON.  Needs a CUDA device and ``nvcc``; builds the
kernels from this checkout at first use.  Times are device times of CUDA
graphs, as ``chip_smoke.py``'s phase 6 takes them.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import subprocess
import sys

import chip_smoke as cs

# every shape the ring route's plan was swept at: the 256x256 generator
# sites, and the 256x256 discriminator sites (phase 9's step at 32, its
# --grad_accum microbatch) of wide rows, some of which no cluster holds
RING_SWEEP_SHAPES = tuple(dict.fromkeys(cs.RING_SHAPES + tuple(
    s for s in cs.STEP256_SHAPES + cs.EXTRAS_SHAPES
    if s[1] > 2048 and s[2] >= 128)))
# rows no cluster holds whose ring as split_plan's rule would set it does
# not fit a CTA's shared memory: the discriminators' third site at 256x256
# with --ndf 128 --batchSize 1 and a larger sample of its width, whose ring
# one halving of the chunk fits, and rows of 1024 channels, whose ring
# needs more (the route's ring is timed as the rule would narrow it)
WIDE_SHAPES = ((2, 3969, 512), (1, 65536, 512), (1, 16384, 1024))
APPLY_ROWS_PER_THREAD = (1, 2, 4, 8, 16, 32)  # the apply grids swept


def _apply_at(K, torch, x, mean, rstd, scale, shift, grid, relu=False):
    """``instance_norm_apply``'s launch over ``grid`` = (vec, tx,
    chunk_rows), uncounted."""
    n, h, w, c = x.shape
    scale, shift, stride = K._affine_pointers(scale, shift, c)
    y = torch.empty_like(x)
    K._split_launch(x, "instance_norm_apply", K._APPLY_ARGTYPES,
                    K.KERNEL_NAME, x.data_ptr(), mean.data_ptr(),
                    rstd.data_ptr(), K._ptr(scale), K._ptr(shift),
                    y.data_ptr(), n, h * w, c, stride, K._DTYPE_CODE[x.dtype],
                    *grid, int(relu))
    return y


def _dx_at(K, torch, x, dy, mean, rstd, scale, shift, sum_g, sum_gx,
           hw_total, grid, relu=False):
    """``instance_norm_bwd_apply_dx``'s launch over ``grid``, uncounted,
    biased variance."""
    n, h, w, c = x.shape
    scale, shift, stride = K._affine_pointers(scale, shift, c)
    dx = torch.empty_like(x)
    K._split_launch(x, "instance_norm_bwd_apply_dx", K._APPLY_DX_ARGTYPES,
                    K.BWD_KERNEL_NAME, x.data_ptr(), dy.data_ptr(),
                    mean.data_ptr(), rstd.data_ptr(), K._ptr(scale),
                    K._ptr(shift), sum_g.data_ptr(), sum_gx.data_ptr(),
                    dx.data_ptr(), n, h * w, c, int(hw_total), stride,
                    K._DTYPE_CODE[x.dtype], *grid, 0, int(relu))
    return dx


def _route(K, shape, itemsize, arrays):
    """The ring route's plan where no cluster holds the slab and the rows
    are a multiple of 16 bytes, its ring narrowed as far as it must be to
    fit a CTA (also where the plan takes the streaming variant for it),
    else None."""
    n, hw, c = shape
    if c * itemsize % 16 or \
            cs._on_chip_plan(K, shape, itemsize, arrays) is not None:
        return None
    return K._ring_route(n, hw, c, itemsize, arrays, K._sm_count(0),
                         cuts=None)


def _legacy_grid(K, shape, itemsize):
    """The apply / dx grid before the row chunks: one block per (sample,
    channel tile), tile from launch_geometry, over all of HW."""
    n, hw, c = shape
    return K.launch_geometry(n, c, itemsize, True, K._sm_count(0)) + (hw,)


def _apply_grid_times(torch, K, shape, itemsize, apply, dx, calls=20):
    """Device ms of ``apply(i, grid)`` and ``dx(i, grid)`` under the legacy
    grid and under the row-chunked grid at each of APPLY_ROWS_PER_THREAD
    rows per thread; apply_grid's picks beside them."""
    n, hw, c = shape
    grids = {"legacy": _legacy_grid(K, shape, itemsize)}
    for r in APPLY_ROWS_PER_THREAD:
        grids["r%d" % r] = K._apply_tile(hw, c, itemsize, True, r)
    out = {"picked": {k: list(K.apply_grid(n, hw, c, itemsize, True,
                                           K._sm_count(0), dx=k == "dx"))
                      for k in ("apply", "dx")}}
    for name, fn in (("apply", apply), ("dx", dx)):
        out[name + "_ms"] = {key: cs._time_device(
            torch, lambda i, g=g: fn(i, g), calls=calls)
            for key, g in grids.items()}
    return out


def sweep_ring_plans(torch, K, shapes=RING_SWEEP_SHAPES):
    """Device ms at every shape of ``shapes``, float32 and bfloat16,
    per-channel affine, ReLU, of each launch that takes the ring route: the
    streaming variant; the ring half (K1's statistics, K2's sums,
    ``instance_norm_partial_stats`` / ``instance_norm_bwd_partial_sums``
    under :func:`ring_plan`'s plans of 1-16 CTAs of 256 or 512 threads, two
    slots, the default chunk and twice it, where they fit); the apply / dx
    half under each grid of :func:`_apply_grid_times`; the whole route
    under :func:`_route`'s plan.  The evidence for the ring route's rule."""
    out = []
    for shape in shapes:
        n, hw, c = shape
        for name in ("float32", "bfloat16"):
            dtype = getattr(torch, name)
            item = 4 if name == "float32" else 2
            todo = [a for a in (1, 2)
                    if _route(K, shape, item, a) is not None]
            if not todo:
                continue
            x_bytes = n * hw * c * item
            calls = cs._calls_for(x_bytes)
            nbuf = cs._n_buffers(3 * x_bytes)
            ins = [cs._make_inputs(torch, shape, dtype, "channel", 93 + i)
                   for i in range(nbuf)]
            dys = [torch.randn_like(t[0].float()).to(dtype) for t in ins]
            stats = [K.instance_norm_plain(t[0], *t[1:], return_stats=True,
                                           relu=True)[1:] for t in ins]
            sums = [K.instance_norm_bwd_partial_sums_plain(
                t[0], d, *st, *t[1:], relu=True)
                for t, d, st in zip(ins, dys, stats)]

            def whole(arrays, i, p):
                x, s_, b_ = ins[i % nbuf]
                if arrays == 1:
                    return K._launch(x, s_, b_, 1e-5, False, True, plan=p)
                return K._launch_bwd(x, dys[i % nbuf], *stats[i % nbuf],
                                     s_, b_, False, True, plan=p)

            def half(arrays, i, p):
                x, s_, b_ = ins[i % nbuf]
                if arrays == 1:
                    return K.instance_norm_partial_stats(x, plan=p)
                return K.instance_norm_bwd_partial_sums(
                    x, dys[i % nbuf], *stats[i % nbuf], s_, b_, relu=True,
                    plan=p)

            def apply(i, g):
                x, s_, b_ = ins[i % nbuf]
                return _apply_at(K, torch, x, *stats[i % nbuf], s_, b_, g,
                                 relu=True)

            def dx(i, g):
                x, s_, b_ = ins[i % nbuf]
                return _dx_at(K, torch, x, dys[i % nbuf], *stats[i % nbuf],
                              s_, b_, *sums[i % nbuf], hw, g, relu=True)

            grids = _apply_grid_times(torch, K, shape, item, apply, dx,
                                      calls)
            for arrays in todo:
                kname = ("instance_norm_fwd", "instance_norm_bwd")[arrays - 1]
                route = _route(K, shape, item, arrays)
                row = {"shape": list(shape), "dtype": name, "kernel": kname,
                       "picked": cs._picked_variant(K, shape, item, arrays),
                       "plan": cs._plan_row(route, n),
                       "streaming_ms": cs._time_device(
                           torch, lambda i: whole(arrays, i, K.STREAMING),
                           calls=calls),
                       "ring_route_ms": cs._time_device(
                           torch, lambda i: whole(arrays, i, route),
                           calls=calls),
                       "ring_half_ms": {},
                       "grid_half_ms": grids["apply_ms" if arrays == 1
                                             else "dx_ms"],
                       "grid_picked": grids["picked"][
                           "apply" if arrays == 1 else "dx"]}
                for k, mult, threads in itertools.product(
                        (1, 2, 4, 8, 16), (1, 2), (256, 512)):
                    try:
                        p = K.ring_plan(hw, c, item, arrays, k,
                                        threads=threads)
                        if mult > 1:
                            if p.stage_rows >= p.rows:
                                continue
                            p = K.ring_plan(hw, c, item, arrays, k, 2,
                                            min(mult * p.stage_rows, p.rows),
                                            threads)
                    except ValueError:
                        continue
                    key = "k%d r%d t%d" % (k, p.stage_rows, p.threads)
                    row["ring_half_ms"][key] = cs._time_device(
                        torch, lambda i, p=p: half(arrays, i, p),
                        calls=calls)
                if row["ring_half_ms"]:
                    best = min(row["ring_half_ms"],
                               key=row["ring_half_ms"].get)
                    row["ring_half_best"] = [best,
                                             row["ring_half_ms"][best]]
                out.append(row)
                cs.log("sweep %s %s %r: streaming %.4f, ring route %.4f "
                       "(%s), best ring half %s, grids %s" % (
                           kname, name, shape, row["streaming_ms"],
                           row["ring_route_ms"], cs._plan_row(route, n),
                           row.get("ring_half_best"), json.dumps(
                               {k: round(v, 4) for k, v in
                                row["grid_half_ms"].items()})))
            del ins, dys, stats, sums
            torch.cuda.empty_cache()
    return out


def sweep_apply_grids(torch, K):
    """Device ms of the split apply and dx launches at every
    ``SPLIT_SHAPES`` shape, float32 and bfloat16, (N, C) affine, no ReLU,
    under each grid of :func:`_apply_grid_times`: the evidence for the
    grid they take."""
    out = []
    for shape in cs.SPLIT_SHAPES:
        n, hw, c = shape
        for name in ("float32", "bfloat16"):
            dtype = getattr(torch, name)
            item = 4 if name == "float32" else 2
            nbuf = cs._n_buffers(n * hw * c * item * 3)
            ins = [cs._make_inputs(torch, shape, dtype, "sample", 97 + i)
                   for i in range(nbuf)]
            dys = [torch.randn_like(t[0].float()).to(dtype) for t in ins]
            mean, m2 = K.instance_norm_partial_stats_plain(ins[0][0])
            rstd = torch.rsqrt(m2 / hw + 1e-5)
            sg, sgx = K.instance_norm_bwd_partial_sums_plain(
                ins[0][0], dys[0], mean, rstd, *ins[0][1:])

            def apply(i, g):
                x, s_, b_ = ins[i % nbuf]
                return _apply_at(K, torch, x, mean, rstd, s_, b_, g)

            def dx(i, g):
                x, s_, b_ = ins[i % nbuf]
                return _dx_at(K, torch, x, dys[i % nbuf], mean, rstd, s_, b_,
                              sg, sgx, 2 * hw, g)

            row = {"shape": list(shape), "dtype": name}
            row.update(_apply_grid_times(torch, K, shape, item, apply, dx))
            out.append(row)
            cs.log("grids %s %r: %s" % (name, shape, json.dumps(
                {k: {g: round(t, 4) for g, t in row[k].items()}
                 for k in ("apply_ms", "dx_ms")})))
            del ins, dys
    return out


def sweep_split_plans(torch, K):
    """Device ms of the two split reductions at every ``SPLIT_SHAPES``
    shape, float32 and bfloat16, (N, C) affine, no ReLU: the ``"rows"``
    variant and the cluster variant under every cluster size of 1-16 CTAs
    of 256 or 512 threads, ring of 2 or 4 slots, and chunk of 1 or 2 times
    the default rows (``ring_plan``), each timed as phase 6 times a kernel;
    beside them the plan ``split_plan`` picks.  The evidence for
    ``split_plan``'s rule."""
    out = []
    for shape in cs.SPLIT_SHAPES:
        n, hw, c = shape
        for name in ("float32", "bfloat16"):
            dtype = getattr(torch, name)
            item = 4 if name == "float32" else 2
            nbuf = cs._n_buffers(n * hw * c * item * 2)
            ins = [cs._make_inputs(torch, shape, dtype, "sample", 91 + i)
                   for i in range(nbuf)]
            dys = [torch.randn_like(t[0].float()).to(dtype) for t in ins]
            mean, m2 = K.instance_norm_partial_stats_plain(ins[0][0])
            rstd = torch.rsqrt(m2 / hw + 1e-5)
            launch = {
                1: lambda i, p: K.instance_norm_partial_stats(
                    ins[i % nbuf][0], plan=p),
                2: lambda i, p: K.instance_norm_bwd_partial_sums(
                    ins[i % nbuf][0], dys[i % nbuf], mean, rstd,
                    *ins[i % nbuf][1:], plan=p)}
            for kname, arrays in cs._split_arrays(K).items():
                row = {"shape": list(shape), "dtype": name, "kernel": kname,
                       "picked": cs._split_plan_row(
                           cs._split_picked(K, shape, item, arrays), n),
                       "rows_ms": cs._time_device(torch, lambda i: launch[
                           arrays](i, K.SPLIT_ROWS)), "cluster_ms": {}}
                for k, stages, mult, threads in itertools.product(
                        (1, 2, 4, 8, 16), (2, 4), (1, 2), (256, 512)):
                    try:
                        p = K.ring_plan(hw, c, item, arrays, k, stages,
                                        threads=threads)
                        if mult > 1:
                            # the default chunk doubled, where it does
                            # not hold the CTA's rows already
                            if p.stage_rows >= p.rows:
                                continue
                            p = K.ring_plan(hw, c, item, arrays, k, stages,
                                            min(mult * p.stage_rows, p.rows),
                                            threads)
                    except ValueError:
                        continue
                    key = "k%d s%d r%d t%d" % (k, stages, p.stage_rows,
                                               p.threads)
                    row["cluster_ms"][key] = cs._time_device(
                        torch, lambda i, p=p: launch[arrays](i, p))
                best = min(row["cluster_ms"], key=row["cluster_ms"].get)
                row["best"], row["best_ms"] = best, row["cluster_ms"][best]
                picked = row["picked"]
                row["picked_ms"] = row["rows_ms"] if picked[
                    "variant"] == "rows" else cs._time_device(
                        torch, lambda i: launch[arrays](i, None))
                out.append(row)
                cs.log("sweep %s %s %r: rows %.4f, picked %s %.4f, best "
                       "%s %.4f" % (kname, name, shape, row["rows_ms"],
                                    "%(variant)s k%(cluster)d s%(stages)d "
                                    "r%(stage_rows)d t%(threads)d" % picked,
                                    row["picked_ms"], best, row["best_ms"]))
            del ins, dys
    return out


def _plain_pads(on):
    """A context in which (``on``) the networks pad through ``F.pad``, as
    the port did before its pad kernels: the kernels' yardstick inside a
    whole step."""
    import contextlib

    from domain_transfer_gan_torch.ops.kernels import pad as P
    from domain_transfer_gan_torch.parallel import spatial

    @contextlib.contextmanager
    def swapped():
        spatial.pad2d = P.pad2d_plain if on else P.pad2d
        try:
            yield
        finally:
            spatial.pad2d = P.pad2d
    return swapped()


def pad_step_turns(torch, pairs=10):
    """The aug_cycle_gan float32 step at batch 32 (full width, one model)
    with its pads through the kernels and through ``F.pad``, ``pairs``
    times each in turns (F.pad, kernels, kernels, F.pad, ...): ms per step
    (10 after 3) of each turn; under torch.profiler (3 steps, the first
    turn of each way) the device's busy ms per step, its kernels per step
    and the kernels whose device time moved most; and the host's time to
    enqueue one pad's forward and backward (through autograd, and each
    launch alone) at a small shape, where the device's time is below it, by
    CUDA events around 200 calls."""
    from domain_transfer_gan_torch.ops.kernels import pad as P
    from domain_transfer_gan_torch.utils import timing

    m = timing.full_model()
    A, B = timing.card_inputs(timing.TRAIN_BATCH["float32"], seed=14)
    out, by_name = {"F.pad": [], "kernels": []}, {}
    copies = P.pad2d.copies
    for way in ("F.pad", "kernels", "kernels", "F.pad") * (pairs // 2):
        with _plain_pads(way == "F.pad"):
            out[way].append(timing.step_ms(lambda: m.train_instance(A, B)))
            if way not in by_name:
                _, by_name[way], count = timing.profiled(
                    lambda: m.train_instance(A, B), 3)
                out[way + " profile"] = {
                    "device_busy_ms": sum(by_name[way].values()) / 1e3,
                    "device_kernels": count}
    out["pad_input_copies"] = P.pad2d.copies - copies
    names = set(by_name["F.pad"]) | set(by_name["kernels"])
    moved = {k[:100]: by_name["kernels"].get(k, 0.0) - by_name["F.pad"].get(
        k, 0.0) for k in names}
    out["us_per_step_kernels_minus_f_pad"] = dict(sorted(
        moved.items(), key=lambda kv: -abs(kv[1]))[:12])
    x = torch.randn((2, 16, 8, 8), device="cuda").contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    dy = torch.randn((2, 16, 10, 10), device="cuda").contiguous(
        memory_format=torch.channels_last)
    pads = (1, 1, 1, 1)
    calls = {
        "F.pad fwd_bwd": lambda i: torch.autograd.grad(
            P.pad2d_plain(x, pads, "reflect"), x, dy),
        "kernels fwd_bwd": lambda i: torch.autograd.grad(
            P.pad2d(x, pads, "reflect"), x, dy),
        "F.pad fwd": lambda i: P.pad2d_plain(x.detach(), pads, "reflect"),
        "kernels fwd": lambda i: P._launch(x.detach(), pads, "reflect"),
        "F.pad bwd": lambda i: torch.ops.aten.reflection_pad2d_backward(
            dy, x.detach(), list(pads)),
        "kernels bwd": lambda i: P.pad2d_bwd(dy, x.shape, pads, "reflect")}
    for name, call in calls.items():
        out["host_us " + name] = 1e3 * cs._time_eager(torch, call, iters=200)
    cs.log("pads: step %s" % json.dumps(out))
    return out


def phase9_sessions(torch, K):
    """Phase 9's profiler sessions, the same count and kinds as
    ``chip_smoke.py`` runs them: ``profile_window`` (2 steps) of the
    float32 --grad_accum 4 step at 256x256 and batch 32, then of the
    bfloat16 step at 256x256 and 32 through the ring route and with the
    streaming variant forced, each after a step outside the window."""
    from domain_transfer_gan_torch.utils import timing

    m = timing.full_model(grid_size=256, batchSize=32,
                          grad_accum=cs.ACCUM_K)
    A, B = timing.card_inputs(32, seed=15, hw=256)
    m.train_instance(A, B)
    timing.profile_window(lambda: m.train_instance(A, B), reps=2)
    del m
    m = timing.full_model(compute_dtype="bfloat16", grid_size=256,
                          batchSize=cs.STEP256_BATCH)
    A, B = timing.card_inputs(cs.STEP256_BATCH, seed=17, hw=256)
    for way in ("ring", "streaming"):
        with cs._streamed_ring(K, way == "streaming"):
            m.train_instance(A, B)
            timing.profile_window(lambda: m.train_instance(A, B), reps=2)
    del m, A, B
    torch.cuda.empty_cache()


def read_trace(path):
    """What a --profile_dir trace holds: whether it names K1 and K2, its
    events by category, the first and last time stamp (us) of its kernels
    and of its host ops, and the metadata torch wrote beside the events."""
    import collections

    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    names = {e.get("name", "") for e in events}
    row = {"k1": any("instance_norm_fwd" in n for n in names),
           "k2": any("instance_norm_bwd" in n for n in names),
           "events_by_category": dict(collections.Counter(
               e.get("cat", "") for e in events))}
    for cat in ("kernel", "cpu_op"):
        ts = [e["ts"] for e in events if e.get("cat") == cat]
        row[cat + "_ts"] = [min(ts), max(ts)] if ts else None
    row["metadata"] = {k: v for k, v in trace.items()
                       if k != "traceEvents" and not isinstance(v, list)}
    return row


def trace_repeats(torch, K, runs):
    """ROADMAP F7 in chip_smoke.py's order, in one process: the work of
    phases 4-8 at reduced depth (a float32 and a bfloat16 full-width step,
    a served batch through both generators), then ``runs`` times: phase
    9's profiler sessions (:func:`phase9_sessions`), then phase 10 (b)'s
    per-file epoch (published width, the prefetching feed) with
    --profile_dir.  For each run :func:`read_trace` of its trace, the
    kernel events the training CLI logged for it, and the CUPTI settings
    torch leaves in the environment."""
    import tempfile

    from domain_transfer_gan_torch.cli.train import train_model
    from domain_transfer_gan_torch.data.synthetic import \
        write_synthetic_perfile_dataset
    from domain_transfer_gan_torch.utils import timing

    p, out = cs.P10, []
    for name, batch in timing.TRAIN_BATCH.items():
        m = timing.full_model(compute_dtype=name)
        A, B = timing.card_inputs(batch, seed=3)
        for _ in range(2):
            m.train_instance(A, B)
        m.predict_A(m.predict_B(A, torch.randn(batch, 16, device="cuda")))
        del m, A, B
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "perfile")
        write_synthetic_perfile_dataset(root, n_train=p["n_train"],
                                        n_test=p["n_test"], size=64, seed=11)
        for i in range(runs):
            phase9_sessions(torch, K)
            prof = os.path.join(tmp, "prof%d" % i)
            train_model(argv=cs._p10_argv(
                root, os.path.join(tmp, "runs"), "run%d" % i, "cuda",
                cs.CLI_WIDTH, p, cs.P10_FEED["prefetch"] + [
                    "--profile_dir", prof]))
            row = read_trace(os.path.join(prof, "trace.json"))
            os.remove(os.path.join(prof, "trace.json"))  # ~100 MB each
            with open(os.path.join(tmp, "runs", "run%d" % i,
                                   "results.txt")) as f:
                row["logged"] = [ln.strip() for ln in f
                                 if "profiler trace" in ln]
            row["env"] = {k: os.environ.get(k) for k in (
                "TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT")}
            cs.log("trace %d: %s" % (i, json.dumps(row)))
            out.append(row)
    cs.log("trace: %d of %d traces lack K1 or K2" % (
        sum(not (r["k1"] and r["k2"]) for r in out), runs))
    return out


BAND_ROWS = (1, 2, 4, 8, 16, 32)  # band row counts swept, times the step


def sweep_pad_bands(torch, P, shapes=None):
    """Device ms of both pad kernels at each pad shape of the main path
    (``chip_smoke.PAD_SHAPES``, or ``shapes``) and direction: the word
    kernels, and the band kernels under each band row count of BAND_ROWS
    times the step that keeps bands on 16 bytes and 128, 256 and 512
    threads, beside ``pad_plan``'s pick, a copy of the output's bytes
    (``clone``: what moving them costs) and the bound: the evidence for
    ``pad_plan``'s rule."""
    out = []
    for n, c, h, w, pads, mode, dtype in sorted(
            shapes or cs.PAD_SHAPES, key=lambda s: (s[6], s[:4])):
        dt = getattr(torch, dtype)
        item = 4 if dtype == "float32" else 2
        left, right, top, bottom = pads
        ho, wo = h + top + bottom, w + left + right
        nbytes = (n * c * h * w + n * c * ho * wo) * item
        k = cs._n_buffers(nbytes)
        cl = torch.channels_last
        xs = [torch.randn((n, c, h, w), device="cuda").to(dt).contiguous(
            memory_format=cl) for _ in range(k)]
        dys = [torch.randn((n, c, ho, wo), device="cuda").to(dt).contiguous(
            memory_format=cl) for _ in range(k)]
        row = {"shape": [n, c, h, w], "pads": list(pads), "dtype": dtype,
               "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
               "clone_ms": cs._time_device(torch, lambda i: dys[i % k].clone())}
        for backward in (False, True):
            length = h if backward else ho
            row_bytes = (w if backward else wo) * c * item
            base = 16 // math.gcd(row_bytes, 16) \
                if length * row_bytes % 16 == 0 else 1
            plan = P.pad_plan((n, c, h, w), pads, mode, item, backward)

            def launch(i, p):
                with _planned(P, p):
                    if backward:
                        return P.pad2d_bwd(dys[i % k], (n, c, h, w), pads,
                                           mode)
                    return P._launch(xs[i % k], pads, mode)

            times = {"words": cs._time_device(
                torch, lambda i: launch(i, P.WORDS))}
            fits = backward or 2 * wo * c * item <= P.TABLE_BYTES_MAX
            for rows, threads in sorted({(r * base, t) for r in BAND_ROWS
                                         for t in (128, 256, 512)
                                         if fits and r * base <= length}):
                q = P.PadPlan(rows, threads, -(-length // rows), False)
                times["r%d t%d" % (rows, threads)] = cs._time_device(
                    torch, lambda i, q=q: launch(i, q))
            picked = "r%d t%d" % (plan.rows, plan.threads) if plan.rows \
                else "words"
            if picked not in times:
                times[picked] = cs._time_device(
                    torch, lambda i: launch(i, plan))
            best = min(times, key=times.get)
            row["bwd" if backward else "fwd"] = {
                "picked": [picked, times[picked]], "best": [best, times[best]],
                "ms": times}
        out.append(row)
        cs.log("bands %s: %s" % (json.dumps(row["shape"] + row["pads"]
                                            + [dtype]), json.dumps(
            {d: {k: row[d][k] for k in ("picked", "best")}
             for d in ("fwd", "bwd")})))
        del xs, dys
        torch.cuda.empty_cache()
    return out


def _planned(P, plan):
    """A context in which every pad launch takes ``plan``."""
    import contextlib

    @contextlib.contextmanager
    def swapped():
        keep = P.pad_plan
        P.pad_plan = lambda *a, **kw: plan
        try:
            yield
        finally:
            P.pad_plan = keep
    return swapped()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sweep", choices=("ring", "grids", "splits", "eval",
                                      "pads", "trace"))
    ap.add_argument("--wide", action="store_true",
                    help="ring: sweep WIDE_SHAPES instead of the 256x256 "
                         "shapes")
    ap.add_argument("--deterministic", action="store_true",
                    help="eval: under torch.use_deterministic_algorithms"
                         "(True), which raises at the first op that has no "
                         "deterministic implementation on the card")
    ap.add_argument("--plain-pads", action="store_true",
                    help="eval: pad through F.pad, as before the pad "
                         "kernels")
    ap.add_argument("--runs", type=int, default=30,
                    help="trace: repeats of phase 9's profiler sessions "
                         "and the training CLI run with --profile_dir")
    ap.add_argument("--bands", action="store_true",
                    help="pads: also sweep the band kernels' geometries at "
                         "every pad shape of the main path")
    ap.add_argument("--out", help="write the rows here as JSON")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ring_sweeps: no CUDA device", file=sys.stderr)
        return 2
    from domain_transfer_gan_torch.ops.kernels import build
    from domain_transfer_gan_torch.ops.kernels import instance_norm as K

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.deterministic:  # cuBLAS reads it when it starts
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    build.compile_all()
    if args.sweep == "ring":
        rows = sweep_ring_plans(
            torch, K, WIDE_SHAPES if args.wide else RING_SWEEP_SHAPES)
    elif args.sweep == "grids":
        rows = sweep_apply_grids(torch, K)
    elif args.sweep == "splits":
        rows = sweep_split_plans(torch, K)
    elif args.sweep == "eval":
        with _plain_pads(args.plain_pads):
            rows = {"deterministic_algorithms": args.deterministic,
                    "plain_pads": args.plain_pads,
                    "eval": cs.eval_repeats(),
                    "step_params_differing": cs.step_repeats(torch)}
        cs.log("eval job and step repeated in one process: %s"
               % json.dumps(rows))
    elif args.sweep == "trace":
        rows = trace_repeats(torch, K, args.runs)
    else:
        from domain_transfer_gan_torch.ops.kernels import pad as P

        rows = {"kernels": cs.time_pads(torch, P),
                "steps": pad_step_turns(torch)}
        cs.log("pads: %s" % json.dumps(rows["kernels"]))
        if args.bands:
            rows["bands"] = sweep_pad_bands(torch, P)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "rows": rows}, f)
    cs.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
