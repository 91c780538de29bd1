#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` and no network.  It

1. prints the card's name and power limit and switches TF32 off, so the
   float32 phases compare in full float32;
2. builds every CUDA source of ``domain_transfer_gan_torch/csrc`` into
   ``build/``;
3. holds the instance-norm kernel against its plain PyTorch version on the
   card, at the shapes the serving path gives it and at edge shapes, in
   float32 and bfloat16, over unbiased x relu x {no, per-channel, per-sample}
   affine;
4. drives the serving path at the published width (``aug_cycle_gan``, ngf 32,
   3 blocks, nlatent 16, 64x64, serving batch 32): seed-drawn weights ->
   ``export_model`` -> ``build_server`` on an ephemeral port -> HTTP requests
   (manifest, ``predict_B`` with z, without z and padded, chunked,
   ``predict_A``, a malformed body), each answer compared with the same
   generators run with the kernel's plain version, the launch counters read
   before and after, then ``predict_B`` and ``predict_A`` again from a
   bfloat16 artifact; then every norm site of both generators on the input
   its forward gives it, kernel against plain version, in both dtypes;
5. times the kernel, its plain version and the library call
   ``F.relu(F.instance_norm(...))`` at the path shapes, and the two
   generators end to end, and prints the ``kernels`` line.

Any failed build, launch or check ends the run with a non-zero exit code.
The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``--profile`` adds what PERF.md reports beyond the check: a
``torch.profiler`` breakdown of one ``predict_B`` and one ``predict_A``
forward by kernel name, and per timed shape the kernel's time on one buffer
that stays in L2, its time enqueued call by call from Python, and its time
with the launch geometry's tile narrowing switched off.
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# (N, HW, C) of the norm sites of one forward at the published width and
# serving batch 32, with how often each is expected to occur; the counts that
# are printed are the measured ones, these are what they are held to
PATH_SHAPES = ((32, 4096, 32), (32, 4096, 64), (32, 1024, 128))
SITES_PREDICT_B = {(32, 4096, 32): 2, (32, 4096, 64): 2, (32, 1024, 128): 7}
SITES_PREDICT_A = {(32, 4096, 32): 2, (32, 4096, 64): 2, (32, 1024, 128): 4}
EDGE_SHAPES = ((2, 4096, 4), (3, 169, 20), (4, 65536, 32))
# timed besides the path shapes: the first norm site of a 256x256 request of
# 4 images, twice the bytes of (32, 4096, 32) in a grid of only 16 blocks
TIMED_EXTRA_SHAPES = ((4, 65536, 32),)
HEADLINE = ((32, 1024, 128), "float32")  # the most frequent site

FP32_ATOL = 1e-4   # kernel vs plain version, float32: sums in another order
SERVE_ATOL = 1e-4  # served answer vs plain-norm generators, float32
# bfloat16 artifact vs the float32 answer, tanh outputs of mean |y| ~0.45
# through 14 convs in bfloat16.  The JAX package's own bfloat16 generator is
# this far from its float32 one at the same width, which
# tests/test_torch_port_networks.py::test_bf16_budget_at_full_width measures
# and holds to these limits.
BF16_MAX_ATOL = 1e-1
BF16_MEAN_ATOL = 1.2e-2
# bfloat16 served answer vs the same bfloat16 generators with every norm
# through the plain version.  At one norm site the two are at most one
# bfloat16 ulp apart on the same input (check_norm_sites holds them to that),
# but where they do part, the 14 bfloat16 convs downstream spread it, so the
# end-to-end limit is only some three times tighter than the one against
# float32.
BF16_SERVE_MAX_ATOL = 6e-2
BF16_SERVE_MEAN_ATOL = 4e-3


def log(*a):
    print(*a, flush=True)


def _hw_split(hw: int):
    h = int(round(hw ** 0.5))
    while hw % h:
        h -= 1
    return h, hw // h


def _make_inputs(torch, shape, dtype, affine, seed):
    n, hw, c = shape
    h, w = _hw_split(hw)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((n, h, w, c), generator=g, device="cuda") * 1.5 + 0.5)
    x = x.to(dtype)
    if affine == "none":
        return x, None, None
    lead = (c,) if affine == "channel" else (n, c)
    scale = torch.rand(lead, generator=g, device="cuda") + 0.5
    shift = torch.randn(lead, generator=g, device="cuda")
    return x, scale, shift


def _bf16_ulp(torch, v):
    """One bfloat16 unit in the last place at magnitude |v| (8 significant
    bits: 2 ** (floor(log2 |v|) - 7))."""
    mag = v.abs().clamp_min(2.0 ** -100)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7.0)


def _bf16_ulps_apart(torch, y, yp):
    """Largest distance of two bfloat16 tensors in units of one bfloat16 ulp,
    after allowing the float32 values before rounding to differ by FP32_ATOL;
    and the fraction of elements that differ at all."""
    diff = (y.float() - yp.float()).abs()
    ulp = _bf16_ulp(torch, torch.maximum(y.float().abs(), yp.float().abs()))
    over = float(((diff - FP32_ATOL).clamp_min(0) / ulp).max())
    return over, float((diff > 0).float().mean())


def check_kernel(torch, instance_norm_fused, instance_norm_plain):
    """Phase 3.  Returns the largest float32 |y| error and the largest
    bfloat16 error beyond FP32_ATOL in units of one bfloat16 ulp."""
    worst32, worst_stats, worst16_ulps = 0.0, 0.0, 0.0
    cases = 0
    for shape in PATH_SHAPES + EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for unbiased in (False, True):
                for relu in (False, True):
                    for affine in ("none", "channel", "sample"):
                        x, scale, shift = _make_inputs(
                            torch, shape, dtype, affine, seed=cases)
                        kw = dict(eps=1e-5, unbiased=unbiased, relu=relu,
                                  return_stats=True)
                        y, mean, rstd = instance_norm_fused(x, scale, shift,
                                                            **kw)
                        torch.cuda.synchronize()
                        yp, meanp, rstdp = instance_norm_plain(
                            x, scale, shift, **kw)
                        torch.cuda.synchronize()
                        what = "%r %s unbiased=%s relu=%s affine=%s" % (
                            shape, dtype, unbiased, relu, affine)
                        if y.shape != x.shape or y.dtype != x.dtype:
                            raise AssertionError("bad output for " + what)
                        if not bool(torch.isfinite(y.float()).all()):
                            raise AssertionError("non-finite y for " + what)
                        e_stats = max(float((mean - meanp).abs().max()),
                                      float((rstd - rstdp).abs().max()))
                        worst_stats = max(worst_stats, e_stats)
                        if e_stats > FP32_ATOL:
                            raise AssertionError(
                                "mean/rstd differ by %g for %s"
                                % (e_stats, what))
                        diff = (y.float() - yp.float()).abs()
                        if dtype == torch.float32:
                            e = float(diff.max())
                            worst32 = max(worst32, e)
                            if e > FP32_ATOL:
                                raise AssertionError(
                                    "y differs by %g for %s" % (e, what))
                        else:
                            # one bf16 rounding apart at most
                            over, _ = _bf16_ulps_apart(torch, y, yp)
                            worst16_ulps = max(worst16_ulps, over)
                            if over > 1.0:
                                raise AssertionError(
                                    "bf16 y is %.2f ulp off for %s"
                                    % (over, what))
                        cases += 1
    log("kernel check: %d cases passed; float32 max |y err| %.3g, "
        "max |mean/rstd err| %.3g (limit %.0e); bfloat16 max err %.2f ulp"
        % (cases, worst32, worst_stats, FP32_ATOL, worst16_ulps))
    return worst32, worst16_ulps


def _time_eager(torch, fn, iters=20, warmup=3):
    """Milliseconds per call of ``fn(i)`` enqueued from Python, by CUDA events
    around the loop: the larger of the host's time to enqueue a call and the
    device's time to run it."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_device(torch, fn, calls=20, replays=5):
    """Milliseconds of device time per call of ``fn(i)``: ``calls`` calls are
    captured into one CUDA graph and the graph is replayed, so the host's
    enqueue time is out of the measurement."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(i) for i in range(calls)]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del outs, graph
    return start.elapsed_time(end) / (replays * calls)


def time_kernel(torch, F, K, site_counts, extra):
    """Phase 5, per path shape and dtype.  Per-channel affine, biased
    variance, fused ReLU: the case the library call covers too.  Times are
    device times (CUDA-graph replay).  Inputs rotate over enough buffers to
    exceed the 50 MB L2, so every launch reads x from device memory, as the
    bound assumes.  ``site_counts[dtype][request][shape]`` are the launches
    the serving path was seen to make.  With ``extra``: ``kernel_ms_l2_warm``
    repeats on one buffer, which is closer to a norm that follows its conv;
    ``kernel_eager_ms`` includes the host's enqueue time;
    ``kernel_ms_wide_tile`` is the kernel without the tile narrowing of
    ``launch_geometry`` (an SM count of 0 switches it off)."""
    instance_norm_fused = K.instance_norm_fused
    instance_norm_plain = K.instance_norm_plain
    rows = []
    for shape in PATH_SHAPES + TIMED_EXTRA_SHAPES:
        n, hw, c = shape
        for dtype in (torch.float32, torch.bfloat16):
            itemsize = torch.finfo(dtype).bits // 8
            x_bytes = n * hw * c * itemsize
            # x read once, y written once; scale, shift read as (C,) and
            # mean, rstd written as (N, C), all float32
            nbytes = 2 * x_bytes + 2 * c * 4 + 2 * n * c * 4
            flops = 8 * n * hw * c
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / FP32_FLOP_PER_S * 1e3
            n_buf = max(2, -(-3 * 50 * 2 ** 20 // (2 * x_bytes)))
            bufs = [_make_inputs(torch, shape, dtype, "channel", seed=100 + i)
                    for i in range(n_buf)]
            kw = dict(eps=1e-5, unbiased=False, relu=True)

            def kernel(i):
                x, s, b = bufs[i % n_buf]
                return instance_norm_fused(x, s, b, **kw)

            def plain(i):
                x, s, b = bufs[i % n_buf]
                return instance_norm_plain(x, s, b, **kw)

            def library(i):
                # same memory: the NCHW view of the channels_last activation
                x, s, b = bufs[i % n_buf]
                return F.relu(F.instance_norm(
                    x.permute(0, 3, 1, 2), weight=s.to(dtype),
                    bias=b.to(dtype), eps=1e-5))

            name = str(dtype).split(".")[1]
            row = {
                "shape": list(shape), "dtype": name,
                "bytes": nbytes,
                "kernel_ms": _time_device(torch, kernel),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "plain_ms": _time_device(torch, plain),
                "library_ms": _time_device(torch, library),
                "launches_per_predict_B":
                    site_counts[name]["predict_B"].get(shape, 0),
                "launches_per_predict_A":
                    site_counts[name]["predict_A"].get(shape, 0),
            }
            if extra:
                row["kernel_ms_l2_warm"] = _time_device(
                    torch, lambda i: kernel(0))
                row["kernel_eager_ms"] = _time_eager(torch, kernel)
                sm_count = K._sm_count
                K._sm_count = lambda index: 0
                try:
                    row["kernel_ms_wide_tile"] = _time_device(torch, kernel)
                finally:
                    K._sm_count = sm_count
                row["geometry"] = list(K.launch_geometry(
                    n, c, itemsize, True, sm_count(0)))
                row["geometry_wide_tile"] = list(K.launch_geometry(
                    n, c, itemsize, True, 0))
            rows.append(row)
            del bufs
            torch.cuda.empty_cache()
    return rows


def _post(url, arrays=None, raw=None):
    if raw is None:
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        raw = buf.getvalue()
    req = urllib.request.Request(url, data=raw, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return np.load(io.BytesIO(resp.read()))


class Served:
    """An exported artifact behind a running server (context manager)."""

    def __init__(self, cfg, out_dir, batch):
        from domain_transfer_gan_torch.cli.export import export_model
        from domain_transfer_gan_torch.cli.serve import build_server
        from domain_transfer_gan_torch.models import create_model

        self.out_dir = out_dir
        model = create_model(cfg, testing=True, device="cuda")
        self.manifest = export_model(model, out_dir, batch=batch,
                                     device="cuda")
        self.server = build_server(out_dir, port=0, device="cuda")
        self.url = "http://127.0.0.1:%d" % self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        if self.thread.is_alive():
            raise RuntimeError("the server thread did not stop")


def _check_images(y, n, hw, nc, what):
    if y.shape != (n, hw, hw, nc) or y.dtype != np.float32:
        raise AssertionError("%s: shape %r dtype %s" % (what, y.shape,
                                                        y.dtype))
    if not np.isfinite(y).all() or np.abs(y).max() > 1.0:
        raise AssertionError("%s: values not finite in [-1, 1]" % what)
    if np.abs(y).mean() < 1e-3:
        raise AssertionError("%s: output is ~0 everywhere" % what)


def drive_serving_path(torch, fused, tmp):
    """Phase 4.  Returns (launches counted on the main path, launches per
    shape of the batch-32 requests, what the timing phases need)."""
    from domain_transfer_gan_torch.cli.serve import ExportedEndpoint
    from domain_transfer_gan_torch.config import TrainConfig

    batch, hw, nlatent = 32, 64, 16
    cfg = dict(model="aug_cycle_gan", grid_size=hw, ngf=32, n_blocks=3,
               nlatent=nlatent, input_nc=3, output_nc=3,
               init_scheme="sane", seed=2024)
    rng = np.random.RandomState(7)
    A = rng.uniform(-1, 1, (70, hw, hw, 3)).astype(np.float32)
    B = rng.uniform(-1, 1, (batch, hw, hw, 3)).astype(np.float32)
    z = rng.randn(70, nlatent).astype(np.float32)
    # the server samples a missing z from RandomState(0), in request order
    z_server = np.random.RandomState(0).randn(5, nlatent).astype(np.float32)

    counts, counts_by_shape = {}, {}

    def counted(name, fn):
        before, before_by_shape = fused.launches, dict(fused.launches_by_shape)
        out = fn()
        counts[name] = fused.launches - before
        counts_by_shape[name] = {
            k: v - before_by_shape.get(k, 0)
            for k, v in fused.launches_by_shape.items()
            if v != before_by_shape.get(k, 0)}
        return out

    # the main path starts here
    fused.launches = 0
    fused.launches_by_shape = {}
    with Served(TrainConfig(**cfg), tmp + "/fp32", batch) as srv:
        with urllib.request.urlopen(srv.url + "/", timeout=30) as resp:
            manifest = json.loads(resp.read())
        got = {
            "B32": counted("predict_B n=32", lambda: _post(
                srv.url + "/predict_B", {"A": A[:32], "z": z[:32]})),
            "B5": counted("predict_B n=5 no z", lambda: _post(
                srv.url + "/predict_B", {"A": A[:5]})),
            "B70": counted("predict_B n=70", lambda: _post(
                srv.url + "/predict_B", {"A": A, "z": z})),
            "A32": counted("predict_A n=32", lambda: _post(
                srv.url + "/predict_A", {"B": B})),
        }
        try:
            _post(srv.url + "/predict_B", raw=b"not-an-npz")
        except urllib.error.HTTPError as e:
            bad_code = e.code
        else:
            bad_code = 200
        fp32_dir = srv.out_dir

    with Served(TrainConfig(compute_dtype="bfloat16", **cfg), tmp + "/bf16",
                batch) as srv16:
        manifest16 = srv16.manifest
        got["B32_bf16"] = counted("predict_B n=32 bfloat16", lambda: _post(
            srv16.url + "/predict_B", {"A": A[:32], "z": z[:32]}))
        got["A32_bf16"] = counted("predict_A n=32 bfloat16", lambda: _post(
            srv16.url + "/predict_A", {"B": B}))
        bf16_dir = srv16.out_dir
    main_path_launches = fused.launches  # the main path ends here

    if manifest["batch"] != batch or manifest["platforms"] != ["cuda"] or \
            manifest["serve_dtype"] != "float32" or \
            manifest16["serve_dtype"] != "bfloat16":
        raise AssertionError("unexpected manifest %r" % manifest)
    if bad_code != 400:
        raise AssertionError("malformed request answered %d, not 400"
                             % bad_code)
    want_counts = {"predict_B n=32": 11, "predict_B n=5 no z": 11,
                   "predict_B n=70": 33, "predict_A n=32": 8,
                   "predict_B n=32 bfloat16": 11,
                   "predict_A n=32 bfloat16": 8}
    if counts != want_counts:
        raise AssertionError("kernel launches per request %r, expected %r"
                             % (counts, want_counts))
    site_counts = {
        "float32": {"predict_B": counts_by_shape["predict_B n=32"],
                    "predict_A": counts_by_shape["predict_A n=32"]},
        "bfloat16": {"predict_B": counts_by_shape["predict_B n=32 bfloat16"],
                     "predict_A": counts_by_shape["predict_A n=32 bfloat16"]}}
    for dtype_name, per_fn in site_counts.items():
        for fn_name, want_sites in (("predict_B", SITES_PREDICT_B),
                                    ("predict_A", SITES_PREDICT_A)):
            if per_fn[fn_name] != want_sites:
                raise AssertionError(
                    "%s %s launched the kernel at %r, expected %r"
                    % (fn_name, dtype_name, per_fn[fn_name], want_sites))

    # the same generators with every norm through the plain version
    plain_B = ExportedEndpoint(fp32_dir, "predict_B", batch, "cuda")
    plain_A = ExportedEndpoint(fp32_dir, "predict_A", batch, "cuda")
    plain_B16 = ExportedEndpoint(bf16_dir, "predict_B", batch, "cuda")
    plain_A16 = ExportedEndpoint(bf16_dir, "predict_A", batch, "cuda")
    before = fused.launches
    want = {
        "B32": plain_B(A[:32], z[:32], plain_norm=True),
        "B5": plain_B(A[:5], z_server, plain_norm=True),
        "B70": plain_B(A, z, plain_norm=True),
        "A32": plain_A(B, plain_norm=True),
        "B32_bf16": plain_B16(A[:32], z[:32], plain_norm=True),
        "A32_bf16": plain_A16(B, plain_norm=True),
    }
    if fused.launches != before:
        raise AssertionError("the plain-norm reference launched the kernel")
    errs = {}
    for k, n in (("B32", 32), ("B5", 5), ("B70", 70), ("A32", 32)):
        _check_images(got[k], n, hw, 3, k)
        errs[k] = float(np.abs(got[k] - want[k]).max())
        if errs[k] > SERVE_ATOL:
            raise AssertionError("%s differs from the plain-norm answer by "
                                 "%g (limit %g)" % (k, errs[k], SERVE_ATOL))
    for k in ("B32_bf16", "A32_bf16"):
        _check_images(got[k], 32, hw, 3, k)
        d = np.abs(got[k] - want[k])
        errs[k], errs[k + "_mean"] = float(d.max()), float(d.mean())
        if errs[k] > BF16_SERVE_MAX_ATOL or \
                errs[k + "_mean"] > BF16_SERVE_MEAN_ATOL:
            raise AssertionError(
                "%s differs from the bfloat16 plain-norm answer by max %g "
                "mean %g (limits %g, %g)" % (
                    k, errs[k], errs[k + "_mean"], BF16_SERVE_MAX_ATOL,
                    BF16_SERVE_MEAN_ATOL))
    d16 = np.abs(got["B32_bf16"] - got["B32"])
    errs["B32_bf16_vs_fp32"] = float(d16.max())
    errs["B32_bf16_vs_fp32_mean"] = float(d16.mean())
    if errs["B32_bf16_vs_fp32"] > BF16_MAX_ATOL or \
            errs["B32_bf16_vs_fp32_mean"] > BF16_MEAN_ATOL:
        raise AssertionError(
            "bfloat16 predict_B differs from float32 by max %g mean %g "
            "(limits %g, %g)" % (errs["B32_bf16_vs_fp32"],
                                 errs["B32_bf16_vs_fp32_mean"],
                                 BF16_MAX_ATOL, BF16_MEAN_ATOL))
    log("serving path: launches per request %s" % json.dumps(counts))
    log("serving path: launches per request and shape %s" % json.dumps(
        {name: {"%dx%dx%d" % k: v for k, v in sorted(per.items())}
         for name, per in counts_by_shape.items()}))
    log("serving path: max |served - plain-norm| %s" % json.dumps(errs))
    ctx = {"fp32_dir": fp32_dir, "bf16_dir": bf16_dir, "A": A, "B": B,
           "z": z, "batch": batch, "cfg": cfg}
    return main_path_launches, site_counts, ctx


def check_norm_sites(torch, ctx):
    """Every norm site of both generators, in float32 and bfloat16, on the
    input the forward really gives it: the module's answer through the kernel
    against the same module's answer through the plain version.  Unlike the
    end-to-end comparison nothing downstream amplifies a difference here, so
    bfloat16 is held to one ulp.  Returns the worst float32 error, the worst
    bfloat16 distance in ulps and the largest fraction of a bfloat16 site's
    elements that differ."""
    from domain_transfer_gan_torch.config import TrainConfig
    from domain_transfer_gan_torch.models import create_model
    from domain_transfer_gan_torch.nn.norms import (
        CondInstanceNorm,
        InstanceNorm,
    )

    batch, cfg = ctx["batch"], ctx["cfg"]
    worst = {"float32": 0.0, "bfloat16": 0.0, "bfloat16_differ": 0.0}
    sites = {}

    def hook(mod, args, out):
        # the norms are called as norm(x[, z], plain_norm)
        want = mod.forward(*args[:-1], True)
        sites[out.dtype] = sites.get(out.dtype, 0) + 1
        if out.dtype == torch.float32:
            e = float((out - want).abs().max())
            worst["float32"] = max(worst["float32"], e)
            if e > FP32_ATOL:
                raise AssertionError("norm site %r: kernel and plain version "
                                     "differ by %g" % (mod, e))
        else:
            over, differ = _bf16_ulps_apart(torch, out, want)
            worst["bfloat16"] = max(worst["bfloat16"], over)
            worst["bfloat16_differ"] = max(worst["bfloat16_differ"], differ)
            if over > 1.0:
                raise AssertionError("norm site %r: bfloat16 kernel is %.2f "
                                     "ulp off the plain version" % (mod, over))

    for dtype in ("float32", "bfloat16"):
        model = create_model(TrainConfig(compute_dtype=dtype, **cfg),
                             testing=True, device="cuda")
        for net in model.nets.values():
            for mod in net.modules():
                if isinstance(mod, (InstanceNorm, CondInstanceNorm)):
                    mod.register_forward_hook(hook)
        model.predict_B(ctx["A"][:batch], ctx["z"][:batch])
        model.predict_A(ctx["B"])
    torch.cuda.synchronize()
    if sites != {torch.float32: 19, torch.bfloat16: 19}:
        raise AssertionError("norm sites seen: %r, expected 11 + 8 per dtype"
                             % sites)
    log("norm sites: 19 float32 sites max |kernel - plain| %.3g; 19 bfloat16 "
        "sites at most %.2f ulp apart, at most %.3g of a site's elements "
        "differ" % (worst["float32"], worst["bfloat16"],
                    worst["bfloat16_differ"]))
    return worst


def time_end_to_end(torch, ctx):
    """images/s of the two generators at batch 32: the exported callables on
    device tensors (wall time around a final synchronize) and whole HTTP
    requests, 20 timed calls after 3 warm-ups each."""
    from domain_transfer_gan_torch.cli.export import load_exported
    from domain_transfer_gan_torch.cli.serve import build_server

    batch = ctx["batch"]
    A = torch.from_numpy(ctx["A"][:batch]).cuda()
    B = torch.from_numpy(ctx["B"]).cuda()
    z = torch.from_numpy(ctx["z"][:batch]).cuda()
    out = {"batch": batch, "timed_calls": 20, "warmups": 3}
    for d, tag in ((ctx["fp32_dir"], "float32"), (ctx["bf16_dir"], "bfloat16")):
        pb = load_exported(d, "predict_B", "cuda")
        pa = load_exported(d, "predict_A", "cuda")
        for name, call in (("predict_B", lambda: pb(A, z)),
                           ("predict_A", lambda: pa(B))):
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                call()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            out["%s_%s_images_per_s" % (name, tag)] = 20 * batch / dt
            out["%s_%s_ms_per_call" % (name, tag)] = dt / 20 * 1e3

    server = build_server(ctx["fp32_dir"], port=0, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = "http://127.0.0.1:%d" % server.server_address[1]
        reqs = (("predict_B", {"A": ctx["A"][:batch], "z": ctx["z"][:batch]}),
                ("predict_A", {"B": ctx["B"]}))
        for name, arrays in reqs:
            for _ in range(3):
                _post(url + "/" + name, arrays)
            t0 = time.perf_counter()
            for _ in range(20):
                _post(url + "/" + name, arrays)
            dt = time.perf_counter() - t0
            out["http_%s_float32_images_per_s" % name] = 20 * batch / dt
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return out


def profile_forward(torch, ctx):
    """Device time of one predict_B and one predict_A forward by kernel name
    (torch.profiler), float32, batch 32."""
    from torch.profiler import ProfilerActivity, profile

    from domain_transfer_gan_torch.cli.export import load_exported

    batch = ctx["batch"]
    A = torch.from_numpy(ctx["A"][:batch]).cuda()
    B = torch.from_numpy(ctx["B"]).cuda()
    z = torch.from_numpy(ctx["z"][:batch]).cuda()
    pb = load_exported(ctx["fp32_dir"], "predict_B", "cuda")
    pa = load_exported(ctx["fp32_dir"], "predict_A", "cuda")
    out = {}
    for name, call in (("predict_B", lambda: pb(A, z)),
                       ("predict_A", lambda: pa(B))):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        reps = 5
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        kernels = {}
        for ev in prof.events():
            if str(getattr(ev, "device_type", "")).endswith("CUDA"):
                dur = ev.time_range.elapsed_us()
                kernels[ev.name] = kernels.get(ev.name, 0.0) + dur / reps
        top = sorted(kernels.items(), key=lambda kv: -kv[1])
        out[name] = {
            "device_busy_ms_per_call": sum(kernels.values()) / 1e3,
            "kernels_us_per_call": {k[:80]: round(v, 2) for k, v in top[:14]},
        }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler breakdown and the "
                         "kernel's extra timings")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures on the card only",
              file=sys.stderr)
        return 2

    from domain_transfer_gan_torch.ops.kernels import build
    from domain_transfer_gan_torch.ops.kernels import instance_norm as K

    t_start = time.perf_counter()
    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("python %s, torch %s, CUDA %s; cudnn.allow_tf32=%s, "
        "cuda.matmul.allow_tf32=%s"
        % (sys.version.split()[0], torch.__version__, torch.version.cuda,
           torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32))

    # phase 2: build every kernel source from this checkout
    t0 = time.perf_counter()
    built = [build.compile_kernel(name) for name in build.kernel_names()]
    build_s = time.perf_counter() - t0
    log("built %s in %.1f s" % (", ".join(built), build_s))

    # phase 3: kernel against its plain version
    worst32, worst16_ulps = check_kernel(torch, K.instance_norm_fused,
                                         K.instance_norm_plain)

    # phase 4: the serving path
    with tempfile.TemporaryDirectory() as tmp:
        launches, site_counts, ctx = drive_serving_path(
            torch, K.instance_norm_fused, tmp)
        if launches < 1:
            raise AssertionError("the serving path never launched the kernel")
        check_norm_sites(torch, ctx)

        # phase 5: times
        rows = time_kernel(torch, F, K, site_counts, extra=args.profile)
        e2e = time_end_to_end(torch, ctx)
        prof = profile_forward(torch, ctx) if args.profile else None

    head = next(r for r in rows
                if (tuple(r["shape"]), r["dtype"]) == HEADLINE)
    kernels = {"kernels": [{
        "name": "instance_norm_fwd",
        "route": "cuda",
        "source": "domain_transfer_gan_torch/csrc/instance_norm.cu",
        "replaces": "domain_transfer_gan_tpu/ops/pallas/instance_norm.py:115",
        "launches": launches,
        "max_abs_err": worst32,
        "max_err_bf16_ulps": worst16_ulps,
        "shape": list(HEADLINE[0]), "dtype": HEADLINE[1],
        "ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "launches_per_predict_B": sum(
            site_counts["float32"]["predict_B"].values()),
        "launches_per_predict_A": sum(
            site_counts["float32"]["predict_A"].values()),
        "shapes": rows,
    }]}
    log(json.dumps({"end_to_end": e2e, "card": smi}))
    if prof is not None:
        log(json.dumps({"profile": prof, "card": smi}))
    log("total %.1f s (build %.1f s)" % (time.perf_counter() - t_start,
                                         build_s))
    log(json.dumps(kernels))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
