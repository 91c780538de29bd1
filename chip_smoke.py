#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device, ``nvcc`` and no network.  It

1. prints the card's name and power limit and switches TF32 off, so the
   float32 phases compare in full float32;
2. builds every CUDA source of ``domain_transfer_gan_torch/csrc`` into
   ``build/``, one ``nvcc`` per source, all started together;
3. holds both instance-norm kernels against their plain PyTorch versions on
   the card, each in its variants (the on-chip cluster one wherever
   ``cluster_plan`` can take the shape, else the ring route wherever it
   can, each ring launch repeated bit for bit; the streaming one
   everywhere), at every shape the serving path, the train steps at batch
   32 and batch 128, the training CLI's evaluations and visuals (the
   generators at 10, 25, 50, 100 and 250 images), the evaluation CLI's (at
   5, 64, 150, 200 and 320 besides) and phase 9's steps (at 256x256 too)
   give them and at edge shapes, in float32 and
   bfloat16, over unbiased x relu x {no, per-channel, per-sample} affine:
   the forward's y, mean, rstd, and the backward's dx, dscale, dshift;
4. drives the serving path at the published width (``aug_cycle_gan``, ngf 32,
   3 blocks, nlatent 16, 64x64, serving batch 32): seed-drawn weights ->
   ``export_model`` -> ``build_server`` on an ephemeral port -> HTTP requests
   (manifest, ``predict_B`` with z, without z and padded, chunked,
   ``predict_A``, a malformed body), each answer compared with the same
   generators run with the kernel's plain version, the launch counters read
   before and after (every launch must take the cluster variant), then
   ``predict_B`` and ``predict_A`` again from a
   bfloat16 artifact; then every norm site of both generators on the input
   its forward gives it, kernel against plain version, in both dtypes;
   then the JAX package's own export directories
   (``tests/fixtures/jax_serve``: ``jax.export`` StableHLO lowered for
   ``tpu``, the full-width one and six tiny ones: bfloat16 on two
   draws, ``cycle_gan``, ``["cpu", "tpu"]``) behind the same server, run
   by the port's StableHLO interpreter, each against ``exp.call``'s
   committed outputs, with no kernel of the port launched (phase 6 times
   the full-width one beside the port's own artifact, as callables and
   over HTTP);
5. drives the training path at the same width (nef 32, ndf 64, all six
   networks): ``create_model`` -> ``train_instance``, 3 steps in float32 at
   batch 32 against a twin model with the same weights whose norms run the
   plain version in both directions, then at batch 128 one float32 step and
   3 steps with bfloat16 compute, each against such a twin of its own dtype
   (losses and gradient norms), and one step with ``norm="batch"``; the
   forward and backward launch counters are read around every step and held
   to the counts the step's structure gives, and every launch must take the
   cluster variant;
6. times both kernels (the library call, the streaming variant and the
   cluster variant or the ring route, one after the other, with the plan
   beside each row) at every site of the serving path, the train steps and
   the eval batch of 100 and at the 256x256 generator sites (N = 4, 8, 32)
   in both dtypes, beside their plain versions and the library calls
   (``F.relu(F.instance_norm(...))`` and its backward), the two generators
   end to end and the train step in both dtypes, and prints the ``kernels``
   line with the launches per variant;
7. (run before 6, whose rows carry its launch counts) drives the training
   CLI, ``python -m domain_transfer_gan_torch.cli.train`` as a user calls
   it, at the published width on a synthetic npz set (420 train images with
   a dev split of 100, 150 test images, so the last eval batch is a padded
   tail): 2 epochs with every cadence firing and the train set on the card,
   then one more with ``--continue_train``; it holds the artifact contract,
   finite losses in every log line, the resume and the lr schedule, the
   launch counts by shape and variant that the run's structure gives
   (train steps, eval_mse_A and the UBO's 50 forward + backward steps at
   the eval batch, the grids), a bit-exact checkpoint round trip, the UBO
   of the test set's padded tail batch from that checkpoint against the
   same with every norm through the plain version on the same noise (after
   the run, outside its launch counts and times), and
   ``cli.export --chk_path`` + the
   server's ``predict_B`` against the loaded checkpoint; it prints the
   CLI's train images/s, seconds per eval batch and the save's cost;
8. (also before 6) the other two variants and the supervised step at the
   same width: 2 float32 ``stoch_cycle_gan`` steps at batch 32, one
   bfloat16-compute step at batch 128, one ``cycle_gan`` step and 2
   supervised steps, each against a plain-norm twin with phase 5's limits
   and its launches by shape held to the step's structure; one epoch each
   of ``--model stoch_cycle_gan``, ``--model cycle_gan`` and
   ``aug_cycle_gan --supervised`` through the training CLI on phase 7's
   data (eval-A, eval-B, ``latest``), an export of the
   ``stoch_cycle_gan`` checkpoint and one served ``predict_B``; then the
   evaluation CLI, ``python -m domain_transfer_gan_torch.cli.test`` as a
   user calls it, on the three checkpoints: every ``--metric`` on the
   supervised one (``bpp`` with ``--train_logvar 1``: 500 UBO steps at
   N = 200), all but ``bpp`` on the other two, and ``--metric fid
   --fid_extractor`` on the supervised one with the JAX package's proxy
   net as a ``jax.export`` artifact, run by the port's StableHLO
   interpreter (its features held to the built-in extractor's and
   ``FID_B`` to ``PROXY_FID_B``, its load time and images/s printed on a
   ``fid_extractor:`` line with the card's name and power limit); each
   run's launches by
   shape and variant held to its structure, each metric's files and
   numbers checked, ``TEST_MSE_A`` held to ``eval_mse_A`` over the same
   batch, and the first ``bpp`` chunk held to the same with plain norms on
   the same noise (after the runs); it prints each run's and each
   metric's seconds;
9. (also before 6) the step extras at the same width: ``--grad_accum 4``
   steps of ``aug_cycle_gan`` (2 float32 at batch 32, one bfloat16 at 128,
   one float32 at batch 32 on 256x256 images) and of ``stoch_cycle_gan``
   (one float32 at 32), 3 float32 ``--pool_size 50 --ema 0.999`` steps at
   32 (the pool full by step 2, so it replays), one fused bfloat16
   ``aug_cycle_gan`` step on 256x256 images at batch 32 (its generator
   sites through the ring route), each against a plain-norm
   twin with the same weights, inputs, noise and pool draws under phase 5's
   limits, with its launches by shape and variant held to its structure
   (K1 and K2 at the microbatch of 8, the discriminators' concatenated pass
   at 16, K times per phase, plus the G phase's recomputed phase 0), the
   EMA shadow against the formula (within its float32 rounding) and the
   twin's (by its displacement from the start); one ``--remat`` step with
   dropout and one with ``--norm batch`` against the same step without it
   (losses and gradient norms at phase 5's step-1 limits, running
   statistics equal, one more forward launch per generator norm site for
   each of the four generator calls with a graph); the bfloat16 batch-128
   step fused, with ``--remat`` and with ``--grad_accum 4``: peak memory
   and time; the float32 batch-32 step with and without the pool and EMA:
   time; the 256x256 float32 ``--grad_accum 4`` step and the 256x256
   bfloat16 batch-32 step (the latter through the ring route and with the
   streaming variant forced, one after the other): time, peak memory and the
   instance norms' device time and share under ``torch.profiler``; then
   one epoch each of ``aug_cycle_gan --pool_size 50 --ema
   0.999 --remat`` and ``--grad_accum 4 --ema 0.999`` through the training
   CLI on phase 7's data, one more epoch of the pool run with
   ``--continue_train`` (its restored pools equal the saved ones bit for
   bit), ``cli.test --use_ema 1 --metric mse`` (``TEST_MSE_A`` against
   ``eval_mse_A`` of the loaded and swapped model) and ``cli.export
   --use_ema 1`` with one served ``predict_B`` against the swapped model's;
   every run's launches held to its structure.  Phase 3 checks the kernels
   at phase 9's microbatch shapes too, and phase 6 times them;
10. (also before 6) the per-file data path, the host feed, the Livneh ETL
   and upstream-checkpoint interop at the same width, in float32: (a) a
   Livneh-shaped NetCDF-3 pair (500 days of Prec, Tmax, Tmin, wind and SWE
   over one NaN land mask) through ``data.prep_livneh``, its bundles and
   per-sample files and 80/20 chronological split checked, one epoch of
   ``--input_nc 3 --output_nc 1`` on the bundles; (b) one epoch of
   ``--numpy_data 0 --device_data 0 --nThreads 4`` on 567 per-sample
   files (a train tail batch of 19, an eval tail of 30 padded to 200) with
   eval-A, eval-B, a display and ``--profile_dir``, then ``cli.test
   --metric mse`` (``TEST_MSE_A`` against ``eval_mse_A`` over the same
   DataLoader) and ``--metric visual``; (c) the prefetching feed's batches
   against a synchronous copy bit for bit, the native reader against
   numpy (ms per batch), and the same epoch's images/s three ways in turn
   (npz bundles on the card, the per-file set through the feed, and
   through a synchronous copy: the CLI with its feed swapped for a
   pass-through); (d) ``--supervised --device_data 1``;
   (e) the trace of (b) names K1 and K2; (f) ``export_torch_checkpoint``
   -> ``cli.import_torch`` -> ``predict_B`` within 1e-6 and one resumed
   epoch; (g) a paired-jpg folder where PIL is present, its refusal where
   it is not.  Every run's launches are held to its structure, phase 3
   checks the kernels at phase 10's new shapes, and phase 6 times them;
11. (also before 6) a run moved between packages and trained over ranks, at
   the same width: (a) phase 7's ``latest`` through ``cli.export_jax``
   (the JAX package's flax msgpack format) and back through the port's
   ``load``, every tensor, count and number equal and ``predict_B`` bit for
   bit, then one ``--continue_train`` epoch from the flax file (where
   ``msgpack`` is missing, its refusal by name instead); the same model
   saved as the JAX package's orbax directory (``--ckpt_backend orbax``),
   one ``--continue_train`` epoch of the CLI from it with that backend, its
   ``latest`` directory reloaded equal to the run's model and
   ``predict_B`` bit for bit, then the JAX-written orbax fixture
   (``tests/fixtures/orbax_tiny``: OCDBT, zstd through the card machine's
   libzstd) read with every leaf's sha256 held and one step from it within
   phase 5's float32 limits of its plain-norm twin; (c) the training
   CLI as two processes on the card (``--coordinator --num_processes 2
   --process_id``), one epoch with eval-A and eval-B: rank 0's artifacts
   phase 7's, rank 1's under ``.worker1/``, equal losses on both, the run's
   ``TEST_MSE_A`` that of one process and ``cli.test --metric mse`` held to
   ``eval_mse_A``; (b) two ranks on the card over gloo, each a process on
   half the batch, against one process on the full batch
   (``parallel/selfcheck.py``): ``aug_cycle_gan`` float32 at 32 and
   bfloat16 at 128, ``--norm batch``, ``--pool_size 50`` (2 steps each, phase
   5's limits), a batch-norm pass at float32 rounding and the sharded
   eval-A and UBO of (c)'s checkpoint; each rank's launches held to the
   structure of its half batch; over NCCL as well where there are two
   cards.  Phase 3 checks and phase 6 times the ranks' generator shapes;
12. (also before 6) the space, model and pipe axes over ranks at the same
   width: K1-split and K2-split (the four launches of the instance norm
   for rows spread over a space axis) each against its plain twin and,
   gathered, against unsplit K1 / K2, at every rank shape phase 12 gives
   them (its step's generator and discriminator sites, its CLI's
   evaluation and visual sites) and at 256x256 at batch 8, both dtypes;
   two ranks on the card over gloo against one process on the full batch,
   2 float32 steps each at phase 5's limits: ``--pipeline 2 --n_blocks 4``
   at M = 2 and M = 4, ``--spatial 2`` (every split kernel launched, at
   the shapes ``split_sites`` gives), ``--tensor 2`` (each rank's bytes of
   parameters and moments below one process's); one epoch of the training
   CLI as two processes with ``--pipeline 2`` and with ``--spatial 2``
   (their split launches counted, at checked shapes only), each run's
   ``latest`` loaded and scored by one process to its ``TEST_MSE_A``.
   Phase 6 times the split kernels, without and with the ReLU, beside
   their twins, the library calls and their bound, and the ``kernels``
   line carries them;
13. (also before 6) the root entry points and ROADMAP F5's repair:
   ``__graft_entry_torch__.entry()`` against plain norms,
   ``dryrun_multichip(4)``, the ``dp_sp_tp`` job over 8 ranks at full width
   against one process, the eval job and a float32 step each run twice, bit
   for bit; then both pad kernels (``csrc/pad.cu``) against ``F.pad`` at
   every pad shape phases 4-13 launched them at, and their times.

Any failed build, launch or check ends the run with a non-zero exit code.
The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``--twin-seeds N`` repeats phase 5 from N further seeds with the limits on
fused-vs-twin deviations lifted and prints the deviations (the limits above
were chosen from such a run).  ``--profile`` adds what PERF.md reports beyond
the check: a
``torch.profiler`` breakdown of one ``predict_B`` and one ``predict_A``
forward and of one train step per dtype by kernel name, at every timed
shape both
kernels' times under every cluster size that holds the slab,
per timed serving shape the forward kernel's time on one buffer that
stays in L2, its time enqueued call by call from Python, and the streaming
variant's time with the launch geometry's tile narrowing switched off, and a
breakdown of the UBO's RMSprop steps at the eval batches of 100 and 200.
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

from domain_transfer_gan_torch.utils.timing import (
    TRAIN_BATCH, TRAIN_CFG, full_model, norm_ms, profile_train_step,
    profile_ubo_step, profile_window, profiled, time_train_step,
    time_ubo_step, top_kernels, train_inputs)

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# (N, HW, C) of the norm sites of one forward at the published width and
# serving batch 32, with how often each is expected to occur; the counts that
# are printed are the measured ones, these are what they are held to
PATH_SHAPES = ((32, 4096, 32), (32, 4096, 64), (32, 1024, 128))
SITES_PREDICT_B = {(32, 4096, 32): 2, (32, 4096, 64): 2, (32, 1024, 128): 7}
SITES_PREDICT_A = {(32, 4096, 32): 2, (32, 4096, 64): 2, (32, 1024, 128): 4}
# edge shapes: rows of 16 and of 80 bytes, the first site of a 256x256
# request, and wide rows whose ring the plan narrows to fit a CTA (the
# discriminators' third site at 256x256 with --ndf 128 --batchSize 1)
EDGE_SHAPES = ((2, 4096, 4), (3, 169, 20), (4, 65536, 32), (2, 3969, 512))
# timed besides the path shapes: the first norm site of a 256x256 request of
# 4 images, twice the bytes of (32, 4096, 32) in a grid of only 16 blocks
TIMED_EXTRA_SHAPES = ((4, 65536, 32),)
HEADLINE = ((32, 1024, 128), "float32")  # the most frequent site
HW1_SHAPE = (8, 1, 16)  # one pixel: x - mean = 0, the unbiased divisor is 1

# (losses, gnorms) of a fused step vs the same step of a twin model with the
# same weights whose norms run the plain version forward and backward, in
# the same compute dtype and at the same batch, relative to max(1, |value|).
# Largest seen on an H100 over six runs from these seeds and eight from
# others (--twin-seeds; cuDNN's weight gradients differ from run to run):
# float32 8.8e-6 / 7.8e-4 at either batch; bfloat16, where a norm output one
# ulp apart is spread by the bfloat16 convs downstream, 2.7e-3 / 2.3e-2.
TRAIN_STEP1_RTOL = {"float32": (1e-4, 2e-3), "bfloat16": (1e-2, 8e-2)}
# by step 3 the two models' weights differ: Adam's first updates are
# lr * g / (|g| + 1e-8), so a gradient entry near zero that the two summation
# orders put on either side of zero moves its weight by 2 * lr the other way.
# Largest seen over the same runs: float32 3.6e-3 / 6.0e-2 (3.6e-2 from
# these seeds), bfloat16 1.3e-2 / 2.5e-1 (7.3e-2 from these seeds).
TRAIN_STEP3_RTOL = {"float32": (1e-2, 2e-1), "bfloat16": (5e-2, 5e-1)}
# sanity only: bfloat16 compute vs float32 on the same inputs and weights,
# step 1 losses (1.8e-3 to 9.8e-3 over the same runs, 5.3e-3 from these seeds)
TRAIN_BF16_VS_FP32_RTOL = 2e-2

def _add(d, sites, k=1):
    for shape, c in sites.items():
        d[shape] = d.get(shape, 0) + k * c


def disc_shapes(n, ndf=64, hw=64):
    """(N, HW, C) of the three norm sites of D_A (ndf 32, hard-wired) and of
    D_B (``ndf``) on n hw x hw images (at 64: 16x16, 8x8, 4x4 and 16x16,
    15x15, 14x14)."""
    s = hw // 4
    return ((n, s * s, 64), (n, s * s // 4, 128), (n, s * s // 16, 128),
            (n, s * s, 2 * ndf), (n, (s - 1) ** 2, 4 * ndf),
            (n, (s - 2) ** 2, 4 * ndf))


def gen_sites(n, fn, ngf=32, n_blocks=3, hw=64):
    """Launches of one forward of a generator on n hw x hw images by (N, HW,
    C): ``fn`` "B" is netG_A_B (two norms per residual block), "A" netG_B_A
    (one); both have 2 + 2 + 1 more in their stem and head."""
    per_block = 2 if fn == "B" else 1
    return {(n, hw * hw, ngf): 2, (n, hw * hw, 2 * ngf): 2,
            (n, hw * hw // 4, 4 * ngf): 1 + per_block * n_blocks}


def train_sites(batch, n_blocks=3, ngf=32, ndf=64, hw=64):
    """Launches per train step by (N, HW, C) under norm="instance", the same
    for the forward and the backward kernel.  Forward: two passes through
    each generator (5 + 2 n_blocks and 5 + n_blocks sites), one concatenated
    fake|real pass through D_A and D_B in the D phase (N = 2 batch) and one
    in the G phase.  Backward: every one of those sites once."""
    sites = {}
    for fn in ("B", "A"):
        for shape, k in gen_sites(batch, fn, ngf, n_blocks, hw).items():
            sites[shape] = sites.get(shape, 0) + 2 * k
    for shape in disc_shapes(2 * batch, ndf, hw) + disc_shapes(batch, ndf,
                                                               hw):
        sites[shape] = 1
    return sites


def accum_sites(batch, k, n_blocks=3, ngf=32, ndf=64, hw=64):
    """Launches per ``--grad_accum k`` train step by direction and (N, HW,
    C), instance norms, either variant's step (the encoder and the latent
    discriminator have batch norms only): per microbatch of m = batch / k,
    the D phase runs phase 0 (each generator once, no backward) and the
    concatenated fake|real pass through D_A and D_B (N = 2m), the G phase
    runs phase 0 again, D_A and D_B on the fakes and the two cycles; the
    backward covers the D phase's discriminators and everything of the G
    phase."""
    m = batch // k
    fwd, bwd = {}, {}
    for fn in ("B", "A"):
        sites = gen_sites(m, fn, ngf, n_blocks, hw)
        _add(fwd, sites, 3 * k)
        _add(bwd, sites, 2 * k)
    for d in (fwd, bwd):
        for shape in disc_shapes(2 * m, ndf, hw) + disc_shapes(m, ndf, hw):
            d[shape] = d.get(shape, 0) + k
    return {"fwd": fwd, "bwd": bwd}


def remat_sites(batch, instance=True, n_blocks=3, ngf=32, ndf=64):
    """Launches of one ``--remat`` train step of aug_cycle_gan: the fused
    step's, and in the forward one more per generator norm site for each of
    the four generator calls with a graph (its recompute in the backward).
    Under norm="batch" only netG_A_B has instance norms."""
    if instance:
        step = train_sites(batch, n_blocks, ngf, ndf)
        fwd = dict(step)
        for fn in ("B", "A"):
            _add(fwd, gen_sites(batch, fn, ngf, n_blocks), 2)
    else:
        step = {s: 2 * c for s, c in gen_sites(batch, "B", ngf,
                                                n_blocks).items()}
        fwd = {s: 2 * c for s, c in step.items()}
    return {"fwd": fwd, "bwd": dict(step)}

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
# phase 4's JAX arm: the JAX package's own export directories
# (tests/fixtures/make_jax_serve_fixtures.py) served by cli/serve.py and
# run by the port's StableHLO interpreter, no hand-written kernel: the
# full-width one (aug_cycle_gan, ngf 32, nlatent 16, batch 32, lowered for
# tpu) and six tiny ones (bfloat16 on two draws of weights, cycle_gan's
# dropped z, a ["cpu", "tpu"] module's case on _platform_index), each
# against exp.call's committed outputs on its seeded inputs: float32 within
# JAX_SERVE_ATOL (the JAX norm's E[x^2] - mean^2 puts exp.call itself
# 2.5e-5 from the module in float64 on the CPU), bfloat16 within
# BF16_MAX_ATOL / BF16_MEAN_ATOL of the bfloat16 exp.call
JAX_SERVE = ("tests", "fixtures", "jax_serve")
JAX_SERVE_FULL = "aug_full_f32_tpu"
JAX_SERVE_TINY = ("aug_f32_tpu", "aug_bf16_tpu", "cycle_f32_tpu",
                  "aug_f32_cpu_tpu", "aug_f32_s2_tpu", "aug_bf16_s2_tpu")
JAX_SERVE_ATOL = 1e-4


# the training CLI phase (phase 7): a synthetic npz set of 420 train images
# (100 of them the dev split, 10 steps of 32 per epoch) and 150 test images
# (eval batches of 100 and a tail of 50 padded to 100), 2 epochs, then one
# resumed; the generators run at the eval batch of 100 (eval_mse_A, the
# UBO's 50 RMSprop steps), at 50 (eval_mse_A's test tail), at the 25 of a
# dev visual batch, at 10 (the inference grid's header) and at 250 (the
# multi and inference grids)
CLI_DATA = dict(n_train=420, n_test=150, dev_size=100)
CLI_EPOCHS, CLI_RESUMED_EPOCHS = 2, 1
EVAL_BATCH, UBO_STEPS, DEV_VIS_BATCH, NUM_MULTI = 100, 50, 25, 10
# eval_mse_A runs a short tail batch as it is (the UBO pads it to 100)
CLI_EVAL_TAIL = CLI_DATA["n_test"] % EVAL_BATCH
CLI_BATCHES = tuple(sorted({EVAL_BATCH, CLI_EVAL_TAIL, DEV_VIS_BATCH,
                            NUM_MULTI, DEV_VIS_BATCH * NUM_MULTI}))
EVAL_SHAPES = tuple(gen_sites(EVAL_BATCH, "B"))
# the UBO of the test set's padded tail batch, from the trained checkpoint,
# vs the same with every norm through the plain version, on the same noise:
# float32 on the card, the kernels' sums in another order.  Step 1 is the
# starting iterate's bound (~5e4 nats from 12288 per-pixel terms).
# RMSprop's first update is 10 lr * sign(g) per entry, so an entry whose
# gradient sits at 0 may move either way; the 50th step's bound sees that
# and the gradients' magnitudes too, and is held loosely.
UBO_STEP1_RTOL = 1e-5
UBO_LAST_RTOL = 1e-3
EXPORT_ATOL = 1e-5  # exported predict_B vs the loaded checkpoint's, float32

# phase 8: the other variants, the supervised step and the evaluation CLI on
# the phase-7 data set.  The evaluation CLI scores at batch 200: the test set
# (150 images) as one batch, padded to 200 by the UBO of --metric bpp (500
# steps of netG_A_B forward + backward), the dev set (100) as one batch,
# train_logvar on a 20 % train subset (64 images, one batch); --metric
# visual decodes one dev batch of 10 with 5 samples per grid (50 images, an
# inference header of 5), --metric z_div 32 inputs x 10 z's
TEST_BATCH, BPP_STEPS = 200, 500
TEST_SUBSET = (CLI_DATA["n_train"] - CLI_DATA["dev_size"]) // 5
TEST_VIS_BATCH, TEST_NUM_MULTI, Z_DIV_INPUTS = 10, 5, 32
TEST_CLI_BATCHES = tuple(sorted({
    TEST_BATCH, CLI_DATA["n_test"], CLI_DATA["dev_size"], TEST_SUBSET,
    TEST_VIS_BATCH, TEST_VIS_BATCH * TEST_NUM_MULTI, TEST_NUM_MULTI,
    DEV_VIS_BATCH, Z_DIV_INPUTS * NUM_MULTI}))
TEST_SHAPES = tuple(gen_sites(TEST_BATCH, "B"))
# phase 8's --fid_extractor call: the JAX package's save_extractor artifact
# of its width-64 proxy net (tests/fixtures/make_jax_export_fixtures.py),
# run by the port's StableHLO interpreter on the supervised checkpoint.
# Its features against the built-in extractor (the same weights, from
# fid_weights.npz) on the 150 test images, float32 with TF32 off; FID_B
# against that checkpoint's PROXY_FID_B; each extractor's images/s over
# FID_REPS passes of those images
FID_EXTRACTOR = ("tests", "fixtures", "jax_export",
                 "proxy_w64_64x64x3.jaxexp")
FID_FEATURE_RTOL = 1e-4  # of max |feature|
FID_RTOL = 1e-3
FID_REPS = 5

# phase 9: the step extras.  --grad_accum 4 at batch 32 runs both kernels
# at microbatches of 8 (the discriminators' fake|real pass at 16), at 64x64
# and at 256x256, the size accumulation exists for; at batch 128 in
# bfloat16 at 32 (64), shapes of the other phases
ACCUM_K = 4
EXTRAS_SHAPES = tuple(dict.fromkeys(
    s for hw in (64, 256)
    for s in sorted(accum_sites(32, ACCUM_K, hw=hw)["fwd"], reverse=True)))
# phase 9's fused bfloat16 step on 256x256 images at batch 32 (the JAX
# package's quality arm at the reference's default grid size): its sites
STEP256_BATCH = 32
STEP256_SHAPES = tuple(sorted(train_sites(STEP256_BATCH, hw=256),
                              reverse=True))
# the 256x256 generator sites (a request of 4, phase 9's microbatch of 8,
# the step at 32), whose slabs no cluster holds: K1's and K2's ring route
RING_SHAPES = ((4, 65536, 32),) + tuple(gen_sites(8, "B", hw=256)) + \
    tuple(gen_sites(STEP256_BATCH, "B", hw=256))

# phase 10: the per-file data path, the host feed, the Livneh ETL and
# upstream-checkpoint interop, at the published width in float32.  Sizes
# are cut in scale only:
# (a) a Livneh-shaped NetCDF-3 pair of 500 daily 64x64 rasters over one
#     land mask: 400 train days (100 of them dev: 10 steps of 32, the last
#     one backed off) and 100 test days, eval-A at batch 100;
# (b) 567 per-sample train files (100 of them dev): 14 steps of 32 and a
#     tail of 19 that is trained on, so that --profile_dir's window (steps
#     10-14) holds the tail; 230 test files: eval batches of 200 and a tail
#     of 30, which the UBO pads to 200;
# (c)-(g) the same set (and its npz bundles) for the feed's three ways, the
#     supervised set on the card, the upstream round trip and a paired-jpg
#     folder.
P10 = dict(batch=32, livneh_days=500, livneh_dev=100, n_train=567,
           n_test=230, dev_size=100, n_threads=4, jpg_dev=8,
           feed_turns=("npz", "prefetch", "sync"))
P10_EVAL, P10_UBO_STEPS, P10_TEST_VIS, P10_TEST_MULTI = 200, 50, 10, 5
P10_TAIL = (P10["n_train"] - P10["dev_size"]) % P10["batch"]
P10_EVAL_TAIL = P10["n_test"] % P10_EVAL
# the shapes phase 10 adds to the others': the tail step's and the eval
# tail's
P10_SHAPES = tuple(dict.fromkeys(
    tuple(sorted(train_sites(P10_TAIL), reverse=True))
    + tuple(gen_sites(P10_EVAL_TAIL, "B"))))
P10_PREDICT_ATOL = 1e-6  # predict_B after the upstream round trip

# phase 11: a run moved between packages, and the step over two ranks on
# the card (gloo: they share it), each on half the batch: the generators at
# N = 16 (float32 batch 32) and 64 (bfloat16 batch 128); the
# discriminators' passes land on shapes of the other phases
P11_RANKS, P11_STEPS = 2, 2
P11_JOBS = (  # (label, parallel/selfcheck.py job, dtype, batch, flags)
    ("aug_float32", "aug", "float32", 32, {}),
    ("aug_bfloat16", "aug", "bfloat16", 128, {}),
    ("norm_batch", "norm_batch", "float32", 32, {}),
    ("pool50", "pool", "float32", 32, {"pool_size": 50, "ema": 0.0}),
    ("batch_norm_pass", "batch_norm", "float32", 32, {}),
)
P11_SHAPES = tuple(dict.fromkeys(
    tuple(gen_sites(16, "B")) + tuple(gen_sites(64, "B"))))
P11_TIMEOUT = 600  # seconds a pair of ranks may take before it is killed
# (c)'s CLI ranks with cuDNN pinned: their latest, which (b)'s eval job
# loads, is then the same on every run (ROADMAP F5)
P11_CLI_MAIN = ("import runpy, torch; torch.backends.cudnn.deterministic = "
                "True; runpy.run_module('domain_transfer_gan_torch.cli.train'"
                ", run_name='__main__', alter_sys=True)")
# the feed's three ways: "sync" is the per-file run with the CLI's feed
# replaced by a pass-through, so that each step copies its host batch
# synchronously (train_instance on numpy arrays)
P10_FEED = {"npz": ["--numpy_data", "1", "--device_data", "1"],
            "prefetch": ["--numpy_data", "0", "--device_data", "0"],
            "sync": ["--numpy_data", "0", "--device_data", "0"]}


def synchronous_feed(train_cli):
    """A context that replaces ``train_cli``'s prefetching feed by a
    pass-through for its duration."""
    import contextlib

    @contextlib.contextmanager
    def swapped():
        feed = train_cli.prefetch_to_device
        train_cli.prefetch_to_device = lambda it, device, size=2: it
        try:
            yield
        finally:
            train_cli.prefetch_to_device = feed
    return swapped()


# every shape both kernels are checked at, in both dtypes: every site of the
# serving path, of a train step at batch 32 and at batch 128 (the
# discriminators' concatenated pass has N = 2 batch; the launch geometry
# differs with N), of the training CLI's evaluations and visuals, of phase
# 9's microbatches and 256x256 step, phase 10's tails, and edge shapes
CHECK_SHAPES = tuple(dict.fromkeys(
    PATH_SHAPES + tuple(s for b in sorted(set(TRAIN_BATCH.values()))
                        for s in train_sites(b))
    + tuple(s for n in CLI_BATCHES + TEST_CLI_BATCHES
            for s in gen_sites(n, "B"))
    + EXTRAS_SHAPES + P10_SHAPES + P11_SHAPES + STEP256_SHAPES
    + EDGE_SHAPES + (HW1_SHAPE,)))
BWD_SUM_RTOL = 1e-4  # dscale, dshift: fp32 sums of up to 65536 products


def log(*a):
    print(*a, flush=True)


# the kernels' variants (ops/kernels/instance_norm.py::VARIANTS)
VARIANTS = ("cluster", "ring", "streaming")


def _no_launches():
    return dict.fromkeys(VARIANTS, 0)


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
    and the fraction of elements that differ at all.  Both as 0-d tensors on
    the device: nothing is read back here."""
    diff = (y.float() - yp.float()).abs()
    ulp = _bf16_ulp(torch, torch.maximum(y.float().abs(), yp.float().abs()))
    return (((diff - FP32_ATOL).clamp_min(0) / ulp).max(),
            (diff > 0).float().mean())


def _read(torch, *scalars):
    """The values of 0-d device tensors as floats, in one copy to the host
    (the one synchronization of a check case)."""
    return torch.stack([s.float() for s in scalars]).tolist()


def _rel_err(a, b):
    """max |a - b| relative to max(1, max |b|), as a 0-d tensor."""
    return (a.float() - b.float()).abs().max() / \
        b.float().abs().max().clamp_min(1.0)


def _check_cases():
    for shape in CHECK_SHAPES:
        for dtype in ("float32", "bfloat16"):
            for unbiased in (False, True):
                for relu in (False, True):
                    for affine in ("none", "channel", "sample"):
                        yield shape, dtype, unbiased, relu, affine


def _on_chip_plan(K, shape, itemsize, arrays):
    """The cluster variant's plan for a shape (also where the wrapper picks
    the streaming one), or None where the cluster variant cannot run."""
    n, hw, c = shape
    try:
        return K.cluster_plan(n, hw, c, itemsize, arrays, K._sm_count(0),
                              on_chip=True)
    except ValueError:
        return None


def _ring_route(K, shape, itemsize, arrays):
    """The ring route's plan where the wrapper takes it (no cluster holds
    the slab, the rows are a multiple of 16 bytes and a ring fits), else
    None."""
    n, hw, c = shape
    plan = K.cluster_plan(n, hw, c, itemsize, arrays, K._sm_count(0))
    return plan if plan.variant == "ring" else None


def _picked_variant(K, shape, itemsize, arrays):
    n, hw, c = shape
    return K.cluster_plan(n, hw, c, itemsize, arrays,
                          K._sm_count(0)).variant


def _variants(K, shape, itemsize, arrays):
    """The plans a case is checked under: the cluster variant's wherever it
    can run, else the ring route's wherever that can, and the streaming
    one everywhere."""
    chip = _on_chip_plan(K, shape, itemsize, arrays) or \
        _ring_route(K, shape, itemsize, arrays)
    return ([chip] if chip is not None else []) + [K.STREAMING]


class _Worst:
    """Largest errors per variant, and the cases held per variant."""

    def __init__(self, *names):
        self.names = names
        self.cases = _no_launches()
        self.worst = {v: dict.fromkeys(names, 0.0) for v in self.cases}
        self.ring_repeats = 0  # ring launches repeated, bit for bit equal

    def add(self, variant, **errs):
        for k, e in errs.items():
            self.worst[variant][k] = max(self.worst[variant][k], e)

    def overall(self, name):
        return max(w[name] for w in self.worst.values())

    def summary(self):
        out = {v: dict(self.worst[v], cases=self.cases[v])
               for v in self.cases}
        out["ring"]["repeats_bit_equal"] = self.ring_repeats
        return out

    def repeat(self, torch, got, launch, what):
        """A second launch of the ring route, bit for bit the first."""
        again = launch()
        if not all(a is b or torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("two launches of the ring route differ "
                                 "for " + what)
        self.ring_repeats += 1


def check_kernel(torch, K):
    """Phase 3, forward.  The variants of the kernel against
    ``instance_norm_plain`` on the same inputs: the cluster variant at
    every case whose shape it takes, else the ring route where it can run
    (launched twice, bit for bit the same), the streaming variant at every
    case.
    float32 y, mean, rstd within FP32_ATOL; bfloat16 y within one bfloat16
    ulp.  Returns a ``_Worst`` (float32 |y| error, mean/rstd error,
    bfloat16 distance in ulps)."""
    worst = _Worst("y_float32", "stats", "y_bfloat16_ulps")
    t0 = time.perf_counter()
    for cases, (shape, name, unbiased, relu, affine) in enumerate(
            _check_cases()):
        dtype = getattr(torch, name)
        x, scale, shift = _make_inputs(torch, shape, dtype, affine,
                                       seed=cases)
        yp, meanp, rstdp = K.instance_norm_plain(
            x, scale, shift, eps=1e-5, unbiased=unbiased, relu=relu,
            return_stats=True)
        for plan in _variants(K, shape, x.element_size(), 1):
            def launch(plan=plan):
                return K._launch(x, scale, shift, 1e-5, unbiased, relu,
                                 plan=plan)
            y, mean, rstd = launch()
            what = "%r %s unbiased=%s relu=%s affine=%s, %r" % (
                shape, name, unbiased, relu, affine, plan)
            if plan.variant == "ring":
                worst.repeat(torch, (y, mean, rstd), launch, what)
            if y.shape != x.shape or y.dtype != x.dtype:
                raise AssertionError("bad output for " + what)
            finite, e_stats, e, over = _read(
                torch, torch.isfinite(y.float()).all(),
                torch.maximum((mean - meanp).abs().max(),
                              (rstd - rstdp).abs().max()),
                (y.float() - yp.float()).abs().max(),
                _bf16_ulps_apart(torch, y, yp)[0])
            if not finite:
                raise AssertionError("non-finite y for " + what)
            worst.cases[plan.variant] += 1
            worst.add(plan.variant, stats=e_stats)
            if e_stats > FP32_ATOL:
                raise AssertionError("mean/rstd differ by %g for %s"
                                     % (e_stats, what))
            if dtype == torch.float32:
                worst.add(plan.variant, y_float32=e)
                if e > FP32_ATOL:
                    raise AssertionError("y differs by %g for %s" % (e, what))
            else:
                # one bf16 rounding apart at most
                worst.add(plan.variant, y_bfloat16_ulps=over)
                if over > 1.0:
                    raise AssertionError("bf16 y is %.2f ulp off for %s"
                                         % (over, what))
    log("kernel check: %d cases at %d shapes in %.1f s, limits %.0e float32 "
        "and 1 bfloat16 ulp; per variant %s" % (
            cases + 1, len(CHECK_SHAPES), time.perf_counter() - t0,
            FP32_ATOL, json.dumps(worst.summary())))
    if worst.cases["streaming"] != cases + 1:
        raise AssertionError("the streaming variant was not held at every "
                             "case")
    return worst


def check_bwd_kernel(torch, K):
    """Phase 3, backward.  The variants' dx, dscale, dshift against
    ``instance_norm_bwd_plain`` on the same x, dy, mean, rstd, scale, shift,
    as ``check_kernel`` does for the forward.  float32 dx within FP32_ATOL
    relative to the largest |dx|; bfloat16 dx within one bfloat16 ulp; the
    float32 sums within BWD_SUM_RTOL of the largest |sum|.  Returns a
    ``_Worst`` (float32 |dx| error relative to the largest |dx|, at least 1;
    the sums' error; bfloat16 distance in ulps)."""
    worst = _Worst("dx_float32", "sums", "dx_bfloat16_ulps")
    t0 = time.perf_counter()
    for cases, (shape, name, unbiased, relu, affine) in enumerate(
            _check_cases()):
        dtype = getattr(torch, name)
        x, scale, shift = _make_inputs(torch, shape, dtype, affine,
                                       seed=1000 + cases)
        g = torch.Generator(device="cuda").manual_seed(cases)
        dy = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
        kw = dict(unbiased=unbiased, relu=relu)
        _, mean, rstd = K.instance_norm_plain(x, scale, shift,
                                              return_stats=True, **kw)
        dxp, dsp, dtp = K.instance_norm_bwd_plain(x, dy, mean, rstd, scale,
                                                  shift, **kw)
        for plan in _variants(K, shape, x.element_size(), 2):
            def launch(plan=plan):
                return K._launch_bwd(x, dy, mean, rstd, scale, shift,
                                     unbiased, relu, plan=plan)
            dx, ds, dt = launch()
            what = "%r %s unbiased=%s relu=%s affine=%s, %r" % (
                shape, name, unbiased, relu, affine, plan)
            if plan.variant == "ring":
                worst.repeat(torch, (dx, ds, dt), launch, what)
            if dx.shape != x.shape or dx.dtype != x.dtype:
                raise AssertionError("bad dx for " + what)
            if affine == "none":
                if ds is not None or dt is not None:
                    raise AssertionError("dscale without an affine for "
                                         + what)
                sums = []
            else:
                if ds.shape != dsp.shape or dt.shape != dtp.shape:
                    raise AssertionError("bad dscale/dshift for " + what)
                sums = [_rel_err(ds, dsp), _rel_err(dt, dtp)]
            finite, e, over, *e_sums = _read(
                torch, torch.isfinite(dx.float()).all(), _rel_err(dx, dxp),
                _bf16_ulps_apart(torch, dx, dxp)[0], *sums)
            if not finite:
                raise AssertionError("non-finite dx for " + what)
            worst.cases[plan.variant] += 1
            for sum_name, e_sum in zip(("dscale", "dshift"), e_sums):
                worst.add(plan.variant, sums=e_sum)
                if e_sum > BWD_SUM_RTOL:
                    raise AssertionError("%s differs by %g (relative) for %s"
                                         % (sum_name, e_sum, what))
            if dtype == torch.float32:
                worst.add(plan.variant, dx_float32=e)
                if e > FP32_ATOL:
                    raise AssertionError("dx differs by %g (relative) for %s"
                                         % (e, what))
            else:
                worst.add(plan.variant, dx_bfloat16_ulps=over)
                if over > 1.0:
                    raise AssertionError("bf16 dx is %.2f ulp off for %s"
                                         % (over, what))
    log("backward kernel check: %d cases at %d shapes in %.1f s, limits "
        "%.0e float32 dx (relative to max |dx|), %.0e dscale/dshift, 1 "
        "bfloat16 ulp; per variant %s" % (
            cases + 1, len(CHECK_SHAPES), time.perf_counter() - t0,
            FP32_ATOL, BWD_SUM_RTOL, json.dumps(worst.summary())))
    if worst.cases["streaming"] != cases + 1:
        raise AssertionError("the streaming variant was not held at every "
                             "case")
    return worst


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


def _n_buffers(nbytes):
    """Buffers to rotate over so that a launch never finds its input in the
    50 MB L2."""
    return max(2, -(-3 * 50 * 2 ** 20 // nbytes))


def _serving_cases():
    return [(shape, name) for shape in PATH_SHAPES + TIMED_EXTRA_SHAPES
            for name in ("float32", "bfloat16")]


def _train_cases():
    """(shape, dtype name) of the norm sites of one train step, in the dtype
    and at the batch the training path runs them."""
    return [(shape, name) for name, batch in TRAIN_BATCH.items()
            for shape in sorted(train_sites(batch), reverse=True)]


def _eval_cases():
    """The generator sites at the CLI's eval batch, float32 (phase 7)."""
    return [(shape, "float32") for shape in EVAL_SHAPES]


def _test_cases():
    """The generator sites at the evaluation CLI's batch, float32 (phase
    8)."""
    return [(shape, "float32") for shape in TEST_SHAPES]


def _extras_cases():
    """The sites of phase 9's --grad_accum steps at batch 32, float32 (the
    microbatches of 8, at 64x64 and at 256x256)."""
    return [(shape, "float32") for shape in EXTRAS_SHAPES]


def _phase10_cases():
    """The shapes phase 10 adds, float32: its per-file tail step at 19 (the
    discriminators' pass at 38) and its eval tail at 30."""
    return [(shape, "float32") for shape in P10_SHAPES]


def _phase11_cases():
    """The generator sites of a rank of phase 11: half the float32 batch of
    32 and half the bfloat16 batch of 128."""
    return ([(shape, "float32") for shape in gen_sites(16, "B")]
            + [(shape, "bfloat16") for shape in gen_sites(64, "B")])


def _ring_cases():
    """The 256x256 generator sites in both dtypes (the ring route's), and
    the sites of phase 9's bfloat16 step at 256x256 and batch 32."""
    return ([(shape, name) for shape in RING_SHAPES
             for name in ("float32", "bfloat16")]
            + [(shape, "bfloat16") for shape in STEP256_SHAPES])


def _timed_cases():
    serving = _serving_cases()
    return serving + [c for c in dict.fromkeys(
        _train_cases() + _eval_cases() + _test_cases() + _extras_cases()
        + _phase10_cases() + _phase11_cases() + _ring_cases())
        if c not in serving]


def _plan_row(plan, n):
    """A plan's fields; the ring route's are its ring's and its chunk."""
    p = plan.ring or plan
    return {"variant": plan.variant, "cluster": p.cluster, "rows": p.rows,
            "stages": p.stages, "threads": p.threads,
            "smem_bytes": p.smem_bytes,
            "stage_rows": plan.ring.stage_rows if plan.ring else 0,
            "chunk_rows": plan.chunk_rows, "ctas": n * p.cluster}


def _calls_for(nbytes):
    """Calls a timing graph captures: 20, fewer where each allocates an
    output of ``nbytes`` (x's size) and the plain versions' intermediates,
    so that a graph of the 256x256 sites stays within a few GB."""
    return max(3, min(20, int(2e9 // max(nbytes, 1))))


def _time_variants(torch, K, launch, shape, itemsize, arrays, sweep,
                   library=None, calls=20, others=True):
    """Device ms of ``launch(i, plan)`` under the cluster variant's plan
    (``cluster_ms``, where it can run), under the ring route's plan
    (``ring_ms``, where no cluster holds the slab and the route can run)
    and under the streaming plan (the kernels' first ports, ``streaming_ms``),
    timed one after the other (library, streaming, the other plan);
    ``library(i)`` (the library call's ``library_turns_ms``) where
    given; without ``others``, the variant the wrapper picks alone.
    ``kernel_ms`` is the time of the
    variant the wrapper picks (``variant``), ``plan`` the cluster variant's
    or the ring route's plan.  With ``sweep`` also under every cluster size
    that holds the slab."""
    n, hw, c = shape
    sm_count = K._sm_count(0)
    picked = _picked_variant(K, shape, itemsize, arrays)
    other = _on_chip_plan(K, shape, itemsize, arrays) or \
        _ring_route(K, shape, itemsize, arrays)

    def timed(p):
        if p == "library":
            return _time_device(torch, library, calls=calls)
        return _time_device(torch, lambda i: launch(i, p), calls=calls)

    out = {"variant": picked, "plan": _plan_row(other or K.STREAMING, n),
           "cluster_ms": None, "ring_ms": None}
    turns = [K.STREAMING] + ([other] if other is not None else [])
    if not others:
        turns = [K.STREAMING if picked == "streaming" else other]
    if library is not None:
        turns = ["library"] + turns
    times = {}
    for p in turns:
        key = "library" if p == "library" else p.variant
        times.setdefault(key, []).append(timed(p))
    for key, ts in times.items():
        out[("library_turns" if key == "library" else key) + "_ms"] = \
            sum(ts) / len(ts)
    out["kernel_ms"] = out[picked + "_ms"]
    if sweep:
        out["cluster_sweep_ms"] = {}
        for k in (1, 2, 4, 8, 16):
            try:
                p = K.cluster_plan(n, hw, c, itemsize, arrays, sm_count,
                                   cluster=k)
            except ValueError:
                continue
            out["cluster_sweep_ms"][str(k)] = timed(p)
    return out


def time_kernel(torch, F, K, site_counts, train_counts, cli_counts,
                variant_counts, bpp_counts, extra, extras_counts,
                p10_counts, p11_counts):
    """Phase 6, forward kernel, per path shape and dtype.  Per-channel
    affine, biased variance, fused ReLU: the case the library call covers
    too.  Times are device times (CUDA-graph replay).  Inputs rotate over
    enough buffers to exceed the 50 MB L2, so every launch reads x from
    device memory, as the bound assumes.  ``kernel_ms`` is the variant the
    wrapper picks (``variant``); ``plan`` says how the cluster variant ran.
    At the headline shape (every shape with ``extra``) ``cluster_ms`` and
    ``streaming_ms`` are the two variants, timed one after the other, and
    the plain version's and the library call's times stand beside them.  ``site_counts[dtype][request][shape]`` are the launches
    the serving path was seen to make, ``train_counts[dtype]["fwd"][shape]``
    those of one train step, ``cli_counts["fwd"][shape]`` those of the
    whole training CLI phase (float32), ``variant_counts["fwd"][shape]``
    those of phase 8 (float32), ``bpp_counts["fwd"][shape]`` those of its
    ``--metric bpp`` run (the rows at the evaluation CLI's batch),
    ``extras_counts[dtype]["fwd"][shape]`` those of phase 9,
    ``p10_counts["fwd"][shape]`` those of phase 10 (float32),
    ``p11_counts[dtype]["fwd"][shape]`` those of phase 11 (both ranks).
    With ``extra`` every
    row also has ``cluster_sweep_ms`` (the cluster variant at each cluster
    size that holds the slab), and the serving shapes gain:
    ``kernel_ms_l2_warm`` repeats on one buffer, which is closer to a norm
    that follows its conv; ``kernel_eager_ms`` includes the host's enqueue
    time; ``streaming_ms_wide_tile`` is the streaming variant without the
    tile narrowing of ``launch_geometry`` (an SM count of 0 switches it
    off)."""
    serving = _serving_cases()
    rows = []
    for shape, name in _timed_cases():
        n, hw, c = shape
        dtype = getattr(torch, name)
        itemsize = torch.finfo(dtype).bits // 8
        x_bytes = n * hw * c * itemsize
        # x read once, y written once; scale, shift read as (C,) and
        # mean, rstd written as (N, C), all float32
        nbytes = 2 * x_bytes + 2 * c * 4 + 2 * n * c * 4
        flops = 8 * n * hw * c
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        n_buf = _n_buffers(2 * x_bytes)
        bufs = [_make_inputs(torch, shape, dtype, "channel", seed=100 + i)
                for i in range(n_buf)]

        def launch(i, plan):
            x, s, b = bufs[i % n_buf]
            return K._launch(x, s, b, 1e-5, False, True, plan=plan)

        def plain(i):
            x, s, b = bufs[i % n_buf]
            return K.instance_norm_plain(x, s, b, eps=1e-5, relu=True)

        def library(i):
            # same memory: the NCHW view of the channels_last activation
            x, s, b = bufs[i % n_buf]
            return F.relu(F.instance_norm(
                x.permute(0, 3, 1, 2), weight=s.to(dtype),
                bias=b.to(dtype), eps=1e-5))

        calls = _calls_for(x_bytes)
        row = {"shape": list(shape), "dtype": name, "bytes": nbytes}
        full = extra or (shape, name) == HEADLINE  # the yardsticks too
        row.update(_time_variants(torch, K, launch, shape, itemsize, 1,
                                  sweep=extra, library=library if full
                                  else None, calls=calls, others=full))
        row.update({
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "plain_ms": _time_device(torch, plain, calls=calls) if full
            else None,
            "library_ms": row.get("library_turns_ms"),
            "launches_per_predict_B":
                site_counts[name]["predict_B"].get(shape, 0),
            "launches_per_predict_A":
                site_counts[name]["predict_A"].get(shape, 0),
            "launches_per_train_step":
                train_counts[name]["fwd"].get(shape, 0),
            "launches_training_cli": cli_counts["fwd"].get(shape, 0)
                if name == "float32" else 0,
            "launches_phase8": variant_counts["fwd"].get(shape, 0)
                if name == "float32" else 0,
            "launches_phase9": extras_counts[name]["fwd"].get(shape, 0),
            "launches_phase10": p10_counts["fwd"].get(shape, 0)
                if name == "float32" else 0,
            "launches_phase11": p11_counts[name]["fwd"].get(shape, 0),
        })
        if (shape, name) in _test_cases():
            row["launches_bpp_run"] = bpp_counts["fwd"].get(shape, 0)
        if extra and (shape, name) in serving:
            row["kernel_ms_l2_warm"] = _time_device(
                torch, lambda i: launch(0, None))
            row["kernel_eager_ms"] = _time_eager(
                torch, lambda i: launch(i, None))
            sm_count = K._sm_count
            K._sm_count = lambda index: 0
            try:
                row["streaming_ms_wide_tile"] = _time_device(
                    torch, lambda i: launch(i, K.STREAMING))
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


def time_bwd_kernel(torch, F, K, train_counts, cli_counts, variant_counts,
                    bpp_counts, extra, extras_counts, p10_counts,
                    p11_counts):
    """Phase 6, backward kernel, at the serving shapes in both dtypes (the
    bfloat16 batch-32 rows and the 256x256 request are on no training path:
    they complete the table), at every site of the training path in the
    dtype and batch that path runs them, and at the generator sites of the
    two CLIs' eval batches (the UBO's backward at 100 and 200).
    Per-channel affine, biased variance, fused ReLU.
    Device times by CUDA-graph replay over buffers that exceed the L2;
    ``kernel_ms``, ``streaming_ms``, ``plan`` and, with ``extra``,
    ``cluster_sweep_ms`` as for the forward.  ``bound_ms`` = (x and dy read
    once, dx written once, mean, rstd, dscale, dshift as (N, C) and scale,
    shift as (C,), float32) over the card's memory rate.  ``library_ms`` is
    the backward of ``F.relu(F.instance_norm(x, weight, bias))`` on the same
    channels_last memory (``torch.autograd.grad`` w.r.t. x, weight and
    bias): the time of a captured forward + backward less the time of the
    captured forward."""
    rows = []
    for shape, name in _timed_cases():
        n, hw, c = shape
        dtype = getattr(torch, name)
        itemsize = torch.finfo(dtype).bits // 8
        x_bytes = n * hw * c * itemsize
        nbytes = 3 * x_bytes + 2 * c * 4 + 4 * n * c * 4
        flops = 15 * n * hw * c
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        n_buf = _n_buffers(3 * x_bytes)
        kw = dict(unbiased=False, relu=True)
        bufs = []
        for i in range(n_buf):
            x, s, b = _make_inputs(torch, shape, dtype, "channel",
                                   seed=200 + i)
            dy = torch.randn_like(x)
            _, mean, rstd = K.instance_norm_plain(x, s, b, return_stats=True,
                                                  **kw)
            bufs.append((x, dy, mean, rstd, s, b))

        def launch(i, plan):
            return K._launch_bwd(*bufs[i % n_buf], False, True, plan=plan)

        def plain(i):
            return K.instance_norm_bwd_plain(*bufs[i % n_buf], **kw)

        def lib_leaves(i):
            x, dy, _, _, s, b = bufs[i % n_buf]
            return (x.permute(0, 3, 1, 2).detach().requires_grad_(True),
                    s.detach().to(dtype).requires_grad_(True),
                    b.detach().to(dtype).requires_grad_(True),
                    dy.permute(0, 3, 1, 2))

        def library_fwd(i):
            xl, sl, bl, _ = lib_leaves(i)
            return F.relu(F.instance_norm(xl, weight=sl, bias=bl, eps=1e-5))

        def library_fwd_bwd(i):
            xl, sl, bl, dyl = lib_leaves(i)
            y = F.relu(F.instance_norm(xl, weight=sl, bias=bl, eps=1e-5))
            return torch.autograd.grad(y, (xl, sl, bl), dyl)

        calls = _calls_for(x_bytes)
        row = {"shape": list(shape), "dtype": name, "bytes": nbytes}
        full = extra or (shape, name) == HEADLINE  # the yardsticks too
        row.update(_time_variants(torch, K, launch, shape, itemsize, 2,
                                  sweep=extra, library=library_fwd_bwd
                                  if full else None, calls=calls,
                                  others=full))
        lib_both = row.get("library_turns_ms")
        row.update({
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "plain_ms": _time_device(torch, plain, calls=calls) if full
            else None,
            "library_ms": lib_both - _time_device(
                torch, library_fwd, calls=calls) if full else None,
            "library_fwd_bwd_ms": lib_both,
            "launches_per_train_step":
                train_counts[name]["bwd"].get(shape, 0),
            "launches_training_cli": cli_counts["bwd"].get(shape, 0)
                if name == "float32" else 0,
            "launches_phase8": variant_counts["bwd"].get(shape, 0)
                if name == "float32" else 0,
            "launches_phase9": extras_counts[name]["bwd"].get(shape, 0),
            "launches_phase10": p10_counts["bwd"].get(shape, 0)
                if name == "float32" else 0,
            "launches_phase11": p11_counts[name]["bwd"].get(shape, 0),
        })
        if (shape, name) in _test_cases():
            row["launches_bpp_run"] = bpp_counts["bwd"].get(shape, 0)
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


class Serving:
    """A server on an export directory, running in a thread (context
    manager); ``load_s`` is what ``build_server`` took."""

    def __init__(self, out_dir):
        from domain_transfer_gan_torch.cli.serve import build_server

        self.out_dir = out_dir
        t = time.perf_counter()
        self.server = build_server(out_dir, port=0, device="cuda")
        self.load_s = time.perf_counter() - t
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


class Served(Serving):
    """A model exported by the port's ``export_model`` behind a running
    server."""

    def __init__(self, cfg, out_dir, batch):
        from domain_transfer_gan_torch.cli.export import export_model
        from domain_transfer_gan_torch.models import create_model

        model = create_model(cfg, testing=True, device="cuda")
        self.manifest = export_model(model, out_dir, batch=batch,
                                     device="cuda")
        super().__init__(out_dir)


def _check_images(y, n, hw, nc, what):
    if y.shape != (n, hw, hw, nc) or y.dtype != np.float32:
        raise AssertionError("%s: shape %r dtype %s" % (what, y.shape,
                                                        y.dtype))
    if not np.isfinite(y).all() or np.abs(y).max() > 1.0:
        raise AssertionError("%s: values not finite in [-1, 1]" % what)
    if np.abs(y).mean() < 1e-3:
        raise AssertionError("%s: output is ~0 everywhere" % what)


def drive_serving_path(torch, fused, fused_bwd, tmp):
    """Phase 4.  Returns (forward launches counted on the main path, the same
    per variant, launches per shape of the batch-32 requests, what the
    timing phases need).  The backward kernel must not launch, and every
    forward launch must take the cluster variant."""
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
    for wrapper in (fused, fused_bwd):
        wrapper.launches = 0
        wrapper.launches_by_shape = {}
        wrapper.launches_by_variant = _no_launches()
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
    # the main path ends here
    main_path_launches, bwd_launches = fused.launches, fused_bwd.launches
    by_variant = dict(fused.launches_by_variant)
    if bwd_launches:
        raise AssertionError("serving launched the backward kernel %d times"
                             % bwd_launches)
    if by_variant != dict(_no_launches(), cluster=main_path_launches):
        raise AssertionError("serving launched the forward kernel's variants "
                             "%r: every serving shape must take the cluster "
                             "one" % by_variant)

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
    log("serving path: launches per request %s, per variant %s"
        % (json.dumps(counts), json.dumps(by_variant)))
    log("serving path: launches per request and shape %s" % json.dumps(
        {name: {"%dx%dx%d" % k: v for k, v in sorted(per.items())}
         for name, per in counts_by_shape.items()}))
    log("serving path: max |served - plain-norm| %s" % json.dumps(errs))
    ctx = {"fp32_dir": fp32_dir, "bf16_dir": bf16_dir, "A": A, "B": B,
           "z": z, "batch": batch, "cfg": cfg}
    return main_path_launches, by_variant, site_counts, ctx


def serve_jax_exports(torch, K, P, ctx, smi):
    """Phase 4's JAX arm: each directory of ``JAX_SERVE`` behind
    ``cli/serve.py`` on the card, ``predict_B`` and ``predict_A`` on the
    fixture's inputs (``tests/fixtures/jax_serve_inputs.py``) against
    ``exp.call``'s committed outputs; no K1, K2, split or pad kernel may
    launch for these requests.  Logs and returns the figures; phase 6
    times the full-width directory beside the port's own artifact."""
    import importlib.util
    import os

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            *JAX_SERVE[:-1])
    root = os.path.join(fixtures, JAX_SERVE[-1])
    spec = importlib.util.spec_from_file_location(
        "jax_serve_inputs", os.path.join(fixtures, "jax_serve_inputs.py"))
    draw = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(draw)
    with open(os.path.join(root, "index.json")) as f:
        index = json.load(f)
    wrappers = ((K.instance_norm_fused, K.instance_norm_bwd_fused)
                + tuple(K.SPLIT_WRAPPERS) + tuple(P.WRAPPERS))
    before = [w.launches for w in wrappers]
    fig = {"card": smi, "max_abs_err": {}, "load_s": {}}
    for name in (JAX_SERVE_FULL,) + JAX_SERVE_TINY:
        d = os.path.join(root, name)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        x = draw.inputs(manifest, index[name]["seed"])
        with np.load(os.path.join(root, name + ".outputs.npz")) as f:
            want = {k: f[k] for k in f.files}
        with Serving(d) as srv:
            fig["load_s"][name] = srv.load_s
            got = {"predict_B": _post(srv.url + "/predict_B",
                                      {"A": x["A"], "z": x["z"]}),
                   "predict_A": _post(srv.url + "/predict_A", {"B": x["B"]})}
        for fn, y in got.items():
            what = "%s %s" % (name, fn)
            _check_images(y, manifest["batch"], manifest["grid_size"], 3,
                          what)
            d_abs = np.abs(y - want[fn])
            fig["max_abs_err"][what] = float(d_abs.max())
            if index[name]["serve_dtype"] == "bfloat16":
                fig["max_abs_err"][what + " mean"] = float(d_abs.mean())
                if d_abs.max() > BF16_MAX_ATOL or \
                        d_abs.mean() > BF16_MEAN_ATOL:
                    raise AssertionError(
                        "%s differs from exp.call by max %g mean %g (limits "
                        "%g, %g)" % (what, d_abs.max(), d_abs.mean(),
                                     BF16_MAX_ATOL, BF16_MEAN_ATOL))
            elif d_abs.max() > JAX_SERVE_ATOL:
                raise AssertionError("%s differs from exp.call by %g (limit "
                                     "%g)" % (what, d_abs.max(),
                                              JAX_SERVE_ATOL))
    launched = {w.__name__: w.launches - n for w, n in zip(wrappers, before)
                if w.launches != n}
    if launched:
        raise AssertionError("serving the JAX package's export launched %r"
                             % launched)
    log("serving path, the JAX package's export: %s" % json.dumps(fig))
    fig["dir"] = os.path.join(root, JAX_SERVE_FULL)
    return fig


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
            over, differ = _read(torch, *_bf16_ulps_apart(torch, out, want))
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


class _Counters:
    """The two wrappers' launch counters, read as differences."""

    def __init__(self, K):
        self.fwd, self.bwd = K.instance_norm_fused, K.instance_norm_bwd_fused

    def reset(self):
        for w in (self.fwd, self.bwd):
            w.launches = 0
            w.launches_by_shape = {}
            w.launches_by_variant = _no_launches()
        self.bwd.dy_copies = 0

    def variants(self):
        return {"fwd": dict(self.fwd.launches_by_variant),
                "bwd": dict(self.bwd.launches_by_variant)}

    def read(self):
        return {"fwd": dict(self.fwd.launches_by_shape),
                "bwd": dict(self.bwd.launches_by_shape),
                "dy_copies": self.bwd.dy_copies}

    @staticmethod
    def diff(after, before):
        out = {"dy_copies": after["dy_copies"] - before["dy_copies"]}
        for k in ("fwd", "bwd"):
            out[k] = {shape: v - before[k].get(shape, 0)
                      for shape, v in after[k].items()
                      if v != before[k].get(shape, 0)}
        return out


def _tally(K, seen, itemsize, expected):
    """Add the launches ``seen`` by direction and shape to ``expected``, per
    the variant ``cluster_plan`` picks for each shape."""
    for direction, arrays in (("fwd", 1), ("bwd", 2)):
        for shape, count in seen[direction].items():
            expected[direction][_picked_variant(K, shape, itemsize,
                                                arrays)] += count


def _held_counts(seen, want, what):
    for direction in ("fwd", "bwd"):
        got = {k: v for k, v in seen[direction].items() if v}
        if got != {k: v for k, v in want[direction].items() if v}:
            raise AssertionError("%s: %s launches by shape %r, expected %r"
                                 % (what, direction, sorted(got.items()),
                                    sorted(want[direction].items())))


def _floats(d):
    return {k: float(v) for k, v in d.items()}


def _held(got, want, rtol, what):
    for k, w in want.items():
        if not np.isfinite(got[k]):
            raise AssertionError("%s: %s is not finite" % (what, k))
        if abs(got[k] - w) > rtol * max(1.0, abs(w)):
            raise AssertionError("%s: %s = %r, expected %r within %g"
                                 % (what, k, got[k], w, rtol))
    return max(abs(got[k] - w) / max(1.0, abs(w)) for k, w in want.items())


def _snapshot(model):
    return {name: {k: v.detach().clone()
                   for k, v in net.state_dict().items()}
            for name, net in model.nets.items()}


def drive_training_path(torch, K, seed_offset=0, hold=True):
    """Phase 5.  Returns (forward and backward launches counted on the
    training path, per variant: every one must take the variant
    ``cluster_plan`` picks for its shape and dtype; launches of one step per
    dtype and direction and shape; the largest deviations seen).  ``seed_offset`` moves the seeds of the
    weights and of the inputs; with ``hold`` off the deviations from the
    twins are measured and returned but held to no limit (``--twin-seeds``:
    how the limits were chosen)."""
    from domain_transfer_gan_torch.config import TrainConfig
    from domain_transfer_gan_torch.models import create_model

    counters = _Counters(K)
    nlatent = TRAIN_CFG["nlatent"]

    slack = 1.0 if hold else float("inf")

    def model(**kw):
        cfg = dict(TRAIN_CFG, seed=TRAIN_CFG["seed"] + seed_offset, **kw)
        return create_model(TrainConfig(**cfg), testing=True, device="cuda")

    expected = {d: _no_launches() for d in ("fwd", "bwd")}

    def step(m, A, B, z, eps, plain_norm=False):
        before = counters.read()
        losses, visuals, gnorms = m.train_instance(A, B, z, eps,
                                                   plain_norm=plain_norm)
        torch.cuda.synchronize()
        for k, v in visuals.items():
            if tuple(v.shape) != A.shape or \
                    not bool(torch.isfinite(v.float()).all()):
                raise AssertionError("visual %s: shape %r or values"
                                     % (k, tuple(v.shape)))
        seen = counters.diff(counters.read(), before)
        _tally(K, seen, torch.finfo(m.dtype).bits // 8, expected)
        return _floats(losses), _floats(gnorms), seen

    def check_counts(seen, batch, what, n_blocks=3, instance=True):
        if instance:
            want = train_sites(batch, n_blocks)
        else:  # norm="batch": only the CIN generator's norms are left
            want = {(batch, 4096, 32): 4, (batch, 4096, 64): 4,
                    (batch, 1024, 128): 2 * (1 + 2 * n_blocks)}
        for direction in ("fwd", "bwd"):
            if seen[direction] != want:
                raise AssertionError(
                    "%s: %s launches by shape %r, expected %r"
                    % (what, direction, seen[direction], want))

    devs, step_counts = {}, {}

    def against_twin(name, batch, it, lf, gf, lp, gp):
        rl, rg = (TRAIN_STEP1_RTOL if it == 0 else TRAIN_STEP3_RTOL)[name]
        tag = "%s batch %d step %d, fused vs plain-norm twin" % (
            name, batch, it + 1)
        key = "%s_b%d_step%d_" % (name, batch, it + 1)
        devs[key + "losses"] = _held(lf, lp, rl * slack, tag)
        devs[key + "gnorms"] = _held(gf, gp, rg * slack, tag)

    counters.reset()  # the training path starts here

    # (a) float32, batch 32, 3 steps, against the plain-norm twin
    batch = TRAIN_BATCH["float32"]
    A, B, zs = train_inputs(batch, nlatent, seed=11 + seed_offset)
    fused, twin = model(), model()
    start = _snapshot(fused)
    for it, (z, eps) in enumerate(zs):
        lf, gf, seen = step(fused, A, B, z, eps)
        check_counts(seen, batch, "float32 step %d" % (it + 1))
        lp, gp, none = step(twin, A, B, z, eps, plain_norm=True)
        if none["fwd"] or none["bwd"]:
            raise AssertionError("the plain-norm twin launched a kernel")
        against_twin("float32", batch, it, lf, gf, lp, gp)
    step_counts["float32"] = seen
    end = _snapshot(fused)
    for name in end:
        params = [k for k in end[name] if "running_" not in k]
        if not any(bool((end[name][k] != start[name][k]).any())
                   for k in params):
            raise AssertionError("%s did not move in 3 steps" % name)
    for name in ("netE_B", "netD_z_B"):
        stats = [k for k in end[name] if "running_" in k]
        if not stats or not all(bool((end[name][k] != start[name][k]).any())
                                for k in stats):
            raise AssertionError("%s: running statistics did not move" % name)
    del fused, twin, start, end
    torch.cuda.empty_cache()

    # (b) batch 128: one float32 step and 3 steps with bfloat16 compute,
    # each against a plain-norm twin of its own dtype; the bfloat16 step 1
    # losses against the float32 ones only as a sanity check
    batch = TRAIN_BATCH["bfloat16"]
    A, B, zs = train_inputs(batch, nlatent, seed=12 + seed_offset)
    for name, n_steps in (("float32", 1), ("bfloat16", 3)):
        fused, twin = model(compute_dtype=name), model(compute_dtype=name)
        for it, (z, eps) in enumerate(zs[:n_steps]):
            lf, gf, seen = step(fused, A, B, z, eps)
            check_counts(seen, batch, "%s batch-%d step %d"
                         % (name, batch, it + 1))
            lp, gp, none = step(twin, A, B, z, eps, plain_norm=True)
            if none["fwd"] or none["bwd"]:
                raise AssertionError("the plain-norm twin launched a kernel")
            against_twin(name, batch, it, lf, gf, lp, gp)
            if it == 0 and name == "float32":
                l32 = lf
            elif it == 0:
                devs["bfloat16_b%d_step1_losses_vs_float32" % batch] = _held(
                    lf, l32, TRAIN_BF16_VS_FP32_RTOL * slack,
                    "bfloat16 step 1 vs float32")
        if any(p.dtype != torch.float32 for net in fused.nets.values()
               for p in net.parameters()):
            raise AssertionError("%s training cast a master parameter" % name)
        del fused, twin
        torch.cuda.empty_cache()
    step_counts["bfloat16"] = seen

    # (d) norm="batch" at a small depth: the branch runs on the card
    batch = TRAIN_BATCH["float32"]
    A, B, zs = train_inputs(batch, nlatent, seed=13 + seed_offset)
    bn = model(norm="batch", n_blocks=1)
    lb, gb, seen = step(bn, A, B, *zs[0])
    check_counts(seen, batch, "norm=batch step", n_blocks=1, instance=False)
    if not all(np.isfinite(v) for v in list(lb.values()) + list(gb.values())):
        raise AssertionError("norm=batch step is not finite: %r %r"
                             % (lb, gb))
    del bn
    torch.cuda.empty_cache()

    total = counters.read()  # the training path ends here
    variants = counters.variants()
    fwd, bwd = sum(total["fwd"].values()), sum(total["bwd"].values())
    if variants != expected:
        raise AssertionError("the training path launched the variants %r, "
                             "the plan picks %r" % (variants, expected))
    per_step = {d: {k: sum(v[k].values()) for k in ("fwd", "bwd")}
                for d, v in step_counts.items()}
    log("training path: launches per step %s, per variant on the whole path "
        "%s, dy copies on the whole path %d"
        % (json.dumps(per_step), json.dumps(variants), total["dy_copies"]))
    log("training path: launches per step and shape %s" % json.dumps(
        {d: {k: {"%dx%dx%d" % sh: c for sh, c in sorted(v[k].items())}
             for k in ("fwd", "bwd")} for d, v in step_counts.items()}))
    log("training path: largest relative deviations %s" % json.dumps(devs))
    return variants, step_counts, devs


CLI_WIDTH = dict(ngf=32, nef=32, ndf=64, n_blocks=3, nlatent=16)
CLI_ARTIFACTS = ("latest", "best_A", "best_B", "best_mse_A.txt",
                 "best_bpp_B.txt", "history_mse_A.npy", "history_ubo_B.npy",
                 "nets.txt", "opt.txt", "opt.json", "opt.pkl", "results.txt",
                 "results.json")
CLI_VIS = {"vis_cycle": 2, "train_vis_cycle": 1, "vis_multi": 1,
           "vis_inf": 1, "vis_pred_B": 1, "vis_latest": 3}
CLI_PRINT_EVERY = 3  # steps; the display fires at the epoch's 10th


def _cli_argv(root, ckpt, device, width, extra=()):
    """The training CLI at the published width: 2 epochs (the second one
    decays the lr), every cadence firing, the train set on the device."""
    argv = ["--dataroot", root, "--name", "cli", "--checkpoints_dir", ckpt,
            "--grid_size", "64", "--batchSize", str(TRAIN_BATCH["float32"]),
            "--niter", "1", "--niter_decay", "1", "--save_epoch_freq", "1",
            "--eval_A_freq", "1", "--eval_B_freq", "1",
            "--print_freq", str(CLI_PRINT_EVERY * TRAIN_BATCH["float32"]),
            "--display_freq", "320",
            "--dev_size", str(CLI_DATA["dev_size"]), "--device_data", "1",
            "--use_pallas", "1", "--init_scheme", "sane", "--seed", "2026",
            "--device", device, "--num_devices", "1"]
    for k, v in width.items():
        argv += ["--" + k, str(v)]
    return argv + list(extra)


def cli_expected(width, epochs, ubo=True):
    """Launches of the training CLI phase by (N, HW, C), forward and
    backward, from its structure: per epoch the train steps, eval_mse_A
    (netG_B_A, a short tail batch at its size) and the UBO (netG_A_B forward
    and backward per RMSprop step, every batch padded to 100), the dev UBO's
    first grid (netG_A_B at 25), and one
    display: generate_cycle at 25 (two passes through each generator), the
    multi grid (netG_A_B at 250) and the inference grid (netG_B_A at 10,
    netG_A_B at 250).  ``ubo=False``: a run with ``--eval_B_freq 0``."""
    ngf, nb, batch = width["ngf"], width["n_blocks"], TRAIN_BATCH["float32"]
    steps = (CLI_DATA["n_train"] - CLI_DATA["dev_size"]) // batch
    sizes = [min(EVAL_BATCH, n - lo) for n in (CLI_DATA["dev_size"],
                                               CLI_DATA["n_test"])
             for lo in range(0, n, EVAL_BATCH)]
    eval_batches = len(sizes)
    fwd, bwd = {}, {}

    def g(n, fn):
        return gen_sites(n, fn, ngf, nb)

    for d in (fwd, bwd):
        _add(d, train_sites(batch, nb, ngf, width["ndf"]), epochs * steps)
        _add(d, g(EVAL_BATCH, "B"), ubo * epochs * eval_batches * UBO_STEPS)
    for n in sizes:
        _add(fwd, g(n, "A"), epochs)
    _add(fwd, g(DEV_VIS_BATCH, "B"), epochs * (2 + ubo))
    _add(fwd, g(DEV_VIS_BATCH, "A"), epochs * 2)
    _add(fwd, g(DEV_VIS_BATCH * NUM_MULTI, "B"), epochs * 2)
    _add(fwd, g(NUM_MULTI, "A"), epochs)
    return {"fwd": fwd, "bwd": bwd, "steps_per_epoch": steps,
            "eval_batches": eval_batches}


def check_ubo_against_plain(torch, model, real_A, real_B,
                            pad_to=EVAL_BATCH, logvar_B=None):
    """The UBO of one eval batch on the card (``real_A``/``real_B``, padded
    to ``pad_to`` as the CLIs pad it, under ``logvar_B``), through the
    kernels and with every norm through its plain version, on the same
    seeded noise, read at step 1 and at step UBO_STEPS."""
    from domain_transfer_gan_torch.eval.metrics import variational_ubo

    gen = torch.Generator(device=model.device)
    gen.manual_seed(31)
    eps = torch.randn((UBO_STEPS, pad_to, model.opt.nlatent),
                      device=model.device, generator=gen)
    dequant = torch.rand((pad_to,) + real_B.shape[1:],
                         device=model.device, generator=gen) / 127.5
    got = {}
    for plain in (False, True):
        for steps in (1, UBO_STEPS):
            got[plain, steps] = variational_ubo(
                model, real_A, real_B, steps, pad_to=pad_to,
                logvar_B=logvar_B, dequant=dequant, eps=eps[:steps],
                plain_norm=plain)
    (ub1, kl1, _), (ubl, _, _) = got[False, 1], got[False, UBO_STEPS]
    (pub1, pkl1, _), (publ, _, _) = got[True, 1], got[True, UBO_STEPS]
    dev = {"ubo_step1": abs(ub1 - pub1) / abs(pub1),
           "kld_step1": abs(kl1 - pkl1) / max(1.0, abs(pkl1)),
           "ubo_last": abs(ubl - publ) / abs(publ)}
    if not all(np.isfinite(v) for v in (ub1, kl1, ubl)):
        raise AssertionError("UBO not finite: %r" % ((ub1, kl1, ubl),))
    if dev["ubo_step1"] > UBO_STEP1_RTOL or dev["kld_step1"] > UBO_STEP1_RTOL:
        raise AssertionError("first UBO step, kernels vs plain norms: %r "
                             "(limit %g)" % (dev, UBO_STEP1_RTOL))
    if dev["ubo_last"] > UBO_LAST_RTOL:
        raise AssertionError("UBO step %d, kernels vs plain norms: %r "
                             "(limit %g)" % (UBO_STEPS, dev, UBO_LAST_RTOL))
    ubo_vals = {"step1": ub1, "step%d" % UBO_STEPS: ubl,
                "rows": len(real_A), "padded_to": pad_to}
    return dev, ubo_vals


def _log_figures(log):
    """Throughput windows and eval times as the CLI printed them."""
    import re
    ips = [float(v) for v in re.findall(r"throughput: ([\d.]+) images/sec",
                                        log)]
    evals = {k: [float(t) for t in re.findall(
        r"\] %s: [\d.]+, TEST_%s: [\d.]+, TIME: ([\d.]+)" % (k, k[4:]), log)]
        for k in ("DEV_MSE_A", "DEV_BPP_B")}
    return ips, evals


def drive_training_cli(torch, K, tmp, device="cuda", width=CLI_WIDTH):
    """Phase 7: the training CLI on the card, then export and serve from its
    checkpoint.  Returns (launches of the CLI run by direction and shape,
    the same by variant, launches of the served request, the figures)."""
    import os
    import re
    import statistics

    from domain_transfer_gan_torch.cli.export import main as export_main
    from domain_transfer_gan_torch.cli.serve import build_server
    from domain_transfer_gan_torch.cli.train import train_model
    from domain_transfer_gan_torch.config import \
        load_train_config_from_expr_dir
    from domain_transfer_gan_torch.data import AlignedIterator, \
        load_numpy_data
    from domain_transfer_gan_torch.data.synthetic import \
        write_synthetic_dataset
    from domain_transfer_gan_torch.models import create_model
    from domain_transfer_gan_torch.utils import checkpoint

    root, ckpt = tmp + "/cli_data", tmp + "/cli_runs"
    write_synthetic_dataset(root, n_train=CLI_DATA["n_train"],
                            n_test=CLI_DATA["n_test"], size=64)
    epochs = CLI_EPOCHS + CLI_RESUMED_EPOCHS
    want = cli_expected(width, epochs)
    counters = _Counters(K)
    counters.reset()  # the training CLI's path starts here
    t0 = time.perf_counter()
    first = train_model(argv=_cli_argv(root, ckpt, device, width))
    t1 = time.perf_counter()
    second = train_model(argv=_cli_argv(
        root, ckpt, device, width,
        ["--continue_train", "--niter_decay", "2"]))
    if device == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    seen, variants = counters.read(), counters.variants()  # ends here

    for direction in ("fwd", "bwd"):
        if seen[direction] != want[direction]:
            raise AssertionError(
                "training CLI: %s launches by shape %r, expected %r" % (
                    direction, sorted(seen[direction].items()),
                    sorted(want[direction].items())))
    expected = {d: _no_launches() for d in ("fwd", "bwd")}
    _tally(K, seen, 4, expected)
    if variants != expected:
        raise AssertionError("training CLI launched the variants %r, the "
                             "plan picks %r" % (variants, expected))

    # artifacts
    expr = os.path.join(ckpt, "cli")
    for f in CLI_ARTIFACTS:
        if not os.path.exists(os.path.join(expr, f)):
            raise AssertionError("training CLI: %s missing" % f)
    pngs = {}
    for d, at_least in CLI_VIS.items():
        files = [f for f in os.listdir(os.path.join(expr, d))
                 if f.endswith(".png")]
        pngs[d] = len(files)
        if len(files) < at_least or not all(
                os.path.getsize(os.path.join(expr, d, f)) > 0
                for f in files):
            raise AssertionError("training CLI: %s holds %r" % (d, files))

    # the log: finite losses, the resume, the lr schedule
    with open(os.path.join(expr, "results.txt")) as f:
        log_text = f.read()
    lines = log_text.splitlines()
    loss_lines = [i for i, ln in enumerate(lines) if ln.startswith("(epoch:")]
    steps = want["steps_per_epoch"]
    run_steps = (CLI_EPOCHS * steps, CLI_RESUMED_EPOCHS * steps)
    if len(loss_lines) != sum(n // CLI_PRINT_EVERY for n in run_steps):
        raise AssertionError("training CLI: %d loss lines" % len(loss_lines))
    for i in loss_lines:
        for ln in lines[i:i + 2]:  # the losses and the gnorms under them
            vals = re.findall(r"\w+: (\S+) ", ln.split(") ", 1)[-1])
            if len(vals) < 10 or not all(np.isfinite(float(v))
                                         for v in vals):
                raise AssertionError("training CLI: %r" % ln)
    m = re.search(r"resumed from \S+latest \(epoch (\d+), step (\d+)\)",
                  log_text)
    if not m or (int(m.group(1)), int(m.group(2))) != (
            CLI_EPOCHS, CLI_EPOCHS * steps):
        raise AssertionError("training CLI: no resume line for epoch %d"
                             % CLI_EPOCHS)
    lr = 2e-4
    if (first.epoch, first.state.step) != (CLI_EPOCHS, CLI_EPOCHS * steps) \
            or (second.epoch, second.state.step) != (epochs, epochs * steps) \
            or "(epoch: %d, iters:" % epochs not in log_text \
            or abs(first.old_lr) > 1e-12 \
            or abs(second.old_lr - (lr - lr / 2)) > 1e-12:
        raise AssertionError(
            "training CLI: epochs %d/%d, steps %d/%d, lr %r/%r" % (
                first.epoch, second.epoch, first.state.step,
                second.state.step, first.old_lr, second.old_lr))

    # the checkpoint round trip, bit for bit
    latest = os.path.join(expr, "latest")
    opt = load_train_config_from_expr_dir(expr)
    loaded = create_model(opt, testing=True, device=device)
    loaded.load(latest)
    for name, net in second.nets.items():
        mine = loaded.nets[name].state_dict()
        for k, v in net.state_dict().items():
            if not torch.equal(mine[k], v):
                raise AssertionError("checkpoint: %s.%s differs" % (name, k))
        a, b = second.state.opt_state[name], loaded.state.opt_state[name]
        if a.count != b.count or not all(
                torch.equal(x, y) for x, y in zip(a.mu + a.nu, b.mu + b.nu)):
            raise AssertionError("checkpoint: Adam state of %s" % name)
    payload = checkpoint.read_checkpoint(latest)
    if (loaded.state.step, loaded.epoch) != (second.state.step,
                                             second.epoch) \
            or loaded.old_lr != payload["old_lr"] \
            or abs(loaded.old_lr - (second.old_lr + lr / 2)) > 1e-12:
        raise AssertionError("checkpoint: step/epoch/lr %r vs %r" % (
            (loaded.state.step, loaded.epoch, loaded.old_lr),
            (second.state.step, second.epoch, second.old_lr)))

    # the UBO from the checkpoint, kernels vs plain norms, on the test set's
    # tail batch (padded to the eval batch)
    *_, testA, testB = load_numpy_data(root, grid_size=64,
                                       dev_size=CLI_DATA["dev_size"])
    *_, tail = AlignedIterator(testA, testB, batch_size=EVAL_BATCH)
    ubo_dev, ubo_vals = check_ubo_against_plain(torch, loaded, tail["A"],
                                                tail["B"])

    # what a save of 'latest' costs: the copy to the host the loop waits
    # for, and the whole write on the writer thread
    t = time.perf_counter()
    writer = checkpoint.AsyncCheckpointer()
    writer.save(tmp + "/timed_latest", second._ckpt_payload())
    save_call_s = time.perf_counter() - t
    writer.wait()
    save_total_s = time.perf_counter() - t
    writer.close()

    # export from the checkpoint, serve, one predict_B request
    out = tmp + "/cli_export"
    export_main(["--chk_path", latest, "--out", out, "--device", device])
    rng = np.random.RandomState(5)
    A = rng.uniform(-1, 1, (32, 64, 64, 3)).astype(np.float32)
    z = rng.randn(32, width["nlatent"]).astype(np.float32)
    want_B = loaded.predict_B(A, z).cpu().numpy()
    server = build_server(out, port=0, device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    counters.reset()  # the served request starts here
    try:
        got_B = _post("http://127.0.0.1:%d/predict_B"
                      % server.server_address[1], {"A": A, "z": z})
    finally:
        served = counters.read()  # and ends here
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("the server thread did not stop")
    _check_images(got_B, 32, 64, 3, "served predict_B")
    export_err = float(np.abs(got_B - want_B).max())
    if export_err > EXPORT_ATOL:
        raise AssertionError("exported predict_B is %g from the loaded "
                             "checkpoint's (limit %g)"
                             % (export_err, EXPORT_ATOL))
    if served["fwd"] != gen_sites(32, "B", width["ngf"], width["n_blocks"]) \
            or served["bwd"]:
        raise AssertionError("served request launched %r" % served)

    ips, evals = _log_figures(log_text)
    # steady windows: not a run's first (its set-up), and no epoch end (the
    # evals, the save) or display inside
    steady, k = [], 0
    for n in run_steps:
        for p in range(CLI_PRINT_EVERY, n + 1, CLI_PRINT_EVERY):
            if p > CLI_PRINT_EVERY and \
                    (p - 1) // steps == (p - CLI_PRINT_EVERY) // steps:
                steady.append(ips[k])
            k += 1
    per_batch = want["eval_batches"]
    figures = {
        "train_images_per_s_windows": ips,
        "train_images_per_s_steady": steady,
        "train_images_per_s_steady_median": statistics.median(steady)
        if steady else None,
        "eval_A_s_per_batch": [t / per_batch for t in evals["DEV_MSE_A"]],
        "eval_B_s_per_batch": [t / per_batch for t in evals["DEV_BPP_B"]],
        "save_latest_call_s": save_call_s,
        "save_latest_total_s": save_total_s,
        "run_s": t1 - t0, "resumed_run_s": t2 - t1,
        "ubo_kernels_vs_plain": ubo_dev,
        "ubo_tail_batch": ubo_vals,
        "export_max_abs_err": export_err,
        "pngs": pngs,
    }
    log("training CLI: launches by direction and shape %s, per variant "
           "%s; the served request %s" % (
               json.dumps({d: {"%dx%dx%d" % sh: c for sh, c in
                               sorted(seen[d].items())}
                           for d in ("fwd", "bwd")}),
               json.dumps(variants),
               json.dumps({"%dx%dx%d" % sh: c for sh, c in
                           sorted(served["fwd"].items())})))
    log("training CLI: %s" % json.dumps(figures))
    return seen, variants, served, figures


def sup_sites(batch, n_blocks=3, ngf=32):
    """Launches per supervised step by (N, HW, C), the same for the forward
    and the backward kernel: one pass through each generator (the encoder
    and the latent discriminator have batch norms only)."""
    sites = dict(gen_sites(batch, "B", ngf, n_blocks))
    for shape, k in gen_sites(batch, "A", ngf, n_blocks).items():
        sites[shape] = sites.get(shape, 0) + k
    return sites


# phase 8 (a): (model, compute dtype, batch, steps, step) against the
# plain-norm twins, with phase 5's limits
VARIANT_STEPS = (("stoch_cycle_gan", "float32", 32, 2, "main"),
                 ("stoch_cycle_gan", "bfloat16", 128, 1, "main"),
                 ("cycle_gan", "float32", 32, 1, "main"),
                 ("aug_cycle_gan", "float32", 32, 2, "sup"))


def drive_variant_steps(torch, K):
    """Phase 8 (a): the stoch_cycle_gan and cycle_gan steps and the
    supervised step at full width, each against a twin with the same weights
    whose norms run the plain version, its launches per step held to the
    step's structure (the two-phase steps: the sites of the aug_cycle_gan
    step, whose encoder and latent discriminator have batch norms only; the
    supervised step: one pass through each generator).  Returns (launches
    by direction and shape, the same per variant, launches per step by
    case, the largest deviations)."""
    from domain_transfer_gan_torch.config import TrainConfig
    from domain_transfer_gan_torch.models import create_model

    counters = _Counters(K)
    expected = {d: _no_launches() for d in ("fwd", "bwd")}
    nlatent = TRAIN_CFG["nlatent"]
    devs, per_step = {}, {}
    counters.reset()  # phase 8's steps start here
    for i, (name, dtype, batch, n_steps, kind) in enumerate(VARIANT_STEPS):
        cfg = dict(TRAIN_CFG, model=name, compute_dtype=dtype)
        fused, twin = (create_model(TrainConfig(**cfg), testing=True,
                                    device="cuda") for _ in range(2))
        A, B, zs = train_inputs(batch, nlatent, seed=21 + i)
        width = (TRAIN_CFG["n_blocks"], TRAIN_CFG["ngf"])
        if kind == "sup":
            want_sites = sup_sites(batch, *width)

            def call(m, z, eps, plain):
                out = m.supervised_train_instance(A, B, z, eps,
                                                  plain_norm=plain)
                return ({k: v for k, v in out.items() if "gnorm" not in k},
                        {k: v for k, v in out.items() if "gnorm" in k})
        else:
            want_sites = train_sites(batch, *width, TRAIN_CFG["ndf"])

            def call(m, z, eps, plain):
                losses, visuals, gnorms = m.train_instance(A, B, z,
                                                           plain_norm=plain)
                for k, v in visuals.items():
                    if tuple(v.shape) != A.shape or \
                            not bool(torch.isfinite(v.float()).all()):
                        raise AssertionError("%s visual %s" % (name, k))
                return losses, gnorms
        tag = "%s%s %s b%d" % (name, " supervised" * (kind == "sup"), dtype,
                               batch)
        for it, (z, eps) in enumerate(zs[:n_steps]):
            before = counters.read()
            lf, gf = (_floats(d) for d in call(fused, z, eps, False))
            seen = counters.diff(counters.read(), before)
            _held_counts(seen, {"fwd": want_sites, "bwd": want_sites},
                         "%s step %d" % (tag, it + 1))
            _tally(K, seen, torch.finfo(fused.dtype).bits // 8, expected)
            before = counters.read()
            lp, gp = (_floats(d) for d in call(twin, z, eps, True))
            none = counters.diff(counters.read(), before)
            if none["fwd"] or none["bwd"]:
                raise AssertionError("the plain-norm twin launched a kernel")
            rl, rg = (TRAIN_STEP1_RTOL if it == 0 else TRAIN_STEP3_RTOL)[dtype]
            what = "%s step %d, fused vs plain-norm twin" % (tag, it + 1)
            key = tag.replace(" ", "_") + "_step%d_" % (it + 1)
            devs[key + "losses"] = _held(lf, lp, rl, what)
            devs[key + "gnorms"] = _held(gf, gp, rg, what)
        per_step[tag] = {d: sum(seen[d].values()) for d in ("fwd", "bwd")}
        if kind == "sup" and fused.state.step != 0:
            raise AssertionError("the supervised step advanced state.step")
        del fused, twin
        torch.cuda.empty_cache()
    total, variants = counters.read(), counters.variants()  # and end here
    if variants != expected:
        raise AssertionError("phase 8 steps launched the variants %r, the "
                             "plan picks %r" % (variants, expected))
    log("variant steps: launches per step %s, per variant %s"
        % (json.dumps(per_step), json.dumps(variants)))
    log("variant steps: largest relative deviations %s" % json.dumps(devs))
    return total, variants, per_step, devs


# phase 8 (b): one epoch each through the training CLI
VARIANT_RUNS = {"stoch": ["--model", "stoch_cycle_gan"],
                "cycle": ["--model", "cycle_gan"],
                "sup": ["--model", "aug_cycle_gan", "--supervised"]}


def variant_cli_expected(name, width):
    """Launches of one epoch of a phase-8 training CLI run by (N, HW, C),
    from its structure: the train steps (and as many supervised steps at
    the same batch: the supervised set is 32 images, one batch), eval-A (a
    dev batch of 100, test batches of 100 and 50), eval-B (the UBO's
    forward and backward per RMSprop step, 50 steps, 1 for cycle_gan, whose
    z = 1 takes the generator out of the gradient: no backward), the dev
    UBO's first grid, and one display (generate_cycle at 25, the multi grid
    at 250 and, for aug_cycle_gan, the inference grid)."""
    ngf, nb, batch = width["ngf"], width["n_blocks"], TRAIN_BATCH["float32"]
    steps = (CLI_DATA["n_train"] - CLI_DATA["dev_size"]) // batch
    ubo_steps = 1 if name == "cycle" else UBO_STEPS
    fwd, bwd = {}, {}

    def g(n, fn):
        return gen_sites(n, fn, ngf, nb)

    for d in (fwd, bwd):
        _add(d, train_sites(batch, nb, ngf, width["ndf"]), steps)
        if name == "sup":
            _add(d, sup_sites(batch, nb, ngf), steps)
    for d in ((fwd, bwd) if name != "cycle" else (fwd,)):
        _add(d, g(EVAL_BATCH, "B"), 3 * ubo_steps)
    for n in (EVAL_BATCH, EVAL_BATCH, CLI_EVAL_TAIL):
        _add(fwd, g(n, "A"))
    _add(fwd, g(DEV_VIS_BATCH, "B"), 3)
    _add(fwd, g(DEV_VIS_BATCH, "A"), 2)
    _add(fwd, g(DEV_VIS_BATCH * NUM_MULTI, "B"))
    if name == "sup":
        _add(fwd, g(NUM_MULTI, "A"))
        _add(fwd, g(DEV_VIS_BATCH * NUM_MULTI, "B"))
    return {"fwd": fwd, "bwd": bwd}


def test_cli_expected(name, metric, width):
    """Launches of one evaluation-CLI call by (N, HW, C), from its
    structure (forward unless said): bpp fits logvar_B on the train subset
    (both generators at 64), then 500 UBO steps on the test set padded to
    200 (forward and backward each), the verbose line's decode every 100
    steps (at 200) and the grids at 0 and every 100 steps (at 25); mse runs
    netG_B_A on the dev batch (100) and the test batch (150); visual
    generate_cycle at 10, the multi grid (50), the cycle_B_multi grid (10,
    50), 4 multi-cycle steps (10) and, for aug_cycle_gan, the inference
    grid (5, 50); noise_sens 8 noisy cycles at 150; fid one decode at 150;
    z_div one decode of 32 x 10."""
    ngf, nb = width["ngf"], width["n_blocks"]
    fwd, bwd = {}, {}

    def g(n, fn):
        return gen_sites(n, fn, ngf, nb)

    n_test = CLI_DATA["n_test"]
    if metric == "bpp":
        _add(fwd, g(TEST_SUBSET, "A"))
        _add(fwd, g(TEST_SUBSET, "B"))
        _add(fwd, g(TEST_BATCH, "B"), BPP_STEPS + BPP_STEPS // 100)
        _add(bwd, g(TEST_BATCH, "B"), BPP_STEPS)
        _add(fwd, g(DEV_VIS_BATCH, "B"), 1 + BPP_STEPS // 100)
    elif metric == "mse":
        _add(fwd, g(CLI_DATA["dev_size"], "A"))
        _add(fwd, g(n_test, "A"))
    elif metric == "visual":
        v, m = TEST_VIS_BATCH, TEST_VIS_BATCH * TEST_NUM_MULTI
        _add(fwd, g(v, "B"), 2 + 4)
        _add(fwd, g(v, "A"), 2 + 1 + 4)
        _add(fwd, g(m, "B"), 2)
        if name == "sup":
            _add(fwd, g(TEST_NUM_MULTI, "A"))
            _add(fwd, g(m, "B"))
    elif metric == "noise_sens":
        _add(fwd, g(n_test, "A"), 8)
        _add(fwd, g(n_test, "B"), 8)
    elif metric == "fid":
        _add(fwd, g(n_test, "B"))
    elif metric == "z_div":
        _add(fwd, g(Z_DIV_INPUTS * NUM_MULTI, "B"))
    return {"fwd": fwd, "bwd": bwd}


TEST_METRICS = ("mse", "visual", "noise_sens", "mvgauss", "fid", "z_div")
TEST_FILES = {"visual": ("cycle_0.png", "multi_0.png", "cycle_B_multi_0.png",
                         "multi_cycle_0.png"),
              "noise_sens": ("noise_sens.npy",),
              "mvgauss": ("mvgauss_bpp.txt",), "fid": ("fid.txt",),
              "z_div": ("z_diversity.json",)}


def check_fid_extractor(torch, images, device, proxy_fid, fid_b, smi,
                        launches):
    """The interpreted --fid_extractor artifact against the built-in
    extractor on ``images``, FID_B against PROXY_FID_B, and both
    extractors' load time and images/s; logs them on a line of their
    own, with the CLI call's kernel ``launches``, and returns them."""
    import os

    from domain_transfer_gan_torch.eval import fid

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        *FID_EXTRACTOR)
    t = time.perf_counter()
    ext = fid.load_extractor(path, device=device)
    load_s = time.perf_counter() - t
    builtin = fid.random_feature_extractor(device=device)
    x = torch.from_numpy(images).to(device)
    got, want = ext(x), builtin(x)
    fig = {"card": smi, "images": len(images), "load_s": load_s,
           "feature_max_abs_err": float(np.abs(got - want).max()),
           "feature_max_abs": float(np.abs(want).max()),
           "FID_B": fid_b, "PROXY_FID_B": proxy_fid,
           "fid_rel_err": abs(fid_b - proxy_fid) / abs(proxy_fid),
           "cli_launches": launches}
    for name, fn in (("interpreted", ext), ("builtin", builtin)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(FID_REPS):
            fn(x)
        torch.cuda.synchronize()
        fig[name + "_images_per_s"] = FID_REPS * len(images) / (
            time.perf_counter() - t)
    log("fid_extractor: %s" % json.dumps(fig))
    if not fig["feature_max_abs_err"] <= \
            FID_FEATURE_RTOL * fig["feature_max_abs"]:
        raise AssertionError("--fid_extractor features vs the built-in "
                             "extractor's: %r" % fig)
    if not fig["fid_rel_err"] <= FID_RTOL:
        raise AssertionError("FID_B vs PROXY_FID_B: %r" % fig)
    return fig


def drive_variants_cli(torch, K, tmp, device="cuda", width=CLI_WIDTH,
                       smi=""):
    """Phase 8 (b) and (c): one epoch each of stoch_cycle_gan, cycle_gan and
    aug_cycle_gan --supervised through the training CLI on the phase-7 data
    set (eval-A, eval-B and latest every epoch), an export of the
    stoch_cycle_gan checkpoint and one served predict_B, then the
    evaluation CLI on the three checkpoints: every --metric on the
    supervised one (bpp with --train_logvar 1), all but bpp on the other
    two, and --metric fid --fid_extractor (the JAX package's proxy net as a
    jax.export artifact) on the supervised one.  Launches are read around
    each run and held to its structure; TEST_MSE_A is held to eval_mse_A
    of the checkpoint over the same batch of 150, the extractor's
    features and FID_B to the built-in extractor's; after the runs, the first bpp chunk (the test set padded to 200)
    through the kernels against the same with plain norms on the same
    noise.  Returns (launches by direction and shape of all of it, the same
    by variant, those of the bpp run by direction and shape, the
    figures)."""
    import os
    import re

    from domain_transfer_gan_torch.cli import test as test_cli
    from domain_transfer_gan_torch.cli.export import main as export_main
    from domain_transfer_gan_torch.cli.serve import build_server
    from domain_transfer_gan_torch.cli.train import train_model
    from domain_transfer_gan_torch.config import \
        load_train_config_from_expr_dir
    from domain_transfer_gan_torch.data import AlignedIterator, \
        UnalignedIterator, load_numpy_data
    from domain_transfer_gan_torch.eval import eval_mse_A, train_logvar
    from domain_transfer_gan_torch.models import create_model
    from domain_transfer_gan_torch.ops.kernels import pad as P

    root, ckpt = tmp + "/cli_data", tmp + "/variant_runs"
    counters = _Counters(K)
    total = {"fwd": {}, "bwd": {}}
    expected = {d: _no_launches() for d in ("fwd", "bwd")}
    variants = {d: _no_launches() for d in ("fwd", "bwd")}
    figures = {"train_s": {}, "metric_s": {}}
    runs = {}

    def counted(what, want, fn):
        counters.reset()  # each run of phase 8 starts here
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        seen, by_variant = counters.read(), counters.variants()  # ends here
        _held_counts(seen, want, what)
        _tally(K, seen, 4, expected)
        runs[what] = seen
        for d in ("fwd", "bwd"):
            _add(total[d], seen[d])
            for v, c in by_variant[d].items():
                variants[d][v] += c
        return out, dt

    steps = (CLI_DATA["n_train"] - CLI_DATA["dev_size"]) // \
        TRAIN_BATCH["float32"]
    for name, flags in VARIANT_RUNS.items():
        argv = _cli_argv(root, ckpt, device, width,
                         ["--name", name, "--niter_decay", "0",
                          "--check_numerics", "1"] + flags)
        model, figures["train_s"][name] = counted(
            "training CLI " + name, variant_cli_expected(name, width),
            lambda: train_model(argv=argv))
        expr = os.path.join(ckpt, name)
        for f in CLI_ARTIFACTS:
            if not os.path.exists(os.path.join(expr, f)):
                raise AssertionError("training CLI %s: %s missing"
                                     % (name, f))
        if os.path.isdir(os.path.join(expr, "vis_inf")) != (name == "sup"):
            raise AssertionError("training CLI %s: vis_inf" % name)
        with open(os.path.join(expr, "results.txt")) as f:
            lines = f.read().splitlines()
        loss_lines = [i for i, ln in enumerate(lines)
                      if ln.startswith("(epoch:")]
        if len(loss_lines) != steps // CLI_PRINT_EVERY:
            raise AssertionError("training CLI %s: %d loss lines"
                                 % (name, len(loss_lines)))
        n_keys = (13, 8, 10) if name == "sup" else (10, 4)
        for i in loss_lines:
            for ln, n in zip(lines[i:i + len(n_keys)], n_keys):
                vals = re.findall(r"\w+: (\S+) ", ln.split(") ", 1)[-1])
                if len(vals) != n or not all(np.isfinite(float(v))
                                             for v in vals):
                    raise AssertionError("training CLI %s: %r" % (name, ln))
        if (model.epoch, model.state.step) != (1, steps):
            raise AssertionError("training CLI %s: epoch %d step %d"
                                 % (name, model.epoch, model.state.step))

    # export the stoch_cycle_gan checkpoint, serve one predict_B
    latest = os.path.join(ckpt, "stoch", "latest")
    out = tmp + "/variant_export"
    export_main(["--chk_path", latest, "--out", out, "--device", device])
    opt = load_train_config_from_expr_dir(os.path.join(ckpt, "stoch"))
    loaded = create_model(opt, testing=True, device=device)
    loaded.load(latest)
    rng = np.random.RandomState(6)
    A = rng.uniform(-1, 1, (32, 64, 64, 3)).astype(np.float32)
    z = rng.randn(32, width["nlatent"]).astype(np.float32)
    want_B = loaded.predict_B(A, z).cpu().numpy()
    server = build_server(out, port=0, device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        got_B, _ = counted(
            "served stoch_cycle_gan predict_B",
            {"fwd": gen_sites(32, "B", width["ngf"], width["n_blocks"]),
             "bwd": {}},
            lambda: _post("http://127.0.0.1:%d/predict_B"
                          % server.server_address[1], {"A": A, "z": z}))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("the server thread did not stop")
    _check_images(got_B, 32, 64, 3, "served stoch_cycle_gan predict_B")
    figures["export_max_abs_err"] = float(np.abs(got_B - want_B).max())
    if figures["export_max_abs_err"] > EXPORT_ATOL:
        raise AssertionError("exported stoch_cycle_gan predict_B: %r"
                             % figures["export_max_abs_err"])

    # the evaluation CLI on each checkpoint
    results = {}
    for name in VARIANT_RUNS:
        chk = os.path.join(ckpt, name, "latest")
        res_dir = os.path.join(ckpt, name, "test_res")
        for metric in (("bpp",) if name == "sup" else ()) + TEST_METRICS:
            argv = ["--chk_path", chk, "--dataroot", root, "--metric",
                    metric, "--device", device, "--train_logvar", "1"]
            results[name, metric], figures["metric_s"][
                "%s_%s" % (name, metric)] = counted(
                "test CLI %s --metric %s" % (name, metric),
                test_cli_expected(name, metric, width),
                lambda: test_cli.test_model(argv))
            files = TEST_FILES.get(metric, ()) + (
                ("inf_0.png",) if (name, metric) == ("sup", "visual")
                else ()) + (("test_pred_B_0.png", "test_pred_B_%d.png"
                             % BPP_STEPS) if metric == "bpp" else ())
            for f in files:
                if not os.path.getsize(os.path.join(res_dir, f)):
                    raise AssertionError("test CLI %s: %s empty" % (name, f))
            if not all(np.isfinite(v)
                       for v in results[name, metric].values()):
                raise AssertionError("test CLI %s --metric %s: %r" % (
                    name, metric, results[name, metric]))
        if os.path.exists(os.path.join(res_dir, "inf_0.png")) != \
                (name == "sup"):
            raise AssertionError("test CLI %s: inf_0.png" % name)
        noise = np.load(os.path.join(res_dir, "noise_sens.npy"))
        if noise.shape != (8, CLI_DATA["n_test"]) or \
                not np.isfinite(noise).all():
            raise AssertionError("test CLI %s: noise_sens %r"
                                 % (name, noise.shape))
    # --fid_extractor on the supervised checkpoint: the same decode
    argv = ["--chk_path", os.path.join(ckpt, "sup", "latest"), "--dataroot",
            root, "--metric", "fid", "--device", device, "--fid_extractor",
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         *FID_EXTRACTOR)]
    pads_before = [w.launches for w in P.WRAPPERS]
    results["sup", "fid_extractor"], figures["metric_s"][
        "sup_fid_extractor"] = counted(
        "test CLI sup --metric fid --fid_extractor",
        test_cli_expected("sup", "fid", width),
        lambda: test_cli.test_model(argv))
    fid_launches = {"K1": sum(runs["test CLI sup --metric fid "
                                   "--fid_extractor"]["fwd"].values()),
                    "K2": sum(runs["test CLI sup --metric fid "
                                   "--fid_extractor"]["bwd"].values())}
    for w, n in zip(P.WRAPPERS, pads_before):
        fid_launches[w.__name__] = w.launches - n
    if not os.path.getsize(os.path.join(ckpt, "sup", "test_res",
                                        "fid.txt")):
        raise AssertionError("test CLI sup --fid_extractor: fid.txt empty")
    # cycle_gan decodes every z of an input alike: only float noise of the
    # batched convs (4e-7 of 0.34 seen on an H100) parts them
    if results["cycle", "z_div"]["ratio"] > 1e-5:
        raise AssertionError("cycle_gan z_div: %r" % results["cycle", "z_div"])

    # TEST_MSE_A is eval_mse_A over the same batch; the first bpp chunk
    # through the kernels vs plain norms, outside the counted runs
    expr = os.path.join(ckpt, "sup")
    opt = load_train_config_from_expr_dir(expr, seed=12345)
    model = create_model(opt, testing=True, device=device)
    model.load(os.path.join(expr, "latest"))
    trainA, trainB, _, _, testA, testB = load_numpy_data(
        root, grid_size=64, dev_size=CLI_DATA["dev_size"])
    direct = eval_mse_A(AlignedIterator(testA, testB, batch_size=TEST_BATCH),
                        model)
    figures["test_mse_A_vs_eval_mse_A"] = abs(
        results["sup", "mse"]["TEST_MSE_A"] - direct)
    if figures["test_mse_A_vs_eval_mse_A"] > 1e-6 * direct:
        raise AssertionError("TEST_MSE_A %r, eval_mse_A %r" % (
            results["sup", "mse"]["TEST_MSE_A"], direct))
    figures["fid_extractor"] = check_fid_extractor(
        torch, testB, device, results["sup", "fid"]["PROXY_FID_B"],
        results["sup", "fid_extractor"]["FID_B"], smi, fid_launches)
    logvar_B = train_logvar(UnalignedIterator(
        trainA[:TEST_SUBSET], trainB[:TEST_SUBSET], batch_size=TEST_BATCH),
        model, verbose=False)
    ubo_dev, ubo_vals = check_ubo_against_plain(
        torch, model, testA, testB, TEST_BATCH, logvar_B)
    figures.update({
        "ubo_b200_kernels_vs_plain": ubo_dev, "ubo_b200": ubo_vals,
        "results": {"%s_%s" % k: v for k, v in results.items()},
    })
    log("variants and test CLI: launches by direction and shape %s, per "
        "variant %s" % (json.dumps({d: {"%dx%dx%d" % sh: c for sh, c in
                                        sorted(total[d].items())}
                                    for d in ("fwd", "bwd")}),
                        json.dumps(variants)))
    log("variants and test CLI: %s" % json.dumps(figures))
    if variants != expected:
        raise AssertionError("phase 8 launched the variants %r, the plan "
                             "picks %r" % (variants, expected))
    return total, variants, runs["test CLI sup --metric bpp"], figures


# phase 9 (a): (tag, model, flags, compute dtype, batch, grid, steps) against
# plain-norm twins with phase 5's limits.  The pool's run: 32 images fill 32
# of its 50 slots at step 1 and the rest at step 2, so steps 2 and 3 replay
EXTRAS_STEPS = (
    ("aug_accum4_f32_b32", "aug_cycle_gan", dict(grad_accum=ACCUM_K),
     "float32", 32, 64, 2),
    ("aug_accum4_bf16_b128", "aug_cycle_gan", dict(grad_accum=ACCUM_K),
     "bfloat16", 128, 64, 1),
    ("stoch_accum4_f32_b32", "stoch_cycle_gan", dict(grad_accum=ACCUM_K),
     "float32", 32, 64, 1),
    ("aug_accum4_f32_b32_256", "aug_cycle_gan", dict(grad_accum=ACCUM_K),
     "float32", 32, 256, 1),
    ("aug_pool50_ema_f32_b32", "aug_cycle_gan",
     dict(pool_size=50, ema=0.999), "float32", 32, 64, 3),
    ("aug_bf16_b32_256", "aug_cycle_gan", {}, "bfloat16", STEP256_BATCH,
     256, 1),
)
# --remat against the same model without it, one float32 step at batch 32
# each (cuDNN's deterministic algorithms on, so that the two runs differ in
# nothing but the recompute: the running statistics must be equal)
REMAT_STEPS = (("remat_dropout", dict(use_dropout=1)),
               ("remat_norm_batch", dict(norm="batch")))
# An EMA shadow against the formula applied to the parameters after each
# step, in float64 with the float32 coefficients the update uses.  Each step
# rounds three times (decay * e, (1 - decay) * p, the sum), each by at most
# half an ulp of a value no larger than m, the largest of |e_t| and
# (1 - decay) |p_t| over the steps; so after n steps an entry is within
# 1.5 n eps32 m of the formula, and twice that is allowed (EMA_ULPS n eps32
# m).  Most entries must have moved from the start by more than that, or an
# unchanged shadow would pass (EMA_MOVED_SHARE).
EMA_ULPS = 3.0
EMA_MOVED_SHARE = 0.5
# The shadow against the twin's, per net, by the relative L2 of their
# displacements from the start: an unchanged shadow reads 1.  The twin's
# parameters part by Adam's sign flips on entries whose gradient is rounding
# noise (up to 2 lr a step), which the shadow carries at (1 - decay); the
# same check of the port against the JAX package reads up to 0.11 at the
# tests' width 4, where such entries are a larger share
EMA_TWIN_RTOL = 0.3


def ema_formula_start(nets, tracked):
    """(start, formula, largest) of the shadow check: the tracked nets'
    parameters in float64, the formula's shadows (a copy) and the running
    m of the EMA_ULPS bound."""
    start = {k: [p.detach().double() for p in nets[k].parameters()]
             for k in tracked}
    formula = {k: [v.clone() for v in vs] for k, vs in start.items()}
    return start, formula, {k: [v.abs() for v in vs]
                            for k, vs in formula.items()}


def ema_formula_step(formula, largest, nets, decay):
    """The formula's shadows after one step, from the parameters."""
    d32, a32 = float(np.float32(decay)), float(np.float32(1.0 - decay))
    for k in formula:
        for e, m, p in zip(formula[k], largest[k], nets[k].parameters()):
            p = p.detach().double()
            e.mul_(d32).add_(p, alpha=a32)
            m.copy_(m.maximum(e.abs()).maximum(a32 * p.abs()))


def ema_readings(shadows, twin_shadows, start, formula, largest, n_steps):
    """(worst gap from the formula over its rounding bound, share of
    entries moved beyond that bound, relative L2 of the displacement from
    the twin's by net)."""
    eps32 = float(np.finfo(np.float32).eps)
    worst, moved, total, vs_twin = 0.0, 0, 0, {}
    for k, shadow in shadows.items():
        gap2 = twin2 = 0.0
        for s_, t_, f_, m_, e0 in zip(shadow, twin_shadows[k], formula[k],
                                      largest[k], start[k]):
            s_, t_ = s_.double(), t_.double()
            bound = EMA_ULPS * n_steps * eps32 * m_
            worst = max(worst, float(((s_ - f_).abs()
                                      / bound.clamp_min(1e-300)).max()))
            moved += int(((f_ - e0).abs() > bound).sum())
            total += f_.numel()
            gap2 += float((s_ - t_).square().sum())
            twin2 += float((t_ - e0).square().sum())
        vs_twin[k] = (gap2 / max(twin2, 1e-300)) ** 0.5
    return worst, moved / total, vs_twin


# the bfloat16 batch-128 step three ways, peak memory and time
MEMORY_WAYS = (("fused", {}), ("remat", dict(remat=True)),
               ("accum4", dict(grad_accum=ACCUM_K)))
# the float32 batch-32 step with and without the pool and EMA: time after
# two warm-up steps (the pools full), of EXTRAS_TIMED steps, each way once
EXTRAS_WAYS = (("fused", {}), ("pool50_ema", dict(pool_size=50, ema=0.999)))
EXTRAS_TIMED = 10


def _streamed_ring(K, on):
    """A context in which (``on``) every launch the plan sends to the ring
    route takes the streaming variant instead: the route's yardstick
    inside a whole step."""
    import contextlib

    @contextlib.contextmanager
    def swapped():
        plan = K.cluster_plan

        def streamed(*a, **kw):
            p = plan(*a, **kw)
            return K.STREAMING if p.variant == "ring" else p
        if on:
            K.cluster_plan = streamed
        try:
            yield
        finally:
            K.cluster_plan = plan
    return swapped()


def drive_extras_steps(torch, K):
    """Phase 9 (a): the --grad_accum steps, the pool with EMA and --remat at
    the published width.  Each step of EXTRAS_STEPS is held against a twin
    with the same weights, inputs, noise and pool draws whose norms run the
    plain version (phase 5's limits), its launches by direction and shape
    against its structure (accum_sites or the fused step's train_sites);
    the pool's replays and fill, the EMA shadow against the formula and
    against the twin's (EMA_ULPS, EMA_TWIN_RTOL).  Each case of REMAT_STEPS is held against the same
    model without --remat: losses and gradient norms at phase 5's step-1
    limits, running statistics equal, launches per remat_sites.  Then the
    bfloat16 batch-128 step fused, with --remat and with --grad_accum 4,
    and the float32 batch-32 --grad_accum 4 step on 256x256 images: peak
    memory and step time; the float32 batch-32 step with and without the
    pool and EMA (EXTRAS_WAYS): step time; the bfloat16 batch-32 step on
    256x256 images with the ring route and with the streaming variant
    forced (_streamed_ring), and the 256x256 --grad_accum 4
    step: the instance norms' device time and share (_profile_window).
    Returns (launches by dtype, direction and shape, the same per variant,
    the figures)."""
    from domain_transfer_gan_torch.config import TrainConfig
    from domain_transfer_gan_torch.models import create_model

    counters = _Counters(K)
    expected = {d: _no_launches() for d in ("fwd", "bwd")}
    by_dtype = {n: {"fwd": {}, "bwd": {}} for n in ("float32", "bfloat16")}
    nlatent = TRAIN_CFG["nlatent"]
    width = dict(n_blocks=TRAIN_CFG["n_blocks"], ngf=TRAIN_CFG["ngf"],
                 ndf=TRAIN_CFG["ndf"])
    devs, figures = {}, {"counted_step_ms": {}}

    def model(**kw):
        return create_model(TrainConfig(**dict(TRAIN_CFG, **kw)),
                            testing=True, device="cuda")

    def counted(m, what, want, fn):
        before = counters.read()
        out = fn()
        torch.cuda.synchronize()
        seen = counters.diff(counters.read(), before)
        _held_counts(seen, want, what)
        name = "float32" if m.dtype == torch.float32 else "bfloat16"
        _tally(K, seen, torch.finfo(m.dtype).bits // 8, expected)
        for d in ("fwd", "bwd"):
            _add(by_dtype[name][d], seen[d])
        return out

    def train(m, A, B, z, eps, draws, plain=False):
        kw = dict(plain_norm=plain, pool_draws=draws)
        if m.opt.model == "aug_cycle_gan":
            losses, visuals, gnorms = m.train_instance(A, B, z, eps, **kw)
        else:
            losses, visuals, gnorms = m.train_instance(A, B, z, **kw)
        for k, v in visuals.items():
            if tuple(v.shape) != A.shape or \
                    not bool(torch.isfinite(v.float()).all()):
                raise AssertionError("%s visual %s" % (m.opt.model, k))
        return _floats(losses), _floats(gnorms)

    counters.reset()  # phase 9's steps start here
    for i, (tag, name, flags, dtype, batch, hw, n_steps) in enumerate(
            EXTRAS_STEPS):
        cfg = dict(model=name, compute_dtype=dtype, grid_size=hw,
                   batchSize=batch, **flags)
        fused, twin = model(**cfg), model(**cfg)
        A, B, zs = train_inputs(batch, nlatent, seed=41 + i, hw=hw)
        if "grad_accum" in flags:
            want = accum_sites(batch, flags["grad_accum"], hw=hw, **width)
        else:
            sites = train_sites(batch, hw=hw, **width)
            want = {"fwd": sites, "bwd": sites}
        rng = np.random.RandomState(51 + i)
        pool_size = flags.get("pool_size", 0)
        ema_check = ema_formula_start(fused.nets, fused.state.ema)
        replays = 0
        for it, (z, eps) in enumerate(zs[:n_steps]):
            draws = None
            if pool_size:
                draws = {k: (rng.rand(batch) < 0.5,
                             rng.randint(0, pool_size, batch))
                         for k in ("fake_A", "fake_B")}
                first = max(0, pool_size - fused.state.pools["fake_A"].n)
                replays += int(draws["fake_A"][0][first:].sum())
            t0 = time.perf_counter()
            lf, gf = counted(fused, "%s step %d" % (tag, it + 1), want,
                             lambda: train(fused, A, B, z, eps, draws))
            # a step with the counters read and its structure checked
            figures["counted_step_ms"].setdefault(tag, []).append(
                (time.perf_counter() - t0) * 1e3)
            before = counters.read()
            lp, gp = train(twin, A, B, z, eps, draws, plain=True)
            none = counters.diff(counters.read(), before)
            if none["fwd"] or none["bwd"]:
                raise AssertionError("the plain-norm twin launched a kernel")
            rl, rg = (TRAIN_STEP1_RTOL if it == 0 else TRAIN_STEP3_RTOL)[dtype]
            what = "%s step %d, fused vs plain-norm twin" % (tag, it + 1)
            devs[tag + "_step%d_losses" % (it + 1)] = _held(lf, lp, rl, what)
            devs[tag + "_step%d_gnorms" % (it + 1)] = _held(gf, gp, rg, what)
            if fused.state.ema:
                ema_formula_step(*ema_check[1:], fused.nets, fused.opt.ema)
        if pool_size:
            if [p.n for p in fused.state.pools.values()] != [pool_size] * 2 \
                    or replays == 0:
                raise AssertionError("%s: pools %r, %d replays" % (
                    tag, [p.n for p in fused.state.pools.values()], replays))
            figures[tag + "_replays_fake_A"] = replays
            devs[tag + "_pool_vs_twin"] = max(
                float((fused.state.pools[k].buf - twin.state.pools[k].buf)
                      .abs().max()) for k in fused.state.pools)
        if fused.state.ema:
            worst, moved, vs_twin = ema_readings(
                fused.state.ema, twin.state.ema, *ema_check, n_steps)
            devs[tag + "_ema_vs_formula"] = worst
            devs[tag + "_ema_moved_share"] = moved
            for k, v in vs_twin.items():
                devs["%s_ema_vs_twin_%s" % (tag, k)] = v
            if worst > 1.0 or moved < EMA_MOVED_SHARE or \
                    max(vs_twin.values()) > EMA_TWIN_RTOL:
                raise AssertionError(
                    "%s: EMA shadow %g of its rounding bound from the "
                    "formula, %g of its entries moved beyond it, %r "
                    "(relative L2) from the twin's"
                    % (tag, worst, moved, vs_twin))
        del fused, twin
        torch.cuda.empty_cache()

    # --remat against the same model without it
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        batch = TRAIN_BATCH["float32"]
        A, B, zs = train_inputs(batch, nlatent, seed=61)
        for tag, flags in REMAT_STEPS:
            base, remat = model(**flags), model(remat=True, **flags)
            want = remat_sites(batch, flags.get("norm") != "batch", **width)
            lb, gb = counted(base, tag + " without --remat",
                             {"fwd": want["bwd"], "bwd": want["bwd"]},
                             lambda: train(base, A, B, *zs[0], None))
            lr_, gr_ = counted(remat, tag, want,
                               lambda: train(remat, A, B, *zs[0], None))
            rl, rg = TRAIN_STEP1_RTOL["float32"]
            devs[tag + "_losses"] = _held(lr_, lb, rl, tag + " vs no remat")
            devs[tag + "_gnorms"] = _held(gr_, gb, rg, tag + " vs no remat")
            for name in base.nets:
                for (k, a), b in zip(base.nets[name].named_buffers(),
                                     remat.nets[name].buffers()):
                    if not torch.equal(a, b):
                        raise AssertionError("%s: %s.%s differs from the "
                                             "step without --remat"
                                             % (tag, name, k))
            del base, remat
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic

    total, variants = counters.read(), counters.variants()  # and end here
    if variants != expected:
        raise AssertionError("phase 9 steps launched the variants %r, the "
                             "plan picks %r" % (variants, expected))

    # the bfloat16 batch-128 step three ways: peak memory and time (after
    # one warm-up step; the counters are not read here)
    batch = TRAIN_BATCH["bfloat16"]
    A, B, _ = train_inputs(batch, nlatent, seed=14)
    A, B = torch.from_numpy(A).cuda(), torch.from_numpy(B).cuda()
    for way, flags in MEMORY_WAYS:
        m = model(compute_dtype="bfloat16", batchSize=batch, **flags)
        m.train_instance(A, B)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(2):
            m.train_instance(A, B)
        torch.cuda.synchronize()
        figures["bf16_b128_%s_step_ms" % way] = \
            (time.perf_counter() - t0) / 2 * 1e3
        figures["bf16_b128_%s_peak_memory_gb" % way] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
        del m
        torch.cuda.empty_cache()
    # the float32 batch-32 step with and without the pool and EMA (the
    # model draws the pools' coins and slots)
    batch = TRAIN_BATCH["float32"]
    A, B, _ = train_inputs(batch, nlatent, seed=16)
    A, B = torch.from_numpy(A).cuda(), torch.from_numpy(B).cuda()
    ways = {way: model(batchSize=batch, **flags) for way, flags in EXTRAS_WAYS}
    for m in ways.values():
        for _ in range(2):
            m.train_instance(A, B)
    for way, m in ways.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EXTRAS_TIMED):
            m.train_instance(A, B)
        torch.cuda.synchronize()
        figures["f32_b32_%s_step_ms" % way] = \
            (time.perf_counter() - t0) / EXTRAS_TIMED * 1e3
    del ways, m
    torch.cuda.empty_cache()
    # the --grad_accum 4 step on 256x256 images, float32 at batch 32: time
    # and peak memory (one warm-up step)
    A, B, _ = train_inputs(32, nlatent, seed=15, hw=256)
    A, B = torch.from_numpy(A).cuda(), torch.from_numpy(B).cuda()
    m = model(grid_size=256, batchSize=32, grad_accum=ACCUM_K)
    m.train_instance(A, B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m.train_instance(A, B)
    torch.cuda.synchronize()
    figures["f32_b32_256_accum4_step_ms"] = (time.perf_counter() - t0) * 1e3
    figures["f32_b32_256_accum4_peak_memory_gb"] = \
        torch.cuda.max_memory_allocated() / 2 ** 30
    figures["f32_b32_256_accum4_profile"] = profile_window(
        lambda: m.train_instance(A, B), reps=2)
    del m, A, B
    torch.cuda.empty_cache()
    # the bfloat16 step on 256x256 images at batch 32, its 256x256
    # generator sites through the ring route (the plan's pick) and through
    # the streaming variant forced: time, peak memory and the
    # instance norms' device time under torch.profiler (the counters are
    # not read here)
    A, B, _ = train_inputs(STEP256_BATCH, nlatent, seed=17, hw=256)
    A, B = torch.from_numpy(A).cuda(), torch.from_numpy(B).cuda()
    m = model(compute_dtype="bfloat16", grid_size=256,
              batchSize=STEP256_BATCH)
    for way in ("ring", "streaming"):
        with _streamed_ring(K, way == "streaming"):
            m.train_instance(A, B)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(2):
                m.train_instance(A, B)
            torch.cuda.synchronize()
            key = "bf16_b32_256_%s" % way
            figures.setdefault(key + "_step_ms", []).append(
                (time.perf_counter() - t0) / 2 * 1e3)
            figures[key + "_peak_memory_gb"] = \
                torch.cuda.max_memory_allocated() / 2 ** 30
            if key + "_profile" not in figures:
                figures[key + "_profile"] = profile_window(
                    lambda: m.train_instance(A, B), reps=2)
    del m, A, B
    torch.cuda.empty_cache()
    log("extras steps: launches by direction and shape %s, per variant %s"
        % (json.dumps({d: {"%dx%dx%d" % sh: c for sh, c in
                           sorted(total[d].items())} for d in ("fwd", "bwd")}),
           json.dumps(variants)))
    log("extras steps: largest relative deviations %s" % json.dumps(devs))
    log("extras steps: %s" % json.dumps(figures))
    return by_dtype, variants, figures


# phase 9 (b): one epoch each through the training CLI on phase 7's data
EXTRAS_RUNS = {"pool": ["--pool_size", "50", "--ema", "0.999", "--remat"],
               "accum": ["--grad_accum", str(ACCUM_K), "--ema", "0.999"]}


def extras_cli_expected(name, width):
    """Launches of one epoch of a phase-9 training CLI run (aug_cycle_gan)
    by direction and (N, HW, C): a phase-8 run's structure (the stoch run's
    evaluations and grids, and the inference grid of aug_cycle_gan) with
    this run's step; under --remat the UBO's forward runs twice per RMSprop
    step (its backward recomputes netG_A_B)."""
    ngf, nb, batch = width["ngf"], width["n_blocks"], TRAIN_BATCH["float32"]
    steps = (CLI_DATA["n_train"] - CLI_DATA["dev_size"]) // batch
    want = variant_cli_expected("stoch", width)
    fused = train_sites(batch, nb, ngf, width["ndf"])
    if name == "accum":
        step = accum_sites(batch, ACCUM_K, nb, ngf, width["ndf"])
    else:
        step = remat_sites(batch, True, nb, ngf, width["ndf"])
    for d in ("fwd", "bwd"):
        _add(want[d], fused, -steps)
        _add(want[d], step[d], steps)
    _add(want["fwd"], gen_sites(NUM_MULTI, "A", ngf, nb))
    _add(want["fwd"], gen_sites(DEV_VIS_BATCH * NUM_MULTI, "B", ngf, nb))
    if name == "pool":
        _add(want["fwd"], gen_sites(EVAL_BATCH, "B", ngf, nb), 3 * UBO_STEPS)
    return {d: {k: v for k, v in want[d].items() if v} for d in want}


def drive_extras_cli(torch, K, tmp, device="cuda", width=CLI_WIDTH):
    """Phase 9 (b): one epoch each of aug_cycle_gan --pool_size 50 --ema
    0.999 --remat and --grad_accum 4 --ema 0.999 through the training CLI
    on phase 7's data, then one more epoch of the pool run with
    --continue_train; latest is format 2 with pools and shadows, and the
    resumed run's restored pools equal the saved ones bit for bit; the
    evaluation CLI with --use_ema 1 --metric mse on the EMA checkpoint
    (TEST_MSE_A against eval_mse_A of the loaded and swapped model over the
    same batch), export --use_ema 1 and one served predict_B against the
    swapped model's.  Launches are read around each run and held to its
    structure.  Returns (launches by direction and shape, per variant, the
    figures)."""
    import os

    from domain_transfer_gan_torch.cli import test as test_cli
    from domain_transfer_gan_torch.cli.export import main as export_main
    from domain_transfer_gan_torch.cli.serve import build_server
    from domain_transfer_gan_torch.cli.train import train_model
    from domain_transfer_gan_torch.config import \
        load_train_config_from_expr_dir
    from domain_transfer_gan_torch.data import AlignedIterator, \
        load_numpy_data
    from domain_transfer_gan_torch.eval import eval_mse_A
    from domain_transfer_gan_torch.models import create_model
    from domain_transfer_gan_torch.models.api import CKPT_FORMAT, \
        CycleGANBase
    from domain_transfer_gan_torch.utils import checkpoint

    root, ckpt = tmp + "/cli_data", tmp + "/extras_runs"
    counters = _Counters(K)
    total = {"fwd": {}, "bwd": {}}
    expected = {d: _no_launches() for d in ("fwd", "bwd")}
    variants = {d: _no_launches() for d in ("fwd", "bwd")}
    figures = {"train_s": {}}

    def counted(what, want, fn):
        counters.reset()  # each run of phase 9 (b) starts here
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        seen, by_variant = counters.read(), counters.variants()  # ends here
        _held_counts(seen, want, what)
        _tally(K, seen, 4, expected)
        for d in ("fwd", "bwd"):
            _add(total[d], seen[d])
            for v, c in by_variant[d].items():
                variants[d][v] += c
        return out, dt

    steps = (CLI_DATA["n_train"] - CLI_DATA["dev_size"]) // \
        TRAIN_BATCH["float32"]
    saved = {}
    for name, flags in EXTRAS_RUNS.items():
        argv = _cli_argv(root, ckpt, device, width,
                         ["--name", name, "--niter_decay", "0"] + flags)
        model, figures["train_s"][name] = counted(
            "training CLI " + name, extras_cli_expected(name, width),
            lambda: train_model(argv=argv))
        if (model.epoch, model.state.step) != (1, steps):
            raise AssertionError("training CLI %s: epoch %d step %d"
                                 % (name, model.epoch, model.state.step))
        payload = checkpoint.read_checkpoint(os.path.join(ckpt, name,
                                                          "latest"))
        if payload["format"] != CKPT_FORMAT or \
                set(payload.get("ema", ())) != {"netG_A_B", "netG_B_A",
                                                "netE_B"} or \
                ("pools" in payload) != (name == "pool"):
            raise AssertionError("training CLI %s: latest holds %s, ema %r"
                                 % (name, payload["format"],
                                    sorted(payload.get("ema", ()))))
        saved[name] = payload

    # one more epoch of the pool run, its pools right after the load kept
    restored, load = [], CycleGANBase.load

    def recording_load(self, path):
        load(self, path)
        restored.append({k: (p.buf.detach().cpu().clone(), p.n)
                         for k, p in self.state.pools.items()})

    CycleGANBase.load = recording_load
    try:
        argv = _cli_argv(root, ckpt, device, width,
                         ["--name", "pool", "--continue_train",
                          "--niter_decay", "1"] + EXTRAS_RUNS["pool"])
        resumed, figures["train_s"]["pool_resumed"] = counted(
            "training CLI pool, resumed", extras_cli_expected("pool", width),
            lambda: train_model(argv=argv))
    finally:
        CycleGANBase.load = load
    pools = saved["pool"]["pools"]
    if len(restored) != 1 or any(
            not torch.equal(restored[0][k][0], pools[k]["buf"])
            or restored[0][k][1] != pools[k]["n"] for k in pools):
        raise AssertionError("the resumed run's pools are not the saved ones")
    if (resumed.epoch, resumed.state.step) != (2, 2 * steps):
        raise AssertionError("resumed pool run: epoch %d step %d"
                             % (resumed.epoch, resumed.state.step))

    # the evaluation CLI on the EMA shadows of the accumulation run
    expr = os.path.join(ckpt, "accum")
    latest = os.path.join(expr, "latest")
    out, figures["test_cli_use_ema_s"] = counted(
        "test CLI --use_ema 1 --metric mse",
        test_cli_expected("accum", "mse", width),
        lambda: test_cli.test_model(
            ["--chk_path", latest, "--dataroot", root, "--metric", "mse",
             "--device", device, "--use_ema", "1"]))
    opt = load_train_config_from_expr_dir(expr, seed=12345)
    swapped = create_model(opt, testing=True, device=device)
    swapped.load(latest)
    swapped.swap_ema()
    _, _, _, _, testA, testB = load_numpy_data(
        root, grid_size=64, dev_size=CLI_DATA["dev_size"])
    direct = eval_mse_A(AlignedIterator(testA, testB, batch_size=TEST_BATCH),
                        swapped)
    figures["test_mse_A_use_ema_vs_eval_mse_A"] = abs(out["TEST_MSE_A"]
                                                      - direct)
    if figures["test_mse_A_use_ema_vs_eval_mse_A"] > 1e-6 * direct:
        raise AssertionError("--use_ema TEST_MSE_A %r, eval_mse_A of the "
                             "swapped model %r" % (out["TEST_MSE_A"], direct))

    # export the shadows of the pool run, serve one predict_B
    expr = os.path.join(ckpt, "pool")
    export = tmp + "/extras_export"
    export_main(["--chk_path", os.path.join(expr, "latest"), "--out", export,
                 "--device", device, "--use_ema", "1"])
    loaded = create_model(load_train_config_from_expr_dir(expr),
                          testing=True, device=device)
    loaded.load(os.path.join(expr, "latest"))
    loaded.swap_ema()
    rng = np.random.RandomState(7)
    A = rng.uniform(-1, 1, (32, 64, 64, 3)).astype(np.float32)
    z = rng.randn(32, width["nlatent"]).astype(np.float32)
    want_B = loaded.predict_B(A, z).cpu().numpy()
    server = build_server(export, port=0, device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        got_B, _ = counted(
            "served EMA predict_B",
            {"fwd": gen_sites(32, "B", width["ngf"], width["n_blocks"]),
             "bwd": {}},
            lambda: _post("http://127.0.0.1:%d/predict_B"
                          % server.server_address[1], {"A": A, "z": z}))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("the server thread did not stop")
    _check_images(got_B, 32, 64, 3, "served EMA predict_B")
    figures["export_use_ema_max_abs_err"] = float(np.abs(got_B
                                                         - want_B).max())
    if figures["export_use_ema_max_abs_err"] > EXPORT_ATOL:
        raise AssertionError("exported EMA predict_B: %r"
                             % figures["export_use_ema_max_abs_err"])
    log("extras CLI: launches by direction and shape %s, per variant %s"
        % (json.dumps({d: {"%dx%dx%d" % sh: c for sh, c in
                           sorted(total[d].items())} for d in ("fwd", "bwd")}),
           json.dumps(variants)))
    log("extras CLI: %s" % json.dumps(figures))
    if variants != expected:
        raise AssertionError("phase 9 CLIs launched the variants %r, the "
                             "plan picks %r" % (variants, expected))
    return total, variants, figures


def time_end_to_end(torch, ctx):
    """images/s of the two generators at batch 32: the exported callables on
    device tensors (wall time around a final synchronize; the port's float32
    and bfloat16 artifacts and the JAX package's full-width float32 export,
    interpreted) and whole HTTP requests (the port's float32 artifact and
    the JAX package's export), 20 timed calls after 3 warm-ups each."""
    from domain_transfer_gan_torch.cli.export import load_exported
    from domain_transfer_gan_torch.cli.serve import build_server

    batch = ctx["batch"]
    A = torch.from_numpy(ctx["A"][:batch]).cuda()
    B = torch.from_numpy(ctx["B"]).cuda()
    z = torch.from_numpy(ctx["z"][:batch]).cuda()
    out = {"batch": batch, "timed_calls": 20, "warmups": 3}
    for d, tag in ((ctx["fp32_dir"], "float32"), (ctx["bf16_dir"], "bfloat16"),
                   (ctx["jax_dir"], "jax_export_float32")):
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

    reqs = (("predict_B", {"A": ctx["A"][:batch], "z": ctx["z"][:batch]}),
            ("predict_A", {"B": ctx["B"]}))
    for d, tag in ((ctx["fp32_dir"], "float32"),
                   (ctx["jax_dir"], "jax_export_float32")):
        server = build_server(d, port=0, device="cuda")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            url = "http://127.0.0.1:%d" % server.server_address[1]
            for name, arrays in reqs:
                for _ in range(3):
                    _post(url + "/" + name, arrays)
                t0 = time.perf_counter()
                for _ in range(20):
                    _post(url + "/" + name, arrays)
                dt = time.perf_counter() - t0
                out["http_%s_%s_images_per_s" % (name, tag)] = (
                    20 * batch / dt)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    return out


def profile_forward(torch, ctx):
    """Device time of one predict_B and one predict_A forward by kernel name
    (torch.profiler), float32, batch 32."""
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
        _, kernels, _ = profiled(call, 5)
        out[name] = {
            "device_busy_ms_per_call": sum(kernels.values()) / 1e3,
            "instance_norm_ms_per_call": norm_ms(kernels),
            "kernels_us_per_call": top_kernels(kernels, 14),
        }
    return out


def _p10_argv(root, ckpt, name, device, width, p, extra=()):
    """One epoch at the published width, every cadence off unless
    ``extra`` turns it on."""
    argv = ["--dataroot", root, "--name", name, "--checkpoints_dir", ckpt,
            "--grid_size", "64", "--batchSize", str(p["batch"]),
            "--niter", "1", "--niter_decay", "0", "--save_epoch_freq", "0",
            "--eval_A_freq", "0", "--eval_B_freq", "0",
            "--print_freq", str(CLI_PRINT_EVERY * p["batch"]),
            "--display_freq", "0", "--dev_size", str(p["dev_size"]),
            "--nThreads", str(p["n_threads"]), "--init_scheme", "sane",
            "--seed", "2027", "--device", device, "--num_devices", "1"]
    for k, v in width.items():
        argv += ["--" + k, str(v)]
    return argv + list(extra)


def _batch_sizes(n, batch):
    return [min(batch, n - lo) for lo in range(0, n, batch)]


def p10_train_expected(width, batch, sizes, sup=0):
    """Launches of train steps on batches of ``sizes`` (with ``sup``
    supervised steps at ``batch``)."""
    ngf, nb, ndf = width["ngf"], width["n_blocks"], width["ndf"]
    want = {"fwd": {}, "bwd": {}}
    for d in want.values():
        for n in sizes:
            _add(d, train_sites(n, nb, ngf, ndf))
        _add(d, sup_sites(batch, nb, ngf), sup)
    return want


def p10_perfile_expected(width, p, ubo=True, display=True):
    """Launches of phase 10 (b)'s training CLI run by direction and (N, HW,
    C): the steps (the tail's included), eval-A (netG_B_A on each dev and
    test batch of 200 as it is), eval-B (the UBO's forward and backward per
    RMSprop step on every batch padded to 200, and the dev batches' first
    grid at up to 25), and one display on the epoch's last step
    (generate_cycle, the multi grid and the inference grid on a dev batch of
    up to 25)."""
    ngf, nb = width["ngf"], width["n_blocks"]
    n_tr = p["n_train"] - p["dev_size"]
    want = p10_train_expected(width, p["batch"],
                              _batch_sizes(n_tr, p["batch"]))
    fwd, bwd = want["fwd"], want["bwd"]

    def g(n, fn):
        return gen_sites(n, fn, ngf, nb)

    dev = _batch_sizes(p["dev_size"], P10_EVAL)
    test = _batch_sizes(p["n_test"], P10_EVAL)
    for n in dev + test:
        _add(fwd, g(n, "A"))
    if ubo:
        for d in (fwd, bwd):
            _add(d, g(P10_EVAL, "B"), (len(dev) + len(test)) * P10_UBO_STEPS)
        for n in dev:
            _add(fwd, g(min(DEV_VIS_BATCH, n), "B"))
    if display:
        v = min(DEV_VIS_BATCH, p["dev_size"])
        h = min(NUM_MULTI, v)
        _add(fwd, g(v, "B"), 2)
        _add(fwd, g(v, "A"), 2)
        _add(fwd, g(v * NUM_MULTI, "B"))
        _add(fwd, g(h, "A"))
        _add(fwd, g(v * h, "B"))
    return want


def p10_test_expected(width, p, metric):
    """Launches of cli.test on the per-file run: mse decodes each dev and
    test batch of 200 through netG_B_A; visual decodes one dev batch of up
    to 10 as phase 8 does (with the inference grid of aug_cycle_gan)."""
    ngf, nb = width["ngf"], width["n_blocks"]
    fwd = {}

    def g(n, fn):
        return gen_sites(n, fn, ngf, nb)

    if metric == "mse":
        for n in (_batch_sizes(p["dev_size"], P10_EVAL)
                  + _batch_sizes(p["n_test"], P10_EVAL)):
            _add(fwd, g(n, "A"))
    else:
        v = min(P10_TEST_VIS, p["dev_size"])
        m, h = v * P10_TEST_MULTI, min(P10_TEST_MULTI, v)
        _add(fwd, g(v, "B"), 2 + 4)
        _add(fwd, g(v, "A"), 2 + 1 + 4)
        _add(fwd, g(m, "B"), 2)
        _add(fwd, g(h, "A"))
        _add(fwd, g(v * h, "B"))
    return {"fwd": fwd, "bwd": {}}


def write_livneh_netcdf(root, days, size, seed):
    """A Livneh-shaped NetCDF-3 pair under ``root`` (``forcings.nc``:
    Prec, Tmax, Tmin, wind; ``swe.nc``: SWE; each (time, lat, lon) float32
    with lat/lon/time) over one land mask that is NaN in every variable and
    day.  Returns (A, B): the forcings stacked in that order and SWE, as
    the ETL should stack them."""
    import os

    from scipy.io import netcdf_file

    from domain_transfer_gan_torch.data.synthetic import \
        make_synthetic_livneh_pair

    A, B = make_synthetic_livneh_pair(days, size, seed, nan_frac=0.0)
    A = A[..., [0, 2, 1, 3]]  # (prec, tmin, tmax, wind) -> the file's order
    rng = np.random.RandomState(seed)
    field = rng.rand(size, size)
    mask = field > np.quantile(field, 0.9)
    A[:, mask] = np.nan
    B[:, mask] = np.nan
    os.makedirs(root, exist_ok=True)
    for fname, names, arr in (("forcings.nc", ["Prec", "Tmax", "Tmin",
                                               "wind"], A),
                              ("swe.nc", ["SWE"], B)):
        with netcdf_file(os.path.join(root, fname), "w") as ds:
            for dim, n in (("time", days), ("lat", size), ("lon", size)):
                ds.createDimension(dim, n)
                v = ds.createVariable(dim, "f4", (dim,))
                v[:] = np.arange(n, dtype=np.float32)
            for i, name in enumerate(names):
                v = ds.createVariable(name, "f4", ("time", "lat", "lon"))
                v[:] = arr[..., i]
    return A, B


def _finite_loss_lines(log, what):
    import re
    lines = [ln for ln in log.splitlines() if ln.startswith("(epoch:")]
    if not lines:
        raise AssertionError("%s: no loss line" % what)
    for ln in lines:
        vals = re.findall(r"\w+: (\S+) ", ln.split(") ", 1)[-1] + " ")
        if len(vals) < 10 or not all(np.isfinite(float(v)) for v in vals):
            raise AssertionError("%s: %r" % (what, ln))
    return len(lines)


def _steady(ips):
    """The CLI's throughput windows less the first (its warm-up)."""
    import statistics
    steady = ips[1:]
    return statistics.median(steady) if steady else None


def drive_phase10(torch, K, tmp, smi, device="cuda", width=CLI_WIDTH,
                  p=P10, counters=None):
    """Phase 10: (a) the Livneh ETL and one epoch on its bundles; (b) one
    epoch of the per-file path with eval-A, eval-B, a display and
    --profile_dir, then cli.test --metric mse and visual on its latest
    (TEST_MSE_A against eval_mse_A over the same DataLoader); (c) the feed:
    its batches against a synchronous copy bit for bit, the native reader
    against numpy, the same epoch's images/s three ways in turn; (d)
    --supervised --device_data 1; (e) the trace of (b) names K1 and K2; (f)
    export_torch_checkpoint -> cli.import_torch -> predict_B and one
    resumed epoch; (g) a paired-jpg folder where PIL is present.  Every
    run's launches are read from 0 around it and held to its structure
    (and, on the card, to the variants the plan picks).  Returns (launches
    by direction and shape, per variant, the figures)."""
    import collections
    import contextlib
    import json as _json
    import os
    import types

    from domain_transfer_gan_torch.cli import test as test_cli
    from domain_transfer_gan_torch.cli import train as train_cli
    from domain_transfer_gan_torch.cli.import_torch import \
        main as import_main
    from domain_transfer_gan_torch.cli.train import train_model
    from domain_transfer_gan_torch.config import \
        load_train_config_from_expr_dir
    from domain_transfer_gan_torch.data import DataLoader, PILMissingError, \
        load_edges2shoes, load_numpy_data, native, prep_livneh
    from domain_transfer_gan_torch.data.feed import prefetch_to_device
    from domain_transfer_gan_torch.data.synthetic import (
        write_synthetic_dataset,
        write_synthetic_perfile_dataset,
    )
    from domain_transfer_gan_torch.eval import eval_mse_A
    from domain_transfer_gan_torch.models import create_model
    from domain_transfer_gan_torch.utils.torch_interop import \
        export_torch_checkpoint

    log("phase 10 on %s" % smi)
    counters = counters or _Counters(K)
    on_card = device == "cuda"
    total = {"fwd": {}, "bwd": {}}
    expected = {d: _no_launches() for d in ("fwd", "bwd")}
    variants = {d: _no_launches() for d in ("fwd", "bwd")}
    fig = {"run_s": {}, "native_reader": native.reader_name(),
           "zlib_h": os.path.exists("/usr/include/zlib.h")}
    log("phase 10: host reader %s; /usr/include/zlib.h %s"
        % (fig["native_reader"], "present" if fig["zlib_h"] else "absent"))
    batch = p["batch"]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def counted(what, want, fn):
        counters.reset()  # each run of phase 10 starts here
        t = time.perf_counter()
        out = fn()
        sync()
        fig["run_s"][what] = time.perf_counter() - t
        seen = counters.read()  # and ends here
        _held_counts(seen, want, what)
        for d in ("fwd", "bwd"):
            _add(total[d], seen[d])
        if on_card:
            _tally(K, seen, 4, expected)
            for d, by in counters.variants().items():
                for v, c in by.items():
                    variants[d][v] += c
        return out

    def read_log(expr):
        with open(os.path.join(expr, "results.txt")) as f:
            return f.read()

    ckpt = os.path.join(tmp, "p10_runs")

    # (a) the ETL and the science configuration
    nc = os.path.join(tmp, "p10_nc")
    A_src, B_src = write_livneh_netcdf(nc, p["livneh_days"], 64, seed=10)
    livneh = os.path.join(tmp, "p10_livneh")
    t = time.perf_counter()
    prep_livneh.prepare(os.path.join(nc, "forcings.nc"),
                        os.path.join(nc, "swe.nc"), livneh)
    fig["prep_livneh_s"] = time.perf_counter() - t
    n_days_tr = int(p["livneh_days"] * prep_livneh.TRAIN_FRACTION)
    for fname, want in (("trainA.npz", A_src[:n_days_tr]),
                        ("testA.npz", A_src[n_days_tr:]),
                        ("trainB.npz", B_src[:n_days_tr]),
                        ("testB.npz", B_src[n_days_tr:])):
        with np.load(os.path.join(livneh, fname)) as f:
            if f["data"].shape != want.shape or not np.array_equal(
                    f["data"], want, equal_nan=True) \
                    or sorted(f.files) != ["data", "lat", "lon", "time"]:
                raise AssertionError("prep_livneh: %s holds %r" % (
                    fname, f["data"].shape))
    for sub, n in (("trainA", n_days_tr), ("testB",
                                           p["livneh_days"] - n_days_tr)):
        if len(os.listdir(os.path.join(livneh, sub))) != n:
            raise AssertionError("prep_livneh: %s holds %d files"
                                 % (sub, len(os.listdir(os.path.join(
                                     livneh, sub)))))
    trA, trB, *_ = load_numpy_data(livneh, grid_size=64,
                                   dev_size=p["livneh_dev"])
    if trA.shape[-1] != 3 or trB.shape[-1] != 1 or not (
            np.isfinite(trA).all() and np.abs(trA).max() <= 1.0):
        raise AssertionError("Livneh bundles load as %r / %r"
                             % (trA.shape, trB.shape))
    n_tr = n_days_tr - p["livneh_dev"]
    want = p10_train_expected(width, batch, [batch] * -(-n_tr // batch))
    ev = _batch_sizes(p["livneh_dev"], 100) + _batch_sizes(
        p["livneh_days"] - n_days_tr, 100)
    for n in ev:
        _add(want["fwd"], gen_sites(n, "A", width["ngf"], width["n_blocks"]))
    model = counted("livneh", want, lambda: train_model(argv=_p10_argv(
        livneh, ckpt, "livneh", device, width,
        dict(p, dev_size=p["livneh_dev"]),
        ["--input_nc", "3", "--output_nc", "1", "--eval_A_freq", "1"])))
    text = read_log(os.path.join(ckpt, "livneh"))
    _finite_loss_lines(text, "Livneh run")
    if "DEV_MSE_A" not in text or model.state.step != -(-n_tr // batch):
        raise AssertionError("Livneh run: step %d" % model.state.step)

    # (b) the per-file path, and cli.test on its checkpoint
    perfile = os.path.join(tmp, "p10_perfile")
    write_synthetic_perfile_dataset(perfile, n_train=p["n_train"],
                                    n_test=p["n_test"], size=64, seed=11)
    npz = os.path.join(tmp, "p10_npz")
    write_synthetic_dataset(npz, n_train=p["n_train"], n_test=p["n_test"],
                            size=64, seed=11)
    prof = os.path.join(tmp, "p10_prof")
    n_tr = p["n_train"] - p["dev_size"]
    steps = -(-n_tr // batch)
    model = counted("per-file", p10_perfile_expected(width, p),
                    lambda: train_model(argv=_p10_argv(
                        perfile, ckpt, "perfile", device, width, p,
                        P10_FEED["prefetch"] + [
                            "--eval_A_freq", "1", "--eval_B_freq", "1",
                            "--save_epoch_freq", "1",
                            "--display_freq", str(steps * batch),
                            "--profile_dir", prof])))
    expr = os.path.join(ckpt, "perfile")
    text = read_log(expr)
    _finite_loss_lines(text, "per-file run")
    if model.state.step != steps or "DEV_BPP_B" not in text \
            or "host reader: " not in text \
            or "#training images = %d" % n_tr not in text:
        raise AssertionError("per-file run: step %d\n%s"
                             % (model.state.step, text[-2000:]))
    for f in ("latest", "best_A", "best_B", "history_ubo_B.npy"):
        if not os.path.exists(os.path.join(expr, f)):
            raise AssertionError("per-file run: %s missing" % f)
    latest = os.path.join(expr, "latest")
    out = counted("cli.test mse", p10_test_expected(width, p, "mse"),
                  lambda: test_cli.test_model(
                      ["--chk_path", latest, "--dataroot", perfile,
                       "--metric", "mse", "--device", device]))
    counted("cli.test visual", p10_test_expected(width, p, "visual"),
            lambda: test_cli.test_model(
                ["--chk_path", latest, "--dataroot", perfile, "--metric",
                 "visual", "--device", device]))
    if not os.path.getsize(os.path.join(expr, "test_res", "inf_0.png")):
        raise AssertionError("cli.test visual: no inf_0.png")
    opt = load_train_config_from_expr_dir(expr, seed=12345, device=device)
    loaded = create_model(opt, testing=True, device=device)
    loaded.load(latest)
    direct = eval_mse_A(DataLoader(opt, "val", False, P10_EVAL,
                                   load_in_mem=False), loaded)
    fig["test_mse_A_vs_eval_mse_A"] = abs(out["TEST_MSE_A"] - direct) / \
        abs(direct)
    if fig["test_mse_A_vs_eval_mse_A"] > 1e-6:
        raise AssertionError("per-file TEST_MSE_A %r, eval_mse_A %r"
                             % (out["TEST_MSE_A"], direct))

    # (e) the trace of (b)'s steps 10-14
    with open(os.path.join(prof, "trace.json")) as f:
        events = _json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    fig["trace_k1"] = sorted(n for n in names if "instance_norm_fwd" in n)
    fig["trace_k2"] = sorted(n for n in names if "instance_norm_bwd" in n)
    cats = dict(collections.Counter(e.get("cat", "") for e in events))
    fig["trace_events_by_category"] = cats  # "kernel": the card's kernels
    if on_card and not (fig["trace_k1"] and fig["trace_k2"]):
        raise AssertionError("the --profile_dir trace names K1 %r, K2 %r; "
                             "its events by category %r"
                             % (fig["trace_k1"], fig["trace_k2"], cats))
    if "profiler trace written to %s" % prof not in text:
        raise AssertionError("per-file run: no profiler line")

    # (c) the feed: bit-equal batches, the readers, then images/s
    dopt = types.SimpleNamespace(dataroot=perfile, grid_size=64,
                                 dev_size=p["dev_size"], resize_antialias=1,
                                 nThreads=p["n_threads"])
    host = list(DataLoader(dopt, "train", True, batch, seed=5))
    fed = list(prefetch_to_device(iter(host), device, size=2))
    if len(fed) != len(host) or not all(
            torch.equal(torch.as_tensor(f[k]),
                        torch.from_numpy(h[k]).to(device))
            for f, h in zip(fed, host) for k in ("A", "B")):
        raise AssertionError("the feed's batches are not the synchronous "
                             "copy's")
    fig["feed_batches_bit_equal"] = len(fed)
    del fed
    reader = DataLoader(dopt, "train", False, batch, load_in_mem=False)
    times, got = {}, {}
    saved = (native._LIB, native._TRIED, native._ERROR)
    for way in ("native", "numpy"):
        if way == "numpy":
            native._LIB, native._TRIED, native._ERROR = None, True, "off"
        t = time.perf_counter()
        got[way] = list(reader)
        times.setdefault(way, []).append(
            (time.perf_counter() - t) * 1e3 / len(got[way]))
        native._LIB, native._TRIED, native._ERROR = saved
    if not all(np.array_equal(a[k], b[k]) for a, b in
               zip(got["native"], got["numpy"]) for k in ("A", "B")):
        raise AssertionError("the native and numpy readers differ")
    fig["reader_ms_per_batch"] = times
    del got
    fig["feed_images_per_s"] = {}
    for i, way in enumerate(p["feed_turns"]):
        root = npz if way == "npz" else perfile
        name = "feed_%s_%d" % (way, i)
        with (synchronous_feed(train_cli) if way == "sync"
              else contextlib.nullcontext()):
            counted(name, p10_train_expected(
                width, batch, [batch] * steps if way == "npz"
                else _batch_sizes(n_tr, batch)),
                lambda: train_model(argv=_p10_argv(
                    root, ckpt, name, device, width, p, P10_FEED[way])))
        ips, _ = _log_figures(read_log(os.path.join(ckpt, name)))
        fig["feed_images_per_s"].setdefault(way, []).append(_steady(ips))
    log("phase 10 (c): %s" % _json.dumps(
        {k: fig[k] for k in ("feed_images_per_s", "reader_ms_per_batch",
                             "native_reader")}))

    # (d) --supervised --device_data 1
    sup_frac = (batch + 0.5) / n_tr  # one supervised batch
    counted("supervised", p10_train_expected(width, batch, [batch] * steps,
                                             sup=steps),
            lambda: train_model(argv=_p10_argv(
                npz, ckpt, "sup", device, width, p,
                ["--supervised", "--sup_frac", repr(sup_frac),
                 "--device_data", "1"])))
    text = read_log(os.path.join(ckpt, "sup"))
    if "supervised set on %s" % device not in text:
        raise AssertionError("--supervised --device_data 1: %s"
                             % text[:1000])
    _finite_loss_lines(text, "supervised run")

    # (f) upstream interop: export, import by the CLI, predict_B, resume
    upstream = os.path.join(tmp, "p10_upstream.pt")
    t = time.perf_counter()
    export_torch_checkpoint(loaded, upstream)
    fig["export_torch_s"] = time.perf_counter() - t
    imported_expr = os.path.join(ckpt, "imported")
    t = time.perf_counter()
    import_main(["--torch_chk", upstream, "--opt", expr, "--out",
                 os.path.join(imported_expr, "latest"), "--device", device])
    sync()
    fig["import_torch_s"] = time.perf_counter() - t
    imported = create_model(opt, testing=True, device=device)
    imported.load(os.path.join(imported_expr, "latest"))
    for name, net in loaded.nets.items():
        theirs = imported.nets[name].state_dict()
        a, b = loaded.state.opt_state[name], imported.state.opt_state[name]
        if not all(torch.equal(v, theirs[k])
                   for k, v in net.state_dict().items()) \
                or a.count != b.count or not all(
                    torch.equal(x, y) for x, y in zip(a.mu + a.nu,
                                                      b.mu + b.nu)):
            raise AssertionError("the upstream round trip changed %s" % name)
    rng = np.random.RandomState(12)
    A = rng.uniform(-1, 1, (batch, 64, 64, 3)).astype(np.float32)
    z = rng.randn(batch, width["nlatent"]).astype(np.float32)
    # cuDNN may pick another algorithm for the same conv from one call to
    # the next (1.1e-6 apart seen): the comparison pins its choice
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        fig["upstream_round_trip_max_abs_err"] = float(
            (imported.predict_B(A, z) - loaded.predict_B(A, z)).abs().max())
    fig["predict_B_run_to_run_max_abs_diff"] = float(
        (loaded.predict_B(A, z) - loaded.predict_B(A, z)).abs().max())
    if fig["upstream_round_trip_max_abs_err"] > P10_PREDICT_ATOL:
        raise AssertionError("predict_B after the upstream round trip: %r"
                             % fig["upstream_round_trip_max_abs_err"])
    resumed = counted("imported, resumed", p10_train_expected(
        width, batch, [batch] * steps), lambda: train_model(argv=_p10_argv(
            npz, ckpt, "imported", device, width, p,
            ["--continue_train"])))
    text = read_log(imported_expr)
    if "(epoch 0, step 0)" not in text or resumed.epoch != 1:
        raise AssertionError("the imported checkpoint did not resume: %s"
                             % text[:1000])
    _finite_loss_lines(text, "resumed run")

    # (g) a paired-jpg folder, where PIL is
    jpg = os.path.join(tmp, "p10_jpg")
    try:
        from PIL import Image
    except ImportError:
        os.makedirs(os.path.join(jpg, "train"))
        try:
            load_edges2shoes(jpg)
        except PILMissingError as e:
            fig["pil"] = "absent: %s" % e
            log("phase 10 (g): %s" % e)
        else:
            raise AssertionError("a paired-jpg folder loaded without PIL")
    else:
        rng = np.random.RandomState(13)
        for sub, n in (("train", p["jpg_dev"] + batch), ("val", 4)):
            os.makedirs(os.path.join(jpg, sub))
            for i in range(n):
                Image.fromarray((rng.rand(64, 128, 3) * 255).astype(
                    np.uint8)).save(os.path.join(jpg, sub, "%d.jpg" % i))
        counted("paired jpg", p10_train_expected(width, batch, [batch]),
                lambda: train_model(argv=_p10_argv(
                    jpg, ckpt, "jpg", device, width,
                    dict(p, dev_size=p["jpg_dev"]))))
        fig["pil"] = "present: one epoch trained on a paired-jpg folder"
        log("phase 10 (g): PIL present, paired-jpg folder trained")

    if on_card and variants != expected:
        raise AssertionError("phase 10 launched the variants %r, the plan "
                             "picks %r" % (variants, expected))
    log("phase 10: launches by direction and shape %s, per variant %s"
        % (_json.dumps({d: {"%dx%dx%d" % sh: c for sh, c in
                            sorted(total[d].items())}
                        for d in ("fwd", "bwd")}), _json.dumps(variants)))
    log("phase 10: %s" % _json.dumps(fig))
    return total, variants, fig


def p11_rank_expected(job, batch, steps=P11_STEPS, width=CLI_WIDTH):
    """Launches of one rank of a phase-11 job by direction and (N, HW, C):
    the step at half the batch, ``steps`` times (under norm="batch" only
    netG_A_B's conditional norms, twice per step; the batch-norm pass has
    none)."""
    half, ngf, nb = batch // P11_RANKS, width["ngf"], width["n_blocks"]
    if job == "batch_norm":
        return {"fwd": {}, "bwd": {}}
    if job == "norm_batch":
        step = {s: 2 * c for s, c in gen_sites(half, "B", ngf, nb).items()}
    else:
        step = train_sites(half, nb, ngf, width["ndf"])
    return {d: {s: steps * c for s, c in step.items()} for d in ("fwd",
                                                                "bwd")}


def p11_eval_expected(batch, ubo_steps, width=CLI_WIDTH):
    """One rank of the sharded evaluation job: eval_mse_A (netG_B_A at half
    the batch) and the UBO's 1 + ``ubo_steps`` RMSprop steps (netG_A_B
    forward and backward at half the batch; the encoder has batch norms
    only)."""
    half, ngf, nb = batch // P11_RANKS, width["ngf"], width["n_blocks"]
    fwd, bwd = {}, {}
    _add(fwd, gen_sites(half, "A", ngf, nb))
    _add(fwd, gen_sites(half, "B", ngf, nb), 1 + ubo_steps)
    _add(bwd, gen_sites(half, "B", ngf, nb), 1 + ubo_steps)
    return {"fwd": fwd, "bwd": bwd}


def _loss_lines(text):
    """The loss and gnorm lines of a results.txt without their timings."""
    import re

    return [re.sub(r"time: [0-9.]+", "", ln) for ln in text.splitlines()
            if ln.startswith("(epoch:") or "gnorm_" in ln]


def _flax_round_trip(torch, fig, counters, account, sync, root, ckpt,
                     latest7, jax_latest, expr7, device, width):
    """Phase 11 (a) where msgpack is: the export's bytes open a msgpack
    map, the port's load of it equals the source tensor for tensor,
    ``predict_B`` bit for bit, and one resumed epoch from it."""
    import os

    from domain_transfer_gan_torch.cli.export_jax import \
        main as export_jax_main
    from domain_transfer_gan_torch.cli.train import train_model
    from domain_transfer_gan_torch.config import \
        load_train_config_from_expr_dir
    from domain_transfer_gan_torch.models import create_model
    from domain_transfer_gan_torch.utils.flax_msgpack import is_flax_bytes

    t0 = time.perf_counter()
    export_jax_main(["--chk_path", latest7, "--out", jax_latest,
                     "--device", device])
    fig["export_jax_s"] = time.perf_counter() - t0
    with open(jax_latest, "rb") as f:
        if not is_flax_bytes(f.read(4)):
            raise AssertionError("export_jax wrote no msgpack map")
    opt = load_train_config_from_expr_dir(expr7)
    src = create_model(opt, testing=True, device=device)
    src.load(latest7)
    dst = create_model(opt, testing=True, device=device)
    sync()
    t0 = time.perf_counter()
    dst.load(jax_latest)
    sync()
    fig["load_jax_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _equal_models(torch, src, dst, "the flax round trip")
    rng = np.random.RandomState(14)
    A = rng.uniform(-1, 1, (32, 64, 64, 3)).astype(np.float32)
    z = rng.randn(32, width["nlatent"]).astype(np.float32)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        fig["flax_round_trip_max_abs_err"] = float(
            (dst.predict_B(A, z) - src.predict_B(A, z)).abs().max())
    if fig["flax_round_trip_max_abs_err"] != 0.0:
        raise AssertionError("predict_B after the flax round trip: %r"
                             % fig["flax_round_trip_max_abs_err"])
    epoch, step = src.epoch, src.state.step
    del src, dst
    counters.reset()  # the resumed run of (a) starts here
    resumed = train_model(argv=_cli_argv(
        root, ckpt, device, width,
        ["--name", "from_jax", "--continue_train", "--niter_decay",
         str(epoch), "--eval_B_freq", "0"]))
    sync()
    account(counters.read(), getattr(counters, "variants", dict)(),
            "float32", cli_expected(width, 1, ubo=False),
            "flax resume")  # ends here
    with open(os.path.join(ckpt, "from_jax", "results.txt")) as f:
        text = f.read()
    steps = cli_expected(width, 1)["steps_per_epoch"]
    if "(epoch %d, step %d)" % (epoch, step) not in text or \
            (resumed.epoch, resumed.state.step) != (epoch + 1, step + steps):
        raise AssertionError("the flax latest did not resume: %s"
                             % text[:1000])
    _finite_loss_lines(text, "flax resumed run")
    fig["flax_resume_s"] = time.perf_counter() - t0
    del resumed


def _equal_models(torch, a, b, what, old_lr=None):
    """Every parameter, buffer, Adam moment and count, the pools, ``step``,
    ``epoch`` and ``old_lr`` (``a``'s, or the one given) of ``b`` those of
    ``a``."""
    for name, net in a.nets.items():
        theirs = b.nets[name].state_dict()
        x, y = a.state.opt_state[name], b.state.opt_state[name]
        if not all(torch.equal(v, theirs[k])
                   for k, v in net.state_dict().items()) \
                or x.count != y.count or not all(
                    torch.equal(s, t) for s, t in zip(x.mu + x.nu,
                                                      y.mu + y.nu)):
            raise AssertionError("%s changed %s" % (what, name))
    if set(a.state.pools) != set(b.state.pools) or any(
            not torch.equal(p.buf, b.state.pools[k].buf)
            or p.n != b.state.pools[k].n
            for k, p in a.state.pools.items()) or \
            set(a.state.ema) != set(b.state.ema) or any(
                not torch.equal(s, t) for k in a.state.ema
                for s, t in zip(a.state.ema[k], b.state.ema[k])) or \
            (a.state.step, a.epoch, a.old_lr if old_lr is None
             else old_lr) != (b.state.step, b.epoch, b.old_lr):
        raise AssertionError("%s changed the pools, the shadows or step / "
                             "old_lr / epoch" % what)


def _orbax_round_trip(torch, fig, counters, account, sync, root, ckpt,
                      latest7, expr7, device, width, smi):
    """Phase 11 (a)'s orbax arm: phase 7's model saved as the JAX package's
    orbax directory (``--ckpt_backend orbax``), one ``--continue_train``
    epoch of the training CLI from it with that backend, its ``latest``
    directory reloaded equal to the run's model and ``predict_B`` bit for
    bit; then the JAX-written fixture read on the card, each leaf held to
    its sha256, and one step from it against its plain-norm twin."""
    import hashlib
    import os

    from domain_transfer_gan_torch.cli.train import train_model
    from domain_transfer_gan_torch.config import TrainConfig, \
        load_train_config_from_expr_dir
    from domain_transfer_gan_torch.models import create_model
    from domain_transfer_gan_torch.ops.kernels import pad as P
    from domain_transfer_gan_torch.utils.orbax_dir import read_orbax

    opt = load_train_config_from_expr_dir(expr7)
    src = create_model(opt, testing=True, device=device)
    src.load(latest7)
    expr = os.path.join(ckpt, "from_orbax")
    os.makedirs(expr)
    src.opt.ckpt_backend, src.opt.expr_dir = "orbax", expr
    sync()
    t0 = time.perf_counter()
    src.save("latest")
    fig["orbax_save_s"] = time.perf_counter() - t0
    latest = os.path.join(expr, "latest")
    fig["orbax_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                             for d, _, fs in os.walk(latest) for f in fs)
    epoch, step, old_lr = src.epoch, src.state.step, src.old_lr
    del src
    pads = [w.launches for w in P.WRAPPERS]
    counters.reset()  # the resumed run of the orbax arm starts here
    t0 = time.perf_counter()
    resumed = train_model(argv=_cli_argv(
        root, ckpt, device, width,
        ["--name", "from_orbax", "--continue_train", "--niter_decay",
         str(epoch), "--eval_B_freq", "0", "--ckpt_backend", "orbax"]))
    sync()
    fig["orbax_resume_s"] = time.perf_counter() - t0
    account(counters.read(), getattr(counters, "variants", dict)(),
            "float32", cli_expected(width, 1, ubo=False),
            "orbax resume")  # ends here
    fig["orbax_resume_pad_launches"] = [
        w.launches - n for w, n in zip(P.WRAPPERS, pads)]
    if device == "cuda" and min(fig["orbax_resume_pad_launches"]) < 1:
        raise AssertionError("the orbax resume launched no pad kernel: %r"
                             % fig["orbax_resume_pad_launches"])
    with open(os.path.join(expr, "results.txt")) as f:
        text = f.read()
    steps = cli_expected(width, 1)["steps_per_epoch"]
    if "(epoch %d, step %d)" % (epoch, step) not in text or \
            (resumed.epoch, resumed.state.step) != (epoch + 1, step + steps):
        raise AssertionError("the orbax latest did not resume: %s"
                             % text[:1000])
    _finite_loss_lines(text, "orbax resumed run")
    back = create_model(load_train_config_from_expr_dir(expr), testing=True,
                        device=device)
    sync()
    t0 = time.perf_counter()
    back.load(latest)
    sync()
    fig["orbax_load_s"] = time.perf_counter() - t0
    # latest holds the lr of before its epoch's decay, the one it resumed at
    _equal_models(torch, resumed, back, "the orbax round trip", old_lr)
    rng = np.random.RandomState(15)
    A = rng.uniform(-1, 1, (32, 64, 64, 3)).astype(np.float32)
    z = rng.randn(32, width["nlatent"]).astype(np.float32)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True):
        fig["orbax_round_trip_max_abs_err"] = float(
            (back.predict_B(A, z) - resumed.predict_B(A, z)).abs().max())
    if fig["orbax_round_trip_max_abs_err"] != 0.0:
        raise AssertionError("predict_B after the orbax round trip: %r"
                             % fig["orbax_round_trip_max_abs_err"])
    del resumed, back

    # the JAX package's own orbax save (tests/fixtures/make_orbax_tiny.py)
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "orbax_tiny")
    with open(os.path.join(fixture, "leaves.json")) as f:
        want = json.load(f)
    t0 = time.perf_counter()
    tree = read_orbax(os.path.join(fixture, "latest"))
    fig["fixture_read_s"] = time.perf_counter() - t0
    got = {}

    def walk(node, keys=()):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, keys + (k,))
        else:
            got[".".join(keys)] = {
                "dtype": node.dtype.str, "shape": list(node.shape),
                "sha256": hashlib.sha256(node.tobytes("C")).hexdigest()}
    walk(tree)
    bad = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
    if bad:
        raise AssertionError("the fixture read on the card: %d of %d leaves "
                             "differ from their sha256, e.g. %r"
                             % (len(bad), len(want), bad[:5]))
    fig["fixture_leaves"] = len(got)
    fopt = load_train_config_from_expr_dir(fixture)
    cfg = {f: getattr(fopt, f) for f in TrainConfig.__dataclass_fields__
           if f != "expr_dir"}
    cfg["device"] = device
    rng = np.random.RandomState(16)
    A = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    B = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    z = rng.randn(4, fopt.nlatent).astype(np.float32)
    eps = rng.randn(4, fopt.nlatent).astype(np.float32)
    out = {}
    for plain in (False, True):
        m = create_model(TrainConfig(**cfg), testing=True, device=device)
        m.load(os.path.join(fixture, "latest"))
        losses, _, gnorms = m.train_instance(A, B, z, eps, plain_norm=plain)
        out[plain] = (_floats(losses), _floats(gnorms))
    sync()
    rl, rg = TRAIN_STEP1_RTOL["float32"]
    fig["fixture_step_losses"] = _held(out[False][0], out[True][0], rl,
                                       "the fixture's step, fused vs plain")
    fig["fixture_step_gnorms"] = _held(out[False][1], out[True][1], rg,
                                       "the fixture's step, fused vs plain")
    log("phase 11 (a) orbax: %s" % json.dumps(dict(
        {k: v for k, v in fig.items() if k.startswith(("orbax", "fixture"))},
        card=smi)))


def drive_phase11(torch, K, tmp, smi, device="cuda", width=CLI_WIDTH,
                  counters=None):
    """Phase 11.  (a) Phase 7's ``latest`` through ``cli.export_jax`` (the
    JAX package's flax format) and back through the port's ``load``: every
    parameter, buffer, Adam moment and count, ``step``, ``old_lr`` and
    ``epoch`` equal, ``predict_B`` bit for bit (cuDNN pinned); then one
    ``--continue_train`` epoch from an expr_dir whose ``latest`` is the flax
    file; then the orbax arm (:func:`_orbax_round_trip`).  (c) The training
    CLI as two processes
    (``--coordinator/--num_processes/--process_id``) on phase 7's data, one
    epoch with eval-A and eval-B: rank 0's artifacts are phase 7's, rank
    1's are under ``.worker1/``, the logged losses are equal on both ranks,
    the run's TEST_MSE_A is ``eval_mse_A`` of its ``latest`` in one process
    over the same batches and ``cli.test --metric mse`` is ``eval_mse_A`` at
    its batch.  (b) The data-parallel step: two ranks on the card over gloo
    (they share it), each a process on half the batch
    (``parallel/selfcheck.py``), against one process on the full batch with
    the same weights, data and noise, at phase 5's limits:
    ``aug_cycle_gan`` float32 at 32 and bfloat16 at 128, ``--norm batch``,
    ``--pool_size 50``, 2 steps each; one batch-norm pass at float32
    rounding; the sharded eval-A and UBO of (c)'s ``latest`` at the eval
    batch against one process (the UBO after one step within 1e-5, after
    50 within 1e-3).  Each rank's launches are held to the structure of the
    step at its half batch, and to the plan's variants.  With two or more
    cards the aug float32 job runs again over NCCL, one card per rank.
    (The ranks' wrappers count launches on the card only: on the CPU, where
    ``counters`` counts the plain versions in this process, the ranks'
    counts are not held.)  Returns (launches by dtype, direction and
    shape, per variant, the figures)."""
    import os
    import statistics

    from domain_transfer_gan_torch.cli import test as test_cli
    from domain_transfer_gan_torch.cli.export_jax import \
        main as export_jax_main
    from domain_transfer_gan_torch.config import \
        load_train_config_from_expr_dir
    from domain_transfer_gan_torch.data import AlignedIterator, \
        load_numpy_data
    from domain_transfer_gan_torch.eval import eval_mse_A
    from domain_transfer_gan_torch.models import create_model
    from domain_transfer_gan_torch.parallel import multihost, selfcheck
    from domain_transfer_gan_torch.utils.flax_msgpack import \
        MsgpackMissingError

    log("phase 11 on %s" % smi)
    on_card = device == "cuda"
    counters = counters or _Counters(K)
    totals = {n: {"fwd": {}, "bwd": {}} for n in ("float32", "bfloat16")}
    variants = {d: _no_launches() for d in ("fwd", "bwd")}
    expected = {d: _no_launches() for d in ("fwd", "bwd")}
    fig = {"card": smi}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def account(seen, by_variant, dtype, want, what, held=True):
        if held:
            _held_counts(seen, want, what)
        for d in ("fwd", "bwd"):
            _add(totals[dtype][d], seen[d])
        if on_card:
            _tally(K, seen, 4 if dtype == "float32" else 2, expected)
            for d, by in by_variant.items():
                for v, c in by.items():
                    variants[d][v] += c

    root = tmp + "/cli_data"
    expr7 = os.path.join(tmp, "cli_runs", "cli")
    latest7 = os.path.join(expr7, "latest")
    ckpt = os.path.join(tmp, "p11_runs")

    # (a) the port's latest -> the JAX package's format -> the port; where
    # msgpack is missing, the refusal by name instead
    jax_latest = os.path.join(ckpt, "from_jax", "latest")
    try:
        import msgpack
    except ImportError:
        try:
            export_jax_main(["--chk_path", latest7, "--out", jax_latest,
                             "--device", device])
        except MsgpackMissingError as e:
            fig["msgpack"] = "absent: %s" % e
        else:
            raise AssertionError("export_jax wrote a flax file without "
                                 "msgpack")
    else:
        fig["msgpack"] = "present: %s" % ".".join(map(str, msgpack.version))
    log("phase 11 (a): msgpack %s" % fig["msgpack"])
    if fig["msgpack"].startswith("present"):
        _flax_round_trip(torch, fig, counters, account, sync, root, ckpt,
                         latest7, jax_latest, expr7, device, width)
    _orbax_round_trip(torch, fig, counters, account, sync, root, ckpt,
                      latest7, expr7, device, width, smi)


    # (c) the training CLI as two processes on the card
    port = multihost.free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    # TF32 off in the ranks too, as in this process: the CLI keeps
    # PyTorch's default (cuDNN TF32 on), which the variable overrides
    env = dict(os.environ, PYTHONPATH=here, NVIDIA_TF32_OVERRIDE="0")
    argv = _cli_argv(root, ckpt, device, width, [
        "--name", "mp", "--niter", "1", "--niter_decay", "0",
        "--coordinator", "127.0.0.1:%d" % port,
        "--num_processes", str(P11_RANKS)])
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", P11_CLI_MAIN, *argv,
         "--process_id", str(r)], cwd=here, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(P11_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=P11_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    fig["two_process_cli_s"] = time.perf_counter() - t0
    if [p.returncode for p in procs] != [0] * P11_RANKS:
        raise AssertionError("two-process CLI: exit codes %r\n%s" % (
            [p.returncode for p in procs],
            "\n".join(o[-3000:] for o in outs)))
    expr = os.path.join(ckpt, "mp")
    worker = os.path.join(expr, ".worker1")
    mine = set(os.listdir(expr)) - {".worker1"}
    if mine != set(os.listdir(expr7)):
        raise AssertionError("two-process CLI: rank 0 wrote %r, phase 7 %r"
                             % (sorted(mine), sorted(os.listdir(expr7))))
    for d in CLI_VIS:
        if not [f for f in os.listdir(os.path.join(expr, d))
                if f.endswith(".png")]:
            raise AssertionError("two-process CLI: %s holds no PNG" % d)
    logs = []
    for d in (expr, worker):
        with open(os.path.join(d, "results.txt")) as f:
            logs.append(f.read())
    if "SPMD over 2 devices (data-parallel)" not in logs[0] or \
            "backend gloo" not in outs[0]:
        raise AssertionError("two-process CLI: %s" % logs[0][:1000])
    if _loss_lines(logs[0]) != _loss_lines(logs[1]) or \
            not _loss_lines(logs[0]):
        raise AssertionError("two-process CLI: the ranks logged other "
                             "losses")
    _finite_loss_lines(logs[0], "two-process run")
    mp_latest = os.path.join(expr, "latest")
    opt = load_train_config_from_expr_dir(expr)
    one = create_model(opt, testing=True, device=device)
    one.load(mp_latest)
    _, _, _, _, testA, testB = load_numpy_data(
        root, grid_size=64, dev_size=CLI_DATA["dev_size"])
    logged = float(np.load(os.path.join(expr, "history_mse_A.npy"))[-1][1])
    direct = eval_mse_A(AlignedIterator(testA, testB, batch_size=EVAL_BATCH),
                        one)
    fig["two_process_test_mse_A_vs_one_process"] = abs(logged - direct) / \
        direct
    out = test_cli.test_model(["--chk_path", mp_latest, "--dataroot", root,
                               "--metric", "mse", "--device", device])
    direct200 = eval_mse_A(
        AlignedIterator(testA, testB, batch_size=TEST_BATCH), one)
    fig["cli_test_mse_vs_eval_mse_A"] = abs(out["TEST_MSE_A"] - direct200) \
        / direct200
    if fig["two_process_test_mse_A_vs_one_process"] > 1e-6 or \
            fig["cli_test_mse_vs_eval_mse_A"] > 1e-6:
        raise AssertionError("two-process CLI: TEST_MSE_A %r vs %r; "
                             "cli.test %r vs %r" % (
                                 logged, direct, out["TEST_MSE_A"],
                                 direct200))
    del one

    # (b) the step over two ranks against one process on the full batch
    jobs = [dict(name=job, width=dict(width), batch=batch,
                 steps=P11_STEPS, compute_dtype=dtype, seed=2025, **flags)
            for _, job, dtype, batch, flags in P11_JOBS]
    jobs.append(dict(name="eval", width=dict(width), batch=EVAL_BATCH,
                     ubo_steps=UBO_STEPS, ckpt=mp_latest, seed=2025))
    labels = [j[0] for j in P11_JOBS] + ["eval_B"]
    t0 = time.perf_counter()
    singles = [selfcheck.run_job(device=device, **j) for j in jobs]
    fig["one_process_jobs_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = selfcheck.run_ranks(jobs, P11_RANKS, device,
                                timeout=P11_TIMEOUT)
    fig["two_rank_jobs_s"] = time.perf_counter() - t0
    _rank_pads("phase11", ranks)
    fig["steps"], failed = {}, []
    for i, (label, job) in enumerate(zip(labels, jobs)):
        dtype = job.get("compute_dtype", "float32")
        limits = selfcheck.LIMITS[dtype]
        try:
            worst = selfcheck.compare(singles[i], [r[i] for r in ranks],
                                      limits, params=False)
        except AssertionError as e:  # every job runs; all failures reported
            failed.append("%s: %s" % (label, e))
            worst = {"failed": str(e)}
        want = (p11_eval_expected(EVAL_BATCH, UBO_STEPS, width)
                if label == "eval_B"
                else p11_rank_expected(job["name"], job["batch"],
                                       width=width))
        for r, res in enumerate(ranks):
            account(res[i]["launches"], res[i]["launches_by_variant"], dtype,
                    want, "phase 11 %s rank %d" % (label, r), held=on_card)
        row = {"max_rel_dev": worst}
        if singles[i]["ms"]:
            later = slice(1, None)
            row["one_process_step_ms"] = statistics.median(
                singles[i]["ms"][later])
            row["rank_step_ms"] = [statistics.median(r[i]["ms"][later])
                                   for r in ranks]
            row["reduction_share"] = [
                r[i]["collective_s"] / (sum(r[i]["ms"]) / 1e3)
                for r in ranks]
        fig["steps"][label] = row
        log("phase 11 (b) %s: %s" % (label, json.dumps(row)))
    if failed:
        raise AssertionError("phase 11 (b): %s" % "; ".join(failed))
    if torch.cuda.device_count() >= 2 and on_card:
        nccl = selfcheck.run_ranks(jobs[:1], P11_RANKS, device,
                                   backend="nccl", timeout=P11_TIMEOUT)
        fig["nccl_aug_float32"] = selfcheck.compare(
            singles[0], [r[0] for r in nccl], selfcheck.LIMITS["float32"],
            params=False)
        fig["nccl_rank_step_ms"] = [statistics.median(r[0]["ms"][1:])
                                    for r in nccl]
        log("phase 11 (b): NCCL over %d cards: %s" % (
            P11_RANKS, json.dumps(fig["nccl_aug_float32"])))
    else:
        fig["nccl"] = ("not run: %d CUDA card(s) visible; NCCL refuses two "
                       "ranks on one device" % torch.cuda.device_count())
        log("phase 11 (b): NCCL %s" % fig["nccl"])
    log("phase 11: two ranks on one card over gloo are a correctness run, "
        "not a scaling figure (%s)" % smi)
    if on_card and variants != expected:
        raise AssertionError("phase 11 launched the variants %r, the plan "
                             "picks %r" % (variants, expected))
    log("phase 11: launches by dtype, direction and shape %s, per variant "
        "%s" % (json.dumps({n: {d: {"%dx%dx%d" % sh: c for sh, c in
                                    sorted(totals[n][d].items())}
                                for d in ("fwd", "bwd")}
                            for n in totals}), json.dumps(variants)))
    log("phase 11: %s" % json.dumps(fig))
    return totals, variants, fig


# ---------------------------------------------------------------------------
# phase 12: the space, model and pipe axes over ranks on the card, and the
# split forms of K1 and K2
# ---------------------------------------------------------------------------

P12_RANKS, P12_STEPS, P12_BATCH, P12_TIMEOUT = 2, 2, 32, 600


def half_rows(sites, spatial=2):
    """``sites`` by (N, HW, C) as a rank of a space axis of ``spatial``
    holds them: its 1 / ``spatial`` of every sample's rows."""
    out = {}
    _add(out, {(n, hw // spatial, c): k for (n, hw, c), k in sites.items()})
    return out


def split_sites(batch, n_blocks=3, ngf=32, ndf=64, hw=64, spatial=2):
    """Split norms per ``aug_cycle_gan`` train step on a rank of a space
    axis of ``spatial`` (no data axis: every rank has the whole batch), by
    (N, HW, C) of the rank's rows; each launches K1-split's two kernels and
    K2-split's two.  The generators' sites (two calls of each generator),
    and in the D phase's fake|real pass (N = 2 batch) and the G phase's
    (N = batch) D_A's three sites and D_B's first; D_B's second and third
    (15 and 14 rows at 64x64) gather all of H and run unsplit K1 / K2."""
    sites = {}
    for fn in ("B", "A"):
        _add(sites, half_rows(gen_sites(batch, fn, ngf, n_blocks, hw),
                              spatial), 2)
    for n in (2 * batch, batch):
        _add(sites, half_rows({s: 1 for s in disc_shapes(n, ndf, hw)[:4]},
                              spatial))
    return sites


def p12_split_shapes(width=CLI_WIDTH):
    """(N, HW, C) of a rank's rows at every split norm phase 12 runs at
    ``width`` under --spatial 2: its step's (64x64 at batch 32: the
    generator and discriminator sites) and its training CLI's evaluations'
    and visuals' (the generator sites at CLI_BATCHES)."""
    w = width
    step = split_sites(P12_BATCH, w["n_blocks"], w["ngf"], w["ndf"])
    return tuple(dict.fromkeys(
        tuple(sorted(step, reverse=True))
        + tuple(s for n in CLI_BATCHES for s in half_rows(
            gen_sites(n, "B", w["ngf"], w["n_blocks"])))))


# every shape a split kernel is checked and timed at: phase 12's, and a
# rank's rows of 256x256 at batch 8 (phase 9's 256x256 generator sites, H
# halved)
SPLIT_SHAPES = tuple(dict.fromkeys(
    p12_split_shapes() + tuple(half_rows(gen_sites(8, "B", hw=256)))))
SPLIT_HEADLINE = ((32, 512, 128), "float32")  # the trunk's sites
SPLIT_ULPS = 2.0  # bfloat16 outputs against the twin / the unsplit kernel
P12_JOBS = (  # (label, flags of parallel/selfcheck.py's run_job)
    ("pipeline_m2", dict(n_blocks=4, pipeline=2)),
    ("pipeline_m4", dict(n_blocks=4, pipeline=2, microbatches=4)),
    ("spatial", dict(spatial=2)),
    ("tensor", dict(tensor=2)),
)
P12_LABELS = tuple(label for label, _ in P12_JOBS)
P12_CLI = (("pp", ["--pipeline", "2", "--n_blocks", "4"]),
           ("sp", ["--spatial", "2"]))
# the training CLI as phase 12 (d) runs each rank: ``python -c P12_CLI_MAIN
# OUT.json ARGS...`` runs ``cli/train.py`` on ARGS and, at exit, writes the
# process's split norms and split-kernel launches by (N, HW, C), and the
# split-kernel launches by variant, to OUT.json
P12_CLI_MAIN = """
import json, runpy, sys
from domain_transfer_gan_torch.ops.kernels import instance_norm as K
out = sys.argv.pop(1)
try:
    runpy.run_module("domain_transfer_gan_torch.cli.train",
                     run_name="__main__", alter_sys=True)
finally:
    by = {w.__name__: w.launches_by_shape for w in K.SPLIT_WRAPPERS}
    by["split_norms"] = K.instance_norm_split.calls_by_shape
    with open(out, "w") as f:
        json.dump({"shapes": {k: [[list(s), c] for s, c in v.items()]
                              for k, v in by.items()},
                   "variants": {w.__name__: w.launches_by_variant
                                for w in K.SPLIT_WRAPPERS}}, f)
"""


def _split_cases():
    for shape in SPLIT_SHAPES:
        for dtype in ("float32", "bfloat16"):
            for affine in ("none", "channel", "sample"):
                for relu in (False, True):
                    # CIN's (N, C) maps take the unbiased variance
                    yield shape, dtype, affine == "sample", relu, affine


def _split_plans(K, shape, itemsize, arrays):
    """The plans a split reduction is checked and timed under: the cluster
    variant's (the one ``split_plan`` picks, or its K where it picks
    ``"rows"``) and the streaming ``"rows"`` kernel."""
    n, hw, c = shape
    return {"cluster": K.split_plan(n, hw, c, itemsize, arrays,
                                    K._sm_count(0), on_chip=True),
            "rows": K.SPLIT_ROWS}


def _split_picked(K, shape, itemsize, arrays):
    n, hw, c = shape
    return K.split_plan(n, hw, c, itemsize, arrays, K._sm_count(0))


SPLIT_VARIANTS = ("cluster", "rows")


def check_split_kernels(torch, K):
    """Phase 12's check of K1-split and K2-split: at every rank shape of
    ``SPLIT_SHAPES`` (a sample's rows cut in two halves, as two space ranks
    hold them), under each variant of the two reductions, each of the four
    launches against its plain twin on the same inputs, and the halves' y
    and dx, gathered, against unsplit K1 / K2 on the whole rows (K2 on the
    split's mean and rstd; the mean and rstd against K1's); the cluster
    variant launched twice, bit for bit the same.  float32 within FP32_ATOL
    (dx and the sums relative to their largest value), bfloat16 within
    SPLIT_ULPS.  Returns the largest errors, overall and per variant."""
    keys = ("y_float32", "dx_float32", "sums", "y_bfloat16_ulps",
            "dx_bfloat16_ulps")
    by_variant = {v: dict.fromkeys(keys, 0.0) for v in SPLIT_VARIANTS}
    held = dict.fromkeys(SPLIT_VARIANTS, 0)
    repeats = 0
    t0 = time.perf_counter()
    for case, (shape, name, unbiased, relu, affine) in enumerate(
            _split_cases()):
        n, hw, c = shape
        dtype = getattr(torch, name)
        x, scale, shift = _make_inputs(torch, (n, 2 * hw, c), dtype, affine,
                                       seed=5000 + case)
        g = torch.Generator(device="cuda").manual_seed(case)
        dy = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
        halves = [t.contiguous() for t in x.chunk(2, dim=1)]
        dys = [t.contiguous() for t in dy.chunk(2, dim=1)]
        y_ref, mean_ref, rstd_ref = K._launch(x, scale, shift, 1e-5,
                                              unbiased, relu)
        plans = {a: _split_plans(K, shape, x.element_size(), a)
                 for a in (1, 2)}
        for variant in SPLIT_VARIANTS:
            what = "%r %s unbiased=%s relu=%s affine=%s variant=%s" % (
                shape, name, unbiased, relu, affine, variant)
            p_stats, p_sums = plans[1][variant], plans[2][variant]
            errs, stats, same = [], [], []
            for h in halves:
                got = K.instance_norm_partial_stats(h, plan=p_stats)
                want = K.instance_norm_partial_stats_plain(h)
                errs += [_rel_err(a, b) for a, b in zip(got, want)]
                stats.append(got)
                if variant == "cluster":
                    again = K.instance_norm_partial_stats(h, plan=p_stats)
                    same += [torch.equal(a, b) for a, b in zip(got, again)]
            mean, m2, rows = K.combine_stats([t[0] for t in stats],
                                             [t[1] for t in stats],
                                             [hw, hw])
            corr = rows / (rows - 1) if unbiased else 1.0
            rstd = torch.rsqrt(m2 / rows * corr + 1e-5)
            ys = [K.instance_norm_apply(h, mean, rstd, scale, shift,
                                        relu=relu) for h in halves]
            yps = [K.instance_norm_apply_plain(h, mean, rstd, scale, shift,
                                               relu=relu) for h in halves]
            y = torch.cat(ys, dim=1)
            sums = []
            for h, d in zip(halves, dys):
                got = K.instance_norm_bwd_partial_sums(
                    h, d, mean, rstd, scale, shift, relu=relu, plan=p_sums)
                want = K.instance_norm_bwd_partial_sums_plain(
                    h, d, mean, rstd, scale, shift, relu=relu)
                errs += [_rel_err(got[0], want[0]),
                         _rel_err(got[1], want[1])]
                sums.append(got)
                if variant == "cluster":
                    again = K.instance_norm_bwd_partial_sums(
                        h, d, mean, rstd, scale, shift, relu=relu,
                        plan=p_sums)
                    same += [torch.equal(a, b) for a, b in zip(got, again)]
            if not all(same):
                raise AssertionError("split kernels: two launches of the "
                                     "cluster variant differ for " + what)
            repeats += len(same)
            tot_g = sums[0][0] + sums[1][0]
            tot_gx = sums[0][1] + sums[1][1]
            dxs = [K.instance_norm_bwd_apply_dx(
                h, d, mean, rstd, scale, shift, tot_g, tot_gx, rows,
                unbiased=unbiased, relu=relu) for h, d in zip(halves, dys)]
            dxps = [K.instance_norm_bwd_apply_dx_plain(
                h, d, mean, rstd, scale, shift, tot_g, tot_gx, rows,
                unbiased=unbiased, relu=relu) for h, d in zip(halves, dys)]
            # on the split's statistics: the ReLU mask of dx is
            # discontinuous in them, and they differ from the unsplit
            # kernel's by rounding
            dx_ref = K._launch_bwd(x, dy, mean.contiguous(),
                                   rstd.contiguous(), scale, shift, unbiased,
                                   relu)[0]
            dx = torch.cat(dxs, dim=1)
            scale_dx = dx_ref.float().abs().max().clamp_min(1e-30)
            checks = [
                torch.isfinite(y.float()).all()
                & torch.isfinite(dx.float()).all(),
                torch.stack(errs).max(),
                _rel_err(mean, mean_ref), _rel_err(rstd, rstd_ref),
                torch.stack([(a.float() - b.float()).abs().max()
                             for a, b in zip(ys, yps)]).max(),
                (y.float() - y_ref.float()).abs().max(),
                torch.stack([(a.float() - b.float()).abs().max()
                             for a, b in zip(dxs, dxps)]).max() / scale_dx,
                (dx.float() - dx_ref.float()).abs().max() / scale_dx,
                torch.stack([_bf16_ulps_apart(torch, a, b)[0]
                             for a, b in zip(ys, yps)]).max(),
                _bf16_ulps_apart(torch, y, y_ref)[0],
                torch.stack([_bf16_ulps_apart(torch, a, b)[0]
                             for a, b in zip(dxs, dxps)]).max(),
                _bf16_ulps_apart(torch, dx, dx_ref)[0]]
            (finite, e_sums, e_mean, e_rstd, e_y_twin, e_y_ref, e_dx_twin,
             e_dx_ref, u_y_twin, u_y_ref, u_dx_twin, u_dx_ref) = _read(
                 torch, *checks)
            if not finite:
                raise AssertionError("split kernels: non-finite output for "
                                     + what)
            worst = by_variant[variant]
            worst["sums"] = max(worst["sums"], e_sums, e_mean, e_rstd)
            if max(e_sums, e_mean, e_rstd) > BWD_SUM_RTOL:
                raise AssertionError("split kernels: partial sums / "
                                     "statistics off by %g, %g, %g for %s"
                                     % (e_sums, e_mean, e_rstd, what))
            if name == "float32":
                worst["y_float32"] = max(worst["y_float32"], e_y_twin,
                                         e_y_ref)
                worst["dx_float32"] = max(worst["dx_float32"], e_dx_twin,
                                          e_dx_ref)
                if max(e_y_twin, e_y_ref, e_dx_twin, e_dx_ref) > FP32_ATOL:
                    raise AssertionError(
                        "split kernels: y %g / %g, dx %g / %g (twin / "
                        "unsplit) for %s" % (e_y_twin, e_y_ref, e_dx_twin,
                                             e_dx_ref, what))
            else:
                worst["y_bfloat16_ulps"] = max(worst["y_bfloat16_ulps"],
                                               u_y_twin, u_y_ref)
                worst["dx_bfloat16_ulps"] = max(worst["dx_bfloat16_ulps"],
                                                u_dx_twin, u_dx_ref)
                if max(u_y_twin, u_y_ref, u_dx_twin, u_dx_ref) > SPLIT_ULPS:
                    raise AssertionError(
                        "split kernels: y %.2f / %.2f, dx %.2f / %.2f "
                        "bfloat16 ulp (twin / unsplit) for %s" % (
                            u_y_twin, u_y_ref, u_dx_twin, u_dx_ref, what))
            held[variant] += 1
    if set(held.values()) != {case + 1}:
        raise AssertionError("split kernels: cases held per variant %r of "
                             "%d" % (held, case + 1))
    out = {k: max(w[k] for w in by_variant.values()) for k in keys}
    out["cases"] = case + 1
    out["cluster_repeats_bit_equal"] = repeats
    out["by_variant"] = by_variant
    log("phase 12: split kernel check, %d cases at %d shapes under both "
        "variants in %.1f s: %s" % (case + 1, len(SPLIT_SHAPES),
                                    time.perf_counter() - t0,
                                    json.dumps(out)))
    return out


# x = 1000 + N(0, 0.1^2): the statistics of a one-pass sum of x and x^2
# would keep no digit of the variance (x^2 ~ 1e6 in float32 rounds by 0.06)
HIGH_MEAN_SHAPES = ((8, 32768, 32), SPLIT_HEADLINE[0])
RING_HIGH_MEAN_SHAPES = ((8, 65536, 32),)


def check_split_high_mean(torch, K):
    """The partial statistics of both variants of ``instance_norm_partial_
    stats`` on x = 1000 + N(0, 0.1^2), float32, at a 256x256 rank's shape
    and the headline, against a float64 reference of the same values: the
    cluster variant's one pass must keep its M2 within the plain twin's
    own float32 error (floored at one float32 ulp), as the twin's two
    passes do.  Returns the relative errors of M2 and the mean, per shape."""
    out = {}
    eps32 = 2.0 ** -23
    for shape in HIGH_MEAN_SHAPES:
        n, hw, c = shape
        h, w = _hw_split(hw)
        g = torch.Generator(device="cuda").manual_seed(n * hw + c)
        x = 1000.0 + 0.1 * torch.randn((n, h, w, c), generator=g,
                                       device="cuda")
        x64 = x.double().reshape(n, hw, c)
        mean64 = x64.mean(dim=1)
        m2_64 = ((x64 - mean64[:, None, :]) ** 2).sum(dim=1)

        def rel(got, want):
            return ((got.double() - want).abs() / want.abs()).max()

        row = {}
        plans = _split_plans(K, shape, 4, 1)
        ways = {"twin": K.instance_norm_partial_stats_plain(x)}
        for v in SPLIT_VARIANTS:
            ways[v] = K.instance_norm_partial_stats(x, plan=plans[v])
        x32 = x.reshape(n, hw, c)
        sumsq = (x32 * x32).mean(dim=1) - x32.mean(dim=1) ** 2
        errs = _read(torch, *[e for way in ways.values()
                              for e in (rel(way[1], m2_64),
                                        rel(way[0], mean64))],
                     rel(sumsq * hw, m2_64))
        for i, way in enumerate(ways):
            row[way] = {"m2_rel_err": errs[2 * i],
                        "mean_rel_err": errs[2 * i + 1]}
        row["sum_of_squares_m2_rel_err"] = errs[-1]
        out[str(shape)] = row
        limit = max(row["twin"]["m2_rel_err"], eps32)
        if row["cluster"]["m2_rel_err"] > limit:
            raise AssertionError(
                "split kernels: the cluster variant's M2 is %g off a float64 "
                "reference at %r on x = 1000 + N(0, 0.1^2), the twin's %g"
                % (row["cluster"]["m2_rel_err"], shape,
                   row["twin"]["m2_rel_err"]))
    # K1's ring route at a 256x256 generator site: its mean and rstd (the
    # finalizing epilogue of the same one pass), held as the twin's
    for shape in RING_HIGH_MEAN_SHAPES:
        n, hw, c = shape
        h, w = _hw_split(hw)
        g = torch.Generator(device="cuda").manual_seed(n * hw + c)
        x = 1000.0 + 0.1 * torch.randn((n, h, w, c), generator=g,
                                       device="cuda")
        x64 = x.double().reshape(n, hw, c)
        mean64 = x64.mean(dim=1)
        rstd64 = torch.rsqrt(((x64 - mean64[:, None, :]) ** 2).mean(dim=1)
                             + 1e-5)
        plan = _ring_route(K, shape, 4, 1)
        ways = {"twin": K.instance_norm_plain(x, None, None,
                                              return_stats=True)[1:],
                "ring": K._launch(x, None, None, 1e-5, False, False,
                                  plan=plan)[1:]}
        errs = _read(torch, *[((got.double() - want).abs()
                               / want.abs()).max()
                              for way in ways.values()
                              for got, want in zip(way, (mean64, rstd64))])
        row = {way: {"mean_rel_err": errs[2 * i],
                     "rstd_rel_err": errs[2 * i + 1]}
               for i, way in enumerate(ways)}
        out["ring " + str(shape)] = row
        limit = max(row["twin"]["rstd_rel_err"], eps32)
        if row["ring"]["rstd_rel_err"] > limit:
            raise AssertionError(
                "the ring route's rstd is %g off a float64 reference at %r "
                "on x = 1000 + N(0, 0.1^2), the twin's %g"
                % (row["ring"]["rstd_rel_err"], shape,
                   row["twin"]["rstd_rel_err"]))
    log("phase 12: partial statistics (and K1's ring route) on x = 1000 + "
        "N(0, 0.1^2) against float64 (relative errors): %s"
        % json.dumps(out))
    return out


def _split_bytes(shape, itemsize, arrays):
    n, hw, c = shape
    return arrays * n * hw * c * itemsize + 4 * n * c * 4


def _library_split_calls(torch, x, dy, mean, rstd, scale, shift, sum_g,
                         sum_gx, rows):
    """PyTorch's SyncBatchNorm primitives computing the split launches'
    functions (no ReLU; dx with the biased variance) on an NHWC slice, one
    call each, on the (1, N*C, HW) layout they take: each with the copies
    into that layout and, for an output of x's size, back to NHWC.  Returns
    {wrapper name: fn()} for the apply, the partial sums and dx."""
    n, h, w, c = x.shape

    def flat(t):  # (N, H, W, C) -> (1, N*C, HW), a copy
        return t.reshape(n, h * w, c).transpose(1, 2).reshape(1, n * c,
                                                               h * w)

    def back(t):  # the inverse, to NHWC
        return t.reshape(n, c, h * w).transpose(1, 2).reshape(n, h, w, c)

    def per_nc(t):  # an (N, C) or (C,) per-(sample, channel) value
        return t.expand(n, c).reshape(n * c)

    m, r, s_, t_ = per_nc(mean), per_nc(rstd), per_nc(scale), per_nc(shift)
    sum_dy = per_nc(sum_g)
    sum_dy_xmu = per_nc(sum_gx) / r  # sum dy * (x - mean)
    count = torch.tensor([rows], dtype=torch.int32, device=x.device)
    return {
        "instance_norm_apply": lambda: back(torch.batch_norm_elemt(
            flat(x), s_, t_, m, r, 1e-5)),
        "instance_norm_bwd_partial_sums":
            lambda: torch.batch_norm_backward_reduce(
                flat(dy), flat(x), m, r, s_, True, False, False)[:2],
        "instance_norm_bwd_apply_dx": lambda: back(
            torch.batch_norm_backward_elemt(flat(dy), flat(x), m, r, s_,
                                            sum_dy, sum_dy_xmu, count)),
    }


def _split_arrays(K):
    """The split reductions by name, each with the arrays it streams: 1
    (x) for K1-split's partial statistics, 2 (x and dy) for K2-split's
    partial sums."""
    return {w.__name__: i + 1 for i, w in enumerate(K.SPLIT_REDUCTIONS)}


def _split_plan_row(plan, n):
    return {"variant": plan.variant, "cluster": plan.cluster,
            "rows": plan.rows, "stages": plan.stages,
            "stage_rows": plan.stage_rows, "threads": plan.threads,
            "smem_bytes": plan.smem_bytes, "ctas": n * plan.cluster}


def time_split_kernels(torch, K, launches):
    """Per ``SPLIT_SHAPES`` shape, float32, (N, C) affine: each split
    launch's device time (a CUDA graph of calls rotating over buffers
    larger than L2) without the ReLU (dx with the biased variance) and with
    it (dx unbiased, as CIN's sites take it), its plain twin's without, the
    library call's without where one computes the same function
    (``torch.var_mean`` for the partial statistics, the SyncBatchNorm
    primitives of :func:`_library_split_calls` for the others, their layout
    copies included; each held first to the twin on the same inputs), and
    the byte bound.  ``launches``: phase 12's counts by name and shape."""
    rows = {w.__name__: [] for w in K.SPLIT_WRAPPERS}
    lib_err = 0.0
    for shape in SPLIT_SHAPES:
        n, hw, c = shape
        nbuf = _n_buffers(n * hw * c * 4 * 3)
        ins = [_make_inputs(torch, shape, torch.float32, "sample", 77 + i)
               for i in range(nbuf)]
        dys = [torch.randn_like(t[0]) for t in ins]
        # statistics and sums of the first input's rows (taken as a rank's
        # of 2 hw), so that the library calls can be held to the twins
        mean, m2 = K.instance_norm_partial_stats_plain(ins[0][0])
        rstd = torch.rsqrt(m2 / hw + 1e-5)
        sg, sgx = K.instance_norm_bwd_partial_sums_plain(
            ins[0][0], dys[0], mean, rstd, *ins[0][1:])
        x4 = [t[0].reshape(n, hw, c) for t in ins]
        libs = [_library_split_calls(torch, ins[i][0], dys[i], mean, rstd,
                                     *ins[i][1:], sg, sgx, 2 * hw)
                for i in range(nbuf)]
        twins = {
            "instance_norm_apply": K.instance_norm_apply_plain(
                ins[0][0], mean, rstd, *ins[0][1:]),
            "instance_norm_bwd_partial_sums": (sg, sgx),
            "instance_norm_bwd_apply_dx": K.instance_norm_bwd_apply_dx_plain(
                ins[0][0], dys[0], mean, rstd, *ins[0][1:], sg, sgx,
                2 * hw)}
        for name, want in twins.items():
            got = libs[0][name]()
            if name == "instance_norm_bwd_partial_sums":
                # the library's second sum is over dy * (x - mean)
                got = (got[0].reshape(n, c), got[1].reshape(n, c) * rstd)
                err = max(_read(torch, _rel_err(got[0], want[0]),
                                _rel_err(got[1], want[1])))
            else:
                err = _read(torch, _rel_err(got, want))[0]
            lib_err = max(lib_err, err)
            if err > BWD_SUM_RTOL:
                raise AssertionError("split kernels: the library call for "
                                     "%s is %g off the twin at %r"
                                     % (name, err, shape))

        def each(fn):
            return lambda i: fn(i % nbuf)

        calls = {  # name: (kernel(i, relu, plan), plain(i), library(i),
            #        arrays); the plan is the reductions' (None: the pick)
            "instance_norm_partial_stats": (
                lambda i, relu, plan=None: K.instance_norm_partial_stats(
                    ins[i][0], plan=plan),
                lambda i: K.instance_norm_partial_stats_plain(ins[i][0]),
                lambda i: torch.var_mean(x4[i], dim=1, correction=0), 1),
            "instance_norm_apply": (
                lambda i, relu, plan=None: K.instance_norm_apply(
                    ins[i][0], mean, rstd, *ins[i][1:], relu=relu),
                lambda i: K.instance_norm_apply_plain(
                    ins[i][0], mean, rstd, *ins[i][1:]),
                lambda i: libs[i]["instance_norm_apply"](), 2),
            "instance_norm_bwd_partial_sums": (
                lambda i, relu, plan=None: K.instance_norm_bwd_partial_sums(
                    ins[i][0], dys[i], mean, rstd, *ins[i][1:], relu=relu,
                    plan=plan),
                lambda i: K.instance_norm_bwd_partial_sums_plain(
                    ins[i][0], dys[i], mean, rstd, *ins[i][1:]),
                lambda i: libs[i]["instance_norm_bwd_partial_sums"](), 2),
            "instance_norm_bwd_apply_dx": (
                lambda i, relu, plan=None: K.instance_norm_bwd_apply_dx(
                    ins[i][0], dys[i], mean, rstd, *ins[i][1:], sg, sgx,
                    2 * hw, unbiased=relu, relu=relu),
                lambda i: K.instance_norm_bwd_apply_dx_plain(
                    ins[i][0], dys[i], mean, rstd, *ins[i][1:], sg, sgx,
                    2 * hw),
                lambda i: libs[i]["instance_norm_bwd_apply_dx"](), 3),
        }
        for name, (fn, plain, lib, arrays) in calls.items():
            bound = _split_bytes(shape, 4, arrays) / HBM_BYTES_PER_S * 1e3
            row = {"shape": list(shape), "dtype": "float32"}
            if name in _split_arrays(K):
                # both variants, one after the other
                plans = _split_plans(K, shape, 4, arrays)
                row["rows_ms"], row["cluster_ms"] = (_time_device(
                    torch, each(lambda i, fn=fn, p=plans[v]: fn(i, False, p)))
                    for v in ("rows", "cluster"))
                row["variant"] = _split_picked(K, shape, 4, arrays).variant
                row["plan"] = _split_plan_row(plans["cluster"], shape[0])
                row["kernel_ms"] = row[row["variant"] + "_ms"]
            else:
                row["kernel_ms"] = _time_device(torch, each(
                    lambda i, fn=fn: fn(i, False)))
            row.update({
                "kernel_relu_ms": _time_device(torch, each(
                    lambda i, fn=fn: fn(i, True))),
                "plain_ms": _time_device(torch, each(plain)),
                "library_ms": _time_device(torch, each(lib)),
                "bound_ms": bound, "bound_by": "bytes",
                "launches": launches.get(name, {}).get(shape, 0)})
            rows[name].append(row)
        del ins, dys, x4, libs, twins
    log("phase 6: the split kernels' library calls agree with the twins "
        "within %g" % lib_err)
    return rows


def p12_test_mse(torch, root, expr, device):
    """One process loads the run's ``latest`` and scores it: its
    ``TEST_MSE_A`` against ``eval_mse_A`` over the same batches."""
    import os

    from domain_transfer_gan_torch.config import \
        load_train_config_from_expr_dir
    from domain_transfer_gan_torch.data import AlignedIterator, \
        load_numpy_data
    from domain_transfer_gan_torch.eval import eval_mse_A
    from domain_transfer_gan_torch.models import create_model

    opt = load_train_config_from_expr_dir(expr)
    opt.spatial = opt.tensor = opt.pipeline = opt.microbatches = 0
    one = create_model(opt, testing=True, device=device)
    one.load(os.path.join(expr, "latest"))
    _, _, _, _, testA, testB = load_numpy_data(
        root, grid_size=64, dev_size=CLI_DATA["dev_size"])
    logged = float(np.load(os.path.join(expr, "history_mse_A.npy"))[-1][1])
    direct = eval_mse_A(AlignedIterator(testA, testB, batch_size=EVAL_BATCH),
                        one)
    return logged, direct


def drive_phase12(torch, K, tmp, smi, device="cuda", width=CLI_WIDTH):
    """Phase 12.  (a)-(c) Two ranks on the card over gloo
    (``parallel/selfcheck.py``), each a process, against one process on the
    full batch with the same weights, data and noise, 2 ``aug_cycle_gan``
    float32 steps at 32 each, at phase 5's limits: ``--pipeline 2
    --n_blocks 4`` with M = 2 and M = 4, ``--spatial 2`` (the split
    kernels on the main path), ``--tensor 2`` (each rank's bytes of
    parameters, Adam moments and shadows against one process's).  (d) The
    training CLI as two processes on phase 7's data, one epoch with
    ``--pipeline 2 --n_blocks 4`` and one with ``--spatial 2`` (eval-A on,
    eval-B off): both ranks log the same losses, and one process loads
    each run's ``latest`` and scores it to its ``TEST_MSE_A`` (≤ 1e-6).
    Returns (K1 / K2 launches by direction and shape, per variant, the
    split launches by name and shape, the figures)."""
    import os
    import statistics

    from domain_transfer_gan_torch.parallel import multihost, selfcheck

    log("phase 12 on %s" % smi)
    fig = {"card": smi}
    totals = {"fwd": {}, "bwd": {}}
    variants = {d: _no_launches() for d in ("fwd", "bwd")}
    split = {w.__name__: {} for w in K.SPLIT_WRAPPERS}
    split_var = {w.__name__: {} for w in K.SPLIT_WRAPPERS}
    jobs = [dict(name="aug", width=dict(width), batch=P12_BATCH,
                 steps=P12_STEPS, seed=2027, **flags)
            for _, flags in P12_JOBS]
    t0 = time.perf_counter()
    singles = [selfcheck.run_job(device=device, **j) for j in jobs]
    fig["one_process_jobs_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = selfcheck.run_ranks(jobs, P12_RANKS, device, timeout=P12_TIMEOUT)
    fig["rank_jobs_s"] = time.perf_counter() - t0
    _rank_pads("phase12", ranks)
    failed = []
    fig["steps"] = {}
    for i, (label, _) in enumerate(P12_JOBS):
        try:
            worst = selfcheck.compare(singles[i], [r[i] for r in ranks],
                                      selfcheck.LIMITS["float32"],
                                      params=False)
        except AssertionError as e:
            failed.append("%s: %s" % (label, e))
            worst = {"failed": str(e)}
        row = {"max_rel_dev": worst,
               "one_process_step_ms": statistics.median(singles[i]["ms"][1:]),
               "rank_step_ms": [statistics.median(r[i]["ms"][1:])
                                for r in ranks],
               "one_process_bytes": singles[i]["bytes_held"],
               "rank_bytes": [r[i]["bytes_held"] for r in ranks]}
        for r in ranks:
            for d in ("fwd", "bwd"):
                _add(totals[d], r[i]["launches"][d])
                for v, c in r[i]["launches_by_variant"][d].items():
                    variants[d][v] += c
            for name, by in r[i]["split_launches"].items():
                _add(split[name], by)
            for name, by in r[i]["split_variants"].items():
                _add(split_var[name], by)
        row["split_norms"] = [r[i]["split_norms"] for r in ranks]
        row["trunk_runs"] = [r[i]["trunk_runs"] for r in ranks]
        fig["steps"][label] = row
        log("phase 12 %s: %s" % (label, json.dumps(row)))
    if failed:
        raise AssertionError("phase 12: %s" % "; ".join(failed))
    # every rank's split norms by shape are split_sites' (either device),
    # and on the card each split kernel launched once per split norm (the
    # wrappers count launches on the card only)
    want = {s: P12_STEPS * k for s, k in split_sites(
        P12_BATCH, width["n_blocks"], width["ngf"], width["ndf"]).items()}
    got = [r[P12_LABELS.index("spatial")]["split_shapes"] for r in ranks]
    if any(g != want for g in got):
        raise AssertionError("phase 12: --spatial 2 split norms by shape %r,"
                             " expected %r on each rank" % (got, want))
    if device == "cuda" and any(
            split[name] != {s: P12_RANKS * k for s, k in want.items()}
            for name in split):
        raise AssertionError("phase 12: --spatial 2 split launches %r"
                             % split)
    if not all(fig["steps"]["spatial"]["split_norms"]) or not all(
            n == 4 * P12_STEPS for label in ("pipeline_m2", "pipeline_m4")
            for n in fig["steps"][label]["trunk_runs"]):
        raise AssertionError("phase 12: a rank did not run its axis: %r"
                             % fig["steps"])
    tp_rows = fig["steps"]["tensor"]
    if max(tp_rows["rank_bytes"]) >= tp_rows["one_process_bytes"]:
        raise AssertionError("phase 12 (c): a rank holds %r bytes, one "
                             "process %d" % (tp_rows["rank_bytes"],
                                             tp_rows["one_process_bytes"]))
    log("phase 12 (c): bytes of parameters, Adam moments and shadows per "
        "rank %r against one process's %d" % (tp_rows["rank_bytes"],
                                             tp_rows["one_process_bytes"]))

    # (d) the training CLI as two processes per axis
    root = tmp + "/cli_data"
    ckpt = os.path.join(tmp, "p12_runs")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here, NVIDIA_TF32_OVERRIDE="0")
    fig["cli"] = {}
    for name, flags in P12_CLI:
        port = multihost.free_port()
        argv = _cli_argv(root, ckpt, device, width, [
            "--name", name, "--niter", "1", "--niter_decay", "0",
            "--eval_B_freq", "0", "--coordinator", "127.0.0.1:%d" % port,
            "--num_processes", str(P12_RANKS), *flags])
        t0 = time.perf_counter()
        counts = [os.path.join(tmp, "p12_%s_rank%d.json" % (name, r))
                  for r in range(P12_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", P12_CLI_MAIN, counts[r], *argv,
             "--process_id", str(r)], cwd=here, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(P12_RANKS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=P12_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        secs = time.perf_counter() - t0
        if [p.returncode for p in procs] != [0] * P12_RANKS:
            raise AssertionError("phase 12 (d) %s: exit codes %r\n%s" % (
                name, [p.returncode for p in procs],
                "\n".join(o[-3000:] for o in outs)))
        # the CLI's split launches count as the main path's; every shape
        # a split norm ran at is one the split check held
        norms = {}
        for path in counts:
            with open(path) as f:
                got = json.load(f)
            by = {k: {tuple(sh): c for sh, c in v}
                  for k, v in got["shapes"].items()}
            _add(norms, by.pop("split_norms"))
            for k, v in by.items():
                _add(split[k], v)
            for k, v in got["variants"].items():
                _add(split_var[k], v)
        shapes = p12_split_shapes(width)
        if set(norms) - set(shapes) or bool(norms) != (name == "sp"):
            raise AssertionError("phase 12 (d) %s: split norms at %r, "
                                 "expected at %r" % (name, sorted(norms),
                                                     shapes))
        fig["cli_split_norms_%s" % name] = sum(norms.values())
        expr = os.path.join(ckpt, name)
        logs = []
        for d in (expr, os.path.join(expr, ".worker1")):
            with open(os.path.join(d, "results.txt")) as f:
                logs.append(f.read())
        if "SPMD over 2 devices (data x space x model x pipe" not in logs[0]:
            raise AssertionError("phase 12 (d) %s: %s" % (name,
                                                          logs[0][:1000]))
        if _loss_lines(logs[0]) != _loss_lines(logs[1]) or \
                not _loss_lines(logs[0]):
            raise AssertionError("phase 12 (d) %s: the ranks logged other "
                                 "losses" % name)
        _finite_loss_lines(logs[0], "phase 12 (d) %s" % name)
        logged, direct = p12_test_mse(torch, root, expr, device)
        rel = abs(logged - direct) / direct
        fig["cli"][name] = {"s": secs, "test_mse_A_vs_one_process": rel}
        if rel > 1e-6:
            raise AssertionError("phase 12 (d) %s: TEST_MSE_A %r, one "
                                 "process %r" % (name, logged, direct))
        log("phase 12 (d) %s: %s" % (name, json.dumps(fig["cli"][name])))
    # every split launch took the variant split_plan picks for its shape
    # (float32 rows, aligned tensors: an unaligned one would show as
    # "rows" where the plan picks "cluster")
    if device == "cuda":
        for name, by in split.items():
            arrays = _split_arrays(K).get(name)
            want = {}
            for shape, k in by.items():
                v = _split_picked(K, shape, 4, arrays).variant \
                    if arrays else "rows"
                want[v] = want.get(v, 0) + k
            got = {v: k for v, k in split_var[name].items() if k}
            if got != want:
                raise AssertionError(
                    "phase 12: %s launched %r by variant, the plan picks %r"
                    % (name, got, want))
    fig["split_launches_by_variant"] = split_var
    log("phase 12: split launches by variant %s (each the plan's pick)"
        % json.dumps(split_var))
    log("phase 12: ranks sharing one card over gloo are a correctness run, "
        "not a scaling figure")
    return totals, variants, split, split_var, fig


# phase 13: the root entry points, the three SPMD axes at once, the repair
# of ROADMAP F5 (bit-stable pads) and the pad kernels themselves
P13_RANKS, P13_TIMEOUT = 8, 900
# conv0's pad at the published batch, and a residual block's
PAD_TIMED = (((32, 3, 64, 64), (3, 3, 3, 3)), ((32, 128, 32, 32),
                                                (1, 1, 1, 1)))
PAD_BWD_RTOL = 1e-6  # float32 dx vs F.pad's backward, relative to max |dx|
RANK_PADS = {}  # {phase: {wrapper: {shape: launches}}} of its selfcheck ranks


def pad_sites(n, dtype, hw=64, c_in=3, ngf=32):
    """(N, C, H, W, pads, mode, dtype) of a generator's pads at batch n:
    conv0's 3-pixel pad, the residual blocks' 1-pixel pads."""
    return [(n, c_in, hw, hw, (3,) * 4, "reflect", dtype),
            (n, 4 * ngf, hw // 2, hw // 2, (1,) * 4, "reflect", dtype)]


# every pad the main path launches: the generators' at each batch and dtype
# of phases 4-13, at 256x256, Livneh's one-channel B, a rank's rows under
# --spatial 2 (W pads only), the entry's width; phase 13 fails on any other
PAD_SHAPES = frozenset(
    [s for n in (5, 8, 10, 16, 19, 25, 30, 32, 50, 64, 100, 128, 150, 200,
                 250, 320) for s in pad_sites(n, "float32")]
    + [s for n in (32, 64, 128) for s in pad_sites(n, "bfloat16")]
    + pad_sites(8, "float32", 256) + pad_sites(32, "bfloat16", 256)
    + [(n, 1, 64, 64, (3,) * 4, "reflect", "float32") for n in (32, 100)]
    + [(n, c, h, w, (p, p, 0, 0), "reflect", "float32") for n in (4, 32)
       for c, h, w, p in ((3, 38, 64, 3), (128, 18, 32, 1))]
    + pad_sites(8, "float32", ngf=8)[1:]
    + pad_sites(4, "float32", ngf=4))  # phase 11 (a)'s orbax fixture


def _rank_pads(phase, ranks):
    """Add the pad launches of a phase's selfcheck ranks (each rank's total
    is in its last job's result) to RANK_PADS."""
    for r in ranks:
        for name, by in r[-1]["pad_launches"].items():
            _add(RANK_PADS.setdefault(phase, {}).setdefault(name, {}), by)


def eval_repeats(reps=2):
    """The selfcheck's eval job (full width, N = EVAL_BATCH, eval_mse_A and
    the UBO of 1 and UBO_STEPS RMSprop steps, one process, cuDNN pinned by
    the job) ``reps`` times: each run's numbers, and whether they repeat
    bit for bit."""
    from domain_transfer_gan_torch.parallel import selfcheck

    runs = []
    for _ in range(reps):
        r = selfcheck.run_job("eval", device="cuda", width=dict(CLI_WIDTH),
                              batch=EVAL_BATCH, ubo_steps=UBO_STEPS, seed=2025)
        runs.append([r["mse"]] + [r[k][v] for k in ("ubo1", "ubo")
                                  for v in ("ubo", "kld", "bpp")])
    return {"bit_equal": all(r == runs[0] for r in runs),
            "mse, ubo1 (ubo, kld, bpp), ubo (ubo, kld, bpp)": runs}


def step_repeats(torch):
    """One aug_cycle_gan float32 step at batch 32, twice from the same
    seed-drawn state, inputs and noise, cuDNN pinned: the parameters that
    differ after it (bit for bit), of how many."""
    A, B, (zs, *_) = train_inputs(32, TRAIN_CFG["nlatent"], 71)
    A, B, z, e = (torch.from_numpy(a).cuda() for a in (A, B) + zs)
    keep = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for _ in range(2):
            m = full_model()
            m.train_instance(A, B, z, e)
            runs.append([p.detach().clone() for net in m.state.nets.values()
                         for p in net.parameters()])
    finally:
        torch.backends.cudnn.deterministic = keep
    return sum(not torch.equal(a, b) for a, b in zip(*runs)), len(runs[0])


def check_pads(torch, P, shapes):
    """Both pad kernels against their plain versions (``F.pad`` and its
    backward, on the card) at every (N, C, H, W, pads, mode, dtype) of
    ``shapes``: the forward bit for bit, the backward within PAD_BWD_RTOL
    of max |dx| in float32 (bfloat16: within one ulp of the float32
    backward), and two backward launches bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(13)
    worst = {"bwd_float32": 0.0, "bwd_bfloat16_ulps": 0.0}
    cl = torch.channels_last
    for n, c, h, w, pads, mode, dtype in shapes:
        dt = getattr(torch, dtype)
        x = torch.randn((n, c, h, w), generator=g, device="cuda").to(dt)
        y = P.pad2d(x.contiguous(memory_format=cl), pads, mode)
        dy = torch.randn(y.shape, generator=g, device="cuda").to(
            dt).contiguous(memory_format=cl)
        dx, again = (P.pad2d_bwd(dy, x.shape, pads, mode) for _ in range(2))
        want = P.pad2d_bwd_plain(dy.float(), x.shape, pads, mode)
        what = "pad %r %r %s %s" % ((n, c, h, w), pads, mode, dtype)
        if not torch.equal(y, P.pad2d_plain(x, pads, mode)):
            raise AssertionError("%s: forward differs from F.pad" % what)
        if not torch.equal(dx, again):
            raise AssertionError("%s: backward does not repeat" % what)
        if dt == torch.float32:
            err = float((dx - want).abs().max() / want.abs().max())
            key, limit = "bwd_float32", PAD_BWD_RTOL
        else:
            err = float(((dx.float() - want.to(dt).float()).abs()
                         / _bf16_ulp(torch, want)).max())
            key, limit = "bwd_bfloat16_ulps", 1.0
        worst[key] = max(worst[key], err)
        if err > limit:
            raise AssertionError("%s: backward %g off (limit %g)"
                                 % (what, err, limit))
    return worst


def time_pads(torch, P):
    """Device ms of both pad kernels at PAD_TIMED (reflect, float32), in
    turns with their plain versions (``F.pad``'s forward and backward, the
    library calls too), beside the bound: x and y (dy and dx) moved once."""
    rows, cl = [], torch.channels_last
    for shape, pads in PAD_TIMED:
        n, c, h, w = shape
        out = (n, c, h + pads[2] + pads[3], w + pads[0] + pads[1])
        nbytes = 4 * (n * c * h * w + int(np.prod(out)))
        k = _n_buffers(nbytes)
        xs, dys = ([torch.randn(s, device="cuda").contiguous(
            memory_format=cl) for _ in range(k)] for s in (shape, out))
        calls = {"fwd": (lambda i: P._launch(xs[i % k], pads, "reflect"),
                         lambda i: P.pad2d_plain(xs[i % k], pads, "reflect")),
                 "bwd": (lambda i: P.pad2d_bwd(dys[i % k], shape, pads,
                                               "reflect"),
                         lambda i: torch.ops.aten.reflection_pad2d_backward(
                             dys[i % k], xs[i % k], list(pads)))}
        row = {"shape": list(shape), "pads": list(pads),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        for d in ("fwd", "bwd"):  # the kernel pad_plan picks there
            row[d + "_kernel"] = "band" if P.pad_plan(
                shape, pads, "reflect", 4, d == "bwd").rows else "words"
        for d, (kern, plain) in calls.items():
            t = [_time_device(torch, f) for f in (kern, plain, plain, kern)]
            row[d + "_ms"], row[d + "_plain_ms"] = (t[0] + t[3]) / 2, \
                (t[1] + t[2]) / 2
        rows.append(row)
    return rows


def drive_phase13(torch):
    """Phase 13: (a) ``entry()`` on the card, its example weights and
    seed-drawn "sane" ones, against the same net with plain norms; (b)
    ``dryrun_multichip(4)``; (c) the ``dp_sp_tp`` job (data x space x
    model, 2x2x2) over 8 ranks sharing the card at full width against one
    process at the float32 limits; (d) ROADMAP F5: the eval job twice in
    one process, bit for bit, and an aug_cycle_gan float32 step at 32
    twice from one state, every parameter bit-identical."""
    import __graft_entry_torch__ as ge
    from domain_transfer_gan_torch.config import TrainConfig
    from domain_transfer_gan_torch.models.state import build_networks
    from domain_transfer_gan_torch.parallel import selfcheck

    fig, t0 = {}, time.perf_counter()
    fn, (params, x, z) = ge.entry()
    sane = build_networks(TrainConfig(**dict(
        ge.ENTRY_CFG, init_scheme="sane")), torch.Generator().manual_seed(3))
    errs = []
    with torch.no_grad():
        for p in (params, {k: v.cuda() for k, v in
                           sane["netG_A_B"].state_dict().items()}):
            y = fn(p, x, z)
            _check_images(y.cpu().numpy(), 8, 64, 3, "entry()")
            errs.append(float((y - fn(p, x, z, plain_norm=True)).abs().max()))
    fig["entry_vs_plain_norms_max_abs_err"] = errs
    if max(errs) > SERVE_ATOL:
        raise AssertionError("entry() is %g from plain norms" % max(errs))
    t = time.perf_counter()
    fig["dryrun_multichip_4"] = ge.dryrun_multichip(4)
    fig["dryrun_multichip_4_s"] = time.perf_counter() - t
    job = dict(name="dp_sp_tp", width=dict(selfcheck.FULL))
    t = time.perf_counter()
    single = selfcheck.run_job(device="cuda", **job)
    fig["dp_sp_tp_one_process_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ranks = selfcheck.run_ranks([job], P13_RANKS, "cuda",
                                timeout=P13_TIMEOUT)
    fig["dp_sp_tp_8_ranks_s"] = time.perf_counter() - t
    _rank_pads("phase13", ranks)
    fig["dp_sp_tp_max_rel_dev"] = selfcheck.compare(
        single, [r[0] for r in ranks], selfcheck.LIMITS["float32"],
        params=False)
    fig["dp_sp_tp_rank_step_ms"] = [r[0]["ms"] for r in ranks]
    counts = [dict(r[0]["launches"], **r[0]["split_launches"]) for r in ranks]
    fig["dp_sp_tp_launches"] = {k: sum(sum(c[k].values()) for c in counts)
                                for k in counts[0]}  # each read from 0
    if not all(fig["dp_sp_tp_launches"].values()):
        raise AssertionError("phase 13: the ranks skipped a norm kernel")
    fig["eval_repeats"] = eval_repeats()
    fig["step_params_differing"] = step_repeats(torch)
    if not fig["eval_repeats"]["bit_equal"] or \
            fig["step_params_differing"][0]:
        raise AssertionError("F5: a repeat differs %s" % json.dumps(fig))
    fig["s"] = time.perf_counter() - t0
    log("phase 13: %s" % json.dumps(fig))
    return fig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print a torch.profiler breakdown and the "
                         "kernel's extra timings")
    ap.add_argument("--twin-seeds", type=int, default=0, metavar="N",
                    help="also repeat the training phase from N further "
                         "seeds and print, without holding them to the "
                         "limits, the deviations of the fused steps from "
                         "their plain-norm twins")
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
    from domain_transfer_gan_torch.ops.kernels import pad as P

    seconds, lap_at = {}, [time.perf_counter()]
    t_start = lap_at[0]

    def lap(phase):
        """The seconds since the last lap, as phase ``phase``'s."""
        now = time.perf_counter()
        seconds[phase], lap_at[0] = now - lap_at[0], now
        return seconds[phase]

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
    lap("1")

    # phase 2: build every kernel source from this checkout, together
    built = build.compile_all()
    build_s = lap("2")
    log("built %s in %.1f s" % (", ".join(built), build_s))

    # phase 3: kernels against their plain versions
    worst = check_kernel(torch, K)
    bwd_worst = check_bwd_kernel(torch, K)
    split_worst = check_split_kernels(torch, K)
    high_mean = check_split_high_mean(torch, K)
    lap("3")

    # the pad kernels' launches of each path, read from 0: by shape (its
    # selfcheck ranks' too), and by kernel (this process's)
    pads, pad_kernels = {}, {w.__name__: {} for w in P.WRAPPERS}

    def pads_of(phase):
        pads[phase] = {w.__name__: dict(w.launches_by_shape)
                       for w in P.WRAPPERS}
        for name, by in RANK_PADS.get(phase, {}).items():
            _add(pads[phase][name], by)
        for w in P.WRAPPERS:
            _add(pad_kernels[w.__name__], w.launches_by_kernel)
        P.reset_counts()

    # phase 4: the serving path
    P.reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        launches, serving_variants, site_counts, ctx = drive_serving_path(
            torch, K.instance_norm_fused, K.instance_norm_bwd_fused, tmp)
        if launches < 1:
            raise AssertionError("the serving path never launched the kernel")
        check_norm_sites(torch, ctx)
        jax_serving = serve_jax_exports(torch, K, P, ctx, smi)
        ctx["jax_dir"] = jax_serving["dir"]
        pads_of("serving")
        lap("4")

        # phase 5: the training path
        train_variants, train_counts, _ = drive_training_path(torch, K)
        train_fwd = sum(train_variants["fwd"].values())
        train_bwd = sum(train_variants["bwd"].values())
        if train_fwd < 1 or train_bwd < 1:
            raise AssertionError("the training path never launched a kernel")
        for i in range(args.twin_seeds):
            drive_training_path(torch, K, seed_offset=100 * (i + 1),
                                hold=False)
        pads_of("steps")
        lap("5")

        # phase 7: the training CLI, then export and serve from its
        # checkpoint (before phase 6, whose rows carry its launch counts)
        cli_counts, cli_variants, cli_served, _ = drive_training_cli(
            torch, K, tmp)
        cli_fwd = sum(cli_counts["fwd"].values())
        cli_bwd = sum(cli_counts["bwd"].values())
        served_fwd = sum(cli_served["fwd"].values())
        pads_of("training_cli")
        lap("7")

        # phase 8: the other variants' steps and the supervised step against
        # plain-norm twins, then one epoch of each through the training CLI
        # and the evaluation CLI on their checkpoints (before phase 6 too)
        p8_steps, p8_step_variants, _, _ = drive_variant_steps(torch, K)
        p8_cli, p8_cli_variants, bpp_counts, _ = drive_variants_cli(
            torch, K, tmp, smi=smi)
        p8 = {d: dict(p8_steps[d]) for d in ("fwd", "bwd")}
        for d in p8:
            _add(p8[d], p8_cli[d])
        p8_variants = {d: {v: p8_step_variants[d][v] + p8_cli_variants[d][v]
                           for v in p8_cli_variants[d]} for d in p8}
        p8_fwd, p8_bwd = (sum(p8[d].values()) for d in ("fwd", "bwd"))
        log("phase 8: %.1f s, launches %d forward, %d backward"
            % (lap("8"), p8_fwd, p8_bwd))
        pads_of("phase8")

        # phase 9: the step extras (gradient accumulation, the pool, EMA,
        # --remat) against plain-norm twins, then through the CLIs (before
        # phase 6 too)
        p9, p9_step_variants, p9_figures = drive_extras_steps(torch, K)
        p9_cli, p9_cli_variants, _ = drive_extras_cli(torch, K, tmp)
        for d in ("fwd", "bwd"):
            _add(p9["float32"][d], p9_cli[d])
        p9_variants = {d: {v: p9_step_variants[d][v] + p9_cli_variants[d][v]
                           for v in p9_cli_variants[d]}
                       for d in ("fwd", "bwd")}
        p9_fwd, p9_bwd = (sum(sum(p9[n][d].values()) for n in p9)
                          for d in ("fwd", "bwd"))
        log("phase 9: %.1f s, launches %d forward, %d backward"
            % (lap("9"), p9_fwd, p9_bwd))
        pads_of("phase9")

        # phase 10: the per-file data path, the host feed, the Livneh ETL,
        # upstream-checkpoint interop (before phase 6 too)
        p10, p10_variants, p10_figures = drive_phase10(torch, K, tmp, smi)
        p10_fwd, p10_bwd = (sum(p10[d].values()) for d in ("fwd", "bwd"))
        log("phase 10: %.1f s, launches %d forward, %d backward"
            % (lap("10"), p10_fwd, p10_bwd))
        pads_of("phase10")

        # phase 11: a run moved between packages (the JAX package's flax
        # and orbax checkpoints) and trained over two ranks (before phase 6 too)
        p11, p11_variants, p11_figures = drive_phase11(torch, K, tmp, smi)
        p11_fwd, p11_bwd = (sum(sum(p11[n][d].values()) for n in p11)
                            for d in ("fwd", "bwd"))
        log("phase 11: %.1f s, launches %d forward, %d backward"
            % (lap("11"), p11_fwd, p11_bwd))
        pads_of("phase11")

        # phase 12: the space, model and pipe axes over ranks, the split
        # kernels on the main path (the counts read from 0 in the ranks)
        p12, p12_variants, p12_split, p12_split_var, p12_figures = \
            drive_phase12(torch, K, tmp, smi)
        p12_fwd, p12_bwd = (sum(p12[d].values()) for d in ("fwd", "bwd"))
        p12_figures["s"] = lap("12")
        log("phase 12: %.1f s, launches %d forward, %d backward; split "
            "launches by shape %s" % (
                p12_figures["s"], p12_fwd, p12_bwd, json.dumps(
                    {k: {str(s): v for s, v in by.items()}
                     for k, by in p12_split.items()})))
        pads_of("phase12")

        # phase 13: the root entry points, dp x sp x tp over 8 ranks, F5;
        # then the pad kernels at every shape the paths gave them, timed
        p13 = drive_phase13(torch)
        pads_of("phase13")
        for phase, by in pads.items():
            if not by["pad2d"] or (phase != "serving" and not by["pad2d_bwd"]):
                raise AssertionError("%s never launched a pad kernel" % phase)
        other = {s for by in pads.values() for d in by.values()
                 for s in d} - PAD_SHAPES
        if other or not all(by["band"] for by in pad_kernels.values()):
            raise AssertionError("pads at %r (list them in PAD_SHAPES); "
                                 "by kernel %r" % (sorted(other, key=str),
                                                   pad_kernels))
        pad_worst = check_pads(torch, P, sorted(PAD_SHAPES, key=str))
        pad_rows = time_pads(torch, P)
        lap("13")

        # phase 6: times
        rows = time_kernel(torch, F, K, site_counts, train_counts,
                           cli_counts, p8, bpp_counts, extra=args.profile,
                           extras_counts=p9, p10_counts=p10,
                           p11_counts=p11)
        bwd_rows = time_bwd_kernel(torch, F, K, train_counts, cli_counts,
                                   p8, bpp_counts, extra=args.profile,
                                   extras_counts=p9, p10_counts=p10,
                                   p11_counts=p11)
        e2e = time_end_to_end(torch, ctx)
        e2e["phase4_jax_export"] = {k: v for k, v in jax_serving.items()
                                    if k != "dir"}
        e2e.update(time_train_step())
        e2e["phase9"] = p9_figures
        e2e["phase10"] = p10_figures
        e2e["phase11"] = p11_figures
        e2e["phase12"] = p12_figures
        e2e["phase13"] = p13
        split_rows = time_split_kernels(torch, K, p12_split)
        log("phase 6: split kernels (ms, twin, library, bound, phase 12 "
            "launches) %s" % json.dumps({"card": smi, "rows": split_rows}))
        e2e.update(time_ubo_step((EVAL_BATCH, TEST_BATCH)))
        prof = None
        if args.profile:
            prof = profile_forward(torch, ctx)
            prof["train_step"] = profile_train_step()
            for n in (EVAL_BATCH, TEST_BATCH):
                prof["ubo_step_b%d" % n] = profile_ubo_step(n)

    lap("6")

    def head_of(table):
        return next(r for r in table
                    if (tuple(r["shape"]), r["dtype"]) == HEADLINE)

    def per_step(direction):
        return {d: sum(v[direction].values())
                for d, v in train_counts.items()}

    head, bwd_head = head_of(rows), head_of(bwd_rows)
    pallas = "domain_transfer_gan_tpu/ops/pallas/instance_norm.py"
    kernels = {"kernels": [{
        "name": "instance_norm_fwd",
        "route": "cuda",
        "source": "domain_transfer_gan_torch/csrc/instance_norm.cu",
        "replaces": pallas + ":115",
        "launches": launches + train_fwd + cli_fwd + served_fwd + p8_fwd
        + p9_fwd + p10_fwd + p11_fwd + p12_fwd,
        "launches_serving_path": launches,
        "launches_training_path": train_fwd,
        "launches_training_cli": cli_fwd + served_fwd,
        "launches_phase8": p8_fwd,
        "launches_phase9": p9_fwd,
        "launches_phase10": p10_fwd,
        "launches_phase11": p11_fwd,
        "launches_phase12": p12_fwd,
        "launches_by_variant": {
            v: serving_variants[v] + train_variants["fwd"][v]
            + cli_variants["fwd"][v] + p8_variants["fwd"][v]
            + p9_variants["fwd"][v] + p10_variants["fwd"][v]
            + p11_variants["fwd"][v] + p12_variants["fwd"][v]
            for v in serving_variants},
        "max_abs_err": worst.overall("y_float32"),
        "max_err_bf16_ulps": worst.overall("y_bfloat16_ulps"),
        "check_by_variant": worst.summary(),
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
        "launches_per_train_step": per_step("fwd"),
        "shapes": rows,
    }, {
        "name": "instance_norm_bwd",
        "route": "cuda",
        "source": "domain_transfer_gan_torch/csrc/instance_norm_bwd.cu",
        "replaces": pallas + ":175",
        "launches": train_bwd + cli_bwd + p8_bwd + p9_bwd + p10_bwd
        + p11_bwd + p12_bwd,
        "launches_serving_path": 0,
        "launches_training_path": train_bwd,
        "launches_training_cli": cli_bwd,
        "launches_phase8": p8_bwd,
        "launches_phase9": p9_bwd,
        "launches_phase10": p10_bwd,
        "launches_phase11": p11_bwd,
        "launches_phase12": p12_bwd,
        "launches_by_variant": {
            v: train_variants["bwd"][v] + cli_variants["bwd"][v]
            + p8_variants["bwd"][v] + p9_variants["bwd"][v]
            + p10_variants["bwd"][v] + p11_variants["bwd"][v]
            + p12_variants["bwd"][v] for v in train_variants["bwd"]},
        "max_abs_err": bwd_worst.overall("dx_float32"),
        "max_err_bf16_ulps": bwd_worst.overall("dx_bfloat16_ulps"),
        "check_by_variant": bwd_worst.summary(),
        "shape": list(HEADLINE[0]), "dtype": HEADLINE[1],
        "ms": bwd_head["kernel_ms"],
        "plain_ms": bwd_head["plain_ms"],
        "bound_ms": bwd_head["bound_ms"],
        "bound_by": bwd_head["bound_by"],
        "library_ms": bwd_head["library_ms"],
        "launches_per_train_step": per_step("bwd"),
        "shapes": bwd_rows,
    }]}
    split_src = {"instance_norm_partial_stats": ("instance_norm.cu", ":115"),
                 "instance_norm_apply": ("instance_norm.cu", ":115"),
                 "instance_norm_bwd_partial_sums": ("instance_norm_bwd.cu",
                                                    ":175"),
                 "instance_norm_bwd_apply_dx": ("instance_norm_bwd.cu",
                                                ":175")}
    for name, (src, line) in split_src.items():
        head_row = next(r for r in split_rows[name]
                        if (tuple(r["shape"]), r["dtype"]) == SPLIT_HEADLINE)
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": "domain_transfer_gan_torch/csrc/" + src,
            "replaces": pallas + line,
            "launches": sum(p12_split[name].values()),
            "launches_phase12": sum(p12_split[name].values()),
            "launches_by_shape": {str(k): v
                                  for k, v in p12_split[name].items()},
            "max_abs_err": split_worst[
                "y_float32" if "apply" in name and "dx" not in name
                else "dx_float32" if "dx" in name else "sums"],
            "max_err_bf16_ulps": max(split_worst["y_bfloat16_ulps"],
                                     split_worst["dx_bfloat16_ulps"]),
            "check": split_worst,
            "launches_by_variant": p12_split_var[name],
            "launches_phase13": p13["dp_sp_tp_launches"][name],
            "shape": list(SPLIT_HEADLINE[0]), "dtype": SPLIT_HEADLINE[1],
            # without the ReLU: the function the library call computes
            "ms": head_row["kernel_ms"], "plain_ms": head_row["plain_ms"],
            "ms_relu": head_row["kernel_relu_ms"],
            "bound_ms": head_row["bound_ms"],
            "bound_by": head_row["bound_by"],
            "library_ms": head_row["library_ms"],
            "shapes": split_rows[name]})
        if name in _split_arrays(K):
            kernels["kernels"][-1].update({
                "variant": head_row["variant"],
                "cluster_ms": head_row["cluster_ms"],
                "rows_ms": head_row["rows_ms"],
                "plan_by_shape": {str(tuple(r["shape"])): dict(
                    r["plan"], variant=r["variant"])
                    for r in split_rows[name]}})
            if _split_arrays(K)[name] == 1:
                kernels["kernels"][-1]["high_mean"] = high_mean
    # every variant of both kernels that the plan picks at some shape of
    # the main path ran on it: the cluster one and the ring route.  The
    # counts are calls of the wrappers, each one launch but the ring
    # route's, which launches its ring and then its apply / dx
    for entry, d in zip(kernels["kernels"][:2], ("fwd", "bwd")):
        entry["launches_phase13"] = p13["dp_sp_tp_launches"][d]
        ring_calls = entry["launches_by_variant"]["ring"]
        entry["counts_are"] = "calls; a ring-route call is two launches"
        entry["ring_route_launches"] = 2 * ring_calls
        entry["kernel_launches"] = entry["launches"] + ring_calls
        for v in ("cluster", "ring"):
            if entry["launches_by_variant"][v] < 1:
                raise AssertionError("%s: the %s variant never launched on "
                                     "the main path" % (entry["name"], v))
    for name, d in (("pad2d", "fwd"), ("pad2d_bwd", "bwd")):
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": "domain_transfer_gan_torch/csrc/pad.cu",
            "replaces": "no TPU kernel (jnp.pad, domain_transfer_gan_tpu/"
            "ops/convs.py:29): a repair of F.pad's atomics, ROADMAP F5",
            "launches": sum(sum(by[name].values()) for by in pads.values()),
            "launches_by_path": {ph: sum(by[name].values())
                                 for ph, by in pads.items()},
            "launches_by_kernel": pad_kernels[name],
            "launches_by_shape": {str(s): sum(by[name].get(s, 0) for by in
                                              pads.values())
                                  for s in set().union(*(
                                      by[name] for by in pads.values()))},
            "max_abs_err": 0.0 if d == "fwd" else pad_worst["bwd_float32"],
            "check": pad_worst, "shape": pad_rows[0]["shape"],
            "pads": pad_rows[0]["pads"], "dtype": "float32",
            "ms": pad_rows[0][d + "_ms"],
            "plain_ms": pad_rows[0][d + "_plain_ms"],
            "bound_ms": pad_rows[0]["bound_ms"], "bound_by": "bytes",
            "library_ms": pad_rows[0][d + "_plain_ms"], "shapes": pad_rows})
    log(json.dumps({"end_to_end": e2e, "card": smi}))
    if prof is not None:
        log(json.dumps({"profile": prof, "card": smi}))
    log(json.dumps({"phase_seconds": seconds}))
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
