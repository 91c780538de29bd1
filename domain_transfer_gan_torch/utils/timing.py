"""Timers of the port's train and UBO steps on one CUDA card.

``time_train_step`` and ``time_ubo_step`` take wall time around steps that
end in one ``torch.cuda.synchronize()``; ``profile_train_step``,
``profile_ubo_step`` and ``profile_window`` run steps under
``torch.profiler`` and add up the device time of every kernel by name: the
device's busy milliseconds per step, its share of the step's wall time, and
the instance-norm kernels' part of it.  The steps are the published
configuration at full width (``TRAIN_CFG``) from seed-drawn weights and
inputs.  Every function needs a CUDA device: on a machine without one they
raise, they never time the CPU.

``chip_smoke.py`` prints these figures (phases 6 and 9); ``ring_sweeps.py
pads`` times the float32 step with the pad kernels and with ``F.pad``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

# the published model at full width, 64x64 (PERF.md section 4)
TRAIN_CFG = dict(model="aug_cycle_gan", grid_size=64, ngf=32, nef=32, ndf=64,
                 nlatent=16, n_blocks=3, input_nc=3, output_nc=3,
                 init_scheme="sane", seed=2025)
# each compute dtype at the batch its step is measured at
TRAIN_BATCH = {"float32": 32, "bfloat16": 128}
# the training CLI's eval batch and the evaluation CLI's bpp batch
UBO_BATCHES = (100, 200)
WARMUPS, TIMED = 3, 10


def train_inputs(batch: int, nlatent: int, seed: int, hw: int = 64):
    """A and B (NHWC in [-1, 1]) and three steps' (prior z, posterior
    noise) drawn from ``seed`` with numpy."""
    rng = np.random.RandomState(seed)
    A = rng.uniform(-1, 1, (batch, hw, hw, 3)).astype(np.float32)
    B = rng.uniform(-1, 1, (batch, hw, hw, 3)).astype(np.float32)
    zs = [(rng.randn(batch, nlatent).astype(np.float32),
           rng.randn(batch, nlatent).astype(np.float32)) for _ in range(3)]
    return A, B, zs


def full_model(**flags):
    """The published model at full width on the card (``TRAIN_CFG`` with
    ``flags``)."""
    from ..config import TrainConfig
    from ..models import create_model

    return create_model(TrainConfig(**dict(TRAIN_CFG, **flags)),
                        testing=True, device="cuda")


def card_inputs(batch: int, seed: int, hw: int = 64):
    """``train_inputs``' A and B on the card."""
    A, B, _ = train_inputs(batch, TRAIN_CFG["nlatent"], seed, hw)
    return torch.from_numpy(A).cuda(), torch.from_numpy(B).cuda()


def norm_ms(kernels: Dict[str, float]) -> float:
    """Milliseconds of the instance-norm kernels in {kernel name: us}."""
    return sum(v for k, v in kernels.items() if "instance_norm" in k) / 1e3


def top_kernels(kernels: Dict[str, float], n: int, width: int = 80):
    """The n largest entries of {kernel name: microseconds}, names cut to
    ``width`` characters (times of names that then coincide are added)."""
    short: Dict[str, float] = {}
    for k, v in kernels.items():
        short[k[:width]] = short.get(k[:width], 0.0) + v
    top = sorted(short.items(), key=lambda kv: -kv[1])[:n]
    return {k: round(v, 1) for k, v in top}


def profiled(step: Callable[[], object],
             reps: int) -> Tuple[float, Dict[str, float], float]:
    """``step()`` ``reps`` times under torch.profiler, ending in one
    synchronize: (wall ms of a step, {kernel name: device us per step},
    kernels launched per step)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
    kernels: Dict[str, float] = {}
    count = 0
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            kernels[ev.name] = kernels.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / reps
            count += 1
    return wall_ms, kernels, count / reps


def _busy(wall_ms: float, kernels: Dict[str, float], count: float,
          top: int, width: int) -> dict:
    busy_ms = sum(kernels.values()) / 1e3
    return {"step_wall_ms_under_profiler": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "device_kernels_per_step": count,
            # every variant of both instance-norm kernels, all launches
            "instance_norm_ms_per_step": norm_ms(kernels),
            # ATen's elementwise kernels differ only late in their names
            "kernels_us_per_step": top_kernels(kernels, top, width)}


def profile_window(step: Callable[[], object], reps: int) -> dict:
    """``step()`` ``reps`` times under torch.profiler: wall ms of a step,
    the device's busy ms (all kernels) and the instance norms' (K1 and K2,
    every variant and route) per step, and their shares."""
    wall_ms, kernels, _ = profiled(step, reps)
    busy_ms = sum(kernels.values()) / 1e3
    norm = norm_ms(kernels)
    return {"step_wall_ms_under_profiler": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "instance_norm_ms_per_step": norm,
            "instance_norm_share_of_busy": norm / max(busy_ms, 1e-9),
            "instance_norm_share_of_wall": norm / wall_ms,
            "norm_kernels_us_per_step": {
                k[:80]: round(v, 1) for k, v in sorted(
                    kernels.items(), key=lambda kv: -kv[1])
                if "instance_norm" in k}}


def step_ms(step: Callable[[], object]) -> float:
    """ms of a step: WARMUPS steps, then wall time around TIMED steps that
    end in one synchronize()."""
    for _ in range(WARMUPS):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / TIMED * 1e3


def time_train_step() -> dict:
    """train_step_ms, images/s and peak memory of the aug_cycle_gan step
    per dtype at its batch; the stoch_cycle_gan step and the supervised
    step in float32 at batch 32."""
    out = {"timed_steps": TIMED, "warmups": WARMUPS}
    for name, batch in TRAIN_BATCH.items():
        m = full_model(compute_dtype=name)
        A, B = card_inputs(batch, seed=14)
        torch.cuda.reset_peak_memory_stats()
        ms = step_ms(lambda: m.train_instance(A, B))
        out["train_step_ms_%s_b%d" % (name, batch)] = ms
        out["train_images_per_s_%s_b%d" % (name, batch)] = batch / ms * 1e3
        out["peak_memory_gb_%s_b%d" % (name, batch)] = \
            torch.cuda.max_memory_allocated() / 2 ** 30
        del m
        torch.cuda.empty_cache()
    batch = TRAIN_BATCH["float32"]
    A, B = card_inputs(batch, seed=14)
    for key, model, method in (
            ("train_step_ms_stoch_cycle_gan", "stoch_cycle_gan",
             "train_instance"),
            ("supervised_step_ms", "aug_cycle_gan",
             "supervised_train_instance")):
        m = full_model(model=model)
        step = getattr(m, method)
        out["%s_float32_b%d" % (key, batch)] = step_ms(lambda: step(A, B))
        del m
        torch.cuda.empty_cache()
    return out


def ubo_args(n: int, seed: int):
    """A model at full width and the arguments of
    ``eval.metrics.ubo_chunk`` at batch n (float32), from a seed."""
    m = full_model()
    nlat = TRAIN_CFG["nlatent"]
    A, B = card_inputs(n, seed)
    B = B + torch.rand_like(B) / 127.5
    mu = torch.zeros((n, nlat), device="cuda")
    lv = torch.full((n, nlat), -4.6, device="cuda")
    return m, (A, B, mu, lv, torch.zeros_like(mu), torch.zeros_like(lv),
               torch.full((1, 64, 64, 3), -4.6, device="cuda"),
               torch.ones(n, device="cuda"), 64 * 64 * 3.0)


def time_ubo_step(batches=UBO_BATCHES) -> dict:
    """ms of one UBO RMSprop step (netG_A_B forward + backward to z) at
    each batch: wall time around 20 steps that end in one synchronize(),
    after 3."""
    from ..eval import metrics

    out = {}
    for n in batches:
        m, args = ubo_args(n, seed=17)
        metrics.ubo_chunk(m, *args, 3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics.ubo_chunk(m, *args, 20)
        torch.cuda.synchronize()
        out["ubo_step_ms_b%d" % n] = (time.perf_counter() - t0) / 20 * 1e3
        del m, args
        torch.cuda.empty_cache()
    return out


def profile_train_step() -> dict:
    """Device time of one train step by kernel name: the aug_cycle_gan step
    per dtype at its batch, the stoch_cycle_gan step and the supervised
    step in float32 at batch 32; and the device-busy share of the step's
    wall time."""
    cases = [("%s_b%d" % (name, batch), "aug_cycle_gan", name, batch,
              "train_instance") for name, batch in TRAIN_BATCH.items()]
    cases += [("stoch_cycle_gan_float32_b32", "stoch_cycle_gan", "float32",
               32, "train_instance"),
              ("supervised_float32_b32", "aug_cycle_gan", "float32", 32,
               "supervised_train_instance")]
    out = {}
    for key, model, name, batch, method in cases:
        m = full_model(model=model, compute_dtype=name)
        step = getattr(m, method)
        A, B = card_inputs(batch, seed=15)
        for _ in range(WARMUPS):
            step(A, B)
        torch.cuda.synchronize()
        out[key] = _busy(*profiled(lambda: step(A, B), 3), top=24,
                         width=200)
        del m
        torch.cuda.empty_cache()
    return out


def profile_ubo_step(n: int) -> dict:
    """Device time of the UBO's RMSprop steps at batch n (float32, full
    width: one netG_A_B forward and backward to z each) by kernel name, and
    the device-busy share of the steps' wall time."""
    from ..eval import metrics

    m, args = ubo_args(n, seed=16)
    metrics.ubo_chunk(m, *args, 3)
    torch.cuda.synchronize()
    reps = 5  # steps of one chunk
    wall_ms, kernels, count = profiled(
        lambda: metrics.ubo_chunk(m, *args, reps), 1)
    return _busy(wall_ms / reps, {k: v / reps for k, v in kernels.items()},
                 count / reps, top=16, width=120)
