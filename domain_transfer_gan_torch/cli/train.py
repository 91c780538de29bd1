"""The training CLI of the port: the JAX package's ``cli/train.py`` on one
torch device (``--device``, default ``cuda``), for every ``--model`` and with
``--supervised`` (a supervised step on a paired batch of the first
``sup_frac`` of the train set after every unsupervised one, both on one
prior z draw).

Data, as the JAX CLI reads it: the npz bundles (``--numpy_data 1``, the
default), a paired-jpg edges2shoes folder (a ``train/`` directory and no
``trainA.npz``; needs PIL) or, with ``--numpy_data 0``, one file per sample
through the threaded ``data/folder.py::DataLoader`` (train at
``--batchSize`` with its short tail batch trained on, test and dev at 200,
the display's dev batches at 25, ``--nThreads`` workers).  The log names the
host reader (the native C++ one, or numpy and why).

The artifact contract is the JAX one, file for file: ``results.{txt,json}``,
``history_mse_A.npy`` / ``history_ubo_B.npy``, the ``latest`` / ``best_A`` /
``best_B`` checkpoints (the port's ``torch.save`` format, or under
``--ckpt_backend orbax`` the JAX package's orbax directories, which its
``--continue_train`` reads as well) with
``best_mse_A.txt`` / ``best_bpp_B.txt``, ``nets.txt``,
``opt.{txt,json,pkl}``, the vis dirs and their PNGs, and the source
snapshot.  Resume is real: ``--continue_train`` reloads ``which_epoch``,
continues at its epoch + 1 and keeps ``results.json`` and the histories.

The npz train set (and the supervised set) lives on the device when
``--device_data`` says so (1, or -1 with the set under
``--device_data_max_gb``): it is copied there once and each step gathers
its batch with ``index_select`` from the iterator's index vectors, the same
rows in the same order as the host feed.  Batches that come from the host
(``--device_data 0``, the per-file path) go through the prefetching feed
(``data/feed.py``: pinned buffers, a side stream, two batches ahead).

``--profile_dir DIR`` traces steps 10-14 of the first epoch with
``torch.profiler`` and writes a Chrome trace (``DIR/trace.json``; the JAX
CLI writes a TensorBoard trace instead).

    python -m domain_transfer_gan_torch.cli.train --dataroot DATA --name RUN \\
        --grid_size 64 [--device cuda]

The instance norms run the hand-written CUDA kernels on a CUDA device
whatever ``--use_pallas`` says (the flag is accepted and has no effect).
The step extras train as in the JAX package: ``--pool_size N`` (the
discriminators score a fake-image pool), ``--ema D`` (EMA shadows of the
generators and the encoder, in the checkpoints; ``--use_ema 1`` of the
evaluation and export CLIs scores them), ``--grad_accum K`` (K microbatches
per step, ``models/accum.py``) and ``--remat`` (the generators recompute
their activations in the backward).

Data parallelism over ranks, as the JAX CLI's mesh (``parallel/``): each
rank is a process with the whole model, computing on its slice of every
batch, the step over all of them the single-process step on the full
batch.  ``--num_devices N`` starts N local ranks (``spawn``), one card
each, over NCCL (0, the default, means every visible card, as in JAX; more
than are visible is refused); ``--device cpu --num_devices N`` runs N gloo
ranks on the CPU.  ``--coordinator host:port --num_processes P
--process_id R`` (or ``--coordinator auto`` under torchrun) runs this
process as rank R of P; ranks that share a card talk over gloo.  Rank 0
writes ``expr_dir``, rank R > 0 ``expr_dir/.workerR/`` (its own
checkpoints included, which its ``--continue_train`` reads).  Every rank
reads the same data with the same seeds (without ``--seed``, rank 0's
random one); with ``--device_data`` every rank's card holds the whole set
and gathers its own rows.  A batch that does not divide over the ranks is
computed whole on every rank (logged as JAX logs it).  ``--spatial S``,
``--tensor T`` and ``--pipeline P`` (with ``--microbatches M``) lay the
ranks out as the JAX CLI's ``data x space x model x pipe`` mesh
(``parallel/mesh.py``): images sliced by rows over S ranks, the large
weights by output channels over T, the residual trunks pipelined over P
stages; the batch divides over the data axis, or over ``(data, pipe)``.

A paired-jpg dataroot where PIL cannot be imported is refused by name
(``config.refuse_unported``), before anything is written.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import sys
import time
from shutil import copyfile

import numpy as np
import torch

from ..config import TrainConfig, TrainOptions, create_sub_dirs, \
    refuse_unported
from ..data import AlignedIterator, DataLoader, UnalignedIterator, \
    load_edges2shoes, native
from ..data.edges2shoes import is_paired_jpg_root
from ..data.feed import prefetch_to_device
from ..eval import eval_mse_A, eval_ubo_B, one_to_three_channels
from ..eval.visualize import (
    inference_grid,
    interleave_columns,
    multi_grid,
    save_image_grid,
    to_numpy,
)
from ..models import create_model
from ..parallel import DataParallel, multihost
from ..utils.artifacts import (
    copy_scripts_to_folder,
    format_log,
    print_log,
    save_results,
)
from ..utils.profiling import StepTimer

SUB_DIRS = ["vis_multi", "vis_cycle", "vis_latest", "train_vis_cycle"]


def visualize_cycle(opt, visuals, eidx, uidx, train):
    """6-column cycle grid."""
    imgs = [one_to_three_channels(to_numpy(v)[..., :3])
            for v in visuals.values()]
    grid = interleave_columns(imgs)
    save_dir = opt.train_vis_cycle if train else opt.vis_cycle
    save_path = os.path.join(save_dir, "cycle_%02d_%04d.png" % (eidx, uidx))
    save_image_grid(grid, save_path, nrow=len(imgs))
    copyfile(save_path, os.path.join(opt.vis_latest, "cycle.png"))


def visualize_multi(opt, real_A, model, eidx, uidx):
    """Same z-set across the batch."""
    grid = multi_grid(opt, real_A, model)
    save_path = os.path.join(opt.vis_multi,
                             "multi_%02d_%04d.png" % (eidx, uidx))
    save_image_grid(grid, save_path, nrow=opt.num_multi + 1)
    copyfile(save_path, os.path.join(opt.vis_latest, "multi.png"))


def visualize_inference(opt, real_A, real_B, model, eidx, uidx):
    """Posterior-z transfer grid."""
    grid, num = inference_grid(opt, real_A, real_B, model)
    save_path = os.path.join(opt.vis_inf, "inf_%02d_%04d.png" % (eidx, uidx))
    save_image_grid(grid, save_path, nrow=num + 1)
    copyfile(save_path, os.path.join(opt.vis_latest, "inf.png"))


def check_losses_finite(losses, epoch, step) -> None:
    """``--check_numerics``: read every loss (one sync per step, a debug
    mode) and raise naming the non-finite ones."""
    vals = dict(zip(losses, torch.stack(
        [torch.as_tensor(v, dtype=torch.float32).reshape(())
         for v in losses.values()]).tolist()))
    bad = [k for k, v in vals.items() if not np.isfinite(v)]
    if bad:
        raise FloatingPointError(
            "non-finite losses at epoch %d step %d: %s (values: %s)"
            % (epoch, step, bad, {k: vals[k] for k in bad}))


def _cycle(loader):
    """Endless passes over a loader, each a fresh iteration."""
    while True:
        yield from loader


def full_batches(it):
    """The batches of ``it`` whose A and B agree in size (on one device the
    JAX CLI drops only those; a short tail batch is trained on)."""
    for d in it:
        if len(d["A"]) == len(d["B"]):
            yield d


def start_profiler(device: torch.device):
    """A started ``torch.profiler`` over the host and, on a CUDA device, the
    card."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_profiler(prof, device: torch.device, out_dir: str):
    """Wait for the device, stop ``prof`` and write its Chrome trace to
    ``out_dir/trace.json``; returns the file's path and the count of the
    card's kernels in it (its ``kernel`` events)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        kernels = sum(e.get("cat") == "kernel"
                      for e in json.load(f)["traceEvents"])
    return path, kernels


def write_trace(out_f, prof, device: torch.device, out_dir: str) -> None:
    """:func:`stop_profiler`, then a log line that says how many of the
    card's kernels the trace holds, so that a card's run whose trace holds
    none (ROADMAP F7) is never silent."""
    _, kernels = stop_profiler(prof, device, out_dir)
    print_log(out_f, "profiler trace written to %s: %d kernel events of the "
              "card%s" % (out_dir, kernels, " (WARNING: none)"
                          if device.type == "cuda" and not kernels else ""))


def _device(opt) -> torch.device:
    """The run's device.  A CUDA device that is not there is an error: the
    CLI never falls back to the CPU."""
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device %s asks for CUDA, but torch.cuda.is_available() is "
            "False; pass --device cpu to train on the CPU" % opt.device)
    return device


def local_ranks(opt) -> int:
    """How many local ranks ``--num_devices`` asks this process to start:
    on CUDA 0 means every visible card, and more than are visible is
    refused; on the CPU 0 means one."""
    n = int(opt.num_devices or 0)
    if torch.device(opt.device).type != "cuda":
        return max(n, 1)
    cards = torch.cuda.device_count()
    if n > cards:
        raise ValueError("--num_devices %d asks for %d CUDA cards, but %d "
                         "are visible" % (n, n, cards))
    return max(n or cards, 1)


def train_model(opt: TrainConfig = None, argv=None):
    """Train as ``opt`` (or the flags ``argv``) says.  Returns the trained
    model, or None where this process only started the local ranks of
    ``--num_devices`` and waited for them."""
    if opt is None:
        opt = TrainOptions().parse(sub_dirs=SUB_DIRS, args=argv)
    else:
        refuse_unported(opt)
    if multihost.check_spec(opt.coordinator, opt.num_processes,
                            opt.process_id):
        if int(opt.num_devices or 0) > 1:
            raise ValueError("--num_devices %d with --num_processes: each "
                             "process runs one rank" % opt.num_devices)
        return _run_rank(opt, opt.process_id, opt.num_processes,
                         opt.coordinator, multihost.ranks_per_host(
                             opt.coordinator, opt.num_processes))
    n = local_ranks(opt)
    if n == 1:
        return _run_single(opt, _device(opt))
    import torch.multiprocessing as mp

    # spawn, not fork: no rank inherits this process's CUDA state
    mp.start_processes(_spawned_rank, args=(opt, n, "127.0.0.1:%d"
                                            % multihost.free_port()),
                       nprocs=n, start_method="spawn")
    return None


def _spawned_rank(rank: int, opt: TrainConfig, world: int, coordinator: str):
    _run_rank(opt, rank, world, coordinator, ranks_here=world)


def _rank_dir(opt: TrainConfig, rank: int) -> None:
    """Rank 0 writes ``expr_dir``, rank r > 0 ``expr_dir/.worker<r>/``."""
    if rank > 0 and not opt.expr_dir.endswith(".worker%d" % rank):
        opt.expr_dir = os.path.join(opt.expr_dir, ".worker%d" % rank)
    os.makedirs(opt.expr_dir, exist_ok=True)
    create_sub_dirs(opt, SUB_DIRS)


def _run_rank(opt: TrainConfig, rank: int, world: int, coordinator: str,
              ranks_here: int):
    """One rank: pick its device and the backend from the layout, join the
    group, train, leave."""
    opt = dataclasses.replace(opt)
    _rank_dir(opt, rank)
    device = torch.device(opt.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if device.type == "cuda":
        device = torch.device("cuda", multihost.local_rank(rank, cards))
        opt.device = str(device)
    backend = multihost.choose_backend(device.type, ranks_here, cards)
    device = _device(opt)
    if backend == "nccl":
        torch.cuda.set_device(device)
    print("rank %d of %d on %s, backend %s" % (rank, world, device, backend))
    multihost.initialize(coordinator, world, rank, backend=backend)
    try:
        if opt.seed is None:
            # the ranks must draw the same batches and noise: rank 0's
            # random seed, shared
            seed = torch.tensor([np.random.randint(2 ** 31) if rank == 0
                                 else 0], device=device)
            opt.seed = int(multihost.all_reduce_(seed))
        return _run_single(opt, device, backend=backend)
    finally:
        multihost.shutdown()


def _run_single(opt: TrainConfig, device: torch.device, backend=None):
    # resume appends to the prior run's log instead of truncating it
    out_f = open(os.path.join(opt.expr_dir, "results.txt"),
                 "a" if opt.continue_train else "w")
    try:
        if backend is not None:
            print_log(out_f, "rank %d of %d on %s (%s)" % (
                multihost.process_index(), multihost.process_count(),
                device, backend))
        return _train(opt, device, out_f)
    finally:
        out_f.close()


def _train(opt: TrainConfig, device: torch.device, out_f):
    copy_scripts_to_folder(opt.expr_dir)
    if opt.seed is not None:
        print("using random seed:", opt.seed)
        np.random.seed(opt.seed)

    # ----- data ---------------------------------------------------------
    trainA = None
    if opt.numpy_data:
        # load_edges2shoes reads the npz bundles, or a paired-jpg folder
        trainA, trainB, devA, devB, testA, testB = load_edges2shoes(
            opt.dataroot, size=opt.grid_size, dev_size=opt.dev_size,
            antialias=bool(opt.resize_antialias))
        if is_paired_jpg_root(opt.dataroot):
            print_log(out_f, "paired-jpg folder %s (PIL)" % opt.dataroot)
        train_dataset = UnalignedIterator(trainA, trainB,
                                          batch_size=opt.batchSize)
        test_dataset = AlignedIterator(testA, testB, batch_size=100)
        dev_dataset = AlignedIterator(devA, devB, batch_size=100)
        dev_cycle = itertools.cycle(AlignedIterator(devA, devB,
                                                    batch_size=25))
    else:
        train_dataset = DataLoader(opt, subset="train", unaligned=True,
                                   batchSize=opt.batchSize)
        test_dataset = DataLoader(opt, subset="val", unaligned=False,
                                  batchSize=200)
        dev_dataset = DataLoader(opt, subset="dev", unaligned=False,
                                 batchSize=200)
        dev_cycle = _cycle(DataLoader(opt, subset="dev", unaligned=False,
                                      batchSize=25))
    print_log(out_f, "host reader: %s" % native.reader_name())
    print_log(out_f, "#training images = %d" % len(train_dataset))
    print_log(out_f, "#test images = %d" % len(test_dataset))
    print_log(out_f, "#dev images = %d" % len(dev_dataset))

    if opt.supervised:
        if trainA is not None:
            sup_size = int(len(trainA) * opt.sup_frac)
            sup_dataset = AlignedIterator(trainA[:sup_size],
                                          trainB[:sup_size],
                                          batch_size=opt.batchSize)
        else:
            sup_dataset = DataLoader(opt, subset="train", unaligned=False,
                                     batchSize=opt.batchSize,
                                     fraction=opt.sup_frac)
            sup_size = len(sup_dataset)
        print_log(out_f, "#supervised images = %d" % sup_size)

    # ----- model --------------------------------------------------------
    model = create_model(opt, device=device, image_size=opt.grid_size)
    # the posterior-z grid needs the encoder
    vis_inf = opt.model == "aug_cycle_gan"
    if vis_inf:
        create_sub_dirs(opt, ["vis_inf"])
    print_log(out_f, "model [%s] was created" % type(model).__name__)

    resumed = False
    if opt.continue_train:
        chk = os.path.join(opt.expr_dir, opt.which_epoch)
        if os.path.exists(chk):
            model.load(chk)
            resumed = True
            print_log(out_f, "resumed from %s (epoch %d, step %d)"
                      % (chk, model.epoch, int(model.state.step)))
        else:
            print_log(out_f, "WARNING: --continue_train set but %s missing"
                      % chk)

    # the ranks as a data x space x model x pipe mesh (the JAX CLI's
    # arithmetic): batches slice over the data axis, or over (data, pipe)
    # jointly under a pipe axis
    n_dev = multihost.process_count()
    spatial, tensor, pipe = (int(opt.spatial or 0), int(opt.tensor or 0),
                             int(opt.pipeline or 0))
    per_data = max(spatial, 1) * max(tensor, 1) * max(pipe, 1)
    data_axis_size = max(n_dev // per_data, 1)
    batch_shards = data_axis_size * max(pipe, 1)
    if n_dev > 1 and opt.batchSize % batch_shards != 0:
        print_log(out_f, "WARNING: %d devices visible but batchSize %d does "
                  "not divide the batch-sharding axes (%d) — running "
                  "UNSHARDED on one device; --spatial/--tensor/--pipeline "
                  "are ignored" % (n_dev, opt.batchSize, batch_shards))
    elif n_dev > 1:
        model = DataParallel(model, num_devices=n_dev, spatial=spatial,
                             tensor=tensor, pipeline=pipe,
                             microbatches=int(opt.microbatches or 0))
        print_log(out_f, "SPMD over %d devices (%s)"
                  % (model.n_devices, model.mesh.describe()))
    dp = isinstance(model, DataParallel)

    total_steps = 0
    timer = StepTimer()
    results = {
        "best_dev_mse_A": sys.float_info.max,
        "best_test_mse_A": sys.float_info.max,
        "best_dev_bpp_B": sys.float_info.max,
        "best_test_bpp_B": sys.float_info.max,
    }
    results_path = os.path.join(opt.expr_dir, "results.json")
    if opt.continue_train and os.path.exists(results_path):
        # keep the best metrics of before the restart, so that a worse
        # epoch after it cannot overwrite best_A / best_B
        with open(results_path) as f:
            results.update(json.load(f))
    save_results(opt.expr_dir, results)
    # the per-epoch np.save writes the WHOLE list: start from the saved one
    history_mse_A, history_ubo_B = [], []
    if resumed:
        for name, hist in (("history_mse_A.npy", history_mse_A),
                           ("history_ubo_B.npy", history_ubo_B)):
            p = os.path.join(opt.expr_dir, name)
            if os.path.exists(p):
                hist.extend(tuple(row) for row in np.load(p))
    create_sub_dirs(opt, ["vis_pred_B"])

    # 'latest' is written at the END of epoch E with epoch=E: resume
    # continues at E+1
    start_epoch = model.epoch + 1 if resumed else opt.epoch_count

    # ----- device-resident train set ------------------------------------
    data_A = data_B = None
    if trainA is not None and opt.device_data:
        ds_bytes = trainA.nbytes + trainB.nbytes
        if opt.device_data == 1 or \
                ds_bytes <= opt.device_data_max_gb * (1 << 30):
            data_A = torch.from_numpy(trainA).to(device)
            data_B = torch.from_numpy(trainB).to(device)
            train_dataset.yield_indices = True
            where = "train set on %s (%.1f MB): on-device batch gather" % (
                device, ds_bytes / 2 ** 20)
            if opt.supervised:
                sup_dataset.data_A = torch.from_numpy(
                    sup_dataset.data_A).to(device)
                sup_dataset.data_B = torch.from_numpy(
                    sup_dataset.data_B).to(device)
                where += "; supervised set on %s (%.1f MB)" % (
                    device, 2 * sup_dataset.data_A.nbytes / 2 ** 20)
            print_log(out_f, where)
    if opt.supervised:
        sup_iter = itertools.cycle(iter(sup_dataset))

    losses = None
    profiler = None
    for epoch in range(start_epoch, opt.niter + opt.niter_decay + 1):
        model.epoch = epoch
        epoch_start_time = time.time()
        epoch_iter = 0

        if data_A is not None:
            feed = iter(train_dataset)  # index vectors only
        else:
            batches = full_batches(train_dataset)
            if dp:  # over ranks only whole batches, as the JAX mesh
                batches = (d for d in batches
                           if len(d["A"]) == opt.batchSize)
            feed = prefetch_to_device(batches, device)
        for i, data in enumerate(feed):
            n_batch = len(data["A_idx"] if data_A is not None else data["A"])
            # a steady-state window of the first epoch under --profile_dir
            if opt.profile_dir and epoch == start_epoch and i == 10:
                profiler = start_profiler(device)
            # the supervised step takes the same prior z draw as the
            # unsupervised one, so the loop draws it here
            prior_z = model.sample_prior_z(n_batch) if opt.supervised \
                else None
            if data_A is not None:
                out = model.train_instance_indexed(
                    data_A, data_B, data["A_idx"], data["B_idx"], prior_z)
            else:
                out = model.train_instance(data["A"], data["B"], prior_z)
            total_steps += opt.batchSize
            epoch_iter += opt.batchSize
            if opt.monitor_gnorm:
                losses, visuals, gnorms = out
            else:
                losses, visuals = out
            if profiler is not None and i == 14:
                write_trace(out_f, profiler, device, opt.profile_dir)
                profiler = None
            if opt.supervised:
                sup_data = next(sup_iter)
                # a supervised batch of another size gets a fresh draw
                sup_z = prior_z
                if len(sup_data["A"]) != n_batch:
                    sup_z = model.sample_prior_z(len(sup_data["A"]))
                sup_losses = model.supervised_train_instance(
                    sup_data["A"], sup_data["B"], sup_z)
            if opt.check_numerics:
                check_losses_finite(losses, epoch, i)
                if opt.supervised:
                    check_losses_finite(sup_losses, epoch, i)
            timer.tick(opt.batchSize)

            if opt.display_freq and total_steps % opt.display_freq == 0:
                uidx = epoch_iter // opt.batchSize
                if dp:
                    visuals = model.gather_visuals(visuals)
                visualize_cycle(opt, visuals, epoch, uidx, train=True)
                dev_data = next(dev_cycle)
                dev_A, dev_B = dev_data["A"], dev_data["B"]
                dev_z = model.sample_prior_z(dev_A.shape[0])
                dev_visuals = model.generate_cycle(dev_A, dev_B, dev_z)
                visualize_cycle(opt, dev_visuals, epoch, uidx, train=False)
                visualize_multi(opt, dev_A, model, epoch, uidx)
                if vis_inf:
                    visualize_inference(opt, dev_A, dev_B, model, epoch,
                                        uidx)

            if opt.print_freq and total_steps % opt.print_freq == 0:
                sec_per_item, img_per_sec, _, _ = timer.window(
                    sync_tensor=losses["D_A"])
                print_log(out_f, format_log(epoch, epoch_iter, losses,
                                            sec_per_item))
                if opt.supervised:
                    print_log(out_f, format_log(epoch, epoch_iter,
                                                sup_losses, sec_per_item,
                                                prefix=False))
                if opt.monitor_gnorm:
                    print_log(out_f, format_log(epoch, epoch_iter, gnorms,
                                                sec_per_item, prefix=False)
                              + "\n")
                print_log(out_f, "  throughput: %.1f images/sec" % img_per_sec)

        if profiler is not None:  # an epoch of under 15 steps
            write_trace(out_f, profiler, device, opt.profile_dir)
            profiler = None

        if opt.save_epoch_freq and epoch % opt.save_epoch_freq == 0:
            print_log(out_f, "saving the model at the end of epoch %d, "
                      "iters %d" % (epoch, total_steps))
            model.save("latest", async_save=True)

        # ----- evaluate mappings; a frequency of 0 means never -----------
        if opt.eval_A_freq and epoch % opt.eval_A_freq == 0:
            t = time.time()
            dev_mse_A = eval_mse_A(dev_dataset, model)
            test_mse_A = eval_mse_A(test_dataset, model)
            t = time.time() - t
            history_mse_A.append((dev_mse_A, test_mse_A))
            np.save(os.path.join(opt.expr_dir, "history_mse_A"),
                    history_mse_A)
            res_str_list = ["[%d] DEV_MSE_A: %.4f, TEST_MSE_A: %.4f, "
                            "TIME: %.4f" % (epoch, dev_mse_A, test_mse_A, t)]
            if dev_mse_A < results["best_dev_mse_A"]:
                with open(os.path.join(opt.expr_dir, "best_mse_A.txt"),
                          "w") as f:
                    f.write(res_str_list[0] + "\n")
                results["best_dev_mse_A"] = dev_mse_A
                results["best_test_mse_A"] = test_mse_A
                model.save("best_A")
                save_results(opt.expr_dir, results)
                res_str_list += ["*** BEST DEV A ***"]
            print_log(out_f, "\n".join(["-" * 60] + res_str_list + ["-" * 60]))

        if opt.eval_B_freq and epoch % opt.eval_B_freq == 0:
            t = time.time()
            steps = 1 if opt.model == "cycle_gan" else 50
            dev_ubo_B, dev_bpp_B, dev_kld_B = eval_ubo_B(
                dev_dataset, model, steps, True, "pred_B_%d" % epoch,
                opt.vis_pred_B)
            test_ubo_B, test_bpp_B, test_kld_B = eval_ubo_B(
                test_dataset, model, steps, False, "pred_B", opt.vis_pred_B)
            t = time.time() - t
            history_ubo_B.append((dev_ubo_B, dev_bpp_B, dev_kld_B,
                                  test_ubo_B, test_bpp_B, test_kld_B))
            np.save(os.path.join(opt.expr_dir, "history_ubo_B"),
                    history_ubo_B)
            res_str_list = ["[%d] DEV_BPP_B: %.4f, TEST_BPP_B: %.4f, "
                            "TIME: %.4f" % (epoch, dev_bpp_B, test_bpp_B, t)]
            if dev_bpp_B < results["best_dev_bpp_B"]:
                with open(os.path.join(opt.expr_dir, "best_bpp_B.txt"),
                          "w") as f:
                    f.write(res_str_list[0] + "\n")
                results["best_dev_bpp_B"] = dev_bpp_B
                results["best_test_bpp_B"] = test_bpp_B
                save_results(opt.expr_dir, results)
                model.save("best_B")
                res_str_list += ["*** BEST BPP B ***"]
            print_log(out_f, "\n".join(["-" * 60] + res_str_list + ["-" * 60]))

        print_log(out_f, "End of epoch %d / %d \t Time Taken: %d sec"
                  % (epoch, opt.niter + opt.niter_decay,
                     time.time() - epoch_start_time))

        if epoch > opt.niter:
            model.update_learning_rate()

    model.wait_for_saves()
    # wait for the device before returning, so that a caller's clock
    # around train_model sees the whole run
    if losses is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    return model


if __name__ == "__main__":
    train_model()
