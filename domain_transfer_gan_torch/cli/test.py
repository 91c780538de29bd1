"""The evaluation CLI of the port: the JAX package's ``cli/test.py`` on one
torch device (``--device``, default ``cuda``), on the data the run was
trained on: npz bundles, a paired-jpg folder (needs PIL) or, for a run
trained with ``--numpy_data 0``, the per-file set through
``data/folder.py::DataLoader`` (items read and transformed as batches are
drawn).

    python -m domain_transfer_gan_torch.cli.test --chk_path RUN/latest \\
        --dataroot DATA --metric {bpp,mse,visual,noise_sens,mvgauss,fid,z_div} \\
        [--res_dir test_res] [--train_logvar 1] [--use_ema 1] \\
        [--device cuda] [--fid_extractor EXTRACTOR.jaxexp]

The run's options are read back from the checkpoint's directory (its
``opt.json``), with ``seed`` set to 12345: ``random``, ``np.random`` and the
model's ``torch.Generator`` are seeded from it, so repeated runs draw the
same batches and noise.  Data: a 20 % train subset at batch 200 (for
``--train_logvar``), test and dev at batch 200.
What each metric prints and writes under ``expr_dir/res_dir``:

- ``bpp``: fits logvar_B on the train subset (``--train_logvar 1``), then
  500 UBO steps per test batch; ``TEST_BPP_B: ...``, ``test_pred_B_*.png``;
- ``mse``: ``DEV_MSE_A: ..., TEST_MSE_A: ...``;
- ``visual``: on one dev batch of 10 with 5 samples per grid,
  ``cycle_0.png``, ``multi_0.png``, ``cycle_B_multi_0.png``,
  ``multi_cycle_0.png`` and, for ``aug_cycle_gan``, ``inf_0.png``;
- ``noise_sens``: ``noise_sens.npy``;
- ``mvgauss``: ``MVGauss BPP: ...``, ``mvgauss_bpp.txt``;
- ``fid``: ``PROXY_FID_B: ...``, ``fid.txt`` (the JAX package's
  random-feature extractor, stored with ``eval/fid.py``); with
  ``--fid_extractor F`` (a ``jax.export`` artifact of the JAX package's
  ``save_extractor``, run by ``eval/stablehlo.py`` on the same device)
  ``FID_B: ...`` instead;
- ``z_div``: ``Z_DIV_RATIO: ...``, ``z_diversity.json`` (strict JSON, NaN
  written as null).

``--use_ema 1`` scores the EMA shadows of a run trained with ``--ema`` (and
refuses a checkpoint without them).  Refused by name: a paired-jpg
dataroot where PIL cannot be imported (``PILMissingError``), and an
``--fid_extractor`` artifact that uses what the port does not run, before
any image is read.
"""

from __future__ import annotations

import json
import os
import random
import time

import numpy as np

from ..config import TestOptions, load_train_config_from_expr_dir
from ..data import AlignedIterator, DataLoader, UnalignedIterator, \
    load_edges2shoes
from ..data.edges2shoes import require_pil_for
from ..eval import (
    compute_bpp_mvgauss_B,
    eval_fid_B,
    eval_mse_A,
    eval_ubo_B,
    eval_z_diversity,
    one_to_three_channels,
    sensitivity_to_edge_noise,
    train_logvar,
)
from ..eval.fid import load_extractor
from ..eval.visualize import (
    cycle_B_multi_grid,
    inference_grid,
    interleave_columns,
    multi_cycle_grid,
    multi_grid,
    save_image_grid,
    to_numpy,
)
from ..models import create_model
from .train import _device

SEED = 12345
BPP_UBO_STEPS = 500  # RMSprop steps per test batch


def visualize_cycle(opt, visuals, name="cycle_test.png"):
    imgs = [one_to_three_channels(to_numpy(v)[..., :3])
            for v in visuals.values()]
    save_image_grid(interleave_columns(imgs),
                    os.path.join(opt.res_dir, name), nrow=len(imgs))


def visualize_multi_cycle(opt, real_B, model, name="multi_cycle_test.png"):
    grid = multi_cycle_grid(real_B, model, steps=4)
    save_image_grid(grid, os.path.join(opt.res_dir, name), nrow=9)


def visualize_cycle_B_multi(opt, real_B, model,
                            name="cycle_B_multi_test.png"):
    save_image_grid(cycle_B_multi_grid(opt, real_B, model),
                    os.path.join(opt.res_dir, name), nrow=opt.num_multi + 2)


def visualize_multi(opt, real_A, model, name="multi_test.png"):
    save_image_grid(multi_grid(opt, real_A, model),
                    os.path.join(opt.res_dir, name), nrow=opt.num_multi + 1)


def visualize_inference(opt, real_A, real_B, model, name="inf_test.png"):
    grid, num = inference_grid(opt, real_A, real_B, model)
    save_image_grid(grid, os.path.join(opt.res_dir, name), nrow=num + 1)


def test_model(argv=None) -> dict:
    """Run one ``--metric``; returns the numbers it printed (empty for
    ``visual`` and ``noise_sens``, whose results are files)."""
    topt = TestOptions().parse(argv)
    device = _device(topt)
    extractor = None
    if topt.metric == "fid" and topt.fid_extractor:
        # checked whole before anything is read or written
        extractor = load_extractor(topt.fid_extractor, device=device)
    random.seed(SEED)
    np.random.seed(SEED)
    expr_dir = os.path.dirname(os.path.abspath(topt.chk_path))
    opt = load_train_config_from_expr_dir(expr_dir, dataroot=topt.dataroot,
                                          seed=SEED, device=topt.device)
    if opt.numpy_data:
        require_pil_for(opt.dataroot)
    opt.res_dir = os.path.join(expr_dir, topt.res_dir)
    os.makedirs(opt.res_dir, exist_ok=True)

    if opt.numpy_data:
        trainA, trainB, devA, devB, testA, testB = load_edges2shoes(
            opt.dataroot, size=opt.grid_size, dev_size=opt.dev_size,
            antialias=bool(opt.resize_antialias))
        sub = int(len(trainA) * 0.2)  # upstream scores on a 20 % subset
        train_dataset = UnalignedIterator(trainA[:sub], trainB[:sub],
                                          batch_size=200)
        test_dataset = AlignedIterator(testA, testB, batch_size=200)
        dev_dataset = AlignedIterator(devA, devB, batch_size=200)
        dev_vis = AlignedIterator(devA, devB, batch_size=10)
    else:
        # load_in_mem=False: each split reads and transforms its files only
        # when a metric iterates it
        train_dataset = DataLoader(opt, subset="train", unaligned=True,
                                   batchSize=200, fraction=0.2,
                                   load_in_mem=False)
        test_dataset = DataLoader(opt, subset="val", unaligned=False,
                                  batchSize=200, load_in_mem=False)
        dev_dataset = DataLoader(opt, subset="dev", unaligned=False,
                                 batchSize=200, load_in_mem=False)
        dev_vis = DataLoader(opt, subset="dev", unaligned=False,
                             batchSize=10, load_in_mem=False)
    print("#training images = %d" % len(train_dataset))
    print("#test images = %d" % len(test_dataset))
    print("#dev images = %d" % len(dev_dataset))

    model = create_model(opt, testing=True, device=device,
                         image_size=opt.grid_size)
    model.load(topt.chk_path)
    if topt.use_ema:
        if not model.state.ema:
            raise ValueError("--use_ema 1 needs a checkpoint trained with "
                             "--ema")
        model.swap_ema()
    out = {}

    if topt.metric == "bpp":
        logvar_B = None
        if topt.train_logvar:
            print("training logvar_B on training data...")
            logvar_B = train_logvar(train_dataset, model)
        print("evaluating on test set...")
        t = time.time()
        _, out["TEST_BPP_B"], _ = eval_ubo_B(
            test_dataset, model, BPP_UBO_STEPS, visualize=True,
            vis_name="test_pred_B", vis_path=opt.res_dir, logvar_B=logvar_B,
            verbose=True, compute_l1=True)
        print("TEST_BPP_B: %.4f, TIME: %.4f" % (out["TEST_BPP_B"],
                                                time.time() - t))

    elif topt.metric == "mse":
        out["DEV_MSE_A"] = eval_mse_A(dev_dataset, model)
        out["TEST_MSE_A"] = eval_mse_A(test_dataset, model)
        print("DEV_MSE_A: %.4f, TEST_MSE_A: %.4f" % (out["DEV_MSE_A"],
                                                      out["TEST_MSE_A"]))

    elif topt.metric == "visual":
        opt.num_multi = 5
        # upstream also stops after the first batch
        vis_data = next(iter(dev_vis))
        real_A, real_B = vis_data["A"], vis_data["B"]
        # the dev split may be smaller than 10: size z to the batch
        prior_z_B = model.sample_prior_z(real_A.shape[0])
        visualize_cycle(opt, model.generate_cycle(real_A, real_B, prior_z_B),
                        name="cycle_0.png")
        visualize_multi(opt, real_A, model, name="multi_0.png")
        visualize_cycle_B_multi(opt, real_B, model,
                                name="cycle_B_multi_0.png")
        visualize_multi_cycle(opt, real_B, model, name="multi_cycle_0.png")
        if opt.model == "aug_cycle_gan":
            visualize_inference(opt, real_A, real_B, model, name="inf_0.png")

    elif topt.metric == "noise_sens":
        sensitivity_to_edge_noise(opt, model, next(iter(test_dataset))["B"],
                                  save_path=os.path.join(opt.res_dir,
                                                         "noise_sens.npy"))

    elif topt.metric == "mvgauss":
        out["MVGAUSS_BPP_B"] = compute_bpp_mvgauss_B(train_dataset,
                                                     test_dataset)
        with open(os.path.join(opt.res_dir, "mvgauss_bpp.txt"), "w") as f:
            f.write("%f\n" % out["MVGAUSS_BPP_B"])

    elif topt.metric == "fid":
        # --fid_extractor swaps in a serialized real extractor (a
        # jax.export artifact, e.g. Inception features) for true FID
        label = "FID_B" if extractor is not None else "PROXY_FID_B"
        out[label] = eval_fid_B(test_dataset, model, extractor=extractor)
        print("%s: %.4f" % (label, out[label]))
        with open(os.path.join(opt.res_dir, "fid.txt"), "w") as f:
            f.write("%f\n" % out[label])

    elif topt.metric == "z_div":
        batch = next(iter(dev_dataset))
        n = min(32, batch["A"].shape[0])
        div = eval_z_diversity(model, batch["A"][:n], num_z=opt.num_multi)
        out.update(div)
        print("Z_DIV_RATIO: %.4f (intra %.4f / inter %.4f)"
              % (div["ratio"], div["intra_z"], div["inter_input"]))
        with open(os.path.join(opt.res_dir, "z_diversity.json"), "w") as f:
            # strict JSON: a one-sample dev batch gives inter/ratio = NaN
            json.dump({k: (v if np.isfinite(v) else None)
                       for k, v in div.items()}, f, indent=2)
    return out


if __name__ == "__main__":
    test_model()
