"""Entry points of the PyTorch/CUDA port (``domain_transfer_gan_torch``),
beside the JAX package's ``__graft_entry__.py``.

- :func:`entry` — the forward step of the flagship model (the
  CIN-conditioned stochastic generator G_A->B of aug_cycle_gan) with example
  args, as a function of its weights.
- :func:`dryrun_multichip` — the aug_cycle_gan two-phase train step and the
  supervised step over n ranks, data-parallel, then over the meshes that n
  ranks can lay out (data x space, data x model, data x pipe, and data x
  space x model), ONE step each on tiny shapes, the batch sliced over the
  ranks and every rank holding its part of the model.

Both run on the card unless the caller asks for the CPU::

    python3 __graft_entry_torch__.py 4                 # four ranks, the card
    python3 __graft_entry_torch__.py 2 --device cpu    # two gloo ranks
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

# the tiny configuration of both entry points (``__graft_entry__._tiny_cfg``)
ENTRY_CFG = dict(model="aug_cycle_gan", grid_size=64, ngf=8, nef=8, ndf=8,
                 nlatent=16, batchSize=8, monitor_gnorm=True)
# dryrun_multichip's meshes: (the label it prints, parallel/selfcheck.py's
# job, the ranks per data slice it takes)
MESHES = (("dp x sp", "dp_sp", 2), ("dp x tp", "dp_tp", 2),
          ("dp x pp", "dp_pp", 2), ("dp x sp x tp", "dp_sp_tp", 4))


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device here (torch.cuda.is_available() "
                           "is False); pass device='cpu' to run on the CPU")
    return dev


def entry(device="cuda"):
    """Returns (fn, example_args): the flagship generator forward.

    ``fn(state_dict, x, z)`` is ``netG_A_B(x, z)`` of the tiny config's
    aug_cycle_gan (``torch.func.functional_call`` with the weights in
    ``state_dict``, keyed as the module's own): x an NHWC float32 image
    batch in [-1, 1], z its (N, nlatent) latent codes, the result the NHWC
    B images.  ``example_args`` are the weights the model draws from seed 0
    and a batch of 8 drawn from a numpy seed, all on ``device``.  On the card
    every instance norm and pad runs the port's kernels; ``fn(...,
    plain_norm=True)`` sends the norms through their plain versions."""
    from domain_transfer_gan_torch.config import TrainConfig
    from domain_transfer_gan_torch.models.state import init_state

    dev = _device(device)
    cfg = TrainConfig(**ENTRY_CFG, device=str(dev))
    state = init_state(cfg, dev, generator=torch.Generator().manual_seed(0))
    net = state.nets["netG_A_B"]
    params = {k: v.detach() for k, v in net.state_dict().items()}

    def fn(params, x, z, plain_norm=False):
        return torch.func.functional_call(net, params, (x, z),
                                          {"plain_norm": plain_norm})

    rng = np.random.RandomState(0)
    n = cfg.batchSize
    x = rng.uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32)
    z = rng.randn(n, cfg.nlatent).astype(np.float32)
    return fn, (params, torch.from_numpy(x).to(dev),
                torch.from_numpy(z).to(dev))


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One data-parallel aug_cycle_gan train step and one supervised step
    over ``n_devices`` ranks; at an even n >= 4 one step each over the
    data x space, data x model and data x pipe meshes (the last at
    n_blocks = 4), and at n >= 8 with n % 4 == 0 one over data x space x
    model.  The batch is max(n, 8) rounded up to a multiple of n.

    Each rank is a process of its own, started here
    (``parallel/selfcheck.py::run_ranks``), that computes its slice through
    ``parallel.DataParallel``.  On the card every rank takes a card of its
    own over NCCL where there are n of them, else the ranks share the card
    over gloo; on the CPU (``device="cpu"``, the only way it runs there)
    they talk over gloo.  Asserts every loss of every rank finite, prints
    the backend, the card count and a line per mesh, and returns each
    mesh's losses on rank 0."""
    from domain_transfer_gan_torch.parallel import multihost, selfcheck

    dev = _device(device)
    n = int(n_devices)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = multihost.choose_backend(dev.type, n, cards)
    print("dryrun_multichip(%d): %d ranks over %s on %s, %d CUDA card(s)"
          % (n, n, backend, dev.type, cards))
    batch = n * math.ceil(max(n, 8) / n)
    width = {k: ENTRY_CFG[k] for k in ("ngf", "nef", "ndf", "nlatent")}
    names = ["aug", "sup"]
    labels = []
    if n % 2 == 0 and n >= 4:
        labels = [m for m in MESHES if m[2] == 2]
    if n % 4 == 0 and n >= 8:
        labels += [m for m in MESHES if m[2] == 4]
    names += [job for _, job, _ in labels]
    jobs = [dict(name=job, width=width, batch=batch, steps=1)
            for job in names]
    ranks = selfcheck.run_ranks(jobs, n, str(dev), backend)
    losses = {}
    for job, out in zip(names, ranks[0]):
        losses[job] = out["steps"][0]["losses"]
    for r, outs in enumerate(ranks):
        for job, out in zip(names, outs):
            bad = {k: v for k, v in out["steps"][0]["losses"].items()
                   if not math.isfinite(v)}
            assert not bad, "rank %d, %s: losses not finite %r" % (r, job,
                                                                  bad)
    main, sup = losses["aug"], losses["sup"]
    print("dryrun_multichip(%d) OK: D_A=%.4f G_A=%.4f Cyc_A=%.4f S_A=%.4f"
          % (n, main["D_A"], main["G_A"], main["Cyc_A"], sup["S_A"]))
    for label, job, per in labels:
        print("dryrun_multichip %s (%dx%s) OK: D_A=%.4f" % (
            label, n // per, "x".join(["2"] * int(math.log2(per))),
            losses[job]["D_A"]))
    return losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=0,
                    help="ranks (default: the visible CUDA cards)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    dryrun_multichip(args.n or max(torch.cuda.device_count(), 1),
                     args.device)
