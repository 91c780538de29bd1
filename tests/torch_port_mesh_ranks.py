"""Functions that run on each rank of a mesh test (spawned by
``parallel.selfcheck.run_rank_fn``): importable without JAX or pytest."""

import numpy as np
import torch

from domain_transfer_gan_torch.nn.blocks import CINResnetBlock
from domain_transfer_gan_torch.parallel import hints, multihost, pipeline, \
    spatial
from domain_transfer_gan_torch.parallel.mesh import Mesh

# the JAX engine cases (tests/test_pipeline.py): (stages, microbatches)
ENGINE_CASES = ((4, 4), (2, 4), (4, 2), (2, 2))
TRUNK = dict(n_blocks=4, dim=16, nl=8, b=16, h=8)


def trunk_fixture():
    """The blocks, input, code and output weights of the engine cases, the
    same in every process (seeded)."""
    t = TRUNK
    torch.manual_seed(0)
    blocks = [CINResnetBlock(t["dim"], t["nl"]) for _ in range(t["n_blocks"])]
    for blk in blocks:  # a nontrivial affine: scale away from 1
        with torch.no_grad():
            blk.norm2.scale.uniform_(0.5, 1.5)
            blk.norm2.shift.uniform_(-0.5, 0.5)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((t["b"], t["dim"], t["h"], t["h"]), generator=g)
    z = torch.randn((t["b"], t["nl"]), generator=g)
    w = torch.randn((t["b"], t["dim"], t["h"], t["h"]), generator=g)
    return blocks, x, z, w


def engine_cases(device):
    """Each engine case over the world's 4 ranks (a pipe axis of S, the
    rest data): the trunk's output, the gradients of sum(w * y) w.r.t.
    every block parameter (summed over the ranks), x and z, gathered."""
    out = {}
    for S, M in ENGINE_CASES:
        mesh = Mesh(pipeline=S)
        blocks, x, z, w = trunk_fixture()
        b = mesh.batch
        rows = lambda t: multihost.local_rows(t, b.index, b.size)
        xl = rows(x).clone().requires_grad_(True)
        zl = rows(z).clone().requires_grad_(True)
        engine = pipeline.PipelineEngine(mesh.pipe, M)
        y = pipeline.gpipe_trunk(engine, blocks, xl, zl, False)
        loss = (rows(w) * y).sum()
        params = [p for blk in blocks for p in blk.parameters()]
        # a block not on this rank's stage has no gradient here
        grads = torch.autograd.grad(loss, params + [xl, zl],
                                    allow_unused=True)
        summed = multihost.all_reduce_(torch.cat(
            [(torch.zeros_like(p) if g is None else g).reshape(-1)
             for p, g in zip(params, grads)]))
        out[(S, M)] = {
            "y": multihost.all_gather_cat(y.contiguous(), b).numpy(),
            "param_grads": summed.numpy(),
            "dx": multihost.all_gather_cat(grads[-2].contiguous(),
                                           b).numpy(),
            "dz": multihost.all_gather_cat(grads[-1], b).numpy()}
    return out


def space_gather(device):
    """``pin_batch_only`` under a space axis of 2: the gathered rows, and
    the gradient each rank gets back for its rows from sum(w * y)."""
    mesh = Mesh(spatial=2)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 4, 8, 8), generator=g)
    w = torch.randn((2, 4, 8, 8), generator=g)
    sp = mesh.space
    xl = multihost.local_rows(x, sp.index, sp.size, 2).clone() \
        .requires_grad_(True)
    with multihost.sharded(mesh), spatial.image_rows():
        y = hints.pin_batch_only(xl)
        whole_after = spatial.rows_axis() is None
    (gx,) = torch.autograd.grad((w * y).sum(), [xl])
    return {"y": y.detach().numpy(), "gx": gx.numpy(), "index": sp.index,
            "whole_after": whole_after}


def _tiny_model(device, **kw):
    from domain_transfer_gan_torch.parallel.selfcheck import job_config
    from domain_transfer_gan_torch.models import create_model

    cfg = job_config("aug", device=str(device), seed=4, **kw)
    return create_model(cfg, testing=True, device=device), cfg


def helpers_unpipelined(device):
    """The generation helpers of a ``--pipeline 2`` model over 2 ranks
    (outside a step, so unpipelined, data-parallel over (data, pipe))."""
    from domain_transfer_gan_torch.parallel.mesh import DataParallel

    model, cfg = _tiny_model(device, n_blocks=4, batchSize=8)
    dp = DataParallel(model, pipeline=2)
    rng = np.random.RandomState(5)
    A = rng.uniform(-1, 1, (8, 64, 64, 3)).astype(np.float32)
    z = rng.randn(8, cfg.nlatent).astype(np.float32)
    return {"predict_B": dp.predict_B(A, z).numpy(),
            "predict_A": dp.predict_A(A).numpy(),
            "engine_off_after": pipeline.active_engine() is None}


def tensor_checkpoint(device):
    """One ``--tensor 2`` step over 2 ranks, then ``save`` and ``save_jax``
    of the wrapper: the ranks' bytes held, the shapes of their sliced
    leaves, the state gathered whole and the two files' bytes."""
    import os
    import tempfile

    from domain_transfer_gan_torch.parallel.mesh import (DataParallel,
                                                         slices_of,
                                                         state_bytes)

    model, cfg = _tiny_model(device, batchSize=4, ema=0.9)
    before = state_bytes(model.state)
    cfg.expr_dir = tempfile.mkdtemp()
    dp = DataParallel(model, tensor=2)
    rng = np.random.RandomState(6)
    A = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    B = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    dp.train_instance(A, B)
    sliced = {k: [tuple(p.shape) for p, d in zip(
        net.parameters(), slices_of(net)[1].values()) if d is not None]
              for k, net in model.nets.items()}
    held = state_bytes(model.state)
    dp.save("latest")
    dp.save_jax(os.path.join(cfg.expr_dir, "latest.flax"))
    with dp._whole():
        whole = {k: {n: v.detach().clone().numpy()
                     for n, v in net.state_dict().items()}
                 for k, net in model.nets.items()}
        moments = {k: [t.clone().numpy() for t in s.mu + s.nu]
                   for k, s in model.state.opt_state.items()}
        ema = {k: [t.clone().numpy() for t in v]
               for k, v in model.state.ema.items()}
    after = {k: {n: v.detach().clone().numpy()
                 for n, v in net.state_dict().items()}
             for k, net in model.nets.items()}
    files = {}
    for name in ("latest", "latest.flax"):
        with open(os.path.join(cfg.expr_dir, name), "rb") as f:
            files[name] = f.read()
    return {"before": before, "held": held, "sliced": sliced,
            "whole": whole, "moments": moments, "ema": ema,
            "after": after, "files": files}


def jobs_then(device, jobs, extras=()):
    """``parallel.selfcheck``'s jobs, then the functions of this module
    named in ``extras``: (job results, {name: result})."""
    from domain_transfer_gan_torch.parallel import selfcheck

    results = [selfcheck.run_job(device=device, **job) for job in jobs]
    return results, {name: globals()[name](device) for name in extras}
