"""The rank mesh (``parallel/mesh.py``), in one process: the layout of
``data x space x model x pipe`` over the ranks, a rank's slices of a batch,
and the JAX ``DataParallel``'s refusals with its messages
(``tests/test_pipeline.py::test_dp_pipe_guards``)."""

import itertools

import numpy as np
import pytest
import torch

from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.parallel import mesh as M
from domain_transfer_gan_torch.parallel import multihost
from domain_transfer_gan_torch.parallel.mesh import (DataParallel, Mesh,
                                                     check_pipeline,
                                                     check_spatial)

# (world, spatial, tensor, pipeline): every mix of the axes on 8 ranks
MIXES = [(8, s, t, p) for s, t, p in itertools.product((1, 2), (1, 2),
                                                       (1, 2))
         if not (p > 1 and (s > 1 or t > 1))] + [(8, 2, 2, 1), (4, 4, 1, 1),
                                                 (8, 1, 1, 4), (6, 1, 3, 1)]


def _mesh(world, s, t, p, rank):
    return Mesh(s, t, p, world=world, rank=rank, groups=False)


@pytest.mark.parametrize("world,s,t,p", MIXES)
def test_the_ranks_are_row_major_in_the_jax_order(world, s, t, p):
    """rank = ((data * S + space) * T + model) * P + pipe, and every line
    through a rank holds the ranks that differ from it on its axes only."""
    seen = set()
    for rank in range(world):
        m = _mesh(world, s, t, p, rank)
        c = m.coords
        assert m.sizes == {"data": world // (s * t * p), "space": s,
                           "model": t, "pipe": p}
        want = ((c["data"] * s + c["space"]) * t + c["model"]) * p + c["pipe"]
        assert want == rank
        seen.add(tuple(c.values()))
        for name, axes in (("data", ("data",)), ("space", ("space",)),
                           ("model", ("model",)), ("pipe", ("pipe",)),
                           ("batch", ("data", "pipe")),
                           ("replica", ("data", "space", "pipe"))):
            axis = getattr(m, name)
            assert axis.ranks[axis.index] == rank
            size = int(np.prod([m.sizes[a] for a in axes]))
            assert len(axis.ranks) == size
            for other in axis.ranks:
                oc = M.coords_of(other, m.sizes)
                assert all(oc[a] == c[a] for a in M.AXES if a not in axes)
    assert len(seen) == world


@pytest.mark.parametrize("world,s,t,p", MIXES)
def test_each_rank_holds_its_batch_slice_and_rows(world, s, t, p):
    """Axis 0 over (data, pipe) jointly, data major (the JAX
    ``('data', 'pipe')`` sharding); rows over space; the model ranks hold
    the same part.  The parts tile the batch exactly once per model rank."""
    n, h = 8 * world, 16
    x = torch.arange(n * h, dtype=torch.float32).reshape(n, h, 1, 1)
    count = torch.zeros_like(x)
    for rank in range(world):
        m = _mesh(world, s, t, p, rank)
        b, sp = m.batch, m.space
        assert b.index == m.coords["data"] * p + m.coords["pipe"]
        part = multihost.local_rows(multihost.local_rows(x, b.index, b.size),
                                    sp.index, sp.size, 1)
        lo = b.index * (n // b.size)
        r0 = sp.index * (h // sp.size)
        assert torch.equal(part, x[lo:lo + n // b.size,
                                   r0:r0 + h // sp.size])
        count[lo:lo + n // b.size, r0:r0 + h // sp.size] += 1
    assert torch.equal(count, torch.full_like(count, t))


def test_the_lines_are_made_in_one_order_on_every_rank():
    """``new_group`` must be called for every line, by every rank, in the
    same order: the order does not depend on the rank asking."""
    sizes = M.mesh_sizes(8, 2, 2, 0)
    for axes in (("data",), ("space",), ("model",), ("data", "space",
                                                     "pipe")):
        lines = M.all_lines(sizes, axes)
        assert sorted(r for line in lines for r in line) == list(range(8))
        assert all(M.line(line[0], sizes, axes)[0] == line for line in lines)


def tiny_cfg(**kw):
    base = dict(model="aug_cycle_gan", grid_size=64, ngf=4, nef=4, ndf=4,
                nlatent=8, batchSize=8, n_blocks=4, seed=1, device="cpu")
    base.update(kw)
    return TrainConfig(**base)


# the JAX guards (tests/test_pipeline.py:227-246) and the device count
GUARDS = [
    (dict(pipeline=2, spatial=2), {}, "mutually exclusive"),
    (dict(pipeline=2, tensor=2), {}, "mutually exclusive"),
    (dict(pipeline=2), dict(n_blocks=3), "divide n_blocks"),
    (dict(pipeline=2), dict(remat=True), "remat"),
    (dict(pipeline=2), dict(use_dropout=True), "use_dropout"),
    (dict(pipeline=2), dict(norm="batch"), "instance"),
    (dict(microbatches=4), {}, "microbatches"),
]


@pytest.mark.parametrize("mesh_kw,cfg_kw,match", GUARDS,
                         ids=[g[2] + str(i) for i, g in enumerate(GUARDS)])
def test_the_jax_guards_with_their_messages(mesh_kw, cfg_kw, match):
    with pytest.raises(ValueError, match=match):
        check_pipeline(tiny_cfg(**cfg_kw), mesh_kw.get("pipeline", 0),
                       mesh_kw.get("microbatches", 0),
                       mesh_kw.get("spatial", 0), mesh_kw.get("tensor", 0))


def test_the_messages_are_the_jax_ones_word_for_word():
    cases = {
        "--microbatches only applies to pipeline parallelism; set "
        "--pipeline >= 2": (tiny_cfg(), 0, 4),
        "--pipeline is mutually exclusive with --spatial/--tensor":
            (tiny_cfg(), 2, 0, 2),
        "--pipeline is incompatible with --remat (lifted remat cannot take "
        "the trunk closure argument)": (tiny_cfg(remat=True), 2),
        "--pipeline requires --use_dropout off (no rng plumbing into the "
        "manual pipeline region)": (tiny_cfg(use_dropout=True), 2),
        "--pipeline requires per-sample (instance) generator norms":
            (tiny_cfg(norm="batch"), 2),
        "--pipeline 2 must divide n_blocks 3": (tiny_cfg(n_blocks=3), 2),
    }
    for message, args in cases.items():
        with pytest.raises(ValueError) as e:
            check_pipeline(*args)
        assert str(e.value) == message


def test_a_world_that_does_not_divide_is_refused():
    with pytest.raises(ValueError, match=r"devices \(6\) not divisible by "
                       r"spatial\*tensor\*pipe \(4\)"):
        M.mesh_sizes(6, 2, 2, 0)


def test_the_pipeline_stage_split_refuses_what_jax_refuses():
    from domain_transfer_gan_torch.parallel.pipeline import (schedule,
                                                             stage_blocks)

    with pytest.raises(ValueError, match="n_blocks 3 not divisible by pipe "
                       "stages 2"):
        stage_blocks([object()] * 3, 2, 0)
    assert stage_blocks(list(range(8)), 4, 2) == [4, 5]
    # T = M + S - 1 ticks; stage s runs microbatch t - s
    assert schedule(2, 4, 3) == [-1, -1, -1, 0, 1]
    assert schedule(4, 2, 0) == [0, 1, 2, 3, -1]


def test_row_slices_the_generators_cannot_keep_are_refused():
    check_spatial(tiny_cfg(), 2)
    check_spatial(tiny_cfg(), 8)
    with pytest.raises(ValueError, match="--spatial 32"):
        check_spatial(tiny_cfg(), 32)
    with pytest.raises(ValueError, match="--spatial 3"):
        check_spatial(tiny_cfg(), 3)


def test_one_rank_gets_no_groups_and_a_world_of_one():
    m = Mesh()
    assert m.world == 1 and m.describe() == "data-parallel"
    assert all(getattr(m, a).size == 1 for a in M.AXES)
    assert Mesh(2, 2, 0, world=8, rank=5, groups=False).describe() == \
        "data x space x model x pipe 2x2x2x1"


def test_data_parallel_refuses_before_it_builds_anything():
    from domain_transfer_gan_torch.models import create_model

    model = create_model(tiny_cfg(n_blocks=3), testing=True, device="cpu")
    with pytest.raises(ValueError, match="divide n_blocks"):
        DataParallel(model, pipeline=2)
    with pytest.raises(ValueError, match="microbatches"):
        DataParallel(model, microbatches=4)
