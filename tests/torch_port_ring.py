"""The ring of the instance-norm kernels (``csrc/instance_norm_cluster.cuh``:
the cluster variant of the split reductions, and the first launch of K1's
and K2's ring route) emulated in float32 on the CPU, in the kernels' order:
shared by tests/test_torch_port_split_plan.py and
tests/test_torch_port_instance_norm_plan.py.  Pure torch."""

import torch

from domain_transfer_gan_torch.ops.kernels import instance_norm as K


def _chan(a, b):
    """``csrc/instance_norm_cluster.cuh::chan_merge``: (count, mean, M2)
    triples, ``a`` the lower rows."""
    na, ma, qa = a
    nb, mb, qb = b
    total = na + nb
    w = nb / torch.clamp_min(total, 1.0)
    d = mb - ma
    return total, ma + d * w, (qa + qb) + (d * d) * (na * w)


def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _rows(t, idx):
    return tuple(v[idx] for v in t)


def _tree(vals, packs, op):
    """``tree_over_rows`` over the thread rows (dim 0) of ``vals`` (a tuple
    of tensors): where packs divides 32, a butterfly inside each warp's
    rows (row t with row t ^ off, the one with the bit clear the lower),
    then the binary tree over the warps' rows (row t takes row t + s at
    s = P/2 .. 1); else the tree over all rows."""
    if packs < 32 and 32 % packs == 0:
        per_warp = 32 // packs
        vals = tuple(v.reshape((-1, per_warp) + v.shape[1:]) for v in vals)
        off = per_warp // 2
        while off >= 1:
            idx = torch.arange(per_warp)
            lo = torch.minimum(idx, idx ^ off)
            hi = torch.maximum(idx, idx ^ off)
            vals = op(tuple(v[:, lo] for v in vals),
                      tuple(v[:, hi] for v in vals))
            off //= 2
        vals = tuple(v[:, 0] for v in vals)
    rows = vals[0].shape[0]
    span = 1
    while span < rows:
        span *= 2
    s = span // 2
    while s > 0:
        hi = min(2 * s, rows)
        if hi > s:
            merged = op(_rows(vals, slice(0, hi - s)),
                        _rows(vals, slice(s, hi)))
            vals = tuple(torch.cat([m, v[hi - s:]]) for m, v in
                         zip(merged, vals))
        s //= 2
    return _rows(vals, 0)


def emulate_stats(x, plan, packs, ty):
    """``instance_norm_partial_stats_cluster`` on x (N, HW, C) float32 (the
    values the kernel reads), in its order: per CTA, per chunk, per
    sub-chunk of RING_ROWS_PER_THREAD rows of every thread (``ty`` thread
    rows, ``packs`` channel packs), each thread's chunk mean and M2 of x
    less the first row, folded by Chan's rule; the tree; rank 0's merge of
    the CTAs in rank order; the first row added back to the mean."""
    n, hw, c = x.shape
    rpt = K.RING_ROWS_PER_THREAD
    ref = x[:, 0, :]
    zero = torch.zeros((n, c))
    total = (zero, zero, zero)
    for first, last in plan.row_ranges(hw):
        acc = tuple(torch.zeros((ty, n, c)) for _ in range(3))
        for r0, r1 in plan.chunk_ranges(first, last):
            for base in range(r0, r1, rpt * ty):
                rows = (base + torch.arange(ty)[:, None]
                        + ty * torch.arange(rpt)[None, :])
                valid = rows < r1                       # (ty, rpt)
                m = valid.sum(1).float()[:, None, None]  # (ty, 1, 1)
                u = x[:, rows.clamp_max(hw - 1), :] - ref[:, None, None, :]
                u = torch.where(valid[None, :, :, None], u,
                                torch.zeros(()))        # (n, ty, rpt, c)
                s = torch.zeros((ty, n, c))
                for j in range(rpt):
                    s = s + u[:, :, j].transpose(0, 1)
                mb = s * (1.0 / torch.clamp_min(m, 1.0))
                q = torch.zeros((ty, n, c))
                for j in range(rpt):
                    d = u[:, :, j].transpose(0, 1) - mb
                    q = q + torch.where(valid[:, j, None, None], d * d,
                                        torch.zeros(()))
                has = m > 0
                new = _chan(acc, (m.expand(ty, n, c), mb, q))
                acc = tuple(torch.where(has, a2, a1)
                            for a1, a2 in zip(acc, new))
        total = _chan(total, _tree(acc, packs, _chan))
    return total[1] + ref, total[2]


def emulate_sums(x, dy, mean, rstd, scale, shift, relu, plan, packs, ty):
    """``instance_norm_bwd_partial_sums_cluster``'s sums of dy' and dy' *
    xhat, in its order: each thread's rows of each chunk in row order, the
    tree, rank 0's sum of the CTAs in rank order."""
    n, hw, c = x.shape
    xhat = (x - mean[:, None, :]) * rstd[:, None, :]
    s = scale.reshape(-1, 1, c)
    t = shift.reshape(-1, 1, c)
    g = torch.where(xhat * s + t > 0.0, dy, torch.zeros(())) if relu else dy
    parts = (g, g * xhat)
    total = (torch.zeros((n, c)), torch.zeros((n, c)))
    for first, last in plan.row_ranges(hw):
        acc = (torch.zeros((ty, n, c)), torch.zeros((ty, n, c)))
        for r0, r1 in plan.chunk_ranges(first, last):
            for r in range(r0, r1):  # each thread's rows in order
                k = (r - r0) % ty
                acc[0][k] += parts[0][:, r]
                acc[1][k] += parts[1][:, r]
        total = _add(total, _tree(acc, packs, _add))
    return total
