"""The opt-in step extras of the port, the port alone (tiny nets, 64x64, on
the CPU): ``--remat`` against the same step without it (with dropout, and
with ``--norm batch``), the ``--grad_accum`` steps against the fused step
and their batch-norm cadence, the guards of the accumulation steps,
``ema_update`` / ``swap_ema`` against the numpy formula, and checkpoints
that carry pools and shadows (format 2) or predate them (format 1).  The
JAX-parity runs of the same extras are in
``test_torch_port_step_extras_jax.py`` (``slow``)."""

import numpy as np
import pytest
import torch

from domain_transfer_gan_torch.config import TrainConfig
from domain_transfer_gan_torch.models import accum, create_model, steps
from domain_transfer_gan_torch.models.state import ema_update
from domain_transfer_gan_torch.nn import norms
from domain_transfer_gan_torch.utils import checkpoint

from torch_port_helpers import (  # noqa: F401 (a fixture)
    TINY,
    check_step_grads,
    images,
    latents,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REMAT_ATOL = 1e-6
ACCUM_LOSS_ATOL = 1e-5


def _model(tmp_path=None, **flags):
    flags.setdefault("seed", 3)
    cfg = TrainConfig(**dict(TINY, init_scheme="sane", **flags))
    if tmp_path is not None:
        cfg.checkpoints_dir, cfg.name = str(tmp_path), "x"
        cfg.finalize()
    return create_model(cfg, testing=True, device="cpu")


def _steps(m, n, batch=4, seed=0):
    A, B = images(seed + 10, batch), images(seed + 11, batch)
    out = []
    for it in range(n):
        z, eps = latents(seed + 20 + it, batch, 8), latents(seed + 30 + it,
                                                            batch, 8)
        if m.opt.model == "aug_cycle_gan":
            tl, tv, tg = m.train_instance(A, B, z, eps)
        else:
            tl, tv, tg = m.train_instance(A, B, z)
        out.append(({k: float(v) for k, v in tl.items()},
                    {k: float(v) for k, v in tg.items()}, tv))
    return out


def _states(m):
    return {k: {n: v.detach().clone() for n, v in net.state_dict().items()}
            for k, net in m.nets.items()}


@pytest.mark.parametrize("flags", [dict(use_dropout=1), dict(norm="batch")],
                         ids=["dropout", "norm_batch"])
def test_remat_is_the_same_step(monkeypatch, flags):
    """Two steps with and without --remat from the same seed: the same
    dropout masks in the recompute, running statistics advanced once per
    forward, parameters and statistics within REMAT_ATOL; the recompute
    runs every generator norm site once more per generator call with a
    graph (four per step)."""
    calls = {}
    fused = norms.instance_norm_fused

    def counted(*a, **kw):
        calls[key] = calls.get(key, 0) + 1
        return fused(*a, **kw)

    monkeypatch.setattr(norms, "instance_norm_fused", counted)
    runs = {}
    for key in (False, True):
        m = _model(remat=key, **flags)
        assert m.nets["netG_A_B"].remat == key == m.nets["netG_B_A"].remat
        assert not m.nets["netE_B"].remat and not m.nets["netD_A"].remat
        runs[key] = (_steps(m, 2), _states(m))
    for (l0, g0, _), (l1, g1, _) in zip(runs[False][0], runs[True][0]):
        assert l0 == pytest.approx(l1, abs=REMAT_ATOL)
        assert g0 == pytest.approx(g1, abs=REMAT_ATOL)
    for net, sd in runs[False][1].items():
        for name, v in sd.items():
            d = (runs[True][1][net][name] - v).abs().max().item()
            assert d <= REMAT_ATOL, (net, name, d)
    # the recompute: netG_A_B has 5 + 2 * 3 instance-norm sites, netG_B_A
    # 5 + 3 (none under --norm batch), each generator runs twice with a
    # graph per step, two steps
    per_call = {"netG_A_B": 11, "netG_B_A": 0 if flags.get("norm") else 8}
    assert calls[True] - calls[False] == 2 * 2 * sum(per_call.values())


def test_remat_recompute_does_not_advance_the_generators_statistics():
    m = _model(remat=True, norm="batch")
    net = m.nets["netG_B_A"]
    x = torch.from_numpy(images(1, 4))
    before = [b.clone() for b in net.buffers()]
    net.train()
    y = net(x.requires_grad_(True))
    once = [b.clone() for b in net.buffers()]
    assert any(not torch.equal(a, b) for a, b in zip(before, once))
    y.sum().backward()
    assert all(torch.equal(a, b) for a, b in zip(once, net.buffers()))
    with torch.no_grad():  # no grad, no checkpoint
        net(x)


@pytest.mark.parametrize("model_name", ["stoch_cycle_gan", "cycle_gan"])
def test_stoch_accumulation_is_the_fused_step(monkeypatch, model_name):
    """Instance norms only: K = 2 microbatches give the fused step's losses
    and, per tensor, its step-1 gradients (check_step_grads)."""
    grads = {}

    def run(k):
        m = _model(model=model_name, grad_accum=k)
        owner = {id(p): n for n, net in m.nets.items()
                 for p in net.parameters()}
        names = {n: [p for p, _ in net.named_parameters()]
                 for n, net in m.nets.items()}
        seen = grads.setdefault(k, {})
        orig = steps.apply_net_update

        def record(p, opt, g, *rest):
            net = owner[id(p[0])]
            seen.setdefault(net, []).append(
                {n: t.detach().numpy().copy() for n, t in zip(names[net], g)})
            return orig(p, opt, g, *rest)

        monkeypatch.setattr(steps, "apply_net_update", record)
        try:
            return _steps(m, 2)
        finally:
            monkeypatch.setattr(steps, "apply_net_update", orig)

    fused, micro = run(1), run(2)
    for (lf, gf, _), (lm, gm, _) in zip(fused, micro):
        assert set(lf) == set(lm) and set(gf) == set(gm)
        assert lm == pytest.approx(lf, abs=ACCUM_LOSS_ATOL)
    for k, v in fused[0][2].items():
        np.testing.assert_allclose(micro[0][2][k].numpy(), v.numpy(),
                                   atol=1e-5, err_msg=k)
    check_step_grads({"grads": {"jax": grads[1], "port": grads[2]},
                      "steps": fused})


def test_aug_accumulation_batch_norm_cadence(monkeypatch):
    """K = 2: per microbatch netE_B advances twice in the G phase and not in
    the D phase; netD_z_B twice in the D phase and once in the G phase."""
    m = _model(grad_accum=2)
    first = {n: next(c for c in m.nets[n].modules()
                     if isinstance(c, norms._BatchNormCore))
             for n in ("netE_B", "netD_z_B")}
    counts = {n: 0 for n in first}
    orig = norms._BatchNormCore.forward

    def forward(self, x):
        for n, c in first.items():
            if c is self and self.training and self.advance:
                counts[n] += 1
        return orig(self, x)

    monkeypatch.setattr(norms._BatchNormCore, "forward", forward)
    (losses, gnorms, vis), = _steps(m, 1)
    assert counts == {"netE_B": 2 * 2, "netD_z_B": 2 * 3}
    assert all(np.isfinite(v) for v in list(losses.values())
               + list(gnorms.values()))
    assert gnorms["mu_min"] <= gnorms["mu_max"]
    assert all(v.shape == (4, 64, 64, 3) for v in vis.values())


def test_microbatches_interleave():
    x = torch.arange(6 * 2).reshape(6, 2)
    parts = accum._split_micro(x, 3)
    assert [p[:, 0].tolist() for p in parts] == [[0, 6], [2, 8], [4, 10]]
    assert torch.equal(accum._merge_micro(parts), x)


GUARDS = [
    (dict(pool_size=4), "--pool_size"),
    (dict(norm="batch"), "--norm batch"),
    (dict(pipeline=2), "--pipeline"),
    (dict(batchSize=5), "batch 5 not divisible by --grad_accum 2"),
    (dict(supervised=True), "--supervised"),
]


@pytest.mark.parametrize("flags,named", GUARDS, ids=[g[1] for g in GUARDS])
def test_accumulation_guards(flags, named):
    with pytest.raises(ValueError, match=named):
        _model(grad_accum=2, **flags)


def test_an_indivisible_batch_is_refused_at_the_step():
    m = _model(grad_accum=2, model="stoch_cycle_gan")
    with pytest.raises(ValueError, match="batch 3 not divisible"):
        m.train_instance(images(1, 3), images(2, 3))


def test_ema_update_is_the_formula():
    rng = np.random.RandomState(0)
    p = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    e = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    net = torch.nn.Module()
    net.a, net.b = (torch.nn.Parameter(torch.from_numpy(v.copy()))
                    for v in p)
    shadow = {"netG_A_B": [torch.from_numpy(v.copy()) for v in e]}
    ema_update(shadow, {"netG_A_B": net}, 0.9)
    for got, ev, pv in zip(shadow["netG_A_B"], e, p):
        np.testing.assert_allclose(got.numpy(), 0.9 * ev + 0.1 * pv,
                                   rtol=1e-6, atol=1e-7)
    before = [t.clone() for t in shadow["netG_A_B"]]
    ema_update(shadow, {"netG_A_B": net}, 0.0)  # off: no change
    assert all(torch.equal(a, b) for a, b in zip(before, shadow["netG_A_B"]))


def test_the_step_updates_the_shadows_and_swap_ema_swaps():
    m = _model(ema=0.9)
    assert set(m.state.ema) == {"netG_A_B", "netG_B_A", "netE_B"}
    start = {k: [t.clone() for t in v] for k, v in m.state.ema.items()}
    _steps(m, 1)
    live = {k: [p.detach().clone() for p in m.nets[k].parameters()]
            for k in m.state.ema}
    for k, shadow in m.state.ema.items():
        for s, s0, p in zip(shadow, start[k], live[k]):
            np.testing.assert_allclose(s.numpy(), (0.9 * s0 + 0.1 * p).numpy(),
                                       rtol=1e-6, atol=1e-7)
    shadows = {k: [t.clone() for t in v] for k, v in m.state.ema.items()}
    m.swap_ema()
    for k in shadows:
        assert all(torch.equal(p, s) for p, s in
                   zip(m.nets[k].parameters(), shadows[k]))
        assert all(torch.equal(e, p) for e, p in
                   zip(m.state.ema[k], live[k]))
    m.swap_ema()
    for k in shadows:
        assert all(torch.equal(p, q) for p, q in
                   zip(m.nets[k].parameters(), live[k]))
    # the supervised step updates them too; without --ema nothing to swap
    before = [t.clone() for t in m.state.ema["netE_B"]]
    m.supervised_train_instance(images(3, 4), images(4, 4))
    assert not all(torch.equal(a, b) for a, b in
                   zip(before, m.state.ema["netE_B"]))
    plain = _model()
    assert plain.state.ema == {} and plain.state.pools == {}
    plain.swap_ema()


def test_checkpoint_carries_pools_and_shadows(tmp_path):
    m = _model(tmp_path, pool_size=6, ema=0.9)
    _steps(m, 2)
    m.save("latest")
    payload = checkpoint.read_checkpoint(str(tmp_path / "x" / "latest"))
    assert payload["format"].endswith("checkpoint 2")
    assert set(payload["pools"]) == {"fake_A", "fake_B"}
    assert set(payload["ema"]) == {"netG_A_B", "netG_B_A", "netE_B"}
    back = _model(tmp_path, pool_size=6, ema=0.9, seed=9)
    back.load(str(tmp_path / "x" / "latest"))
    for k, p in m.state.pools.items():
        assert torch.equal(back.state.pools[k].buf, p.buf)
        assert back.state.pools[k].n == p.n == 6
    for k, v in m.state.ema.items():
        assert all(torch.equal(a, b) for a, b in zip(back.state.ema[k], v))


def test_a_format_1_checkpoint_seeds_the_shadows(tmp_path):
    """A checkpoint from before pools and EMA (format 1): it loads, the
    shadows start at the loaded parameters, the pools stay fresh and say
    so."""
    old = _model(tmp_path)
    _steps(old, 1)
    payload = checkpoint.to_cpu(old._ckpt_payload())
    payload["format"] = "domain_transfer_gan_torch checkpoint 1"
    path = str(tmp_path / "x" / "v1")
    checkpoint.write_checkpoint(path, payload)
    m = _model(tmp_path, ema=0.5, seed=9)
    m.load(path)
    for k, shadow in m.state.ema.items():
        assert all(torch.equal(s, p.detach()) for s, p in
                   zip(shadow, old.nets[k].parameters()))
        assert all(s.data_ptr() != p.data_ptr() for s, p in
                   zip(shadow, m.nets[k].parameters()))
    assert m.state.step == 1


def test_a_pool_size_mismatch_warns_and_starts_fresh(tmp_path, capsys):
    m = _model(tmp_path, pool_size=4)
    _steps(m, 1)
    m.save("latest")
    other = _model(tmp_path, pool_size=6)
    other.load(str(tmp_path / "x" / "latest"))
    assert "do not match this config's --pool_size" in capsys.readouterr().out
    assert all(p.n == 0 and p.buf.shape[0] == 6
               for p in other.state.pools.values())
    same = _model(tmp_path, pool_size=4)
    same.load(str(tmp_path / "x" / "latest"))
    assert "do not match" not in capsys.readouterr().out
    assert all(p.n == 4 for p in same.state.pools.values())


def _chip_smoke():
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


STRUCTURE = [
    ("aug_accum2_64", dict(grad_accum=2), 64),
    ("aug_accum2_256", dict(grad_accum=2), 256),
    ("stoch_accum2_64", dict(grad_accum=2, model="stoch_cycle_gan"), 64),
    ("remat_dropout", dict(remat=True, use_dropout=1), 64),
    ("remat_norm_batch", dict(remat=True, norm="batch"), 64),
]


@pytest.mark.parametrize("flags,hw", [s[1:] for s in STRUCTURE],
                         ids=[s[0] for s in STRUCTURE])
def test_chip_smoke_holds_the_steps_to_their_structure(monkeypatch, flags,
                                                       hw):
    """What chip_smoke.py's phase 9 holds the card's launch counters to
    (accum_sites, remat_sites) is what the steps run: the kernel wrapper's
    calls of its CPU versions by direction and (N, HW, C), at a tiny width
    (D_A's width is hard-wired)."""
    from domain_transfer_gan_torch.ops.kernels import instance_norm as K

    cs = _chip_smoke()
    seen = {"fwd": {}, "bwd": {}}

    def counting(direction, fn):
        def wrapped(x, *a, **kw):
            key = (x.shape[0], x.shape[1] * x.shape[2], x.shape[3])
            seen[direction][key] = seen[direction].get(key, 0) + 1
            return fn(x, *a, **kw)
        return wrapped

    monkeypatch.setattr(K, "instance_norm_plain",
                        counting("fwd", K.instance_norm_plain))
    monkeypatch.setattr(K, "instance_norm_bwd_plain",
                        counting("bwd", K.instance_norm_bwd_plain))
    m = _model(grid_size=hw, **flags)
    A, B = images(1, 4, hw=hw), images(2, 4, hw=hw)
    m.train_instance(A, B)
    width = dict(n_blocks=3, ngf=4, ndf=4)
    if flags.get("remat"):
        want = cs.remat_sites(4, flags.get("norm") != "batch", **width)
    else:
        want = cs.accum_sites(4, 2, hw=hw, **width)
    assert seen == want


def test_chip_smoke_ema_check_tells_a_wrong_shadow():
    """chip_smoke.py's phase-9 shadow check on the CPU: the step's shadows
    within the formula's float32 rounding bound, most entries moved beyond
    it, and equal to the twin's; shadows left at their start, and shadows
    with decay and 1 - decay swapped, far outside the bound (the first read
    about 1e6 of it, the second about 1e9)."""
    cs = _chip_smoke()
    decay, n_steps = 0.999, 2
    m, twin = _model(ema=decay), _model(ema=decay)
    check = cs.ema_formula_start(m.nets, m.state.ema)
    unchanged = {k: [t.clone() for t in v] for k, v in m.state.ema.items()}
    swapped = {k: [t.clone() for t in v] for k, v in m.state.ema.items()}
    for it in range(n_steps):
        _steps(m, 1, seed=it)
        _steps(twin, 1, seed=it)
        cs.ema_formula_step(*check[1:], m.nets, decay)
        for k, shadow in swapped.items():
            for e, p in zip(shadow, m.nets[k].parameters()):
                e.mul_(1.0 - decay).add_(p.detach(), alpha=decay)
    worst, moved, vs_twin = cs.ema_readings(m.state.ema, twin.state.ema,
                                            *check, n_steps)
    assert worst <= 1.0 and moved >= cs.EMA_MOVED_SHARE
    assert max(vs_twin.values()) <= cs.EMA_TWIN_RTOL
    for wrong in (unchanged, swapped):
        worst, _, vs_twin = cs.ema_readings(wrong, twin.state.ema, *check,
                                            n_steps)
        assert worst > 1e3, worst
        assert min(vs_twin.values()) > cs.EMA_TWIN_RTOL, vs_twin
