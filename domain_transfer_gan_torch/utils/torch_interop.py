"""Checkpoint interop with the upstream PyTorch implementation
(adrianalbert/domain-transfer-GAN): the JAX package's
``utils/torch_interop.py`` for the port.

- :func:`import_torch_checkpoint` reads an upstream ``torch.save``
  checkpoint (per-net ``state_dict``s and the Adam state dicts, upstream
  model.py:293-303 / 750-764) into a model of the port: parameters,
  batch-norm running statistics and, optionally, the Adam moments and step
  counts.
- :func:`export_torch_checkpoint` writes a model of the port as an upstream
  checkpoint, with the duplicate alias keys that upstream's
  ``CINResnetBlock`` registers (``add_module``, upstream
  modules.py:145-146), so that ``load_state_dict(strict=True)`` of the
  upstream modules accepts it.

The key names come from the upstream constructors (CINResnetGenerator
networks.py:149-197, ResnetGenerator :203-252, Discriminator :308-349,
Discriminator_edges :352-393, DiscriminatorLatent :396-433, LatentEncoder
:438-483, the blocks and norms of modules.py).  Each table entry pairs an
upstream module prefix with the port's module path, which is the JAX
package's parameter path (``block0.cin1.shift_conv``...).

Both sides are torch, so most tensors copy as they are: the port's convs
hold ``(O, I, kh, kw)`` weights, its transposed conv ``up0`` the
``(I, O, kh, kw)`` weight of ``nn.ConvTranspose2d`` with the same
orientation (``ops/convs.py::conv_transpose2d_torch`` is the transposed
conv of PyTorch, which ``utils/convert.py`` reaches from the JAX layout by a
flip), and its Linear layers ``(O, I)``.  Only the conditional instance
norm differs: upstream computes shift and scale with 1x1 convs on z
``(O, nlatent, 1, 1)``, the port with Linear layers ``(O, nlatent)``.  CIN
registers shift before scale, in both.

The running statistics are copied as they are, in both directions, as the
JAX package copies them: the port's (flax's) running variance is the
biased batch variance, upstream's BatchNorm stores the unbiased one, so an
imported variance is read as if it were biased (a factor n / (n - 1) of
the batch size, 1.03 at batch 32).

The upstream Adam groups (model.py:109-114 for StochCycleGAN: G =
netG_A_B + netG_B_A, D = netD_A + netD_B; model.py:379-389 for
AugmentedCycleGAN: G_A = netG_B_A, G_B = netG_A_B + netE_B, D_A = netD_A,
D_B = netD_B + netD_z_B) map onto the port's per-net Adam states
(``models/state.py``): Adam's state is per parameter, and a group never
mixes learning rates.  torch keys a group's state by the parameter's
position in the group (registration order), which the tables reproduce.  A
net's step count is the largest step of its entries; a parameter never
stepped gets zero moments.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# layout tables: (upstream module prefix, the port's module path, kind),
# kind in {"conv", "convt", "dense", "dense1x1", "in", "bn"}
# ---------------------------------------------------------------------------


def _cin(tk: str, path: str):
    """A CondInstanceNorm: shift, then scale (upstream modules.py:111-118)."""
    return [(tk + ".shift_conv.0", path + ".shift_conv", "dense1x1"),
            (tk + ".scale_conv.0", path + ".scale_conv", "dense1x1")]


def _norm(tk: str, base: str, norm: str):
    """The inner norm of a _NormRelu / _NormLRelu: InstanceNorm at
    ``<base>.norm``, BatchNorm2d at ``<base>.norm.bn``."""
    if norm == "instance":
        return [(tk, base + ".norm", "in")]
    return [(tk, base + ".norm.bn", "bn")]


def layout_G_A_B(use_dropout: bool = False):
    """CINResnetGenerator: TwoInputSequential 'model' indices 0 pad,
    1 conv7, 2 CIN, 3 relu, 4 conv3, 5 CIN, 6 relu, 7 conv3s2, 8 CIN,
    9 relu, 10-12 CINResnetBlock, 13 convT, 14 CIN, 15 relu, 16 conv3,
    17 CIN, 18 relu, 19 conv7, 20 tanh."""
    e = [("model.1", "conv0", "conv")]
    e += _cin("model.2", "cin0")
    e += [("model.4", "conv1", "conv")]
    e += _cin("model.5", "cin1")
    e += [("model.7", "conv2", "conv")]
    e += _cin("model.8", "cin2")
    # CINResnetBlock conv_block: 0 pad, 1 Merge(conv, CIN), 2 relu,
    # [3 dropout], 3/4 pad, 4/5 conv, 5/6 InstanceNorm
    ci = 5 if use_dropout else 4
    for i in range(3):
        p, b = "model.%d.conv_block" % (10 + i), "block%d" % i
        e += [(p + ".1.module1", b + ".conv1", "conv")]
        e += _cin(p + ".1.module2", b + ".cin1")
        e += [(p + ".%d" % ci, b + ".conv2", "conv"),
              (p + ".%d" % (ci + 1), b + ".norm2", "in")]
    e += [("model.13", "up0", "convt")]
    e += _cin("model.14", "cin3")
    e += [("model.16", "conv3", "conv")]
    e += _cin("model.17", "cin4")
    e += [("model.19", "conv4", "conv")]
    return e


def layout_G_B_A(norm: str = "instance", use_dropout: bool = False):
    """ResnetGenerator: the indices of :func:`layout_G_A_B` with plain norms
    in place of the CINs.  A ResnetBlock has no norm after conv1."""
    e = [("model.1", "conv0", "conv")]
    e += _norm("model.2", "nr0", norm)
    e += [("model.4", "conv1", "conv")]
    e += _norm("model.5", "nr1", norm)
    e += [("model.7", "conv2", "conv")]
    e += _norm("model.8", "nr2", norm)
    ci = 5 if use_dropout else 4
    for i in range(3):
        p, b = "model.%d.conv_block" % (10 + i), "block%d" % i
        e += [(p + ".1", b + ".conv1", "conv"),
              (p + ".%d" % ci, b + ".conv2", "conv")]
        if norm == "instance":
            e += [(p + ".%d" % (ci + 1), b + ".norm2", "in")]
        else:
            e += [(p + ".%d" % (ci + 1), b + ".norm2.bn", "bn")]
    e += [("model.13", "up0", "convt")]
    e += _norm("model.14", "nr3", norm)
    e += [("model.16", "conv3", "conv")]
    e += _norm("model.17", "nr4", norm)
    e += [("model.19", "conv4", "conv")]
    return e


def _layout_patch_D(norm: str):
    """Discriminator / Discriminator_edges: conv, lrelu, [conv, norm,
    lrelu] x3, conv -> indices 0, 2, 3, 5, 6, 8, 9, 11."""
    e = [("model.0", "conv0", "conv"), ("model.2", "conv1", "conv")]
    e += _norm("model.3", "nl1", norm)
    e += [("model.5", "conv2", "conv")]
    e += _norm("model.6", "nl2", norm)
    e += [("model.8", "conv3", "conv")]
    e += _norm("model.9", "nl3", norm)
    e += [("model.11", "conv4", "conv")]
    return e


def layout_D_z_B():
    """DiscriminatorLatent: Linear / BatchNorm1d / LReLU x3 + Linear ->
    indices 0, 1, 3, 4, 6, 7, 9."""
    e = []
    for i, (fc, bn) in enumerate(((0, 1), (3, 4), (6, 7))):
        e += [("model.%d" % fc, "fc%d" % i, "dense"),
              ("model.%d" % bn, "bn%d.bn" % i, "bn")]
    e += [("model.9", "fc3", "dense")]
    return e


def layout_E_B():
    """LatentEncoder: conv_modules 0, 2, 3, 5, 6, 8, 9, 11, 12, then the
    enc_mu / enc_logvar heads.  Its norm is always batch (upstream
    model.py:364)."""
    return [("conv_modules.0", "conv0", "conv"),
            ("conv_modules.2", "conv1", "conv"),
            ("conv_modules.3", "nr1.norm.bn", "bn"),
            ("conv_modules.5", "conv2", "conv"),
            ("conv_modules.6", "nr2.norm.bn", "bn"),
            ("conv_modules.8", "conv3", "conv"),
            ("conv_modules.9", "nr3.norm.bn", "bn"),
            ("conv_modules.11", "conv4", "conv"),
            ("conv_modules.12", "nr4.norm.bn", "bn"),
            ("enc_mu", "enc_mu", "conv"),
            ("enc_logvar", "enc_logvar", "conv")]


def reference_layouts(cfg) -> Dict[str, list]:
    """Per-net layout tables of the configured model variant.  Upstream's
    generators have 3 residual blocks, and so do the tables."""
    if int(cfg.n_blocks) != 3:
        raise ValueError("upstream checkpoints hold generators of 3 residual "
                         "blocks; --n_blocks %d has no upstream layout"
                         % cfg.n_blocks)
    layouts = {
        "netG_A_B": layout_G_A_B(cfg.use_dropout),
        "netG_B_A": layout_G_B_A(cfg.norm, cfg.use_dropout),
        "netD_A": _layout_patch_D(cfg.norm),
        "netD_B": _layout_patch_D(cfg.norm),
    }
    if cfg.model == "aug_cycle_gan":
        layouts["netD_z_B"] = layout_D_z_B()
        layouts["netE_B"] = layout_E_B()
    return layouts


# upstream optimizer groups: checkpoint key -> nets in registration order
OPTIMIZER_GROUPS = {
    "aug_cycle_gan": {
        "optimizer_G_A": ("netG_B_A",),
        "optimizer_G_B": ("netG_A_B", "netE_B"),
        "optimizer_D_A": ("netD_A",),
        "optimizer_D_B": ("netD_B", "netD_z_B"),
    },
    "stoch_cycle_gan": {
        "optimizer_G": ("netG_A_B", "netG_B_A"),
        "optimizer_D": ("netD_A", "netD_B"),
    },
}
OPTIMIZER_GROUPS["cycle_gan"] = OPTIMIZER_GROUPS["stoch_cycle_gan"]

# the one layout change: upstream's 1x1 conv on z vs the port's Linear
_T2P = {"copy": lambda w: w, "dense1x1": lambda w: w[:, :, 0, 0]}
_P2T = {"copy": lambda w: w, "dense1x1": lambda w: w[:, :, None, None]}


def leaf_map(layout, state_keys) -> Tuple[list, list]:
    """Expand a layout into per-tensor maps: ``(param_leaves,
    buffer_leaves)``, param_leaves ``[(upstream key, port key, transform)]``
    in upstream ``parameters()`` order (the order torch keys an optimizer's
    state by), buffer_leaves ``[(upstream key, port key)]`` (batch-norm
    running statistics).  Whether a conv has a bias is read off the port's
    ``state_keys`` (the encoder's middle convs have none)."""
    params, buffers = [], []
    for tk, path, kind in layout:
        if kind in ("conv", "convt", "dense", "dense1x1"):
            tf = "dense1x1" if kind == "dense1x1" else "copy"
            params.append((tk + ".weight", path + ".weight", tf))
            if kind in ("dense", "dense1x1") or path + ".bias" in state_keys:
                params.append((tk + ".bias", path + ".bias", "copy"))
        elif kind == "in":
            params.append((tk + ".scale", path + ".scale", "copy"))
            params.append((tk + ".shift", path + ".shift", "copy"))
        elif kind == "bn":
            params.append((tk + ".weight", path + ".weight", "copy"))
            params.append((tk + ".bias", path + ".bias", "copy"))
            buffers.append((tk + ".running_mean", path + ".running_mean"))
            buffers.append((tk + ".running_var", path + ".running_var"))
        else:  # pragma: no cover
            raise ValueError("unknown layout kind %r" % kind)
    return params, buffers


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _tensor(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, order="C"))


# ---------------------------------------------------------------------------
# import
# ---------------------------------------------------------------------------

def load_reference_checkpoint(path: str) -> dict:
    """``torch.load`` of an upstream checkpoint on the CPU, retried with
    latin1 decoding for the Python 2 era's pickles.  It unpickles: load only
    checkpoints you trust."""
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    except UnicodeDecodeError:
        return torch.load(path, map_location="cpu", weights_only=False,
                          encoding="latin1")


def _net_maps(model) -> Dict[str, Tuple[list, list]]:
    """Per net its leaf maps, after checking that they name exactly the
    module's parameters and buffers."""
    maps = {}
    for net, layout in reference_layouts(model.opt).items():
        module = model.nets[net]
        sd = module.state_dict()
        pleaves, bleaves = leaf_map(layout, sd)
        mapped = {pk for _, pk, _ in pleaves} | {pk for _, pk in bleaves}
        if mapped != set(sd):
            raise KeyError("%s: the upstream layout and the module disagree "
                           "on %s" % (net, sorted(mapped ^ set(sd))))
        maps[net] = (pleaves, bleaves)
    return maps


def import_torch_checkpoint(path: str, model,
                            import_optimizers: bool = True) -> List[str]:
    """Load an upstream checkpoint into ``model`` (parameters and buffers
    are copied into its tensors: device and dtype stay).  Returns a report,
    one line per net and optimizer group.  A checkpoint of another
    architecture than ``model.opt`` (variant, norm, widths) raises a
    ``KeyError`` or ``ValueError`` naming the tensor."""
    ckpt = load_reference_checkpoint(path)
    maps = _net_maps(model)
    report = []
    with torch.no_grad():
        for net, (pleaves, bleaves) in maps.items():
            if net not in ckpt:
                raise KeyError("%s holds no %s" % (path, net))
            theirs = ckpt[net]
            mine = model.nets[net].state_dict()
            for tk, pk, tf in pleaves:
                val = _T2P[tf](_np32(theirs[tk]))
                if tuple(val.shape) != tuple(mine[pk].shape):
                    raise ValueError(
                        "shape mismatch importing %s -> %s.%s: checkpoint "
                        "%s vs model %s" % (tk, net, pk, tuple(val.shape),
                                            tuple(mine[pk].shape)))
                mine[pk].copy_(_tensor(val))
            for tk, pk in bleaves:
                mine[pk].copy_(_tensor(_np32(theirs[tk])))
            report.append("imported %s: %d tensors"
                          % (net, len(pleaves) + len(bleaves)))

        if import_optimizers:
            for opt_key, nets in OPTIMIZER_GROUPS[model.opt.model].items():
                if opt_key not in ckpt:
                    report.append("skipped %s: not in checkpoint" % opt_key)
                    continue
                if _import_adam_group(ckpt[opt_key], nets, maps, model,
                                      report, opt_key):
                    report.append("imported %s -> %s"
                                  % (opt_key, "+".join(nets)))

    if model.state.ema:
        # the upstream run has no EMA: the shadows start at the imported
        # parameters
        model.state.ema = {
            name: [p.detach().clone() for p in model.nets[name].parameters()]
            for name in model.state.ema}
    return report


def _import_adam_group(osd, nets, maps, model, report, opt_key) -> bool:
    """One upstream Adam state dict onto the per-net Adam states of
    ``nets``; False (and a report line) when its entries do not line up
    with the group's parameters."""
    state = osd.get("state", {})
    idxs: List[Any] = []
    for g in osd.get("param_groups", []):
        idxs += list(g.get("params", []))
    total = sum(len(maps[n][0]) for n in nets)
    if len(idxs) != total:
        report.append("skipped %s: %d state entries vs %d params (id-keyed "
                      "0.3-era state?)" % (opt_key, len(idxs), total))
        return False
    pos = 0
    for net in nets:
        names = [n for n, _ in model.nets[net].named_parameters()]
        adam = model.state.opt_state[net]
        count = 0
        for tk, pk, tf in maps[net][0]:
            pid = idxs[pos]
            pos += 1
            k = names.index(pk)
            mu, nu = adam.mu[k], adam.nu[k]
            ent = state.get(pid, state.get(str(pid)))
            if ent is None:  # never stepped: zero moments
                mu.zero_()
                nu.zero_()
                continue
            m = _T2P[tf](_np32(ent["exp_avg"]))
            v = _T2P[tf](_np32(ent["exp_avg_sq"]))
            if tuple(m.shape) != tuple(mu.shape):
                raise ValueError("optimizer shape mismatch at %s: checkpoint "
                                 "%s vs model %s" % (tk, tuple(m.shape),
                                                     tuple(mu.shape)))
            mu.copy_(_tensor(m))
            nu.copy_(_tensor(v))
            count = max(count, int(_np32(ent["step"])))
        adam.count = count
    return True


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def _alias_keys(net: str, key: str) -> List[str]:
    """The duplicate state-dict keys of upstream's CINResnetBlock, which
    registers every conv_block member a second time under its bare index:
    'model.10.conv_block.1.module1.weight' is also
    'model.10.1.module1.weight'."""
    if net != "netG_A_B":
        return []
    parts = key.split(".")
    if len(parts) >= 4 and parts[2] == "conv_block":
        return [".".join(parts[:2] + parts[3:])]
    return []


def export_torch_checkpoint(model, path: str) -> List[str]:
    """Write ``model`` as an upstream checkpoint at ``path``; returns a
    report."""
    cfg = model.opt
    maps = _net_maps(model)
    report = []
    ckpt: Dict[str, Any] = {}
    for net, (pleaves, bleaves) in maps.items():
        mine = model.nets[net].state_dict()
        sd: Dict[str, torch.Tensor] = {}
        for tk, pk, tf in pleaves:
            val = _tensor(_P2T[tf](_np32(mine[pk])))
            for k in [tk] + _alias_keys(net, tk):
                sd[k] = val.clone()
        for tk, pk in bleaves:
            sd[tk] = _tensor(_np32(mine[pk]))
        ckpt[net] = sd
        report.append("exported %s: %d tensors" % (net, len(sd)))

    for opt_key, nets in OPTIMIZER_GROUPS[cfg.model].items():
        # the D groups run at their own lr (lr / 5 until decay starts, the
        # decayed lr after: upstream model.py:282-291, 735-748)
        lr = model.old_lr_d if "D" in opt_key else model.old_lr
        state: Dict[int, Any] = {}
        pid = 0
        for net in nets:
            names = [n for n, _ in model.nets[net].named_parameters()]
            adam = model.state.opt_state[net]
            for tk, pk, tf in maps[net][0]:
                k = names.index(pk)
                state[pid] = {
                    "step": int(adam.count),
                    "exp_avg": _tensor(_P2T[tf](_np32(adam.mu[k]))),
                    "exp_avg_sq": _tensor(_P2T[tf](_np32(adam.nu[k]))),
                }
                pid += 1
        ckpt[opt_key] = {
            "state": state,
            "param_groups": [{
                "lr": lr, "betas": (cfg.beta1, 0.999), "eps": 1e-8,
                "weight_decay": 0, "amsgrad": False,
                "params": list(range(pid)),
            }],
        }
        report.append("exported %s: %d entries" % (opt_key, pid))

    torch.save(ckpt, path)
    return report
