"""Carry the JAX package's parameters across into the port.

``jax_params_to_state_dict(net_name, params)`` takes one net's ``params``
subtree as nested dicts of numpy arrays (the flax tree, e.g.
``params["block0"]["cin1"]["shift_conv"]["kernel"]``) and returns the
``state_dict`` of the port's module of the same name.  The module trees carry
the same names, so a leaf's key is its path joined by dots; what changes is
the layout of each kernel:

- conv ``kernel (kh, kw, I, O)``       -> ``weight (O, I, kh, kw)``;
- ``up0`` ``kernel (kh, kw, I, O)``    -> ``weight (I, O, kh, kw)`` with both
  spatial axes flipped: the JAX package correlates the stride-dilated input
  with an unflipped kernel, PyTorch's transposed conv is the gradient of a
  correlation, and the two agree iff ours[.., i, j] = theirs[kh-1-i, kw-1-j];
- Dense ``kernel (in, out)`` (CIN ``shift_conv`` / ``scale_conv``, the latent
  discriminator's ``fc*``) -> ``nn.Linear.weight (out, in)``;
- batch norm ``bn/scale`` -> ``bn.weight`` (``bn/bias`` keeps its name);
- ``bias`` and InstanceNorm ``scale`` / ``shift`` ``(C,)`` unchanged.

``jax_batch_stats_to_buffers(net_name, batch_stats)`` does the same for one
net's ``batch_stats`` subtree: ``bn/mean`` -> ``bn.running_mean``, ``bn/var``
-> ``bn.running_var``.

``jax_fid_params_to_state_dict(params)`` converts the JAX package's
random-feature FID extractor (``eval/fid.py``) the same way.

The opt-in training state comes across too: an EMA shadow is a params tree
(``jax_params_to_state_dict`` of it gives the shadow per parameter name;
``models.api.CycleGANBase.load_jax_ema``), and ``jax_pool_to_port`` turns a
JAX fake-image pool (``PoolState`` or a dict with ``buf`` NHWC
``(P, H, W, C)`` and ``n``) into the port's buffer, in the same NHWC
layout, and fill count (``CycleGANBase.load_jax_pools``).

``flatten_params`` / ``unflatten_params`` move between the nested tree and the
flat ``netG_A_B/conv0/kernel`` keys of a params ``.npz``.

The inverse direction (port -> JAX), for writing the JAX package's
checkpoints (``models.api.CycleGANBase.save_jax``):
``state_dict_to_jax_params`` (parameters, or an Adam moment or EMA shadow
keyed by parameter name: the same layout maps, ``up0``'s flip included),
``buffers_to_jax_batch_stats`` and ``port_pool_to_jax``.  Each is the exact
inverse of its forward map: a layout change moves bytes, never rounds.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

GENERATOR_NETS = ("netG_A_B", "netG_B_A")
NET_NAMES = GENERATOR_NETS + ("netD_A", "netD_B", "netD_z_B", "netE_B")


def _convert_leaf(path, value: np.ndarray) -> np.ndarray:
    leaf = path[-1]
    if leaf != "kernel":
        return value
    if value.ndim == 2:       # Dense (in, out) -> Linear (out, in)
        return value.T
    if value.ndim != 4:
        raise ValueError("kernel %s has unexpected shape %r"
                         % ("/".join(path), value.shape))
    if path[-2].startswith("up"):  # transposed conv: flip + (I, O, kh, kw)
        return np.transpose(value, (2, 3, 0, 1))[:, :, ::-1, ::-1]
    return np.transpose(value, (3, 2, 0, 1))


def flax_last_axis_dim(name: str, shape) -> int:
    """The dimension of the port's parameter ``name`` (a ``state_dict`` key)
    of ``shape`` that holds the last axis of its JAX leaf, by the layout map
    of :func:`_convert_leaf`: a conv kernel (kh, kw, I, O) is (O, I, kh, kw)
    here, a transposed one (``up*``) (I, O, kh, kw), a Dense (in, out) a
    Linear (out, in); a 1-D leaf is the same."""
    parts = name.split(".")
    if len(shape) == 4 and len(parts) >= 2 and parts[-2].startswith("up"):
        return 1
    return 0


def _walk(tree: Mapping, prefix=()):
    for k in tree:
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _check_net(net_name: str) -> None:
    if net_name not in NET_NAMES:
        raise KeyError("unknown network %r (have %s)"
                       % (net_name, ", ".join(NET_NAMES)))


def _tensor(value: np.ndarray) -> torch.Tensor:
    # a fresh C-ordered copy: the source may be read-only or a view
    return torch.from_numpy(np.array(value, np.float32, order="C"))


def jax_params_to_state_dict(net_name: str,
                             params: Mapping) -> Dict[str, torch.Tensor]:
    """The parameters of the port's module ``net_name`` (float32 CPU
    tensors, keyed as in its ``state_dict``) from the JAX ``params``
    subtree."""
    _check_net(net_name)
    return _params_to_state_dict(params)


def _params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, value in _walk(params):
        value = _convert_leaf(path, np.asarray(value, np.float32))
        leaf = path[-1]
        if leaf == "kernel" or path[-2:] == ("bn", "scale"):
            leaf = "weight"
        sd[".".join(path[:-1] + (leaf,))] = _tensor(value)
    return sd


def jax_batch_stats_to_buffers(net_name: str,
                               batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """The running statistics of the port's module ``net_name`` (keyed as in
    its ``state_dict``) from the JAX ``batch_stats`` subtree; empty for a
    net without batch norm."""
    _check_net(net_name)
    sd = {}
    for path, value in _walk(batch_stats):
        if path[-1] not in ("mean", "var"):
            raise ValueError("unexpected batch statistic %s" % "/".join(path))
        sd[".".join(path[:-1] + ("running_" + path[-1],))] = _tensor(
            np.asarray(value, np.float32))
    return sd


def jax_fid_params_to_state_dict(params: Mapping
                                 ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``eval.fid.RandomFeatureNet`` from the
    ``params`` of the JAX package's random-feature extractor
    (``conv0`` ... ``conv3``, each ``kernel`` and ``bias``)."""
    return _params_to_state_dict(params)


def jax_pool_to_port(pool) -> Tuple[torch.Tensor, int]:
    """(buffer, fill count) of the port's ``models.pool.PoolState`` from a
    JAX pool: the buffer stays NHWC ``(P, H, W, C)`` float32."""
    if isinstance(pool, Mapping):
        buf, n = pool["buf"], pool["n"]
    else:
        buf, n = pool.buf, pool.n
    buf = np.asarray(buf, np.float32)
    if buf.ndim != 4:
        raise ValueError("a pool buffer is (P, H, W, C), got %r"
                         % (buf.shape,))
    return _tensor(buf), int(np.asarray(n))


def flatten_params(tree: Mapping) -> Dict[str, np.ndarray]:
    """Nested dicts -> ``{"a/b/c": array}``."""
    return {"/".join(path): np.asarray(v) for path, v in _walk(tree)}


def unflatten_params(flat: Mapping[str, np.ndarray]) -> dict:
    """``{"a/b/c": array}`` -> nested dicts."""
    tree: dict = {}
    for key in flat:
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(flat[key])
    return tree


def _unconvert_leaf(path, value: np.ndarray) -> np.ndarray:
    """The inverse of :func:`_convert_leaf` (``path`` ends in the JAX leaf
    name)."""
    if path[-1] != "kernel":
        return value
    if value.ndim == 2:       # Linear (out, in) -> Dense (in, out)
        return value.T
    if path[-2].startswith("up"):  # (I, O, kh, kw) flipped -> (kh, kw, I, O)
        return np.transpose(value[:, :, ::-1, ::-1], (2, 3, 0, 1))
    return np.transpose(value, (2, 3, 1, 0))


def _nest(flat: Mapping[tuple, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return tree


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().to("cpu", torch.float32).numpy()
    return np.asarray(value, np.float32)


def state_dict_to_jax_params(net_name: str, sd: Mapping) -> dict:
    """The JAX ``params`` subtree of ``net_name`` (nested dicts of C-ordered
    float32 numpy arrays) from the port's parameters keyed as in its
    ``state_dict``; also takes an Adam moment or an EMA shadow keyed so."""
    _check_net(net_name)
    flat = {}
    for key, value in sd.items():
        *mods, leaf = key.split(".")
        value = _numpy(value)
        if leaf == "weight":
            if value.ndim >= 2:
                leaf = "kernel"
            elif mods and mods[-1] == "bn":
                leaf = "scale"
            else:
                raise ValueError("%s: a 1-d weight outside a batch norm (%s)"
                                 % (net_name, key))
        path = tuple(mods) + (leaf,)
        flat[path] = np.ascontiguousarray(_unconvert_leaf(path, value))
    return _nest(flat)


def buffers_to_jax_batch_stats(net_name: str, sd: Mapping) -> dict:
    """The JAX ``batch_stats`` subtree of ``net_name`` from the port's
    running statistics (``...bn.running_mean`` / ``running_var``; other
    keys are skipped); empty for a net without batch norm."""
    _check_net(net_name)
    flat = {}
    for key, value in sd.items():
        *mods, leaf = key.split(".")
        if leaf not in ("running_mean", "running_var"):
            continue
        flat[tuple(mods) + (leaf[len("running_"):],)] = np.ascontiguousarray(
            _numpy(value))
    return _nest(flat)


def port_pool_to_jax(buf, n: int) -> dict:
    """A JAX ``PoolState``-shaped ``{"buf": (P, H, W, C) float32, "n":
    int32 0-d}`` from the port's pool buffer and fill count."""
    return {"buf": np.ascontiguousarray(_numpy(buf)),
            "n": np.asarray(n, np.int32)}
