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
- CIN ``shift_conv`` / ``scale_conv`` Dense ``kernel (nlatent, C)`` ->
  ``nn.Linear.weight (C, nlatent)``;
- ``bias`` and InstanceNorm ``scale`` / ``shift`` ``(C,)`` unchanged.

``flatten_params`` / ``unflatten_params`` move between the nested tree and the
flat ``netG_A_B/conv0/kernel`` keys of a params ``.npz``.  The inverse
direction (port -> JAX) comes with the checkpoint slice.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

GENERATOR_NETS = ("netG_A_B", "netG_B_A")


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


def _walk(tree: Mapping, prefix=()):
    for k in tree:
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_params_to_state_dict(net_name: str,
                             params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (float32 CPU tensors) for one generator."""
    if net_name not in GENERATOR_NETS:
        raise NotImplementedError(
            "%s is not ported yet: this slice converts %s; the "
            "discriminators and the encoder come with the training slice"
            % (net_name, ", ".join(GENERATOR_NETS)))
    sd = {}
    for path, value in _walk(params):
        value = _convert_leaf(path, np.asarray(value, np.float32))
        key = ".".join(path[:-1] + ("weight" if path[-1] == "kernel"
                                    else path[-1],))
        # a fresh C-ordered copy: the source may be read-only or a view
        sd[key] = torch.from_numpy(np.array(value, np.float32, order="C"))
    return sd


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
