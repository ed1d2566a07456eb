"""Carry parameters between the reference's tree and the port's modules.

``params_from_numpy(cfg, tree)`` takes the reference's parameter tree
(``repro.models.registry.init_params``) as nested dicts of numpy arrays
and returns the port's ``LM`` (or, for the enc-dec family, ``EncDec``) with
the same values, so that both packages
compute with the same weights; ``params_to_numpy(model)`` is its inverse.
The layouts agree: the port keeps the reference's ``(in, out)`` weights
(a layer computes ``x @ w``; the MoE experts' ``(e, in, out)``), so no
leaf is transposed; the only change is that the reference's stacked
groups — ``layers``, the hybrid's ``supers`` and ``tail``, the enc-dec
model's ``enc_layers`` and ``dec_layers`` — whose leaves carry a leading
axis over the group's members, are the port's ``layers[i]``,
``supers[i]``, ``tail[j]``, ``enc_layers[i]`` and ``dec_layers[i]``
(``reference_tree``, ``port_leaf``). A hybrid whose layer count is a multiple of 3 has an
empty ``tail``, ``{}`` in the reference's tree. bf16 leaves arrive as
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` refuses; their
bits are carried over as int16, and where ``ml_dtypes`` is missing
``params_to_numpy`` gives those int16 bits.
"""

from __future__ import annotations

import importlib.util
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from .common import ModelConfig
from .encdec import EncDec
from .transformer import LM

__all__ = ["params_from_numpy", "params_to_numpy", "tensor_from_numpy",
           "reference_tree", "port_leaf", "STACKED"]

# the reference's groups whose leaves are stacked over their members
STACKED = ("layers", "supers", "tail", "enc_layers", "dec_layers")


def tensor_from_numpy(a) -> torch.Tensor:
    """A CPU tensor with ``a``'s values and dtype (bf16 bit for bit)."""
    a = np.array(a, order="C")          # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tree_path(name: str) -> tuple[tuple, int | None]:
    """The reference's key path of the port's parameter ``name`` and the
    row of the stacked leaf it is (None outside a stacked group)."""
    parts = name.split(".")
    if parts[0] in STACKED:
        return (parts[0], *parts[2:]), int(parts[1])
    return (name,), None


def port_leaf(tree: dict, name: str):
    """The port's parameter ``name`` read from a tree in the reference's
    layout (``layers.<i>.…`` is row ``i`` of the stacked leaf, likewise
    ``supers.<i>.…`` and ``tail.<j>.…``)."""
    path, row = _tree_path(name)
    node = tree
    for key in path:
        node = node[key]
    return node if row is None else node[row]


def reference_tree(named: dict, stack: Callable = np.stack) -> dict:
    """Leaves keyed by the port's parameter names, as the reference's
    nested tree: the stacked groups' leaves stacked along a leading axis
    by ``stack`` (``np.stack`` or ``torch.stack``); a hybrid's (one with
    ``supers``) empty ``tail`` as ``{}``."""
    tree: dict = {}
    stacked: dict[tuple, dict[int, object]] = {}
    for name, leaf in named.items():
        path, row = _tree_path(name)
        if row is None:
            tree[name] = leaf
        else:
            stacked.setdefault(path, {})[row] = leaf
    for path, rows in stacked.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = stack([rows[i] for i in range(len(rows))])
    if "supers" in tree:
        tree.setdefault("tail", {})
    return tree


def _paths(tree, prefix: str = "") -> set[str]:
    if not isinstance(tree, dict):
        return {prefix}
    return set().union(*(_paths(v, f"{prefix}{k}.") for k, v in tree.items())
                       ) if tree else set()


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: dict, *, device=None
                      ) -> LM | EncDec:
    """The port's ``LM`` (``EncDec`` for the enc-dec family) holding the
    reference tree's values, on ``device`` (the card when None)."""
    model = (EncDec if cfg.family == "encdec" else LM)(
        cfg, device=resolve_device(device, what="params_from_numpy"))
    want = {n.rstrip(".") for n in _paths(tree)}
    have = {".".join(_tree_path(n)[0]) for n, _ in model.named_parameters()}
    if want != have:
        raise ValueError(f"tree leaves do not match the {cfg.name} "
                         f"parameters: {sorted(want ^ have)}")
    for name, p in model.named_parameters():
        src = tensor_from_numpy(port_leaf(tree, name))
        if src.dtype == torch.int16 and p.dtype == torch.bfloat16:
            src = src.view(torch.bfloat16)      # bits from params_to_numpy
        if tuple(src.shape) != tuple(p.shape) or src.dtype != p.dtype:
            raise ValueError(f"{name}: tree has {tuple(src.shape)} "
                             f"{src.dtype}, the port expects "
                             f"{tuple(p.shape)} {p.dtype}")
        p.copy_(src)
    return model


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.int16).numpy()
    if importlib.util.find_spec("ml_dtypes") is None:
        return bits
    import ml_dtypes
    return bits.view(ml_dtypes.bfloat16)


def params_to_numpy(model: LM | EncDec) -> dict:
    """The reference's parameter tree of ``model``'s values, on the host:
    nested dicts of numpy arrays with the ``layers`` leaves stacked; bf16
    leaves as ``ml_dtypes.bfloat16`` (their int16 bits without
    ``ml_dtypes``)."""
    return reference_tree({name: _numpy(p)
                           for name, p in model.named_parameters()})
