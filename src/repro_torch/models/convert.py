"""Carry the reference's parameters into the port's modules.

``params_from_numpy(cfg, tree)`` takes the reference's parameter tree
(``repro.models.registry.init_params``) as nested dicts of numpy arrays
and returns the port's ``LM`` with the same values, so that both packages
compute with the same weights. The layouts agree: the port keeps the
reference's ``(in, out)`` weights (a layer computes ``x @ w``), so no
leaf is transposed; the only change is that the reference's ``layers``
leaves, stacked along a leading ``(n_layers,)`` axis, are unstacked into
``layers[i]``. bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses; their bits are carried over as int16.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .common import ModelConfig
from .transformer import LM

__all__ = ["params_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a) -> torch.Tensor:
    """A CPU tensor with ``a``'s values and dtype (bf16 bit for bit)."""
    a = np.array(a, order="C")          # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaf(tree: dict, name: str):
    parts = name.split(".")
    if parts[0] != "layers":
        return tree[name]
    node = tree["layers"]
    for key in parts[2:]:
        node = node[key]
    return np.asarray(node)[int(parts[1])]


def _paths(tree, prefix: str = "") -> set[str]:
    if not isinstance(tree, dict):
        return {prefix}
    return set().union(*(_paths(v, f"{prefix}{k}.") for k, v in tree.items())
                       ) if tree else set()


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: dict, *, device=None) -> LM:
    """The port's ``LM`` holding the reference tree's values, on
    ``device`` (the card when None)."""
    model = LM(cfg, device=resolve_device(device,
                                          what="params_from_numpy"))
    want = {n.rstrip(".") for n in _paths(tree)}
    have = {".".join(n.split(".")[:1] + n.split(".")[2:])
            if n.startswith("layers.") else n
            for n, _ in model.named_parameters()}
    if want != have:
        raise ValueError(f"tree leaves do not match the {cfg.name} "
                         f"parameters: {sorted(want ^ have)}")
    for name, p in model.named_parameters():
        src = tensor_from_numpy(_leaf(tree, name))
        if tuple(src.shape) != tuple(p.shape) or src.dtype != p.dtype:
            raise ValueError(f"{name}: tree has {tuple(src.shape)} "
                             f"{src.dtype}, the port expects "
                             f"{tuple(p.shape)} {p.dtype}")
        p.copy_(src)
    return model
