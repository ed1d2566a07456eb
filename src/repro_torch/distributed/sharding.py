"""Parameter, optimizer-state, batch and cache sharding rules
(counterpart of ``repro.distributed.sharding``).

The rules are the reference's, by name over dotted parameter paths:
``"model"`` on the Megatron dimensions, ``"__dp__"`` (FSDP over the
data axes, ZeRO-3) on the others, any dimension that its axes do not
divide replicated. They are written for the reference's tree, whose
stacked groups (``models.convert.STACKED``) carry a leading axis over
their members; the port's parameters are per member
(``layers.0.ffn.w_gate``). Applied to a per-member leaf the rules would
read it as stacked (the reference decides that by rank), and a MoE
expert leaf ``(e, d, f)`` would take the dense ``ffn.w_gate`` rule. So
each spec is computed on the leaf's reference shape (the member count
prepended) and the stacked axis is then dropped. Shapes come from the
parameters themselves, so a model on the meta device gives the specs of
a full-width model without allocating it.

Every spec here has one entry per dimension of the port's leaf (the
reference's ``P()`` is all ``None``).
"""

from __future__ import annotations

import math
from collections import namedtuple
from typing import Any

import torch

from ..launch.mesh import data_axes
from ..models.convert import _tree_path
from .ctx import PartitionSpec
from .ctx import PartitionSpec as P

__all__ = ["PartitionSpec", "NamedSharding", "param_specs",
           "param_shardings", "opt_state_specs", "batch_specs",
           "cache_specs", "leaf_shapes"]

# a spec on a mesh (the reference's ``jax.sharding.NamedSharding``)
NamedSharding = namedtuple("NamedSharding", ["mesh", "spec"])

# (path-suffix substring, spec WITHOUT the stacked-layer axis); earlier
# rules win (``src/repro/distributed/sharding.py``, ``_PARAM_RULES``)
_PARAM_RULES: tuple[tuple[str, tuple], ...] = (
    ("embed", ("model", "__dp__")),
    ("lm_head", ("__dp__", "model")),
    ("attn.wq", ("__dp__", "model")),
    ("attn.wk", ("__dp__", "model")),
    ("attn.wv", ("__dp__", "model")),
    ("attn.wo", ("model", "__dp__")),
    ("self_attn.wq", ("__dp__", "model")),
    ("self_attn.wk", ("__dp__", "model")),
    ("self_attn.wv", ("__dp__", "model")),
    ("self_attn.wo", ("model", "__dp__")),
    ("cross_attn.wq", ("__dp__", "model")),
    ("cross_attn.wk", ("__dp__", "model")),
    ("cross_attn.wv", ("__dp__", "model")),
    ("cross_attn.wo", ("model", "__dp__")),
    ("ffn.w_gate", ("__dp__", "model")),
    ("ffn.w_up", ("__dp__", "model")),
    ("ffn.w_down", ("model", "__dp__")),
    ("ffn.router", (None, None)),
    ("tm.wr", ("__dp__", "model")),
    ("tm.wk", ("__dp__", "model")),
    ("tm.wv", ("__dp__", "model")),
    ("tm.wo", ("model", "__dp__")),
    ("tm.w_lora_a", (None, None)),
    ("tm.w_lora_b", (None, None)),
    ("cm.wk", ("__dp__", "model")),
    ("cm.wv", ("model", "__dp__")),
    ("cm.wr", ("__dp__", "model")),
    ("rglru.w_in", ("__dp__", "model")),
    ("rglru.w_gate_in", ("__dp__", "model")),
    ("rglru.conv_k", (None, "model")),
    ("rglru.w_r", ("__dp__", "model")),
    ("rglru.w_i", ("__dp__", "model")),
    ("rglru.lam", ("model",)),
    ("rglru.w_out", ("model", "__dp__")),
)

# expert weights, 4-D when stacked (L, e, d, f): experts on "model", FSDP
# over d_model / d_ff on the data axes
_MOE_3D = {"w_gate": ("model", "__dp__", None),
           "w_up": ("model", "__dp__", None),
           "w_down": ("model", "__dp__", None)}


def _dp(mesh) -> tuple[tuple[str, ...], Any, int]:
    """The data axes, their spec entry (one name, a tuple, or None) and
    their size."""
    dp = data_axes(mesh)
    entry = dp if len(dp) > 1 else (dp[0] if dp else None)
    return dp, entry, math.prod(mesh.shape[a] for a in dp)


def _fallback(spec: tuple, shape: tuple, mesh) -> tuple:
    """Replicate any dim its axis does not divide; ``"__dp__"`` is the
    mesh's data axes."""
    _, dpa, dp_size = _dp(mesh)
    fixed = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            fixed.append(None)
        elif ax == "__dp__":
            fixed.append(dpa if dp_size > 1 and dim % dp_size == 0
                         else None)
        else:
            size = mesh.shape[ax] if ax in mesh.axis_names else 1
            fixed.append(ax if size > 1 and dim % size == 0 else None)
    return tuple(fixed)


def _spec_for(path: str, shape: tuple, mesh) -> tuple:
    """The reference's ``_spec_for`` on a reference-shaped leaf, padded
    with None to its rank."""
    ndim = len(shape)
    for key, spec in _MOE_3D.items():
        if path.endswith("ffn." + key) and ndim == 4:
            return _fallback((None,) + spec, shape, mesh)
    for suffix, spec in _PARAM_RULES:
        if suffix in path:
            if ndim == len(spec) + 1:        # layer-stacked
                spec = (None,) + spec
            if ndim != len(spec):
                return (None,) * ndim        # shape surprise: replicate
            return _fallback(spec, shape, mesh)
    return (None,) * ndim                    # norms, scalars: replicated


def leaf_shapes(params) -> dict[str, tuple[str, tuple, bool, torch.dtype]]:
    """Each port parameter's reference path, reference shape (the stacked
    groups' member count prepended), whether it is stacked, and dtype:
    ``params`` is a module (the meta device will do) or a flat dict of
    tensors keyed by the port's names."""
    named = dict(params.named_parameters()) if isinstance(
        params, torch.nn.Module) else dict(params)
    members: dict[tuple, int] = {}
    for name in named:
        path, row = _tree_path(name)
        if row is not None:
            members[path] = max(members.get(path, 0), row + 1)
    out = {}
    for name, p in named.items():
        path, row = _tree_path(name)
        shape = tuple(p.shape)
        if row is not None:
            shape = (members[path],) + shape
        out[name] = (".".join(path), shape, row is not None, p.dtype)
    return out


def _drop_stacked(spec: tuple, stacked: bool) -> P:
    return P(*(spec[1:] if stacked else spec))


def param_specs(params, mesh, *, serving: bool = False) -> dict[str, P]:
    """Spec of each parameter, keyed by the port's names.

    ``serving=True`` drops the FSDP (data) axes when the TP-sharded
    parameters fit in 12 GiB: inference keeps no optimizer state and
    re-reads the weights every token."""
    shapes = leaf_shapes(params)
    drop_dp = False
    if serving:
        mp = mesh.shape.get("model", 1)
        total = sum(math.prod(s[int(stacked):]) * dt.itemsize
                    for _, s, stacked, dt in shapes.values())
        drop_dp = (total / max(mp, 1)) < 12 * 2**30
    dp = set(data_axes(mesh))
    out = {}
    for name, (path, shape, stacked, _) in shapes.items():
        spec = _spec_for(path, shape, mesh)
        if drop_dp:
            spec = tuple(None if (a in dp or (isinstance(a, tuple)
                                              and set(a) & dp)) else a
                         for a in spec)
        out[name] = _drop_stacked(spec, stacked)
    return out


def param_shardings(params, mesh) -> dict[str, NamedSharding]:
    return {name: NamedSharding(mesh, spec)
            for name, spec in param_specs(params, mesh).items()}


def opt_state_specs(params, mesh, *, zero: bool = True) -> dict[str, P]:
    """Optimizer-moment specs. ``zero=True`` also shards a moment over
    the data axes on the first unsharded dim that they divide and that
    holds at least 8 rows a rank (ZeRO), where the parameter is not
    FSDP-sharded already. The dim is chosen on the reference's stacked
    shape: where it is the stacked axis (small meshes, deep models), the
    port's member keeps its moment whole."""
    shapes = leaf_shapes(params)
    dp, dpa, dp_size = _dp(mesh)
    out = {}
    for name, (path, shape, stacked, _) in shapes.items():
        parts = list(_spec_for(path, shape, mesh))
        used = {a for ax in parts if ax is not None
                for a in (ax if isinstance(ax, tuple) else (ax,))}
        if zero and not used & set(dp):
            for i, (dim, ax) in enumerate(zip(shape, parts)):
                if ax is None and dp_size > 1 and dim % dp_size == 0 \
                        and dim >= dp_size * 8:
                    parts[i] = dpa
                    break
        out[name] = _drop_stacked(tuple(parts), stacked)
    return out


def batch_specs(cfg, mesh, kind: str) -> dict[str, P]:
    """Input specs of a shape cell: tokens and labels ``(b, s)`` (and the
    enc-dec family's ``src_embeds``) with the batch over the data axes."""
    _, dpa, _ = _dp(mesh)
    out = {"tokens": P(dpa, None), "labels": P(dpa, None)}
    if cfg.family == "encdec":
        out["src_embeds"] = P(dpa, None, None)
    if kind != "train":
        out.pop("labels")
    return out


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def cache_specs(cfg, caches, mesh):
    """Decode-cache specs, in the caches' own structure: the batch dim
    (dim 1 of a stacked ``(L, b, ...)`` leaf) over the data axes; on
    ``"model"`` a KV cache's heads, else its head width, else its
    sequence, and another leaf's longest dim past the batch when it
    divides and holds at least 8 rows a rank; the rest replicated."""
    _, dpa, dp_size = _dp(mesh)
    mp_size = mesh.shape.get("model", 1)

    def spec(leaf):
        shape = tuple(leaf.shape)
        parts: list = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % dp_size == 0 and dp_size > 1:
            parts[1] = dpa
        if mp_size > 1 and len(shape) == 5:    # (L, b, h, s, dh) kv cache
            for cand in (2, 4, 3):
                if shape[cand] % mp_size == 0 and shape[cand] >= mp_size:
                    parts[cand] = "model"
                    break
        elif mp_size > 1 and len(shape) >= 3:
            cand = max(range(2, len(shape)), key=lambda i: shape[i])
            if shape[cand] % mp_size == 0 and shape[cand] >= mp_size * 8:
                parts[cand] = "model"
        return P(*parts)

    return _tree_map(spec, caches)
