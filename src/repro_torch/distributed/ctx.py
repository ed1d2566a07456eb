"""Ambient activation-sharding context (counterpart of
``repro.distributed.ctx``).

``activation_sharding(mesh)`` pushes the mesh's data-parallel and
tensor-parallel axes on a stack, as the reference does; the model code
reads it through ``moe_group_count()`` (the MoE routes its tokens in as
many groups as the data-parallel degree) and ``seq_parallel_enabled()``.

The reference's ``constrain(x, kind)`` asks GSPMD for a layout with
``with_sharding_constraint``. The port's ``constrain`` returns ``x``
unchanged: its tensor-parallel step (``distributed.tp``, the models'
``*_tp`` functions) computes each activation in the layout
``constraint_spec(shape, kind)`` names, which is the single source of
those decisions, fallbacks included. It gives the ``PartitionSpec`` the
reference would ask for, for every kind it knows:

    bsd        (b, s, d)  batch over the data axes; seq over "model"
               (sequence parallelism) when seq_parallel and it divides
    bsd_batch_only  (b, s, d)  batch only (recurrent blocks)
    bshd       (b, s, h, dh) heads over "model", else the query sequence
    bshd_kv    (b, s, h, dh) heads over "model" or replicated
    bhsd       (b, h, s, dh)
    logits_v   (b, s, v) vocab over "model", else the sequence
    ecd        (e, c, d) experts over "model"
    gtd, gecd, gec, gt  the MoE's group-leading tensors: groups over the
               data axes, experts over "model"

Outside ``activation_sharding``, or on a mesh without a ``"model"``
axis, it is None (the reference makes no request there).

``rank_local()`` is the port's own: inside it, code runs as one
data-parallel rank sees it (its rows are one MoE group), which is how
``train.step``'s sharded step computes each rank's loss.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

__all__ = ["PartitionSpec", "activation_sharding", "rank_local", "constrain",
           "constraint_spec", "moe_group_count", "seq_parallel_enabled"]

_STACK: list[dict] = []


class PartitionSpec(tuple):
    """One entry per dimension: None (whole), a mesh axis name, or a
    tuple of names (the dimension split over their product, the first
    name major), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@contextlib.contextmanager
def activation_sharding(mesh, *, seq_parallel: bool = True):
    """Under ``mesh`` (anything with ``axis_names`` and a ``shape`` dict):
    the data axes are ``"pod"`` and ``"data"``, the tensor-parallel axis
    ``"model"``."""
    names = set(mesh.axis_names)
    dp = tuple(a for a in ("pod", "data") if a in names)
    entry = {
        "mesh": mesh,
        "dp": dp if len(dp) > 1 else (dp[0] if dp else None),
        "tp": "model" if "model" in names else None,
        "seq_parallel": seq_parallel,
        "mp_size": mesh.shape["model"] if "model" in names else 1,
        "dp_size": math.prod(mesh.shape[a] for a in dp) if dp else 1,
    }
    _STACK.append(entry)
    try:
        yield
    finally:
        _STACK.pop()


@contextlib.contextmanager
def rank_local():
    """Run as one data-parallel rank: one MoE group, no axes."""
    _STACK.append({"mesh": None, "dp": None, "tp": None,
                   "seq_parallel": False, "mp_size": 1, "dp_size": 1})
    try:
        yield
    finally:
        _STACK.pop()


def _active() -> Optional[dict]:
    return _STACK[-1] if _STACK else None


def _divisible(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def constraint_spec(shape, kind: str) -> Optional[P]:
    """The layout the reference's ``constrain`` requests for a tensor of
    ``shape`` and ``kind`` under the active context (None: no request)."""
    ctx = _active()
    if ctx is None or ctx["tp"] is None:
        return None
    shape = tuple(shape)
    ndim = len(shape)
    dp, tp, mp = ctx["dp"], ctx["tp"], ctx["mp_size"]
    dps = ctx["dp_size"]
    if kind == "bsd" and ndim == 3:
        seq = tp if (ctx["seq_parallel"] and _divisible(shape[1], mp)) \
            else None
        return P(dp, seq, None)
    if kind == "bsd_batch_only" and ndim == 3:
        return P(dp, None, None)
    if kind == "bshd" and ndim == 4:
        if _divisible(shape[2], mp):
            return P(dp, None, tp, None)
        if _divisible(shape[1], mp):
            return P(dp, tp, None, None)
        return P(dp, None, None, None)
    if kind == "bshd_kv" and ndim == 4:
        return P(dp, None, tp if _divisible(shape[2], mp) else None, None)
    if kind == "bhsd" and ndim == 4:
        return P(dp, tp if _divisible(shape[1], mp) else None, None, None)
    if kind == "logits_v" and ndim == 3:
        if _divisible(shape[2], mp):
            return P(dp, None, tp)
        if _divisible(shape[1], mp):
            return P(dp, tp, None)
        return P(dp, None, None)
    if kind == "ecd" and ndim == 3:
        return P(tp if _divisible(shape[0], mp) else None, None, None)
    group = dp if ndim and _divisible(shape[0], dps) else None
    if kind == "gtd" and ndim == 3:
        return P(group, None, None)
    if kind == "gecd" and ndim == 4:
        return P(group, tp if _divisible(shape[1], mp) else None, None, None)
    if kind == "gec" and ndim == 3:
        return P(group, tp if _divisible(shape[1], mp) else None, None)
    if kind == "gt" and ndim == 2:
        return P(group, None)
    return None


def constrain(x, kind: str):
    """``x`` unchanged: the tensor-parallel step computes in the layout
    ``constraint_spec`` names (``distributed.tp``)."""
    return x


def moe_group_count() -> int:
    """Number of MoE routing groups = the data-parallel degree (1 off a
    mesh)."""
    ctx = _active()
    return int(ctx["dp_size"]) if ctx else 1


def seq_parallel_enabled() -> bool:
    ctx = _active()
    return bool(ctx and ctx["seq_parallel"])
