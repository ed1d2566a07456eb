"""Mixture-of-Experts feed-forward with top-k token-choice routing.

Counterpart of ``repro.models.moe``: the GShard grouped formulation. The
tokens split into ``g = distributed.ctx.moe_group_count()`` contiguous
groups (the data-parallel degree under ``activation_sharding``, 1 off a
mesh; 1 also when g does not divide the token count, as in the
reference), and each group routes its own tokens with its own capacity.
Each token picks its k highest router scores, softmax over those k gives
the gates; every expert owns ``cap`` slots in each group, and a (token,
expert) pair takes the next free slot of its group in the flattened
``(token, k)`` order or, past ``cap``, is dropped (capacity factor 1.25).
The experts' SwiGLU runs batched over their ``(e, g x cap)`` slot
tables, so the work is the capacity's, not the tokens' times e.

Three details keep the reference's results:

* top-k ties break toward the lower expert index, as
  ``jax.lax.top_k`` does: a stable descending sort, then its first k
  (``torch.topk`` promises no order among equal values, and in bf16
  equal router scores are common);
* a pair's slot is the count of earlier pairs of its group, in the
  flattened order, that chose the same expert (the reference's exclusive
  cumsum of the one-hot), computed by a stable sort on the (group,
  expert) index;
* the combine adds each token's gate-weighted expert outputs in float32
  in ascending expert order, starting from zero: the order of the
  reference's scatter-add over its ``(e, cap)`` table, where a token owns
  at most one slot per expert. It is a fixed sequence of gathers and
  adds, so the card gives the same bits every run (``index_add_``'s
  atomics would not).

``moe_tp`` is the tensor-parallel step's (``distributed.tp``), with the
experts on ``"model"`` as ``ecd``/``gecd`` place them: the tokens are
gathered whole on every model rank, the routing runs once for all of
them (expert parallelism changes no routing: the drops are those of the
unsharded MoE on the same tokens), each rank runs the SwiGLU
of its own experts on their capacity slots only, and each rank's
combine adds its own experts' gate-weighted rows in ascending expert
order; the ranks' partial outputs are then added in rank order
(``scatter_sum``, or an all-reduce) into the residual's layout.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..distributed.ctx import moe_group_count
from ..distributed.tp import split_ranks
from .common import ModelConfig, new_param

__all__ = ["MoE", "Routing", "capacity", "group_count", "route_scores",
           "place_pairs", "route", "combine", "combine_ranks", "moe", "moe_tp",
           "record_routing"]

# the routings made inside ``record_routing``
_ROUTING_LOG: Optional[list] = None


class MoE(nn.Module):
    """``router`` ``(d, e)``, ``w_gate``/``w_up`` ``(e, d, f)``, ``w_down``
    ``(e, f, d)``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
        self.router = new_param((d, e), cfg.dtype, device)
        self.w_gate = new_param((e, d, f), cfg.dtype, device)
        self.w_up = new_param((e, d, f), cfg.dtype, device)
        self.w_down = new_param((e, f, d), cfg.dtype, device)


class Routing(NamedTuple):
    expert: torch.Tensor   # (t, k) int64, by descending score
    gate: torch.Tensor     # (t, k) float32 softmax over the k scores
    slot: torch.Tensor     # (t, k) int64 place in the group's expert slots
    keep: torch.Tensor     # (t, k) bool, slot < cap
    cap: int               # slots per expert and group
    # (t,) float32: the k-th score's lead over the (k+1)-th, relative to
    # the k-th's magnitude (inf with k = e); a small margin marks a token
    # whose choice another summation order may change
    margin: torch.Tensor
    groups: int = 1        # contiguous token groups, t / groups tokens each

    def dropped_by_group(self) -> torch.Tensor:
        """Pairs dropped for capacity in each group, ``(groups,)``."""
        return (~self.keep).reshape(self.groups, -1).sum(dim=1)


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``tokens k / e x 1.25``, at least 8, a multiple
    of 8 (the reference's rounding)."""
    cap = int(tokens * cfg.moe_topk / cfg.moe_experts
              * cfg.moe_capacity_factor)
    return max(8, -(-cap // 8) * 8)


@contextlib.contextmanager
def record_routing():
    """Collect every ``Routing`` made inside, in call order (one per MoE
    layer a forward or decode step; a CUDA graph's replays make none, nor
    does a train step's backward, whose rematerialised layers route their
    tokens again), its tensors left on their device: the pairs dropped
    for capacity are ``(~r.keep).sum()`` of each."""
    global _ROUTING_LOG
    prev, _ROUTING_LOG = _ROUTING_LOG, []
    try:
        yield _ROUTING_LOG
    finally:
        _ROUTING_LOG = prev


def route_scores(scores: torch.Tensor, cfg: ModelConfig, groups: int = 1
                 ) -> Routing:
    """Routing of ``t`` tokens from their float32 router scores
    ``(t, e)``, in ``groups`` contiguous groups of ``t / groups``."""
    t, e = scores.shape
    k = cfg.moe_topk
    top, expert = torch.sort(scores, dim=-1, descending=True, stable=True)
    gate = torch.softmax(top[:, :k], dim=-1)
    margin = ((top[:, k - 1] - top[:, k]) / top[:, k - 1].abs()
              if e > k else torch.full((t,), float("inf"),
                                       device=scores.device))
    expert = expert[:, :k]
    slot, keep, cap = place_pairs(expert, cfg, groups)
    r = Routing(expert, gate, slot, keep, cap, margin, groups)
    # autograd's backward runs a graph task (-1 outside one): there the
    # checkpointed layers' forward is replayed, already logged
    in_backward = torch._C._current_graph_task_id() != -1
    if _ROUTING_LOG is not None and not in_backward:
        _ROUTING_LOG.append(r)
    return r


def place_pairs(expert: torch.Tensor, cfg: ModelConfig, groups: int = 1
                ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The capacity rule on chosen experts ``expert`` ``(t, k)`` in
    ``groups`` contiguous groups: each pair's slot ``(t, k)``, whether it
    is kept ``(t, k)``, and the slots per expert and group."""
    t, k = expert.shape
    flat = _group_expert(expert, groups, cfg.moe_experts).reshape(-1)
    # slot = earlier pairs of the group (flattened order) that chose the
    # same expert: a pair's place in the stable sort by (group, expert),
    # less that key's start
    by_expert, order = torch.sort(flat, stable=True)
    starts = torch.searchsorted(
        by_expert, torch.arange(groups * cfg.moe_experts, device=flat.device))
    slot = torch.empty_like(flat)
    slot[order] = torch.arange(flat.numel(), device=flat.device) \
        - starts[by_expert]
    slot = slot.reshape(t, k)
    cap = capacity(t // groups, cfg)
    return slot, slot < cap, cap


def _group_expert(expert: torch.Tensor, groups: int, e: int) -> torch.Tensor:
    """``group * e + expert`` of each pair of ``expert`` ``(t, k)``."""
    if groups == 1:
        return expert
    t = expert.shape[0]
    group = torch.arange(t, device=expert.device) // (t // groups)
    return group[:, None] * e + expert


def group_count(tokens: int) -> int:
    """The routing groups of ``tokens`` tokens: ``moe_group_count()``, or
    1 where it does not divide them (the reference's fallback)."""
    g = moe_group_count()
    return 1 if tokens % g else g


def route(params: MoE, x: torch.Tensor, cfg: ModelConfig) -> Routing:
    """Routing of ``x`` ``(b, s, d)``'s tokens, flattened in order, in
    ``group_count`` groups."""
    xt = x.reshape(-1, x.shape[-1])
    return route_scores((xt @ params.router).float(), cfg,
                        group_count(xt.shape[0]))


def combine(ye: torch.Tensor, r: Routing) -> torch.Tensor:
    """Each token's kept pairs' rows of ``ye`` ``(groups x e, cap, d)``
    (group major), weighted by their gates in float32 and added from zero
    in ascending expert order: ``(t, d)`` float32."""
    ge, cap, d = ye.shape
    expert, perm = torch.sort(r.expert, dim=-1)
    slot = torch.gather(r.slot, 1, perm)
    gate = torch.gather(r.gate, 1, perm)
    kept = torch.gather(r.keep, 1, perm)
    key = _group_expert(expert, r.groups, ge // r.groups)
    idx = torch.where(kept, key * cap + slot, 0)
    w = torch.where(kept, gate, 0.0)
    terms = ye.reshape(ge * cap, d)[idx].float() * w[..., None]  # (t, k, d)
    out = torch.zeros_like(terms[:, 0])
    for j in range(terms.shape[1]):
        out = out + terms[:, j]
    return out


def _slot_table(r: Routing, tl: int, e: int, device) -> torch.Tensor:
    """The ``(g x e, cap)`` table of rows of the padded tokens (each
    group's tl tokens, then its zero pad row, where empty): each kept
    pair owns its own (group, expert, slot); dropped pairs all go to a
    spare column cap, which is cut off (no mask, so no host sync)."""
    g, cap, k = r.groups, r.cap, r.expert.shape[1]
    pos = torch.arange(g * tl, device=device)
    row = pos + pos // tl                       # the token's padded row
    flat_row = row[:, None].expand(g * tl, k).reshape(-1)
    pad = (torch.arange(g, device=device) * (tl + 1) + tl)
    col = torch.where(r.keep, r.slot, cap).reshape(-1)
    table = pad.repeat_interleave(e)[:, None].repeat(1, cap + 1)
    table[_group_expert(r.expert, g, e).reshape(-1), col] = flat_row
    return table[:, :cap]


def _swiglu(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, dtype) -> torch.Tensor:
    """The experts' SwiGLU, batched over ``xe`` ``(e, n, d)``'s
    experts."""
    gate_h = torch.nn.functional.silu(torch.bmm(xe, w_gate).float())
    up_h = torch.bmm(xe, w_up).float()
    return torch.bmm((gate_h * up_h).to(dtype), w_down)


def moe(params: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: ``(b, s, d)`` -> ``(b, s, d)``."""
    b, s, d = x.shape
    e = cfg.moe_experts
    r = route(params, x, cfg)
    g, cap = r.groups, r.cap
    tl = b * s // g
    xt_pad = torch.cat([x.reshape(g, tl, d), x.new_zeros((g, 1, d))],
                       dim=1).reshape(g * (tl + 1), d)
    xe = xt_pad[_slot_table(r, tl, e, x.device)]             # (g e, cap, d)
    if g > 1:                                    # expert major for bmm
        xe = xe.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    ye = _swiglu(xe, params.w_gate, params.w_up, params.w_down, x.dtype)
    if g > 1:                                    # back to group major
        ye = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(g * e, cap, d)
    return combine(ye, r).to(x.dtype).reshape(b, s, d)


def combine_ranks(ye: torch.Tensor, r: Routing) -> torch.Tensor:
    """``combine`` on each model rank: ``ye`` ``(R, e / R x cap, d)``
    holds rank r's experts' slot rows (experts ``[r e / R, (r + 1) e /
    R)``, one routing group); each rank adds its own experts' kept pairs
    only, gate-weighted in float32, from zero in ascending expert order:
    ``(R, t, d)`` float32 partial outputs."""
    ranks, rows, d = ye.shape
    per = rows // r.cap                         # experts a rank
    expert, perm = torch.sort(r.expert, dim=-1)
    slot = torch.gather(r.slot, 1, perm)
    gate = torch.gather(r.gate, 1, perm)
    kept = torch.gather(r.keep, 1, perm)
    rank = torch.arange(ranks, device=ye.device)[:, None, None]
    mine = kept[None] & (expert[None] // per == rank)
    idx = torch.where(mine, ((expert % per) * r.cap + slot)[None], 0)
    w = torch.where(mine, gate[None], 0.0)
    terms = ye[rank, idx].float() * w[..., None]           # (R, t, k, d)
    out = torch.zeros_like(terms[:, :, 0])
    for j in range(terms.shape[2]):
        out = out + terms[:, :, j]
    return out


def moe_tp(params: MoE, x: torch.Tensor, cfg: ModelConfig, group, shape
           ) -> torch.Tensor:
    """``moe`` of the residual ``x`` (whole shape ``shape``, one routing
    group) on a data rank's model positions (``group``, a
    ``distributed.tp.Group``), in the residual's layout. ``params``'
    experts are stacked ``(R, e / R, ...)`` by ``tp_module_on`` where
    ``gecd`` puts them on ``"model"``, else whole (every rank runs them,
    replicated)."""
    b, s, d = shape
    e = cfg.moe_experts
    t = b * s
    full, once = group.whole(x, shape)
    group.placed("gtd", (1, t, d), once.reshape(1, t, d))
    r = route(params, once, cfg)
    if r.groups != 1:
        raise ValueError("the tensor-parallel MoE routes one group a data "
                         "rank (ctx.rank_local)")
    table = _slot_table(r, t, e, x.device)                    # (e, cap)
    if params.w_gate.dim() == 3:                  # whole: replicated
        group.placed("gec", (1, e, r.cap), table[None])
        xt_pad = torch.cat([once.reshape(t, d), once.new_zeros((1, d))])
        xe = group.placed("gecd", (1, e, r.cap, d), xt_pad[table][None])
        y = combine(_swiglu(xe[0], params.w_gate, params.w_up,
                            params.w_down, x.dtype), r)
        return group.from_replicated(y.to(x.dtype).view(shape), shape)
    ranks = group.size
    if torch._C._current_graph_task_id() == -1:          # not a replay
        rank = torch.arange(ranks, device=x.device)[:, None, None]
        kept = ((r.expert[None] // (e // ranks) == rank)
                & r.keep[None]).sum(dim=(1, 2))
        group.moe_ranks.append(([list(range(m * e // ranks,
                                             (m + 1) * e // ranks))
                                 for m in range(ranks)], kept))
    tables = split_ranks(table, 0, ranks)                # (R, e / R, cap)
    group.placed("gec", (1, e, r.cap), tables[:, None])
    xt_pad = torch.cat([full.reshape(ranks, t, d),
                        full.new_zeros((ranks, 1, d))], dim=1)
    rank = torch.arange(ranks, device=x.device)[:, None, None]
    xe = group.placed("gecd", (1, e, r.cap, d),
                      xt_pad[rank, tables][:, None])
    # rank r's experts are rows [r e / R, (r + 1) e / R) of the stacks:
    # one product over the ranks' experts
    ye = _swiglu(xe.reshape(e, r.cap, d), params.w_gate.flatten(0, 1),
                 params.w_up.flatten(0, 1), params.w_down.flatten(0, 1),
                 x.dtype)                                    # (e, cap, d)
    out = combine_ranks(ye.view(ranks, -1, d), r)
    return group.from_partials(out.view(ranks, b, s, d), shape).to(x.dtype)
