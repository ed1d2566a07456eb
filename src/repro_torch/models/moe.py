"""Mixture-of-Experts feed-forward with top-k token-choice routing.

Counterpart of ``repro.models.moe``: the GShard grouped formulation with
one group (the reference's group count is the data-parallel degree,
which is 1 off a mesh). Each token picks its k highest router scores,
softmax over those k gives the gates; every expert owns ``cap`` slots,
and a (token, expert) pair takes the next free slot in the flattened
``(token, k)`` order or, past ``cap``, is dropped (capacity factor 1.25).
The experts' SwiGLU runs batched over their ``(e, cap)`` slot tables, so
the work is the capacity's, not the tokens' times e.

Three details keep the reference's results:

* top-k ties break toward the lower expert index, as
  ``jax.lax.top_k`` does: a stable descending sort, then its first k
  (``torch.topk`` promises no order among equal values, and in bf16
  equal router scores are common);
* a pair's slot is the count of earlier pairs, in the flattened order,
  that chose the same expert (the reference's exclusive cumsum of the
  one-hot), computed by a stable sort on the expert index;
* the combine adds each token's gate-weighted expert outputs in float32
  in ascending expert order, starting from zero: the order of the
  reference's scatter-add over its ``(e, cap)`` table, where a token owns
  at most one slot per expert. It is a fixed sequence of gathers and
  adds, so the card gives the same bits every run (``index_add_``'s
  atomics would not).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
from torch import nn

from .common import ModelConfig, new_param

__all__ = ["MoE", "Routing", "capacity", "route_scores", "route", "combine",
           "moe", "record_routing"]

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
    slot: torch.Tensor     # (t, k) int64 place in the expert's slots
    keep: torch.Tensor     # (t, k) bool, slot < cap
    cap: int
    # (t,) float32: the k-th score's lead over the (k+1)-th, relative to
    # the k-th's magnitude (inf with k = e); a small margin marks a token
    # whose choice another summation order may change
    margin: torch.Tensor


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


def route_scores(scores: torch.Tensor, cfg: ModelConfig) -> Routing:
    """Routing of ``t`` tokens from their float32 router scores
    ``(t, e)``."""
    t, e = scores.shape
    k = cfg.moe_topk
    top, expert = torch.sort(scores, dim=-1, descending=True, stable=True)
    gate = torch.softmax(top[:, :k], dim=-1)
    margin = ((top[:, k - 1] - top[:, k]) / top[:, k - 1].abs()
              if e > k else torch.full((t,), float("inf"),
                                       device=scores.device))
    expert = expert[:, :k]
    flat = expert.reshape(-1)
    # slot = earlier pairs (flattened order) that chose the same expert:
    # a pair's place in the stable sort by expert, less its expert's start
    by_expert, order = torch.sort(flat, stable=True)
    starts = torch.searchsorted(by_expert,
                                torch.arange(e, device=flat.device))
    slot = torch.empty_like(flat)
    slot[order] = torch.arange(flat.numel(), device=flat.device) \
        - starts[by_expert]
    slot = slot.reshape(t, k)
    cap = capacity(t, cfg)
    r = Routing(expert, gate, slot, slot < cap, cap, margin)
    # autograd's backward runs a graph task (-1 outside one): there the
    # checkpointed layers' forward is replayed, already logged
    in_backward = torch._C._current_graph_task_id() != -1
    if _ROUTING_LOG is not None and not in_backward:
        _ROUTING_LOG.append(r)
    return r


def route(params: MoE, x: torch.Tensor, cfg: ModelConfig) -> Routing:
    """Routing of ``x`` ``(b, s, d)``'s tokens, flattened in order."""
    xt = x.reshape(-1, x.shape[-1])
    return route_scores((xt @ params.router).float(), cfg)


def combine(ye: torch.Tensor, r: Routing) -> torch.Tensor:
    """Each token's kept pairs' rows of ``ye`` ``(e, cap, d)``, weighted
    by their gates in float32 and added from zero in ascending expert
    order: ``(t, d)`` float32."""
    e, cap, d = ye.shape
    expert, perm = torch.sort(r.expert, dim=-1)
    slot = torch.gather(r.slot, 1, perm)
    gate = torch.gather(r.gate, 1, perm)
    kept = torch.gather(r.keep, 1, perm)
    idx = torch.where(kept, expert * cap + slot, 0)
    w = torch.where(kept, gate, 0.0)
    terms = ye.reshape(e * cap, d)[idx].float() * w[..., None]  # (t, k, d)
    out = torch.zeros_like(terms[:, 0])
    for j in range(terms.shape[1]):
        out = out + terms[:, j]
    return out


def moe(params: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: ``(b, s, d)`` -> ``(b, s, d)``."""
    b, s, d = x.shape
    e = cfg.moe_experts
    xt = x.reshape(b * s, d)
    r = route(params, x, cfg)
    tl = xt.shape[0]

    # (e, cap) table of token rows (the zero pad row tl where empty): each
    # kept pair owns its own (expert, slot); dropped pairs all go to a
    # spare column cap, which is cut off (no mask, so no host sync)
    flat_tok = torch.arange(tl, device=x.device)[:, None].expand(
        tl, cfg.moe_topk).reshape(-1)
    col = torch.where(r.keep, r.slot, r.cap).reshape(-1)
    table = torch.full((e, r.cap + 1), tl, dtype=torch.long,
                       device=x.device)
    table[r.expert.reshape(-1), col] = flat_tok
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    xe = xt_pad[table[:, :r.cap]]                        # (e, cap, d)

    gate_h = torch.nn.functional.silu(torch.bmm(xe, params.w_gate).float())
    up_h = torch.bmm(xe, params.w_up).float()
    ye = torch.bmm((gate_h * up_h).to(x.dtype), params.w_down)  # (e, cap, d)
    return combine(ye, r).to(x.dtype).reshape(b, s, d)
