"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Counterpart of ``repro.models.rglru``. A Real-Gated Linear Recurrent Unit
over a ``rnn_width`` channel state:

    r_t = sigmoid(x_t W_r)                 (recurrence gate)
    i_t = sigmoid(x_t W_i)                 (input gate)
    a_t = a^(c r_t)   with a = sigmoid(lam), c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

inside Griffin's residual branch: a width-4 causal conv1d, the RG-LRU,
then a GELU-gated output projection. The gates, the decay and the state
are float32; GELU is the tanh approximation (``jax.nn.gelu``'s default).

The recurrence is a diagonal affine map, so prefill runs it as a
log-depth scan over the sequence (Hillis-Steele: step ``j`` combines
each position with the one ``2^j`` before it, 12 steps at 4096 tokens)
after folding ``h0`` into the first element, as the reference does
before its ``jax.lax.associative_scan``. The two scans associate the
products differently, so they agree to float32 rounding, not bitwise.
Decode runs one step of the recurrence.

``rglru_block_tp`` is the tensor-parallel training step's
(``distributed.tp``): each model rank on its ``w / R`` channels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..distributed.tp import (copy_to_ranks, gather_to_ranks, ranked_matmul,
                              reduce_from_ranks)
from .common import ModelConfig, new_param

__all__ = ["RglruState", "RGLRU", "rglru_block", "rglru_block_tp",
           "rglru_step_tp",
           "rglru_step", "make_rglru_state", "linear_scan"]

_C = 8.0


class RglruState(NamedTuple):
    h: torch.Tensor       # (b, w) float32 recurrent state
    conv: torch.Tensor    # (b, 3, w) last conv inputs (kernel 4)


class RGLRU(nn.Module):
    """``w_in``, ``w_gate_in`` ``(d, w)``, ``conv_k`` ``(4, w)``, ``w_r``,
    ``w_i`` ``(w, w)``, ``lam`` ``(w,)`` float32, ``w_out`` ``(w, d)``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        d = cfg.d_model
        w = cfg.rnn_width or d
        self.w_in = new_param((d, w), cfg.dtype, device)
        self.w_gate_in = new_param((d, w), cfg.dtype, device)
        self.conv_k = new_param((4, w), cfg.dtype, device)
        self.w_r = new_param((w, w), cfg.dtype, device)
        self.w_i = new_param((w, w), cfg.dtype, device)
        self.lam = new_param((w,), torch.float32, device)
        self.w_out = new_param((w, d), cfg.dtype, device)


def _gates(params: RGLRU, u: torch.Tensor):
    """u: ``(b, s, w)`` post-conv activations -> (a, gated input), both
    float32."""
    r = torch.sigmoid((u @ params.w_r).float())
    i = torch.sigmoid((u @ params.w_i).float())
    log_a0 = torch.nn.functional.logsigmoid(params.lam.float())
    log_a = _C * r * log_a0                           # (b, s, w), <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9))
    return a, beta * i * u.float()


def _conv(params: RGLRU, u: torch.Tensor, carry: torch.Tensor):
    """Causal conv1d of width 4. u: ``(b, s, w)``; carry: ``(b, 3, w)``."""
    ext = torch.cat([carry.to(u.dtype), u], dim=1)
    k = params.conv_k
    out = (ext[:, 3:] * k[3] + ext[:, 2:-1] * k[2] +
           ext[:, 1:-2] * k[1] + ext[:, :-3] * k[0])
    return out, ext[:, -3:]


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All ``h_t = a_t h_{t-1} + b_t`` (``h_{-1} = 0``) along axis 1, in
    ``ceil(log2 s)`` steps."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]],
                      dim=1)
        if 2 * off < s:
            a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return b


def _gate(params: RGLRU, x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu((x @ params.w_gate_in).float(),
                                    approximate="tanh")


def rglru_block(params: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                state: RglruState) -> tuple[torch.Tensor, RglruState]:
    """Griffin recurrent residual branch over a sequence. x: ``(b, s, d)``."""
    u = x @ params.w_in                              # (b, s, w)
    gate = _gate(params, x)
    u, conv_carry = _conv(params, u, state.conv)
    a, bx = _gates(params, u)
    h0 = state.h.float()
    bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]], dim=1)
    h = linear_scan(a, bx)
    out = (h * gate).to(x.dtype) @ params.w_out
    return out, RglruState(h=h[:, -1].to(state.h.dtype), conv=conv_carry)


def rglru_block_tp(params: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                   group, shape) -> torch.Tensor:
    """``rglru_block`` from a zero state of the residual's normed input
    ``x`` (whole shape ``shape``, in the ``bsd`` layout) on a data rank's
    model positions (``group``, a ``distributed.tp.Group``), in the
    residual's layout. Where ``tp_module_on`` splits the channels (the
    storage's ``"model"`` split of ``rnn_width``: ``w_in``,
    ``w_gate_in``, ``w_r``, ``w_i`` by columns, ``conv_k``'s channels,
    ``lam``, ``w_out`` by rows): the sequence gathered whole on every
    rank, ``w_in`` and ``w_gate_in`` column-parallel, the causal conv on
    the rank's channels, ``u``'s channels all-gathered (``w_r`` and
    ``w_i`` take the whole width as input: their rows are not split),
    the gates and the scan over the whole sequence on the rank's
    channels, ``w_out`` row-parallel and its partial sums added into the
    residual's layout (reduce-scatter onto the sequence, or all-reduce).
    With whole weights (the ranks do not divide the width) the block
    runs once on the whole sequence, replicated."""
    b = shape[0]
    if params.w_in.dim() == 2:
        _, once = group.whole(x, shape)
        w = params.w_in.shape[1]
        out, _ = rglru_block(params, once, cfg, RglruState(
            h=once.new_zeros((b, w), dtype=torch.float32),
            conv=once.new_zeros((b, 3, w))))
        return group.from_replicated(out, shape)
    ranks = group.size
    full, _ = group.whole(x, shape)                   # (R, b, s, d)
    u = ranked_matmul(full, params.w_in)              # (R, b, s, w / R)
    gate = torch.nn.functional.gelu(
        ranked_matmul(full, params.w_gate_in).float(), approximate="tanh")
    k = params.conv_k[:, :, None, None]               # (R, 4, 1, 1, w / R)
    ext = torch.cat([u.new_zeros((ranks, b, 3, u.shape[-1])), u], dim=2)
    u = (ext[:, :, 3:] * k[:, 3] + ext[:, :, 2:-1] * k[:, 2] +
         ext[:, :, 1:-2] * k[:, 1] + ext[:, :, :-3] * k[:, 0])
    u_all = gather_to_ranks(u, group, 2)              # (R, b, s, w)
    r = torch.sigmoid(ranked_matmul(u_all, params.w_r).float())
    i = torch.sigmoid(ranked_matmul(u_all, params.w_i).float())
    log_a0 = torch.nn.functional.logsigmoid(params.lam.float())
    log_a = _C * r * log_a0[:, None, None]
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9))
    h = linear_scan(a.flatten(0, 1), (beta * i * u.float()).flatten(0, 1))
    h = h.view(gate.shape)                            # from a zero state
    out = ranked_matmul((h * gate).to(x.dtype), params.w_out)
    return group.from_partials(out, shape)


def rglru_step(params: RGLRU, x: torch.Tensor, cfg: ModelConfig,
               state: RglruState) -> tuple[torch.Tensor, RglruState]:
    """Single-token decode. x: ``(b, 1, d)``."""
    u = x @ params.w_in
    gate = _gate(params, x)
    u, conv_carry = _conv(params, u, state.conv)
    a, bx = _gates(params, u)
    h = a[:, 0] * state.h.float() + bx[:, 0]
    out = (h[:, None, :] * gate).to(x.dtype) @ params.w_out
    return out, RglruState(h=h.to(state.h.dtype), conv=conv_carry)


def rglru_step_tp(params: RGLRU, x: torch.Tensor, cfg: ModelConfig,
                  group, h: torch.Tensor, conv: torch.Tensor
                  ) -> torch.Tensor:
    """``rglru_step`` of the replicated ``x`` ``(b, 1, d)`` on a data
    rank's model positions, the state updated in place. Where
    ``tp_module_on`` splits the channels (as in ``rglru_block_tp``) the
    state comes as the ranks' channels, ``h`` ``(R, b, w / R)`` float32
    and ``conv`` ``(R, b, 3, w / R)`` (``sharding.cache_specs`` puts the
    width on ``"model"``): ``w_in`` and ``w_gate_in`` column-parallel,
    the conv on the rank's channels, ``u``'s channels all-gathered for
    ``w_r`` and ``w_i``, the recurrence on the rank's channels, ``w_out``
    row-parallel and its partial sums all-reduced. With whole weights the
    step runs once on the whole state ``(b, w)``, ``(b, 3, w)``.
    Returns ``(b, 1, d)``, replicated."""
    if params.w_in.dim() == 2:
        out, st = rglru_step(params, x, cfg, RglruState(h, conv))
        h.copy_(st.h)
        conv.copy_(st.conv)
        return out
    full = copy_to_ranks(x, group)                    # (R, b, 1, d)
    u = ranked_matmul(full, params.w_in)              # (R, b, 1, w / R)
    gate = torch.nn.functional.gelu(
        ranked_matmul(full, params.w_gate_in).float(), approximate="tanh")
    k = params.conv_k[:, :, None, None]               # (R, 4, 1, 1, w / R)
    ext = torch.cat([conv.to(u.dtype), u], dim=2)     # (R, b, 4, w / R)
    u = (ext[:, :, 3:] * k[:, 3] + ext[:, :, 2:-1] * k[:, 2] +
         ext[:, :, 1:-2] * k[:, 1] + ext[:, :, :-3] * k[:, 0])
    conv.copy_(ext[:, :, -3:])
    u_all = gather_to_ranks(u, group, 2)              # (R, b, 1, w)
    r = torch.sigmoid(ranked_matmul(u_all, params.w_r).float())
    i = torch.sigmoid(ranked_matmul(u_all, params.w_i).float())
    log_a = _C * r * torch.nn.functional.logsigmoid(
        params.lam.float())[:, None, None]
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9))
    new = a[:, :, 0] * h.float() + (beta * i * u.float())[:, :, 0]
    out = ranked_matmul((new[:, :, None, :] * gate).to(x.dtype),
                        params.w_out)
    h.copy_(new.to(h.dtype))
    return reduce_from_ranks(out, group)


def make_rglru_state(cfg: ModelConfig, batch: int, n_layers: int, *,
                     device) -> RglruState:
    """Zeroed stacked states: h ``(n_layers, b, w)`` float32, conv
    ``(n_layers, b, 3, w)`` in the model's dtype."""
    w = cfg.rnn_width or cfg.d_model
    return RglruState(
        torch.zeros((n_layers, batch, w), dtype=torch.float32,
                    device=device),
        torch.zeros((n_layers, batch, 3, w), dtype=cfg.dtype, device=device))
