"""RWKV-6 "Finch" time-mix and channel-mix blocks (attention-free).

Counterpart of ``repro.models.rwkv6``. Per head, a ``d_k x d_v`` state:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with the data-dependent decay ``w_t = exp(-exp(lora(x_t)))``, its log
clamped to ``[-0.5, 0)`` in both forms (the floor bounds the chunked
form's factored ``exp(+-cum)``). Two forms:

* ``rwkv_time_mix_chunked`` (prefill): chunks of 64 tokens, an O(C^2)
  masked-decay product within a chunk and the carried state across
  chunks. The reference runs a ``lax.scan`` over chunks; here every
  chunk's intra-chunk terms are batched products over all chunks at
  once, and only the state, ``S' = S exp(total) + K_tail^T V``, runs as
  a loop over chunks, whose states then meet each chunk's decayed r in
  one batched product. Each chunk's terms are the reference's, in its
  dtypes: model-dtype operands with float32 products where it asks for
  ``preferred_element_type=float32``, float32 operands where it upcasts.
* ``rwkv_time_mix_step`` (decode): one token, O(1) in the sequence.

Token shift (the ``x_{t-1}`` mix) takes the previous token in the
sequence and a carried last token across calls.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..distributed.tp import (copy_to_ranks, gather_from_ranks,
                              ranked_matmul, reduce_from_ranks, scatter_sum,
                              split_to_ranks)
from .common import ModelConfig, new_param

__all__ = ["RwkvState", "RwkvTimeMix", "RwkvChannelMix",
           "rwkv_time_mix_chunked", "rwkv_time_mix_step",
           "rwkv_channel_mix", "make_rwkv_state", "rwkv_time_mix_chunked_tp",
           "rwkv_channel_mix_tp", "rwkv_time_mix_step_tp", "CHUNK"]

CHUNK = 64
LORA_RANK = 64


class RwkvState(NamedTuple):
    s: torch.Tensor        # (b, h, dk, dv) float32 wkv state
    x_prev: torch.Tensor   # (b, d) last token (token shift)


class RwkvTimeMix(nn.Module):
    """Token-shift mixes ``mix_{r,k,v,w}`` ``(d,)``, ``wr``/``wk``/``wv``/
    ``wo`` ``(d, d)``, the decay LoRA ``w_lora_a`` ``(d, 64)`` and
    ``w_lora_b`` ``(64, d)``, ``w_bias`` and ``u_bonus`` ``(d,)``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        for name in ("mix_r", "mix_k", "mix_v", "mix_w"):
            setattr(self, name, new_param((d,), dt, device))
        for name in ("wr", "wk", "wv", "wo"):
            setattr(self, name, new_param((d, d), dt, device))
        self.w_lora_a = new_param((d, LORA_RANK), dt, device)
        self.w_lora_b = new_param((LORA_RANK, d), dt, device)
        self.w_bias = new_param((d,), dt, device)
        self.u_bonus = new_param((d,), dt, device)


class RwkvChannelMix(nn.Module):
    """``mix_k``, ``mix_r`` ``(d,)``, ``wk`` ``(d, f)``, ``wv`` ``(f, d)``,
    ``wr`` ``(d, d)``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
        self.mix_k = new_param((d,), dt, device)
        self.mix_r = new_param((d,), dt, device)
        self.wk = new_param((d, f), dt, device)
        self.wv = new_param((f, d), dt, device)
        self.wr = new_param((d, d), dt, device)


def _mix(params, name: str, x, x_shift):
    m = getattr(params, f"mix_{name}").float()
    return (x * (1 - m) + x_shift * m).to(x.dtype)


def _project(params: RwkvTimeMix, x, x_shift):
    """Token-shifted projections. x, x_shift: ``(b, s, d)``."""
    r = _mix(params, "r", x, x_shift) @ params.wr
    k = _mix(params, "k", x, x_shift) @ params.wk
    v = _mix(params, "v", x, x_shift) @ params.wv
    return r, k, v, _log_decay(params, x, x_shift)


def _log_decay(params: RwkvTimeMix, x, x_shift):
    """The data-dependent log-decay (the LoRA on the ``w`` mix), float32,
    clamped to ``[-0.5, 0)``."""
    w_in = _mix(params, "w", x, x_shift) @ params.w_lora_a
    w_log = torch.tanh(w_in.float()) @ params.w_lora_b.float() \
        + params.w_bias.float()
    return torch.clamp_min(-torch.exp(torch.clamp(w_log, -12.0, 4.0)), -0.5)


def _f32_mm(a, b):
    """``a @ b`` of model-dtype operands accumulated and returned in
    float32 (the reference's ``preferred_element_type=float32``)."""
    return torch.matmul(a.float(), b.float())


def _wkv_chunked(r, k, v, logw, u, s0, chunk: int) -> tuple:
    """The chunked WKV recurrence of ``B`` rows of ``h`` heads: r, k, v
    ``(B, s, h dh)`` in the model's dtype, logw ``(B, s, h dh)`` float32,
    u ``(B or 1, h, dh)`` float32, s0 ``(B, h, dh, dh)``. Returns the
    output ``(B, s, h dh)`` in r's dtype and the final state (float32)."""
    b, s, d = r.shape
    h, dh = u.shape[1], u.shape[2]
    nc = s // chunk

    def chunks(t):      # (b, s, d) -> (b, h, nc, chunk, dh)
        return t.reshape(b, nc, chunk, h, dh).permute(0, 3, 1, 2, 4)

    rc, kc, vc, lw = chunks(r), chunks(k), chunks(v), chunks(logw)
    dt = rc.dtype
    cum = torch.cumsum(lw, dim=3)                     # inclusive
    cumex = cum - lw                                  # exclusive
    total = cum[:, :, :, -1, :]                       # (b, h, nc, dh)
    r_dec = rc * torch.exp(cumex).to(dt)
    # intra-chunk: (t, j < t) with the decay factored as
    # exp(cumex_t) exp(-cum_j), safe under the -0.5 log-decay floor
    att = _f32_mm(r_dec, (kc * torch.exp(-cum).to(dt)).transpose(-1, -2))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                 device=r.device), -1)
    att = att * mask
    out_intra = _f32_mm(att.to(dt), vc)
    # the bonus diagonal u k_t v_t
    out_diag = torch.sum(rc.float() * (kc.float() * u[:, :, None, None]),
                         dim=-1, keepdim=True) * vc.float()
    k_tail = kc * torch.exp(total[:, :, :, None, :] - cum).to(dt)
    kv_tail = _f32_mm(k_tail.transpose(-1, -2), vc)   # (b, h, nc, dh, dh)
    decay = torch.exp(total)[..., None]               # (b, h, nc, dh, 1)

    S = s0.float()
    starts = []
    for c in range(nc):
        starts.append(S)
        S = S * decay[:, :, c] + kv_tail[:, :, c]
    out_state = torch.matmul(r_dec.float(), torch.stack(starts, dim=2))
    out = out_state + out_intra + out_diag            # (b, h, nc, chunk, dh)
    return out.permute(0, 2, 3, 1, 4).reshape(b, s, d).to(dt), S


def _check_chunks(s: int, chunk: int) -> None:
    if s % chunk:
        raise ValueError(f"rwkv chunked form needs the sequence ({s}) to "
                         f"be a multiple of the chunk ({chunk})")


def rwkv_time_mix_chunked(params: RwkvTimeMix, x: torch.Tensor,
                          cfg: ModelConfig, state: RwkvState,
                          chunk: int = CHUNK
                          ) -> tuple[torch.Tensor, RwkvState]:
    """Chunked-parallel form. x: ``(b, s, d)`` with ``s % chunk == 0``."""
    b, s, d = x.shape
    _check_chunks(s, chunk)
    dh = cfg.rwkv_head_dim
    x_shift = torch.cat([state.x_prev[:, None, :], x[:, :-1]], dim=1)
    r, k, v, logw = _project(params, x, x_shift)
    u = params.u_bonus.float().reshape(1, d // dh, dh)
    out, S = _wkv_chunked(r, k, v, logw, u, state.s, chunk)
    return out.to(x.dtype) @ params.wo, RwkvState(s=S.to(state.s.dtype),
                                                  x_prev=x[:, -1, :])


def rwkv_time_mix_chunked_tp(params: RwkvTimeMix, x: torch.Tensor,
                             cfg: ModelConfig, group,
                             chunk: int = CHUNK) -> torch.Tensor:
    """``rwkv_time_mix_chunked`` from a zero state on a data rank's model
    positions (``group``, a ``distributed.tp.Group``): ``x`` ``(b, s,
    d)`` the batch-only residual's normed input, replicated (the whole
    sequence and width on every rank); returns the output so. Token
    shift, the mixes and the decay LoRA run once on the whole ``d``.
    Where ``tp_module_on`` splits ``wr``/``wk``/``wv`` by columns and
    ``wo`` by rows (the ranks divide the heads: ``bhsd``'s heads over
    ``"model"``), each rank projects its heads' columns
    (column-parallel), takes ``logw``'s and ``u_bonus``'s columns of its
    heads, runs the recurrence on its heads and its row block of ``wo``
    (row-parallel); the partial sums are added over the ranks (a float32
    all-reduce in rank order). Where the ranks would cut a head (the
    storage's column split is by ``d_model``, not by heads), the weights
    come whole and the whole time mix runs once, replicated (``bhsd``
    replicated)."""
    b, s, d = x.shape
    _check_chunks(s, chunk)
    dh = cfg.rwkv_head_dim
    heads = d // dh
    ranks = group.size
    split = params.wr.dim() == 3
    zeros = x.new_zeros((b, d))
    if not split:
        out, _ = rwkv_time_mix_chunked(
            params, x, cfg, RwkvState(s=x.new_zeros(
                (b, heads, dh, dh), dtype=torch.float32), x_prev=zeros),
            chunk)
        group.record("bhsd", (b, heads, s, dh), None)
        return out
    x_shift = torch.cat([zeros[:, None, :], x[:, :-1]], dim=1)
    mine = heads // ranks

    def project(name, w):
        t = ranked_matmul(copy_to_ranks(_mix(params, name, x, x_shift),
                                        group), w)
        group.placed("bhsd", (b, heads, s, dh),
                     t.view(ranks, b, s, mine, dh).transpose(2, 3))
        return t.reshape(ranks * b, s, d // ranks)

    r, k, v = (project(n, getattr(params, "w" + n)) for n in "rkv")
    logw = split_to_ranks(_log_decay(params, x, x_shift), group, 2)
    logw = logw.reshape(ranks * b, s, d // ranks)
    u = params.u_bonus.float().reshape(ranks, 1, mine, dh).expand(
        ranks, b, mine, dh).reshape(ranks * b, mine, dh)
    out, _ = _wkv_chunked(r, k, v, logw, u, x.new_zeros(
        (ranks * b, mine, dh, dh), dtype=torch.float32), chunk)
    out = ranked_matmul(out.to(x.dtype).view(ranks, b, s, -1), params.wo)
    return reduce_from_ranks(out, group)


def _step_inputs(params: RwkvTimeMix, x: torch.Tensor, cfg: ModelConfig,
                 x_prev: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """A decode step's r, k, v and decay ``w`` ``(b, h, dh)`` and the
    bonus ``u`` ``(h, dh)``, float32, from the whole weights."""
    b, _, d = x.shape
    dh = cfg.rwkv_head_dim
    r, k, v, logw = _project(params, x, x_prev[:, None, :])
    return (r.reshape(b, -1, dh).float(), k.reshape(b, -1, dh).float(),
            v.reshape(b, -1, dh).float(), torch.exp(logw.reshape(b, -1, dh)),
            params.u_bonus.float().reshape(-1, dh))


def _wkv_step(r, k, v, w, u, S) -> tuple[torch.Tensor, torch.Tensor]:
    """One token's recurrence on float32 ``(.., h, dk)`` r, k, w, ``(..,
    h, dv)`` v, ``u`` broadcasting as ``(.., h, dk)`` and the state ``S``
    ``(.., h, dk, dv)``: the output ``(.., h, 1, dv)`` and the new
    state."""
    kv = k[..., :, None] * v[..., None, :]
    out = torch.matmul(r[..., None, :], S + u[..., None] * kv)
    return out, S * w[..., None] + kv


def rwkv_time_mix_step(params: RwkvTimeMix, x: torch.Tensor,
                       cfg: ModelConfig, state: RwkvState
                       ) -> tuple[torch.Tensor, RwkvState]:
    """Single-token decode. x: ``(b, 1, d)`` -> ``(b, 1, d)``."""
    b, _, d = x.shape
    r, k, v, w, u = _step_inputs(params, x, cfg, state.x_prev)
    out, S_new = _wkv_step(r, k, v, w, u, state.s.float())
    out = out.reshape(b, 1, d).to(x.dtype) @ params.wo
    return out, RwkvState(s=S_new.to(state.s.dtype), x_prev=x[:, -1, :])


def rwkv_time_mix_step_tp(params: RwkvTimeMix, x: torch.Tensor,
                          cfg: ModelConfig, group, s: torch.Tensor,
                          x_prev: torch.Tensor) -> torch.Tensor:
    """``rwkv_time_mix_step`` of the replicated ``x`` ``(b, 1, d)`` on a
    data rank's model positions; ``x_prev`` ``(b, d)`` whole. Where
    ``tp_module_on`` splits ``wr``/``wk``/``wv`` by heads (as
    ``rwkv_time_mix_chunked_tp``), the state comes as the ranks' heads,
    ``s`` ``(R, b, h / R, dh, dh)`` (``sharding.cache_specs`` puts the
    heads on ``"model"``): the mixes and the decay LoRA once, each rank
    its heads' projections, decay and bonus, its heads' recurrence, its
    rows of ``wo``, the partial sums all-reduced. Where the weights come
    whole and the state as the ranks' value columns, ``s`` ``(R, b, h,
    dh, dh / R)`` (the ranks divide the head width but not the heads):
    r, k and v once, each rank its columns of the state and of ``k v``,
    and of the output over the whole key width (so nothing is summed
    over the ranks), the columns all-gathered in rank order and ``wo``
    whole. Otherwise the whole step once on the whole state ``(b, h,
    dh, dh)``. The state is updated in place; returns ``(b, 1, d)``,
    replicated."""
    if params.wr.dim() == 2:
        if s.dim() == 5:
            return _time_mix_step_by_columns(params, x, cfg, group, s,
                                             x_prev)
        out, st = rwkv_time_mix_step(params, x, cfg, RwkvState(s, x_prev))
        s.copy_(st.s)
        return out
    b, _, d = x.shape
    dh = cfg.rwkv_head_dim
    ranks = group.size
    mine = d // dh // ranks
    x_shift = x_prev[:, None, :]

    def project(name):
        t = ranked_matmul(copy_to_ranks(_mix(params, name, x, x_shift),
                                        group), getattr(params, "w" + name))
        return t.view(ranks, b, mine, dh).float()

    r, k, v = project("r"), project("k"), project("v")
    logw = split_to_ranks(_log_decay(params, x, x_shift), group, 2)
    w = torch.exp(logw.reshape(ranks, b, mine, dh))
    u = params.u_bonus.float().reshape(ranks, 1, mine, dh)
    out, S_new = _wkv_step(r, k, v, w, u, s.float())   # (R, b, h / R, ..)
    s.copy_(S_new.to(s.dtype))
    out = ranked_matmul(out.reshape(ranks, b, 1, d // ranks).to(x.dtype),
                        params.wo)
    return reduce_from_ranks(out, group)


def _time_mix_step_by_columns(params: RwkvTimeMix, x: torch.Tensor,
                              cfg: ModelConfig, group, s: torch.Tensor,
                              x_prev: torch.Tensor) -> torch.Tensor:
    """``rwkv_time_mix_step_tp`` with the state ``(L, b, h, dk, dv)``
    split over its value width, ``s`` ``(R, b, h, dk, dv / R)``. The
    key width (dim 3) is never the split: ``cache_specs`` tries dim 4
    before it and ``dk == dv``."""
    b, _, d = x.shape
    r, k, v, w, u = _step_inputs(params, x, cfg, x_prev)
    out, S_new = _wkv_step(r, k, split_to_ranks(v, group, 2), w, u,
                           s.float())             # (R, b, h, .., dv / R)
    s.copy_(S_new.to(s.dtype))
    out = gather_from_ranks(out, group, 3)        # (b, h, 1, dv)
    return out.reshape(b, 1, d).to(x.dtype) @ params.wo


def make_rwkv_state(cfg: ModelConfig, batch: int, n_layers: int, *,
                    device) -> RwkvState:
    """Zeroed stacked states: s ``(n_layers, b, h, dh, dh)`` float32,
    x_prev ``(n_layers, b, d)`` in the model's dtype."""
    d, dh = cfg.d_model, cfg.rwkv_head_dim
    return RwkvState(
        torch.zeros((n_layers, batch, d // dh, dh, dh), dtype=torch.float32,
                    device=device),
        torch.zeros((n_layers, batch, d), dtype=cfg.dtype, device=device))


def rwkv_channel_mix(params: RwkvChannelMix, x: torch.Tensor,
                     x_prev: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Squared-ReLU channel mix with token shift. x: ``(b, s, d)``;
    x_prev: ``(b, d)``. Returns (out, new x_prev)."""
    x_shift = torch.cat([x_prev[:, None, :], x[:, :-1]], dim=1)
    k = torch.square(torch.relu((_mix(params, "k", x, x_shift)
                                 @ params.wk).float()))
    r = torch.sigmoid((_mix(params, "r", x, x_shift) @ params.wr).float())
    out = r * (k.to(x.dtype) @ params.wv).float()
    return out.to(x.dtype), x[:, -1, :]


def rwkv_channel_mix_tp(params: RwkvChannelMix, x: torch.Tensor, group,
                        x_prev: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """``rwkv_channel_mix`` from a zero last token on a data rank's model
    positions: ``x`` ``(b, s, d)`` replicated (the batch-only residual's
    normed input); returns the output so. The mixes run once. Where
    ``tp_module_on`` splits the block (the ranks divide both ``d_ff`` and
    ``d``): ``wk`` column-parallel over ``d_ff``, ``wv`` row-parallel
    (partial sums of ``k @ wv`` over the whole ``d``), ``wr``
    column-parallel over ``d``. The product ``r * (k @ wv)`` is formed on
    channels: the partial sums are reduce-scattered onto each rank's
    ``d / R`` channels, multiplied by its ``r``, and all-gathered back to
    the replicated residual. Otherwise every rank runs the whole block.
    ``x_prev`` ``(b, d)`` (a decode step's last token) takes the zero
    last token's place."""
    first = x.new_zeros((x.shape[0], 1, x.shape[2])) if x_prev is None \
        else x_prev[:, None, :]
    x_shift = torch.cat([first, x[:, :-1]], dim=1)
    xk, xr = _mix(params, "k", x, x_shift), _mix(params, "r", x, x_shift)
    if params.wk.dim() == 2:                       # whole
        k = torch.square(torch.relu((xk @ params.wk).float()))
        kv = k.to(x.dtype) @ params.wv
        r = torch.sigmoid((xr @ params.wr).float())
        return (r * kv.float()).to(x.dtype)
    k = torch.square(torch.relu(ranked_matmul(copy_to_ranks(xk, group),
                                              params.wk).float()))
    kv = ranked_matmul(k.to(x.dtype), params.wv)   # partial sums
    r = torch.sigmoid(ranked_matmul(copy_to_ranks(xr, group),
                                    params.wr).float())
    kv = scatter_sum(kv, group, 2)
    return gather_from_ranks((r * kv.float()).to(x.dtype), group, 2)
