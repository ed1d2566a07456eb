"""GQA attention with RoPE and a KV cache.

Counterpart of ``repro.models.attention``. Prefill attention (no window,
more than one query row) launches the hand-written flash-attention kernel
on a CUDA tensor — the route the reference built for its accelerator. The
kernel reads q, k and v in the projections' ``(b, s, h, dh)`` layout
through ``(b, h, s, dh)`` views and returns the ``(b, h, s, dh)`` view of
a ``(b, s, h, dh)`` output, so no layout copy is made around it.
Everywhere else, and for ``backend="plain"``, it takes the reference's
CPU path: kv heads repeated, then ``attention_ref``, or the streaming
softmax of ``_attend_chunked`` once the keys pass
``CHUNKED_KV_THRESHOLD``. Decode is a single-query attention against the
whole cache, masked by position, in plain products with the grouped
layout, so the cache is never repeated per query head. Training asks
for ``backend="plain"``: the kernel has no backward, and its wrapper
raises on inputs that require a gradient.

``mha_attend`` is the enc-dec model's entry (bidirectional encoder and
cross-attention, causal decoder self-attention): on a CUDA tensor both
branches launch the kernel; elsewhere, and for ``backend="plain"``, the
reference's route with its ``causal`` flag.

``attention_tp`` is the tensor-parallel training step's attention
(``distributed.tp``; the reference's route): q, k and v take the
layouts ``constraint_spec`` names for ``bshd`` / ``bshd_kv``. Heads
over the model ranks: column-parallel q/k/v (each rank its heads' slice
of ``wq``/``wk``/``wv``), row-parallel ``wo`` and a reduce-scatter (or
all-reduce) of the ranks' partial sums. Where the heads do not divide,
the query rows: each rank its rows of q, from the whole weights, against
the whole k and v. K and v are computed once where they are replicated.
With ``window=`` it is the hybrid's local attention.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..distributed.tp import ranked_matmul
from ..kernels import backend as _backend
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import attention_ref
from .common import ModelConfig, new_param, rope

__all__ = ["Attention", "attention", "attention_tp", "mha_attend",
           "make_kv_cache", "repeat_kv", "CHUNKED_KV_THRESHOLD", "KV_CHUNK"]

CHUNKED_KV_THRESHOLD = 2048
KV_CHUNK = 1024
_NEG_INF = -1e30


class Attention(nn.Module):
    """``wq`` ``(d, hq dh)``, ``wk``/``wv`` ``(d, hkv dh)``, ``wo``
    ``(hq dh, d)``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
            cfg.head_dim
        self.wq = new_param((d, hq * dh), cfg.dtype, device)
        self.wk = new_param((d, hkv * dh), cfg.dtype, device)
        self.wv = new_param((d, hkv * dh), cfg.dtype, device)
        self.wo = new_param((hq * dh, d), cfg.dtype, device)


def repeat_kv(t: torch.Tensor, group: int) -> torch.Tensor:
    """Each kv head of ``(b, hkv, s, dh)`` repeated ``group`` times in
    place, ``(b, hkv group, s, dh)`` (``repeat_interleave`` on axis 1,
    without its host sync for the output size)."""
    if group == 1:
        return t
    b, h, s, dh = t.shape
    return t[:, :, None].expand(b, h, group, s, dh).reshape(b, h * group,
                                                             s, dh)


def _attend(q, k, v, *, window: Optional[int], backend: str = "auto"
            ) -> torch.Tensor:
    """q: ``(b, hq, sq, dh)``; k, v: ``(b, hkv, skv, dh)``."""
    if window is None and q.shape[2] > 1 \
            and _backend.resolve_route(q, backend) == "kernel":
        return flash_attention(q, k, v, causal=True)
    group = q.shape[1] // k.shape[1]
    k, v = repeat_kv(k, group), repeat_kv(v, group)
    if k.shape[2] > CHUNKED_KV_THRESHOLD:
        return _attend_chunked(q, k, v, window=window)
    return attention_ref(q, k, v, causal=True, window=window)


def mha_attend(q, k, v, *, causal: bool, backend: str = "auto"
               ) -> torch.Tensor:
    """Attention of the enc-dec stacks: q ``(b, hq, sq, dh)``, k and v
    ``(b, hkv, skv, dh)``, causal (end-aligned) or bidirectional. On a
    CUDA tensor (``backend="auto"``) both branches launch the flash
    kernel; on the CPU or with ``backend="plain"``, the reference's
    ``mha_attend``: kv heads repeated, then ``attention_ref``, or the
    streaming softmax once the keys pass ``CHUNKED_KV_THRESHOLD``."""
    if _backend.resolve_route(q, backend) == "kernel":
        return flash_attention(q, k, v, causal=causal)
    group = q.shape[1] // k.shape[1]
    k, v = repeat_kv(k, group), repeat_kv(v, group)
    if k.shape[2] > CHUNKED_KV_THRESHOLD:
        return _attend_chunked(q, k, v, window=None, causal=causal)
    return attention_ref(q, k, v, causal=causal, window=None)


def _attend_chunked(q, k, v, *, window: Optional[int],
                    causal: bool = True,
                    q_start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Streaming-softmax attention in plain products (the flash algorithm
    as a loop over kv chunks): the ``(sq, skv)`` logits never exist whole.
    Products take the operands upcast to float32 (the reference's bf16
    operands with float32 accumulation); the probabilities are rounded to
    v's type before the value product, as the reference rounds them. The
    reference pads the last chunk and masks it; a shorter last chunk gives
    the same result. Without ``causal`` (the enc-dec model's, which has
    no window) the reference masks only its padding columns, so no column
    is masked here. With ``q_start`` ``(R,)`` (q ``(R, ..., sq, dh)``:
    each model rank's query rows) rank r's rows start at ``q_start[r]``,
    not end-aligned."""
    sq, dh = q.shape[-2], q.shape[-1]
    skv = k.shape[-2]
    scale = 1.0 / math.sqrt(dh)
    qf = q.float()
    rows = (torch.arange(sq, device=q.device) + (skv - sq))[:, None]
    if q_start is not None:
        rows = _query_rows(q, q_start)
    m = torch.full((*q.shape[:-1], 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, KV_CHUNK):
        k_c = k[..., c0:c0 + KV_CHUNK, :]
        v_c = v[..., c0:c0 + KV_CHUNK, :]
        s = torch.matmul(qf, k_c.float().transpose(-1, -2)) * scale
        if causal:
            cols = c0 + torch.arange(k_c.shape[-2],
                                     device=q.device)[None, :]
            mask = cols <= rows
            if window is not None:
                mask &= cols > rows - window
            s = s.masked_fill(~mask, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v_c.dtype).float(),
                                         v_c.float())
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


def _query_rows(q: torch.Tensor, q_start: torch.Tensor) -> torch.Tensor:
    """The global row of each query of ``q`` ``(R, ..., sq, dh)``, rank
    r's starting at ``q_start[r]``, shaped to broadcast against ``(R,
    ..., sq, skv)`` logits."""
    sq = q.shape[-2]
    rows = q_start[:, None] + torch.arange(sq, device=q.device)[None, :]
    return rows.view(q.shape[0], *(1,) * (q.dim() - 3), sq, 1)


def _attend_rows(q, k, v, q_start: Optional[torch.Tensor], *,
                 causal: bool, window: Optional[int] = None
                 ) -> torch.Tensor:
    """``attention_ref``'s arithmetic (logits in the inputs' type, then
    float32; softmax and the value product in float32) with each model
    rank's query rows starting at ``q_start[r]`` (None: end-aligned, as
    ``attention_ref``), or the streaming softmax past
    ``CHUNKED_KV_THRESHOLD`` keys; with ``window`` (causal only) a row
    sees the ``window`` keys up to its own position. q ``(R, b, h, sq,
    dh)``; k, v broadcastable to it."""
    if k.shape[-2] > CHUNKED_KV_THRESHOLD:
        return _attend_chunked(q, k, v, window=window, causal=causal,
                               q_start=q_start)
    if q_start is None:
        return attention_ref(q, k, v, causal=causal, window=window)
    logits = torch.matmul(q, k.transpose(-1, -2)).float() \
        * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        ki = torch.arange(k.shape[-2], device=q.device)
        rows = _query_rows(q, q_start)
        hidden = ki > rows
        if window is not None:
            hidden |= ki <= rows - window
        logits = logits.masked_fill(hidden, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def _heads_of_ranks(t: torch.Tensor, ranks: int) -> torch.Tensor:
    """Replicated ``(b, h, s, dh)`` as each rank's heads, ``(R, b, h / R,
    s, dh)`` (a view)."""
    return t.unflatten(1, (ranks, -1)).movedim(1, 0)


def _repeat_ranked(t: torch.Tensor, group: int) -> torch.Tensor:
    """``repeat_kv`` on each rank's ``(R, b, h, s, dh)``."""
    r, b = t.shape[:2]
    return repeat_kv(t.reshape(r * b, *t.shape[2:]), group).view(
        r, b, -1, *t.shape[3:])


def attention_tp(params: Attention, xq: torch.Tensor, cfg: ModelConfig,
                 group, *, q_pos: torch.Tensor, causal: bool,
                 xkv: Optional[torch.Tensor] = None,
                 kv_pos: Optional[torch.Tensor] = None,
                 window: Optional[int] = None) -> torch.Tensor:
    """Attention of ``xq`` over ``xkv`` (itself when None) on a data
    rank's model positions (``group``, a ``distributed.tp.Group``), both
    in the residual's layout (``group.seq_split``); RoPE at ``q_pos`` and
    ``kv_pos``. ``params`` holds each leaf as ``tp_module_on`` stacks it:
    ``(R, d, n / R)`` (``wq``, ``wk``, ``wv``) and ``(R, n / R, d)``
    (``wo``) where their heads are split, else whole. ``window`` (the
    hybrid's local attention, causal) masks as ``_attend_chunked`` does:
    a query sees the keys within ``window`` positions up to its own,
    measured from the query's global position (a rank's query rows may
    start mid-sequence). Returns the output in ``xq``'s residual
    layout."""
    ranks = group.size
    hq, hkv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    sq = q_pos.shape[0]
    kv_pos = q_pos if kv_pos is None else kv_pos
    skv = kv_pos.shape[0]
    b = xq.shape[-3]
    q_shape, kv_shape = (b, sq, d), (b, skv, d)
    # heads over the ranks where the weights come split
    # (``registry.tp_weight_splits``); with whole weights, the query rows
    # where ``bshd`` asks for them
    kv_split = params.wk.dim() == 3
    q_dim = 2 if params.wq.dim() == 3 else (
        1 if group.model_dim("bshd", (b, sq, hq, dh)) == 1 else None)
    group.check("bshd", (b, sq, hq, dh), q_dim)
    group.check("bshd_kv", (b, skv, hkv, dh), 2 if kv_split else None)
    kv_full, kv_once = group.whole(xq if xkv is None else xkv, kv_shape)
    q_full = kv_full if xkv is None else None

    def project(w, h):
        if kv_split:
            return ranked_matmul(kv_full, w).view(ranks, b, skv, h // ranks,
                                                  dh)
        return (kv_once @ w).view(b, skv, h, dh)
    k = group.placed("bshd_kv", (b, skv, hkv, dh), project(params.wk, hkv))
    v = group.placed("bshd_kv", (b, skv, hkv, dh), project(params.wv, hkv))
    k = rope(k, kv_pos, cfg.rope_theta)

    q_start = None
    if q_dim == 2:                                       # heads
        if q_full is None:
            q_full, _ = group.whole(xq, q_shape)
        q = ranked_matmul(q_full, params.wq).view(ranks, b, sq, hq // ranks,
                                                  dh)
        pos = q_pos
    elif q_dim == 1:                                     # query rows
        rows = group.rows(xq, q_shape)
        q = (rows @ params.wq).view(ranks, b, sq // ranks, hq, dh)
        pos = q_pos.view(ranks, 1, sq // ranks)
        q_start = q_pos[::sq // ranks] + (skv - sq)
    else:
        _, q_once = group.whole(xq, q_shape) if q_full is None \
            else (None, kv_once)
        q = (q_once @ params.wq).view(b, sq, hq, dh)
        pos = q_pos
    q = rope(group.placed("bshd", (b, sq, hq, dh), q), pos, cfg.rope_theta)

    q, k, v = (t.transpose(-3, -2) for t in (q, k, v))   # (.., h, s, dh)
    grp = hq // hkv
    if kv_split:
        k, v = _repeat_ranked(k, grp), _repeat_ranked(v, grp)
    else:
        k, v = repeat_kv(k, grp), repeat_kv(v, grp)
        if q_dim == 2:
            k, v = _heads_of_ranks(k, ranks), _heads_of_ranks(v, ranks)
    out = _attend_rows(q, k, v, q_start, causal=causal, window=window)
    out = out.to(xq.dtype).transpose(-3, -2)
    out = out.reshape(*out.shape[:-2], -1)
    if q_dim == 2:
        return group.from_partials(ranked_matmul(out, params.wo), q_shape)
    if q_dim == 1:
        return group.from_rows(out @ params.wo, q_shape)
    return group.from_replicated(out @ params.wo, q_shape)


def attention(params: Attention, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor,
              cache: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
              window: Optional[int] = None, backend: str = "auto"):
    """x: ``(b, s, d)``; positions: ``(s,)`` global positions on x's
    device. With ``cache`` (k, v) of shape ``(b, hkv, s_max, dh)``, writes
    this step's k and v into the cache IN PLACE at ``positions`` and
    returns ``(out, cache)``; otherwise self-attention over x only.
    Decode reads the positions from the device only, so a decode step
    can be captured once in a CUDA graph and replayed at every
    position."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = rope((x @ params.wq).reshape(b, s, hq, dh), positions,
             cfg.rope_theta)
    k = rope((x @ params.wk).reshape(b, s, hkv, dh), positions,
             cfg.rope_theta)
    v = (x @ params.wv).reshape(b, s, hkv, dh)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # (b, h, s, dh) views

    if cache is not None:
        ck, cv = cache
        ck.index_copy_(2, positions, k.to(ck.dtype))
        cv.index_copy_(2, positions, v.to(cv.dtype))
        out = _decode_attend(q, ck, cv, positions, window=window)
        out = out.transpose(1, 2).reshape(b, s, hq * dh)
        return out @ params.wo, (ck, cv)

    out = _attend(q, k, v, window=window, backend=backend)
    # a view on the kernel route, whose output is (b, s, hq, dh) underneath
    out = out.transpose(1, 2).reshape(b, s, hq * dh)
    return out @ params.wo


def _decode_attend(q, k, v, positions, *, window: Optional[int]
                   ) -> torch.Tensor:
    """Decode attention against the whole cache, masked to the slots at
    or before each query's position (and inside ``window``), as the
    reference masks it.

    q: ``(b, hq, s, dh)``; k, v: ``(b, hkv, s_max, dh)``; positions:
    ``(s,)``. The query heads are grouped ``(b, hkv, group, s, dh)``
    against the cache ``(b, hkv, 1, s_max, dh)``, so the cache is never
    repeated per query head. Products are float32 (the reference
    accumulates in float32 from the cache's type).
    """
    b, hq, s, dh = q.shape
    hkv, s_max = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, s, dh).float()
    logits = torch.matmul(qg, k[:, :, None].float().transpose(-1, -2)) \
        * (1.0 / math.sqrt(dh))
    ki = torch.arange(s_max, device=q.device)[None, :]
    qi = positions[:, None]
    mask = ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v[:, :, None].float())
    return out.reshape(b, hq, s, dh).to(q.dtype)


def make_kv_cache(cfg: ModelConfig, batch: int, s_max: int, n_layers: int,
                  *, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed ``(n_layers, batch, hkv, s_max, dh)`` k and v caches in the
    model's dtype on ``device`` (the card when None). Decode writes into
    them in place."""
    device = resolve_device(device, what="make_kv_cache")
    shape = (n_layers, batch, cfg.n_kv_heads, s_max, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))
