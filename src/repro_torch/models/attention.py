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

``decode_attention_tp`` and ``cross_attention_tp`` are the sharded
decode step's (one new token per row, the residual replicated over the
model ranks): the cache comes as each model rank's part, split as
``sharding.cache_specs`` splits it. By heads: q, k and v
column-parallel (each rank its heads' columns), the new k and v written
into the rank's heads, attention on them, ``wo`` row-parallel and the
partial sums all-reduced. By head width (the KV heads do not divide):
q, k and v computed once from the whole weights, each rank writes and
reads its slice of every head's width, the ranks' partial q.k logits
all-reduced (float32, rank order), the softmax replicated, each rank's
slice of the value product all-gathered, and ``wo`` whole. By sequence
(neither divides): q, k and v computed once from the whole weights, the
new k and v written into the rank that owns the slot, each rank's
logits over its slots, and the softmax combined as the reference's one
program rounds it (``_seq_attend``), ``wo`` whole.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..distributed.tp import (copy_to_ranks, gather_from_ranks,
                              max_from_ranks, ranked_matmul,
                              reduce_from_ranks, split_to_ranks)
from ..kernels import backend as _backend
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import attention_ref
from .common import ModelConfig, new_param, rope

__all__ = ["Attention", "attention", "attention_tp", "mha_attend",
           "make_kv_cache", "repeat_kv", "decode_attention_tp",
           "cross_attention_tp", "cache_split", "layer_of",
           "CHUNKED_KV_THRESHOLD", "KV_CHUNK", "BF16_ATTENTION_OPERANDS"]

CHUNKED_KV_THRESHOLD = 2048
KV_CHUNK = 1024
# the reference's switch of the streaming softmax (``_attend_chunked``):
# True, the probabilities are rounded to v's type before the value
# product (its bf16 operands); False, float32 operands and float32
# probabilities. ``launch.perf``'s ``f32attn`` / ``bf16attn`` set it.
BF16_ATTENTION_OPERANDS = True
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
    operands with float32 accumulation, or with
    ``BF16_ATTENTION_OPERANDS`` False its float32 operands: the same
    products); the probabilities are rounded to v's type before the value
    product where ``BF16_ATTENTION_OPERANDS`` is True, as the reference
    rounds them, and stay float32 where it is False. The
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
        if BF16_ATTENTION_OPERANDS:
            p = p.to(v_c.dtype).float()
        acc = acc * alpha + torch.matmul(p, v_c.float())
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


def cache_split(model_dim) -> Optional[str]:
    """How a ``(b, h, s, dh)`` KV cache's model dimension (of its
    stacked ``(L, b, h, s, dh)`` leaf, ``ShardedCaches.model_dims``)
    splits it: ``"heads"`` (2), ``"seq"`` (3), ``"width"`` (4) or None
    (whole) — every dimension ``sharding.cache_specs`` can put on
    ``"model"``."""
    return {None: None, 2: "heads", 3: "seq", 4: "width"}[model_dim]


def layer_of(t: torch.Tensor, i: int, dim) -> torch.Tensor:
    """Layer ``i`` of a stacked cache leaf as a data rank holds it:
    ``(R, L, ...)`` by model rank where ``dim`` (its model dimension,
    ``spmd.ShardedCaches.model_dims``) is not None, else ``(L, ...)``."""
    return t[:, i] if dim is not None else t[i]


def _heads(w: torch.Tensor, x: torch.Tensor, heads: int, dh: int, split,
           group) -> torch.Tensor:
    """``x @ w`` as heads: ``(R, b, s, heads / R, dh)`` from the ranks'
    columns where ``split`` is ``"heads"``, else ``(b, s, heads, dh)``
    once."""
    b, s = x.shape[0], x.shape[1]
    if split == "heads":
        return ranked_matmul(copy_to_ranks(x, group), w).view(
            group.size, b, s, heads // group.size, dh)
    return (x @ w).view(b, s, heads, dh)


def _cache_write(cache: torch.Tensor, t: torch.Tensor, slot: torch.Tensor,
                 split, group) -> None:
    """The new ``t`` (``(R, b, h / R, 1, dh)`` by heads, else ``(b, h,
    1, dh)``) into the rank's ``cache`` at ``slot`` ``(1,)``, in place:
    by sequence into rank ``slot // (S / R)`` at ``slot % (S / R)``."""
    if split == "seq":
        per = cache.shape[-2]
        cache[slot // per, :, :, slot % per] = \
            t.to(cache.dtype).movedim(-2, 0)
        return
    if split == "width":
        t = split_to_ranks(t, group, 3)
    cache.index_copy_(-2, slot, t.to(cache.dtype))


def _cache_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                  valid: Optional[torch.Tensor], split, group
                  ) -> torch.Tensor:
    """Single-query attention of q (``(R, b, hq / R, 1, dh)`` by heads,
    else ``(b, hq, 1, dh)``) against a rank's cache (``(R, b, hkv / R,
    S, dh)``, ``(R, b, hkv, S, dh / R)``, ``(R, b, hkv, S / R, dh)`` or
    whole ``(b, hkv, S, dh)``), the slots ``valid`` (``S`` elements, the
    whole cache's; None: all) visible, in float32 as ``_decode_attend``;
    returns q's layout (whole by width and by sequence)."""
    if split == "seq":
        return _seq_attend(q, ck, cv, valid, group)
    dh = q.shape[-1]
    hkv = ck.shape[-3] * (group.size if split == "heads" else 1)
    lead = q.shape[:-3]
    hq_r = q.shape[-3]
    qg = q.reshape(*lead, ck.shape[-3], hq_r // ck.shape[-3], 1, dh)
    if split == "width":
        qg = split_to_ranks(qg, group, 4)
    logits = torch.matmul(qg.float(), ck.unsqueeze(-3).float()
                          .transpose(-1, -2))
    if split == "width":
        logits = reduce_from_ranks(logits, group)
    logits = logits * (1.0 / math.sqrt(dh))
    if valid is not None:
        logits = logits.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(cv.dtype).float()
    if split == "width":
        out = torch.matmul(copy_to_ranks(probs, group),
                           cv.unsqueeze(-3).float())
        out = gather_from_ranks(out, group, 4)
        return out.reshape(*lead, hkv * (hq_r // ck.shape[-3]), 1,
                           dh).to(q.dtype)
    out = torch.matmul(probs, cv.unsqueeze(-3).float())
    return out.reshape(q.shape).to(q.dtype)


def _seq_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                valid: Optional[torch.Tensor], group) -> torch.Tensor:
    """``_cache_attend`` against a cache split over its slots (``(R, b,
    hkv, S / R, dh)``), q whole ``(b, hq, 1, dh)``. The softmax is
    combined as the reference's one program rounds it, so the
    probabilities are normalised before they are rounded to the cache's
    type: the logits' largest over every rank (``max_from_ranks``),
    each rank's ``exp(logit - max)``, the denominators added over the
    ranks in rank order, the normalised probabilities cast to ``cv``'s
    type, and the ranks' partial value products added in rank order. A
    rank whose slots are all masked adds exactly 0 (the largest is
    another rank's, finite)."""
    b, hq, _, dh = q.shape
    ranks, _, hkv, per, _ = ck.shape
    qg = q.reshape(b, hkv, hq // hkv, 1, dh).float()
    logits = torch.matmul(qg, ck.unsqueeze(-3).float().transpose(-1, -2)) \
        * (1.0 / math.sqrt(dh))                 # (R, b, hkv, g, 1, S / R)
    if valid is not None:
        logits = logits.masked_fill(
            ~valid.reshape(ranks, 1, 1, 1, 1, per), float("-inf"))
    top = max_from_ranks(logits.amax(-1, keepdim=True), group)
    e = torch.exp(logits - top)
    den = reduce_from_ranks(e.sum(-1, keepdim=True), group)
    probs = (e / den).to(cv.dtype).float()
    out = reduce_from_ranks(torch.matmul(probs, cv.unsqueeze(-3).float()),
                            group)
    return out.reshape(b, hq, 1, dh).to(q.dtype)


def _out_proj(out: torch.Tensor, wo: torch.Tensor, split, group
              ) -> torch.Tensor:
    """The attention output (q's layout) through ``wo``: row-parallel
    partial sums all-reduced by heads, else once; ``(b, 1, d)``."""
    if split == "heads":
        r, b, h, s, dh = out.shape
        y = out.transpose(2, 3).reshape(r, b, s, h * dh)
        return reduce_from_ranks(ranked_matmul(y, wo), group)
    b, h, s, dh = out.shape
    return out.transpose(1, 2).reshape(b, s, h * dh) @ wo


def decode_attention_tp(params: Attention, x: torch.Tensor,
                        cfg: ModelConfig, group, positions: torch.Tensor,
                        ck: torch.Tensor, cv: torch.Tensor, split, *,
                        slot: torch.Tensor,
                        valid: Optional[torch.Tensor] = None,
                        rope_at: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """A decode step's self-attention of the replicated ``x`` ``(b, 1,
    d)`` on a data rank's model positions against their cache parts
    ``ck``/``cv`` (split ``split``, ``cache_split``): RoPE at ``rope_at``
    (``positions`` when None), the new k and v written at ``slot`` in
    place, the slots ``valid`` visible (the whole cache's ``S``; None:
    every slot up to ``positions``, the whole count taken here, as a
    sequence split holds ``S / R`` a rank). ``params`` comes split by
    heads (``(R, d, n / R)``, ``(R, n / R, d)``) where ``split`` is
    ``"heads"``, else whole. Returns ``(b, 1, d)``, replicated."""
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if valid is None:
        slots = ck.shape[-2] * (group.size if split == "seq" else 1)
        valid = torch.arange(slots, device=x.device)[None, :] \
            <= positions[:, None]
    at = positions if rope_at is None else rope_at
    q = rope(_heads(params.wq, x, hq, dh, split, group), at, cfg.rope_theta)
    k = rope(_heads(params.wk, x, hkv, dh, split, group), at,
             cfg.rope_theta)
    v = _heads(params.wv, x, hkv, dh, split, group)
    q, k, v = (t.transpose(-3, -2) for t in (q, k, v))   # (.., h, 1, dh)
    _cache_write(ck, k, slot, split, group)
    _cache_write(cv, v, slot, split, group)
    out = _cache_attend(q, ck, cv, valid, split, group)
    return _out_proj(out, params.wo, split, group)


def cross_attention_tp(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                       group, ck: torch.Tensor, cv: torch.Tensor, split, *,
                       rope_at: torch.Tensor) -> torch.Tensor:
    """The enc-dec decode step's cross-attention of the replicated ``x``
    against the rank's parts of the precomputed cross K/V (every source
    slot visible); q rotated at ``rope_at``."""
    hq, dh = cfg.n_heads, cfg.head_dim
    q = rope(_heads(params.wq, x, hq, dh, split, group), rope_at,
             cfg.rope_theta).transpose(-3, -2)
    out = _cache_attend(q, ck, cv, None, split, group)
    return _out_proj(out, params.wo, split, group)


def make_kv_cache(cfg: ModelConfig, batch: int, s_max: int, n_layers: int,
                  *, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed ``(n_layers, batch, hkv, s_max, dh)`` k and v caches in the
    model's dtype on ``device`` (the card when None). Decode writes into
    them in place."""
    device = resolve_device(device, what="make_kv_cache")
    shape = (n_layers, batch, cfg.n_kv_heads, s_max, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))
