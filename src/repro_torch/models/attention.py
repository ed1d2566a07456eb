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
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..kernels import backend as _backend
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import attention_ref
from .common import ModelConfig, new_param, rope

__all__ = ["Attention", "attention", "mha_attend", "make_kv_cache",
           "repeat_kv", "CHUNKED_KV_THRESHOLD", "KV_CHUNK"]

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
                    causal: bool = True) -> torch.Tensor:
    """Streaming-softmax attention in plain products (the flash algorithm
    as a loop over kv chunks): the ``(sq, skv)`` logits never exist whole.
    Products take the operands upcast to float32 (the reference's bf16
    operands with float32 accumulation); the probabilities are rounded to
    v's type before the value product, as the reference rounds them. The
    reference pads the last chunk and masks it; a shorter last chunk gives
    the same result. Without ``causal`` (the enc-dec model's, which has
    no window) the reference masks only its padding columns, so no column
    is masked here."""
    sq, dh = q.shape[2], q.shape[3]
    skv = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    qf = q.float()
    rows = (torch.arange(sq, device=q.device) + (skv - sq))[:, None]
    m = torch.full((*q.shape[:3], 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, KV_CHUNK):
        k_c = k[:, :, c0:c0 + KV_CHUNK]
        v_c = v[:, :, c0:c0 + KV_CHUNK]
        s = torch.matmul(qf, k_c.float().transpose(-1, -2)) * scale
        if causal:
            cols = c0 + torch.arange(k_c.shape[2],
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
