"""Plain PyTorch versions of attention.

``attention_ref`` is the port of the reference's oracle
(``repro.kernels.flash_attention.ref.attention_ref``): the logits are
formed in the inputs' type (so at bf16 they are rounded to bf16, as the
reference's einsum rounds them) and then upcast; softmax and the value
product are float32. The model's CPU path uses it, because that is what
the reference runs on the CPU.

``flash_attention_ref`` is the plain version of the CUDA kernels: the
same function on float32-upcast q, k and v, causal or (``causal=False``)
bidirectional, with grouped-query heads read by index (query head h uses
kv head h // (hq // hkv)) and the result cast back to q's type. Unlike
``attention_ref`` at bf16, its logits are never rounded to bf16; the
card's checks compare the kernels with it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention_ref", "flash_attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: ``(..., sq, d)``; k, v: ``(..., skv, d)`` broadcastable to q's
    leading axes (kv heads already broadcast, or a size-1 group axis).

    End-aligned causal mask: query row i sees key columns
    j <= i + skv - sq; ``window`` further keeps j > i - window (local
    attention); rows with no visible column give NaN, as in the reference.
    """
    sq, d = q.shape[-2:]
    skv = k.shape[-2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    ki = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, v.float()).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: Optional[float] = None,
                        causal: bool = True) -> torch.Tensor:
    """The kernels' function: q ``(b, hq, sq, d)``, k/v ``(b, hkv, skv,
    d)``, causal and end-aligned (every column visible with
    ``causal=False``), all in float32, output in q's type
    (contiguous)."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    # contiguous float32 copies: strided views of the same values give the
    # same products, bit for bit
    qg = q.float().contiguous().reshape(b, hkv, hq // hkv, sq, d)
    out = attention_ref(qg, k.float().contiguous()[:, :, None],
                        v.float().contiguous()[:, :, None], causal=causal,
                        scale=scale)
    return out.reshape(b, hq, sq, d).to(q.dtype)
