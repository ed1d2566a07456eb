"""Shared model-definition utilities.

Counterpart of ``repro.models.common``. Parameters are ``nn.Module``s
(see ``transformer.LM``) whose weights keep the reference's
``(in, out)`` layout, so a layer computes ``x @ w`` as the reference
does. Weights are drawn with the reference's distributions from a
``torch.Generator`` (``transformer.init_scale``): ``normal x 0.02`` in
the model's dtype, norm gains and the RG-LRU's ``lam`` ``normal x 1.0``
in float32, the RG-LRU's conv taps ``x 0.2``, RWKV's token-shift mixes,
decay bias and bonus ``x 0.5``. Activations and weights are bf16 for full
configs and float32 for smoke ones. Parameters are made not requiring
gradients; the train step (``train.step``) turns that on for its own
duration.

``embed_tp`` and ``lm_head_loss_tp`` are the tensor-parallel step's
(``distributed.tp``): a vocab-parallel embedding (each rank looks up the
tokens of its vocabulary rows, zeros elsewhere, and the ranks' rows are
added into the residual's layout), and the logits in the layout
``constraint_spec`` names for ``logits_v``: the vocabulary over the
ranks, with a vocab-parallel cross entropy (the maximum, the sum of
exponentials and the gold logit each reduced over the ranks, so no rank
holds the whole ``(b, s, V)`` logits), else each rank's sequence rows
against the whole head, else replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..distributed import tp

__all__ = ["ModelConfig", "rms_norm", "rope", "cross_entropy_loss",
           "new_param", "normal_", "embed_tp", "lm_head_loss_tp",
           "vocab_parallel_cross_entropy"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_capacity_factor: float = 1.25
    # hybrid (RG-LRU) / local attention
    window: Optional[int] = None
    rnn_width: Optional[int] = None
    hybrid_period: int = 3
    # ssm (RWKV6)
    rwkv_head_dim: int = 64
    # enc-dec
    encoder_layers: int = 0
    # misc
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    embed_frontend: bool = False

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (bounded attention state)."""
        return self.family in ("ssm", "hybrid")

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers), as the
        reference counts it."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "moe":
            ffn = self.moe_experts * 3 * d * f + d * self.moe_experts
        else:
            ffn = 3 * d * f
        qkvo = d * (self.n_heads * self.head_dim) * 2 + \
            d * (self.n_kv_heads * self.head_dim) * 2
        per_layer = ffn + qkvo + 2 * d
        total = emb + self.n_layers * per_layer
        if self.encoder_layers:
            total += self.encoder_layers * per_layer
        return int(total)

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_ffn = self.moe_topk * 3 * d * f
        moe_ffn = self.moe_experts * 3 * d * f
        return int(self.param_count() - self.n_layers * (moe_ffn - dense_ffn))


def new_param(shape, dtype: torch.dtype, device) -> torch.nn.Parameter:
    """An uninitialised parameter that takes no gradient until the train
    step asks for one."""
    return torch.nn.Parameter(torch.empty(tuple(shape), dtype=dtype,
                                          device=device),
                              requires_grad=False)


@torch.no_grad()
def normal_(p: torch.Tensor, generator: torch.Generator,
            scale: float = 0.02) -> torch.Tensor:
    """Fill ``p`` with ``normal x scale``, drawn in float32 on ``p``'s
    device and rounded to its dtype (the reference's ``leaf``)."""
    draw = torch.randn(p.shape, generator=generator, device=p.device,
                       dtype=torch.float32)
    return p.copy_(draw.mul_(scale))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float
             ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale).to(dt) * gamma.to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding. x: ``(..., s, h, d)``; positions: ``(s,)`` or
    ``(b, s)``."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(theta, exps)      # a Python base: no host copy
    angles = positions.to(torch.float32)[..., None] * freqs  # (..., s, half)
    cos = torch.cos(angles)[..., None, :]    # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """Mean token cross-entropy in float32. logits: ``(b, s, v)``; labels:
    ``(b, s)``. On one device the gold logit is a gather (the reference's
    iota-compare form exists for vocab sharding and adds only zeros)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def embed_tp(embed: torch.Tensor, tokens: torch.Tensor, group, shape
             ) -> torch.Tensor:
    """The embedding of ``tokens`` ``(b, s)`` in the residual's layout
    (whole shape ``shape``): ``embed`` ``(R, V / R, d)``, each rank's
    vocabulary rows (vocab parallel), or whole ``(V, d)``."""
    if embed.dim() == 2:
        return group.from_replicated(
            torch.nn.functional.embedding(tokens, embed), shape)
    ranks, rows, d = embed.shape
    first = (torch.arange(ranks, device=tokens.device) * rows)[:, None, None]
    local = tokens[None].long() - first
    mine = (local >= 0) & (local < rows)
    out = torch.nn.functional.embedding(torch.where(mine, local, 0) + first,
                                        embed.reshape(ranks * rows, d))
    return group.from_partials(torch.where(mine[..., None], out, 0.0),
                               shape)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 group) -> torch.Tensor:
    """Mean token cross-entropy in float32 of vocab-parallel ``logits``
    ``(R, t, V / R)`` (rank r's vocabulary rows ``[r V / R, (r + 1) V /
    R)``); labels ``(t,)``."""
    ranks, _, rows = logits.shape
    lf = logits.float()
    m = tp.max_from_ranks(lf.amax(dim=-1), group)                  # (t,)
    sumexp = tp.reduce_from_ranks(
        torch.exp(lf - m[None, :, None]).sum(dim=-1), group)
    first = (torch.arange(ranks, device=labels.device) * rows)[:, None]
    local = labels[None].long() - first
    mine = (local >= 0) & (local < rows)
    gold = torch.gather(lf, -1, torch.where(mine, local, 0)[..., None])
    gold = tp.reduce_from_ranks(torch.where(mine, gold[..., 0], 0.0), group)
    return torch.mean(m + torch.log(sumexp) - gold)


def lm_head_loss_tp(x: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor, group, shape) -> torch.Tensor:
    """Mean next-token cross-entropy of the final normed residual ``x``
    (whole shape ``shape``) against ``labels`` ``(b, s)``: ``head`` ``(R,
    d, V / R)`` (vocab parallel) or whole ``(d, V)``."""
    b, s, d = shape
    vocab = head.shape[-1] * (group.size if head.dim() == 3 else 1)
    lshape = (b, s, vocab)
    if head.dim() == 3:
        full, _ = group.whole(x, shape)
        logits = group.placed("logits_v", lshape,
                              tp.ranked_matmul(full, head))
        return vocab_parallel_cross_entropy(
            logits.reshape(group.size, b * s, -1), labels.reshape(-1), group)
    if group.model_dim("logits_v", lshape) == 1:     # whole head
        logits = group.placed("logits_v", lshape,
                              group.rows(x, shape) @ head).float()
        rows = tp.split_ranks(labels, 1, group.size)
        gold = torch.gather(logits, -1, rows.long()[..., None])[..., 0]
        per = torch.logsumexp(logits, dim=-1) - gold
        total = tp.reduce_from_ranks(per.sum(dim=(1, 2)), group)
        return total / (b * s)
    _, once = group.whole(x, shape)
    logits = group.placed("logits_v", lshape, once @ head)
    return cross_entropy_loss(logits, labels)
