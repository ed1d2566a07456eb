"""Prefill and serve step builders (subset of ``repro.train.step``).

The port runs eagerly on one device, so there is nothing to lower or
shard: ``make_prefill_fn`` and ``make_serve_fn`` return the step
functions themselves. Training steps wait for a later slice (ROADMAP.md).
"""

from __future__ import annotations

import torch

from ..models.common import ModelConfig
from ..models.registry import decode_fn, forward_fn

__all__ = ["make_prefill_fn", "make_serve_fn"]


def make_prefill_fn(cfg: ModelConfig, *, backend: str = "auto"):
    """(params, batch) -> last-position logits ``(b, vocab)`` of the full
    forward. ``backend`` picks the attention route (``models.attention``)."""
    fwd = forward_fn(cfg, backend=backend)

    def prefill(params, batch):
        return fwd(params, batch)[:, -1, :]

    return prefill


def make_serve_fn(cfg: ModelConfig):
    """(params, tokens, caches, pos) -> (greedy next tokens ``(b, 1)``
    int32, caches); the caches are updated in place."""
    dfn = decode_fn(cfg)

    def serve_step(params, tokens, caches, pos):
        logits, caches = dfn(params, tokens, caches, pos)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], caches

    return serve_step
