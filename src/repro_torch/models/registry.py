"""Model registry: build/apply functions of the decoder-only families.

Counterpart of ``repro.models.registry``. ``params`` is the ``LM``
module (dense, MoE, hybrid or SSM); the enc-dec family raises
``NotImplementedError`` (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import transformer
from .common import ModelConfig

__all__ = ["init_params", "forward_fn", "loss_fn", "make_decode_state",
           "decode_fn"]


def init_params(cfg: ModelConfig, *,
                generator: Optional[torch.Generator] = None,
                device=None) -> transformer.LM:
    """Random weights on ``device`` (the card when None), drawn there."""
    return transformer.init_lm(cfg, generator=generator, device=device)


def loss_fn(cfg: ModelConfig, *, backend: str = "auto"):
    """(params, batch) -> scalar loss, differentiable under grad mode.
    Inference callers run it under ``torch.no_grad()`` with the default
    route (flash on the card); the train step asks for
    ``backend="plain"``."""
    transformer.check_family(cfg)
    return lambda p, b: transformer.lm_loss(p, b, cfg, backend=backend)


def forward_fn(cfg: ModelConfig, *, backend: str = "auto"):
    """(params, batch) -> logits."""
    transformer.check_family(cfg)
    return lambda p, b: transformer.forward(p, b["tokens"], cfg,
                                            backend=backend)


def make_decode_state(cfg: ModelConfig, batch: int, s_max: int, *,
                      device=None) -> transformer.DecodeCaches:
    """The family's decode caches (``transformer.DecodeCaches``)."""
    return transformer.make_decode_caches(cfg, batch, s_max, device=device)


def decode_fn(cfg: ModelConfig):
    """(params, tokens, caches, pos) -> (logits, caches)."""
    transformer.check_family(cfg)
    return lambda p, t, c, pos: transformer.decode_step(p, t, c, pos, cfg)
