"""Model registry: family-dispatching build/apply functions.

Counterpart of ``repro.models.registry``. ``params`` is the ``LM``
module of a decoder-only family (dense, MoE, hybrid or SSM) or the
``EncDec`` module of the enc-dec family; a batch holds ``tokens`` (and
``labels`` for a loss), plus ``src_embeds`` for the enc-dec family.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from . import encdec, transformer
from .common import ModelConfig

__all__ = ["init_params", "forward_fn", "loss_fn", "make_decode_state",
           "decode_fn"]


def init_params(cfg: ModelConfig, *,
                generator: Optional[torch.Generator] = None,
                device=None) -> Union[transformer.LM, encdec.EncDec]:
    """Random weights on ``device`` (the card when None), drawn there."""
    if cfg.family == "encdec":
        return encdec.init_encdec(cfg, generator=generator, device=device)
    return transformer.init_lm(cfg, generator=generator, device=device)


def loss_fn(cfg: ModelConfig, *, backend: str = "auto"):
    """(params, batch) -> scalar loss, differentiable under grad mode.
    Inference callers run it under ``torch.no_grad()`` with the default
    route (flash on the card); the train step asks for
    ``backend="plain"``."""
    if cfg.family == "encdec":
        return lambda p, b: encdec.encdec_loss(p, b, cfg, backend=backend)
    transformer.check_family(cfg)
    return lambda p, b: transformer.lm_loss(p, b, cfg, backend=backend)


def forward_fn(cfg: ModelConfig, *, backend: str = "auto"):
    """(params, batch) -> logits, with no autograd graph."""
    if cfg.family == "encdec":
        def fwd(p, b):
            with torch.no_grad():
                return encdec.forward_encdec(p, b["src_embeds"], b["tokens"],
                                             cfg, backend=backend)
        return fwd
    transformer.check_family(cfg)
    return lambda p, b: transformer.forward(p, b["tokens"], cfg,
                                            backend=backend)


def make_decode_state(cfg: ModelConfig, batch: int, s_max: int, *,
                      s_src: int = 0, device=None):
    """The family's decode caches: ``transformer.DecodeCaches``, or for
    the enc-dec family ``encdec.EncDecCaches`` with ``s_src`` source
    positions (128 when 0, as the reference's default)."""
    if cfg.family == "encdec":
        return encdec.make_encdec_caches(cfg, batch, s_max, s_src or 128,
                                         device=device)
    return transformer.make_decode_caches(cfg, batch, s_max, device=device)


def decode_fn(cfg: ModelConfig):
    """(params, tokens, caches, pos) -> (logits, caches)."""
    if cfg.family == "encdec":
        return lambda p, t, c, pos: encdec.decode_step_encdec(p, t, c, pos,
                                                              cfg)
    transformer.check_family(cfg)
    return lambda p, t, c, pos: transformer.decode_step(p, t, c, pos, cfg)
