"""Decoder-only LM assembly, dense family.

Counterpart of ``repro.models.transformer`` for ``family="dense"``
(``llama3.2-3b``): the layers run as a Python loop over an
``nn.ModuleList`` where the reference scans stacked parameters. Under
grad mode each layer is rematerialised in the backward
(``torch.utils.checkpoint``, as the reference wraps its layer in
``jax.checkpoint``), so only the layers' inputs are kept. ``forward`` is
the inference entry (no graph; on the card prefill attention takes the
flash kernel), ``lm_loss`` the training one. The MoE, hybrid, SSM and
enc-dec families raise ``NotImplementedError``; they wait for later
slices (ROADMAP.md). Decode threads an explicit KV cache that
``decode_step`` updates in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .attention import Attention, attention, make_kv_cache
from .common import (ModelConfig, cross_entropy_loss, new_param, normal_,
                     rms_norm)
from .mlp import MLP, mlp

__all__ = ["Block", "LM", "init_lm", "forward", "lm_loss", "DecodeCaches",
           "make_decode_caches", "decode_step", "check_family"]

# parameters drawn as normal x 1.0 in float32 (the norm gains)
_GAINS = ("ln1", "ln2", "final_norm")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.embed_frontend:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense token-input family only; "
            f"family {cfg.family!r} waits for a later slice (ROADMAP.md)")


class Block(nn.Module):
    """One pre-norm layer: ``ln1``, ``attn``, ``ln2``, ``ffn``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.ln1 = new_param((cfg.d_model,), torch.float32, device)
        self.ln2 = new_param((cfg.d_model,), torch.float32, device)
        self.attn = Attention(cfg, device=device)
        self.ffn = MLP(cfg, device=device)


class LM(nn.Module):
    """Parameters of the dense LM, named as the reference's tree:
    ``embed`` ``(v, d)``, ``final_norm``, ``lm_head`` ``(d, v)`` (untied
    configs) and ``layers[i]`` — the reference's ``layers`` leaves
    unstacked along their leading ``(n_layers,)`` axis."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab
        self.embed = new_param((v, d), cfg.dtype, device)
        self.final_norm = new_param((d,), torch.float32, device)
        if not cfg.tie_embeddings:
            self.lm_head = new_param((d, v), cfg.dtype, device)
        self.layers = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.n_layers))

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


@torch.no_grad()
def init_lm(cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
            device=None) -> LM:
    """Random weights drawn on ``device`` (the card when None) from
    ``generator`` (seed 0 when None): ``normal x 0.02`` in ``cfg.dtype``,
    norm gains ``normal x 1.0`` in float32, as the reference draws them
    (the values differ: the generators differ)."""
    dev = resolve_device(device, what="init_lm")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = LM(cfg, device=dev)
    for name, p in model.named_parameters():
        gain = name.rsplit(".", 1)[-1] in _GAINS
        normal_(p, generator, 1.0 if gain else 0.02)
    return model


def _block_fwd(cfg: ModelConfig, layer: Block, x: torch.Tensor,
               positions: torch.Tensor, backend: str) -> torch.Tensor:
    h = rms_norm(x, layer.ln1, cfg.norm_eps)
    x = x + attention(layer.attn, h, cfg, positions, backend=backend)
    h2 = rms_norm(x, layer.ln2, cfg.norm_eps)
    return x + mlp(layer.ffn, h2)


def _logits(params: LM, tokens: torch.Tensor, cfg: ModelConfig, *,
            backend: str, remat: bool) -> torch.Tensor:
    x = torch.nn.functional.embedding(tokens, params.embed)
    positions = torch.arange(x.shape[1], device=x.device)
    for layer in params.layers:
        if remat and torch.is_grad_enabled():
            x = checkpoint(_block_fwd, cfg, layer, x, positions, backend,
                           use_reentrant=False)
        else:
            x = _block_fwd(cfg, layer, x, positions, backend)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x @ params.head()


@torch.no_grad()
def forward(params: LM, tokens: torch.Tensor, cfg: ModelConfig, *,
            backend: str = "auto") -> torch.Tensor:
    """Full-sequence forward: tokens ``(b, s)`` -> logits ``(b, s, vocab)``,
    with no autograd graph. ``backend`` picks the prefill attention route
    (``"auto"``: the kernel on CUDA, the reference's CPU path elsewhere;
    ``"plain"``: the reference's CPU path on any device)."""
    return _logits(params, tokens, cfg, backend=backend, remat=False)


def lm_loss(params: LM, batch: dict, cfg: ModelConfig, *,
            remat: bool = True, backend: str = "auto") -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``).
    Under grad mode it builds the graph (layers rematerialised with
    ``remat``); training asks for ``backend="plain"``, the reference's
    differentiable attention, since the flash kernel has no backward
    (its wrapper raises rather than drop the gradient)."""
    logits = _logits(params, batch["tokens"], cfg, backend=backend,
                     remat=remat)
    return cross_entropy_loss(logits, batch["labels"])


class DecodeCaches(NamedTuple):
    """Decode state; the dense family keeps only the stacked KV cache
    ``(k, v)``, each ``(n_layers, b, hkv, s_max, dh)``."""

    kv: Optional[tuple] = None


def make_decode_caches(cfg: ModelConfig, batch: int, s_max: int, *,
                       device=None) -> DecodeCaches:
    check_family(cfg)
    return DecodeCaches(kv=make_kv_cache(
        cfg, batch, s_max, cfg.n_layers,
        device=resolve_device(device, what="make_decode_caches")))


@torch.no_grad()
def decode_step(params: LM, tokens: torch.Tensor, caches: DecodeCaches,
                pos, cfg: ModelConfig
                ) -> tuple[torch.Tensor, DecodeCaches]:
    """One decode step. tokens: ``(b, s)`` int (s = 1 for a step); pos:
    the global position of the first token (the cache insert index).
    Returns logits ``(b, s, vocab)`` and the caches, updated in place."""
    pos = int(pos)
    x = params.embed[tokens]
    positions = torch.arange(pos, pos + x.shape[1], device=x.device)
    ck, cv = caches.kv
    for i, layer in enumerate(params.layers):
        h = rms_norm(x, layer.ln1, cfg.norm_eps)
        out, _ = attention(layer.attn, h, cfg, positions,
                           cache=(ck[i], cv[i]), cache_index=pos)
        x = x + out
        x = x + mlp(layer.ffn, rms_norm(x, layer.ln2, cfg.norm_eps))
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x @ params.head(), caches
