"""Encoder-decoder transformer (the seamless-m4t backbone).

Counterpart of ``repro.models.encdec``. The modality frontend is a stub,
as in the reference: the encoder takes precomputed frame embeddings
``(b, s_src, d_model)``. Encoder blocks are bidirectional; decoder
blocks are causal self-attention, then cross-attention to the encoder's
output, then the MLP. The layers run as a Python loop over
``nn.ModuleList``s where the reference scans stacked parameters
(``enc_layers[i]``, ``dec_layers[i]``); under grad mode with ``remat``
each layer is rematerialised in the backward, as the reference wraps it
in ``jax.checkpoint`` (inference ignores the flag).

Attention goes through ``attention.mha_attend``: on the card all three
kinds launch the flash kernel (the encoder's and the cross-attention
non-causal, the decoder's self-attention causal); on the CPU, or with
``backend="plain"``, the reference's route.

Quirks kept from the reference, since the port is held to it:

* RoPE rotates the cross-attention's queries at their target positions
  and its keys at their source positions;
* the source embeddings are cast to the model's type before the first
  layer;
* decode attends its own growing cache through the masked whole-cache
  ``_decode_attend`` of the decoder-only models, and the fixed cross
  K/V with the q.k product in the model's type (rounded to bf16 in a
  bf16 model) and then float32, the value product in float32; a
  multi-token step rotates every query and key at the step's first
  position, as the reference does.

``encdec_loss_tp`` is the tensor-parallel training loss on a data
rank's model positions (``distributed.tp``), with the reference's
layout requests: both stacks' residual streams in the ``bsd`` layout of
their own lengths, every attention (the cross-attention's q from the
decoder, its k and v from the encoder's output gathered whole) and MLP
per rank, the embedding and the head vocab-parallel where the
vocabulary divides, else the logits' sequence rows per rank.

Decode reads its position from the device alone and writes its K/V rows
in place (``index_copy_``), so one step is captured once as a CUDA graph
and replayed at every position (``launch.serve.generate``); the cross
K/V are that graph's fixed inputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .attention import (Attention, _decode_attend, attention_tp,
                        cache_split, cross_attention_tp, decode_attention_tp,
                        layer_of, make_kv_cache, mha_attend, repeat_kv)
from .common import (ModelConfig, cross_entropy_loss, embed_tp,
                     last_logits_tp, lm_head_loss_tp, new_param, normal_,
                     rms_norm, rope)
from .mlp import MLP, mlp, mlp_tp

__all__ = ["EncBlock", "DecBlock", "EncDec", "init_encdec", "encode",
           "forward_encdec", "encdec_loss", "encdec_loss_tp",
           "prefill_encdec_tp", "EncDecCaches", "decode_step_encdec_tp",
           "make_encdec_caches", "decode_step_encdec", "precompute_cross_kv"]


def _norm(d: int, device) -> nn.Parameter:
    return new_param((d,), torch.float32, device)


class EncBlock(nn.Module):
    """``ln1``, ``attn`` (bidirectional), ``ln2``, ``ffn``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.ln1 = _norm(cfg.d_model, device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = _norm(cfg.d_model, device)
        self.ffn = MLP(cfg, device=device)


class DecBlock(nn.Module):
    """``ln1``, ``self_attn`` (causal), ``ln_x``, ``cross_attn``, ``ln2``,
    ``ffn``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.ln1 = _norm(cfg.d_model, device)
        self.self_attn = Attention(cfg, device=device)
        self.ln_x = _norm(cfg.d_model, device)
        self.cross_attn = Attention(cfg, device=device)
        self.ln2 = _norm(cfg.d_model, device)
        self.ffn = MLP(cfg, device=device)


class EncDec(nn.Module):
    """Parameters named as the reference's tree: ``embed`` ``(v, d)``,
    ``enc_layers[i]``, ``dec_layers[i]`` (the reference's stacked leaves
    unstacked along their leading axis), ``enc_norm``, ``final_norm``,
    ``lm_head`` ``(d, v)``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: EncDec builds the encdec family, "
                             f"not {cfg.family!r}")
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab
        self.embed = new_param((v, d), cfg.dtype, device)
        self.enc_layers = nn.ModuleList(EncBlock(cfg, device=device)
                                        for _ in range(cfg.encoder_layers))
        self.dec_layers = nn.ModuleList(DecBlock(cfg, device=device)
                                        for _ in range(cfg.n_layers))
        self.enc_norm = _norm(d, device)
        self.final_norm = _norm(d, device)
        self.lm_head = new_param((d, v), cfg.dtype, device)


@torch.no_grad()
def init_encdec(cfg: ModelConfig, *,
                generator: Optional[torch.Generator] = None,
                device=None) -> EncDec:
    """Random weights drawn on ``device`` (the card when None) from
    ``generator`` (seed 0 when None), with the reference's scales and
    dtypes (``transformer.init_scale``: norm gains ``x 1.0`` in float32,
    the rest ``x 0.02`` in the model's type)."""
    from .transformer import init_scale

    dev = resolve_device(device, what="init_encdec")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = EncDec(cfg, device=dev)
    for name, p in model.named_parameters():
        normal_(p, generator, init_scale(name))
    return model


def _mha(p: Attention, xq: torch.Tensor, xkv: torch.Tensor,
         cfg: ModelConfig, *, causal: bool, q_pos: torch.Tensor,
         kv_pos: torch.Tensor, backend: str) -> torch.Tensor:
    """Attention of ``xq`` over ``xkv``, bidirectional (encoder, cross)
    or causal (decoder self-attention); RoPE at ``q_pos`` and ``kv_pos``.
    q, k and v reach the kernel as ``(b, h, s, dh)`` views of the
    projections, as in ``attention.attention``."""
    b, sq, _ = xq.shape
    skv = xkv.shape[1]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = rope((xq @ p.wq).reshape(b, sq, hq, dh), q_pos, cfg.rope_theta)
    k = rope((xkv @ p.wk).reshape(b, skv, hkv, dh), kv_pos, cfg.rope_theta)
    v = (xkv @ p.wv).reshape(b, skv, hkv, dh)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    out = mha_attend(q, k, v, causal=causal, backend=backend)
    out = out.to(xq.dtype).transpose(1, 2).reshape(b, sq, hq * dh)
    return out @ p.wo


def _enc_block(cfg: ModelConfig, p: EncBlock, x: torch.Tensor,
               pos: torch.Tensor, backend: str) -> torch.Tensor:
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    x = x + _mha(p.attn, h, h, cfg, causal=False, q_pos=pos, kv_pos=pos,
                 backend=backend)
    return x + mlp(p.ffn, rms_norm(x, p.ln2, cfg.norm_eps))


def _dec_block(cfg: ModelConfig, p: DecBlock, x: torch.Tensor,
               memory: torch.Tensor, pos_t: torch.Tensor,
               pos_s: torch.Tensor, backend: str) -> torch.Tensor:
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    x = x + _mha(p.self_attn, h, h, cfg, causal=True, q_pos=pos_t,
                 kv_pos=pos_t, backend=backend)
    hx = rms_norm(x, p.ln_x, cfg.norm_eps)
    x = x + _mha(p.cross_attn, hx, memory, cfg, causal=False, q_pos=pos_t,
                 kv_pos=pos_s, backend=backend)
    return x + mlp(p.ffn, rms_norm(x, p.ln2, cfg.norm_eps))


def _run(fn, remat: bool, *args) -> torch.Tensor:
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encode(params: EncDec, src_embeds: torch.Tensor, cfg: ModelConfig, *,
           remat: bool = True, backend: str = "auto") -> torch.Tensor:
    """src_embeds ``(b, s_src, d)`` from the (stubbed) frontend -> the
    encoder's output ``(b, s_src, d)`` in the model's type."""
    x = src_embeds.to(cfg.dtype)
    pos = torch.arange(x.shape[1], device=x.device)
    for p in params.enc_layers:
        x = _run(_enc_block, remat, cfg, p, x, pos, backend)
    return rms_norm(x, params.enc_norm, cfg.norm_eps)


def forward_encdec(params: EncDec, src_embeds: torch.Tensor,
                   tgt_tokens: torch.Tensor, cfg: ModelConfig, *,
                   remat: bool = True, backend: str = "auto"
                   ) -> torch.Tensor:
    """The full forward -> logits ``(b, s_tgt, vocab)``. ``backend``
    picks the attention route (``attention.mha_attend``)."""
    memory = encode(params, src_embeds, cfg, remat=remat, backend=backend)
    x = torch.nn.functional.embedding(tgt_tokens, params.embed)
    pos_t = torch.arange(x.shape[1], device=x.device)
    pos_s = torch.arange(memory.shape[1], device=x.device)
    for p in params.dec_layers:
        x = _run(_dec_block, remat, cfg, p, x, memory, pos_t, pos_s,
                 backend)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x @ params.lm_head


def encdec_loss(params: EncDec, batch: dict, cfg: ModelConfig, *,
                remat: bool = True, backend: str = "auto") -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``src_embeds``,
    ``tokens``, ``labels``)."""
    logits = forward_encdec(params, batch["src_embeds"], batch["tokens"],
                            cfg, remat=remat, backend=backend)
    return cross_entropy_loss(logits, batch["labels"])


def _enc_block_tp(cfg: ModelConfig, p: EncBlock, x: torch.Tensor,
                  pos: torch.Tensor, group, shape) -> torch.Tensor:
    group.placed("bsd", shape, x)
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    x = x + attention_tp(p.attn, h, cfg, group, q_pos=pos, causal=False)
    return x + mlp_tp(p.ffn, rms_norm(x, p.ln2, cfg.norm_eps), group, shape)


def _dec_block_tp(cfg: ModelConfig, p: DecBlock, x: torch.Tensor,
                  memory: torch.Tensor, pos_t: torch.Tensor,
                  pos_s: torch.Tensor, group, shape) -> torch.Tensor:
    group.placed("bsd", shape, x)
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    x = x + attention_tp(p.self_attn, h, cfg, group, q_pos=pos_t,
                         causal=True)
    hx = rms_norm(x, p.ln_x, cfg.norm_eps)
    x = x + attention_tp(p.cross_attn, hx, cfg, group, q_pos=pos_t,
                         causal=False, xkv=memory, kv_pos=pos_s)
    return x + mlp_tp(p.ffn, rms_norm(x, p.ln2, cfg.norm_eps), group, shape)


def _final_tp(params: EncDec, batch: dict, cfg: ModelConfig, group,
              remat: bool) -> tuple[torch.Tensor, tuple]:
    """The decoder's final normed residual per model rank, in the ``bsd``
    layout, and its whole shape."""
    src = batch["src_embeds"].to(cfg.dtype)
    b, s_src, d = src.shape
    enc_shape = (b, s_src, d)
    x = group.from_replicated(src, enc_shape)
    pos_s = torch.arange(s_src, device=src.device)
    for p in params.enc_layers:
        x = _run(_enc_block_tp, remat, cfg, p, x, pos_s, group, enc_shape)
    memory = rms_norm(x, params.enc_norm, cfg.norm_eps)
    tokens = batch["tokens"]
    shape = (b, tokens.shape[1], d)
    y = embed_tp(params.embed, tokens, group, shape)
    pos_t = torch.arange(tokens.shape[1], device=tokens.device)
    for p in params.dec_layers:
        y = _run(_dec_block_tp, remat, cfg, p, y, memory, pos_t, pos_s,
                 group, shape)
    group.placed("bsd", shape, y)
    return rms_norm(y, params.final_norm, cfg.norm_eps), shape


def encdec_loss_tp(params: EncDec, batch: dict, cfg: ModelConfig, group, *,
                   remat: bool = True) -> torch.Tensor:
    """``encdec_loss`` computed per model rank on ``group`` (a
    ``distributed.tp.Group``); ``params`` holds its leaves as
    ``spmd.ShardedModel.tp_module_on`` stacks them."""
    y, shape = _final_tp(params, batch, cfg, group, remat)
    return lm_head_loss_tp(y, params.lm_head, batch["labels"], group, shape)


@torch.no_grad()
def prefill_encdec_tp(params: EncDec, batch: dict, cfg: ModelConfig, group
                      ) -> torch.Tensor:
    """The sharded prefill's forward: ``encdec_loss_tp``'s without the
    loss, its logits over every target position, of which it returns the
    last position's ``(b, vocab)`` (``common.last_logits_tp``)."""
    y, shape = _final_tp(params, batch, cfg, group, remat=False)
    return last_logits_tp(y, params.lm_head, group, shape)


class EncDecCaches(NamedTuple):
    """``self_kv`` (k, v) ``(L, b, hkv, s_max, dh)`` each, written in
    place by decode; ``cross_k``, ``cross_v`` ``(L, b, hkv, s_src, dh)``
    (``precompute_cross_kv``); ``memory_pos`` ``(s_src,)`` int32."""

    self_kv: tuple
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    memory_pos: torch.Tensor


def make_encdec_caches(cfg: ModelConfig, batch: int, s_max: int, s_src: int,
                       *, device=None) -> EncDecCaches:
    """Zeroed caches in the model's type on ``device`` (the card when
    None)."""
    dev = resolve_device(device, what="make_encdec_caches")
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, s_src, cfg.head_dim)
    return EncDecCaches(
        self_kv=make_kv_cache(cfg, batch, s_max, cfg.n_layers, device=dev),
        cross_k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        cross_v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        memory_pos=torch.arange(s_src, dtype=torch.int32, device=dev))


@torch.no_grad()
def decode_step_encdec(params: EncDec, tokens: torch.Tensor,
                       caches: EncDecCaches, pos, cfg: ModelConfig
                       ) -> tuple[torch.Tensor, EncDecCaches]:
    """One decoder step against the precomputed cross K/V. tokens
    ``(b, s)``; pos: the first token's position, an int or a 0-d integer
    tensor on the tokens' device. Returns logits ``(b, s, vocab)`` and
    the caches, their ``self_kv`` updated in place."""
    x = params.embed[tokens]
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = pos + torch.arange(s, device=x.device)
    first = positions[:1]        # the reference rotates at pos alone
    ck_all, cv_all = caches.self_kv
    group = hq // hkv
    for i, p in enumerate(params.dec_layers):
        h = rms_norm(x, p.ln1, cfg.norm_eps)
        sa = p.self_attn
        q = rope((h @ sa.wq).reshape(b, s, hq, dh), first,
                 cfg.rope_theta).transpose(1, 2)
        k = rope((h @ sa.wk).reshape(b, s, hkv, dh), first,
                 cfg.rope_theta).transpose(1, 2)
        v = (h @ sa.wv).reshape(b, s, hkv, dh).transpose(1, 2)
        ck_all[i].index_copy_(2, positions, k.to(ck_all.dtype))
        cv_all[i].index_copy_(2, positions, v.to(cv_all.dtype))
        out = _decode_attend(q, ck_all[i], cv_all[i], positions, window=None)
        x = x + out.transpose(1, 2).reshape(b, s, hq * dh) @ sa.wo
        # cross-attention against the fixed memory
        hx = rms_norm(x, p.ln_x, cfg.norm_eps)
        ca = p.cross_attn
        qx = rope((hx @ ca.wq).reshape(b, s, hq, dh), first,
                  cfg.rope_theta).transpose(1, 2)
        ck = repeat_kv(caches.cross_k[i], group)
        cv = repeat_kv(caches.cross_v[i], group)
        logits = torch.matmul(qx, ck.transpose(-1, -2)).float() \
            / math.sqrt(dh)
        probs = torch.softmax(logits, dim=-1)
        outx = torch.matmul(probs, cv.float())
        outx = outx.to(x.dtype).transpose(1, 2).reshape(b, s, hq * dh)
        x = x + outx @ ca.wo
        x = x + mlp(p.ffn, rms_norm(x, p.ln2, cfg.norm_eps))
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x @ params.lm_head, caches


@torch.no_grad()
def decode_step_encdec_tp(params: EncDec, tokens: torch.Tensor,
                          caches: EncDecCaches, dims: EncDecCaches, pos,
                          cfg: ModelConfig, group) -> torch.Tensor:
    """``decode_step_encdec`` on a data rank's model positions
    (``group``, the residual replicated): ``caches`` the rank's views of
    the ``spmd.ShardedCaches`` and ``dims`` each leaf's model dimension.
    Self-attention against its KV cache and cross-attention against the
    precomputed cross K/V, each by heads, by head width or by sequence
    (``attention.decode_attention_tp``, ``cross_attention_tp``; both
    rotated at the step's first position, as the reference), the MLP as
    in training, the embedding and head vocab parallel where they come
    split. Returns the next position's logits ``(b, vocab)``,
    replicated; the self-attention caches are updated in place."""
    b = tokens.shape[0]
    shape = (b, 1, cfg.d_model)
    x = embed_tp(params.embed, tokens, group, shape)
    positions = pos + torch.arange(1, device=tokens.device)
    first = positions[:1]
    ck_all, cv_all = caches.self_kv
    kd, xd = dims.self_kv[0], dims.cross_k
    split, xsplit = cache_split(kd), cache_split(xd)
    for i, p in enumerate(params.dec_layers):
        h = rms_norm(x, p.ln1, cfg.norm_eps)
        x = x + decode_attention_tp(
            p.self_attn, h, cfg, group, positions, layer_of(ck_all, i, kd),
            layer_of(cv_all, i, kd), split, slot=positions, rope_at=first)
        hx = rms_norm(x, p.ln_x, cfg.norm_eps)
        x = x + cross_attention_tp(
            p.cross_attn, hx, cfg, group, layer_of(caches.cross_k, i, xd),
            layer_of(caches.cross_v, i, xd), xsplit, rope_at=first)
        x = x + mlp_tp(p.ffn, rms_norm(x, p.ln2, cfg.norm_eps), group, shape)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return last_logits_tp(x, params.lm_head, group, shape)


@torch.no_grad()
def precompute_cross_kv(params: EncDec, memory: torch.Tensor,
                        cfg: ModelConfig
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K and V of every decoder layer from the encoder's
    output ``(b, s_src, d)``: two ``(L, b, hkv, s_src, dh)`` tensors, the
    keys rotated at the source positions."""
    b, s_src, _ = memory.shape
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    pos = torch.arange(s_src, device=memory.device)
    ks, vs = [], []
    for p in params.dec_layers:
        ca = p.cross_attn
        ks.append(rope((memory @ ca.wk).reshape(b, s_src, hkv, dh), pos,
                       cfg.rope_theta).transpose(1, 2))
        vs.append((memory @ ca.wv).reshape(b, s_src, hkv, dh)
                  .transpose(1, 2))
    return torch.stack(ks), torch.stack(vs)
