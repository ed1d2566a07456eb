"""Decoder-only LM assembly: dense, MoE, SSM (RWKV-6) and hybrid (Griffin).

Counterpart of ``repro.models.transformer``. The layers run as a Python
loop over ``nn.ModuleList``s where the reference scans stacked
parameters: ``layers`` for the dense, MoE and SSM families; for the
hybrid, ``supers`` of (R, R, A) — two RG-LRU blocks and one local
(windowed) attention block — and a ``tail`` of the remaining
``n_layers mod 3`` RG-LRU blocks. Under grad mode each layer (each super
of the hybrid) is rematerialised in the backward
(``torch.utils.checkpoint``, as the reference wraps it in
``jax.checkpoint``). ``forward`` is the inference entry (no graph; on
the card, non-windowed prefill attention takes the flash kernel; the
hybrid's windowed attention takes the reference's plain path, as the
reference routes it), ``lm_loss`` the training one. ``lm_loss_tp`` is
every decoder family's tensor- (and expert-) parallel loss on a data
rank's model positions (``distributed.tp``): the residual stream in the
``bsd`` layout (its sequence over the model ranks where it divides:
sequence parallelism; the SSM's blocks keep it ``bsd_batch_only``),
every layer's attention, MLP, MoE, RG-LRU or RWKV mixes, the embedding
and the head computed per rank (``attention_tp``, ``mlp_tp``,
``moe_tp``, ``rglru_block_tp``, ``rwkv_time_mix_chunked_tp``,
``rwkv_channel_mix_tp``, ``embed_tp``, ``lm_head_loss_tp``). The enc-dec
family is ``models.encdec``; ``LM`` refuses it.

Decode threads explicit caches that ``decode_step`` updates in place: a
KV cache for the dense and MoE families, RWKV states and the channel
mix's last token for the SSM, and for the hybrid the RG-LRU states and
a ring buffer of ``min(window, s_max)`` KV slots with the global
position each slot holds (``ring_pos``, -1 while empty). The SSM and
hybrid decode take one token a step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..distributed.tp import gather_from_ranks
from .attention import (Attention, attention, attention_tp, make_kv_cache,
                        repeat_kv)
from .common import (ModelConfig, cross_entropy_loss, embed_tp,
                     lm_head_loss_tp, new_param, normal_, rms_norm, rope)
from .mlp import MLP, mlp, mlp_tp
from .moe import MoE, moe, moe_tp
from .rglru import (RGLRU, RglruState, make_rglru_state, rglru_block,
                    rglru_block_tp, rglru_step)
from .rwkv6 import (RwkvChannelMix, RwkvState, RwkvTimeMix, make_rwkv_state,
                    rwkv_channel_mix, rwkv_channel_mix_tp,
                    rwkv_time_mix_chunked, rwkv_time_mix_chunked_tp,
                    rwkv_time_mix_step)

__all__ = ["Block", "Recurrent", "LocalAttention", "Super", "LM", "init_lm",
           "init_scale", "forward", "lm_loss", "lm_loss_tp", "DecodeCaches",
           "make_decode_caches", "decode_step", "check_family"]

# parameters drawn as normal x 1.0 in float32 (norm gains, the RG-LRU's lam)
_UNIT = ("ln1", "ln2", "ln", "ln_ffn", "ln_x", "enc_norm", "final_norm",
         "lam")


def init_scale(name: str) -> float:
    """The reference's ``leaf`` scale of the parameter ``name``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _UNIT:
        return 1.0
    if leaf == "conv_k":
        return 0.2
    if leaf.startswith("mix_") or leaf in ("w_bias", "u_bonus"):
        return 0.5
    return 0.02


def check_family(cfg: ModelConfig) -> None:
    """Refuse what ``LM`` does not build: the enc-dec family (its model is
    ``models.encdec``, which the registry dispatches to)."""
    if cfg.family not in ("dense", "moe", "hybrid", "ssm") \
            or cfg.embed_frontend:
        raise ValueError(
            f"{cfg.name}: LM builds the decoder-only token-input families, "
            f"not {cfg.family!r}; the registry builds the enc-dec family "
            "through models.encdec")


def _norm(d: int, device) -> nn.Parameter:
    return new_param((d,), torch.float32, device)


class Block(nn.Module):
    """One pre-norm layer: ``ln1``, ``attn`` and ``ffn`` (an ``MLP``, or
    a ``MoE``), ``ln2``; for the SSM ``tm`` (time mix) and ``cm``
    (channel mix) in place of attention and ffn."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.ln1 = _norm(cfg.d_model, device)
        self.ln2 = _norm(cfg.d_model, device)
        if cfg.family == "ssm":
            self.tm = RwkvTimeMix(cfg, device=device)
            self.cm = RwkvChannelMix(cfg, device=device)
        else:
            self.attn = Attention(cfg, device=device)
            self.ffn = (MoE if cfg.family == "moe" else MLP)(cfg,
                                                             device=device)


class Recurrent(nn.Module):
    """The hybrid's recurrent layer: ``ln``, ``rglru``, ``ln_ffn``,
    ``ffn``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.ln = _norm(cfg.d_model, device)
        self.rglru = RGLRU(cfg, device=device)
        self.ln_ffn = _norm(cfg.d_model, device)
        self.ffn = MLP(cfg, device=device)


class LocalAttention(nn.Module):
    """The hybrid's attention layer: ``ln``, ``attn`` (windowed),
    ``ln_ffn``, ``ffn``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.ln = _norm(cfg.d_model, device)
        self.attn = Attention(cfg, device=device)
        self.ln_ffn = _norm(cfg.d_model, device)
        self.ffn = MLP(cfg, device=device)


class Super(nn.Module):
    """The hybrid's (R, R, A) super-block: ``r0``, ``r1``, ``attn``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        self.r0 = Recurrent(cfg, device=device)
        self.r1 = Recurrent(cfg, device=device)
        self.attn = LocalAttention(cfg, device=device)


class LM(nn.Module):
    """Parameters of a decoder-only LM, named as the reference's tree:
    ``embed`` ``(v, d)``, ``final_norm``, ``lm_head`` ``(d, v)`` (untied
    configs), and ``layers[i]`` — or, for the hybrid, ``supers[i]`` and
    ``tail[j]`` — the reference's stacked leaves unstacked along their
    leading axis."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab
        self.embed = new_param((v, d), cfg.dtype, device)
        self.final_norm = _norm(d, device)
        if not cfg.tie_embeddings:
            self.lm_head = new_param((d, v), cfg.dtype, device)
        if cfg.family == "hybrid":
            n_super, rem = divmod(cfg.n_layers, 3)
            self.supers = nn.ModuleList(Super(cfg, device=device)
                                        for _ in range(n_super))
            self.tail = nn.ModuleList(Recurrent(cfg, device=device)
                                      for _ in range(rem))
        else:
            self.layers = nn.ModuleList(Block(cfg, device=device)
                                        for _ in range(cfg.n_layers))

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


@torch.no_grad()
def init_lm(cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
            device=None) -> LM:
    """Random weights drawn on ``device`` (the card when None) from
    ``generator`` (seed 0 when None), with the reference's scales and
    dtypes (``init_scale``; the values differ: the generators differ)."""
    dev = resolve_device(device, what="init_lm")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = LM(cfg, device=dev)
    for name, p in model.named_parameters():
        normal_(p, generator, init_scale(name))
    return model


# ------------------------------------------------------------------ forward
def _block_fwd(cfg: ModelConfig, layer: Block, x: torch.Tensor,
               positions: torch.Tensor, backend: str) -> torch.Tensor:
    h = rms_norm(x, layer.ln1, cfg.norm_eps)
    if cfg.family == "ssm":
        b, _, d = x.shape
        dh = cfg.rwkv_head_dim
        st = RwkvState(
            s=torch.zeros((b, d // dh, dh, dh), dtype=torch.float32,
                          device=x.device),
            x_prev=x.new_zeros((b, d)))
        out, _ = rwkv_time_mix_chunked(layer.tm, h, cfg, st)
        x = x + out
        out2, _ = rwkv_channel_mix(layer.cm, rms_norm(x, layer.ln2,
                                                      cfg.norm_eps),
                                   x.new_zeros((b, d)))
        return x + out2
    x = x + attention(layer.attn, h, cfg, positions, backend=backend)
    h2 = rms_norm(x, layer.ln2, cfg.norm_eps)
    if cfg.family == "moe":
        return x + moe(layer.ffn, h2, cfg)
    return x + mlp(layer.ffn, h2)


def _rec_fwd(cfg: ModelConfig, p: Recurrent, x: torch.Tensor
             ) -> torch.Tensor:
    w = cfg.rnn_width or cfg.d_model
    b = x.shape[0]
    st = RglruState(h=torch.zeros((b, w), dtype=torch.float32,
                                  device=x.device),
                    conv=x.new_zeros((b, 3, w)))
    out, _ = rglru_block(p.rglru, rms_norm(x, p.ln, cfg.norm_eps), cfg, st)
    x = x + out
    return x + mlp(p.ffn, rms_norm(x, p.ln_ffn, cfg.norm_eps))


def _super_fwd(cfg: ModelConfig, p: Super, x: torch.Tensor,
               positions: torch.Tensor, backend: str) -> torch.Tensor:
    x = _rec_fwd(cfg, p.r0, x)
    x = _rec_fwd(cfg, p.r1, x)
    pa = p.attn
    x = x + attention(pa.attn, rms_norm(x, pa.ln, cfg.norm_eps), cfg,
                      positions, window=cfg.window, backend=backend)
    return x + mlp(pa.ffn, rms_norm(x, pa.ln_ffn, cfg.norm_eps))


def _logits(params: LM, tokens: torch.Tensor, cfg: ModelConfig, *,
            backend: str, remat: bool) -> torch.Tensor:
    x = torch.nn.functional.embedding(tokens, params.embed)
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.family == "hybrid":
        steps = [(_super_fwd, p) for p in params.supers]
    else:
        steps = [(_block_fwd, layer) for layer in params.layers]
    for fn, p in steps:
        if remat and torch.is_grad_enabled():
            x = checkpoint(fn, cfg, p, x, positions, backend,
                           use_reentrant=False)
        else:
            x = fn(cfg, p, x, positions, backend)
    if cfg.family == "hybrid":
        for p in params.tail:
            x = _rec_fwd(cfg, p, x)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x @ params.head()


@torch.no_grad()
def forward(params: LM, tokens: torch.Tensor, cfg: ModelConfig, *,
            backend: str = "auto") -> torch.Tensor:
    """Full-sequence forward: tokens ``(b, s)`` -> logits ``(b, s, vocab)``,
    with no autograd graph. ``backend`` picks the prefill attention route
    (``"auto"``: the kernel on CUDA, the reference's CPU path elsewhere;
    ``"plain"``: the reference's CPU path on any device); windowed
    attention always takes the reference's path. The SSM's sequence must
    be a multiple of its 64-token chunk."""
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


def _block_tp(cfg: ModelConfig, layer: Block, x: torch.Tensor,
              positions: torch.Tensor, group, shape) -> torch.Tensor:
    group.placed("bsd", shape, x)
    h = rms_norm(x, layer.ln1, cfg.norm_eps)
    x = x + attention_tp(layer.attn, h, cfg, group, q_pos=positions,
                         causal=True)
    h2 = rms_norm(x, layer.ln2, cfg.norm_eps)
    if cfg.family == "moe":
        return x + moe_tp(layer.ffn, h2, cfg, group, shape)
    return x + mlp_tp(layer.ffn, h2, group, shape)


def _rec_tp(cfg: ModelConfig, p: Recurrent, x: torch.Tensor, group,
            shape) -> torch.Tensor:
    group.placed("bsd", shape, x)
    x = x + rglru_block_tp(p.rglru, rms_norm(x, p.ln, cfg.norm_eps), cfg,
                           group, shape)
    return x + mlp_tp(p.ffn, rms_norm(x, p.ln_ffn, cfg.norm_eps), group,
                      shape)


def _super_tp(cfg: ModelConfig, p: Super, x: torch.Tensor,
              positions: torch.Tensor, group, shape) -> torch.Tensor:
    x = _rec_tp(cfg, p.r0, x, group, shape)
    x = _rec_tp(cfg, p.r1, x, group, shape)
    pa = p.attn
    x = x + attention_tp(pa.attn, rms_norm(x, pa.ln, cfg.norm_eps), cfg,
                         group, q_pos=positions, causal=True,
                         window=cfg.window)
    return x + mlp_tp(pa.ffn, rms_norm(x, pa.ln_ffn, cfg.norm_eps), group,
                      shape)


def _ssm_block_tp(cfg: ModelConfig, layer: Block, x: torch.Tensor,
                  positions: torch.Tensor, group, shape) -> torch.Tensor:
    group.placed("bsd_batch_only", shape, x)
    x = x + rwkv_time_mix_chunked_tp(
        layer.tm, rms_norm(x, layer.ln1, cfg.norm_eps), cfg, group)
    return x + rwkv_channel_mix_tp(
        layer.cm, rms_norm(x, layer.ln2, cfg.norm_eps), group)


def lm_loss_tp(params: LM, batch: dict, cfg: ModelConfig, group, *,
               remat: bool = True) -> torch.Tensor:
    """``lm_loss`` computed per model rank on ``group`` (a
    ``distributed.tp.Group``); ``params`` holds its leaves as
    ``spmd.ShardedModel.tp_module_on`` stacks them. The residual is in
    the ``bsd`` layout, but through the SSM's blocks, which keep it
    ``bsd_batch_only`` (the whole sequence on every rank, replicated over
    ``"model"``: the recurrence runs over it) and return it to ``bsd``
    before the final norm. The hybrid runs its supers' (R, R, A) and its
    tail's recurrent layers (``rglru_block_tp``, ``mlp_tp``, windowed
    ``attention_tp``). Layers (the hybrid's supers) are rematerialised
    as in ``lm_loss``."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    shape = (b, s, cfg.d_model)
    x = embed_tp(params.embed, tokens, group, shape)
    positions = torch.arange(s, device=tokens.device)
    if cfg.family == "hybrid":
        steps = [(_super_tp, p) for p in params.supers]
    elif cfg.family == "ssm":
        steps = [(_ssm_block_tp, layer) for layer in params.layers]
        if group.seq_split(shape):                 # bsd -> bsd_batch_only
            x = gather_from_ranks(x, group, 1)
    else:
        steps = [(_block_tp, layer) for layer in params.layers]
    for fn, p in steps:
        if remat and torch.is_grad_enabled():
            x = checkpoint(fn, cfg, p, x, positions, group, shape,
                           use_reentrant=False)
        else:
            x = fn(cfg, p, x, positions, group, shape)
    if cfg.family == "hybrid":
        for p in params.tail:
            x = _rec_tp(cfg, p, x, group, shape)
    if cfg.family == "ssm":
        x = group.from_replicated(x, shape)        # back to bsd
    group.placed("bsd", shape, x)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    head = params.embed.transpose(-1, -2) if cfg.tie_embeddings \
        else params.lm_head
    return lm_head_loss_tp(x, head, batch["labels"], group, shape)


# ------------------------------------------------------------------- decode
class DecodeCaches(NamedTuple):
    """Decode state, by family: ``kv`` ``(k, v)`` stacked
    ``(n, b, hkv, slots, dh)`` (dense and MoE: n = n_layers, slots =
    s_max; hybrid: n = supers, slots = the ring's); ``rwkv`` and
    ``cm_prev`` ``(n_layers, b, d)`` (SSM); ``rglru`` stacked over the
    recurrent layers in the reference's order (each super's r0, r1, then
    the tail) and ``ring_pos`` ``(supers, slots)`` int32 (hybrid)."""

    kv: Optional[tuple] = None
    rwkv: Optional[RwkvState] = None
    cm_prev: Optional[torch.Tensor] = None
    rglru: Optional[RglruState] = None
    ring_pos: Optional[torch.Tensor] = None


def make_decode_caches(cfg: ModelConfig, batch: int, s_max: int, *,
                       device=None) -> DecodeCaches:
    check_family(cfg)
    dev = resolve_device(device, what="make_decode_caches")
    if cfg.family == "ssm":
        return DecodeCaches(
            rwkv=make_rwkv_state(cfg, batch, cfg.n_layers, device=dev),
            cm_prev=torch.zeros((cfg.n_layers, batch, cfg.d_model),
                                dtype=cfg.dtype, device=dev))
    if cfg.family == "hybrid":
        n_super, rem = divmod(cfg.n_layers, 3)
        win = min(cfg.window or s_max, s_max)
        return DecodeCaches(
            kv=make_kv_cache(cfg, batch, win, n_super, device=dev),
            rglru=make_rglru_state(cfg, batch, 2 * n_super + rem,
                                   device=dev),
            ring_pos=torch.full((n_super, win), -1, dtype=torch.int32,
                                device=dev))
    return DecodeCaches(kv=make_kv_cache(cfg, batch, s_max, cfg.n_layers,
                                         device=dev))


def _one_token(cfg: ModelConfig, x: torch.Tensor) -> None:
    if x.shape[1] != 1:
        raise ValueError(f"{cfg.name}: the {cfg.family} decode takes one "
                         f"token a step, got {x.shape[1]}")


def _decode_ssm(params: LM, x, caches: DecodeCaches, cfg: ModelConfig):
    _one_token(cfg, x)
    st = caches.rwkv
    for i, layer in enumerate(params.layers):
        h = rms_norm(x, layer.ln1, cfg.norm_eps)
        out, new = rwkv_time_mix_step(layer.tm, h, cfg,
                                      RwkvState(st.s[i], st.x_prev[i]))
        x = x + out
        out2, cm_new = rwkv_channel_mix(
            layer.cm, rms_norm(x, layer.ln2, cfg.norm_eps),
            caches.cm_prev[i])
        x = x + out2
        st.s[i].copy_(new.s)
        st.x_prev[i].copy_(new.x_prev)
        caches.cm_prev[i].copy_(cm_new)
    return x


def _decode_hybrid(params: LM, x, caches: DecodeCaches,
                   positions: torch.Tensor, cfg: ModelConfig):
    """The reference's hybrid decode: the RG-LRU steps, and local
    attention over the ring buffer written as the reference writes it
    (the q.k product in the model's dtype, then float32). positions:
    ``(1,)``, the token's global position."""
    _one_token(cfg, x)
    ck, cv = caches.kv
    rg, rp = caches.rglru, caches.ring_pos
    win = ck.shape[3]
    slot = positions % win
    window = cfg.window or win
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def rec_step(x, p: Recurrent, li: int):
        out, st = rglru_step(p.rglru, rms_norm(x, p.ln, cfg.norm_eps), cfg,
                             RglruState(rg.h[li], rg.conv[li]))
        rg.h[li].copy_(st.h)
        rg.conv[li].copy_(st.conv)
        x = x + out
        return x + mlp(p.ffn, rms_norm(x, p.ln_ffn, cfg.norm_eps))

    for i, sp in enumerate(params.supers):
        x = rec_step(x, sp.r0, 2 * i)
        x = rec_step(x, sp.r1, 2 * i + 1)
        pa = sp.attn
        h = rms_norm(x, pa.ln, cfg.norm_eps)
        b, s, _ = h.shape
        q = rope((h @ pa.attn.wq).reshape(b, s, hq, dh), positions,
                 cfg.rope_theta).transpose(1, 2)
        k = rope((h @ pa.attn.wk).reshape(b, s, hkv, dh), positions,
                 cfg.rope_theta).transpose(1, 2)
        v = (h @ pa.attn.wv).reshape(b, s, hkv, dh).transpose(1, 2)
        ck[i].index_copy_(2, slot, k.to(ck.dtype))
        cv[i].index_copy_(2, slot, v.to(cv.dtype))
        rp[i].index_copy_(0, slot, positions.to(rp.dtype))
        kk, vv = repeat_kv(ck[i], hq // hkv), repeat_kv(cv[i], hq // hkv)
        logits = torch.matmul(q, kk.transpose(-1, -2)).float() / (dh ** 0.5)
        valid = (rp[i] >= 0) & (rp[i] <= positions) \
            & (rp[i] > positions - window)
        logits = logits.masked_fill(~valid, float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        att = torch.matmul(probs, vv.float())
        att = att.to(x.dtype).transpose(1, 2).reshape(b, s, hq * dh)
        x = x + att @ pa.attn.wo
        x = x + mlp(pa.ffn, rms_norm(x, pa.ln_ffn, cfg.norm_eps))
    for j, p in enumerate(params.tail):
        x = rec_step(x, p, 2 * len(params.supers) + j)
    return x


@torch.no_grad()
def decode_step(params: LM, tokens: torch.Tensor, caches: DecodeCaches,
                pos, cfg: ModelConfig
                ) -> tuple[torch.Tensor, DecodeCaches]:
    """One decode step. tokens: ``(b, s)`` int (s = 1 for a step, and
    always for the SSM and hybrid); pos: the global position of the
    first token (the cache insert index), an int or a 0-d integer tensor
    on the tokens' device — with a tensor the step reads its position on
    the device alone, so it can be captured in a CUDA graph and replayed
    at every position. Returns logits ``(b, s, vocab)`` and the caches,
    updated in place."""
    x = params.embed[tokens]
    positions = pos + torch.arange(x.shape[1], device=x.device)
    if cfg.family == "ssm":
        x = _decode_ssm(params, x, caches, cfg)
    elif cfg.family == "hybrid":
        x = _decode_hybrid(params, x, caches, positions, cfg)
    else:
        ck, cv = caches.kv
        for i, layer in enumerate(params.layers):
            h = rms_norm(x, layer.ln1, cfg.norm_eps)
            out, _ = attention(layer.attn, h, cfg, positions,
                               cache=(ck[i], cv[i]))
            x = x + out
            h2 = rms_norm(x, layer.ln2, cfg.norm_eps)
            x = x + (moe(layer.ffn, h2, cfg) if cfg.family == "moe"
                     else mlp(layer.ffn, h2))
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return x @ params.head(), caches
