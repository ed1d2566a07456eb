"""Model registry: family-dispatching build/apply functions.

Counterpart of ``repro.models.registry``. ``params`` is the ``LM``
module of a decoder-only family (dense, MoE, hybrid or SSM) or the
``EncDec`` module of the enc-dec family; a batch holds ``tokens`` (and
``labels`` for a loss), plus ``src_embeds`` for the enc-dec family.

``tp_loss_fn`` and ``tp_weight_splits`` are the tensor-parallel step's
(``distributed.tp``): every family's loss computed per model rank, and
which dimension of each leaf the model ranks split (from the layouts
``ctx.constraint_spec`` names for the activations the leaf makes, and
the storage's split of the recurrent blocks).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from . import encdec, transformer
from .common import ModelConfig

__all__ = ["init_params", "forward_fn", "loss_fn", "make_decode_state",
           "decode_fn", "TP_FAMILIES", "tp_loss_fn", "tp_compute",
           "tp_weight_splits"]

# the families whose sharded step computes per model rank
TP_FAMILIES = ("dense", "moe", "encdec", "hybrid", "ssm")


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


def tp_loss_fn(cfg: ModelConfig):
    """(params, batch, group) -> scalar loss computed per model rank of
    ``group`` (``distributed.tp.Group``), on the reference's attention
    route; None for a family without tensor-parallel compute."""
    if cfg.family == "encdec":
        return lambda p, b, g: encdec.encdec_loss_tp(p, b, cfg, g)
    if cfg.family in TP_FAMILIES:
        return lambda p, b, g: transformer.lm_loss_tp(p, b, cfg, g)
    return None


def tp_compute(cfg: ModelConfig, mesh) -> str:
    """The compute ``cfg``'s sharded step takes on ``mesh``."""
    if mesh.shape.get("model", 1) == 1:
        return "data-parallel"
    return "tensor- and expert-parallel" if cfg.family == "moe" \
        else "tensor-parallel"


def tp_weight_splits(cfg: ModelConfig, names, group, rows: int, seq: int,
                     src_seq: int = 0) -> dict:
    """Each parameter's dimension split over ``group``'s model ranks
    (None: the rank computes with the whole leaf) for a data rank's
    ``rows`` x ``seq`` tokens (and ``src_seq`` source frames): q/k/v by
    columns and ``wo`` by rows where ``bshd`` / ``bshd_kv`` put heads on
    ``"model"`` (whole in the query-row fallback and where the KV heads
    are replicated); ``w_gate``/``w_up`` by columns and ``w_down`` by
    rows where ``d_ff`` divides (the storage's split); the MoE's experts
    where ``gecd`` puts them on ``"model"``; ``embed`` by vocabulary rows
    and ``lm_head`` by columns where ``logits_v`` is vocab parallel. The
    recurrent blocks, where the ranks divide the dimension (the storage's
    split, ``sharding._fallback``): the hybrid's ``rglru.w_in``,
    ``w_gate_in``, ``w_r``, ``w_i`` by columns, ``conv_k`` on dim 1,
    ``lam`` on dim 0 and ``w_out`` by rows, all by ``rnn_width``; the
    SSM's ``cm.wk`` by columns and ``cm.wv`` by rows (``d_ff``), ``cm.wr``
    by columns (``d_model``) where the ranks divide both (else the channel
    mix is whole); its ``tm.wr``/``wk``/``wv`` by columns and
    ``tm.wo`` by rows only where the ranks divide the *heads*
    (``bhsd``'s heads over ``"model"``): the storage splits them by
    ``d_model`` columns, which would cut a head the chunked recurrence
    needs whole, so with heads the ranks do not divide the time mix
    takes them whole and runs once (``bhsd`` replicated). The decay
    LoRA, the mixes, ``w_bias`` and ``u_bonus`` are whole. The one owner
    of these splits: the models' ``*_tp`` functions read them from the
    leaves' shapes, and the layouts hold them (``tp.Group``'s ``check``
    and ``placed``)."""
    ranks = group.size
    hq, hkv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    vocab = group.model_dim("logits_v", (rows, seq, cfg.vocab)) == 2
    experts = cfg.family == "moe" and group.model_dim(
        "gecd", (1, cfg.moe_experts, 8, d)) == 1
    ff = cfg.d_ff % ranks == 0
    width = (cfg.rnn_width or d) % ranks == 0
    wkv_heads = cfg.family == "ssm" and group.model_dim(
        "bhsd", (rows, d // cfg.rwkv_head_dim, seq, cfg.rwkv_head_dim)) == 1
    channels = ff and d % ranks == 0

    def lengths(name):                 # (query, key) lengths of attention
        if name.startswith("enc_layers."):
            return src_seq, src_seq
        if ".cross_attn." in name:
            return seq, src_seq
        return seq, seq

    out = {}
    for name in names:
        leaf = name.rsplit(".", 1)[-1]
        dim = None
        if name == "embed":
            dim = 0 if vocab else None
        elif name == "lm_head":
            dim = 1 if vocab else None
        elif leaf in ("wq", "wo", "wk", "wv") and "attn." in name:
            sq, skv = lengths(name)
            if leaf in ("wq", "wo"):
                heads = group.model_dim("bshd", (rows, sq, hq, dh)) == 2
                dim = (1 if leaf == "wq" else 0) if heads else None
            else:
                dim = 1 if group.model_dim(
                    "bshd_kv", (rows, skv, hkv, dh)) == 2 else None
        elif ".ffn." in name and leaf in ("w_gate", "w_up", "w_down"):
            if cfg.family == "moe":
                dim = 0 if experts else None
            elif ff:
                dim = 1 if leaf != "w_down" else 0
        elif ".rglru." in name and width:
            dim = {"w_in": 1, "w_gate_in": 1, "w_r": 1, "w_i": 1,
                   "conv_k": 1, "lam": 0, "w_out": 0}.get(leaf)
        elif ".tm." in name and wkv_heads:
            dim = {"wr": 1, "wk": 1, "wv": 1, "wo": 0}.get(leaf)
        elif ".cm." in name and channels:
            dim = {"wk": 1, "wv": 0, "wr": 1}.get(leaf)
        out[name] = dim
    return out
