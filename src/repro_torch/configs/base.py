"""Architecture config registry and shape cells.

Counterpart of ``repro.configs.base``: one ``full()`` (the published
widths, bf16) and one ``smoke()`` (reduced, f32, CPU-runnable) config per
architecture. The port registers every architecture of the reference
(dense, MoE, hybrid, SSM and the enc-dec ``seamless-m4t-large-v2``).

    train_4k     seq 4096  global_batch 256   (train_step)
    prefill_32k  seq 32768 global_batch 32    (prefill forward)
    decode_32k   1 token, KV at 32768, batch 128  (serve_step)
    long_500k    1 token, state at 524288, batch 1  (sub-quadratic archs)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models.common import ModelConfig

__all__ = ["ShapeCell", "SHAPES", "SHAPE_BY_NAME", "register", "get_config",
           "list_archs", "cells_for", "smoke_variant"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}

_REGISTRY: dict[str, dict[str, Callable[[], ModelConfig]]] = {}


def register(arch_id: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[arch_id] = {"full": full, "smoke": smoke}


def get_config(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    from . import ALL_ARCHS  # noqa: F401 — registers on first use
    entry = _REGISTRY.get(arch_id)
    if entry is None:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return entry["smoke" if smoke else "full"]()


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def cells_for(cfg: ModelConfig) -> list[ShapeCell]:
    """Applicable shape cells (long_500k only for sub-quadratic archs)."""
    return [s for s in SHAPES
            if s.name != "long_500k" or cfg.sub_quadratic]


def smoke_variant(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Shrink a full config to a CPU-runnable smoke config of the same
    family, exactly as the reference shrinks it."""
    base = dict(
        n_layers=min(cfg.n_layers, 4) if cfg.family != "hybrid" else 6,
        d_model=256,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        d_ff=512,
        vocab=512,
        head_dim=64,
        dtype=torch.float32,
    )
    if cfg.moe_experts:
        base["moe_experts"] = 8
        base["moe_topk"] = min(cfg.moe_topk, 2)
    if cfg.window:
        base["window"] = 64
    if cfg.rnn_width:
        base["rnn_width"] = 256
    if cfg.encoder_layers:
        base["encoder_layers"] = 2
        base["n_layers"] = 2
    if cfg.family == "ssm":
        base["rwkv_head_dim"] = 32
        base["n_heads"] = 8
        base["n_kv_heads"] = 8
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
