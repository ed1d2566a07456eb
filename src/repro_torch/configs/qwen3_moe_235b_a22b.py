"""qwen3-moe-235b-a22b — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B].

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per expert) vocab=151936.
"""

from ..models.common import ModelConfig
from .base import register, smoke_variant


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
        d_ff=1536, vocab=151936, moe_experts=128, moe_topk=8)


def smoke() -> ModelConfig:
    return smoke_variant(full())


register("qwen3-moe-235b-a22b", full, smoke)
