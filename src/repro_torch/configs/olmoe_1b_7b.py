"""olmoe-1b-7b — 64-expert top-8 MoE [arXiv:2409.02060].

16L d_model=2048 16H (GQA kv=16 = MHA) d_ff=1024 vocab=50304.
"""

from ..models.common import ModelConfig
from .base import register, smoke_variant


def full() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab=50304, moe_experts=64, moe_topk=8)


def smoke() -> ModelConfig:
    return smoke_variant(full())


register("olmoe-1b-7b", full, smoke)
