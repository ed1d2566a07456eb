"""rwkv6-7b "Finch" — attention-free, data-dependent decay
[arXiv:2404.05892].

32L d_model=4096 d_ff=14336 vocab=65536; rwkv head_dim 64 (64 heads).
Sub-quadratic: O(1) decode state, runs long_500k.
"""

from ..models.common import ModelConfig
from .base import register, smoke_variant


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", family="ssm",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
        d_ff=14336, vocab=65536, rwkv_head_dim=64)


def smoke() -> ModelConfig:
    return smoke_variant(full())


register("rwkv6-7b", full, smoke)
