"""seamless-m4t-large-v2 — enc-dec multimodal backbone [arXiv:2308.11596].

24L (x2 stacks) d_model=1024 16H (MHA) d_ff=8192 vocab=256206, as the
reference configures it. The speech frontend is a stub: the encoder takes
precomputed frame embeddings (b, s_src, d_model).
"""

from ..models.common import ModelConfig
from .base import register, smoke_variant


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="encdec",
        n_layers=24, encoder_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=16, d_ff=8192, vocab=256206, head_dim=64,
        embed_frontend=True)


def smoke() -> ModelConfig:
    return smoke_variant(full(), head_dim=64, n_heads=4, n_kv_heads=4)


register("seamless-m4t-large-v2", full, smoke)
