"""granite-8b — llama-arch code model [arXiv:2405.04324].

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""

from ..models.common import ModelConfig
from .base import register, smoke_variant


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=49152)


def smoke() -> ModelConfig:
    return smoke_variant(full())


register("granite-8b", full, smoke)
