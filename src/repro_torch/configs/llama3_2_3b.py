"""llama3.2-3b — small llama3, as the reference configures it.

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256, untied
embeddings. The reference's docstring cites Llama-3.2-1B, but the numbers
are the 3B's; the published 3B ties its embeddings and this config does
not. The port copies the config as it stands, since it is held against
the reference (ROADMAP.md, reference caveats).
"""

from ..models.common import ModelConfig
from .base import register, smoke_variant


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b", family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=128256)


def smoke() -> ModelConfig:
    return smoke_variant(full())


register("llama3.2-3b", full, smoke)
