"""command-r-35b — dense GQA, no biases [hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
"""

from ..models.common import ModelConfig
from .base import register, smoke_variant


def full() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", family="dense",
        n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22528, vocab=256000)


def smoke() -> ModelConfig:
    return smoke_variant(full())


register("command-r-35b", full, smoke)
