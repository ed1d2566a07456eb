"""chameleon-34b — early-fusion VLM backbone [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536. The VQ image-token
frontend is a stub: image patches arrive as token ids in the shared vocab
(early fusion), so the backbone is a standard dense GQA decoder.
"""

from ..models.common import ModelConfig
from .base import register, smoke_variant


def full() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="dense",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22016, vocab=65536)


def smoke() -> ModelConfig:
    return smoke_variant(full())


register("chameleon-34b", full, smoke)
