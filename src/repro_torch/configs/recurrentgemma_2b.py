"""recurrentgemma-2b — RG-LRU + local attention, (R,R,A) [arXiv:2402.19427].

26L d_model=2560 10H (GQA kv=1, MQA) d_ff=7680 vocab=256000; local window
2048; rnn width 2560. Sub-quadratic: runs long_500k with a ring-buffer
local cache + O(1) recurrent state.
"""

from ..models.common import ModelConfig
from .base import register, smoke_variant


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
        d_ff=7680, vocab=256000, head_dim=256,
        window=2048, rnn_width=2560)


def smoke() -> ModelConfig:
    return smoke_variant(full(), n_heads=4, n_kv_heads=1, head_dim=64)


register("recurrentgemma-2b", full, smoke)
