"""Architecture configs of the port (one module per architecture)."""

from . import (chameleon_34b, command_r_35b, granite_8b,  # noqa: F401
               internlm2_20b, llama3_2_3b, olmoe_1b_7b,
               qwen3_moe_235b_a22b, recurrentgemma_2b, rwkv6_7b,
               seamless_m4t_large_v2)
from .base import (SHAPE_BY_NAME, SHAPES, ShapeCell, cells_for,  # noqa: F401
                   get_config, list_archs, register, smoke_variant)

ALL_ARCHS = list_archs()
