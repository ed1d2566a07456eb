"""Architecture configs of the port (the dense LM only, so far)."""

from . import llama3_2_3b  # noqa: F401 — registers the architecture
from .base import (SHAPE_BY_NAME, SHAPES, ShapeCell, get_config,  # noqa: F401
                   list_archs, register, smoke_variant)

ALL_ARCHS = list_archs()
