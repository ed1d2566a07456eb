"""Optimizer, gradient compression and learning-rate schedules
(counterpart of ``repro.optim``)."""

from .adamw import AdamW, AdamWState, apply_updates  # noqa: F401
from .grad_compress import Int8EF  # noqa: F401
from .schedule import cosine_with_warmup  # noqa: F401
