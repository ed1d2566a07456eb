"""Int8 gradient compression with error feedback (counterpart of
``repro.optim.grad_compress``).

Each gradient, plus the residual carried from the previous step, is
quantized to int8 with a per-tensor absmax scale and dequantized again;
the quantization error is kept in float32 and added back next step
(EF-SGD), which keeps Adam's convergence. On one device there is no
reduction to shrink, so this models the production path as quantize ->
dequantize around the gradient's use, as the reference does.
"""

from __future__ import annotations

import dataclasses

import torch

from .adamw import GradTransform

__all__ = ["Int8EF"]


@dataclasses.dataclass(frozen=True)
class Int8EF(GradTransform):
    """Per-tensor absmax int8 quantization with error feedback."""

    def apply(self, grads: dict, ef: dict) -> tuple[dict, dict]:
        new_grads, new_ef = {}, {}
        for name, g in grads.items():
            g32 = g.float() + ef[name]
            scale = torch.clamp_min(g32.abs().max(), 1e-12) / 127.0
            # round half to even, as jnp.round
            q = torch.clamp(torch.round(g32 / scale), -127, 127
                            ).to(torch.int8)
            deq = q.float() * scale
            new_grads[name] = deq.to(g.dtype)
            new_ef[name] = g32 - deq
        return new_grads, new_ef

    # roofline accounting: bytes multiplier vs bf16 gradients
    BYTES_FACTOR = 0.5
