"""Int8 gradient compression with error feedback (counterpart of
``repro.optim.grad_compress``).

Each gradient, plus the residual carried from the previous step, is
quantized to int8 with a per-tensor absmax scale and dequantized again;
the quantization error is kept in float32 and added back next step
(EF-SGD), which keeps Adam's convergence. On one device there is no
reduction to shrink, so this models the production path as quantize ->
dequantize around the gradient's use, as the reference does. On a
mesh (``apply_shards``) the absmax is the whole leaf's, the largest over
its pieces, and each piece is quantized with it: bit for bit the whole
leaf's result.
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

    def apply_shards(self, grads: dict, ef: dict) -> tuple[dict, dict]:
        """``apply`` on ``Sharded`` leaves (``distributed.spmd``), the
        error feedback in the gradients' layouts; the scale is the whole
        leaf's."""
        from ..distributed.spmd import Sharded, leaf_abs_max
        new_grads, new_ef = {}, {}
        for name, g in grads.items():
            g32 = Sharded(g.layout, torch.float32, {
                dev: st.float() + ef[name].stacks[dev]
                for dev, st in g.stacks.items()})
            absmax = leaf_abs_max(g32)
            gs, es = {}, {}
            for dev, x in g32.stacks.items():
                scale = torch.clamp_min(absmax.to(dev), 1e-12) / 127.0
                q = torch.clamp(torch.round(x / scale), -127, 127
                                ).to(torch.int8)
                deq = q.float() * scale
                gs[dev] = deq.to(g.dtype)
                es[dev] = x - deq
            new_grads[name] = Sharded(g.layout, g.dtype, gs)
            new_ef[name] = Sharded(g.layout, torch.float32, es)
        return new_grads, new_ef

    # roofline accounting: bytes multiplier vs bf16 gradients
    BYTES_FACTOR = 0.5
