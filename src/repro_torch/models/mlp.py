"""Dense SwiGLU feed-forward block (counterpart of ``repro.models.mlp``)."""

from __future__ import annotations

import torch
from torch import nn

from .common import ModelConfig, new_param

__all__ = ["MLP", "mlp"]


class MLP(nn.Module):
    """``w_gate``, ``w_up`` ``(d, f)`` and ``w_down`` ``(f, d)``."""

    def __init__(self, cfg: ModelConfig, *, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = new_param((d, f), cfg.dtype, device)
        self.w_up = new_param((d, f), cfg.dtype, device)
        self.w_down = new_param((f, d), cfg.dtype, device)


def mlp(params: MLP, x: torch.Tensor) -> torch.Tensor:
    gate = torch.nn.functional.silu((x @ params.w_gate).float())
    up = (x @ params.w_up).float()
    return (gate * up).to(x.dtype) @ params.w_down
