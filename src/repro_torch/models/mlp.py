"""Dense SwiGLU feed-forward block (counterpart of ``repro.models.mlp``).

``mlp_tp`` is the tensor-parallel step's: where ``tp_module_on`` splits
``d_ff`` over the model ranks (the storage's ``"model"`` split), the
input gathered whole on every rank, column-parallel ``w_gate``/``w_up``,
row-parallel ``w_down`` and a reduce-scatter (or all-reduce) of the
ranks' partial sums; with whole weights, each rank on its own rows of
the residual (or once, replicated).
"""

from __future__ import annotations

import torch
from torch import nn

from ..distributed.tp import ranked_matmul
from .common import ModelConfig, new_param

__all__ = ["MLP", "mlp", "mlp_tp"]


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


def mlp_tp(params: MLP, x: torch.Tensor, group, shape) -> torch.Tensor:
    """``mlp`` of the residual ``x`` (whole shape ``shape``) on a data
    rank's model positions (``group``, a ``distributed.tp.Group``), in
    the residual's layout."""
    if params.w_gate.dim() == 2:
        return mlp(params, x)
    full, _ = group.whole(x, shape)
    gate = torch.nn.functional.silu(ranked_matmul(full,
                                                  params.w_gate).float())
    up = ranked_matmul(full, params.w_up).float()
    y = ranked_matmul((gate * up).to(x.dtype), params.w_down)
    return group.from_partials(y, shape)
