"""Sample allocation across strata (Cochran Ch. 5.5-5.9).

Counterpart of ``repro.core.sampling.allocation``: given a target
precision, how many phase-2 units each stratum needs under proportional
or Neyman allocation (the Table IV experiment). The allocations are
one-lane views over the batched ``tables`` functions, in float64.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from . import tables as _tables
from .types import critical_value

__all__ = ["proportional_allocation", "neyman_allocation",
           "required_total_neyman", "required_total_proportional"]


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float64)


def proportional_allocation(weights: Sequence[float], n_total: int
                            ) -> torch.Tensor:
    """n_h proportional to W_h, each stratum >= 2 (so s_h^2 can be
    estimated); largest-remainder rounding, overshoot accepted."""
    return _tables.proportional_allocation(_f64(weights), int(n_total))


def neyman_allocation(weights: Sequence[float], stds: Sequence[float],
                      n_total: int, *, min_per_stratum: int = 2
                      ) -> torch.Tensor:
    """n_h proportional to W_h S_h (optimal for a fixed total); all-zero
    products fall back to proportional allocation."""
    return _tables.neyman_allocation(_f64(weights), _f64(stds), int(n_total),
                                     min_per_stratum=min_per_stratum)


def _required(numer: float, target_margin_abs: float,
              confidence: float) -> int:
    if target_margin_abs <= 0:
        raise ValueError("target margin must be positive")
    z = critical_value(confidence, None)
    return max(int(math.ceil(z * z * numer / target_margin_abs ** 2)), 2)


def required_total_neyman(weights: Sequence[float], stds: Sequence[float],
                          *, target_margin_abs: float,
                          confidence: float = 0.95) -> int:
    """Total phase-2 n under Neyman allocation for an absolute margin:
    n = z^2 (sum W_h S_h)^2 / margin^2 (no fpc)."""
    numer = float((_f64(weights) * _f64(stds)).sum()) ** 2
    return _required(numer, target_margin_abs, confidence)


def required_total_proportional(weights: Sequence[float],
                                stds: Sequence[float], *,
                                target_margin_abs: float,
                                confidence: float = 0.95) -> int:
    """Total phase-2 n under proportional allocation:
    n = z^2 sum(W_h S_h^2) / margin^2."""
    s = _f64(stds)
    numer = float((_f64(weights) * s * s).sum())
    return _required(numer, target_margin_abs, confidence)
