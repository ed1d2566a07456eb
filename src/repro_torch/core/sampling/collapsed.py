"""Collapsed-strata variance estimation (Appendix A, Section C).

Counterpart of ``repro.core.sampling.collapsed``. With one sampling unit
per stratum the within-stratum variance cannot be estimated directly;
the method of collapsed strata (Cochran 5A.12) pairs neighbouring strata
after ordering them by an auxiliary value (the paper orders by Config-0
stratum CPI) and uses paper eq. (4),

    s_h^2 = s_{h+1}^2 = (y_h - y_{h+1})^2 / 4,   n_h = n_{h+1} = 1,

with df = L - J for J groups. The scalar estimator is a one-lane view
over ``tables.collapsed_pairs_variance``, in float64.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import tables as _tables
from .types import Estimate, apply_coverage_contract

__all__ = ["collapsed_strata_estimate"]


def collapsed_strata_estimate(y_per_stratum: Sequence[float],
                              weights: Sequence[float], *,
                              order_by: Optional[Sequence[float]] = None,
                              confidence: float = 0.95,
                              strict: bool = False) -> Estimate:
    """CI for a one-unit-per-stratum design via pairwise collapsed strata.

    ``y_per_stratum[h]`` is stratum h's one sampled value, ``weights[h]``
    its W_h (summing to 1); ``order_by`` the per-stratum values that order
    the strata before neighbours pair up (default: the sampled values).
    An odd number of strata makes the last three one group. Missing
    values (NaN: an empty stratum) follow the coverage contract: dropped
    from the estimate and the pairing, the mean renormalised by the
    covered weight with a ``UserWarning`` (``strict=True`` raises).
    """
    y = torch.as_tensor(y_per_stratum).to("cpu", torch.float64).reshape(-1)
    w = torch.as_tensor(weights).to("cpu", torch.float64).reshape(-1)
    if y.shape != w.shape:
        raise ValueError("y and weights must align")
    n_strata = y.shape[0]
    if n_strata < 2:
        raise ValueError("need at least two strata to collapse")
    # numpy's isclose(sum, 1, atol=1e-6), as the reference checks it
    if not abs(float(w.sum()) - 1.0) <= 1e-6 + 1e-5:
        raise ValueError(f"weights sum to {float(w.sum())}, expected 1")
    key = y if order_by is None \
        else torch.as_tensor(order_by).to("cpu", torch.float64).reshape(-1)
    if key.shape[0] != n_strata:
        raise ValueError("order_by must have one value per stratum")

    valid = torch.isfinite(y)
    covered = float(w[valid].sum())
    frac = apply_coverage_contract(
        covered, float(w.sum()), strict=strict,
        empty_msg="every stratum value is missing; no units to "
                  "estimate from",
        what="strata with sampled values")
    if frac <= 0.0:
        return Estimate(mean=float("nan"), variance=float("nan"), n=0,
                        df=None, confidence=confidence,
                        scheme="collapsed_strata")
    v_cnt = int(valid.sum())
    if v_cnt < 2:
        raise ValueError("need at least two sampled strata to collapse")

    # valid strata first, in key order (the batched layout)
    order = torch.argsort(torch.where(valid, key,
                                      torch.full_like(key, float("inf"))),
                          stable=True)
    y_s, w_s = y[order], w[order]
    mean = float((w_s[:v_cnt] * y_s[:v_cnt]).sum())
    if v_cnt < n_strata:
        # renormalise the mean and, consistently, the pair terms
        mean /= covered
        w_s = w_s / covered
    var, df = _tables.collapsed_pairs_variance(
        y_s, w_s, torch.tensor(v_cnt), num_strata=n_strata)
    return Estimate(mean=mean, variance=float(var), n=v_cnt,
                    df=float(max(float(df), 1.0)), confidence=confidence,
                    scheme="collapsed_strata")
