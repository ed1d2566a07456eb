"""Two-phase (double) sampling for stratification — paper eq. (5)/(6)
(the ported subset of ``repro.core.sampling.two_phase``).

    eq. (5)  v(ybar) = s^2 / n' + sum_h W_h^2 s_h^2 / n_h
    eq. (6)  v(ybar) = (1/n') sum_h W_h (ybar_h - ybar)^2
                       + sum_h W_h^2 s_h^2 / n_h

Eq. (6) needs only the stratum weights (shaped by phase 1) and the
phase-2 data. ``phase2_sizes_for_margin`` is the Table IV sizing.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence

import torch

from . import tables as _tables
from .types import (Estimate, StratumSummary, apply_coverage_contract,
                    critical_value)

__all__ = ["two_phase_estimate", "two_phase_estimate_tables",
           "phase2_sizes_for_margin"]


def two_phase_estimate_tables(t: _tables.StratumTables, phase1_n: int, *,
                              phase1_var: Optional[float] = None,
                              confidence: float = 0.95,
                              formula: str = "phase2_only",
                              strict: bool = False) -> Estimate:
    """Two-phase mean and CI from one-lane ``StratumTables``, under the
    coverage contract (see ``two_phase_estimate``)."""
    if phase1_n < 1:
        raise ValueError("phase-1 sample size must be >= 1")
    covered = float(_tables.covered_weight(t))
    total = float(_tables.total_weight(t))
    frac = apply_coverage_contract(
        covered, total, strict=strict,
        empty_msg="every stratum is empty; no units to estimate from",
        what="sampled strata")
    if frac <= 0.0:
        return Estimate(mean=float("nan"), variance=float("nan"), n=0,
                        df=None, confidence=confidence,
                        scheme=f"two_phase[{formula}]")
    mean = float(_tables.stratified_mean(t))
    degenerate = bool(((t.counts > 0) & (t.weights > 0)
                       & (t.counts < 2)).any())
    if degenerate:
        msg = ("within-stratum variance needs n_h >= 2 (paper fn.7); "
               "use collapsed strata for one-unit-per-stratum designs")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, UserWarning, stacklevel=3)
    var = float(_tables.two_phase_variance(
        t, phase1_n, formula=formula, phase1_var=phase1_var))
    n = int(t.counts.sum())
    df = float(_tables.satterthwaite_df(t))
    if df == float("inf") or df != df:
        df = None
    return Estimate(mean=mean, variance=var, n=n, df=df,
                    confidence=confidence, scheme=f"two_phase[{formula}]")


def two_phase_estimate(summaries: Sequence[StratumSummary], phase1_n: int,
                       *, phase1_var: Optional[float] = None,
                       confidence: float = 0.95,
                       formula: str = "phase2_only",
                       strict: bool = False) -> Estimate:
    """Two-phase mean and CI from phase-2 per-stratum summaries.

    ``formula="with_phase1_var"`` is eq. (5) and needs ``phase1_var``;
    ``"phase2_only"`` is eq. (6). Coverage contract: positive-weight
    strata with no unit warn and renormalise (``strict`` raises); covered
    strata with n_h < 2 warn and give a NaN variance (``strict`` raises).
    """
    return two_phase_estimate_tables(
        _tables.tables_from_summaries(summaries), phase1_n,
        phase1_var=phase1_var, confidence=confidence, formula=formula,
        strict=strict)


def phase2_sizes_for_margin(weights: Sequence[float],
                            within_stds: Sequence[float], phase1_n: int,
                            between_var: float, *, target_margin_abs: float,
                            confidence: float = 0.95,
                            allocation: str = "neyman",
                            min_per_stratum: int = 2,
                            max_total: int = 10**7) -> torch.Tensor:
    """Phase-2 per-stratum sizes whose eq. (6) margin meets a target (the
    paper's Table IV sizing policy).

    The phase-1 term ``between_var / phase1_n`` is fixed; the total
    phase-2 size is the least whose stratified term brings the combined
    margin under ``target_margin_abs`` (clipped to
    ``[2 L, max_total]``), then allocated across strata (``"neyman"`` or
    ``"proportional"``). Computed in float64, as the reference's numpy
    host sizing is; an unattainable margin raises ``ValueError``. Returns
    int64 ``(L,)`` on the weights' device.
    """
    w = torch.as_tensor(weights).to(torch.float64)
    s = torch.as_tensor(within_stds).to(w.device, torch.float64)
    z = critical_value(confidence, None)
    v_target = (target_margin_abs / z) ** 2
    v_phase1 = between_var / phase1_n
    v_budget = v_target - v_phase1
    if v_budget <= 0:
        raise ValueError(
            "target margin unattainable: phase-1 variance term alone "
            f"({v_phase1:.3e}) exceeds the variance budget ({v_target:.3e})")
    if allocation not in ("neyman", "proportional"):
        raise ValueError(f"unknown allocation {allocation!r}")
    numer = float((w * s).sum()) ** 2 if allocation == "neyman" \
        else float((w * s * s).sum())
    n_total = min(max(math.ceil(numer / v_budget), 2 * w.shape[-1]),
                  max_total)
    if allocation == "neyman":
        return _tables.neyman_allocation(w, s, n_total,
                                         min_per_stratum=min_per_stratum)
    return _tables.proportional_allocation(w, n_total,
                                           min_per_stratum=min_per_stratum)
