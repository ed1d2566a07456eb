"""Two-phase (double) sampling for stratification — paper eq. (5)/(6)
(the ported subset of ``repro.core.sampling.two_phase``).

    eq. (5)  v(ybar) = s^2 / n' + sum_h W_h^2 s_h^2 / n_h
    eq. (6)  v(ybar) = (1/n') sum_h W_h (ybar_h - ybar)^2
                       + sum_h W_h^2 s_h^2 / n_h

Eq. (6) needs only the stratum weights (shaped by phase 1) and the
phase-2 data. The Table IV sizing (``phase2_sizes_for_margin``) waits for
the flow modules (ROADMAP.md).
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

from . import tables as _tables
from .types import Estimate, StratumSummary, apply_coverage_contract

__all__ = ["two_phase_estimate", "two_phase_estimate_tables"]


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
