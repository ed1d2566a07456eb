"""Stratified random sampling (Appendix A, Section B; Cochran Ch. 5).

Counterpart of ``repro.core.sampling.stratified``. Estimators (paper
eq. 3):

    ybar    = sum_h W_h ybar_h
    v(ybar) = sum_h W_h^2 s_h^2 / n_h

with z, Satterthwaite or n - L degrees of freedom. These scalar functions
are one-lane views over the batched ``tables`` estimators, in float64 on
the host; unlike the batched functions, which give NaN lane-wise, they
raise on degenerate strata.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from . import tables as _tables
from .types import Estimate, StratumSummary, as_float_array

__all__ = ["StratumSummary", "summarize_strata", "stratified_mean",
           "stratified_variance", "satterthwaite_df", "stratified_estimate",
           "stratified_estimate_from_samples"]


def summarize_strata(y, strata, *,
                     weights: Optional[Sequence[float]] = None,
                     num_strata: Optional[int] = None
                     ) -> list[StratumSummary]:
    """Per-stratum summaries from sampled values and stratum labels.

    ``weights`` are population weights W_h (summing to about 1); when
    omitted, the sample proportions. L comes from ``num_strata``, else
    ``len(weights)``, else the observed labels. Strata with no sampled
    unit get n = 0 (mean and variance NaN); a single unit gives a NaN
    variance.
    """
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu().numpy()
    yv = torch.from_numpy(as_float_array(y))
    sv = torch.as_tensor(strata).reshape(-1)
    if yv.shape[0] != sv.shape[0]:
        raise ValueError("y and strata must align")
    t = _tables.stratum_tables(yv, sv, weights=weights,
                               num_strata=num_strata)
    means, variances = t.means, t.variances
    out = []
    for h in range(t.num_strata):
        n_h = int(t.counts[h])
        out.append(StratumSummary(
            weight=float(t.weights[h]), n=n_h,
            mean=float(means[h]) if n_h > 0 else float("nan"),
            var=float(variances[h]) if n_h > 1 else float("nan")))
    return out


def stratified_mean(summaries: Sequence[StratumSummary]) -> float:
    """ybar_st = sum_h W_h ybar_h; a stratum with weight and no sampled
    unit is an error."""
    for s in summaries:
        if s.n == 0 and s.weight > 0:
            raise ValueError("stratum with positive weight has no sampled "
                             "units")
    t = _tables.tables_from_summaries(summaries)
    return float(_tables.stratified_mean(t, renormalize=False))


def stratified_variance(summaries: Sequence[StratumSummary]) -> float:
    """v(ybar_st) = sum_h W_h^2 s_h^2 / n_h; needs n_h >= 2 in every
    stratum with weight."""
    for s in summaries:
        if s.weight == 0.0:
            continue
        if s.n < 2 or not math.isfinite(s.var):
            raise ValueError(
                "within-stratum variance needs n_h >= 2 (paper fn.7); "
                "use collapsed strata for one-unit-per-stratum designs")
    t = _tables.tables_from_summaries(summaries)
    return float(_tables.stratified_variance(t, renormalize=False))


def satterthwaite_df(summaries: Sequence[StratumSummary]) -> float:
    """Satterthwaite's effective degrees of freedom for ybar_st."""
    return float(_tables.satterthwaite_df(
        _tables.tables_from_summaries(summaries)))


def stratified_estimate(summaries: Sequence[StratumSummary], *,
                        confidence: float = 0.95,
                        df_method: str = "satterthwaite") -> Estimate:
    """Mean and CI from per-stratum summaries (paper eq. 3);
    ``df_method``: ``"satterthwaite"``, ``"n_minus_L"`` or ``"z"``."""
    mean = stratified_mean(summaries)
    var = stratified_variance(summaries)
    n = sum(s.n for s in summaries)
    n_strata = sum(1 for s in summaries if s.weight > 0)
    if df_method == "z":
        df = None
    elif df_method == "n_minus_L":
        df = float(max(n - n_strata, 1))
    elif df_method == "satterthwaite":
        df = satterthwaite_df(summaries)
        if not math.isfinite(df):
            df = None
    else:
        raise ValueError(f"unknown df_method {df_method!r}")
    return Estimate(mean=mean, variance=var, n=n, df=df,
                    confidence=confidence, scheme="stratified")


def stratified_estimate_from_samples(y, strata, *,
                                     weights: Optional[Sequence[float]] = None,
                                     num_strata: Optional[int] = None,
                                     confidence: float = 0.95,
                                     df_method: str = "satterthwaite"
                                     ) -> Estimate:
    """``summarize_strata`` then ``stratified_estimate``."""
    return stratified_estimate(
        summarize_strata(y, strata, weights=weights, num_strata=num_strata),
        confidence=confidence, df_method=df_method)
