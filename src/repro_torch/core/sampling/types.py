"""Common result types for the sampling estimators.

Terminology follows Cochran, *Sampling Techniques* (3rd ed.) and the paper's
Appendix A: the *population* is the set of all simulation regions of one
application, a *sampling unit* is one region, ``y`` is the study variable
(CPI under the configuration being estimated) and ``x`` is an auxiliary
variable known (or measured in phase 1) for stratification.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import numpy as np
from scipy import stats as _scipy_stats

__all__ = [
    "Estimate",
    "StratumSummary",
    "critical_value",
    "critical_values",
    "apply_coverage_contract",
    "as_float_array",
]



def critical_value(confidence: float, df: Optional[float]) -> float:
    """z- or t- critical value for a two-sided interval.

    ``df=None`` (or very large) selects the normal approximation; otherwise
    Student's t with ``df`` degrees of freedom (Appendix A: t for small n,
    Satterthwaite / rule-of-thumb dfs for stratified designs).
    """
    alpha = 1.0 - confidence
    if df is None or df >= 1e6:
        return float(_scipy_stats.norm.ppf(1.0 - alpha / 2.0))
    df = max(float(df), 1.0)
    return float(_scipy_stats.t.ppf(1.0 - alpha / 2.0, df))


def critical_values(confidence: float, dfs) -> np.ndarray:
    """Vectorized ``critical_value``: z-/t- critical values for an array
    of degrees of freedom (host-side scipy — not jit-able).

    ``inf``, NaN or very large (≥ 1e6) entries select the normal
    approximation; finite entries are clamped to ≥ 1 (matching the scalar
    rule). The batched estimator paths compute per-lane dfs on device and
    look critical values up here once per program, outside ``jit``.
    """
    alpha = 1.0 - confidence
    d = np.asarray(dfs, np.float64)
    z = float(_scipy_stats.norm.ppf(1.0 - alpha / 2.0))
    use_z = ~np.isfinite(d) | (d >= 1e6)
    out = np.where(
        use_z, z,
        _scipy_stats.t.ppf(1.0 - alpha / 2.0,
                           np.maximum(np.where(use_z, 1.0, d), 1.0)))
    return out


def apply_coverage_contract(covered: float, total: float, *,
                            strict: bool = False,
                            empty_action: str = "nan",
                            empty_msg: str = "no strata have sampled units",
                            what: str = "selected units",
                            stacklevel: int = 3) -> float:
    """The package-wide NaN/warn/raise coverage contract (docs/statistics.md).

    ``covered``/``total``: stratum weight with / without sampled units.
    Returns the covered fraction for renormalization (0.0 when nothing is
    covered — callers then produce NaN results). Nothing covered raises
    ``ValueError(empty_msg)`` when ``empty_action="raise"`` or
    ``strict=True``, else warns. Partial coverage warns by default
    (renormalizing silently biases the estimate toward the covered
    strata) and raises under ``strict=True``. Full coverage is silent.
    """
    if covered <= 0.0 or total <= 0.0:
        if strict or empty_action == "raise":
            raise ValueError(empty_msg)
        warnings.warn(empty_msg, UserWarning, stacklevel=stacklevel)
        return 0.0
    frac = covered / total
    if frac < 1.0 - 1e-6:
        msg = (f"{what} cover only {frac:.4f} of the stratum weight; "
               "renormalizing biases the estimate toward the covered strata")
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, UserWarning, stacklevel=stacklevel)
    return frac


@dataclasses.dataclass(frozen=True)
class Estimate:
    """A point estimate with its sampling variance and a confidence interval.

    ``margin`` is the *absolute* half-width ``crit * sqrt(variance)``;
    ``margin_pct`` the relative margin of error in percent (the quantity the
    paper plots in Figs 7-9).
    """

    mean: float
    variance: float            # v(ybar): variance of the *sample mean*
    n: int                     # total sampled units
    df: Optional[float]        # degrees of freedom used (None => z)
    confidence: float = 0.95
    scheme: str = "srs"

    @property
    def std_error(self) -> float:
        return math.sqrt(max(self.variance, 0.0))

    @property
    def margin(self) -> float:
        return critical_value(self.confidence, self.df) * self.std_error

    @property
    def margin_pct(self) -> float:
        if self.mean == 0.0:
            return float("inf")
        return 100.0 * self.margin / abs(self.mean)

    @property
    def interval(self) -> tuple[float, float]:
        return (self.mean - self.margin, self.mean + self.margin)

    def covers(self, true_value: float) -> bool:
        lo, hi = self.interval
        return lo <= true_value <= hi

    def error_pct(self, true_value: float) -> float:
        """Relative estimation error vs a known reference (paper Fig 10/11)."""
        if true_value == 0.0:
            return float("inf")
        return 100.0 * abs(self.mean - true_value) / abs(true_value)


@dataclasses.dataclass(frozen=True)
class StratumSummary:
    """Per-stratum sample statistics (h indexes strata)."""

    weight: float              # W_h = N_h / N
    n: int                     # n_h sampled units
    mean: float                # ybar_h
    var: float                 # s_h^2 (within-stratum sample variance)

    def __post_init__(self):
        if self.weight < 0:
            raise ValueError(f"negative stratum weight {self.weight}")
        if self.n < 0:
            raise ValueError(f"negative stratum sample size {self.n}")


def as_float_array(values) -> np.ndarray:
    arr = np.asarray(values, dtype=np.float64)
    if arr.ndim != 1:
        arr = arr.reshape(-1)
    return arr
