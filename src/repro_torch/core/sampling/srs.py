"""Simple random sampling (Appendix A, Section A; Cochran Ch. 2).

Estimators (paper eq. 2):
    ybar = (1/n) sum y_i
    s^2  = (1/(n-1)) sum (y_i - ybar)^2
    v(ybar) = s^2 / n           [without-replacement fpc optional]

For n < 30 the t-distribution with df = n-1 is used for the interval.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .types import Estimate, as_float_array

__all__ = [
    "srs_estimate",
    "srs_required_n",
    "draw_srs",
]



def srs_estimate(
    y,
    *,
    confidence: float = 0.95,
    population_size: Optional[int] = None,
    use_fpc: bool = False,
) -> Estimate:
    """Estimate the population mean from a simple random sample ``y``.

    ``use_fpc`` applies the finite-population correction (1 - n/N); the paper
    samples a negligible fraction of each application's regions so its
    formulas omit it, and we default to matching the paper.
    """
    arr = as_float_array(y)
    n = int(arr.size)
    if n < 1:
        raise ValueError("need at least one observation")
    mean = float(arr.mean())
    if n == 1:
        var_units = float("nan")
        v_mean = float("inf")
    else:
        var_units = float(arr.var(ddof=1))
        v_mean = var_units / n
        if use_fpc and population_size is not None and population_size > 0:
            v_mean *= max(0.0, 1.0 - n / population_size)
    df = float(n - 1) if n < 30 else None
    return Estimate(
        mean=mean, variance=v_mean, n=n, df=df,
        confidence=confidence, scheme="srs",
    )


def srs_required_n(
    pilot_y,
    *,
    target_margin_pct: float,
    confidence: float = 0.95,
    max_n: int = 10**9,
) -> int:
    """Sample size needed for a target relative margin of error.

    Uses the pilot sample's variance (the paper's Step 1 note: "start small,
    estimate variance, then scale to meet a target confidence").
    """
    from .types import critical_value

    arr = as_float_array(pilot_y)
    if arr.size < 2:
        raise ValueError("pilot needs >= 2 observations")
    s2 = float(arr.var(ddof=1))
    mean = float(arr.mean())
    if mean == 0.0:
        raise ValueError("pilot mean is zero; relative margin undefined")
    z = critical_value(confidence, None)
    target_abs = abs(mean) * target_margin_pct / 100.0
    n = int(np.ceil(z * z * s2 / (target_abs * target_abs)))
    return int(min(max(n, 2), max_n))


def draw_srs(rng: np.random.Generator, population_size: int, n: int) -> np.ndarray:
    """Indices of a without-replacement simple random sample."""
    if n > population_size:
        raise ValueError(f"sample size {n} exceeds population {population_size}")
    return rng.choice(population_size, size=n, replace=False)
