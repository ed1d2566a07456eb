"""Stratified statistics over ``StratumTables`` (the ported subset).

Counterpart of part of ``repro.core.sampling.tables``: a
``StratumTables`` holds per-stratum sufficient statistics — counts,
shifted sums and sums of squares, and population weights — as
``(..., L)`` tensors with any leading batch axes, and the estimators map
them lane-wise. The sweep path needs the one-unit-per-stratum tables
(``sweep_point_tables``), the eq. (3) weighted mean
(``stratified_mean``) and the SRS moments (``masked_srs_stats``); the
two-phase CI of sampled evaluation needs the float64 host constructor
(``stratum_tables``), the scalar bridge (``tables_from_summaries``), the
eq. (3) variance, Satterthwaite's df and the eq. (5)/(6) two-phase
variance. Degenerate lanes give NaN, never an exception.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

__all__ = ["StratumTables", "stratum_tables", "tables_from_summaries",
           "sweep_point_tables", "covered_weight", "total_weight",
           "stratified_mean", "stratified_variance", "satterthwaite_df",
           "two_phase_variance", "masked_srs_stats"]


def _nan_like(t: torch.Tensor) -> torch.Tensor:
    return torch.full_like(t, float("nan"))


@dataclasses.dataclass(frozen=True)
class StratumTables:
    """Masked per-stratum sufficient statistics with leading batch axes.

    ``counts[..., h] == 0`` marks an empty stratum. ``sums``/``sumsqs``
    are moments of ``y - shift`` for a per-lane ``shift`` (0 = plain
    moments).
    """

    counts: torch.Tensor     # (..., L)
    sums: torch.Tensor       # (..., L)
    sumsqs: torch.Tensor     # (..., L)
    weights: torch.Tensor    # (..., L)
    shift: torch.Tensor | float = 0.0

    @property
    def num_strata(self) -> int:
        """L, the trailing stratum axis length."""
        return int(self.counts.shape[-1])

    @property
    def means(self) -> torch.Tensor:
        """(..., L) stratum sample means; NaN where n_h == 0."""
        safe = torch.clamp_min(self.counts, 1.0)
        shift = torch.as_tensor(self.shift, dtype=self.sums.dtype,
                                device=self.sums.device)
        mean = shift[..., None] + self.sums / safe
        return torch.where(self.counts > 0, mean, _nan_like(mean))

    @property
    def variances(self) -> torch.Tensor:
        """(..., L) within-stratum sample variances (ddof=1, eq. 2); NaN
        where n_h < 2. Shift-invariant."""
        safe = torch.clamp_min(self.counts, 1.0)
        mean = self.sums / safe
        ss = self.sumsqs - self.counts * mean * mean
        var = ss / torch.clamp_min(self.counts - 1.0, 1.0)
        return torch.where(self.counts > 1, var, _nan_like(var))


def stratum_tables(y, labels, *, weights=None,
                   num_strata: Optional[int] = None) -> StratumTables:
    """``StratumTables`` from samples + stratum labels, in float64 on the
    host (the reference's numpy path, ``backend="numpy"``).

    ``y`` ``(..., n)`` study values; ``labels`` aligned int stratum ids
    (negative = masked); ``weights`` ``(L,)`` or ``(..., L)`` population
    weights (default: the per-lane sample proportions), which must sum to
    1. Moments are centred on each lane's sample mean (shifted moments).
    """
    yv = torch.as_tensor(y).to("cpu", torch.float64)
    lab = torch.as_tensor(labels).to("cpu", torch.int64)
    if yv.shape != lab.shape:
        raise ValueError(f"y shape {tuple(yv.shape)} != labels shape "
                         f"{tuple(lab.shape)}")
    ok = lab >= 0
    if num_strata is not None:
        n_strata = int(num_strata)
    elif weights is not None:
        n_strata = int(torch.as_tensor(weights).shape[-1])
    else:
        n_strata = int(lab[ok].max()) + 1 if bool(ok.any()) else 0
    if bool(ok.any()) and int(lab[ok].max()) >= n_strata:
        raise ValueError(f"label {int(lab[ok].max())} out of range for "
                         f"num_strata={n_strata}")

    batch_shape = tuple(yv.shape[:-1])
    n = yv.shape[-1] if yv.dim() else 0
    b = 1
    for s in batch_shape:
        b *= s
    lab2, ok2, y2 = lab.reshape(b, n), ok.reshape(b, n), yv.reshape(b, n)
    zero = torch.zeros((), dtype=torch.float64)
    n_ok = torch.clamp_min(ok2.sum(dim=1), 1)
    shift = torch.where(ok2, y2, zero).sum(dim=1) / n_ok
    yz = torch.where(ok2, y2 - shift[:, None], zero)
    # flat segment ids: lane i owns [i L, (i + 1) L); invalid rows go to
    # one trailing slot that is dropped
    flat = torch.where(ok2, lab2 + n_strata * torch.arange(b)[:, None],
                       b * n_strata).reshape(-1)
    size = b * n_strata + 1

    def count(w=None):
        return torch.bincount(flat, weights=w, minlength=size)[:-1]             .to(torch.float64).reshape(*batch_shape, n_strata)

    counts = count()
    sums = count(yz.reshape(-1))
    sumsqs = count((yz * yz).reshape(-1))
    shift = shift.reshape(batch_shape)
    if weights is None:
        w = counts / torch.clamp_min(counts.sum(dim=-1, keepdim=True), 1.0)
    else:
        wa = torch.as_tensor(weights).to("cpu", torch.float64)
        if tuple(wa.shape[-1:]) != (n_strata,):
            raise ValueError(f"weights length {tuple(wa.shape)} != num "
                             f"strata {n_strata}")
        w = torch.broadcast_to(wa, counts.shape).clone()
        tot = w.sum(dim=-1)
        if not torch.allclose(tot, torch.ones_like(tot), rtol=0, atol=1e-6):
            raise ValueError(f"stratum weights sum to "
                             f"{tot.reshape(-1)[:8].tolist()}, expected 1")
    return StratumTables(counts=counts, sums=sums, sumsqs=sumsqs, weights=w,
                         shift=shift)


def tables_from_summaries(summaries: Sequence) -> StratumTables:
    """One-lane float64 tables from a ``list[StratumSummary]`` (the
    scalar bridge): sums and sums of squares centred on the mean of the
    occupied stratum means, ``sum = n (mean - c)`` and
    ``sumsq = (n - 1) s^2 + n (mean - c)^2``."""
    def col(values):
        return torch.tensor(values, dtype=torch.float64)

    counts = col([s.n for s in summaries])
    means = col([s.mean if s.n > 0 else 0.0 for s in summaries])
    variances = col([s.var if s.n > 1 and s.var == s.var
                     and abs(s.var) != float("inf") else 0.0
                     for s in summaries])
    weights = col([s.weight for s in summaries])
    occupied = counts > 0
    shift = float(means[occupied].mean()) if bool(occupied.any()) else 0.0
    centered = torch.where(occupied, means - shift,
                           torch.zeros_like(means))
    sums = counts * centered
    sumsqs = torch.clamp_min(counts - 1.0, 0.0) * variances \
        + counts * centered ** 2
    return StratumTables(counts=counts, sums=sums, sumsqs=sumsqs,
                         weights=weights, shift=shift)


def sweep_point_tables(cpi: torch.Tensor, valid: torch.Tensor,
                       weights: torch.Tensor) -> StratumTables:
    """Tables for a one-unit-per-stratum sweep: ``cpi (A, C, L)``,
    ``valid (A, L)``, ``weights (A, L)``; lanes are (app, config) and the
    counts are the pick mask itself."""
    counts = valid[:, None, :].expand(cpi.shape).to(cpi.dtype)
    return StratumTables(
        counts=counts,
        sums=torch.where(counts > 0, cpi, torch.zeros_like(cpi)),
        sumsqs=torch.zeros_like(cpi),
        weights=weights[:, None, :].expand(cpi.shape).to(cpi.dtype))


def covered_weight(tables: StratumTables) -> torch.Tensor:
    """(...) total weight of strata with at least one sampled unit."""
    return torch.where(tables.counts > 0, tables.weights,
                       torch.zeros_like(tables.weights)).sum(dim=-1)


def total_weight(tables: StratumTables) -> torch.Tensor:
    """(...) total stratum weight per lane (about 1 for normalised
    designs)."""
    return tables.weights.sum(dim=-1)


def stratified_mean(tables: StratumTables, *, renormalize: bool = True
                    ) -> torch.Tensor:
    """Eq. (3) ``sum_h W_h ybar_h`` lane-wise; divided by the covered
    weight under ``renormalize``; NaN for lanes with nothing covered."""
    term = torch.where(tables.counts > 0, tables.weights * tables.means,
                       torch.zeros_like(tables.weights))
    est = term.sum(dim=-1)
    cov = covered_weight(tables)
    if renormalize:
        est = est / torch.where(cov > 0, cov, torch.ones_like(cov))
    return torch.where(cov > 0, est, _nan_like(est))


def _covered_weights(tables: StratumTables) -> torch.Tensor:
    """The weights renormalised by the covered weight, 0 where empty."""
    cov = covered_weight(tables)[..., None]
    return torch.where(tables.counts > 0,
                       tables.weights / torch.where(cov > 0, cov,
                                                    torch.ones_like(cov)),
                       torch.zeros_like(tables.weights))


def stratified_variance(tables: StratumTables) -> torch.Tensor:
    """Eq. (3) variance ``sum_h W_h^2 s_h^2 / n_h`` lane-wise, the weights
    renormalised by the covered weight; NaN where a stratum with positive
    weight and sampled units has n_h < 2, or nothing is covered."""
    w = _covered_weights(tables)
    occupied = tables.counts > 0
    zero = torch.zeros_like(w)
    contrib = torch.where(
        occupied & (w > 0),
        w ** 2 * tables.variances / torch.clamp_min(tables.counts, 1.0),
        zero)
    v = contrib.sum(dim=-1)
    bad = (occupied & (tables.weights > 0) & (tables.counts < 2)).any(dim=-1)
    return torch.where(bad | (covered_weight(tables) <= 0), _nan_like(v), v)


def satterthwaite_df(tables: StratumTables) -> torch.Tensor:
    """Satterthwaite's effective degrees of freedom lane-wise; strata
    with n_h < 2 or no weight are left out; +inf (a z interval) where the
    denominator is 0."""
    usable = (tables.counts > 1) & (tables.weights > 0)
    zero = torch.zeros_like(tables.weights)
    g = torch.where(usable,
                    tables.weights ** 2
                    * torch.where(usable, tables.variances, zero)
                    / torch.clamp_min(tables.counts, 1.0), zero)
    num = g.sum(dim=-1)
    den = torch.where(usable,
                      g * g / torch.clamp_min(tables.counts - 1.0, 1.0),
                      zero).sum(dim=-1)
    safe = torch.where(den > 0, den, torch.ones_like(den))
    return torch.where(den > 0, num * num / safe,
                       torch.full_like(num, float("inf")))


def two_phase_variance(tables: StratumTables, phase1_n, *,
                       formula: str = "phase2_only", phase1_var=None
                       ) -> torch.Tensor:
    """Two-phase variance lane-wise: eq. (5) ``s^2 / n' + v_st``
    (``formula="with_phase1_var"``, needs ``phase1_var``) or eq. (6)
    ``(1 / n') sum_h W_h (mean_h - mean)^2 + v_st`` (``"phase2_only"``)."""
    v2 = stratified_variance(tables)
    if formula == "with_phase1_var":
        if phase1_var is None:
            raise ValueError("eq. (5) needs phase1_var")
        return torch.as_tensor(phase1_var, dtype=v2.dtype) / phase1_n + v2
    if formula != "phase2_only":
        raise ValueError(f"unknown formula {formula!r}")
    mean = stratified_mean(tables)
    w = _covered_weights(tables)
    dev = tables.means - mean[..., None]
    between = torch.where(tables.counts > 0, w * dev * dev,
                          torch.zeros_like(w)).sum(dim=-1)
    return between / phase1_n + v2


def masked_srs_stats(x: torch.Tensor, valid: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lane-wise SRS mean and variance of the mean (eq. 2, ddof=1).

    ``x (..., n)``; ``valid`` broadcastable to it. Returns ``(mean,
    v_mean, n)``; n < 2 gives NaN variance, n = 0 a NaN mean.
    """
    v = torch.broadcast_to(valid.bool(), x.shape)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    n = v.sum(dim=-1).to(x.dtype)
    safe_n = torch.clamp_min(n, 1.0)
    mean = torch.where(v, x, zero).sum(dim=-1) / safe_n
    ss = torch.where(v, (x - mean[..., None]) ** 2, zero).sum(dim=-1)
    s2 = torch.where(n > 1, ss / torch.clamp_min(n - 1.0, 1.0),
                     _nan_like(ss))
    mean = torch.where(n > 0, mean, _nan_like(mean))
    return mean, s2 / safe_n, n
