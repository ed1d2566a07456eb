"""Stratified statistics over ``StratumTables`` (the slice's subset).

Counterpart of part of ``repro.core.sampling.tables``: a
``StratumTables`` holds per-stratum sufficient statistics — counts,
shifted sums and sums of squares, and population weights — as
``(..., L)`` tensors with any leading batch axes, and the estimators map
them lane-wise. The sweep path needs the one-unit-per-stratum tables
(``sweep_point_tables``), the eq. (3) weighted mean
(``stratified_mean``) and the SRS moments (``masked_srs_stats``).
Degenerate lanes give NaN, never an exception.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["StratumTables", "sweep_point_tables", "covered_weight",
           "stratified_mean", "masked_srs_stats"]


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
    def means(self) -> torch.Tensor:
        """(..., L) stratum sample means; NaN where n_h == 0."""
        safe = torch.clamp_min(self.counts, 1.0)
        shift = torch.as_tensor(self.shift, dtype=self.sums.dtype,
                                device=self.sums.device)
        mean = shift[..., None] + self.sums / safe
        return torch.where(self.counts > 0, mean, _nan_like(mean))


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
