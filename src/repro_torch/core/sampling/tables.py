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
variance. The Monte-Carlo trials need the eq. (4) collapsed-pairs
variance (``collapsed_pairs_variance``) and the streaming accumulator
``TrialStats`` with its log-histogram quantile sketches. The two-phase
flow needs the fn. 7 small-stratum merge (``collapse_small_strata``) and
the Cochran 5.5-5.9 allocations (``proportional_allocation``,
``neyman_allocation``). Degenerate lanes give NaN, never an exception.

``stratum_tables`` has two routes: ``backend="numpy"`` (the default) is
the float64 host constructor, the reference's exact path; ``"auto"`` /
``"plain"`` build the tables where the samples lie through the
``segment_stats`` kernel contract (on a CUDA tensor under ``"auto"``, the
kernel) in the policy's trace dtype, with the reference's shifted
moments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["StratumTables", "stratum_tables", "tables_from_summaries",
           "sweep_point_tables", "covered_weight", "total_weight",
           "stratified_mean", "stratified_variance", "satterthwaite_df",
           "two_phase_variance", "masked_srs_stats",
           "collapse_small_strata", "proportional_allocation",
           "neyman_allocation",
           "collapsed_pairs_variance", "fixed_sum", "TRIAL_HIST_BINS",
           "TRIAL_HIST_LO", "TRIAL_HIST_HI", "TrialStats",
           "trial_stats_init", "trial_stats_update", "trial_stats_merge",
           "fold_block_moments", "TRIAL_MOMENTS",
           "log_hist_quantile"]


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
        # a float shift stays a Python scalar: no host-to-device copy, so
        # the estimate can be captured into a CUDA graph
        shift = self.shift.to(self.sums.dtype)[..., None] \
            if isinstance(self.shift, torch.Tensor) else float(self.shift)
        mean = shift + self.sums / safe
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
                   num_strata: Optional[int] = None,
                   backend: str = "numpy") -> StratumTables:
    """``StratumTables`` from samples + stratum labels, batched.

    ``y`` ``(..., n)`` study values; ``labels`` aligned int stratum ids
    (negative = masked); ``weights`` ``(L,)`` or ``(..., L)`` population
    weights (default: the per-lane sample proportions). Moments are
    centred on each lane's sample mean (shifted moments).

    ``backend="numpy"`` is the float64 host path (a CUDA input is read
    back to the host): it checks the label range and that the weights
    sum to 1. ``"auto"`` / ``"plain"`` compute in float32 where ``y``
    lies, through ``segment_stats``, and need ``num_strata`` or
    ``weights``; a CUDA input stays on the card.
    """
    if backend != "numpy":
        return _stratum_tables_device(y, labels, weights=weights,
                                      num_strata=num_strata,
                                      backend=backend)
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


def _stratum_tables_device(y, labels, *, weights, num_strata,
                           backend: str) -> StratumTables:
    """The ``segment_stats`` route of ``stratum_tables`` (reference
    ``tables.py:196-224``, its default float32 policy): everything stays
    on ``y``'s device."""
    from ...kernels.segment_stats.ops import segment_stats
    from ..ordered import tree_sum

    dt = torch.float32
    y = torch.as_tensor(y).to(dt)
    lab = torch.as_tensor(labels).to(y.device, torch.int32)
    if num_strata is None:
        if weights is None:
            raise ValueError("device backends need num_strata (or weights)")
        num_strata = torch.as_tensor(weights).shape[-1]
    n_strata = int(num_strata)
    ok = (lab >= 0) & (lab < n_strata)
    zero = torch.zeros((), dtype=dt, device=y.device)
    n_ok = torch.clamp_min(ok.sum(dim=-1), 1).to(dt)
    shift = tree_sum(torch.where(ok, y, zero)) / n_ok
    sums, sumsqs, counts = segment_stats(y - shift[..., None], lab,
                                         n_strata, backend=backend)
    sums, sumsqs = sums[..., 0].to(dt), sumsqs[..., 0].to(dt)
    counts = counts.to(dt)
    if weights is None:
        w = counts / torch.clamp_min(counts.sum(dim=-1, keepdim=True), 1.0)
    else:
        w = torch.broadcast_to(torch.as_tensor(weights).to(y.device, dt),
                               counts.shape)
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


def stratified_variance(tables: StratumTables, *, renormalize: bool = True
                        ) -> torch.Tensor:
    """Eq. (3) variance ``sum_h W_h^2 s_h^2 / n_h`` lane-wise, the weights
    renormalised by the covered weight under ``renormalize``; NaN where a
    stratum with positive weight and sampled units has n_h < 2, or
    nothing is covered."""
    w = _covered_weights(tables) if renormalize else tables.weights
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
                       formula: str = "phase2_only", phase1_var=None,
                       renormalize: bool = True) -> torch.Tensor:
    """Two-phase variance lane-wise: eq. (5) ``s^2 / n' + v_st``
    (``formula="with_phase1_var"``, needs ``phase1_var``) or eq. (6)
    ``(1 / n') sum_h W_h (mean_h - mean)^2 + v_st`` (``"phase2_only"``)."""
    v2 = stratified_variance(tables, renormalize=renormalize)
    if formula == "with_phase1_var":
        if phase1_var is None:
            raise ValueError("eq. (5) needs phase1_var")
        return torch.as_tensor(phase1_var, dtype=v2.dtype) / phase1_n + v2
    if formula != "phase2_only":
        raise ValueError(f"unknown formula {formula!r}")
    mean = stratified_mean(tables, renormalize=renormalize)
    w = _covered_weights(tables) if renormalize else tables.weights
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


# ------------------------------------------------ collapse (fn. 7, eq. 4)
def collapsed_pairs_variance(y_sorted: torch.Tensor, w_sorted: torch.Tensor,
                             n_valid: torch.Tensor, *, num_strata: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched pairwise collapsed-strata variance (paper eq. 4), lane-wise.

    ``y_sorted (..., L)``: the one sampled value per stratum in key order,
    the ``n_valid`` occupied strata first (later positions are ignored);
    ``w_sorted``: the weights in the same order; ``n_valid (...)``: the
    occupied-stratum count V (both broadcastable). Neighbours pair up; an
    odd V makes the last three strata one group whose variance is their
    sample variance; a pair gives ``s^2 = (y1 - y2)^2 / 4`` with n_h = 1.
    Returns ``(variance, df)``, both NaN where V < 2; ``df = V - V // 2``.
    """
    L = int(num_strata)
    v_cnt = torch.as_tensor(n_valid)
    n_groups = v_cnt // 2
    odd = (v_cnt % 2) == 1
    shape = torch.broadcast_shapes(y_sorted.shape[:-1], w_sorted.shape[:-1],
                                   v_cnt.shape)
    var = torch.zeros(shape, dtype=y_sorted.dtype, device=y_sorted.device)
    for j in range(max(L // 2, 1)):
        p1, p2, p3 = 2 * j, 2 * j + 1, min(2 * j + 2, L - 1)
        if p2 >= L:
            break
        in_grp = j < n_groups
        has3 = odd & (n_groups - 1 == j)
        y1, y2, y3 = (y_sorted[..., p] for p in (p1, p2, p3))
        w1, w2, w3 = (w_sorted[..., p] for p in (p1, p2, p3))
        s2_pair = (y1 - y2) ** 2 / 4.0
        m3 = (y1 + y2 + y3) / 3.0
        s2_tri = ((y1 - m3) ** 2 + (y2 - m3) ** 2 + (y3 - m3) ** 2) / 2.0
        s2 = torch.where(has3, s2_tri, s2_pair)
        wsq = w1 ** 2 + w2 ** 2 + torch.where(has3, w3 ** 2,
                                              torch.zeros_like(w3))
        var = var + torch.where(in_grp, wsq * s2, torch.zeros_like(s2))
    bad = v_cnt < 2
    var = torch.where(bad, _nan_like(var), var)
    df = (v_cnt - n_groups).to(var.dtype)
    df = torch.where(bad, _nan_like(df), df)
    return var, df


def _argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.argsort(x, dim=-1, stable=True)


def collapse_small_strata(tables: StratumTables, order_key, *,
                          min_count: float = 2):
    """Merge under-sampled strata into their key-order neighbour,
    lane-wise (paper fn. 7; ``TwoPhaseFlow.ci_check``'s remedy).

    Strata are ordered by ``order_key`` (e.g. the baseline-CPI stratum
    means); strata with no weight and no samples are dropped; walking the
    order, each stratum closes a group (count >= ``min_count``), joins
    the open group, or — undersized after a closed group — merges back
    into it; a trailing undersized group merges back too. Returns
    ``(merged, group_of, n_groups)``: tables whose group g sits in slot g
    (later slots zero), the stratum -> group map (-1 = dropped) and the
    per-lane group count (0 marks a lane with fewer than ``min_count``
    samples in all).
    """
    n_strata = tables.num_strata
    counts, weights = tables.counts, tables.weights
    active = (weights > 0) | (counts > 0)
    key = torch.broadcast_to(
        torch.as_tensor(order_key).to(counts.device, counts.dtype),
        counts.shape)
    key = torch.where(active, key, torch.full_like(key, float("inf")))
    order = _argsort(key)
    c_s = torch.take_along_dim(counts, order, dim=-1)
    a_s = torch.take_along_dim(active, order, dim=-1)

    batch = counts.shape[:-1]
    gid = torch.full(batch, -1, dtype=torch.int64, device=counts.device)
    acc = torch.zeros(batch, dtype=counts.dtype, device=counts.device)
    slots = []
    for p in range(n_strata):
        act = a_s[..., p]
        c = c_s[..., p]
        start = act & ((gid < 0) | ((acc >= min_count) & (c >= min_count)))
        gid = torch.where(start, gid + 1, gid)
        acc = torch.where(start, c, torch.where(act, acc + c, acc))
        slots.append(torch.where(act, gid, torch.full_like(gid, -1)))
    g_sorted = torch.stack(slots, dim=-1)
    # a group after the first starts only on a stratum with c >= min_count,
    # so only group 0 can end undersized: that lane is degenerate
    n_groups = torch.where(gid < 0, torch.zeros_like(gid), gid + 1)
    n_groups = torch.where((gid == 0) & (acc < min_count),
                           torch.zeros_like(n_groups), n_groups)
    group_of = torch.take_along_dim(g_sorted, _argsort(order), dim=-1)
    onehot = (group_of[..., :, None] == torch.arange(
        n_strata, device=counts.device)).to(counts.dtype)

    def merge(t):
        return (t[..., :, None] * onehot).sum(dim=-2)

    merged = StratumTables(counts=merge(counts), sums=merge(tables.sums),
                           sumsqs=merge(tables.sumsqs),
                           weights=merge(weights), shift=tables.shift)
    return merged, group_of, n_groups


# ------------------------------------------------------------- allocation
def _float_lanes(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.double()


def proportional_allocation(weights, n_total, *, min_per_stratum: int = 2
                            ) -> torch.Tensor:
    """Proportional allocation lane-wise: n_h proportional to W_h, each
    at least ``min_per_stratum``, rounded by largest remainder to the
    ``n_total`` budget (overshoot accepted where the minima force it).
    ``weights (..., L)``; ``n_total`` a number or ``(...)``. Returns
    int64 ``(..., L)``."""
    w = _float_lanes(weights)
    nt = torch.as_tensor(n_total, dtype=w.dtype, device=w.device)
    raw = w * (nt[..., None] if nt.dim() else nt)
    n_h = torch.clamp_min(torch.floor(raw).long(), min_per_stratum)
    return _largest_remainder_fixup(n_h, raw, nt)


def neyman_allocation(weights, stds, n_total, *, min_per_stratum: int = 2
                      ) -> torch.Tensor:
    """Neyman allocation lane-wise: n_h proportional to W_h S_h; lanes
    whose products are all zero take the proportional allocation."""
    w = _float_lanes(weights)
    s = torch.clamp_min(torch.as_tensor(stds).to(w.device, w.dtype), 0.0)
    prod = w * s
    tot = prod.sum(dim=-1, keepdim=True)
    zero = tot <= 0
    share = prod / torch.where(zero, torch.ones_like(tot), tot)
    nt = torch.as_tensor(n_total, dtype=w.dtype, device=w.device)
    raw = share * (nt[..., None] if nt.dim() else nt)
    n_h = torch.clamp_min(torch.floor(raw).long(), min_per_stratum)
    ney = _largest_remainder_fixup(n_h, raw, nt)
    prop = proportional_allocation(w, nt, min_per_stratum=min_per_stratum)
    return torch.where(zero, prop, ney)


def _largest_remainder_fixup(n_h: torch.Tensor, raw: torch.Tensor,
                             n_total) -> torch.Tensor:
    """Hand out the budget's deficit one unit at a time in descending
    order of fractional remainder, wrapping around (a negative deficit,
    from the minima, is accepted)."""
    n_strata = n_h.shape[-1]
    nt = torch.as_tensor(n_total, device=n_h.device)
    deficit = torch.clamp_min((nt - n_h.sum(dim=-1)).long(), 0)
    frac = raw - torch.floor(raw)
    # rank 0 = largest remainder (a stable sort of -frac)
    rank = _argsort(_argsort(-frac))
    extra = deficit[..., None] // n_strata \
        + (rank < (deficit[..., None] % n_strata)).long()
    return n_h + extra


def fixed_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed order that no shape changes: the
    axis is padded with zeros to a power of two and halved, one
    elementwise add per level. A reduction kernel may pick its order from
    the whole tensor's shape; this one gives every lane the same bits
    whatever the other axes hold (the trials' chunk invariance)."""
    m = x.shape[-1]
    if m == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    width = 1 << (m - 1).bit_length()
    if width != m:
        x = torch.nn.functional.pad(x, (0, width - m))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]


# ----------------------------------------------- streaming trial statistics
# the log-histogram sketch grid of every TrialStats: 4096 bins over
# [1e-6, 1e6), about 0.68 % relative resolution; values outside clip into
# the edge bins
TRIAL_HIST_BINS = 4096
TRIAL_HIST_LO = 1e-6
TRIAL_HIST_HI = 1e6
_HIST_LOG_LO = float(np.log(TRIAL_HIST_LO))
_HIST_LOG_SPAN = float(np.log(TRIAL_HIST_HI) - np.log(TRIAL_HIST_LO))


@dataclasses.dataclass(frozen=True)
class TrialStats:
    """Streaming Monte-Carlo trial statistics over batch lanes (apps).

    Every leaf is additive. The counters and histogram sketches are int32,
    exact in any order. The float moments are added as
    ``trial_stats_update`` describes: each block of trials is reduced to
    partial sums in a fixed order, and the blocks are added into the
    running sums one at a time in block order, so any chunking of the
    same blocks gives the same bits. ``err_hist``/``half_hist`` are
    log-spaced sketches over ``[TRIAL_HIST_LO, TRIAL_HIST_HI)``; the
    readouts below return numpy arrays on the host.
    """

    count: torch.Tensor       # (...,) valid trials
    cover: torch.Tensor       # (...,) trials whose CI covered the truth
    err_sum: torch.Tensor     # (...,) sum of percent |error| (accum dtype)
    err_sumsq: torch.Tensor   # (...,) sum of its squares
    half_n: torch.Tensor      # (...,) trials with a finite half-width
    half_sum: torch.Tensor    # (...,) sum of CI half-widths
    half_sumsq: torch.Tensor  # (...,) sum of their squares
    err_hist: torch.Tensor    # (..., B) log-bucketed error counts
    half_hist: torch.Tensor   # (..., B) log-bucketed half-width counts

    def leaves(self) -> tuple[torch.Tensor, ...]:
        """The nine tensors, in field order."""
        return tuple(getattr(self, f.name)
                     for f in dataclasses.fields(self))

    def map(self, fn) -> "TrialStats":
        """A ``TrialStats`` of ``fn`` applied to every leaf."""
        return TrialStats(*(fn(x) for x in self.leaves()))

    @staticmethod
    def _np(x) -> np.ndarray:
        return x.detach().cpu().numpy()

    @property
    def coverage(self) -> np.ndarray:
        """(...) covered / valid trials (NaN where no trial counted)."""
        count, cover = self._np(self.count), self._np(self.cover)
        denom = np.maximum(count, 1).astype(np.float64)
        return np.where(count > 0, cover / denom, np.nan)

    @property
    def err_mean(self) -> np.ndarray:
        """(...) mean percent |error| over trials with a finite error."""
        n = self._np(self.err_hist).sum(axis=-1)
        return np.where(n > 0, self._np(self.err_sum) / np.maximum(n, 1),
                        np.nan)

    @property
    def half_mean(self) -> np.ndarray:
        """(...) mean CI half-width over trials with a finite interval."""
        n = self._np(self.half_n)
        return np.where(n > 0, self._np(self.half_sum) / np.maximum(n, 1),
                        np.nan)

    def err_quantile(self, q: float) -> np.ndarray:
        """(...) q-quantile of percent |error| from the sketch."""
        return log_hist_quantile(self.err_hist, q)

    def half_quantile(self, q: float) -> np.ndarray:
        """(...) q-quantile of the CI half-width from the sketch."""
        return log_hist_quantile(self.half_hist, q)


def trial_stats_init(batch_shape, *, bins: int = TRIAL_HIST_BINS,
                     accum_dtype: torch.dtype = torch.float32,
                     device=None) -> TrialStats:
    """Zeroed accumulator for ``batch_shape`` lanes: float moments in
    ``accum_dtype``, counters and sketches int32."""
    bs = tuple(batch_shape)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return TrialStats(
        count=zeros(bs, torch.int32), cover=zeros(bs, torch.int32),
        err_sum=zeros(bs, accum_dtype), err_sumsq=zeros(bs, accum_dtype),
        half_n=zeros(bs, torch.int32), half_sum=zeros(bs, accum_dtype),
        half_sumsq=zeros(bs, accum_dtype),
        err_hist=zeros(bs + (int(bins),), torch.int32),
        half_hist=zeros(bs + (int(bins),), torch.int32))


def _log_bucket(x: torch.Tensor, bins: int) -> torch.Tensor:
    """Histogram bin of ``x`` on the shared log grid (clipped), int64."""
    pos = torch.isfinite(x) & (x > 0)
    safe = torch.where(pos, x, torch.full_like(x, TRIAL_HIST_LO))
    b = torch.floor((torch.log(safe) - _HIST_LOG_LO)
                    * (bins / _HIST_LOG_SPAN))
    return torch.clamp(b, 0, bins - 1).long()


def _hist_add(hist: torch.Tensor, values: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """``hist`` plus the histogram of ``values[mask]``, lane-wise: all
    lanes in one int32 ``index_add_`` (exact in any order)."""
    bins = hist.shape[-1]
    lanes = math.prod(hist.shape[:-1])
    t = values.shape[-1]
    idx = _log_bucket(values, bins).reshape(lanes, t)
    flat = (idx + bins * torch.arange(lanes, device=idx.device)[:, None]
            ).reshape(-1)
    w = torch.broadcast_to(mask, values.shape).reshape(-1).to(torch.int32)
    add = torch.zeros(lanes * bins, dtype=torch.int32, device=hist.device)
    add.index_add_(0, flat, w)
    return hist + add.reshape(hist.shape)


def trial_stats_update(stats: TrialStats, err: torch.Tensor,
                       half: torch.Tensor, covered: torch.Tensor, valid, *,
                       block: int, with_moments: bool = False):
    """Fold one chunk of per-trial outcomes into the running statistics.

    ``err``/``half`` ``(..., Tc)`` per-trial percent errors and CI
    half-widths, ``covered`` whether each CI covered the truth, ``valid``
    a broadcastable mask of the trials that count (the chunk grid pads
    the trial count up). Float moments are cast to the accumulator dtype,
    reduced over each ``block`` of trials by ``fixed_sum`` and added into
    the running sums one block at a time, in block order. Counters and
    sketches are int32. ``with_moments`` also returns the block partial
    sums that were added, ``(..., 4, Tc / block)`` in the order of
    ``TRIAL_MOMENTS``, for ``fold_block_moments``.
    """
    v = torch.broadcast_to(torch.as_tensor(valid, device=err.device).bool(),
                           err.shape)
    acc = stats.err_sum.dtype
    err_ok = v & torch.isfinite(err)
    half_ok = v & torch.isfinite(half)
    t = err.shape[-1]
    if t % block:
        raise ValueError(f"{t} trials do not split into blocks of {block}")

    def parts(x, m, square: bool):
        xc = torch.where(m, x, torch.zeros_like(x)).to(acc)
        if square:
            xc = xc * xc
        return fixed_sum(xc.reshape(*xc.shape[:-1], t // block, block))

    def count(total, m):
        return total + m.sum(dim=-1, dtype=torch.int32)

    moments = torch.stack([parts(err, err_ok, False), parts(err, err_ok, True),
                           parts(half, half_ok, False),
                           parts(half, half_ok, True)], dim=-2)
    new = fold_block_moments(TrialStats(
        count=count(stats.count, v),
        cover=count(stats.cover, v & covered),
        err_sum=stats.err_sum, err_sumsq=stats.err_sumsq,
        half_n=count(stats.half_n, half_ok),
        half_sum=stats.half_sum, half_sumsq=stats.half_sumsq,
        err_hist=_hist_add(stats.err_hist, err, err_ok),
        half_hist=_hist_add(stats.half_hist, half, half_ok)), moments)
    return (new, moments) if with_moments else new


# the float moments of a TrialStats, in the order of a block-moments axis
TRIAL_MOMENTS = ("err_sum", "err_sumsq", "half_sum", "half_sumsq")


def fold_block_moments(stats: TrialStats,
                       moments: torch.Tensor) -> TrialStats:
    """``stats`` with block partial sums ``(..., 4, nb)`` (see
    ``trial_stats_update``) added into its float moments one block at a
    time, in block order: the same elementwise adds, so the same bits, as
    folding those blocks chunk by chunk."""
    total = torch.stack([getattr(stats, f) for f in TRIAL_MOMENTS], dim=-1)
    for j in range(moments.shape[-1]):
        total = total + moments[..., j]
    return dataclasses.replace(
        stats, **{f: total[..., i] for i, f in enumerate(TRIAL_MOMENTS)})


def trial_stats_merge(a: TrialStats, b: TrialStats) -> TrialStats:
    """Leafwise sum of two partial accumulations."""
    return TrialStats(*(x + y for x, y in zip(a.leaves(), b.leaves())))


def log_hist_quantile(hist, q: float) -> np.ndarray:
    """(...) q-quantile from a log-histogram sketch, on the host: the
    geometric centre of the bin holding the q-th order statistic; NaN for
    empty lanes. Good to one bin width (about 0.68 %)."""
    h = (hist.detach().cpu().numpy() if isinstance(hist, torch.Tensor)
         else np.asarray(hist)).astype(np.float64)
    bins = h.shape[-1]
    tot = h.sum(axis=-1)
    cum = np.cumsum(h, axis=-1)
    idx = np.argmax(cum >= q * tot[..., None], axis=-1)
    centers = np.exp(_HIST_LOG_LO
                     + (np.arange(bins) + 0.5) * (_HIST_LOG_SPAN / bins))
    return np.where(tot > 0, centers[idx], np.nan)
