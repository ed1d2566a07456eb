"""Composable sampling plans: stratifier x selection policy x estimator.

Counterpart of ``repro.core.sampling.plan``. A ``SamplingPlan`` is three
frozen dataclasses:

* a ``Stratifier`` (``BBVClusters`` / ``RFVClusters`` /
  ``DaleniusGurney``) whose ``resolve`` stacks the engine-built
  stratification of each app into one ``StratumBank``, and whose ``fit``
  stratifies one app's phase-1 sample anew (the ``TwoPhaseFlow``
  path: standardize, then k-means through the clustering kernels, or the
  Dalenius-Gurney boundary search on the host);
* a ``SelectionPolicy`` (``Centroid``, ``StratumMean``, ``RandomUnit``,
  ``RankedSetUnit``) — a batched callable mapping a ``SelectionContext``
  to one pick per stratum per app, with ``select_local`` for one app's
  flow;
* an ``Estimator`` (``WeightedPoint``, ``CollapsedPairsCI``,
  ``TwoPhaseCI``) turning the picked units' values into estimates.

New designs plug in through ``register_stratifier`` /
``register_policy``; ``SamplingPlan.from_strings`` resolves names through
the same registry. Tensors stay on the engine's device throughout, and
nothing here reads a tensor back to the host, so the fused sweep
(``repro_torch.experiments.fused``) can capture selection and estimates
into one CUDA graph. ``last_sweep_dispatch`` records the latest sweep
estimate, staged or fused.
"""

from __future__ import annotations

import dataclasses
import warnings
import zlib
from typing import Callable, ClassVar, Optional, Sequence

import numpy as np
import torch

from . import tables as _tables
from .types import Estimate, critical_values

__all__ = [
    "SamplingPlan", "Stratifier", "SelectionPolicy", "Estimator",
    "BBVClusters", "RFVClusters", "DaleniusGurney",
    "Centroid", "StratumMean", "RandomUnit", "RankedSetUnit",
    "WeightedPoint", "CollapsedPairsCI", "TwoPhaseCI",
    "StratumBank", "SelectionContext", "build_selection_context",
    "register_stratifier", "register_policy",
    "registered_stratifiers", "registered_policies",
    "make_stratifier", "make_policy", "stack_ragged_tensors",
    "trial_scheme_index", "last_sweep_dispatch", "warn_string_dispatch",
]


# ---------------------------------------------------------------- registry
_STRATIFIERS: dict[str, Callable] = {}
_POLICIES: dict[str, Callable] = {}
_STRATIFIER_ALIASES: dict[str, str] = {}


def register_stratifier(name: str, factory: Callable, *,
                        aliases: Sequence[str] = ()) -> Callable:
    """Register a ``Stratifier`` factory under ``name`` (+ aliases that
    resolve to it but are not scheme names of their own)."""
    _STRATIFIERS[name] = factory
    for key in aliases:
        _STRATIFIER_ALIASES[key] = name
    return factory


def register_policy(name: str, factory: Callable) -> Callable:
    """Register a ``SelectionPolicy`` factory under ``name``."""
    _POLICIES[name] = factory
    return factory


def registered_stratifiers() -> tuple[str, ...]:
    """Registered stratifier scheme names (aliases omitted), in
    registration order."""
    return tuple(_STRATIFIERS)


def registered_policies() -> tuple[str, ...]:
    """Registered selection-policy names, in registration order."""
    return tuple(_POLICIES)


def _lookup(table: dict, kind: str, name: str) -> Callable:
    try:
        return table[name]
    except KeyError:
        raise ValueError(
            f"unknown {kind} {name!r}; registered: "
            f"{', '.join(sorted(table))}") from None


def _construct(factory: Callable, params: dict):
    if dataclasses.is_dataclass(factory):
        names = {f.name for f in dataclasses.fields(factory) if f.init}
        params = {k: v for k, v in params.items() if k in names}
    return factory(**params)


def make_stratifier(name: str, **params) -> "Stratifier":
    """A registered stratifier by name (params filtered to its fields)."""
    name = _STRATIFIER_ALIASES.get(name, name)
    return _construct(_lookup(_STRATIFIERS, "stratifier", name), params)


def make_policy(name: str, **params) -> "SelectionPolicy":
    """A registered selection policy by name (params filtered)."""
    return _construct(_lookup(_POLICIES, "selection policy", name), params)


# ------------------------------------------------------------ ragged stack
def stack_ragged_tensors(tensors: Sequence[torch.Tensor]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, valid) stack of tensors with ragged leading lengths,
    zero-padded to the longest."""
    k_max = max(t.shape[0] for t in tensors)
    first = tensors[0]
    out = torch.zeros((len(tensors), k_max) + tuple(first.shape[1:]),
                      dtype=first.dtype, device=first.device)
    valid = torch.zeros((len(tensors), k_max), dtype=torch.bool,
                        device=first.device)
    for i, t in enumerate(tensors):
        out[i, :t.shape[0]] = t
        valid[i, :t.shape[0]] = True
    return out, valid


# -------------------------------------------------------------- stratifiers
@dataclasses.dataclass(frozen=True)
class StratumBank:
    """Stacked-over-app stratification a ``Stratifier`` resolves to.

    ``labels``/``valid`` are ``(A, n)`` over each app's unit pool;
    ``weights`` ``(A, L)``; ``baseline`` the per-unit baseline CPI.
    ``feats``/``centroids`` may be ``None``: the selection context then
    uses the baseline and the per-stratum baseline means (the
    Dalenius-Gurney convention). ``pool`` maps pool positions to
    population indices (``None`` when labels index the population).
    """

    labels: torch.Tensor
    valid: torch.Tensor
    weights: torch.Tensor
    baseline: torch.Tensor
    feats: Optional[torch.Tensor] = None
    centroids: Optional[torch.Tensor] = None
    pool: Optional[torch.Tensor] = None

    @property
    def num_strata(self) -> int:
        return int(self.weights.shape[-1])


@dataclasses.dataclass(frozen=True)
class Stratifier:
    """Base class: how a population is grouped into strata.

    ``resolve(exps)`` stacks the engine-built artifacts this stratifier
    stands for (``exps`` are ``AppExperiment``-shaped, duck-typed) into a
    ``StratumBank``; ``fit(baseline_y, features)`` stratifies one app's
    phase-1 sample anew and returns ``(labels, centroids,
    features_used)``. ``pool_kind`` says where its units come from: the
    census (free) or the charged phase-1 sample.
    """

    name: ClassVar[str] = "?"
    pool_kind: ClassVar[str] = "phase1"

    num_strata: int = 20
    seed: int = 0

    def resolve(self, exps: Sequence) -> StratumBank:
        """Stack this stratifier's engine-built artifacts over apps."""
        raise NotImplementedError

    def fit(self, baseline_y, features):
        """Labels, centroids and the features used, from phase-1 data."""
        raise NotImplementedError


def _fit_kmeans(features, num_strata: int, seed: int, backend: str,
                restarts: int):
    """Standardize, then k-means with ``restarts`` seedings from the
    threefry key of ``seed``; shared by the feature-space stratifiers.

    The z-scores are the reference's: a float64 fit applied in float32
    (its features reach the transform as float32). On a CUDA tensor every
    Lloyd step launches ``kmeans_assign`` and ``segment_stats``.
    """
    from ... import prng
    from ..clustering.kmeans import kmeans
    from ..clustering.standardize import Standardizer

    if features is None:
        raise ValueError("feature-space stratifiers need a feature matrix")
    x = torch.as_tensor(features)
    z = Standardizer.fit(x).transform(x.float())
    km = kmeans(z, num_strata, key=prng.PRNGKey(seed, device=z.device),
                backend=backend, restarts=restarts)
    return km.labels, km.centroids, z


@dataclasses.dataclass(frozen=True)
class BBVClusters(Stratifier):
    """SimPoint-style strata: k-means on projected BBVs over the full
    population."""

    name: ClassVar[str] = "bbv"
    pool_kind: ClassVar[str] = "census"

    restarts: int = 3
    backend: str = "auto"

    def fit(self, baseline_y, features):
        """k-means on the standardized BBV features."""
        return _fit_kmeans(features, self.num_strata, self.seed,
                           self.backend, self.restarts)

    def resolve(self, exps: Sequence) -> StratumBank:
        labels, valid = stack_ragged_tensors([e.bbv_labels for e in exps])
        feats, _ = stack_ragged_tensors([e.bbv_feats for e in exps])
        baseline, _ = stack_ragged_tensors([e.census(0) for e in exps])
        return StratumBank(
            labels=labels, valid=valid,
            weights=torch.stack([e.bbv_weights for e in exps]),
            baseline=baseline, feats=feats,
            centroids=torch.stack([e.bbv_centroids for e in exps]))


@dataclasses.dataclass(frozen=True)
class RFVClusters(Stratifier):
    """The paper's recommended strata: k-means on standardized RFVs of the
    phase-1 sample."""

    name: ClassVar[str] = "rfv"
    pool_kind: ClassVar[str] = "phase1"

    restarts: int = 3
    backend: str = "auto"

    def fit(self, baseline_y, features):
        """k-means on the standardized RFVs."""
        return _fit_kmeans(features, self.num_strata, self.seed,
                           self.backend, self.restarts)

    def resolve(self, exps: Sequence) -> StratumBank:
        labels, valid = stack_ragged_tensors([e.rfv_labels for e in exps])
        feats, _ = stack_ragged_tensors([e.rfv_z for e in exps])
        baseline, _ = stack_ragged_tensors([e.cpi0_1 for e in exps])
        pool, _ = stack_ragged_tensors([e.idx1 for e in exps])
        return StratumBank(
            labels=labels, valid=valid,
            weights=torch.stack([e.rfv_weights for e in exps]),
            baseline=baseline, feats=feats,
            centroids=torch.stack([e.rfv_centroids for e in exps]),
            pool=pool)


@dataclasses.dataclass(frozen=True)
class DaleniusGurney(Stratifier):
    """Dalenius-Gurney boundaries on baseline CPI: one-dimensional strata
    whose centroids are the stratum-mean CPIs."""

    name: ClassVar[str] = "dg"
    pool_kind: ClassVar[str] = "phase1"

    def fit(self, baseline_y, features):
        """The boundary search on baseline y (a float64 host refinement);
        each centroid is its stratum's mean (NaN where empty). Returns
        tensors on ``baseline_y``'s device."""
        from .dalenius import dalenius_gurney_strata

        dev = baseline_y.device if isinstance(baseline_y, torch.Tensor) \
            else torch.device("cpu")
        y = _host(baseline_y).astype(np.float64)
        labels = dalenius_gurney_strata(y, self.num_strata)
        centroids = np.array([
            [y[labels == h].mean()] if (labels == h).any() else [np.nan]
            for h in range(self.num_strata)])
        return (torch.as_tensor(labels, device=dev),
                torch.as_tensor(centroids, device=dev),
                torch.as_tensor(y[:, None], device=dev))

    def resolve(self, exps: Sequence) -> StratumBank:
        labels, valid = stack_ragged_tensors([e.dg_labels for e in exps])
        baseline, _ = stack_ragged_tensors([e.cpi0_1 for e in exps])
        pool, _ = stack_ragged_tensors([e.idx1 for e in exps])
        return StratumBank(
            labels=labels, valid=valid,
            weights=torch.stack([e.dg_weights for e in exps]),
            baseline=baseline, pool=pool)


register_stratifier("bbv", BBVClusters)
register_stratifier("rfv", RFVClusters)
register_stratifier("dg", DaleniusGurney, aliases=("cpi",))


# ----------------------------------------------------------------- policies
def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def host_segment_sums_counts(labels, valid, num_strata: int, values
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact float64 stratum sums and counts, as the reference's host
    default (an offset bincount in numpy), returned on ``labels``'
    device. The one-app flow selection summarizes with it; the engine
    passes its ``segment_stats`` summary instead."""
    lab_np, ok = _host(labels), _host(valid).astype(bool)
    lab = np.where(ok, lab_np, num_strata).astype(np.int64)
    a_n = lab.shape[0]
    flat = (lab + (num_strata + 1) * np.arange(a_n)[:, None]).ravel()
    size = a_n * (num_strata + 1)
    counts = np.bincount(flat, minlength=size)
    sums = np.bincount(flat, weights=np.where(ok, _host(values), 0.0)
                       .ravel(), minlength=size)
    dev = labels.device
    return (torch.as_tensor(sums.reshape(a_n, -1)[:, :num_strata]
                            .astype(np.float64), device=dev),
            torch.as_tensor(counts.reshape(a_n, -1)[:, :num_strata]
                            .astype(np.float64), device=dev))


def stratum_order(labels: torch.Tensor, valid: torch.Tensor,
                  num_strata: int) -> torch.Tensor:
    """(A, n) positions sorted by stratum, index order within a stratum,
    invalid entries last: a stable sort on the device."""
    key = torch.where(valid, labels, torch.full_like(labels, num_strata))
    return torch.argsort(key, dim=1, stable=True)


@dataclasses.dataclass
class SelectionContext:
    """Everything a batched selection policy may read, app-stacked.

    ``member`` (lazy) marks unit ``i`` of app ``a`` as a valid member of
    stratum ``h``. ``order``/``offsets``/``counts`` are the gather tables:
    stratum ``h`` of app ``a`` owns ``order[a, offsets[a, h] :
    offsets[a, h] + counts[a, h]]`` in index order (trailing empty strata
    put their offset at the row width; gathers clamp). ``uniforms``
    optionally carries pre-drawn ``(A, L)`` uniforms for ``RandomUnit``
    (the fused sweep passes the host rng's draws in).
    """

    labels: torch.Tensor       # (A, n)
    valid: torch.Tensor        # (A, n)
    feats: torch.Tensor        # (A, n, F)
    centroids: torch.Tensor    # (A, L, F)
    baseline: torch.Tensor     # (A, n)
    base_means: torch.Tensor   # (A, L)
    counts: torch.Tensor       # (A, L) int64
    num_strata: int
    seed: int = 0
    uniforms: Optional[torch.Tensor] = None    # (A, L) float64 U[0, 1)
    _member: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                        repr=False)
    _order: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                       repr=False)

    @property
    def member(self) -> torch.Tensor:
        """(A, n, L) valid-membership mask (cached on first read)."""
        if self._member is None:
            strata = torch.arange(self.num_strata, device=self.labels.device)
            self._member = (self.labels[:, :, None] == strata) \
                & self.valid[:, :, None]
        return self._member

    @property
    def order(self) -> torch.Tensor:
        """(A, n) stratum-sorted gather table (cached on first read)."""
        if self._order is None:
            self._order = stratum_order(self.labels, self.valid,
                                        self.num_strata)
        return self._order

    @property
    def offsets(self) -> torch.Tensor:
        """(A, L) per-stratum start positions into ``order``."""
        return torch.cumsum(self.counts, dim=1) - self.counts


def build_selection_context(bank: StratumBank, *,
                            summarize: Optional[Callable] = None,
                            seed: int = 0,
                            uniforms: Optional[torch.Tensor] = None
                            ) -> SelectionContext:
    """Selection context for a ``StratumBank``: ONE stratum-summary
    dispatch serves the counts, the stratum-mean baselines and, for banks
    without centroids, the Dalenius-Gurney centroids.

    ``summarize(labels, valid, L, values) -> (sums, counts)`` is the
    engine's ``segment_stats``-backed summary (default: the exact float64
    ``host_segment_sums_counts``). ``seed`` seeds ``RandomUnit``'s host
    draw unless ``uniforms`` carries it.
    """
    summarize = summarize or host_segment_sums_counts
    L = bank.num_strata
    base_sums, countsf = summarize(bank.labels, bank.valid, L, bank.baseline)
    base_means = base_sums / torch.clamp_min(countsf, 1.0)
    feats = bank.feats if bank.feats is not None \
        else bank.baseline[:, :, None]
    cents = bank.centroids if bank.centroids is not None \
        else base_means[:, :, None]
    return SelectionContext(
        labels=bank.labels, valid=bank.valid, feats=feats, centroids=cents,
        baseline=bank.baseline, base_means=base_means,
        counts=countsf.long(), num_strata=L, seed=seed, uniforms=uniforms)


@dataclasses.dataclass(frozen=True)
class SelectionPolicy:
    """Base class: ``policy(ctx) -> (A, L)`` pool positions, one per
    stratum (empty strata may return anything; the caller masks them).
    ``uses_uniforms`` declares that the policy reads per-(app, stratum)
    uniform draws (``SelectionContext.uniforms``), which the fused sweep
    draws on the host and passes in."""

    name: ClassVar[str] = "?"
    uses_uniforms: ClassVar[bool] = False

    def __call__(self, ctx: SelectionContext) -> torch.Tensor:
        raise NotImplementedError

    def select_local(self, labels, *, features, centroids, baseline,
                     num_strata: int, seed: int = 0,
                     per_stratum: Optional[int] = None
                     ) -> list[torch.Tensor]:
        """Per-stratum local index tensors for one app (the flow path).

        ``per_stratum=None`` defers to the policy's own configuration.
        The default runs the batched callable on a one-lane context, so
        it picks one unit per stratum; multi-unit policies override it.
        """
        if (per_stratum or 1) != 1:
            raise NotImplementedError(
                f"{type(self).name!r} selects one unit per stratum; "
                "override select_local for multi-unit designs")
        labels = torch.as_tensor(labels)
        dev = labels.device

        def lane(x):
            return None if x is None else torch.as_tensor(x).to(dev)[None]

        bank = StratumBank(
            labels=labels[None],
            valid=torch.ones((1, labels.numel()), dtype=torch.bool,
                             device=dev),
            weights=torch.full((1, num_strata), 1.0 / max(num_strata, 1),
                               dtype=torch.float64, device=dev),
            baseline=lane(baseline), feats=lane(features),
            centroids=lane(centroids))
        ctx = build_selection_context(bank, seed=seed)
        local = self(ctx)[0]
        return [local[h:h + 1].long() if int(ctx.counts[0, h]) > 0
                else local.new_empty(0, dtype=torch.int64)
                for h in range(num_strata)]


@dataclasses.dataclass(frozen=True)
class Centroid(SelectionPolicy):
    """SimPoint-style selection: the member nearest its stratum centroid."""

    name: ClassVar[str] = "centroid"

    per_stratum: int = 1

    def select_local(self, labels, *, features, centroids, baseline,
                     num_strata: int, seed: int = 0,
                     per_stratum: Optional[int] = None
                     ) -> list[torch.Tensor]:
        """Flow path: ``select_centroid``, the ``per_stratum`` nearest."""
        from .selection import select_centroid
        return select_centroid(labels, features, centroids,
                               per_stratum=per_stratum or self.per_stratum)

    def __call__(self, ctx: SelectionContext) -> torch.Tensor:
        """Argmin over members of the squared distance to the centroid.

        The expanded |x|^2 - 2<x,c> + |c|^2 form cancels badly in float32
        at census scale (d2 ~ 1e-5 out of O(1) terms), enough to flip
        near-boundary argmins, so it is accumulated in float64.
        """
        feats = ctx.feats.double()
        cents = ctx.centroids.double()
        x2 = (feats ** 2).sum(dim=2)
        c2 = (cents ** 2).sum(dim=2)
        d2 = x2[:, :, None] - 2.0 * torch.einsum("and,ald->anl", feats,
                                                 cents) + c2[:, None, :]
        return torch.where(ctx.member, d2, float("inf")).argmin(dim=1)


@dataclasses.dataclass(frozen=True)
class StratumMean(SelectionPolicy):
    """Mean selection (paper V.B.2, Fig 11): the member whose baseline CPI
    is nearest its stratum's mean baseline CPI."""

    name: ClassVar[str] = "mean"

    per_stratum: int = 1

    def select_local(self, labels, *, features, centroids, baseline,
                     num_strata: int, seed: int = 0,
                     per_stratum: Optional[int] = None
                     ) -> list[torch.Tensor]:
        """Flow path: ``select_mean``, the ``per_stratum`` nearest."""
        from .selection import select_mean
        return select_mean(labels, baseline, num_strata=num_strata,
                           per_stratum=per_stratum or self.per_stratum)

    def __call__(self, ctx: SelectionContext) -> torch.Tensor:
        """Argmin of |baseline - stratum mean baseline| over members."""
        d = torch.abs(ctx.baseline[:, :, None] - ctx.base_means[:, None, :])
        return torch.where(ctx.member, d, float("inf")).argmin(dim=1)


@dataclasses.dataclass(frozen=True)
class RandomUnit(SelectionPolicy):
    """Textbook stratified sampling (Fig 9): one uniformly random member
    per stratum."""

    name: ClassVar[str] = "random"
    uses_uniforms: ClassVar[bool] = True

    per_stratum: int = 1

    def select_local(self, labels, *, features, centroids, baseline,
                     num_strata: int, seed: int = 0,
                     per_stratum: Optional[int] = None
                     ) -> list[torch.Tensor]:
        """Flow path: ``select_random`` from ``default_rng(seed)``."""
        from .selection import select_random
        return select_random(labels, num_strata,
                             np.random.default_rng(seed),
                             per_stratum=per_stratum or self.per_stratum)

    def __call__(self, ctx: SelectionContext) -> torch.Tensor:
        """One draw per (app, stratum) through the gather tables: the
        ``(A, L)`` float64 uniforms of ``np.random.default_rng(seed)``,
        or ``ctx.uniforms`` when the caller drew them already."""
        u = ctx.uniforms
        if u is None:
            u = torch.as_tensor(
                np.random.default_rng(ctx.seed).random(
                    tuple(ctx.counts.shape)), device=ctx.counts.device)
        pos = ctx.offsets + torch.minimum(
            (u * ctx.counts).long(), torch.clamp_min(ctx.counts - 1, 0))
        # trailing empty strata put offsets at the row width: clamp (the
        # caller's validity mask discards the pick)
        pos = torch.clamp_max(pos, max(ctx.order.shape[1] - 1, 0))
        return torch.take_along_dim(ctx.order, pos, dim=1)


@dataclasses.dataclass(frozen=True)
class RankedSetUnit(SelectionPolicy):
    """Order-statistic selection: the member at a fixed baseline-CPI rank
    within each stratum (after *CPU Simulation with Ranked Set Sampling
    and Repeated Subsampling*). ``rank_fraction`` 0.5 picks each
    stratum's median unit, 0.0 / 1.0 the extremes. Deterministic, and it
    needs only the scalar baseline. Registered through the public
    registry, as a plug-in would be."""

    name: ClassVar[str] = "ranked_set"

    rank_fraction: float = 0.5

    def __post_init__(self):
        if not 0.0 <= self.rank_fraction <= 1.0:
            raise ValueError(
                f"rank_fraction must be in [0, 1], got {self.rank_fraction}")

    def __call__(self, ctx: SelectionContext) -> torch.Tensor:
        """The unit at the configured rank of each stratum: members
        ordered by (stratum, baseline) with two stable sorts."""
        primary = torch.where(ctx.valid, ctx.labels,
                              torch.full_like(ctx.labels, ctx.num_strata))
        by_base = torch.argsort(ctx.baseline, dim=1, stable=True)
        rs_order = torch.take_along_dim(
            by_base,
            torch.argsort(torch.take_along_dim(primary, by_base, dim=1),
                          dim=1, stable=True), dim=1)
        # numpy's rint: halves round to even, as torch.round does
        rank = torch.round(self.rank_fraction * torch.clamp_min(
            ctx.counts - 1, 0).double()).long()
        pos = torch.clamp_max(ctx.offsets + rank,
                              max(rs_order.shape[1] - 1, 0))
        return torch.take_along_dim(rs_order, pos, dim=1)


register_policy("centroid", Centroid)
register_policy("mean", StratumMean)
register_policy("random", RandomUnit)
register_policy("ranked_set", RankedSetUnit)


# ------------------------------------------------------- dispatch marker
_last_sweep_dispatch: Optional[dict] = None


def last_sweep_dispatch() -> Optional[dict]:
    """The latest sweep-estimate dispatch (``None`` before any): the
    ``batch_shape`` (A, C), ``num_strata``, ``x64`` (estimates in
    float64), ``backend`` (the device type), ``fused`` (one program for
    the whole sweep), ``in_place`` (the program updated the memo tables
    in place), ``captured`` (the program is a CUDA graph) and ``count``
    (dispatches since the last reset: one fused sweep records one)."""
    return None if _last_sweep_dispatch is None \
        else dict(_last_sweep_dispatch)


def _record_sweep_dispatch(**fields) -> None:
    """Write the marker, adding one to ``count``."""
    global _last_sweep_dispatch
    prior = 0 if _last_sweep_dispatch is None \
        else _last_sweep_dispatch.get("count", 0)
    _last_sweep_dispatch = {**fields, "count": prior + 1}


def _reset_sweep_dispatch() -> None:
    """Clear the marker (a test helper)."""
    global _last_sweep_dispatch
    _last_sweep_dispatch = None


# --------------------------------------------------------------- estimators
@dataclasses.dataclass(frozen=True)
class Estimator:
    """Base class: how selected values become estimates."""

    name: ClassVar[str] = "weighted_point"

    @staticmethod
    def estimate_stage(cpi, valid, weights, truth):
        """Tables -> estimates: ``(estimate, err_pct)`` per (app, config)
        lane, from the covered-weight-renormalized weighted mean."""
        t = _tables.sweep_point_tables(cpi, valid, weights)
        est = _tables.stratified_mean(t)
        return est, 100.0 * torch.abs(est - truth) / truth

    def sweep_estimates(self, cpi, valid, weights, truth, *,
                        precision=None) -> tuple[torch.Tensor, torch.Tensor]:
        """(A, C) estimates and percent errors on the device.

        ``cpi (A, C, L)`` selected-unit CPI, ``valid (A, L)``,
        ``weights (A, L)``, ``truth (A, C)``. ``precision`` overrides the
        default ``PrecisionPolicy.host_parity`` (float64).
        """
        from ..precision import PrecisionPolicy

        pp = precision if precision is not None \
            else PrecisionPolicy.host_parity()
        dt = pp.trace_dtype
        out = self.estimate_stage(cpi.to(dt), valid.bool(), weights.to(dt),
                                  truth.to(dt))
        _record_sweep_dispatch(
            batch_shape=tuple(cpi.shape[:-1]), num_strata=int(cpi.shape[-1]),
            x64=dt == torch.float64, backend=cpi.device.type, fused=False,
            in_place=False, captured=False)
        return out


@dataclasses.dataclass(frozen=True)
class WeightedPoint(Estimator):
    """SimPoint-style weighted point estimate (eq. 3 mean, no interval)."""

    name: ClassVar[str] = "weighted_point"


@dataclasses.dataclass(frozen=True)
class CollapsedPairsCI(Estimator):
    """One-unit-per-stratum interval by pairwise collapsed strata (paper
    eq. 4), over ``tables.collapsed_pairs_variance``."""

    name: ClassVar[str] = "collapsed_pairs"

    confidence: float = 0.95

    def interval(self, y_sorted, w_sorted, n_valid, *, num_strata: int):
        """``(variance, df, half_width)`` lane-wise, occupied strata first
        in key order (see ``tables.collapsed_pairs_variance``); the
        critical values come from the host."""
        var, df = _tables.collapsed_pairs_variance(
            y_sorted, w_sorted, n_valid, num_strata=num_strata)
        crit = torch.as_tensor(
            critical_values(self.confidence, _host(df)), dtype=var.dtype,
            device=var.device)
        return var, df, crit * torch.sqrt(var)

    def estimate(self, y_per_stratum, weights, *, order_by=None,
                 strict: bool = False) -> Estimate:
        """Scalar ``Estimate`` for one design."""
        from .collapsed import collapsed_strata_estimate
        return collapsed_strata_estimate(
            y_per_stratum, weights, order_by=order_by,
            confidence=self.confidence, strict=strict)


@dataclasses.dataclass(frozen=True)
class TwoPhaseCI(Estimator):
    """Multi-unit two-phase interval (paper eq. 5/6 with Satterthwaite's
    df), over ``tables.two_phase_variance``."""

    name: ClassVar[str] = "two_phase"

    confidence: float = 0.95
    formula: str = "phase2_only"

    def estimate(self, tables: _tables.StratumTables, phase1_n: int, *,
                 phase1_var: Optional[float] = None,
                 strict: bool = False) -> Estimate:
        """Scalar ``Estimate`` from one-lane tables (the
        ``TwoPhaseFlow.ci_check`` view)."""
        from .two_phase import two_phase_estimate_tables
        return two_phase_estimate_tables(
            tables, phase1_n, phase1_var=phase1_var,
            confidence=self.confidence, formula=self.formula, strict=strict)


# --------------------------------------------------------------------- plan
@dataclasses.dataclass(frozen=True)
class SamplingPlan:
    """A complete sampling design: stratifier x policy x estimator."""

    stratifier: Stratifier
    policy: SelectionPolicy = Centroid()
    estimator: Estimator = WeightedPoint()

    @classmethod
    def from_strings(cls, scheme: str, policy: str = "centroid",
                     **params) -> "SamplingPlan":
        """Resolve registered names into a plan."""
        return cls(stratifier=make_stratifier(scheme, **params),
                   policy=make_policy(policy, **params))

    @property
    def scheme(self) -> str:
        """The stratifier's registered name (sweep-row label)."""
        return type(self.stratifier).name

    @property
    def policy_name(self) -> str:
        """The selection policy's registered name (sweep-row label)."""
        return type(self.policy).name


def trial_scheme_index(scheme: str, canonical: Sequence[str]) -> int:
    """Stable PRNG fold-in index of a trial scheme: its position among
    the canonical schemes, else a crc32 of its name past that range (so
    no scheme's draws depend on registration order)."""
    canonical = tuple(canonical)
    if scheme in canonical:
        return canonical.index(scheme)
    return len(canonical) + zlib.crc32(scheme.encode()) % (2 ** 20)


def warn_string_dispatch(where: str, repl: str) -> None:
    """One ``DeprecationWarning`` for a legacy string shim
    (``SweepSpec(scheme=...)``, ``TwoPhaseFlow.stratify(scheme=...)``,
    ...), naming the replacement."""
    warnings.warn(
        f"{where} with scheme/policy strings is deprecated; {repl}",
        DeprecationWarning, stacklevel=3)
