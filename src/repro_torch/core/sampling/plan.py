"""Composable sampling plans: stratifier x selection policy x estimator.

Counterpart of the part of ``repro.core.sampling.plan`` that the staged
sweep runs. A ``SamplingPlan`` is three frozen dataclasses:

* a ``Stratifier`` (``BBVClusters`` / ``RFVClusters`` /
  ``DaleniusGurney``) whose ``resolve`` stacks the engine-built
  stratification of each app into one ``StratumBank``;
* a ``SelectionPolicy`` (``Centroid``, ``StratumMean``, ``RandomUnit``)
  — a batched callable mapping a ``SelectionContext`` to one pick per
  stratum per app;
* an ``Estimator`` (``WeightedPoint``) turning the picked units' CPI into
  sweep estimates on the device.

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
import zlib
from typing import Callable, ClassVar, Optional, Sequence

import numpy as np
import torch

from . import tables as _tables

__all__ = [
    "SamplingPlan", "Stratifier", "SelectionPolicy", "Estimator",
    "BBVClusters", "RFVClusters", "DaleniusGurney",
    "Centroid", "StratumMean", "RandomUnit", "WeightedPoint",
    "StratumBank", "SelectionContext", "build_selection_context",
    "register_stratifier", "register_policy",
    "registered_stratifiers", "registered_policies",
    "make_stratifier", "make_policy", "stack_ragged_tensors",
    "trial_scheme_index", "last_sweep_dispatch",
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
    ``StratumBank``. ``pool_kind`` says where its units come from: the
    census (free) or the charged phase-1 sample.
    """

    name: ClassVar[str] = "?"
    pool_kind: ClassVar[str] = "phase1"

    def resolve(self, exps: Sequence) -> StratumBank:
        """Stack this stratifier's engine-built artifacts over apps."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class BBVClusters(Stratifier):
    """SimPoint-style strata: k-means on projected BBVs over the full
    population."""

    name: ClassVar[str] = "bbv"
    pool_kind: ClassVar[str] = "census"

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


def build_selection_context(bank: StratumBank, *, summarize: Callable,
                            seed: int = 0,
                            uniforms: Optional[torch.Tensor] = None
                            ) -> SelectionContext:
    """Selection context for a ``StratumBank``: ONE stratum-summary
    dispatch serves the counts, the stratum-mean baselines and, for banks
    without centroids, the Dalenius-Gurney centroids.

    ``summarize(labels, valid, L, values) -> (sums, counts)`` is the
    engine's ``segment_stats``-backed summary. ``seed`` seeds
    ``RandomUnit``'s host draw unless ``uniforms`` carries it.
    """
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


@dataclasses.dataclass(frozen=True)
class Centroid(SelectionPolicy):
    """SimPoint-style selection: the member nearest its stratum centroid."""

    name: ClassVar[str] = "centroid"

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


register_policy("centroid", Centroid)
register_policy("mean", StratumMean)
register_policy("random", RandomUnit)


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
