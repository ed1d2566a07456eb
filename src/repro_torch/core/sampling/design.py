"""End-to-end two-phase sampling flow (paper Fig. 14, Section VI.A).

Counterpart of ``repro.core.sampling.design``. Steps:

  1. initial characterization: a large SRS measured on the baseline
     configuration;
  2. RFVs (and the CPI distribution) from the phase-1 runs;
  3. stratify (k-means on standardized RFVs through the clustering
     kernels, or another ``Stratifier``) and pick units per stratum;
  4. day-to-day studies reuse the picked units (4a); periodic CI checks
     sample several units per stratum and apply the two-phase formulas
     (4b).

The caller supplies the ``measure`` callables (indices -> per-region study
values), so the flow runs on any substrate. Indices reach them as int64
tensors on the flow's device; the values may come back as tensors or
numpy arrays. Random draws come from the flow's ``np.random.Generator``,
as in the reference, so a seed draws the same units.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ...device import resolve_device
from . import plan as _plan
from . import tables as _tables
from .selection import weighted_point_estimate
from .srs import draw_srs, srs_estimate
from .types import Estimate

__all__ = ["Stratification", "TwoPhaseFlow"]


def _tensor(x, device=None) -> Optional[torch.Tensor]:
    if x is None:
        return None
    t = torch.as_tensor(x)
    return t if device is None else t.to(device)


@dataclasses.dataclass
class Stratification:
    """Frozen phase-1 artifact reused across configuration studies.

    Fields may be given as numpy arrays or tensors (a reference
    ``Stratification``'s arrays carry across as they are); they are held
    as tensors.
    """

    labels: torch.Tensor               # per phase-1 unit
    weights: torch.Tensor              # W_h from the phase-1 proportions
    centroids: Optional[torch.Tensor]
    features: Optional[torch.Tensor]   # the features the strata came from
    phase1_indices: torch.Tensor       # population indices of the units
    phase1_baseline_y: torch.Tensor    # baseline-config y of the units
    scheme: str

    def __post_init__(self):
        for f in ("labels", "weights", "centroids", "features",
                  "phase1_indices", "phase1_baseline_y"):
            setattr(self, f, _tensor(getattr(self, f)))

    @property
    def num_strata(self) -> int:
        return int(self.weights.shape[0])

    def to(self, device) -> "Stratification":
        """The same stratification with every tensor on ``device``."""
        return Stratification(**{
            f.name: (_tensor(getattr(self, f.name), device)
                     if f.name != "scheme" else self.scheme)
            for f in dataclasses.fields(self)})

    def stratum_order_key(self) -> torch.Tensor:
        """(L,) float64 per-stratum baseline mean (+inf where empty): the
        paper's collapsed-strata pairing key ("ordering the strata based
        on CPI for Config 0"), taken in numpy's order as the reference
        takes it."""
        lab = self.labels.cpu().numpy()
        base = self.phase1_baseline_y.cpu().numpy()
        out = np.zeros(self.num_strata)
        for h in range(self.num_strata):
            m = lab == h
            out[h] = base[m].mean() if m.any() else np.inf
        return torch.as_tensor(out, device=self.labels.device)


@dataclasses.dataclass
class TwoPhaseFlow:
    """The recommended methodology, step by step.

    ``population_size``: number of regions in the application; ``rng``:
    the generator of every random draw; ``device``: where the flow's
    tensors live (the card when None).
    """

    population_size: int
    rng: np.random.Generator
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device, what="TwoPhaseFlow")

    def _indices(self, idx) -> torch.Tensor:
        return torch.as_tensor(idx).to(self.device, torch.int64).reshape(-1)

    # -- Step 1: initial characterization ------------------------------------
    def characterize(self, measure_baseline: Callable, n_phase1: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                Estimate]:
        """Draw the phase-1 SRS and measure it: returns ``(indices,
        baseline y, features, SRS estimate)``."""
        idx = self._indices(draw_srs(self.rng, self.population_size,
                                     n_phase1))
        y0, feats = measure_baseline(idx)
        y0 = _tensor(y0, self.device)
        return idx, y0, _tensor(feats, self.device), \
            srs_estimate(y0.cpu().numpy())

    # -- Step 3: stratify + select -------------------------------------------
    def stratify(self, phase1_indices, phase1_baseline_y, features, *,
                 num_strata: Optional[int] = None,
                 scheme: Union[str, "_plan.Stratifier"] = "rfv",
                 seed: Optional[int] = None,
                 kmeans_backend: Optional[str] = None) -> Stratification:
        """Stratify the phase-1 sample under a ``Stratifier``.

        ``scheme`` is a ``Stratifier`` object (``RFVClusters``,
        ``BBVClusters``, ``DaleniusGurney`` or a registry plug-in) that
        owns its parameters: a ``num_strata`` / ``seed`` /
        ``kmeans_backend`` keyword that conflicts with the object raises.
        A string (``'rfv'`` | ``'bbv'`` | ``'cpi'``/``'dg'``) is
        deprecated: it resolves through the registry, the keywords
        parameterizing the object, and warns.
        """
        if isinstance(scheme, str):
            _plan.warn_string_dispatch(
                "TwoPhaseFlow.stratify(scheme=...)",
                "pass a Stratifier object (e.g. RFVClusters(num_strata=20))")
            if num_strata is None:
                raise ValueError("string schemes need num_strata")
            scheme = _plan.make_stratifier(
                scheme, num_strata=num_strata, seed=seed or 0,
                backend=kmeans_backend or "auto")
        else:
            for arg, field, val in (("num_strata", "num_strata", num_strata),
                                    ("seed", "seed", seed),
                                    ("kmeans_backend", "backend",
                                     kmeans_backend)):
                if val is not None and getattr(scheme, field, None) != val:
                    raise ValueError(
                        f"{arg}={val!r} conflicts with the Stratifier "
                        f"object ({field}="
                        f"{getattr(scheme, field, None)!r}); configure "
                        "the Stratifier instead")
        y0 = _tensor(phase1_baseline_y, self.device)
        labels, centroids, feats = scheme.fit(
            y0, _tensor(features, self.device))
        counts = torch.bincount(labels.long(),
                                minlength=scheme.num_strata).double()
        return Stratification(
            labels=labels, weights=counts / counts.sum(),
            centroids=centroids, features=feats,
            phase1_indices=_tensor(phase1_indices, self.device),
            phase1_baseline_y=y0, scheme=type(scheme).name)

    def select(self, strat: Stratification, *,
               policy: Union[str, "_plan.SelectionPolicy"] = "centroid",
               per_stratum: Optional[int] = None,
               seed: int = 0) -> list[torch.Tensor]:
        """Population indices of the selected regions, one tensor per
        stratum. ``policy`` is a ``SelectionPolicy`` object (``Centroid``,
        ``StratumMean``, ``RandomUnit(per_stratum=...)``,
        ``RankedSetUnit`` or a plug-in); ``per_stratum`` overrides its own
        setting when given. A string is deprecated and warns."""
        if isinstance(policy, str):
            _plan.warn_string_dispatch(
                "TwoPhaseFlow.select(policy=...)",
                "pass a SelectionPolicy object (e.g. Centroid())")
            policy = _plan.make_policy(policy, per_stratum=per_stratum or 1)
        strat = strat.to(self.device)
        local = policy.select_local(
            strat.labels, features=strat.features,
            centroids=strat.centroids, baseline=strat.phase1_baseline_y,
            num_strata=strat.num_strata, seed=seed, per_stratum=per_stratum)
        return [strat.phase1_indices[lo.to(self.device)] for lo in local]

    # -- Step 4a: day-to-day point estimate ----------------------------------
    def point_estimate(self, strat: Stratification,
                       selected: Sequence[torch.Tensor],
                       measure: Callable) -> float:
        """Weighted mean of ``measure`` over the selected units (one
        measurement call for all of them)."""
        sel = [self._indices(s) for s in selected]
        y = _tensor(measure(torch.cat([s for s in sel if s.numel()])))
        per_stratum, off = [], 0
        for s in sel:
            per_stratum.append(torch.arange(off, off + s.numel()))
            off += s.numel()
        return weighted_point_estimate(per_stratum, y.cpu(),
                                       strat.weights.cpu())

    def collapsed_ci(self, strat: Stratification,
                     selected: Sequence[torch.Tensor], measure: Callable, *,
                     confidence: float = 0.95) -> Estimate:
        """The practical one-unit-per-stratum CI (paper V.A.3, Fig 9): the
        plan-level ``CollapsedPairsCI`` view."""
        y_h = [float(_tensor(measure(self._indices(s))).reshape(-1)[0])
               for s in selected]
        return _plan.CollapsedPairsCI(confidence=confidence).estimate(
            y_h, strat.weights, order_by=strat.stratum_order_key())

    # -- Step 4b: periodic multi-unit CI check -------------------------------
    def ci_check(self, strat: Stratification, measure: Callable, *,
                 per_stratum_sizes, confidence: float = 0.95,
                 seed: int = 0) -> Estimate:
        """Stratified multi-unit sample and two-phase CI (paper eq. 5/6).

        Units are drawn per stratum from ``default_rng(seed)`` as the
        reference draws them. Strata with fewer than 2 sampled units are
        merged into their neighbour in baseline-CPI order (paper fn. 7,
        ``tables.collapse_small_strata``), then the plan-level
        ``TwoPhaseCI`` estimates.
        """
        rng = np.random.default_rng(seed)
        lab = strat.labels.cpu().numpy()
        pool_all = strat.phase1_indices.cpu().numpy()
        sizes = np.asarray(_plan._host(per_stratum_sizes))
        ys, labs = [], []
        for h in range(strat.num_strata):
            pool = pool_all[lab == h]
            k = int(min(sizes[h], pool.size))
            if k == 0:
                continue
            chosen = rng.choice(pool, size=k, replace=False)
            ys.append(_tensor(measure(self._indices(chosen)))
                      .reshape(-1).double().cpu())
            labs.append(torch.full((k,), h, dtype=torch.int64))
        y = torch.cat(ys) if ys else torch.empty(0, dtype=torch.float64)
        labels = torch.cat(labs) if labs else torch.empty(0,
                                                          dtype=torch.int64)
        t = _tables.stratum_tables(y, labels, weights=strat.weights.cpu(),
                                   num_strata=strat.num_strata)
        merged, _, n_groups = _tables.collapse_small_strata(
            t, strat.stratum_order_key().cpu())
        if int(n_groups) < 1:
            raise ValueError("ci_check needs at least 2 sampled units")
        return _plan.TwoPhaseCI(confidence=confidence).estimate(
            merged, phase1_n=int(strat.phase1_indices.numel()))
