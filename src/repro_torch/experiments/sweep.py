"""Declarative sweeps: ``SweepSpec`` -> results table.

Counterpart of ``repro.experiments.sweep``. A sweep is the cross product
(apps x configs) for one estimation scheme:

* ``plan=None`` — the phase-1 simple-random-sample estimate per config
  (paper Fig 5), with its 95 % margin;
* ``plan=SamplingPlan(...)`` — stratified selection (paper Figs 10/11):
  one unit per stratum, CPI for every requested config, weighted by the
  stratum weights.

Stratified sweeps run as one fused program by default
(``repro_torch.experiments.fused``: selection, the memo update and the
estimates in one CUDA graph on the card); ``fused=False`` runs the staged
chain — ``plan_selection_bank``, one batched ``MemoBank.fill``, the
estimator — which gives the same results bit for bit. ``SweepSpec.trials``
attaches a Monte-Carlo study (``TrialSpec``): rows at its config gain the
p95 |error|, the mean CI half-width and the coverage.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.sampling import plan as sampling_plan
from ..core.sampling import tables as sampling_tables
from ..core.sampling.types import critical_values
from ..simcpu import APP_NAMES
from .engine import ExperimentEngine, plan_selection_bank

__all__ = ["SRS_SCHEME", "SweepSpec", "SweepRow", "ResultsTable",
           "assemble_rows", "run_sweep", "known_schemes"]

SRS_SCHEME = "srs"


def known_schemes() -> tuple[str, ...]:
    """Scheme names a sweep can run: ``"srs"`` plus every registered
    stratifier."""
    return (SRS_SCHEME,) + sampling_plan.registered_stratifiers()


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One sweep = apps x configs for one sampling plan (``None``: SRS).

    ``SweepSpec(plan=SamplingPlan(...))`` is the modern spelling;
    ``scheme``/``policy`` then carry the plan's registered names as row
    labels (stale strings beside a plan raise). The legacy spelling
    ``SweepSpec(scheme="rfv", policy="centroid")`` resolves the names
    through the registry when the spec is made, so unknown names raise
    there, and warns (``DeprecationWarning``); ``scheme="srs"`` is the
    plan-less phase-1 estimate and takes no policy.

    ``fused=True`` (the default) runs a stratified sweep as one program;
    ``fused=False`` runs the staged selection -> fill -> estimate chain.
    ``selection_seed`` seeds ``RandomUnit``'s draw; ``trials`` attaches a
    Monte-Carlo study whose config must be among ``config_indices``.
    """

    apps: tuple[str, ...] = tuple(APP_NAMES)
    scheme: str = SRS_SCHEME
    policy: Optional[str] = None
    plan: Optional[sampling_plan.SamplingPlan] = None
    config_indices: Optional[tuple[int, ...]] = None
    selection_seed: int = 0
    fused: bool = True
    trials: Optional["TrialSpec"] = None     # noqa: F821

    def __post_init__(self):
        if self.plan is not None:
            if self.scheme not in (SRS_SCHEME, self.plan.scheme) \
                    or self.policy not in (None, self.plan.policy_name):
                raise ValueError(
                    f"scheme={self.scheme!r}/policy={self.policy!r} "
                    f"conflict with plan="
                    f"({self.plan.scheme!r}, {self.plan.policy_name!r}); "
                    "drop the strings when passing plan=")
            object.__setattr__(self, "scheme", self.plan.scheme)
            object.__setattr__(self, "policy", self.plan.policy_name)
        elif self.scheme != SRS_SCHEME:
            sampling_plan.warn_string_dispatch(
                "SweepSpec(scheme=..., policy=...)",
                "pass SweepSpec(plan=SamplingPlan.from_strings(...))")
            # aliases (e.g. "cpi") normalize to the canonical name
            object.__setattr__(self, "plan", sampling_plan.SamplingPlan
                               .from_strings(self.scheme,
                                             self.policy or "centroid"))
            object.__setattr__(self, "scheme", self.plan.scheme)
            object.__setattr__(self, "policy", self.plan.policy_name)
        elif self.policy is not None:
            raise ValueError(
                "scheme='srs' takes no selection policy (phase-1 SRS has "
                "no strata to select from)")
        if (self.trials is not None and self.config_indices is not None
                and self.trials.config_index not in self.config_indices):
            raise ValueError(
                f"trials.config_index={self.trials.config_index} is not in "
                f"config_indices={self.config_indices}; the Monte-Carlo "
                "study would run (and charge the ledger) with its result "
                "attached to no row")


@dataclasses.dataclass(frozen=True)
class SweepRow:
    """One (app, config) result row of a sweep's ``ResultsTable``."""

    app: str
    scheme: str
    config_index: int
    estimate: float       # estimated mean CPI
    truth: float          # census mean CPI
    err_pct: float        # 100 * |estimate - truth| / truth
    n_units: int          # regions the estimate is built from
    margin_pct: Optional[float] = None   # 95% margin (srs scheme only)
    p95_err_pct: Optional[float] = None  # Monte-Carlo p95 |error| (trials)
    ci_half_pct: Optional[float] = None  # Monte-Carlo mean CI half-width, %
    coverage: Optional[float] = None     # Monte-Carlo empirical CI coverage


class ResultsTable:
    """Thin list-of-rows wrapper with filter/column helpers."""

    def __init__(self, rows: Sequence[SweepRow]):
        self.rows = list(rows)

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    def filter(self, **fields) -> "ResultsTable":
        """Rows whose attributes equal every ``field=value`` given."""
        return ResultsTable([
            r for r in self.rows
            if all(getattr(r, k) == v for k, v in fields.items())])

    def column(self, field: str) -> np.ndarray:
        """(len(rows),) array of one ``SweepRow`` field, in row order."""
        return np.asarray([getattr(r, field) for r in self.rows])

    def matrix(self, field: str = "estimate") -> np.ndarray:
        """(C, A) matrix of ``field`` over config x app, in spec order."""
        configs = list(dict.fromkeys(r.config_index for r in self.rows))
        apps = list(dict.fromkeys(r.app for r in self.rows))
        out = np.full((len(configs), len(apps)), np.nan)
        ci = {c: i for i, c in enumerate(configs)}
        ai = {a: j for j, a in enumerate(apps)}
        for r in self.rows:
            out[ci[r.config_index], ai[r.app]] = getattr(r, field)
        return out

    def to_csv(self) -> str:
        """The table as CSV text: a header and one line per row; the
        optional margin, p95, half-width and coverage cells are empty
        where absent."""
        def opt(v):
            return "" if v is None else f"{v:.4f}"

        lines = ["app,scheme,config_index,estimate,truth,err_pct,n_units,"
                 "margin_pct,p95_err_pct,ci_half_pct,coverage"]
        for r in self.rows:
            lines.append(f"{r.app},{r.scheme},{r.config_index},"
                         f"{r.estimate:.6f},{r.truth:.6f},{r.err_pct:.4f},"
                         f"{r.n_units},{opt(r.margin_pct)},"
                         f"{opt(r.p95_err_pct)},{opt(r.ci_half_pct)},"
                         f"{opt(r.coverage)}")
        return "\n".join(lines)


def _srs_stats(cpi: torch.Tensor, valid: torch.Tensor
               ) -> tuple[np.ndarray, np.ndarray]:
    """(A, C) SRS means and 95 % margins (percent) over an (A, C, K)
    masked CPI stack."""
    mean, v_mean, n = sampling_tables.masked_srs_stats(
        cpi.double(), valid[:, None, :])
    mean, v_mean, n = (t.cpu().numpy() for t in (mean, v_mean, n))
    crit = critical_values(0.95, np.where(n < 30, n - 1.0, np.inf))
    margin = crit * np.sqrt(v_mean)
    return mean, 100.0 * margin / np.abs(mean)


def _warn_partial_coverage(spec: SweepSpec, valid: np.ndarray,
                           weights: np.ndarray) -> None:
    """Warn when selected units cover only part of the stratum weight."""
    covered = np.where(valid, weights, 0.0).sum(axis=1)
    low = covered < weights.sum(axis=1) * (1.0 - 1e-6)
    if low.any():
        bad = [spec.apps[a] for a in np.flatnonzero(low)]
        warnings.warn(
            f"selected units cover only part of the stratum weight for "
            f"{bad}; renormalizing biases those estimates",
            UserWarning, stacklevel=3)


def assemble_rows(spec: SweepSpec, cfg_is: Sequence[int], ests, errs,
                  n_units, truth, *, margins=None, p95=None, ci_half=None,
                  cov=None) -> ResultsTable:
    """(A, C) result arrays -> rows in spec order (apps outer, configs
    inner), each value a plain Python number; the Monte-Carlo columns
    attach only to rows at ``spec.trials.config_index``."""
    rows: list[SweepRow] = []
    for a, name in enumerate(spec.apps):
        for pos, ci in enumerate(cfg_is):
            at_trial_cfg = (spec.trials is not None
                            and spec.trials.config_index == ci)
            rows.append(SweepRow(
                app=name, scheme=spec.scheme, config_index=ci,
                estimate=float(ests[a, pos]), truth=float(truth[a, pos]),
                err_pct=float(errs[a, pos]), n_units=int(n_units[a]),
                margin_pct=(float(margins[a, pos])
                            if margins is not None else None),
                p95_err_pct=float(p95[a]) if at_trial_cfg else None,
                ci_half_pct=float(ci_half[a]) if at_trial_cfg else None,
                coverage=float(cov[a]) if at_trial_cfg else None))
    return ResultsTable(rows)


def run_sweep(engine: ExperimentEngine, spec: SweepSpec,
              mesh=None) -> ResultsTable:
    """Execute one sweep over all apps x requested configs (only those are
    simulated and ledger-charged): the fused program by default, the
    staged chain with ``fused=False``; then the attached trials, if
    any. ``mesh`` (default: the engine's) shards the app axis of the
    memo fills, the fused program and the trials."""
    mesh = engine.mesh if mesh is None else mesh
    exps = engine.build(spec.apps)
    stack = engine.stack(spec.apps)
    cfg_is = (tuple(range(len(engine.configs)))
              if spec.config_indices is None else spec.config_indices)
    cfgs = tuple(engine.configs[i] for i in cfg_is)
    truth = stack.truth[:, list(cfg_is)]                      # (A, C')
    truth_np = truth.cpu().numpy()
    margins = None

    if spec.plan is None:                                    # phase-1 SRS
        cpi, _ = engine.memo.fill(stack.rows, stack.idx1, stack.idx1_valid,
                                  cfgs, feats=stack.gather_feats(stack.idx1),
                                  mesh=mesh)
        ests, margins = _srs_stats(cpi, stack.idx1_valid)
        errs = 100.0 * np.abs(ests - truth_np) / truth_np
        n_units = stack.idx1_valid.sum(dim=1).cpu().numpy()
    elif spec.fused:                                 # one fused program
        from .fused import run_fused_sweep
        ests, errs, valid, weights = run_fused_sweep(
            engine, spec, exps, stack, cfgs, truth, mesh=mesh)
    else:                                          # staged reference chain
        picks, valid, weights = plan_selection_bank(
            exps, spec.plan, seed=spec.selection_seed,
            backend=engine.backend)
        cpi, _ = engine.memo.fill(stack.rows, picks, valid, cfgs,
                                  feats=stack.gather_feats(picks), mesh=mesh)
        ests, errs = spec.plan.estimator.sweep_estimates(
            cpi, valid, weights, truth, precision=engine.precision)
    if spec.plan is not None:
        _warn_partial_coverage(spec, valid.cpu().numpy(),
                               weights.cpu().numpy())
        ests, errs = ests.cpu().numpy(), errs.cpu().numpy()
        n_units = valid.sum(dim=1).cpu().numpy()

    p95 = ci_half = cov = None
    if spec.trials is not None:
        from .montecarlo import SRS_DRAWS, run_trials
        mc_scheme = SRS_DRAWS if spec.plan is None else spec.scheme
        strats = None if spec.plan is None \
            else {mc_scheme: spec.plan.stratifier}
        mc = run_trials(engine,
                        dataclasses.replace(spec.trials,
                                            schemes=(mc_scheme,)),
                        apps=spec.apps, mesh=mesh, stratifiers=strats)
        p95 = mc.p95(mc_scheme)
        mc_truth = stack.truth[:, spec.trials.config_index].cpu().numpy()
        ci_half = mc.half_width_pct(mc_scheme, mc_truth)
        cov = mc.coverage[mc_scheme]
    return assemble_rows(spec, cfg_is, ests, errs, n_units, truth_np,
                         margins=margins, p95=p95, ci_half=ci_half, cov=cov)
