"""Declarative sweeps: ``SweepSpec`` -> results table.

Counterpart of ``repro.experiments.sweep`` for the staged path. A sweep
is the cross product (apps x configs) for one estimation scheme:

* ``plan=None`` — the phase-1 simple-random-sample estimate per config
  (paper Fig 5), with its 95 % margin;
* ``plan=SamplingPlan(...)`` — stratified selection (paper Figs 10/11):
  one unit per stratum, CPI for every requested config, weighted by the
  stratum weights.

Selection runs over the whole app stack at once, the picked regions of
all apps are simulated through the engine's memo bank in one batched
fill, and the estimates come off the device ready-made; Python only
assembles the rows.
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
           "assemble_rows", "run_sweep"]

SRS_SCHEME = "srs"


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One sweep = apps x configs for one sampling plan (``None``: SRS).

    ``fused=True`` (the reference's default) asks for the one-program
    fused sweep, which a later slice of the port brings; until then it
    raises, and ``fused=False`` runs the staged selection -> fill ->
    estimate chain.
    """

    apps: tuple[str, ...] = tuple(APP_NAMES)
    plan: Optional[sampling_plan.SamplingPlan] = None
    config_indices: Optional[tuple[int, ...]] = None
    fused: bool = True

    @property
    def scheme(self) -> str:
        """Row label: ``"srs"`` or the plan's stratifier name."""
        return SRS_SCHEME if self.plan is None else self.plan.scheme



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


class ResultsTable:
    """Thin list-of-rows wrapper with filter/column helpers."""

    def __init__(self, rows: Sequence[SweepRow]):
        self.rows = list(rows)

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

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
                  n_units, truth, *, margins=None) -> ResultsTable:
    """(A, C) result arrays -> rows in spec order (apps outer, configs
    inner), each value a plain Python number."""
    rows: list[SweepRow] = []
    for a, name in enumerate(spec.apps):
        for pos, ci in enumerate(cfg_is):
            rows.append(SweepRow(
                app=name, scheme=spec.scheme, config_index=ci,
                estimate=float(ests[a, pos]), truth=float(truth[a, pos]),
                err_pct=float(errs[a, pos]), n_units=int(n_units[a]),
                margin_pct=(float(margins[a, pos])
                            if margins is not None else None)))
    return ResultsTable(rows)


def run_sweep(engine: ExperimentEngine, spec: SweepSpec) -> ResultsTable:
    """Execute one sweep over all apps x requested configs (only those are
    simulated and ledger-charged)."""
    if spec.plan is not None and spec.fused:
        raise NotImplementedError(
            "the fused sweep program is not ported yet (a later slice of "
            "the port, after this staged path); pass SweepSpec(fused=False)")
    exps = engine.build(spec.apps)
    stack = engine.stack(spec.apps)
    cfg_is = (tuple(range(len(engine.configs)))
              if spec.config_indices is None else spec.config_indices)
    cfgs = tuple(engine.configs[i] for i in cfg_is)
    truth = stack.truth[:, list(cfg_is)]                      # (A, C')

    if spec.plan is None:                                    # phase-1 SRS
        cpi, _ = engine.memo.fill(stack.rows, stack.idx1, stack.idx1_valid,
                                  cfgs, feats=stack.gather_feats(stack.idx1))
        ests, margins = _srs_stats(cpi, stack.idx1_valid)
        truth_np = truth.cpu().numpy()
        errs = 100.0 * np.abs(ests - truth_np) / truth_np
        n_units = stack.idx1_valid.sum(dim=1).cpu().numpy()
    else:                                          # staged reference chain
        picks, valid, weights = plan_selection_bank(exps, spec.plan,
                                                    backend=engine.backend)
        cpi, _ = engine.memo.fill(stack.rows, picks, valid, cfgs,
                                  feats=stack.gather_feats(picks))
        _warn_partial_coverage(spec, valid.cpu().numpy(),
                               weights.cpu().numpy())
        ests, errs = spec.plan.estimator.sweep_estimates(
            cpi, valid, weights, truth, precision=engine.precision)
        ests, errs = ests.cpu().numpy(), errs.cpu().numpy()
        margins = None
        n_units = valid.sum(dim=1).cpu().numpy()
        truth_np = truth.cpu().numpy()
    return assemble_rows(spec, cfg_is, ests, errs, n_units, truth_np,
                         margins=margins)
