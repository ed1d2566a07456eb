"""Paper-figure and table reproductions on the port (one function each).

Counterpart of the reference repository's ``benchmarks/paper_figs.py``:
the same functions under the same names, printing the same
``name,value,derived`` rows and returning the same dicts (floats as
Python floats, integers as ints). Each takes the ``ExperimentEngine`` as
its first argument instead of a process-wide one, and ``apps`` (default:
the ten paper apps).

The device work — builds, sweeps, trials, k-means fits, memo fills —
runs on the engine's device through its kernel route (``engine.backend``:
``"auto"`` launches the kernels on the card, ``"plain"`` their plain
versions). The host analysis of the results (dispersion, margins, KS
distances, per-stratum moments) is the reference's numpy code on host
copies, so shared inputs give the reference's numbers.

Run on the card:

    python -c "import sys; sys.path.insert(0, 'src'); \\
      from repro_torch.experiments import ExperimentEngine, paper_figs; \\
      paper_figs.run_all(ExperimentEngine())"

``compare`` holds one run's dicts against another's (or against the
reference's numbers committed in ``paper_figs_reference.json``).
"""

from __future__ import annotations

import hashlib
import json
import math
import pathlib
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.clustering import Standardizer, kmeans
from ..core.sampling import (Estimate, SamplingPlan, StratumSummary,
                             collapsed_strata_estimate,
                             phase2_sizes_for_margin, select_centroid,
                             srs_estimate)
from ..simcpu import APP_NAMES, CONFIGS, evaluate_regions_approx
from .engine import NUM_STRATA, plan_selection, plan_selection_bank
from .montecarlo import TrialSpec, run_trials
from .sweep import SweepSpec, run_sweep

__all__ = ["FIGURES", "bench_cpi_distributions", "bench_config_sweep",
           "bench_ci_analytical", "bench_ci_empirical", "bench_ci_collapsed",
           "bench_selection_centroid", "bench_selection_mean",
           "bench_distribution_approx", "bench_two_phase_sizing",
           "bench_gcc_cluster_sensitivity", "bench_approx_phase1",
           "bench_isa_features", "run_figure", "run_all",
           "selection_record", "fit_summary", "pick_ties", "fits_behind",
           "explain", "FIT_TAGS", "to_jsonable", "compare",
           "REFERENCE_JSON", "load_reference"]

REFERENCE_JSON = pathlib.Path(__file__).with_name(
    "paper_figs_reference.json")
GCC = "502.gcc_r"


def _row(name: str, value, derived: str = "") -> None:
    print(f"{name},{value},{derived}", flush=True)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _apps(apps: Optional[Sequence[str]]) -> list[str]:
    return list(apps or APP_NAMES)


def _fit_record(record: Optional[dict], key: tuple, z, km, local) -> None:
    """Keep a figure's k-means fit (points, labels, centroids; seed 0)
    and its centroid picks (``local``: one index tensor per
    stratum) for holding one route's or package's fits against
    another's."""
    if record is not None:
        record["/".join(map(str, key))] = {
            "z": z, "labels": km.labels, "centroids": km.centroids,
            "picks": [int(lo[0]) if lo.numel() else -1 for lo in local]}


def _zscore(features: torch.Tensor) -> torch.Tensor:
    """The reference's ``Standardizer.fit_transform``: a float64 fit
    applied to the float32 features."""
    return Standardizer.fit(features).transform(features.float())


# --------------------------------------------------------------------- Fig 1/6
def bench_cpi_distributions(engine, apps=None) -> dict:
    """Fig 1 + Fig 6: CPI dispersion per app; aggregation over longer
    regions (10M/100M instructions = means of 10/100 consecutive 1M
    regions) lowers dispersion."""
    t0 = time.time()
    out = {}
    for exp in engine.apps(_apps(apps)):
        cpi = _np(exp.census(0))
        cvs = []
        for agg in (1, 10, 100):
            n = (cpi.shape[0] // agg) * agg
            c = cpi[:n].reshape(-1, agg).mean(axis=1)
            cvs.append(float(c.std() / c.mean()))
        out[exp.name] = cvs
        _row(f"fig1_cv_{exp.name}", round(cvs[0], 3),
             f"cv10M={cvs[1]:.3f};cv100M={cvs[2]:.3f}")
    mono = sum(1 for v in out.values() if v[0] >= v[1] >= v[2])
    _row("fig1_dispersion_monotone_apps", mono, "of 10 (expect ~10)")
    _row("fig1_time_s", round(time.time() - t0, 1))
    return {"monotone_apps": mono}


# ---------------------------------------------------------------------- Fig 5
def bench_config_sweep(engine, apps=None) -> dict:
    """Fig 5: per-app IPC across Configs 0-6 with tight phase-1 CIs: the
    phase-1 SRS sweep, every app and config in one batched pass."""
    t0 = time.time()
    table = run_sweep(engine, SweepSpec(apps=tuple(_apps(apps)),
                                        scheme="srs"))
    for r in table:
        if r.config_index in (0, 6):
            _row(f"fig5_ipc_{r.app}_cfg{r.config_index}",
                 round(1 / r.estimate, 3), f"margin_pct={r.margin_pct:.2f}")
    ipc = 1.0 / table.matrix("estimate")            # (7, n_apps)
    geo = np.exp(np.log(ipc).mean(axis=1))
    speedup = float(geo[6] / geo[0])
    _row("fig5_geomean_ipc_cfg0", round(geo[0], 3))
    _row("fig5_geomean_ipc_cfg6", round(geo[6], 3))
    _row("fig5_speedup_cfg6_over_cfg0", round(speedup, 3),
         "paper: 1.68 (1.52->2.56)")
    _row("fig5_time_s", round(time.time() - t0, 1))
    return {"speedup": speedup, "geo0": float(geo[0]), "geo6": float(geo[6])}


# ------------------------------------------------------------------- helpers
def _analytical_margin(exp, scheme: str, cfg_i: int) -> float:
    """95% margin (%) for one-unit-per-stratum stratified sampling using
    exact within-stratum variances (census for BBV, phase-1 for RFV/DG)."""
    if scheme == "random":
        cpi = _np(exp.census(cfg_i))
        n = 20
        var = float(cpi.var(ddof=1)) / n
        est = Estimate(mean=float(cpi.mean()), variance=var, n=n,
                       df=float(n - 1))
        return est.margin_pct
    if scheme == "bbv":
        labels, weights = exp.bbv_labels, exp.bbv_weights
        cpi = _np(exp.census(cfg_i))
    else:
        labels = exp.rfv_labels if scheme == "rfv" else exp.dg_labels
        weights = exp.rfv_weights if scheme == "rfv" else exp.dg_weights
        cpi = _np(exp.cpi(cfg_i, exp.idx1))
    labels, weights = _np(labels), _np(weights)
    summ = []
    for h in range(NUM_STRATA):
        m = labels == h
        if m.sum() < 2:
            summ.append(StratumSummary(weight=float(weights[h]),
                                       n=2, mean=float(cpi[m].mean())
                                       if m.any() else 0.0, var=0.0))
            continue
        v = float(cpi[m].var(ddof=1))
        summ.append(StratumSummary(weight=float(weights[h]), n=1,
                                   mean=float(cpi[m].mean()), var=v))
    # one unit per stratum: v(ybar) = sum W_h^2 s_h^2 (n_h = 1)
    var = sum(s.weight ** 2 * s.var for s in summ)
    mean = sum(s.weight * s.mean for s in summ)
    est = Estimate(mean=mean, variance=var, n=NUM_STRATA,
                   df=float(NUM_STRATA // 2))
    return est.margin_pct


# ---------------------------------------------------------------------- Fig 7
def bench_ci_analytical(engine, apps=None) -> dict:
    """Fig 7: analytical 95% margins at n=20 for the four schemes
    (config 6, stratifications built from config-0 data)."""
    t0 = time.time()
    worse_than_random = []
    margins = {}
    for exp in engine.apps(_apps(apps)):
        m = tuple(_analytical_margin(exp, s, 6)
                  for s in ("random", "bbv", "rfv", "dg"))
        margins[exp.name] = m
        if m[1] > m[0]:
            worse_than_random.append(exp.name)
        _row(f"fig7_margin_{exp.name}", round(m[0], 1),
             f"bbv={m[1]:.1f};rfv={m[2]:.1f};dg={m[3]:.1f}")
    _row("fig7_bbv_worse_than_random", len(worse_than_random),
         "apps (paper: ~5 of 10): " + "|".join(
             w.split(".")[1] for w in worse_than_random))
    rfv_ok = sum(1 for m in margins.values() if m[2] < 12.0)
    _row("fig7_rfv_margin_lt12pct", rfv_ok, "apps (paper: most <10%)")
    _row("fig7_time_s", round(time.time() - t0, 1))
    return {"bbv_worse": len(worse_than_random), "margins": margins}


# ---------------------------------------------------------------------- Fig 8
def bench_ci_empirical(engine, apps=None, trials: int = 1000) -> dict:
    """Fig 8: Monte-Carlo 95th-percentile |error| at n=20 per scheme, from
    ``run_trials`` (every app, trial and stratum of a scheme at once)."""
    t0 = time.time()
    res = run_trials(engine, TrialSpec(trials=trials, keep_trials=True),
                     apps=tuple(_apps(apps)))
    results = {}
    for a, name in enumerate(res.apps):
        results[name] = {k: float(np.percentile(res.errors[k][a], 95))
                         for k in res.errors}
        r = results[name]
        _row(f"fig8_p95err_{name}", round(r["random"], 1),
             f"bbv={r['bbv']:.1f};rfv={r['rfv']:.1f};dg={r['dg']:.1f}")
    for scheme, cov in res.coverage.items():
        _row(f"fig8_ci_coverage_{scheme}", round(float(np.mean(cov)), 3),
             "mean empirical coverage of nominal 95% per-trial CIs")
    _row("fig8_time_s", round(time.time() - t0, 1))
    results["coverage"] = {k: float(np.mean(v))
                           for k, v in res.coverage.items()}
    return results


# ---------------------------------------------------------------------- Fig 9
def bench_ci_collapsed(engine, apps=None) -> dict:
    """Fig 9: practically computable CI — collapsed strata from exactly 20
    simulations of config 6 (one per RFV stratum, random unit)."""
    t0 = time.time()
    out = {}
    for exp in engine.apps(_apps(apps)):
        sel, weights = plan_selection(
            exp, SamplingPlan.from_strings("rfv", "random"), seed=3,
            backend=engine.backend)
        weights = _np(weights)
        y = np.array([float(exp.cpi(6, s)[0]) for s in sel if s.numel()])
        w = np.array([weights[h] for h, s in enumerate(sel) if s.numel()])
        w = w / w.sum()
        cpi0, labels = _np(exp.cpi0_1), _np(exp.rfv_labels)
        order = np.array([cpi0[labels == h].mean()
                          for h, s in enumerate(sel) if s.numel()])
        est = collapsed_strata_estimate(y, w, order_by=order)
        covered = est.covers(float(exp.truth[6]))
        out[exp.name] = (est.margin_pct, covered)
        _row(f"fig9_collapsed_margin_{exp.name}", round(est.margin_pct, 1),
             f"covers_truth={covered}")
    cov = sum(1 for _, c in out.values() if c)
    _row("fig9_coverage", cov, "of 10 apps (95% CI; collapsed strata are "
                               "approximate)")
    _row("fig9_time_s", round(time.time() - t0, 1))
    return out


# ------------------------------------------------------------------ Fig 10/11
def _selection_sweeps(engine, apps, policy: str) -> dict:
    out = {name: {} for name in apps}
    for scheme in ("bbv", "rfv", "dg"):
        table = run_sweep(engine, SweepSpec(
            apps=tuple(apps),
            plan=SamplingPlan.from_strings(scheme, policy)))
        for name in apps:
            out[name][scheme] = float(
                table.filter(app=name).column("err_pct").max())
    return out


def bench_selection_centroid(engine, apps=None) -> dict:
    """Fig 10: measured errors (Configs 0-6) with centroid selection: one
    sweep per scheme, every app's picks on every config at once."""
    t0 = time.time()
    out = _selection_sweeps(engine, _apps(apps), "centroid")
    for name, maxerr in out.items():
        _row(f"fig10_maxerr_{name}", round(maxerr["bbv"], 1),
             f"rfv={maxerr['rfv']:.1f};dg={maxerr['dg']:.1f}")
    worst_bbv = max(v["bbv"] for v in out.values())
    worst_rfv = max(v["rfv"] for v in out.values())
    _row("fig10_worst_bbv_err", round(worst_bbv, 1),
         "paper: 40-60% for two apps")
    _row("fig10_worst_rfv_err", round(worst_rfv, 1), "paper: ~3%")
    _row("fig10_time_s", round(time.time() - t0, 1))
    return {"worst_bbv": worst_bbv, "worst_rfv": worst_rfv, "per_app": out}


def bench_selection_mean(engine, apps=None) -> dict:
    """Fig 11: mean selection (baseline-CPI nearest stratum mean)."""
    t0 = time.time()
    out = _selection_sweeps(engine, _apps(apps), "mean")
    for name, maxerr in out.items():
        _row(f"fig11_maxerr_{name}", round(maxerr["bbv"], 1),
             f"rfv={maxerr['rfv']:.1f};dg={maxerr['dg']:.1f}")
    worst_bbv = max(v["bbv"] for v in out.values())
    _row("fig11_worst_bbv_err", round(worst_bbv, 1),
         "paper: BBV improved vs Fig 10, still worse than RFV")
    _row("fig11_time_s", round(time.time() - t0, 1))
    return {"worst_bbv_mean": worst_bbv, "per_app": out}


# ------------------------------------------------------------------ Fig 12/13
def bench_distribution_approx(engine, apps=None, *,
                              record: Optional[dict] = None) -> dict:
    """Fig 12/13: distribution approximated by 20 vs 500 selected regions —
    Kolmogorov-Smirnov distance to the census CPI distribution. The 500
    strata are a k-means fit of the app's phase-1 RFVs (k = min(500,
    n1 // 2)) through the clustering kernels."""
    t0 = time.time()
    out = {}
    for exp in engine.apps(_apps(apps)):
        census = np.sort(_np(exp.census(0)))
        ks = {}
        for k in (20, 500):
            if k == 20:
                sel, weights = plan_selection(
                    exp, SamplingPlan.from_strings("rfv", "centroid"),
                    backend=engine.backend)
                weights = _np(weights)
            else:
                km = kmeans(exp.rfv_z, min(k, exp.idx1.numel() // 2),
                            seed=0, backend=engine.backend)
                w = np.bincount(_np(km.labels),
                                minlength=km.centroids.shape[0]).astype(float)
                w /= w.sum()
                local = select_centroid(km.labels, exp.rfv_z, km.centroids)
                _fit_record(record, ("fig12", exp.name, k), exp.rfv_z, km,
                            local)
                sel, weights = [exp.idx1[lo] for lo in local], w
            vals, ws = [], []
            for h, s in enumerate(sel):
                if s.numel():
                    vals.append(float(exp.cpi(0, s)[0]))
                    ws.append(weights[h])
            vals = np.asarray(vals)
            ws = np.asarray(ws) / np.sum(ws)
            order = np.argsort(vals)
            vals, ws = vals[order], ws[order]
            approx_cdf_at = np.cumsum(ws)
            census_cdf = np.searchsorted(census, vals, side="right") \
                / census.size
            ks[k] = float(np.max(np.abs(approx_cdf_at - census_cdf)))
        out[exp.name] = ks
        _row(f"fig12_ks20_{exp.name}", round(ks[20], 3),
             f"ks500={ks[500]:.3f}")
    improved = sum(1 for v in out.values() if v[500] <= v[20] + 1e-9)
    _row("fig13_ks_improved_at_500", improved, "of 10 apps")
    _row("fig12_time_s", round(time.time() - t0, 1))
    return out


# -------------------------------------------------------------------- Table IV
def bench_two_phase_sizing(engine, apps=None) -> dict:
    """Table IV: phase-2 sizes for <=1.5x the phase-1 random margin, RFV vs
    BBV stratification; derived reduction factors vs simple random."""
    t0 = time.time()
    tot_rand = tot_rfv = tot_bbv = 0
    rows = {}
    for exp in engine.apps(_apps(apps)):
        cpi6_p1 = _np(exp.cpi(6, exp.idx1))
        n1 = int(exp.idx1.numel())
        est1 = srs_estimate(cpi6_p1)
        sizes = {}
        for scheme in ("rfv", "bbv_p1"):
            if scheme == "rfv":
                labels, weights = _np(exp.rfv_labels), _np(exp.rfv_weights)
            else:
                # classify phase-1 units into census BBV strata
                labels = _np(exp.bbv_labels[exp.idx1])
                weights = _np(exp.bbv_weights)
            stds = np.array([cpi6_p1[labels == h].std(ddof=1)
                             if (labels == h).sum() > 1 else 0.0
                             for h in range(NUM_STRATA)])
            mean = float(np.sum(weights * np.array(
                [cpi6_p1[labels == h].mean() if (labels == h).any() else 0.0
                 for h in range(NUM_STRATA)])))
            between = float(np.sum(weights * (np.array(
                [cpi6_p1[labels == h].mean() if (labels == h).any() else mean
                 for h in range(NUM_STRATA)]) - mean) ** 2))
            try:
                n_h = phase2_sizes_for_margin(
                    weights, stds, n1, between,
                    target_margin_abs=1.5 * est1.margin,
                    allocation="neyman")
                sizes[scheme] = int(n_h.sum())
            except ValueError:
                sizes[scheme] = n1  # unattainable: fall back to full SRS
        rows[exp.name] = (n1, sizes["rfv"], sizes["bbv_p1"])
        tot_rand += n1
        tot_rfv += sizes["rfv"]
        tot_bbv += sizes["bbv_p1"]
        _row(f"table4_{exp.name}", n1,
             f"rfv={sizes['rfv']};bbv={sizes['bbv_p1']};"
             f"margin_random_pct={est1.margin_pct:.2f}")
    red_rfv = tot_rand / max(tot_rfv, 1)
    red_bbv = tot_rand / max(tot_bbv, 1)
    _row("table4_total_random", tot_rand, "paper: 24079")
    _row("table4_total_rfv", tot_rfv,
         f"reduction={red_rfv:.1f}x (paper: 12.6x, 1917 sims)")
    _row("table4_total_bbv", tot_bbv,
         f"reduction={red_bbv:.1f}x (paper: 3.5x, 6818 sims)")
    _row("table4_time_s", round(time.time() - t0, 1))
    return {"reduction_rfv": red_rfv, "reduction_bbv": red_bbv,
            "per_app": rows}


# ------------------------------------------------- gcc k-sensitivity (V.B.1)
def bench_gcc_cluster_sensitivity(engine, app: str = GCC, *,
                                  record: Optional[dict] = None) -> dict:
    """Paper V.B.1: raising gcc's BBV clusters 20 -> 50 collapses the
    centroid-selection error (k-means over all of gcc's 120,000 projected
    BBVs)."""
    t0 = time.time()
    exp = engine.app(app)
    z = exp.bbv_feats
    out = {}
    for k in (20, 50):
        km = kmeans(z, k, seed=0, backend=engine.backend)
        w = np.bincount(_np(km.labels), minlength=k) / z.shape[0]
        sel = select_centroid(km.labels, z, km.centroids)
        _fit_record(record, ("gcc", app, k), z, km, sel)
        ests = _np(exp.weighted_cpi_all(sel, w))
        errs = 100 * np.abs(ests - _np(exp.truth)) / _np(exp.truth)
        out[k] = float(errs.max())
        _row(f"gcc_bbv_maxerr_k{k}", round(out[k], 1),
             "paper: k=50 -> 5.4%")
    _row("gcc_sensitivity_time_s", round(time.time() - t0, 1))
    return out


# ------------------------------------------ beyond-paper: §VI.C directions
def _stratify_and_estimate(engine, exp, z, record, key) -> float:
    """k-means (20 strata, 2 restarts) on the phase-1 features ``z``,
    centroid picks, and the worst percent error over the configs."""
    km = kmeans(z, NUM_STRATA, seed=0, restarts=2, backend=engine.backend)
    w = np.bincount(_np(km.labels), minlength=NUM_STRATA) \
        / exp.idx1.numel()
    local = select_centroid(km.labels, z, km.centroids)
    _fit_record(record, key, z, km, local)
    sel = [exp.idx1[s] for s in local]
    ests = _np(exp.weighted_cpi_all(sel, w))
    errs = 100 * np.abs(ests - _np(exp.truth)) / _np(exp.truth)
    return float(errs.max())


def bench_approx_phase1(engine, apps=None, *,
                        record: Optional[dict] = None) -> dict:
    """Paper §VI.C (proposed, not evaluated): run phase 1 on a FAST
    approximate simulator, stratify on its (biased) RFV, then study
    accurate configurations on the selected regions."""
    t0 = time.time()
    worst = {}
    for exp in engine.apps(_apps(apps)):
        stats = evaluate_regions_approx(exp.sim.sim.features, CONFIGS[0],
                                        exp.idx1)
        feats = torch.stack([stats[k] for k in sorted(stats)], dim=1)
        worst[exp.name] = _stratify_and_estimate(
            engine, exp, _zscore(feats), record, ("approx", exp.name, 20))
        _row(f"approx_phase1_maxerr_{exp.name}", round(worst[exp.name], 1))
    _row("approx_phase1_worst", round(max(worst.values()), 1),
         "approximate-simulator phase 1 (beyond-paper, paper proposes in "
         "VI.C)")
    _row("approx_phase1_time_s", round(time.time() - t0, 1))
    return {"worst": max(worst.values()), "per_app": worst}


def bench_isa_features(engine, apps=None, *,
                       record: Optional[dict] = None) -> dict:
    """Paper §VI.C: stratify on microarchitecture-INDEPENDENT (ISA-level)
    features — the populations' intrinsic feature vectors, available
    without any cycle-accurate run."""
    t0 = time.time()
    worst = {}
    for exp in engine.apps(_apps(apps)):
        feats = torch.as_tensor(exp.sim.pop.features[_np(exp.idx1)],
                                device=exp.idx1.device)
        worst[exp.name] = _stratify_and_estimate(
            engine, exp, _zscore(feats), record, ("isa", exp.name, 20))
        _row(f"isa_features_maxerr_{exp.name}", round(worst[exp.name], 1))
    _row("isa_features_worst", round(max(worst.values()), 1),
         "ISA-level stratification (beyond-paper, paper proposes in VI.C)")
    _row("isa_features_time_s", round(time.time() - t0, 1))
    return {"worst": max(worst.values()), "per_app": worst}


FIGURES: dict[str, Callable] = {
    "bench_cpi_distributions": bench_cpi_distributions,
    "bench_config_sweep": bench_config_sweep,
    "bench_ci_analytical": bench_ci_analytical,
    "bench_ci_empirical": bench_ci_empirical,
    "bench_ci_collapsed": bench_ci_collapsed,
    "bench_selection_centroid": bench_selection_centroid,
    "bench_selection_mean": bench_selection_mean,
    "bench_distribution_approx": bench_distribution_approx,
    "bench_two_phase_sizing": bench_two_phase_sizing,
    "bench_gcc_cluster_sensitivity": bench_gcc_cluster_sensitivity,
    "bench_approx_phase1": bench_approx_phase1,
    "bench_isa_features": bench_isa_features,
}
def run_figure(engine, name: str, apps=None, *, gcc_app: str = GCC,
               record: Optional[dict] = None) -> dict:
    """One figure of ``FIGURES`` by name (the gcc row on ``gcc_app``);
    the figures that fit k-means of their own keep their fits in
    ``record``."""
    kwargs = {"record": record} if name in FIT_TAGS else {}
    if name == "bench_gcc_cluster_sensitivity":
        return FIGURES[name](engine, gcc_app, **kwargs)
    return FIGURES[name](engine, apps, **kwargs)


def run_all(engine, apps=None, *, gcc_app: str = GCC,
            record: Optional[dict] = None) -> dict:
    """Every figure in order; returns ``{function name: dict}``."""
    return {name: run_figure(engine, name, apps, gcc_app=gcc_app,
                             record=record) for name in FIGURES}


# ------------------------------------------------------------ comparisons
def selection_record(engine, apps=None) -> dict:
    """Per app: a digest of each engine stratification's labels and the
    picks of the six (stratifier, centroid|mean) plans and of Fig 9's
    random plan — the integers on which the figures' inputs rest."""
    apps = _apps(apps)
    exps = engine.build(apps)
    out = {e.name: {f: _digest(getattr(e, f)) for f in
                    ("bbv_labels", "rfv_labels", "dg_labels")}
           for e in exps}
    plans = [(s, p, 0) for s in ("bbv", "rfv", "dg")
             for p in ("centroid", "mean")] + [("rfv", "random", 3)]
    for scheme, policy, seed in plans:
        picks, valid, _ = plan_selection_bank(
            exps, SamplingPlan.from_strings(scheme, policy), seed=seed,
            backend=engine.backend)
        picks = np.where(_np(valid), _np(picks), -1)
        for a, e in enumerate(exps):
            out[e.name][f"{scheme}/{policy}"] = [int(v) for v in picks[a]]
    return out


def _digest(labels) -> str:
    return hashlib.sha1(_np(labels).astype("<i8").tobytes()).hexdigest()


def fit_summary(record: dict) -> dict:
    """``{fit key: {"labels": digest, "picks": [...]}}`` of a ``record``
    (the layout of the reference JSON's ``fits``)."""
    return {k: {"labels": _digest(v["labels"]), "picks": v["picks"]}
            for k, v in record.items()}


def pick_ties(entry: dict, want_picks: Sequence[int]) -> tuple[int, int]:
    """``(differing, near_ties)``: the strata of one recorded fit whose
    centroid pick differs from ``want_picks``, and how many of those are
    near-ties — both units members of the stratum, at distances to its
    centroid within ``TIE_RTOL`` relative (strata of two units sit at
    exact ties: their centroid is the midpoint)."""
    labels = entry["labels"]
    z = entry["z"].double()
    cents = entry["centroids"].double()
    differing = ties = 0
    for h, (g, w) in enumerate(zip(entry["picks"], want_picks)):
        if g == w:
            continue
        differing += 1
        if g < 0 or w < 0 or w >= labels.shape[0] \
                or int(labels[w]) != h or int(labels[g]) != h:
            continue
        dg, dw = (float(torch.linalg.vector_norm(z[i] - cents[h]))
                  for i in (g, w))
        if abs(dg - dw) <= TIE_RTOL * max(dg, dw):
            ties += 1
    return differing, ties


def to_jsonable(x):
    """Figure dicts as JSON: tuples become lists, keys strings, numpy
    scalars Python numbers."""
    if isinstance(x, dict):
        return {str(k): to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_jsonable(v) for v in x]
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return float(x)
    return x


def load_reference(path=REFERENCE_JSON) -> dict:
    with open(path) as f:
        return json.load(f)


# percent errors carry the estimates' rtol as an absolute term: an error
# near zero has no relative tolerance (100 * RTOL * estimate / truth, with
# estimate / truth below 2 in every figure)
RTOL = 1e-5
ERR_ATOL = 100 * RTOL * 2
TIE_RTOL = 1e-5
_ERR_FIGURES = ("bench_selection_centroid", "bench_selection_mean",
                "bench_gcc_cluster_sensitivity", "bench_approx_phase1",
                "bench_isa_features")


# the figures that fit k-means of their own: the fit keys' tag and ks
FIT_TAGS = {"bench_distribution_approx": ("fig12", (500,)),
            "bench_gcc_cluster_sensitivity": ("gcc", (20, 50)),
            "bench_approx_phase1": ("approx", (20,)),
            "bench_isa_features": ("isa", (20,))}


def fits_behind(diff: dict, fits: dict, gcc_app: str = GCC) -> list[str]:
    """The keys of the figure's own k-means fits (in ``fits``) that one
    ``compare`` difference rests on."""
    figure, path, app = diff["figure"], diff["path"], diff["app"]
    if figure not in FIT_TAGS:
        return []
    tag, ks = FIT_TAGS[figure]
    if tag == "gcc":
        return [f"gcc/{gcc_app}/{path}"]
    if tag == "fig12":
        return [f"fig12/{app}/500"] if path.endswith("/500") else []
    if app is not None:
        return [f"{tag}/{app}/{ks[0]}"]
    return [k for k in fits if k.startswith(tag + "/")]


def explain(diff: dict, record: dict, want_fits: dict,
            gcc_app: str = GCC) -> Optional[str]:
    """Why one difference may stand, or None: a fit of the figure's own
    gave the labels of ``want_fits`` but other centroid picks, at
    near-ties only (``"near-tie picks"``). ``record`` is the ``record``
    dict this side's figures filled. A fit whose labels part explains
    nothing: the clustering kernels take the reference's dot order at
    every fit shape (``core.ordered.reference_dot_order``)."""
    for key in fits_behind(diff, want_fits, gcc_app):
        want = want_fits[key]
        if _digest(record[key]["labels"]) != want["labels"]:
            continue
        differing, near = pick_ties(record[key], want["picks"])
        if differing and differing == near:
            return "near-tie picks"
    return None


def _leaves(x, path=()):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, x


def _close(fig: str, path: tuple, g: float, w: float,
           near_ties: Optional[dict]) -> bool:
    if math.isnan(g) and math.isnan(w):
        return True
    atol = 0.0
    if fig == "bench_ci_empirical":
        atol = float((near_ties or {}).get(path[-1], 0.0)) \
            if path[0] == "coverage" else ERR_ATOL
    elif fig in _ERR_FIGURES:
        atol = ERR_ATOL
    return abs(g - w) <= atol + RTOL * abs(w)


def compare(got: dict, want: dict, *, near_ties: Optional[dict] = None
            ) -> list[dict]:
    """Every leaf of ``want`` (``{figure: dict}``) that ``got`` does not
    match: integers and booleans exactly, floats to ``RTOL``; percent
    errors (Figs 8, 10, 11, gcc, §VI.C) also within ``ERR_ATOL`` percent
    points; Fig 8's mean coverage within the near-tie trials of
    ``near_ties[scheme]`` (a share of the trials, see
    ``tests/test_torch_trials.py``). Returns one record per difference:
    ``figure``, ``path``, ``got``, ``want``, ``app`` (the app the number
    belongs to, or None)."""
    got, want = to_jsonable(got), to_jsonable(want)
    apps = set(APP_NAMES)
    diffs = []
    for fig, tree in want.items():
        got_leaves = dict(_leaves(got.get(fig, {})))
        for path, w in _leaves(tree):
            g = got_leaves.get(path)
            app = next((p for p in path if p in apps), None)
            rec = {"figure": fig, "path": "/".join(path), "got": g,
                   "want": w, "app": app}
            exact = isinstance(w, (bool, int)) and \
                isinstance(g, (bool, int))
            if g is None or isinstance(w, bool) != isinstance(g, bool):
                diffs.append(rec)
            elif exact:
                if g != w:
                    diffs.append(rec)
            elif not _close(fig, path, float(g), float(w), near_ties):
                diffs.append(rec)
    return diffs
