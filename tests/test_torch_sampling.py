"""The port's estimators, allocations, sizing and the flow's building
blocks against the reference, on the CPU.

Seeded numpy inputs go through each reference function and its port
counterpart (the cases of ``tests/test_sampling.py``,
``tests/test_estimator_tables.py``, ``tests/test_sampling_plan.py`` and
``tests/test_experiments.py`` that touch them, as parametrised cases).
Held to: integers exactly (allocations, sizes, group maps, picks,
charges, ledgers); float64 host statistics to rtol 1e-10 (sums in another
order); float32 perf-model values and anything computed from them to
rtol 1e-5. Phase-2 sizing is held against the reference's numpy host
sizing (its jitted default needs the x64 mode jax 0.9.0 no longer has),
as ``tests/test_streaming_trials.py`` states it.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import repro.core.sampling as RS
import repro.experiments as R
from repro.core.clustering import kmeans_multi_seed as r_multi
from repro.core.precision import PrecisionPolicy as RPolicy
from repro.core.sampling import plan as rplan
from repro.core.sampling import tables as rtables
from repro.simcpu import CONFIGS as RCONFIGS
from repro.simcpu import make_cached_simulator as r_cached
from repro.simcpu import perfmodel as rperf
import repro_torch.core.sampling as TS
import repro_torch.experiments as T
from repro_torch.core.clustering import kmeans_multi_seed as t_multi
from repro_torch.core.sampling import plan as tplan
from repro_torch.core.sampling import tables as ttables
from repro_torch.simcpu import CONFIGS as TCONFIGS
from repro_torch.simcpu import make_cached_simulator as t_cached
from repro_torch.simcpu import perfmodel as tperf

APP = "505.mcf_r"
RTOL = 1e-10


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _same_estimate(got, want, rtol=RTOL):
    assert got.n == want.n and got.scheme == want.scheme
    assert (got.df is None) == (want.df is None)
    np.testing.assert_allclose(
        [got.mean, got.variance, got.df or 0.0, got.margin],
        [want.mean, want.variance, want.df or 0.0, want.margin], rtol=rtol)


def _design(seed, n, L):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, L, n)
    labels[:2 * L] = np.repeat(np.arange(L), 2)        # every stratum >= 2
    y = rng.normal(3.0, 1.0, n) + labels * 0.5
    w = rng.dirichlet(np.ones(L))
    return y, labels, w


# ------------------------------------------------------------- estimators
@pytest.mark.parametrize("n,L", [(200, 5), (37, 3), (500, 20), (10, 1)])
@pytest.mark.parametrize("df_method", ["satterthwaite", "n_minus_L", "z"])
def test_stratified_estimates_match(n, L, df_method):
    y, labels, w = _design(n + L, n, L)
    got = TS.stratified_estimate_from_samples(y, labels, weights=w,
                                              df_method=df_method)
    want = RS.stratified_estimate_from_samples(y, labels, weights=w,
                                               df_method=df_method)
    _same_estimate(got, want)
    summ_t = TS.summarize_strata(y, labels, num_strata=L)
    summ_r = RS.summarize_strata(y, labels, num_strata=L)
    for fn in ("stratified_mean", "stratified_variance", "satterthwaite_df"):
        np.testing.assert_allclose(getattr(TS, fn)(summ_t),
                                   getattr(RS, fn)(summ_r), rtol=RTOL)


def test_stratified_degenerate_strata_raise():
    summ = [TS.StratumSummary(weight=0.5, n=0, mean=float("nan"),
                              var=float("nan")),
            TS.StratumSummary(weight=0.5, n=1, mean=1.0, var=float("nan"))]
    with pytest.raises(ValueError, match="no sampled units"):
        TS.stratified_mean(summ)
    with pytest.raises(ValueError, match="n_h >= 2"):
        TS.stratified_variance(summ)
    with pytest.raises(ValueError, match="df_method"):
        TS.stratified_estimate(TS.summarize_strata([1., 2., 3., 4.],
                                                   [0, 0, 1, 1]),
                               df_method="bogus")


@pytest.mark.parametrize("L", [2, 3, 4, 7, 20])
@pytest.mark.parametrize("ordered", [False, True])
def test_collapsed_strata_matches(L, ordered):
    rng = np.random.default_rng(L)
    y = rng.normal(2.0, 0.5, L)
    w = rng.dirichlet(np.ones(L))
    key = rng.normal(size=L) if ordered else None
    got = TS.collapsed_strata_estimate(y, w, order_by=key)
    want = RS.collapsed_strata_estimate(y, w, order_by=key)
    _same_estimate(got, want)
    ci_t = tplan.CollapsedPairsCI().estimate(y, w, order_by=key)
    _same_estimate(ci_t, want)


def test_collapsed_missing_stratum_contract():
    y = np.array([1.0, np.nan, 3.0, 4.0])
    w = np.full(4, 0.25)
    with pytest.warns(UserWarning, match="cover only"):
        got = TS.collapsed_strata_estimate(y, w)
    with pytest.warns(UserWarning):
        want = RS.collapsed_strata_estimate(y, w)
    _same_estimate(got, want)
    with pytest.raises(ValueError, match="cover only"):
        TS.collapsed_strata_estimate(y, w, strict=True)
    with pytest.raises(ValueError, match="weights sum"):
        TS.collapsed_strata_estimate([1.0, 2.0], [0.5, 0.6])


def test_collapsed_pairs_interval_matches():
    rng = np.random.default_rng(3)
    y = rng.normal(size=(4, 20))
    w = np.broadcast_to(rng.dirichlet(np.ones(20)), (4, 20))
    n_valid = np.array([20, 19, 2, 1])
    got = tplan.CollapsedPairsCI().interval(
        torch.from_numpy(y), torch.from_numpy(np.ascontiguousarray(w)),
        torch.from_numpy(n_valid), num_strata=20)
    want = rplan.CollapsedPairsCI().interval(y, w, n_valid, num_strata=20)
    for g, r in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=RTOL)


@pytest.mark.parametrize("formula", ["phase2_only", "with_phase1_var"])
def test_two_phase_ci_matches(formula):
    y, labels, w = _design(8, 160, 20)
    t_t = TS.stratum_tables(y, labels, weights=w, num_strata=20)
    t_r = RS.stratum_tables(y, labels, weights=w, num_strata=20)
    kw = {"phase1_var": 0.7} if formula == "with_phase1_var" else {}
    got = tplan.TwoPhaseCI(formula=formula).estimate(t_t, 900, **kw)
    want = rplan.TwoPhaseCI(formula=formula).estimate(t_r, 900, **kw)
    _same_estimate(got, want)


# ------------------------------------------------------------- allocation
@pytest.mark.parametrize("n_total", [7, 100, 1234])
def test_allocations_match(n_total):
    w = np.array([0.5, 0.3, 0.2])
    s = np.array([1.0, 4.0, 0.1])
    np.testing.assert_array_equal(
        _np(TS.proportional_allocation(w, n_total)),
        RS.proportional_allocation(w, n_total))
    np.testing.assert_array_equal(
        _np(TS.neyman_allocation(w, s, n_total)),
        RS.neyman_allocation(w, s, n_total))
    np.testing.assert_array_equal(       # all-zero products: proportional
        _np(TS.neyman_allocation(w, np.zeros(3), n_total)),
        RS.neyman_allocation(w, np.zeros(3), n_total))
    for fn in ("required_total_neyman", "required_total_proportional"):
        assert getattr(TS, fn)(w, s, target_margin_abs=0.05) == \
            getattr(RS, fn)(w, s, target_margin_abs=0.05)
    with pytest.raises(ValueError, match="positive"):
        TS.required_total_neyman(w, s, target_margin_abs=0.0)


def test_batched_allocation_matches():
    w = np.array([[0.5, 0.3, 0.2], [0.1, 0.1, 0.8]])
    s = np.array([[1.0, 4.0, 0.1], [0.0, 0.0, 0.0]])
    np.testing.assert_array_equal(
        _np(ttables.proportional_allocation(torch.from_numpy(w), 100)),
        rtables.proportional_allocation(w, 100))
    np.testing.assert_array_equal(
        _np(ttables.neyman_allocation(torch.from_numpy(w),
                                      torch.from_numpy(s), 100)),
        rtables.neyman_allocation(w, s, 100))


@pytest.mark.parametrize("seed", range(8))
def test_collapse_small_strata_matches(seed):
    rng = np.random.default_rng(seed)
    L = 8
    counts = rng.integers(0, 4, L).astype(np.float64)
    if counts.sum() < 2:
        counts[0] = 2.0
    key = rng.normal(size=L)
    w = np.where(counts > 0, 1.0, 0.0)
    w = w / max(w.sum(), 1.0)
    args = dict(counts=counts, sums=counts * 1.5, sumsqs=counts * 3.0,
                weights=w)
    got = ttables.collapse_small_strata(
        ttables.StratumTables(**{k: torch.from_numpy(v)
                                 for k, v in args.items()}),
        torch.from_numpy(key))
    want = rtables.collapse_small_strata(rtables.StratumTables(**args), key)
    for f in ("counts", "sums", "sumsqs", "weights"):
        np.testing.assert_array_equal(_np(getattr(got[0], f)),
                                      getattr(want[0], f))
    np.testing.assert_array_equal(_np(got[1]), want[1])
    assert int(got[2]) == int(want[2])


def _host_sizing(w, s, p1n, bvar, margin, allocation):
    z = RS.critical_value(0.95, None)
    v_budget = (margin / z) ** 2 - bvar / p1n
    numer = (w * s).sum() ** 2 if allocation == "neyman" \
        else (w * s * s).sum()
    n_total = min(max(int(np.ceil(numer / v_budget)), 2 * len(w)), 10**7)
    if allocation == "neyman":
        return RS.neyman_allocation(w, s, n_total, min_per_stratum=2)
    return RS.proportional_allocation(w, n_total)


@pytest.mark.parametrize("allocation", ["neyman", "proportional"])
@pytest.mark.parametrize("margin", [0.05, 0.1, 0.2])
def test_phase2_sizes_match_host_sizing(allocation, margin):
    rng = np.random.default_rng(int(margin * 100))
    w = rng.dirichlet(np.ones(20))
    s = rng.gamma(2.0, 0.3, 20)
    got = TS.phase2_sizes_for_margin(w, s, 400, 0.09,
                                     target_margin_abs=margin,
                                     allocation=allocation)
    np.testing.assert_array_equal(
        _np(got), _host_sizing(w, s, 400, 0.09, margin, allocation))
    with pytest.raises(ValueError, match="unattainable"):
        TS.phase2_sizes_for_margin(w, s, 10, 1.0, target_margin_abs=margin,
                                   allocation=allocation)
    with pytest.raises(ValueError, match="allocation"):
        TS.phase2_sizes_for_margin(w, s, 400, 0.09,
                                   target_margin_abs=margin,
                                   allocation="bogus")


# ------------------------------------------------------------- tables
@pytest.mark.parametrize("shape", [(300,), (3, 200)])
def test_stratum_tables_plain_route_matches_host(shape):
    """The ``segment_stats`` route (plain on the CPU) against the float64
    host route: counts exactly, shifted moments and estimates to
    rtol 1e-5 (float32)."""
    rng = np.random.default_rng(len(shape))
    y = torch.from_numpy(rng.normal(5.0, 1.0, shape))
    labels = torch.from_numpy(rng.integers(-1, 6, shape))
    host = ttables.stratum_tables(y, labels, num_strata=6)
    dev = ttables.stratum_tables(y, labels, num_strata=6, backend="plain")
    np.testing.assert_array_equal(_np(dev.counts), _np(host.counts))
    for f in ("means", "variances"):
        np.testing.assert_allclose(_np(getattr(dev, f)),
                                   _np(getattr(host, f)), rtol=1e-5)
    ref = rtables.stratum_tables(y.numpy(), labels.numpy(), num_strata=6,
                                 backend="jnp")
    np.testing.assert_array_equal(_np(dev.counts), np.asarray(ref.counts))
    np.testing.assert_allclose(_np(dev.means), np.asarray(ref.means),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="num_strata"):
        ttables.stratum_tables(y, labels, backend="plain")


# ------------------------------------------------------------- policies
@pytest.mark.parametrize("seed", range(3))
def test_select_random_and_mean_match(seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 6, 120)
    labels[labels == 5] = 4                           # stratum 5 empty
    base = rng.normal(1.0, 0.2, 120).astype(np.float32)
    for per in (1, 3):
        got = TS.select_random(torch.from_numpy(labels), 6,
                               np.random.default_rng(seed), per_stratum=per)
        want = RS.select_random(labels, 6, np.random.default_rng(seed),
                                per_stratum=per)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
        got = TS.select_mean(torch.from_numpy(labels),
                             torch.from_numpy(base), num_strata=6,
                             per_stratum=per)
        want = RS.select_mean(labels, base, num_strata=6, per_stratum=per)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]


@pytest.mark.parametrize("fraction", [0.0, 0.25, 0.5, 1.0])
def test_ranked_set_unit_matches(fraction):
    rng = np.random.default_rng(int(fraction * 8))
    labels = rng.integers(0, 5, 90)
    base = rng.normal(1.0, 0.3, 90)
    got = tplan.RankedSetUnit(fraction).select_local(
        torch.from_numpy(labels), features=None, centroids=None,
        baseline=torch.from_numpy(base), num_strata=6, seed=0)
    want = rplan.RankedSetUnit(fraction).select_local(
        labels, features=None, centroids=None, baseline=base,
        num_strata=6, seed=0)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    with pytest.raises(ValueError, match="rank_fraction"):
        tplan.RankedSetUnit(1.5)
    assert tplan.registered_policies() == rplan.registered_policies()


def test_kmeans_multi_seed_matches():
    rng = np.random.default_rng(1)
    centers = rng.normal(0, 4, (5, 3))
    x = (centers[rng.integers(0, 5, 400)]
         + rng.normal(0, 1, (400, 3))).astype(np.float32)
    got = t_multi(torch.from_numpy(x), 5, seeds=[0, 1, 7])
    want = r_multi(x, 5, seeds=[0, 1, 7])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.labels.numpy(), w.labels)
        assert g.iterations == w.iterations
        np.testing.assert_allclose(g.inertia, w.inertia, rtol=1e-6)


# ------------------------------------------------------------- simulator
@pytest.fixture(scope="module")
def sims():
    return r_cached(APP), t_cached(APP, device="cpu")


def test_cached_simulator_surface_matches(sims):
    rs, ts = sims
    idx = np.random.default_rng(2).choice(rs.pop.n_regions, 300,
                                          replace=False)
    for ms in (lambda s, c: s.simulate(idx, c[0]),
               lambda s, c: s.simulate_batch(idx, c[:3])):
        got, want = ms(ts, TCONFIGS), ms(rs, RCONFIGS)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(_np(got[k]), want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    cpi_t, rfv_t = ts.simulate_rfv(idx[:50], TCONFIGS[0])
    cpi_r, rfv_r = rs.simulate_rfv(idx[:50], RCONFIGS[0])
    assert rfv_t.dtype == torch.float64 and rfv_t.shape == rfv_r.shape
    np.testing.assert_allclose(_np(rfv_t), rfv_r, rtol=1e-5, atol=1e-7)
    # a second full request is free: misses only, as the reference charges
    ts.simulate(idx, TCONFIGS[4])
    rs.simulate(idx, RCONFIGS[4])
    assert ts.ledger.regions_simulated == rs.ledger.regions_simulated
    assert (ts.hits, ts.misses) == (rs.hits, rs.misses)
    np.testing.assert_array_equal(ts.bank.charges, rs.bank.charges)
    # ground truth stays off the books
    before = ts.ledger.regions_simulated
    np.testing.assert_allclose(ts.true_mean_cpi(TCONFIGS[6]),
                               rs.true_mean_cpi(RCONFIGS[6]), rtol=1e-6)
    got = ts.census_stats(TCONFIGS[2])
    assert got["cpi"].shape == (ts.pop.n_regions,)
    assert ts.ledger.regions_simulated == before


def test_perfmodel_additions_match(sims):
    rs, ts = sims
    idx = np.arange(0, 4000, 7)
    feats = torch.as_tensor(ts.pop.features, dtype=torch.float32)
    np.testing.assert_allclose(
        _np(tperf.cpi_only(feats, TCONFIGS[3], torch.from_numpy(idx))),
        rperf.cpi_only(rs.pop.features, RCONFIGS[3], idx), rtol=1e-5)
    for cfg_i in (0, 6):
        got = tperf.evaluate_regions_approx(feats, TCONFIGS[cfg_i],
                                            torch.from_numpy(idx))
        want = rperf.evaluate_regions_approx(rs.pop.features,
                                             RCONFIGS[cfg_i], idx)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(_np(got[k]), want[k], rtol=1e-5)
    stats_t = {k: v[0] for k, v in tperf.evaluate_regions_batch(
        feats, (TCONFIGS[1],), torch.from_numpy(idx)).items()}
    stats_r = rperf.evaluate_regions(rs.pop.features, RCONFIGS[1], idx)
    np.testing.assert_allclose(_np(tperf.stats_matrix(stats_t)),
                               rperf.stats_matrix(stats_r), rtol=1e-5,
                               atol=1e-7)


# ------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def engines():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = R.ExperimentEngine(precision=RPolicy())
            port = T.ExperimentEngine(device="cpu")
            ref.app(APP)
            port.app(APP)
    finally:
        torch.set_num_threads(threads)
    return ref, port


def test_app_experiment_cpi_methods_match(engines):
    ref, port = engines
    e, p = ref.app(APP), port.app(APP)
    idx = e.idx1[:40]
    np.testing.assert_allclose(_np(p.cpi(3, idx)), e.cpi(3, idx),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(p.cpi_for(idx, (1, 5))),
                               e.cpi_for(idx, (1, 5)), rtol=1e-5)
    np.testing.assert_allclose(_np(p.cpi_all(idx[:10])), e.cpi_all(idx[:10]),
                               rtol=1e-5)
    sel = [e.idx1[h:h + 3] for h in range(0, 60, 3)]
    w = np.asarray(e.rfv_weights)
    np.testing.assert_allclose(
        _np(p.weighted_cpi_all([torch.as_tensor(s) for s in sel], w)),
        e.weighted_cpi_all(sel, w), rtol=1e-5)
    partial = [s if h % 2 else s[:0] for h, s in enumerate(sel)]
    with pytest.warns(UserWarning, match="cover only"):
        got = p.weighted_cpi_all(partial, w, config_indices=(0, 6))
    with pytest.warns(UserWarning):
        want = e.weighted_cpi_all(partial, w, config_indices=(0, 6))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5)
    with pytest.raises(ValueError, match="cover only"):
        p.weighted_cpi_all(partial, w, strict=True)
    with pytest.raises(ValueError, match="empty"):
        p.weighted_cpi_all([s[:0] for s in sel], w, strict=True)
    assert port.memo.total_charges() == ref.memo.total_charges()
    assert p.sim.ledger.regions_simulated == e.sim.ledger.regions_simulated


def test_engine_views_and_multi_seed_match(engines):
    ref, port = engines
    assert [x.name for x in port.apps([APP])] == [APP]
    got = port.rfv_stratifications(APP, [0, 3])
    want = ref.rfv_stratifications(APP, [0, 3])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.labels.numpy(), w.labels)


@pytest.mark.parametrize("scheme", ["bbv", "rfv", "dg", "cpi"])
@pytest.mark.parametrize("policy", ["centroid", "mean", "random"])
def test_legacy_strings_warn_and_match_plan(engines, scheme, policy):
    ref, port = engines
    exps = port.build((APP,))
    with pytest.warns(DeprecationWarning, match="deprecated"):
        got = T.scheme_selection_bank(exps, scheme, policy, 4)
    want = T.plan_selection_bank(
        exps, tplan.SamplingPlan.from_strings(scheme, policy), seed=4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r_picks, r_valid, _ = R.scheme_selection_bank(
            ref.build((APP,)), scheme, policy, 4)
    np.testing.assert_array_equal(got[0].numpy(), r_picks)
    np.testing.assert_array_equal(got[1].numpy(), r_valid)
    with pytest.warns(DeprecationWarning):
        sel, _ = T.scheme_selection(exps[0], scheme, policy, 4)
    assert len(sel) == port.num_strata
    with pytest.warns(DeprecationWarning):
        spec = T.SweepSpec(apps=(APP,), scheme=scheme, policy=policy)
    assert spec.plan == tplan.SamplingPlan.from_strings(scheme, policy)
    assert (spec.scheme, spec.policy) == (spec.plan.scheme,
                                          spec.plan.policy_name)


def test_sweep_spec_string_checks_match_reference():
    plan = tplan.SamplingPlan.from_strings("rfv", "mean")
    with pytest.raises(ValueError, match="conflict"):
        T.SweepSpec(scheme="bbv", plan=plan)
    with pytest.raises(ValueError, match="conflict"):
        T.SweepSpec(policy="centroid", plan=plan)
    with pytest.raises(ValueError, match="no selection policy"):
        T.SweepSpec(scheme="srs", policy="mean")
    with pytest.raises(ValueError, match="unknown stratifier"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            T.SweepSpec(scheme="nope")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        spec = T.SweepSpec(scheme="srs")            # srs never warns
    assert spec.plan is None and spec.policy is None
    spec = T.SweepSpec(plan=plan)
    assert (spec.scheme, spec.policy) == ("rfv", "mean")
