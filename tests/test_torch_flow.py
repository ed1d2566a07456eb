"""The port's two-phase flow (paper Fig 14) against the reference, on the
CPU.

Both ``TwoPhaseFlow``s run ``520.omnetpp_r`` from
``np.random.default_rng(11)``, as ``tests/test_two_phase_e2e.py`` does:
phase 1 of 900 regions measured by ``CachedSimulator.simulate_rfv`` on
config 0, stratified by ``RFVClusters``, ``BBVClusters`` (on the phase-1
units' projected BBVs) and ``DaleniusGurney``, picked by ``Centroid``,
``StratumMean``, ``RandomUnit`` and ``RankedSetUnit``, then estimated on
configs 0-6 (``point_estimate``), by collapsed pairs on config 6 and by a
multi-unit ``ci_check``.

Held to: phase-1 indices, picks and ledgers exactly; labels exactly
except at near-ties (the reference's two best squared distances within
1e-5 relative), which are counted; z-scores bitwise where both flows get
the same features; estimates, means and margins to rtol 1e-5 (float32 CPI
from two compilers); ``n`` and ``df`` of the collapsed CI exactly. The
deprecated string spellings warn, and a keyword that conflicts with a
plan object raises, as in the reference. A reference ``Stratification``'s
arrays carry into the port unchanged.
"""

from __future__ import annotations

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.core.sampling as RS
from repro.core.clustering import random_project as r_project
from repro.simcpu import CONFIGS as RCONFIGS
from repro.simcpu import get_bbvs as r_bbvs
from repro.simcpu import make_cached_simulator as r_cached
import repro_torch.core.sampling as TS
from repro_torch import prng
from repro_torch.core.clustering import random_project as t_project
from repro_torch.experiments.paper_figs import TIE_RTOL
from repro_torch.simcpu import CONFIGS as TCONFIGS
from repro_torch.simcpu import get_bbvs as t_bbvs
from repro_torch.simcpu import make_cached_simulator as t_cached

APP = "520.omnetpp_r"
N1 = 900
SCHEMES = {"rfv": (RS.RFVClusters, TS.RFVClusters),
           "bbv": (RS.BBVClusters, TS.BBVClusters),
           "dg": (RS.DaleniusGurney, TS.DaleniusGurney)}
POLICIES = {"centroid": (RS.Centroid(), TS.Centroid()),
            "mean": (RS.StratumMean(), TS.StratumMean()),
            "random": (RS.RandomUnit(), TS.RandomUnit()),
            "ranked_set": (RS.RankedSetUnit(), TS.RankedSetUnit())}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def near_tie_count(got_labels, want_labels, z, centroids) -> int:
    """Labels that differ; each must sit at a near-tie of the reference's
    fit (its two best squared distances within ``TIE_RTOL``)."""
    diff = np.flatnonzero(_np(got_labels) != _np(want_labels))
    if diff.size:
        zz = np.asarray(z, np.float64)[diff]
        d2 = ((zz[:, None, :] - np.asarray(centroids, np.float64)[None])
              ** 2).sum(-1)
        best = np.sort(d2, axis=1)[:, :2]
        assert (best[:, 1] - best[:, 0] <= TIE_RTOL * best[:, 0]).all()
    return int(diff.size)


@pytest.fixture(scope="module")
def flows():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        rsim, tsim = r_cached(APP), t_cached(APP, device="cpu")
        rflow = RS.TwoPhaseFlow(population_size=rsim.pop.n_regions,
                                rng=np.random.default_rng(11))
        tflow = TS.TwoPhaseFlow(population_size=tsim.pop.n_regions,
                                rng=np.random.default_rng(11), device="cpu")
        r1 = rflow.characterize(
            lambda i: rsim.simulate_rfv(i, RCONFIGS[0]), N1)
        t1 = tflow.characterize(
            lambda i: tsim.simulate_rfv(i, TCONFIGS[0]), N1)
        r_bbv = np.asarray(r_project(r_bbvs(rsim.pop)[r1[0]], 15,
                                     key=jax.random.PRNGKey(0)))
        t_bbv = t_project(torch.from_numpy(t_bbvs(tsim.pop)[_np(t1[0])]),
                          15, key=prng.PRNGKey(0))
        feats = {"rfv": (r1[2], t1[2]), "bbv": (r_bbv, t_bbv),
                 "dg": (None, None)}
        strats = {}
        for name, (rcls, tcls) in SCHEMES.items():
            strats[name] = (
                rflow.stratify(r1[0], r1[1], feats[name][0],
                               scheme=rcls(num_strata=20)),
                tflow.stratify(t1[0], t1[1], feats[name][1],
                               scheme=tcls(num_strata=20)))
    finally:
        torch.set_num_threads(threads)
    return rsim, tsim, rflow, tflow, r1, t1, strats


def test_phase1_matches(flows):
    _, _, _, _, r1, t1, _ = flows
    np.testing.assert_array_equal(_np(t1[0]), r1[0])
    np.testing.assert_allclose(_np(t1[1]), r1[1], rtol=1e-5)
    np.testing.assert_allclose(_np(t1[2]), r1[2], rtol=1e-5, atol=1e-7)
    assert t1[2].dtype == torch.float64 and t1[2].shape == (N1, 38)
    assert t1[3].n == r1[3].n
    np.testing.assert_allclose([t1[3].mean, t1[3].margin],
                               [r1[3].mean, r1[3].margin], rtol=1e-5)


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_stratification_matches(flows, scheme):
    *_, strats = flows
    r, t = strats[scheme]
    ties = near_tie_count(t.labels, r.labels, r.features, r.centroids)
    print(f"{scheme}: {ties} labels differ, all at near-ties")
    np.testing.assert_allclose(_np(t.weights), r.weights,
                               atol=ties / N1 + 1e-15)
    assert t.scheme == r.scheme and t.num_strata == r.num_strata
    if ties == 0:
        np.testing.assert_allclose(_np(t.centroids), r.centroids,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scheme", ["rfv", "bbv"])
def test_shared_features_give_reference_zscores(flows, scheme):
    """The same feature matrix into both stratifiers: the z-scores agree
    bit for bit (a float64 fit applied in float32), and the labels."""
    _, _, rflow, tflow, r1, _, strats = flows
    r = strats[scheme][0]
    feats = r1[2] if scheme == "rfv" else None
    if feats is None:
        rsim = flows[0]
        feats = np.asarray(r_project(r_bbvs(rsim.pop)[r1[0]], 15,
                                     key=jax.random.PRNGKey(0)))
    t = tflow.stratify(torch.tensor(r1[0]), torch.tensor(r1[1]),
                       torch.tensor(np.asarray(feats)),
                       scheme=SCHEMES[scheme][1](num_strata=20))
    np.testing.assert_array_equal(_np(t.features), r.features)
    ties = near_tie_count(t.labels, r.labels, r.features, r.centroids)
    print(f"{scheme} on shared features: {ties} near-tie labels")


@pytest.mark.parametrize("scheme", list(SCHEMES))
@pytest.mark.parametrize("policy", list(POLICIES))
def test_picks_match(flows, scheme, policy):
    _, _, rflow, tflow, _, _, strats = flows
    r, t = strats[scheme]
    if not np.array_equal(_np(t.labels), r.labels):
        pytest.fail(f"{scheme}: labels differ at near-ties; picks not "
                    "comparable")
    rp, tp = POLICIES[policy]
    want = rflow.select(r, policy=rp, seed=5)
    got = tflow.select(t, policy=tp, seed=5)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_estimates_match(flows, scheme):
    rsim, tsim, rflow, tflow, _, _, strats = flows
    r, t = strats[scheme]
    rsel = rflow.select(r, policy=RS.Centroid())
    tsel = tflow.select(t, policy=TS.Centroid())
    for c in range(7):
        want = rflow.point_estimate(
            r, rsel, lambda i, c=c: rsim.simulate_cpi(i, RCONFIGS[c]))
        got = tflow.point_estimate(
            t, tsel, lambda i, c=c: tsim.simulate_cpi(i, TCONFIGS[c]))
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    rsel = rflow.select(r, policy=RS.RandomUnit(), seed=5)
    tsel = tflow.select(t, policy=TS.RandomUnit(), seed=5)
    want = rflow.collapsed_ci(r, rsel,
                              lambda i: rsim.simulate_cpi(i, RCONFIGS[6]))
    got = tflow.collapsed_ci(t, tsel,
                             lambda i: tsim.simulate_cpi(i, TCONFIGS[6]))
    assert (got.n, got.df) == (want.n, want.df)
    np.testing.assert_allclose([got.mean, got.margin],
                               [want.mean, want.margin], rtol=1e-5)
    for per in (2, 8):
        sizes = np.full(20, per)
        want = rflow.ci_check(r, lambda i: rsim.simulate_cpi(i, RCONFIGS[6]),
                              per_stratum_sizes=sizes, seed=per)
        got = tflow.ci_check(t, lambda i: tsim.simulate_cpi(i, TCONFIGS[6]),
                             per_stratum_sizes=sizes, seed=per)
        assert got.n == want.n
        np.testing.assert_allclose(
            [got.mean, got.variance, got.df, got.margin],
            [want.mean, want.variance, want.df, want.margin], rtol=1e-5)
    assert tsim.ledger.regions_simulated == rsim.ledger.regions_simulated
    assert (tsim.hits, tsim.misses) == (rsim.hits, rsim.misses)


def test_reference_stratification_carries_over(flows):
    rsim, tsim, rflow, tflow, _, _, strats = flows
    r = strats["rfv"][0]
    carried = TS.Stratification(**dataclasses.asdict(r))
    assert isinstance(carried.labels, torch.Tensor)
    np.testing.assert_array_equal(_np(carried.stratum_order_key()),
                                  r.stratum_order_key())
    for policy in ("centroid", "mean", "random"):
        rp, tp = POLICIES[policy]
        want = rflow.select(r, policy=rp, seed=2)
        got = tflow.select(carried, policy=tp, seed=2)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]


def test_argument_checks_and_deprecations(flows):
    _, _, _, tflow, _, t1, _ = flows
    idx, y0, feats, _ = t1
    rfv = TS.RFVClusters(num_strata=20)
    for kw in ({"num_strata": 10}, {"seed": 3}, {"kmeans_backend": "plain"}):
        with pytest.raises(ValueError, match="conflicts"):
            tflow.stratify(idx, y0, feats, scheme=rfv, **kw)
    # equal values do not conflict
    tflow.stratify(idx, y0, None, scheme=TS.DaleniusGurney(num_strata=20),
                   num_strata=20, seed=0)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        via_str = tflow.stratify(idx, y0, None, scheme="cpi", num_strata=20)
    assert via_str.scheme == "dg"
    with pytest.raises(ValueError, match="num_strata"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tflow.stratify(idx, y0, feats, scheme="rfv")
    strat = tflow.stratify(idx, y0, None,
                           scheme=TS.DaleniusGurney(num_strata=20))
    with pytest.warns(DeprecationWarning):
        sel = tflow.select(strat, policy="random", per_stratum=2, seed=1)
    assert all(s.numel() == 2 for s in sel)
    with pytest.raises(NotImplementedError):
        tflow.select(strat, policy=TS.RankedSetUnit(), per_stratum=2)
    with pytest.raises(ValueError, match="at least 2"):
        tflow.ci_check(strat, lambda i: torch.ones(len(i)),
                       per_stratum_sizes=np.zeros(20, np.int64))
