"""The port's sampled evaluation and its estimators against the
reference's, on the CPU.

Both ``SampledEval`` classes see the same corpus (``eval_batch`` is
shared numpy), draw the same phase-1 and CI samples (numpy) and the same
k-means seeds (threefry), so the phase-1 indices, stratum labels,
weights and selected batches must be equal exactly, and the three
estimates agree to rtol 1e-9 (float64 sums in another order). The
scalar estimators are held against the reference's on random inputs to
the same rtol; the reference test's two assertions run on the port.
"""

import warnings

import numpy as np
import pytest

from repro.core import sampling as JS
from repro.train.sampled_eval import SampledEval as JaxSampledEval
from repro_torch.core import sampling as TS
from repro_torch.train.sampled_eval import SampledEval

RTOL = 1e-9


def _make_corpus(n=500, seed=0):
    """The reference test's corpus: loss follows a latent difficulty."""
    rng = np.random.default_rng(seed)
    difficulty = rng.choice([1.0, 2.0, 4.0], size=n, p=[0.6, 0.3, 0.1])
    noise = rng.normal(0, 0.05, n)
    losses = difficulty + noise
    feats = np.stack([difficulty + rng.normal(0, 0.1, n),
                      rng.normal(0, 1, n)], axis=1)
    return losses, feats


def _estimates_close(a, b):
    np.testing.assert_allclose(b.mean, a.mean, rtol=RTOL)
    np.testing.assert_allclose(b.variance, a.variance, rtol=RTOL)
    assert a.n == b.n
    assert (a.df is None) == (b.df is None)
    if a.df is not None:
        np.testing.assert_allclose(b.df, a.df, rtol=RTOL)
    np.testing.assert_allclose(b.margin, a.margin, rtol=RTOL)


@pytest.mark.parametrize("seed,strata,n1,per", [(0, 6, 200, 6),
                                                (3, 8, 250, 3),
                                                (5, 16, 120, 4)])
def test_sampled_eval_equals_reference(seed, strata, n1, per):
    losses, feats = _make_corpus(seed=seed)

    def eval_batch(i):
        return float(losses[i]), feats[i]

    ref = JaxSampledEval(n_batches=500, eval_batch=eval_batch,
                         num_strata=strata)
    port = SampledEval(n_batches=500, eval_batch=eval_batch,
                       num_strata=strata, device="cpu")
    _estimates_close(ref.characterize(n1), port.characterize(n1))
    np.testing.assert_array_equal(port._idx1, ref._idx1)
    np.testing.assert_array_equal(port._labels, np.asarray(ref._labels))
    np.testing.assert_array_equal(port._weights, ref._weights)
    assert len(port._selected) == len(ref._selected)
    for mine, theirs in zip(port._selected, ref._selected):
        np.testing.assert_array_equal(mine, np.asarray(theirs))
    np.testing.assert_allclose(port.quick_estimate(), ref.quick_estimate(),
                               rtol=RTOL)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _estimates_close(ref.ci_check(per_stratum=per),
                         port.ci_check(per_stratum=per))


def test_sampled_eval_flow():
    """The reference test's first assertions, on the port."""
    losses, feats = _make_corpus()
    calls = {"n": 0}

    def eval_batch(i):
        calls["n"] += 1
        return float(losses[i]), feats[i]

    se = SampledEval(n_batches=500, eval_batch=eval_batch, num_strata=6,
                     device="cpu")
    est1 = se.characterize(n_phase1=200)
    true = losses.mean()
    assert est1.covers(true) or abs(est1.mean - true) / true < 0.05
    c0 = calls["n"]
    quick = se.quick_estimate()
    assert calls["n"] - c0 <= 6                 # one per stratum
    assert abs(quick - true) / true < 0.10
    ci = se.ci_check(per_stratum=6)
    assert ci.margin_pct < 16
    assert ci.covers(true) or abs(ci.mean - true) / true < 0.05


def test_quick_estimate_beats_same_budget_random():
    """The reference test's second assertion, on the port."""
    losses, feats = _make_corpus(seed=3)

    def eval_batch(i):
        return float(losses[i]), feats[i]

    se = SampledEval(n_batches=500, eval_batch=eval_batch, num_strata=8,
                     device="cpu")
    se.characterize(n_phase1=250)
    true = losses.mean()
    strat_err = abs(se.quick_estimate() - true)
    rng = np.random.default_rng(0)
    rand_errs = [abs(losses[rng.choice(500, 8, replace=False)].mean() - true)
                 for _ in range(200)]
    assert strat_err <= np.median(rand_errs) + 1e-9


@pytest.mark.parametrize("per_stratum", [1, 3])
def test_select_centroid_matches_reference(per_stratum):
    rng = np.random.default_rng(per_stratum)
    feats = rng.normal(size=(300, 4)).astype(np.float32)
    cents = rng.normal(size=(7, 4)).astype(np.float32)
    labels = rng.integers(0, 6, 300)           # stratum 6 stays empty
    want = JS.select_centroid(labels, feats, cents, per_stratum=per_stratum)
    got = TS.select_centroid(labels, feats, cents, per_stratum=per_stratum)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_weighted_point_estimate_matches_reference():
    rng = np.random.default_rng(11)
    y = rng.normal(2.0, 1.0, 50)
    sel = [rng.choice(50, 3, replace=False) for _ in range(5)] \
        + [np.array([], np.int64)]
    w = rng.dirichlet(np.ones(6))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = JS.weighted_point_estimate(sel, y, w)
        got = TS.weighted_point_estimate(sel, y, w)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    with pytest.raises(ValueError):
        TS.weighted_point_estimate(sel, y, w, strict=True)


@pytest.mark.parametrize("formula", ["phase2_only", "with_phase1_var"])
def test_summaries_and_two_phase_match_reference(formula):
    rng = np.random.default_rng(12)
    y = rng.normal(5.0, 2.0, 80)
    labs = rng.integers(0, 5, 80)
    w = rng.dirichlet(np.ones(5))
    want = JS.summarize_strata(y, labs, weights=w, num_strata=5)
    got = TS.summarize_strata(y, labs, weights=w, num_strata=5)
    for g, s in zip(got, want):
        assert g.n == s.n
        np.testing.assert_allclose([g.weight, g.mean, g.var],
                                   [s.weight, s.mean, s.var], rtol=RTOL)
    kw = {"phase1_var": 3.5} if formula == "with_phase1_var" else {}
    _estimates_close(JS.two_phase_estimate(want, 400, formula=formula, **kw),
                     TS.two_phase_estimate(got, 400, formula=formula, **kw))
    tables = TS.stratum_tables(y, labs, weights=w)
    _estimates_close(
        JS.two_phase_estimate_tables(JS.stratum_tables(y, labs, weights=w),
                                     400, formula=formula, **kw),
        TS.two_phase_estimate_tables(tables, 400, formula=formula, **kw))


def test_two_phase_coverage_contract_matches_reference():
    """An empty stratum warns and renormalises; a one-unit stratum warns
    and gives a NaN variance, in both packages."""
    y = np.array([1.0, 1.2, 3.0, 3.3, 7.0])
    labs = np.array([0, 0, 1, 1, 2])
    w = np.array([0.3, 0.3, 0.2, 0.2])
    with pytest.warns(UserWarning):
        want = JS.two_phase_estimate(
            JS.summarize_strata(y, labs, weights=w), 50)
    with pytest.warns(UserWarning):
        got = TS.two_phase_estimate(
            TS.summarize_strata(y, labs, weights=w), 50)
    np.testing.assert_allclose(got.mean, want.mean, rtol=RTOL)
    assert np.isnan(got.variance) and np.isnan(want.variance)
    with pytest.raises(ValueError):
        TS.two_phase_estimate(TS.summarize_strata(y, labs, weights=w), 50,
                              strict=True)
