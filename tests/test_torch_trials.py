"""The port's streaming Monte-Carlo trials against the reference, on the CPU.

Both engines build ``("505.mcf_r", "520.omnetpp_r")``; the reference runs
with an explicit float32 policy (its default needs the x64 mode jax 0.9.0
no longer has) and the port on ``device="cpu"``. Held to:

* the uniforms behind every scheme bitwise equal (the threefry port and
  the block contract ``fold_in(fold_in(key, b), a)``);
* per-trial estimates and CI half-widths to rtol 1e-5 (float32 sums in
  another order), percent errors to the absolute error that an estimate
  rtol of 1e-5 allows (100 * 1e-5 * estimate / truth: errors near zero
  have no relative tolerance), NaN where the reference has NaN;
* trial counts exactly; coverage counts exactly except at near-ties,
  where |estimate - truth| lies within 1e-5 relative of the half-width
  (either side is right there; the test counts them);
* the p95 |error| within one sketch bin;
* within the port, chunked equal to unchunked in every ``TrialStats``
  leaf and every kept array, bit for bit (the reference meets this only
  to rounding).

The building blocks are held on seeded numpy inputs: the collapsed-pairs
variance and ``trial_stats_update`` (counters exact, histogram bins
exact except where a value lies within 1e-6 relative of a bin edge, where
float32 ``log`` may round either way; moments rtol 1e-6), and the batched
``fold_in`` against its int path and ``jax.random.fold_in``.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.experiments as R
from repro.core.precision import PrecisionPolicy as RPolicy
from repro.core.sampling import plan as rplan
from repro.core.sampling import tables as rtables
from repro.experiments import montecarlo as rmc
import repro_torch.experiments as T
from repro_torch import prng
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.sampling import plan as tplan
from repro_torch.core.sampling import tables as ttables
from repro_torch.experiments import engine as tengine
from repro_torch.experiments import montecarlo as tmc

APPS = ("505.mcf_r", "520.omnetpp_r")
SCHEMES = ("random", "bbv", "rfv", "dg")
TRIALS = 1024
TIE_RTOL = 1e-5


@pytest.fixture(scope="module")
def runs():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = R.ExperimentEngine(precision=RPolicy())
            port = T.ExperimentEngine(device="cpu")
            spec_r = R.TrialSpec(trials=TRIALS, keep_trials=True)
            spec_t = T.TrialSpec(trials=TRIALS, keep_trials=True)
            res_r = R.run_trials(ref, spec_r, apps=APPS)
            res_t = T.run_trials(port, spec_t, apps=APPS)
            chunked = T.run_trials(
                port, dataclasses.replace(spec_t, chunk_size=T.TRIAL_BLOCK),
                apps=APPS)
    finally:
        torch.set_num_threads(threads)
    truth = np.stack([e.truth[spec_r.config_index]
                      for e in ref.build(APPS)])
    return ref, port, res_r, res_t, chunked, truth


@pytest.mark.parametrize("scheme", SCHEMES)
def test_trial_uniforms_bitwise(scheme):
    spec = rmc.TrialSpec(trials=600, schemes=(scheme,))
    want = rmc.trial_uniforms(spec, scheme, 3, 7)
    got = T.trial_uniforms(T.TrialSpec(trials=600, schemes=(scheme,)),
                           scheme, 3, 7, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_kept_trials_match_reference(runs, scheme):
    _, _, res_r, res_t, _, truth = runs
    est_r, est_t = res_r.estimates[scheme], res_t.estimates[scheme]
    assert est_t.shape == est_r.shape == (len(APPS), TRIALS)
    np.testing.assert_allclose(est_t, est_r, rtol=1e-5)
    np.testing.assert_allclose(
        res_t.half_widths[scheme], res_r.half_widths[scheme], rtol=1e-5)
    atol = 100.0 * 1e-5 * np.abs(est_r) / truth[:, None]
    err_r, err_t = res_r.errors[scheme], res_t.errors[scheme]
    assert (np.abs(err_t - err_r) <= atol).all()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_counts_and_coverage_match_reference(runs, scheme):
    _, _, res_r, res_t, _, truth = runs
    st_r, st_t = res_r.stats[scheme], res_t.stats[scheme]
    np.testing.assert_array_equal(st_t.count.numpy(), np.asarray(st_r.count))
    np.testing.assert_array_equal(st_t.count.numpy(), [TRIALS] * len(APPS))
    # near-ties: |est - truth| within TIE_RTOL of the half-width, where
    # either side of the comparison is right
    gap = np.abs(res_r.estimates[scheme] - truth[:, None].astype(np.float32))
    half = res_r.half_widths[scheme]
    ties = (np.abs(gap - half) <= TIE_RTOL * np.abs(half)).sum(axis=1)
    diff = np.abs(st_t.cover.numpy() - np.asarray(st_r.cover))
    assert (diff <= ties).all(), (diff, ties)
    np.testing.assert_array_equal(st_t.half_n.numpy(),
                                  np.asarray(st_r.half_n))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_p95_within_one_bin(runs, scheme):
    _, _, res_r, res_t, _, _ = runs
    step = np.exp(rtables._HIST_LOG_SPAN / rtables.TRIAL_HIST_BINS)
    ratio = res_t.p95(scheme) / res_r.p95(scheme)
    assert ((ratio <= step * (1 + 1e-9)) & (ratio >= 1 / step
                                            * (1 - 1e-9))).all()
    np.testing.assert_allclose(res_t.stats[scheme].half_mean,
                               np.asarray(res_r.stats[scheme].half_mean),
                               rtol=1e-5)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_chunked_equals_unchunked_bitwise(runs, scheme):
    _, _, _, res_t, chunked, _ = runs
    for a, b in zip(res_t.stats[scheme].leaves(),
                    chunked.stats[scheme].leaves()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for field in ("estimates", "errors", "half_widths"):
        np.testing.assert_array_equal(getattr(res_t, field)[scheme],
                                      getattr(chunked, field)[scheme])


def test_streamed_readouts(runs):
    _, _, _, res_t, _, truth = runs
    for scheme in SCHEMES:
        st = res_t.stats[scheme]
        cover = np.where(np.isnan(res_t.half_widths[scheme]), False,
                         np.abs(res_t.estimates[scheme]
                                - truth[:, None].astype(np.float32))
                         <= np.nan_to_num(res_t.half_widths[scheme]))
        np.testing.assert_allclose(res_t.coverage[scheme],
                                   cover.mean(axis=1), atol=2.0 / TRIALS)
        np.testing.assert_allclose(st.half_mean, np.nanmean(
            res_t.half_widths[scheme], axis=1), rtol=1e-4)
        np.testing.assert_allclose(
            res_t.half_width_pct(scheme, truth),
            100.0 * st.half_mean / truth, rtol=0)


@pytest.mark.parametrize("size", [100, 0, -256])
def test_chunk_size_validation(size):
    with pytest.raises(ValueError, match="multiple of TRIAL_BLOCK"):
        T.TrialSpec(chunk_size=size)


def test_unknown_scheme_rejected():
    with pytest.raises(ValueError, match="unknown trial scheme"):
        T.TrialSpec(schemes=("nope",))


def test_warm_run_trials_builds_no_new_program(runs):
    _, port, _, _, _, _ = runs
    spec = T.TrialSpec(trials=2 * T.TRIAL_BLOCK, schemes=("random", "dg"))
    T.run_trials(port, spec, apps=APPS)
    programs = tmc._streaming_program.cache_info().currsize
    captures = tmc.program_captures()
    T.run_trials(port, spec, apps=APPS)
    assert tmc._streaming_program.cache_info().currsize == programs
    assert tmc.program_captures() == captures


def test_float64_trace_policy_is_refused(runs):
    _, port, _, _, _, _ = runs
    spec = T.TrialSpec(trials=256, schemes=("random",),
                       precision=PrecisionPolicy.host_parity())
    with pytest.raises(ValueError, match="float32 uniforms"):
        T.run_trials(port, spec, apps=APPS)


def test_charged_pool_fill_charges_once(runs):
    _, port, _, _, _, _ = runs
    spec = T.TrialSpec(trials=256, schemes=("dg",))
    before = port.memo.total_charges()
    pool = tmc.charged_pool_fill(port, spec, APPS)
    assert pool.shape == port.stack(APPS).idx1.shape
    assert port.memo.total_charges() == before       # paid by the fixture
    assert tmc.charged_pool_fill(
        port, dataclasses.replace(spec, schemes=("bbv",)), APPS) is None


@pytest.mark.parametrize("scheme", SCHEMES + ("my_plugin",))
def test_trial_scheme_index_matches_reference(scheme):
    assert tplan.trial_scheme_index(scheme, T.TRIAL_SCHEMES) == \
        rplan.trial_scheme_index(scheme, rmc.TRIAL_SCHEMES)


def test_stratum_tables_match_reference(runs):
    ref, port, _, _, _, _ = runs
    bank_r = rplan.make_stratifier("rfv").resolve(ref.build(APPS))
    bank_t = port.stratum_bank(tplan.make_stratifier("rfv"), APPS)
    want = R.engine.stratum_tables(bank_r.labels, bank_r.valid, 20)
    got = tengine.stratum_tables(bank_t.labels, bank_t.valid, 20)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


# ------------------------------------------------------- building blocks
@pytest.mark.parametrize("n_valid", [[0, 1, 2, 3], [4, 5, 19, 20],
                                     [7, 7, 10, 11]])
def test_collapsed_pairs_variance_matches_reference(n_valid):
    rng = np.random.default_rng(sum(n_valid))
    y = rng.normal(2.0, 0.5, (4, 6, 20)).astype(np.float32)
    w = rng.dirichlet(np.ones(20), size=4).astype(np.float32)[:, None, :]
    nv = np.asarray(n_valid, np.int32)[:, None]
    var_r, df_r = rtables.collapsed_pairs_variance(y, w, nv, num_strata=20)
    var_t, df_t = ttables.collapsed_pairs_variance(
        torch.as_tensor(y), torch.as_tensor(w), torch.as_tensor(nv),
        num_strata=20)
    np.testing.assert_allclose(var_t.numpy(), var_r, rtol=1e-6)
    np.testing.assert_array_equal(df_t.numpy(), df_r)


def _edge_distance(x):
    """Relative distance of each x from its nearest log-grid bin edge."""
    pos = (np.log(x.astype(np.float64)) - rtables._HIST_LOG_LO) \
        * (rtables.TRIAL_HIST_BINS / rtables._HIST_LOG_SPAN)
    return np.abs(pos - np.round(pos)) \
        * rtables._HIST_LOG_SPAN / rtables.TRIAL_HIST_BINS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trial_stats_update_matches_reference(seed):
    rng = np.random.default_rng(seed)
    err = np.abs(rng.lognormal(0.0, 2.0, (3, 512))).astype(np.float32)
    half = np.abs(rng.lognormal(-1.0, 1.0, (3, 512))).astype(np.float32)
    err[0, :7] = np.nan
    half[1, 3:9] = np.inf
    covered = rng.random((3, 512)) < 0.9
    valid = np.arange(512)[None, :] < 500
    init_r = rtables.trial_stats_init((3,), accum_dtype=np.float32)
    got_r = rtables.trial_stats_update(init_r, err, half, covered, valid)
    init_t = ttables.trial_stats_init((3,))
    got_t = ttables.trial_stats_update(
        init_t, torch.as_tensor(err), torch.as_tensor(half),
        torch.as_tensor(covered), torch.as_tensor(valid), block=256)
    for name in ("count", "cover", "half_n"):
        np.testing.assert_array_equal(getattr(got_t, name).numpy(),
                                      getattr(got_r, name))
    for name in ("err_sum", "err_sumsq", "half_sum", "half_sumsq"):
        np.testing.assert_allclose(getattr(got_t, name).numpy(),
                                   getattr(got_r, name), rtol=1e-6)
    for name, vals in (("err_hist", err), ("half_hist", half)):
        h_t, h_r = getattr(got_t, name).numpy(), getattr(got_r, name)
        assert h_t.sum() == h_r.sum()
        moved = np.abs(h_t - h_r).sum() // 2
        ok = np.isfinite(vals) & valid
        near = (_edge_distance(np.where(ok, vals, 1.0)) <= 1e-6) & ok
        assert moved <= near.sum()
    merged = ttables.trial_stats_merge(got_t, got_t)
    np.testing.assert_array_equal(merged.count.numpy(),
                                  2 * got_t.count.numpy())
    np.testing.assert_allclose(got_t.coverage, got_r.coverage, rtol=0)
    np.testing.assert_allclose(got_t.err_quantile(0.95),
                               got_r.err_quantile(0.95), rtol=0)


def test_fixed_sum_is_order_fixed_and_exact_on_integers():
    x = torch.arange(1.0, 21.0).reshape(1, 20).expand(5, 20)
    assert torch.equal(ttables.fixed_sum(x), torch.full((5,), 210.0))
    y = torch.randn(3, 7, 37, generator=torch.Generator().manual_seed(0))
    assert torch.equal(ttables.fixed_sum(y)[1:2],
                       ttables.fixed_sum(y[1:2]))


def test_fold_in_batched_equals_int_path_and_jax():
    key = prng.PRNGKey(7)
    data = torch.tensor([0, 1, 5, 255, 2**31 - 1, -3])
    batched = prng.fold_in(key, data)
    for i, d in enumerate(data.tolist()):
        assert torch.equal(batched[i], prng.fold_in(key, d))
        want = np.asarray(jax.random.fold_in(
            jax.random.PRNGKey(7), np.uint32(d & 0xFFFFFFFF)))
        np.testing.assert_array_equal(batched[i].numpy(),
                                      want.astype(np.int64))
    keys = prng.fold_in(batched[:, None, :], torch.arange(3)[None, :])
    assert keys.shape == (6, 3, 2)
    assert torch.equal(keys[4, 2], prng.fold_in(prng.fold_in(key, 2**31 - 1),
                                                2))

