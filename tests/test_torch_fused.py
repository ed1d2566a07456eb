"""The port's fused sweep on the CPU: against its own staged sweep, bit
for bit, and against the reference's staged sweep.

One port engine and one reference engine build ``("505.mcf_r",
"520.omnetpp_r")``; the reference runs with an explicit float32 policy
(its default needs the x64 mode jax 0.9.0 no longer has). For every
stratifier (bbv, rfv, dg) and policy (centroid, mean, random):

* port fused == port staged, bitwise: estimates, percent errors, picks,
  the memo mask and CPI, charges, hit/miss counters and ledgers (the two
  paths call the same torch functions in the same order);
* port fused against the reference's staged sweep from the same memo
  state (the port bank restored from the reference's snapshot): picks,
  pick validity, charges, hit/miss counters and ledgers exactly equal;
  estimates to rtol 1e-5 (float32 CPI from two compilers).

The dispatch marker reads ``fused=True, count=1`` for one sweep, and a
second identical sweep adds no program.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import repro.experiments as R
from repro.core.precision import PrecisionPolicy as RPolicy
from repro.core.sampling import plan as rplan
import repro_torch.experiments as T
from repro_torch.core.sampling import plan as tplan
from repro_torch.experiments import fused as tfused

APPS = ("505.mcf_r", "520.omnetpp_r")
CASES = [(s, p) for s in ("bbv", "rfv", "dg")
         for p in ("centroid", "mean", "random")]


@pytest.fixture(scope="module")
def engines():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = R.ExperimentEngine(precision=RPolicy())
            port = T.ExperimentEngine(device="cpu")
            ref.build(APPS)
            port.build(APPS)
            # every config column present, so snapshots cover the bank
            ref.memo.cols_for(ref.configs)
            port.memo.cols_for(port.configs)
            yield ref, port
    finally:
        torch.set_num_threads(threads)


def _run(engine, spec):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return T.run_sweep(engine, spec)


def _ledgers(engine):
    return [e.sim.ledger.regions_simulated for e in engine.build(APPS)]


def _state(engine):
    tree, _ = engine.memo.state()
    tree = {k: v for k, v in tree.items() if k != "version"}
    return tree, _ledgers(engine)


@pytest.mark.parametrize("scheme,policy", CASES)
def test_fused_equals_staged_bitwise(engines, scheme, policy):
    _, port = engines
    spec = T.SweepSpec(apps=APPS, selection_seed=3,
                       plan=tplan.SamplingPlan.from_strings(scheme, policy))
    snap = port.memo.state()
    fused = _run(port, spec)
    picks_f = port.fused_outputs["picks"].clone()
    after_fused = _state(port)
    port.memo.load_state(*snap)
    staged = _run(port, dataclasses.replace(spec, fused=False))
    after_staged = _state(port)
    picks_s, _, _ = T.plan_selection_bank(port.build(APPS), spec.plan,
                                          seed=3)
    assert torch.equal(picks_f, picks_s)
    for field in ("estimate", "err_pct", "n_units", "truth"):
        np.testing.assert_array_equal(fused.column(field),
                                      staged.column(field))
    for key, value in after_fused[0].items():
        np.testing.assert_array_equal(value, after_staged[0][key], key)
    assert after_fused[1] == after_staged[1]


@pytest.mark.parametrize("scheme,policy", CASES)
def test_fused_matches_reference_staged(engines, scheme, policy):
    ref, port = engines
    port.memo.load_state(*ref.memo.state(), universe=port.configs)
    before = (ref.memo.charges.copy(), list(ref.memo.hit_count),
              list(ref.memo.miss_count), _ledgers(ref))
    assert _ledgers(port) == before[3]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = R.run_sweep(ref, R.SweepSpec(
            apps=APPS, fused=False,
            plan=rplan.SamplingPlan.from_strings(scheme, policy)))
    got = _run(port, T.SweepSpec(
        apps=APPS, plan=tplan.SamplingPlan.from_strings(scheme, policy)))
    out = port.fused_outputs
    picks_r, valid_r, _ = R.plan_selection_bank(
        ref.build(APPS), rplan.SamplingPlan.from_strings(scheme, policy))
    np.testing.assert_array_equal(out["picks"].numpy(), picks_r)
    np.testing.assert_array_equal(out["valid"].numpy(), valid_r)
    np.testing.assert_allclose(got.column("estimate"),
                               want.column("estimate"), rtol=1e-5)
    np.testing.assert_array_equal(port.memo.charges, ref.memo.charges)
    assert port.memo.hit_count == ref.memo.hit_count
    assert port.memo.miss_count == ref.memo.miss_count
    assert _ledgers(port) == _ledgers(ref)
    assert not np.array_equal(before[0], ref.memo.charges) \
        or before[1] != ref.memo.hit_count


def test_one_dispatch_and_no_new_program_when_warm(engines):
    _, port = engines
    spec = T.SweepSpec(apps=APPS,
                       plan=tplan.SamplingPlan.from_strings("rfv", "mean"))
    assert spec.fused
    _run(port, spec)
    tplan._reset_sweep_dispatch()
    programs = tfused.fused_sweep_program.cache_info().currsize
    captures = tfused.program_captures()
    charges = port.memo.total_charges()
    _run(port, spec)
    marker = tplan.last_sweep_dispatch()
    assert marker["fused"] is True and marker["count"] == 1
    assert marker["in_place"] is True and marker["captured"] is False
    assert marker["batch_shape"] == (len(APPS), len(port.configs))
    assert tfused.fused_sweep_program.cache_info().currsize == programs
    assert tfused.program_captures() == captures
    assert port.memo.total_charges() == charges


def test_staged_sweep_records_a_staged_dispatch(engines):
    _, port = engines
    tplan._reset_sweep_dispatch()
    _run(port, T.SweepSpec(apps=APPS, fused=False,
                           plan=tplan.SamplingPlan.from_strings("dg")))
    marker = tplan.last_sweep_dispatch()
    assert marker["fused"] is False and marker["in_place"] is False
    assert marker["count"] == 1


def test_sweep_with_trials_attaches_the_study(engines):
    _, port = engines
    trials = T.TrialSpec(trials=512, config_index=6)
    spec = T.SweepSpec(apps=APPS, trials=trials,
                       plan=tplan.SamplingPlan.from_strings("dg"))
    table = _run(port, spec)
    mc = T.run_trials(port, dataclasses.replace(trials, schemes=("dg",)),
                      apps=APPS)
    at = table.filter(config_index=6)
    assert len(at) == len(APPS)
    np.testing.assert_array_equal(at.column("p95_err_pct"), mc.p95("dg"))
    np.testing.assert_array_equal(at.column("coverage"), mc.coverage["dg"])
    assert all(r.p95_err_pct is None for r in table.filter(config_index=0))
    lines = table.to_csv().splitlines()
    assert lines[0].endswith("p95_err_pct,ci_half_pct,coverage")
    assert len(lines) == len(table) + 1


def test_sweep_spec_checks_the_trial_config():
    with pytest.raises(ValueError, match="config_indices"):
        T.SweepSpec(config_indices=(0, 1), trials=T.TrialSpec(config_index=6))


def test_known_schemes_match_reference():
    assert T.known_schemes() == R.known_schemes()
    assert tplan.registered_policies() == rplan.registered_policies() \
        == ("centroid", "mean", "random", "ranked_set")


def test_memo_version_moves_on_every_mutation(engines):
    _, port = engines
    v0 = port.memo.version
    port.memo.touch()
    assert port.memo.version == v0 + 1
    snap = port.memo.state()
    port.memo.touch()
    port.memo.load_state(*snap)
    # rolling back past a later version moves forward, never back
    assert port.memo.version == v0 + 3
