"""The port's serving layer on the CPU: coalesced == serial, bitwise, the
memo's eviction and spill accounting, and the ``SweepService`` loop.

Counterpart of ``tests/test_serving.py``, case by case, over
``("505.mcf_r", "520.omnetpp_r")`` and configs 0-2: a coalesced batch of
same-shape sweep requests equals the same requests run one by one through
``run_sweep``, bit for bit, in estimates AND the shared bank's tables,
charges, counters and ledgers; a dropped column is charged again exactly
once; a spilled one comes back free; every evict, spill and unspill bumps
``MemoBank.version``, and eviction clears columns in place (the tables
are never reallocated, so captured graphs keep reading them). On top of
that, the port against the reference's float32 paths (its default policy
needs the x64 mode jax 0.9.0 no longer has): the same coalesced batch and
the RFV requests of the same service stream give the reference's
``n_units``, dispatch counts, charges, counters, mask and ledgers exactly,
and estimates to rtol 1e-5.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import repro.experiments as R
import repro.serving as RS
from repro.core.precision import PrecisionPolicy as RPolicy
from repro.core.sampling import plan as rplan
from repro_torch.core.sampling import plan as sampling_plan
from repro_torch.core.sampling.plan import (Centroid, RFVClusters,
                                            RandomUnit, SamplingPlan)
from repro_torch.experiments.engine import ExperimentEngine
from repro_torch.experiments.montecarlo import TrialSpec, run_trials
from repro_torch.experiments.sweep import SweepSpec, run_sweep
from repro_torch.serving import (SweepService, coalesce_key, coalescible,
                                 prepare_sweep, run_coalesced_sweeps)
from repro_torch.serving.cli import main as cli_main
from repro_torch.serving.cli import synthetic_stream
from repro_torch.simcpu.cache import MemoBank
from repro_torch.simcpu.simulator import Ledger
from repro_torch.simcpu.uarch import CONFIGS

APPS = ("505.mcf_r", "520.omnetpp_r")
CFGS = (0, 1, 2)
RTOL = 1e-5
ERR_ATOL = 100 * RTOL * 2


@pytest.fixture(scope="module")
def engines():
    """(port engine, reference float32 engine), both built, every config
    column registered, so their memo states line up and resets never
    meet a grown table."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            port = ExperimentEngine(device="cpu")
            port.build(APPS)
            port.memo.cols_for(port.configs)
            ref = R.ExperimentEngine(precision=RPolicy())
            ref.build(APPS)
            ref.memo.cols_for(ref.configs)
            yield port, ref
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def engine(engines):
    """The port engine, its memo put back after the test."""
    port, _ = engines
    before = _memo_state(port.memo)
    yield port
    _memo_reset(port.memo, before)


def _memo_state(memo):
    return memo.state()


def _memo_reset(memo, state):
    tree, meta = state
    memo.load_state(tree, meta, universe=memo.configs)
    memo._col_tick.clear()


def _tables(memo):
    tree, _ = memo.state()
    return tree


def _assert_same_tables(a, b):
    for k in ("mask", "cpi", "charges", "hit_count", "miss_count",
              "ledger_regions", "ledger_instr"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _ledger_totals(memo):
    return [None if lg is None else lg.regions_simulated
            for lg in memo.ledgers]


def _quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kw)


def _mixed_specs(module=None):
    """3 same-shape RandomUnit requests (stacked) + 2 identical Centroid
    requests (duplicates), in the port's or the reference's types."""
    if module is None:
        plan_r = SamplingPlan(RFVClusters(), RandomUnit())
        plan_c = SamplingPlan(RFVClusters(), Centroid())
        spec = SweepSpec
    else:
        plan_r = rplan.SamplingPlan(rplan.RFVClusters(), rplan.RandomUnit())
        plan_c = rplan.SamplingPlan(rplan.RFVClusters(), rplan.Centroid())
        spec = R.SweepSpec
    return [spec(apps=APPS, plan=plan_r, config_indices=CFGS,
                 selection_seed=s) for s in (1, 2, 3)] + [
        spec(apps=APPS, plan=plan_c, config_indices=CFGS),
        spec(apps=APPS, plan=plan_c, config_indices=CFGS)]


# ------------------------------------------------ coalescing == serial
def test_coalesced_matches_serial_bitwise(engine):
    """K coalesced same-shape sweeps == K serial run_sweep calls:
    estimates, memo tables, charges, counters, ledgers, all bitwise."""
    before = _memo_state(engine.memo)
    serial = [_quiet(run_sweep, engine, s) for s in _mixed_specs()]
    state_serial = _tables(engine.memo)
    _memo_reset(engine.memo, before)

    coal = _quiet(run_coalesced_sweeps, engine, _mixed_specs())
    state_coal = _tables(engine.memo)

    marker = sampling_plan.last_sweep_dispatch()
    assert marker["coalesced"] == 2
    assert marker["batch_shape"] == (2 * len(APPS), len(CFGS))

    for st, ct in zip(serial, coal):
        for col in ("estimate", "err_pct", "truth", "n_units"):
            assert np.asarray(st.column(col), float).tobytes() == \
                np.asarray(ct.column(col), float).tobytes()
        assert [r.app for r in st.rows] == [r.app for r in ct.rows]
    _assert_same_tables(state_serial, state_coal)


def test_coalesced_matches_reference(engines):
    """The same batch through the reference's float32 batcher from the
    same memo state: counters, charges, mask and ledgers exactly,
    ``n_units`` exactly, estimates to rtol 1e-5."""
    port, ref = engines
    before_p, before_r = _memo_state(port.memo), ref.memo.state()
    try:
        got = _quiet(run_coalesced_sweeps, port, _mixed_specs())
        want = _quiet(RS.run_coalesced_sweeps, ref, _mixed_specs(R))
        for g, w in zip(got, want):
            assert list(g.column("n_units")) == list(w.column("n_units"))
            np.testing.assert_allclose(g.column("estimate"),
                                       w.column("estimate"), rtol=RTOL)
            assert (np.abs(g.column("err_pct") - w.column("err_pct"))
                    <= ERR_ATOL + RTOL * w.column("err_pct")).all()
        tp, tr = _tables(port.memo), ref.memo.state()[0]
        for k in ("mask", "charges", "hit_count", "miss_count",
                  "ledger_regions", "ledger_instr"):
            np.testing.assert_array_equal(tp[k], np.asarray(tr[k]),
                                          err_msg=k)
        np.testing.assert_allclose(tp["cpi"][tr["mask"]],
                                   tr["cpi"][tr["mask"]], rtol=RTOL)
    finally:
        _memo_reset(port.memo, before_p)
        ref.memo.load_state(*before_r, universe=ref.configs)


def test_coalesce_key_and_predicate(engine):
    plan = SamplingPlan(RFVClusters(), Centroid())
    a = prepare_sweep(engine, SweepSpec(apps=APPS, plan=plan,
                                        config_indices=CFGS))
    b = prepare_sweep(engine, SweepSpec(apps=APPS, plan=plan,
                                        config_indices=CFGS,
                                        selection_seed=9))
    assert coalesce_key(a) == coalesce_key(b)
    c = prepare_sweep(engine, SweepSpec(apps=APPS, plan=plan,
                                        config_indices=(0, 1)))
    assert coalesce_key(a) != coalesce_key(c)

    assert coalescible(SweepSpec(apps=APPS, plan=plan))
    assert not coalescible(SweepSpec(apps=APPS))
    assert not coalescible(SweepSpec(apps=APPS, plan=plan, fused=False))
    assert not coalescible(
        SweepSpec(apps=APPS, plan=plan, trials=TrialSpec(trials=4)))


def test_singleton_groups_fall_back_to_serial(engine):
    spec = SweepSpec(apps=APPS, plan=SamplingPlan(RFVClusters(), Centroid()),
                     config_indices=CFGS)
    before = _memo_state(engine.memo)
    direct = _quiet(run_sweep, engine, spec)
    _memo_reset(engine.memo, before)
    (via_batcher,) = _quiet(run_coalesced_sweeps, engine, [spec])
    marker = sampling_plan.last_sweep_dispatch()
    assert "coalesced" not in marker
    np.testing.assert_array_equal(direct.column("estimate"),
                                  via_batcher.column("estimate"))


def test_group_inputs_are_kept_by_the_engine(engine):
    """A repeat of the same group reuses its stacked inputs from
    ``engine.groups``; the cache holds at most ``GROUP_CACHE_CAP``."""
    from repro_torch.serving import batcher

    _quiet(run_coalesced_sweeps, engine, _mixed_specs())
    kept = dict(engine.groups)
    assert 1 <= len(kept) <= batcher.GROUP_CACHE_CAP
    _quiet(run_coalesced_sweeps, engine, _mixed_specs())
    assert all(engine.groups[k] is g for k, g in kept.items())


# ------------------------------------------------ eviction / spill accounting
def test_evicted_column_recharged_exactly_once(engine):
    memo = engine.memo
    spec = SweepSpec(apps=APPS, plan=SamplingPlan(RFVClusters(), Centroid()),
                     config_indices=CFGS)
    t0 = _ledger_totals(memo)

    table = _quiet(run_sweep, engine, spec)
    t1 = _ledger_totals(memo)
    assert sum(a - b for a, b in zip(t1, t0)) > 0
    _quiet(run_sweep, engine, spec)
    assert _ledger_totals(memo) == t1

    ver = memo.version
    mask_t, cpi_t = memo.mask, memo.cpi
    cols = memo.cols_for([engine.configs[i] for i in CFGS])
    memo.evict(cols)
    assert memo.version > ver
    assert memo.mask is mask_t and memo.cpi is cpi_t     # in place
    assert not memo.mask[:, torch.as_tensor(cols), :].any()
    _quiet(run_sweep, engine, spec)
    cold = {r.app: r.n_units * len(CFGS) for r in table.rows}
    np.testing.assert_array_equal(
        np.subtract(_ledger_totals(memo), t1),
        [cold[n] for n in memo.names])
    t2 = _ledger_totals(memo)
    _quiet(run_sweep, engine, spec)
    assert _ledger_totals(memo) == t2


def test_spilled_column_restores_free(engine):
    memo = engine.memo
    spec = SweepSpec(apps=APPS, plan=SamplingPlan(RFVClusters(), Centroid()),
                     config_indices=CFGS)
    _quiet(run_sweep, engine, spec)
    t1 = _ledger_totals(memo)
    mask1, cpi1 = memo.mask.clone(), memo.cpi.clone()

    cols = memo.cols_for([engine.configs[i] for i in CFGS])
    ver = memo.version
    memo.spill(cols)
    assert memo.version > ver
    resident = memo.resident_columns()
    assert not set(int(c) for c in cols) & set(resident)

    ver = memo.version
    _quiet(run_sweep, engine, spec)
    assert memo.version > ver                    # the unspill bumped it
    assert _ledger_totals(memo) == t1
    assert torch.equal(memo.mask, mask1)
    assert torch.equal(memo.cpi, cpi1)


def _fill(bank, cfg, k):
    bank.fill([0], np.arange(k)[None], None, [cfg],
              values=np.ones((1, 1, k), np.float32))


def test_evict_to_cap_policies():
    memo = MemoBank(device="cpu")
    memo.add_app("a", 8, Ledger())
    for i, cfg in enumerate(CONFIGS[:4]):
        _fill(memo, cfg, 2 + 2 * i)
    memo.cols_for([CONFIGS[1]])
    victims = memo.evict_to_cap(2, policy="lru")
    assert sorted(int(v) for v in victims) == [0, 2]
    assert sorted(memo.resident_columns()) == [1, 3]

    memo2 = MemoBank(device="cpu")
    memo2.add_app("a", 8, Ledger())
    for i, cfg in enumerate(CONFIGS[:3]):
        _fill(memo2, cfg, 2 + 2 * i)
    victims = memo2.evict_to_cap(1, policy="charge")
    assert sorted(int(v) for v in victims) == [0, 1]
    assert memo2.resident_columns() == [2]

    with pytest.raises(ValueError, match="policy"):
        memo2.evict_to_cap(1, policy="fifo")


@pytest.mark.parametrize("policy", ["lru", "charge"])
def test_evict_to_cap_matches_reference(policy):
    """The same fills and touches in both packages' banks: the same
    victims, residents and ledgers."""
    from repro.simcpu.cache import MemoBank as RBank
    from repro.simcpu.simulator import Ledger as RLedger
    from repro.simcpu.uarch import CONFIGS as RCONFIGS

    banks = []
    for bank, ledger, cfgs in ((MemoBank(device="cpu"), Ledger, CONFIGS),
                               (RBank(), RLedger, RCONFIGS)):
        bank.add_app("a", 12, ledger())
        bank.add_app("b", 9, ledger())
        for i, cfg in enumerate(cfgs[:6]):
            bank.fill([0, 1], np.asarray([[i, 7 - i % 3], [i % 4, 8]]),
                      None, [cfg], values=np.full((2, 1, 2), 1.0 + i,
                                                  np.float32))
        bank.cols_for([cfgs[2], cfgs[0]])
        banks.append(bank)
    got = banks[0].evict_to_cap(3, policy=policy, spill=True)
    want = banks[1].evict_to_cap(3, policy=policy, spill=True)
    assert [int(v) for v in got] == [int(v) for v in want]
    assert banks[0].resident_columns() == banks[1].resident_columns()
    assert _ledger_totals(banks[0]) == _ledger_totals(banks[1])


def test_absorb_picks_dedups_requests():
    memo = MemoBank(device="cpu")
    memo.add_app("a", 8, Ledger())
    cols = memo.cols_for(CONFIGS[:2])
    picks = np.array([[1, 2, 2]])
    valid = np.ones((1, 3), bool)
    values = np.full((1, 2, 3), 1.5)
    n_miss = memo.absorb_picks([0], cols, picks, valid, values)
    assert int(n_miss.sum()) == 4
    assert memo.ledgers[0].regions_simulated == 4
    n_miss = memo.absorb_picks([0], cols, picks, valid, values)
    assert int(n_miss.sum()) == 0


def test_merge_rejects_mismatched_universes():
    a, b = MemoBank(device="cpu"), MemoBank(device="cpu")
    a.add_app("505.mcf_r", 8, None)
    b.add_app("505.mcf_r", 12, None)
    with pytest.raises(ValueError, match=r"mismatched app universes.*"
                                         r"505\.mcf_r"):
        a.merge(b)


def test_merge_adds_charges_and_fills():
    """Two banks filled on disjoint regions merge into one whose tables
    hold both and whose charges and ledgers add, as the reference's."""
    a, b = MemoBank(device="cpu"), MemoBank(device="cpu")
    for bank in (a, b):
        bank.add_app("x", 6, Ledger())
    _fill(a, CONFIGS[0], 2)
    b.fill([0], np.asarray([[3, 4, 5]]), None, [CONFIGS[1]],
           values=np.full((1, 1, 3), 2.0, np.float32))
    a.merge(b)
    assert a.total_charges() == 5
    assert a.ledgers[0].regions_simulated == 5
    assert int(a.mask.sum()) == 5
    assert float(a.cpi[0, 1, 4]) == 2.0


# ------------------------------------------------------ SweepService loop
def test_service_serves_and_coalesces(engine):
    before = _memo_state(engine.memo)
    service = SweepService(engine)
    ids = [service.submit(s) for s in _mixed_specs()]
    assert service.pending == len(ids)
    served = _quiet(service.drain)
    assert served == len(ids)

    _memo_reset(engine.memo, before)
    direct = _quiet(run_coalesced_sweeps, engine, _mixed_specs())
    for rid, table in zip(ids, direct):
        np.testing.assert_array_equal(service.result(rid).column("estimate"),
                                      table.column("estimate"))
    stats = service.stats()
    assert stats.completed == len(ids)
    assert stats.coalesced_requests == 5
    assert stats.dispatches == 2
    assert stats.latency_p95_s >= stats.latency_p50_s > 0


def test_service_trial_dedup_matches_serial(engine):
    spec = TrialSpec(trials=16, schemes=("random", "rfv"), config_index=0,
                     seed=3)
    before = _memo_state(engine.memo)
    _quiet(run_trials, engine, spec, apps=APPS)
    _quiet(run_trials, engine, spec, apps=APPS)
    state_serial = _tables(engine.memo)
    _memo_reset(engine.memo, before)

    service = SweepService(engine)
    r1 = service.submit(spec, apps=APPS)
    r2 = service.submit(spec, apps=APPS)
    _quiet(service.tick)
    assert service.result(r1) is service.result(r2)
    _assert_same_tables(state_serial, _tables(engine.memo))

    with pytest.raises(ValueError, match="apps"):
        service.submit(spec)


def test_service_memo_cap_bounds_residency(engine):
    memo = engine.memo
    memo.evict([c for c in memo.resident_columns()])
    cold = _memo_state(memo)

    plan = SamplingPlan(RFVClusters(), Centroid())
    service = SweepService(engine, memo_cap=2, spill=True)
    for cfg_is in ((0, 1, 2), (3, 4, 5), (0, 1, 2)):
        service.submit(SweepSpec(apps=APPS, plan=plan,
                                 config_indices=cfg_is))
        _quiet(service.tick)
        assert len(memo.resident_columns()) <= 2

    stats = service.stats()
    assert stats.evicted_cols > 0
    assert stats.peak_resident_cols <= 3
    capped_totals = _ledger_totals(memo)

    _memo_reset(memo, cold)
    uncapped = SweepService(engine)
    for cfg_is in ((0, 1, 2), (3, 4, 5), (0, 1, 2)):
        uncapped.submit(SweepSpec(apps=APPS, plan=plan,
                                  config_indices=cfg_is))
    _quiet(uncapped.drain)
    assert _ledger_totals(memo) == capped_totals


def test_service_stream_matches_reference(engines):
    """The synthetic stream over both apps (32 requests, seed 1) is the
    reference's; its RFV requests, in ticks of 8 with memo cap 4 and
    spill, served by both packages from the same memo state give the same
    dispatch counts, charges, counters and ledgers, and estimates to rtol
    1e-5. (The stream's Dalenius-Gurney ``Centroid`` requests run the
    reference's fused float32 path, which picks other units than its
    staged path, ``ROADMAP.md``; the port's are held against serial runs
    above and on the card.)"""
    from repro.serving.cli import synthetic_stream as r_stream

    port, ref = engines
    before_p, before_r = _memo_state(port.memo), ref.memo.state()
    try:
        stream_p = synthetic_stream(32, seed=1, apps=APPS)
        stream_r = r_stream(32, seed=1, apps=APPS)
        assert [(s.scheme, s.policy, s.config_indices, s.selection_seed)
                for s in stream_p] == \
            [(s.scheme, s.policy, s.config_indices, s.selection_seed)
             for s in stream_r]
        stream_p = [s for s in stream_p if s.scheme == "rfv"]
        stream_r = [s for s in stream_r if s.scheme == "rfv"]
        services = (SweepService(port, memo_cap=4, spill=True),
                    RS.SweepService(ref, memo_cap=4, spill=True))
        for svc, stream in zip(services, (stream_p, stream_r)):
            for start in range(0, len(stream), 8):
                for spec in stream[start:start + 8]:
                    svc.submit(spec)
                _quiet(svc.tick)
        sp, sr = (svc.stats() for svc in services)
        assert (sp.completed, sp.ticks, sp.dispatches,
                sp.coalesced_requests, sp.evicted_cols,
                sp.peak_resident_cols) == \
            (sr.completed, sr.ticks, sr.dispatches, sr.coalesced_requests,
             sr.evicted_cols, sr.peak_resident_cols)
        assert sp.cache_hit_rate == sr.cache_hit_rate
        for i in range(len(stream_p)):
            g, w = services[0].result(i), services[1].result(i)
            assert list(g.column("n_units")) == list(w.column("n_units"))
            np.testing.assert_allclose(g.column("estimate"),
                                       w.column("estimate"), rtol=RTOL)
        tp, tr = _tables(port.memo), ref.memo.state()[0]
        for k in ("mask", "charges", "hit_count", "miss_count",
                  "ledger_regions", "ledger_instr"):
            np.testing.assert_array_equal(tp[k], np.asarray(tr[k]),
                                          err_msg=k)
    finally:
        _memo_reset(port.memo, before_p)
        ref.memo.load_state(*before_r, universe=ref.configs)


def test_cli_quick_runs_on_the_cpu(capsys):
    """``python -m repro_torch.serving.cli --device cpu --quick``."""
    _quiet(cli_main, ["--device", "cpu", "--quick", "--memo-cap", "2",
                      "--spill"])
    out = capsys.readouterr().out
    assert "served 12 requests in 2 ticks" in out
    assert "evicted" in out


def test_service_mesh_needs_the_app_axis(engine):
    """The service over a 2-shard app mesh (the CPU named twice) serves
    the same tables and memo as without one, bit for bit."""
    from repro_torch.launch.mesh import make_app_mesh
    mesh = make_app_mesh(devices=["cpu", "cpu"])
    before = _memo_state(engine.memo)
    plain = SweepService(engine)
    ids = [plain.submit(s) for s in _mixed_specs()]
    _quiet(plain.drain)
    state_plain = _tables(engine.memo)
    _memo_reset(engine.memo, before)
    sharded = SweepService(engine, mesh=mesh)
    assert sharded.mesh == mesh
    ids_m = [sharded.submit(s) for s in _mixed_specs()]
    _quiet(sharded.drain)
    for a, b in zip(ids, ids_m):
        assert plain.result(a).column("estimate").tobytes() == \
            sharded.result(b).column("estimate").tobytes()
    _assert_same_tables(state_plain, _tables(engine.memo))
    assert run_coalesced_sweeps(engine, [], mesh=mesh) == []
