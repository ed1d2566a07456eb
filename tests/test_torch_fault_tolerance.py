"""The port's checkpointed fleet drivers: resumed == uninterrupted, bitwise.

Counterpart of ``tests/test_fault_tolerance.py``, case by case, on the
CPU over ``("505.mcf_r", "520.omnetpp_r")`` and configs 0 and 6; a pool
of more than one device runs over its mesh (the elastic re-mesh after a
lost device is held in ``tests/test_torch_mesh.py``).

* **Port against itself, bitwise**: a sweep (srs, rfv fused, rfv staged,
  dg centroid) or Monte-Carlo study killed at randomized quanta, in all
  three ways (before its checkpoint, mid-write with the tmp dir
  truncated, after publish), and resumed by the supervisor equals the
  uninterrupted run of the same blocking in estimates, errors, the memo
  tables, charges, counters and ledgers, and every ``TrialStats`` leaf
  and per-trial array; the deterministic policies equal plain
  ``run_sweep`` too.
* **Port against the reference's float32 paths** (its default policy
  needs the x64 mode jax 0.9.0 no longer has; its fused Dalenius-Gurney
  ``Centroid`` is held against its staged path, ``ROADMAP.md``):
  integers exactly (ledgers, charges, counters, mask, ``n_units``,
  ``TrialStats`` integer leaves), floats to rtol 1e-5.
* **Checkpoints cross both ways**: a reference sweep killed after quantum
  1 resumes in the port from the reference's directory to the
  reference's uninterrupted ledger; a port memo snapshot restores in the
  reference; a different run's directory raises ``ManifestMismatch`` in
  both.

Each attempt's engine is a copy of one port engine taken right after its
build (``copy.deepcopy``): the build is deterministic, so the copy is the
rebuilt engine a restart makes, at none of its cost on the CPU. One
restart test rebuilds for real.
"""

from __future__ import annotations

import copy
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import repro.experiments as R
from repro.core.precision import PrecisionPolicy as RPolicy
from repro.core.sampling import plan as rplan
from repro.runtime import checkpoint as rckpt
from repro.runtime import faults as rfaults
import repro_torch.experiments as T
from repro_torch.core.sampling.plan import SamplingPlan
from repro_torch.experiments.montecarlo import TRIAL_BLOCK
from repro_torch.runtime.checkpoint import (ManifestMismatch, latest_step,
                                            restore_checkpoint,
                                            save_checkpoint, save_memobank)
from repro_torch.runtime.faults import (FAULT_KINDS, FaultEvent, FaultPlan,
                                        HostLoss)

APPS = ("505.mcf_r", "520.omnetpp_r")
CONFIGS = (0, 6)
# estimates from two compilers' float32 CPI; a percent error near zero
# carries the estimate's rtol as an absolute term
RTOL = 1e-5
ERR_ATOL = 100 * RTOL * 2


@pytest.fixture(scope="module")
def built():
    """(port engine right after its build, reference float32 engine, the
    reference memo's post-build state); every config column registered
    in both, so their memo states line up column for column."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            port = T.ExperimentEngine(device="cpu")
            port.build(APPS)
            port.memo.cols_for(port.configs)
            ref = R.ExperimentEngine(precision=RPolicy())
            ref.build(APPS)
            ref.memo.cols_for(ref.configs)
            yield port, ref, ref.memo.state()
    finally:
        torch.set_num_threads(threads)


def _fresh(template):
    """A rebuilt engine: the template's post-build state, independent."""
    return copy.deepcopy(template)


def _reset(ref, state):
    """The reference engine's memo back to its post-build state."""
    tree, meta = state
    ref.memo.load_state(copy.deepcopy(tree), meta, universe=ref.configs)


def _capture_engines(template):
    engines = []

    def make(mesh):
        assert mesh is None
        eng = _fresh(template)
        engines.append(eng)
        return eng

    return engines, make


def _port_spec(scheme, policy, fused):
    if scheme == "srs":
        return T.SweepSpec(apps=APPS, config_indices=CONFIGS, fused=fused)
    return T.SweepSpec(apps=APPS,
                       plan=SamplingPlan.from_strings(scheme, policy),
                       config_indices=CONFIGS, fused=fused)


def _ref_spec(scheme, policy, fused):
    if scheme == "srs":
        return R.SweepSpec(apps=APPS, config_indices=CONFIGS, fused=fused)
    return R.SweepSpec(apps=APPS,
                       plan=rplan.SamplingPlan.from_strings(scheme, policy),
                       config_indices=CONFIGS, fused=fused)


def _quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kw)


def _assert_rows_bitwise(got, want):
    assert len(got.rows) == len(want.rows)
    for r, b in zip(got.rows, want.rows):
        assert (r.app, r.scheme, r.config_index) == \
               (b.app, b.scheme, b.config_index)
        assert np.float64(r.estimate).tobytes() == \
               np.float64(b.estimate).tobytes()
        assert np.float64(r.err_pct).tobytes() == \
               np.float64(b.err_pct).tobytes()
        assert r.n_units == b.n_units
        if b.margin_pct is not None:
            assert np.float64(r.margin_pct).tobytes() == \
                   np.float64(b.margin_pct).tobytes()


def _assert_rows_close(got, want):
    """Port rows against the reference's: labels and ``n_units`` exact,
    floats to rtol 1e-5 (percent errors also within ``ERR_ATOL``)."""
    assert len(got.rows) == len(want.rows)
    for r, b in zip(got.rows, want.rows):
        assert (r.app, r.scheme, r.config_index, r.n_units) == \
               (b.app, b.scheme, b.config_index, b.n_units)
        np.testing.assert_allclose(r.estimate, b.estimate, rtol=RTOL)
        np.testing.assert_allclose(r.truth, b.truth, rtol=RTOL)
        assert abs(r.err_pct - b.err_pct) <= ERR_ATOL + RTOL * b.err_pct
        if b.margin_pct is not None:
            np.testing.assert_allclose(r.margin_pct, b.margin_pct,
                                       rtol=RTOL)


def _assert_memo_equal(bank_a, bank_b, *, keys=None):
    tree_a, meta_a = bank_a.state()
    tree_b, meta_b = bank_b.state()
    assert meta_a == meta_b
    # ``version`` counts table writes, which restarts legally repeat
    for k in (keys if keys is not None else
              [k for k in tree_a if k != "version"]):
        np.testing.assert_array_equal(tree_a[k], tree_b[k], err_msg=k)


def _assert_memo_matches_reference(port_bank, ref_bank):
    """Integers exactly (mask, charges, counters, ledgers); CPI to rtol
    1e-5 where held."""
    tree_p, meta_p = port_bank.state()
    tree_r, meta_r = ref_bank.state()
    assert meta_p == meta_r
    for k in ("mask", "charges", "hit_count", "miss_count",
              "ledger_regions", "ledger_instr"):
        np.testing.assert_array_equal(tree_p[k], np.asarray(tree_r[k]),
                                      err_msg=k)
    held = tree_r["mask"]
    np.testing.assert_allclose(tree_p["cpi"][held], tree_r["cpi"][held],
                               rtol=RTOL)


# ------------------------------------------------------- fault plan units
def test_fault_plan_random_is_deterministic():
    a = FaultPlan.random(5, 16, kills=4, max_devices_lost=3)
    b = FaultPlan.random(5, 16, kills=4, max_devices_lost=3)
    assert a == b
    assert len(a.events) == 4
    assert [e.quantum for e in a.events] == \
           sorted({e.quantum for e in a.events})
    assert all(e.kind in FAULT_KINDS for e in a.events)
    assert all(0 <= e.devices_lost <= 3 for e in a.events)
    assert FaultPlan.random(6, 16, kills=4) != a


def test_fault_event_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent("meteor", 0)
    with pytest.raises(ValueError, match=">= 0"):
        FaultEvent("kill", -1)


def test_injector_fires_events_in_order():
    plan = FaultPlan((FaultEvent("kill", 1, devices_lost=2),
                      FaultEvent("kill_dirty", 0)))
    inj = plan.injector()
    assert [e.quantum for e in inj.pending] == [0, 1]
    with pytest.raises(HostLoss):
        inj.quantum_computed()
    inj.on_resume(0)
    inj.quantum_computed()
    inj.quantum_checkpointed()
    inj.quantum_computed()
    with pytest.raises(HostLoss) as err:
        inj.quantum_checkpointed()
    assert err.value.devices_lost == 2 and err.value.quantum == 1
    assert not inj.pending
    assert [e.kind for e in inj.fired] == ["kill_dirty", "kill"]


def test_plan_tail_beyond_run_never_fires():
    inj = FaultPlan((FaultEvent("kill", 9),)).injector()
    for _ in range(4):
        inj.quantum_computed()
        inj.quantum_checkpointed()
    assert len(inj.pending) == 1 and not inj.fired


# -------------------------------------------------- checkpoint atomicity
def test_corrupt_mid_write_keeps_previous_checkpoint_restorable(tmp_path):
    tree0 = {"x": np.arange(8, dtype=np.int64)}
    save_checkpoint(tmp_path, 0, tree0, extra={"next_quantum": 1})
    inj = FaultPlan((FaultEvent("corrupt", 1),)).injector()
    inj.on_resume(1)
    with pytest.raises(HostLoss, match="mid-checkpoint-write"):
        save_checkpoint(tmp_path, 1, {"x": np.arange(8, dtype=np.int64) * 2},
                        extra={"next_quantum": 2}, fault_hook=inj.hook)
    assert (tmp_path / "step_1.tmp").exists()
    assert latest_step(tmp_path) == 0
    restored, extra = restore_checkpoint(tmp_path, tree0)
    assert extra["next_quantum"] == 1
    np.testing.assert_array_equal(restored["x"], tree0["x"])


def test_manifest_mismatch_raises_before_reading_arrays(tmp_path):
    tree = {"x": np.arange(4, dtype=np.float32)}
    save_checkpoint(tmp_path, 0, tree, extra={"run": {"kind": "sweep"}})
    (tmp_path / "step_0" / "arrays.npz").write_bytes(b"not-a-zipfile")
    with pytest.raises(ManifestMismatch, match="extra"):
        restore_checkpoint(tmp_path, tree, expect={"run": {"kind": "trial"}})
    with pytest.raises(ManifestMismatch, match="shape"):
        restore_checkpoint(tmp_path, {"x": np.zeros((9, 9), np.float32)})
    with pytest.raises(ManifestMismatch, match="missing"):
        restore_checkpoint(tmp_path, {"y": np.arange(4, dtype=np.float32)})


# ------------------------------------------------- sweeps: resume == run
SWEEP_MATRIX = [
    pytest.param("srs", None, True, 5, id="srs"),
    pytest.param("rfv", "centroid", True, 6, id="rfv-fused"),
    pytest.param("rfv", "centroid", False, 9, id="rfv-staged"),
    pytest.param("dg", "centroid", True, 8, id="dg-centroid"),
]


@pytest.mark.parametrize("scheme,policy,fused,seed", SWEEP_MATRIX)
def test_sweep_killed_and_resumed_is_bitwise_identical(
        built, tmp_path, scheme, policy, fused, seed):
    """Three randomized faults (kinds drawn from the three failure modes,
    all three across the matrix, each firing once) over the 2 x 2
    quantum grid: the supervised run equals the uninterrupted
    one bitwise (estimates, errors, memo tables, charges, counters,
    ledgers) and plain ``run_sweep`` too; against the reference's float32
    run of the same blocking, integers exactly and floats to rtol 1e-5."""
    template, ref, ref_state = built
    spec = _port_spec(scheme, policy, fused)
    n_quanta = len(APPS) * len(CONFIGS)
    plan = FaultPlan.random(seed, n_quanta, kills=3)
    assert len(plan.events) == 3

    eng_u = _fresh(template)
    uninterrupted = _quiet(T.run_sweep_resumable, eng_u, spec, tmp_path / "u",
                           app_block=1, config_block=1)

    engines, make = _capture_engines(template)
    res, rep = _quiet(T.supervise_sweep, make, spec, tmp_path / "f",
                      faults=plan, app_block=1, config_block=1)
    assert rep.restarts == 3
    assert [a["error"].split()[1] for a in rep.attempts[:-1]] == \
        [e.kind for e in plan.events]
    assert len(rep.quanta) >= n_quanta
    assert [a["outcome"] for a in rep.attempts] == \
        ["host_loss"] * 3 + ["completed"]

    _assert_rows_bitwise(res, uninterrupted)
    _assert_memo_equal(engines[-1].memo, eng_u.memo)

    eng_p = _fresh(template)
    _assert_rows_bitwise(res, _quiet(T.run_sweep, eng_p, spec))
    _assert_memo_equal(engines[-1].memo, eng_p.memo,
                       keys=["mask", "charges", "ledger_regions",
                             "ledger_instr"])

    # the reference's float32 run; its fused DG-Centroid is held against
    # its staged path (ROADMAP.md, reference caveats)
    _reset(ref, ref_state)
    ref_fused = fused and scheme != "dg"
    want = _quiet(R.run_sweep_resumable, ref,
                  _ref_spec(scheme, policy, ref_fused), tmp_path / "r",
                  app_block=1, config_block=1)
    _assert_rows_close(res, want)
    _assert_memo_matches_reference(engines[-1].memo, ref.memo)


def test_sweep_checkpoint_identity_guards_resume(built, tmp_path):
    template, _, _ = built
    spec = _port_spec("rfv", "centroid", True)
    _quiet(T.run_sweep_resumable, _fresh(template), spec, tmp_path,
           app_block=1, config_block=1)
    other = _port_spec("rfv", "mean", True)
    with pytest.raises(ManifestMismatch):
        T.run_sweep_resumable(_fresh(template), other, tmp_path,
                              app_block=1, config_block=1)


def test_supervisor_rebuilds_engines_for_real(built, tmp_path):
    """One supervised run whose attempts build their engines from
    scratch (no copies): equal to the copies' run bitwise."""
    template, _, _ = built
    spec = _port_spec("rfv", "centroid", True)
    plan = FaultPlan((FaultEvent("kill", 1),))

    def make(mesh):
        eng = T.ExperimentEngine(device="cpu")
        eng.build(APPS)
        eng.memo.cols_for(eng.configs)
        return eng

    res, rep = _quiet(T.supervise_sweep, make, spec, tmp_path / "f",
                      faults=plan, app_block=1, config_block=1)
    assert rep.restarts == 1
    want = _quiet(T.run_sweep_resumable, _fresh(template), spec,
                  tmp_path / "u", app_block=1, config_block=1)
    _assert_rows_bitwise(res, want)


def test_more_than_one_device_needs_the_app_axis(built, tmp_path):
    """A pool of two devices (the CPU named twice): each attempt's engine
    gets the pool's 2-shard app mesh, and the supervised run equals the
    unsharded uninterrupted one bit for bit; so does the resumable driver
    given the mesh directly."""
    from repro_torch.launch.mesh import make_app_mesh
    template, _, _ = built
    spec = _port_spec("rfv", "centroid", True)
    mesh = make_app_mesh(devices=["cpu", "cpu"])
    meshes = []

    def make(m):
        meshes.append(m)
        eng = _fresh(template)
        eng.mesh = m
        return eng

    want = _quiet(T.run_sweep_resumable, _fresh(template), spec,
                  tmp_path / "u", app_block=1, config_block=1)
    got, rep = _quiet(T.supervise_sweep, make, spec, tmp_path / "f",
                      app_block=1, config_block=1, devices=["cpu", "cpu"])
    assert meshes == [mesh] and rep.attempts[0]["mesh_shape"] == (2,)
    _assert_rows_bitwise(got, want)
    direct = _quiet(T.run_sweep_resumable, _fresh(template), spec,
                    tmp_path / "d", app_block=1, config_block=1, mesh=mesh)
    _assert_rows_bitwise(direct, want)


# ------------------------------------------------- trials: resume == run
def _trials_spec(module):
    # one block a chunk, 2 chunks; segment_trials=256 makes 2 segments x
    # 4 schemes = 8 quanta
    return module.TrialSpec(trials=512, chunk_size=TRIAL_BLOCK,
                            keep_trials=True)


def _assert_trials_equal(got, want, *, exact_floats):
    for s in want.spec.schemes:
        for i, (g, w) in enumerate(zip(got.stats[s].leaves(),
                                       want.stats[s].leaves())):
            assert g.dtype == w.dtype and g.shape == w.shape, (s, i)
            if not g.dtype.is_floating_point or exact_floats:
                assert torch.equal(g, w), (s, i)
            else:
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL)
        for field in ("estimates", "errors", "half_widths"):
            a = getattr(got, field)[s]
            b = getattr(want, field)[s]
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes(), (s, field)


def test_trials_killed_and_resumed_is_bitwise_identical(built, tmp_path):
    """Four randomized faults over 8 segment quanta: every ``TrialStats``
    leaf and per-trial array equals the uninterrupted run bitwise; plain
    ``run_trials`` (another blocking) keeps the per-trial arrays and the
    integer leaves bitwise; the reference's float32 resumable run agrees
    as ``_assert_stats_match_reference`` holds it, and its memo's
    integers exactly."""
    template, ref, ref_state = built
    spec = _trials_spec(T)
    plan = FaultPlan.random(12, 8, kills=4)
    assert len(plan.events) == 4

    uninterrupted = _quiet(T.run_trials_resumable, _fresh(template), spec,
                           tmp_path / "u", apps=APPS, segment_trials=256)
    engines, make = _capture_engines(template)
    res, rep = _quiet(T.supervise_trials, make, spec, tmp_path / "f",
                      apps=APPS, faults=plan, segment_trials=256)
    assert rep.restarts == 4
    assert [a["error"].split()[1] for a in rep.attempts[:-1]] == \
        [e.kind for e in plan.events]
    _assert_trials_equal(res, uninterrupted, exact_floats=True)

    plain = _quiet(T.run_trials, _fresh(template),
                   dataclasses.replace(spec, chunk_size=None), apps=APPS)
    _assert_trials_equal(res, plain, exact_floats=False)

    _reset(ref, ref_state)
    want = _quiet(R.run_trials_resumable, ref, _trials_spec(R),
                  tmp_path / "r", apps=APPS, segment_trials=256)
    truth = np.stack([e.truth[spec.config_index] for e in ref.build(APPS)])
    for s in spec.schemes:
        _assert_stats_match_reference(res, want, s, truth)
        np.testing.assert_allclose(res.estimates[s], want.estimates[s],
                                   rtol=RTOL)
    _assert_memo_matches_reference(engines[-1].memo, ref.memo)


def _edge_ties(values: np.ndarray, atol: np.ndarray) -> np.ndarray:
    """Per lane, the values within ``atol`` (elementwise) of a sketch bin
    edge: their bin may move either way within the comparison's
    tolerance."""
    from repro_torch.core.sampling import tables as ttables

    v = values.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        pos = (np.log(v) - ttables._HIST_LOG_LO) \
            * (ttables.TRIAL_HIST_BINS / ttables._HIST_LOG_SPAN)
        step = (atol / v) * ttables.TRIAL_HIST_BINS / ttables._HIST_LOG_SPAN
    near = np.isfinite(pos) & (np.abs(pos - np.round(pos)) <= step)
    return near.sum(axis=-1)


def _assert_stats_match_reference(res, want, scheme, truth):
    """``TrialStats`` against the reference's: trial counts exactly;
    coverage counts exactly but at near-ties (|estimate - truth| within
    rtol 1e-5 of the half-width), as ``tests/test_torch_trials.py``
    holds them; each sketch's counts exactly but for values within their
    tolerance of a bin edge (rtol 1e-5; a percent error also 100 * 1e-5 *
    estimate / truth), which may sit in the next bin; float moments to
    rtol 1e-5, the error moments also within the per-trial error
    tolerances summed."""
    got, ref = res.stats[scheme], want.stats[scheme]
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    np.testing.assert_array_equal(got.half_n.numpy(), np.asarray(ref.half_n))
    gap = np.abs(want.estimates[scheme] - truth[:, None].astype(np.float32))
    half = want.half_widths[scheme]
    ties = (np.abs(gap - half) <= RTOL * np.abs(half)).sum(axis=1)
    assert (np.abs(got.cover.numpy() - np.asarray(ref.cover))
            <= ties).all()
    err, half_w = want.errors[scheme], want.half_widths[scheme]
    err_atol = RTOL * err + 100 * RTOL * np.abs(want.estimates[scheme]) \
        / truth[:, None]
    for name, values, atol in (("err_hist", err, err_atol),
                               ("half_hist", half_w, RTOL * half_w)):
        g = getattr(got, name).numpy().astype(np.int64)
        w = np.asarray(getattr(ref, name)).astype(np.int64)
        np.testing.assert_array_equal(g.sum(axis=-1), w.sum(axis=-1))
        moved = np.abs(np.cumsum(g - w, axis=-1)).max(axis=-1)
        assert (moved <= _edge_ties(values, atol)).all(), (name, moved)
    # the moments carry the per-trial tolerances summed
    pct_atol = 100 * RTOL * np.abs(want.estimates[scheme]) / truth[:, None]
    for name, atol in (("err_sum", pct_atol.sum(axis=1)),
                       ("err_sumsq", (2 * err * pct_atol).sum(axis=1)),
                       ("half_sum", 0.0), ("half_sumsq", 0.0)):
        g = getattr(got, name).numpy().astype(np.float64)
        w = np.asarray(getattr(ref, name)).astype(np.float64)
        assert (np.abs(g - w) <= atol + RTOL * np.abs(w)).all(), (name, g, w)


# ------------------------------------------- checkpoints across packages
def test_reference_checkpoint_resumes_in_port(built, tmp_path):
    """A reference sweep killed after quantum 1 resumes in the port from
    the reference's own directory: the final ledger, charges, counters
    and mask equal the reference's uninterrupted run's, the estimates to
    rtol 1e-5."""
    template, ref, ref_state = built
    _reset(ref, ref_state)
    rspec = _ref_spec("rfv", "centroid", True)
    inj = rfaults.FaultPlan((rfaults.FaultEvent("kill", 1),)).injector()
    with pytest.raises(rfaults.HostLoss):
        _quiet(R.run_sweep_resumable, ref, rspec, tmp_path / "k",
               app_block=1, config_block=1, injector=inj)
    assert latest_step(tmp_path / "k") == 1

    port = _fresh(template)
    got = _quiet(T.run_sweep_resumable, port,
                 _port_spec("rfv", "centroid", True), tmp_path / "k",
                 app_block=1, config_block=1)

    _reset(ref, ref_state)
    want = _quiet(R.run_sweep_resumable, ref, rspec, tmp_path / "u",
                  app_block=1, config_block=1)
    _assert_rows_close(got, want)
    _assert_memo_matches_reference(port.memo, ref.memo)
    assert [lg.regions_simulated for lg in port.memo.ledgers] == \
        [lg.regions_simulated for lg in ref.memo.ledgers]


def test_port_memo_snapshot_restores_in_reference(built, tmp_path):
    """A port engine's memo after a sweep, saved by the port, restores
    in the reference (``restore_memobank``) with the same tables and
    accounting; the reference then serves that sweep without a charge."""
    template, ref, ref_state = built
    port = _fresh(template)
    _quiet(T.run_sweep, port, _port_spec("dg", "centroid", True))
    save_memobank(tmp_path, 0, port.memo, extra={"from": "port"})
    _reset(ref, ref_state)
    extra = rckpt.restore_memobank(tmp_path, ref.memo, universe=ref.configs)
    assert extra["from"] == "port"
    _assert_memo_matches_reference(port.memo, ref.memo)
    before = ref.memo.total_charges()
    _quiet(R.run_sweep, ref, _ref_spec("dg", "centroid", False))
    assert ref.memo.total_charges() == before


def test_other_runs_directory_is_refused_by_both(built, tmp_path):
    """A directory of another run raises ``ManifestMismatch`` before
    loading, in whichever package reads it."""
    template, ref, ref_state = built
    _quiet(T.run_sweep_resumable, _fresh(template),
           _port_spec("rfv", "centroid", True), tmp_path / "p",
           app_block=1, config_block=1)
    _reset(ref, ref_state)
    with pytest.raises(rckpt.ManifestMismatch):
        _quiet(R.run_sweep_resumable, ref, _ref_spec("rfv", "mean", True),
               tmp_path / "p", app_block=1, config_block=1)
    _reset(ref, ref_state)
    _quiet(R.run_sweep_resumable, ref, _ref_spec("srs", None, True),
           tmp_path / "r", app_block=1, config_block=1)
    with pytest.raises(ManifestMismatch):
        _quiet(T.run_sweep_resumable, _fresh(template),
               _port_spec("srs", None, True), tmp_path / "r",
               app_block=2, config_block=1)
