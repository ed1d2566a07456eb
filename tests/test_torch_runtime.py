"""The port's checkpoint, elastic and health runtime against the reference.

Counterpart of ``tests/test_runtime.py``, case by case, on the CPU: the
same checkpoints, memo snapshots, mesh plans, health traces and step-time
estimators, through ``repro_torch.runtime``. Restores take a device
(``device=``); a plan over several devices builds a mesh (the pool may
name one device more than once) and ``reshard`` places each leaf on its
device. On top of that:

* checkpoints cross both ways: a reference checkpoint (``TrialStats``
  included) restores in the port leaf for leaf, and a port checkpoint
  restores in the reference, through its own ``restore_checkpoint`` and
  ``restore_memobank``;
* ``FaultPlan.random`` gives the reference's events, and every ``plan_*``
  the reference's plans, over several seeds and pool sizes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.sampling import tables as sampling_tables
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import elastic, faults, health


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.as_tensor(rng.normal(size=(8, 4)), dtype=torch.float32),
        "nested": {"b": torch.as_tensor(rng.integers(0, 9, (3,)),
                                        dtype=torch.int32)},
    }


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save_checkpoint(tmp_path, 7, tree, extra={"step": 7})
    restored, extra = ckpt.restore_checkpoint(tmp_path, tree)
    assert extra["step"] == 7
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])


def test_checkpoint_retention_and_latest(tmp_path):
    tree = _tree()
    for step in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(tmp_path, step, tree, keep=3)
    assert ckpt.latest_step(tmp_path) == 5
    kept = sorted(int(p.name.split("_")[1])
                  for p in tmp_path.glob("step_*"))
    assert kept == [3, 4, 5]


def test_checkpoint_shape_mismatch_detected(tmp_path):
    ckpt.save_checkpoint(tmp_path, 0, _tree())
    bad = {"a": torch.zeros((2, 2)),
           "nested": {"b": torch.zeros(3, dtype=torch.int32)}}
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(tmp_path, bad)


def test_checkpoint_device_restore(tmp_path):
    """``device=`` places restored leaves there in the template's dtype
    (the one-device counterpart of the reference's ``shardings=``), and a
    numpy template comes back as numpy without it."""
    tree = _tree()
    ckpt.save_checkpoint(tmp_path, 0, tree)
    restored, _ = ckpt.restore_checkpoint(tmp_path, tree, device="cpu")
    assert restored["a"].device.type == "cpu"
    assert restored["a"].dtype == tree["a"].dtype
    assert torch.equal(restored["a"], tree["a"])
    host = {"a": tree["a"].numpy(), "nested": {"b": tree["nested"]["b"]}}
    restored, _ = ckpt.restore_checkpoint(tmp_path, host)
    assert isinstance(restored["a"], np.ndarray)
    np.testing.assert_array_equal(restored["a"], host["a"])


# ---------------------------------------------------------------- MemoBank
def _toy_bank(register):
    """A two-app bank with ledgers (the port's), filled through the memo;
    ``register`` pre-registers the config columns in an order, so a
    restore target can hold a permuted (or empty) column layout."""
    from repro_torch.simcpu.cache import MemoBank
    from repro_torch.simcpu.simulator import Ledger
    from repro_torch.simcpu.uarch import UarchConfig

    c0, c1 = UarchConfig(name="cfg-a"), UarchConfig(name="cfg-b")
    bank = MemoBank(device="cpu")
    bank.add_app("alpha", 6, Ledger())
    bank.add_app("beta", 5, Ledger())
    bank.cols_for([(c0, c1), (c1, c0), ()][register])
    return bank, (c0, c1)


def _fill_toy(bank, cfgs, *, seed=0):
    rng = np.random.default_rng(seed)
    idx = np.asarray([[0, 2, 4], [1, 3, 3]])
    vals = rng.uniform(0.5, 3.0, size=(2, 2, 3)).astype(np.float32)
    return bank.fill([0, 1], idx, None, cfgs, values=vals)


def test_memobank_checkpoint_roundtrip_permuted_columns(tmp_path):
    """A bank snapshot restores into a fresh bank whose columns were
    registered in another order: dtypes, shapes and version survive, the
    accounting is replaced exactly, and the original fills are hits with
    the same CPI."""
    src, cfgs = _toy_bank(0)
    cpi_src, _ = _fill_toy(src, cfgs)
    ckpt.save_memobank(tmp_path, 0, src, extra={"tag": "t"})

    for register in (1, 2):                    # permuted / unregistered
        dst, _ = _toy_bank(register)
        extra = ckpt.restore_memobank(tmp_path, dst, universe=cfgs)
        assert extra["tag"] == "t"
        assert dst.mask.dtype == torch.bool
        assert dst.cpi.dtype == torch.float32
        assert dst.version == src.version
        assert dst.hit_count == src.hit_count
        assert dst.miss_count == src.miss_count
        assert [lg.regions_simulated for lg in dst.ledgers] == \
               [lg.regions_simulated for lg in src.ledgers]
        cpi_dst, n_miss = _fill_toy(dst, cfgs)
        assert not n_miss.any()
        assert torch.equal(cpi_dst, cpi_src)
        assert dst.charges.sum() == src.charges.sum()


def test_memobank_restore_refuses_identity_drift(tmp_path):
    from repro_torch.simcpu.cache import MemoBank
    from repro_torch.simcpu.simulator import Ledger

    src, cfgs = _toy_bank(0)
    _fill_toy(src, cfgs)
    ckpt.save_memobank(tmp_path, 0, src)
    other = MemoBank(device="cpu")
    other.add_app("gamma", 6, Ledger())
    other.add_app("beta", 5, Ledger())
    with pytest.raises(ValueError, match="apps"):
        ckpt.restore_memobank(tmp_path, other, universe=cfgs)
    fresh, _ = _toy_bank(2)
    with pytest.raises(ValueError, match="not resolvable"):
        ckpt.restore_memobank(tmp_path, fresh, universe=())


def test_memobank_version_never_rolls_back(tmp_path):
    src, cfgs = _toy_bank(0)
    _fill_toy(src, cfgs)
    ckpt.save_memobank(tmp_path, 0, src)
    dst, _ = _toy_bank(0)
    for _ in range(src.version + 3):
        dst.touch()
    before = dst.version
    ckpt.restore_memobank(tmp_path, dst, universe=cfgs)
    assert dst.version > before >= src.version


def _trial_stats(xp_update, init, rng):
    return xp_update(init((2,)), rng.uniform(0.1, 20.0, (2, 32)),
                     rng.uniform(0.01, 1.0, (2, 32)),
                     rng.random((2, 32)) < 0.9, np.ones((2, 32), bool))


def test_trial_stats_checkpoint_roundtrip(tmp_path):
    """``TrialStats`` checkpoint leaf for leaf: dtypes, shapes and bits
    survive the round trip."""
    rng = np.random.default_rng(3)
    st = sampling_tables.trial_stats_update(
        sampling_tables.trial_stats_init((2,)),
        torch.as_tensor(rng.uniform(0.1, 20.0, (2, 32)), dtype=torch.float32),
        torch.as_tensor(rng.uniform(0.01, 1.0, (2, 32)), dtype=torch.float32),
        torch.as_tensor(rng.random((2, 32)) < 0.9),
        torch.ones((2, 32), dtype=torch.bool), block=32)
    ckpt.save_checkpoint(tmp_path, 0, {"stats": st})
    restored, _ = ckpt.restore_checkpoint(
        tmp_path, {"stats": sampling_tables.trial_stats_init((2,))})
    for g, w in zip(restored["stats"].leaves(), st.leaves()):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.numpy().tobytes() == w.numpy().tobytes()


def test_elastic_mesh_plans():
    p = elastic.plan_mesh(256, model_parallel=16)
    assert p.shape == (16, 16)
    p = elastic.plan_mesh(240, model_parallel=16)
    assert p.shape == (15, 16)
    p = elastic.plan_mesh(8, model_parallel=16)
    assert p.shape[0] * p.shape[1] <= 8
    with pytest.raises(ValueError):
        elastic.plan_mesh(0)


def test_elastic_app_mesh_plans():
    assert elastic.plan_app_mesh(5).shape == (5,)
    assert elastic.plan_app_mesh(5).axes == ("app",)
    p = elastic.plan_app_trial_mesh(8, app_devices=2)
    assert p.shape == (2, 4) and p.axes == ("app", "trial")
    assert elastic.plan_app_trial_mesh(3, app_devices=8).shape == (3, 1)
    with pytest.raises(ValueError):
        elastic.plan_app_trial_mesh(0)


def test_quantum_health_trace():
    h = health.QuantumHealth()
    h.detector.min_samples = 4
    for q in range(8):
        assert not h.record(q, 0.1)
    assert h.record(8, 5.0)
    assert h.summary()["quanta"] == 9
    assert h.summary()["stragglers"] == 1
    assert h.stragglers[0][0] == 8


def test_elastic_reshard_on_host():
    """One device: no mesh, and ``reshard`` moves the state there. A plan
    over more devices builds their mesh; a placement that does not match
    the state's structure raises."""
    plan = elastic.plan_mesh(1, model_parallel=1)
    assert elastic.build_mesh(plan, ["cpu"]) is None
    tree = _tree()
    out = elastic.reshard({"a": tree["a"].numpy(), "nested": tree["nested"]},
                          "cpu")
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["nested"]["b"], tree["nested"]["b"])
    from repro_torch.launch.mesh import make_app_mesh
    assert elastic.build_mesh(elastic.plan_app_mesh(2), ["cpu", "cpu"]) \
        == make_app_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError):
        elastic.reshard(tree, ["cpu", "cpu"])
    with pytest.raises(ValueError):
        elastic.build_mesh(elastic.plan_app_mesh(2), ["cpu"])


def test_straggler_detector():
    det = health.StragglerDetector(k=3.0, min_samples=10)
    times = np.full(100, 0.1) + np.random.default_rng(0).normal(0, 0.002, 100)
    assert not det.is_straggler(times, 0.105)
    assert det.is_straggler(times, 0.5)


def test_step_timer_window():
    t = health.StepTimer(window=5)
    for i in range(10):
        t.record(float(i))
    assert t.times.size == 5
    assert t.times[-1] == 9.0


def test_stratified_steptime_cis():
    from repro.runtime import health as rhealth

    rng = np.random.default_rng(1)
    labels = rng.integers(0, 2, 200)
    times = np.where(labels == 0, 0.1, 0.3) + rng.normal(0, 0.01, 200)
    est = health.stratified_steptime_estimate(times, labels, num_strata=2)
    assert abs(est.mean - times.mean()) < 0.02
    want = rhealth.stratified_steptime_estimate(times, labels, num_strata=2)
    np.testing.assert_allclose([est.mean, est.margin],
                               [want.mean, want.margin], rtol=1e-5)
    est1 = health.one_per_stratum_steptime_ci([0.1, 0.12, 0.3, 0.29],
                                              [0.25, 0.25, 0.25, 0.25])
    assert np.isfinite(est1.margin)
    want1 = rhealth.one_per_stratum_steptime_ci([0.1, 0.12, 0.3, 0.29],
                                                [0.25, 0.25, 0.25, 0.25])
    np.testing.assert_allclose([est1.mean, est1.margin],
                               [want1.mean, want1.margin], rtol=1e-5)
    srs = health.srs_steptime_estimate(times)
    want_srs = rhealth.srs_steptime_estimate(times)
    np.testing.assert_allclose([srs.mean, srs.margin],
                               [want_srs.mean, want_srs.margin], rtol=1e-5)


# ------------------------------------------------------ against the reference
@pytest.mark.parametrize("seed", [0, 1, 7, 42, 2024])
@pytest.mark.parametrize("n_quanta,kills,lost", [(4, 3, 0), (20, 3, 2),
                                                 (70, 5, 3), (2, 4, 1)])
def test_fault_plan_random_matches_reference(seed, n_quanta, kills, lost):
    from repro.runtime import faults as rfaults

    got = faults.FaultPlan.random(seed, n_quanta, kills=kills,
                                  max_devices_lost=lost)
    want = rfaults.FaultPlan.random(seed, n_quanta, kills=kills,
                                    max_devices_lost=lost)
    assert [(e.kind, e.quantum, e.devices_lost) for e in got.events] == \
        [(e.kind, e.quantum, e.devices_lost) for e in want.events]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 15, 16, 17, 64, 240, 256])
def test_mesh_plans_match_reference(n):
    from repro.runtime import elastic as relastic

    for mp in (1, 2, 16):
        assert elastic.plan_mesh(n, model_parallel=mp) == \
            elastic.MeshPlan(**vars(relastic.plan_mesh(n, model_parallel=mp)))
    assert vars(elastic.plan_app_mesh(n)) == vars(relastic.plan_app_mesh(n))
    for ad in (1, 2, 4, 8):
        assert vars(elastic.plan_app_trial_mesh(n, app_devices=ad)) == \
            vars(relastic.plan_app_trial_mesh(n, app_devices=ad))
    for kind in ("data_model", "app", "app_trial"):
        mine = elastic.ElasticRunner(mesh_kind=kind, app_devices=2)
        theirs = relastic.ElasticRunner(mesh_kind=kind, app_devices=2)
        assert vars(mine.on_pool_change(n)) == vars(theirs.on_pool_change(n))
        assert mine.history == theirs.history


def test_reference_checkpoint_restores_in_port(tmp_path):
    """A checkpoint the reference writes (nested dicts, a ``TrialStats``)
    restores in the port leaf for leaf, bits and dtypes, through the
    reference's key strings."""
    import jax.numpy as jnp
    from repro.core.sampling import tables as rtables
    from repro.runtime import checkpoint as rckpt

    rng = np.random.default_rng(5)
    st = rtables.trial_stats_update(
        rtables.trial_stats_init((2,)), rng.uniform(0.1, 20.0, (2, 32)),
        rng.uniform(0.01, 1.0, (2, 32)), rng.random((2, 32)) < 0.9,
        np.ones((2, 32), bool))
    tree = {"x": jnp.asarray(rng.normal(size=(3, 5)), jnp.float32),
            "stats": {"rfv": st},
            "n": np.arange(4, dtype=np.int64)}
    rckpt.save_checkpoint(tmp_path, 3, tree, extra={"run": {"k": [1, 2]}})
    template = {"x": torch.zeros((3, 5)),
                "stats": {"rfv": sampling_tables.trial_stats_init((2,))},
                "n": np.zeros(4, np.int64)}
    got, extra = ckpt.restore_checkpoint(tmp_path, template,
                                         expect={"run": {"k": (1, 2)}})
    assert extra["run"] == {"k": [1, 2]}
    assert got["x"].numpy().tobytes() == np.asarray(tree["x"]).tobytes()
    np.testing.assert_array_equal(got["n"], tree["n"])
    for g, w in zip(got["stats"]["rfv"].leaves(),
                    (st.count, st.cover, st.err_sum, st.err_sumsq, st.half_n,
                     st.half_sum, st.half_sumsq, st.err_hist, st.half_hist)):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        assert g.numpy().tobytes() == w.tobytes()
    with pytest.raises(ckpt.ManifestMismatch):
        ckpt.restore_checkpoint(tmp_path, template,
                                expect={"run": {"k": [2, 1]}})


def test_port_checkpoint_restores_in_reference(tmp_path):
    """The reverse: a port checkpoint (and a port memo snapshot) restores
    through the reference's ``restore_checkpoint`` / ``restore_memobank``;
    the restored reference bank serves the port's fills as hits."""
    from repro.core.sampling import tables as rtables
    from repro.runtime import checkpoint as rckpt
    from repro.simcpu.cache import MemoBank as RBank
    from repro.simcpu.simulator import Ledger as RLedger
    from repro.simcpu.uarch import UarchConfig as RConfig

    rng = np.random.default_rng(6)
    st = sampling_tables.trial_stats_update(
        sampling_tables.trial_stats_init((2,)),
        torch.as_tensor(rng.uniform(0.1, 20.0, (2, 32)), dtype=torch.float32),
        torch.as_tensor(rng.uniform(0.01, 1.0, (2, 32)), dtype=torch.float32),
        torch.as_tensor(rng.random((2, 32)) < 0.9),
        torch.ones((2, 32), dtype=torch.bool), block=32)
    ckpt.save_checkpoint(tmp_path / "t", 0, {"stats": {"bbv": st}})
    got, _ = rckpt.restore_checkpoint(
        tmp_path / "t", {"stats": {"bbv": rtables.trial_stats_init((2,))}})
    for g, w in zip((got["stats"]["bbv"].count, got["stats"]["bbv"].err_sum,
                     got["stats"]["bbv"].half_hist),
                    (st.count, st.err_sum, st.half_hist)):
        assert np.asarray(g).tobytes() == w.numpy().tobytes()

    src, cfgs = _toy_bank(0)
    cpi_src, _ = _fill_toy(src, cfgs)
    ckpt.save_memobank(tmp_path / "m", 0, src, extra={"tag": "port"})
    rcfgs = (RConfig(name="cfg-a"), RConfig(name="cfg-b"))
    dst = RBank()
    dst.add_app("alpha", 6, RLedger())
    dst.add_app("beta", 5, RLedger())
    extra = rckpt.restore_memobank(tmp_path / "m", dst, universe=rcfgs)
    assert extra["tag"] == "port"
    assert dst.hit_count == src.hit_count
    assert dst.miss_count == src.miss_count
    np.testing.assert_array_equal(dst.charges, src.charges)
    np.testing.assert_array_equal(dst.mask, src.mask.numpy())
    idx = np.asarray([[0, 2, 4], [1, 3, 3]])
    cpi, n_miss = dst.fill([0, 1], idx, None, rcfgs,
                           values=np.zeros((2, 2, 3), np.float32))
    assert not n_miss.any()
    np.testing.assert_array_equal(cpi, cpi_src.numpy())
