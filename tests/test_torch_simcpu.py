"""The port's simulation substrate against the reference's, on the CPU.

Populations and BBVs are numpy in both packages and must be bitwise
equal. The perf model runs in float32 in both but through different
compilers (XLA's fused, reassociated kernels against PyTorch's eager
ops), so CPI and RFVs are held to rtol 1e-5. The memo bank's accounting
— misses, hits, charges, ledgers — must be exactly equal, and a bank
restored from the reference's ``state()`` serves the same fills with no
new charges.
"""

import numpy as np
import pytest
import torch

from repro import simcpu as R
from repro_torch import simcpu as T

APPS = ("505.mcf_r", "500.perlbench_r")


def test_populations_and_bbvs_bitwise():
    rb, tb = R.get_population_bank(APPS), T.get_population_bank(APPS)
    for field in ("features", "mask", "n_regions"):
        np.testing.assert_array_equal(getattr(rb, field), getattr(tb, field))
    for rp, tp in zip(rb.pops, tb.pops):
        np.testing.assert_array_equal(rp.phase_ids, tp.phase_ids)
        np.testing.assert_array_equal(R.get_bbvs(rp), T.get_bbvs(tp))
    assert T.APP_NAMES == R.APP_NAMES
    assert [repr(c) for c in T.CONFIGS] == [repr(c) for c in R.CONFIGS]


def test_cpi_bank_matches_reference():
    feats = R.get_population_bank(APPS).features[:, :5000]
    want = R.cpi_bank(feats, R.CONFIGS)
    got = T.cpi_bank(torch.from_numpy(feats), T.CONFIGS).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_rfv_bank_matches_reference():
    feats = R.get_population_bank(APPS).features[:, :3000]
    cpi_r, rfv_r = R.rfv_bank(feats, R.CONFIGS[0])
    cpi_t, rfv_t = T.rfv_bank(torch.from_numpy(feats), T.CONFIGS[0])
    np.testing.assert_allclose(cpi_t.numpy(), cpi_r, rtol=1e-5, atol=0)
    np.testing.assert_allclose(rfv_t.numpy(), rfv_r, rtol=1e-5, atol=1e-12)


def test_evaluate_and_cpi_batch_match_reference():
    feats = R.get_population(APPS[0]).features
    idx = np.arange(0, 4000, 7)
    want = R.evaluate_regions_batch(feats, R.CONFIGS[2:5], idx)
    got = T.evaluate_regions_batch(torch.as_tensor(feats), T.CONFIGS[2:5],
                                   torch.as_tensor(idx))
    assert set(got) == set(want)
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v, rtol=1e-5,
                                   atol=1e-12, err_msg=name)
    np.testing.assert_allclose(
        T.cpi_batch(torch.as_tensor(feats), T.CONFIGS, torch.as_tensor(idx))
        .numpy(), R.cpi_batch(feats, R.CONFIGS, idx), rtol=1e-5)


def _banks():
    """Reference and port banks over the same two apps, same ledgers."""
    rb, tb = R.MemoBank(), T.MemoBank(device="cpu")
    r_ledgers, t_ledgers = [], []
    for name in APPS:
        pop = R.get_population(name)
        r_ledgers.append(R.Ledger())
        t_ledgers.append(T.Ledger())
        rb.add_app(name, pop.n_regions, r_ledgers[-1])
        tb.add_app(name, pop.n_regions, t_ledgers[-1])
    return rb, tb, r_ledgers, t_ledgers


def _fill_both(rb, tb, idx, valid, cfgs_i, seed):
    bank = R.get_population_bank(APPS)
    feats = bank.features[np.arange(2)[:, None], idx]
    rc, rm = rb.fill(np.arange(2), idx, valid,
                     tuple(R.CONFIGS[i] for i in cfgs_i), feats=feats)
    tc, tm = tb.fill(np.arange(2), torch.as_tensor(idx),
                     torch.as_tensor(valid),
                     tuple(T.CONFIGS[i] for i in cfgs_i),
                     feats=torch.as_tensor(feats))
    np.testing.assert_array_equal(tm, rm)
    np.testing.assert_allclose(tc.numpy(), rc, rtol=1e-5)


def test_memobank_accounting_exact():
    rb, tb, rl, tl = _banks()
    rng = np.random.default_rng(0)
    for step, cfgs_i in enumerate([(0,), (0, 1, 2), (2, 5), (0, 1, 2)]):
        idx = rng.integers(0, 40000, (2, 300))        # duplicates included
        valid = rng.random((2, 300)) > 0.1
        _fill_both(rb, tb, idx, valid, cfgs_i, step)
    np.testing.assert_array_equal(tb.charges, rb.charges)
    assert tb.hit_count == rb.hit_count
    assert tb.miss_count == rb.miss_count
    assert [l.regions_simulated for l in tl] == \
        [l.regions_simulated for l in rl]
    assert tb.total_charges() == rb.total_charges()
    np.testing.assert_array_equal(tb.mask.numpy(), rb.mask)


def test_memobank_restores_reference_state_without_new_charges():
    rb, tb, rl, tl = _banks()
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 40000, (2, 500))
    valid = np.ones((2, 500), bool)
    bank = R.get_population_bank(APPS)
    feats = bank.features[np.arange(2)[:, None], idx]
    rb.fill(np.arange(2), idx, valid, R.CONFIGS[:3], feats=feats)
    tree, meta = rb.state()
    tb.load_state(tree, meta, universe=T.CONFIGS)
    # the port's own snapshot of the restored bank is the reference's
    tree2, meta2 = tb.state()
    assert meta2 == meta
    for key in tree:
        np.testing.assert_array_equal(tree2[key], tree[key], err_msg=key)
    before = [l.regions_simulated for l in tl]
    assert before == [l.regions_simulated for l in rl]
    cpi, n_miss = tb.fill(np.arange(2), torch.as_tensor(idx),
                          torch.as_tensor(valid), T.CONFIGS[:3],
                          feats=torch.as_tensor(feats))
    assert not n_miss.any()
    assert [l.regions_simulated for l in tl] == before
    want = np.take_along_axis(tree["cpi"][:, :3],
                              np.broadcast_to(idx[:, None, :], (2, 3, 500)),
                              axis=2)
    np.testing.assert_array_equal(cpi.numpy(), want)


def test_memobank_restore_rejects_other_apps():
    rb, _, _, _ = _banks()
    other = T.MemoBank(device="cpu")
    other.add_app(APPS[1], 60000)
    with pytest.raises(ValueError):
        other.load_state(*rb.state())


def test_cached_simulator_charges_once():
    ref = R.make_cached_simulator(APPS[0])
    cached = T.CachedSimulator(T.make_simulator(APPS[0]))
    a = cached.simulate_cpi([1, 2, 3, 3], T.CONFIGS[0])
    b = cached.simulate_cpi_batch([3, 4], T.CONFIGS[:2])
    ref.simulate_cpi([1, 2, 3, 3], R.CONFIGS[0])
    want = ref.simulate_cpi_batch([3, 4], R.CONFIGS[:2])
    assert cached.ledger.regions_simulated == ref.ledger.regions_simulated \
        == 6
    assert (cached.misses, cached.hits) == (ref.misses, ref.hits) == (6, 2)
    np.testing.assert_allclose(b.numpy(), want, rtol=1e-5)
    assert a[2] == a[3] == b[0, 0]
