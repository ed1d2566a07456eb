"""The port's whole slice against the reference, on the CPU.

Both engines build ``("505.mcf_r", "500.perlbench_r")`` — ragged in the
population size N and the phase-1 size n1 — and run the staged sweeps.
The reference runs with an explicit float32 policy,
``ExperimentEngine(precision=PrecisionPolicy())``: its default
``host_parity`` policy needs ``jax.experimental.enable_x64``, which jax
0.9.0 no longer has.

Held to: phase-1 indices, Dalenius-Gurney labels, k-means labels, picks,
pick validity and ledger totals exactly equal; census truth to rtol 1e-6
(float64 sums of float32 CPI that differ in the last bit); sweep
estimates to rtol 1e-5 (float32 CPI from two compilers). A port bank
restored from the reference's ``MemoBank.state()`` re-serves the sweeps
with no new charge. The import check keeps the port free of JAX and of
the reference package.
"""

import ast
import copy
import pathlib
import warnings

import numpy as np
import pytest
import torch

import repro.experiments as R
from repro.core.precision import PrecisionPolicy as RPolicy
from repro.core.sampling import plan as rplan
import repro_torch.experiments as T
from repro_torch.core.sampling import plan as tplan
from repro_torch.simcpu import Ledger, MemoBank, get_population

APPS = ("505.mcf_r", "500.perlbench_r")
SCHEMES = (None, "rfv", "bbv", "dg")
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _specs(scheme):
    if scheme is None:
        return R.SweepSpec(apps=APPS), T.SweepSpec(apps=APPS)
    return (R.SweepSpec(apps=APPS, fused=False,
                        plan=rplan.SamplingPlan.from_strings(scheme)),
            T.SweepSpec(apps=APPS, fused=False,
                        plan=tplan.SamplingPlan.from_strings(scheme)))


@pytest.fixture(scope="module")
def engines():
    # two intra-op threads: the tier-1 run shares the cores among workers
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = R.ExperimentEngine(precision=RPolicy())
            port = T.ExperimentEngine(device="cpu")
            tables = {s: tuple(run(e, spec) for run, e, spec in zip(
                (R.run_sweep, T.run_sweep), (ref, port), _specs(s)))
                for s in SCHEMES}
    finally:
        torch.set_num_threads(threads)
    return ref, port, tables


def test_build_state_matches(engines):
    ref, port, _ = engines
    for r, p in zip(ref.build(APPS), port.build(APPS)):
        np.testing.assert_array_equal(p.idx1.numpy(), r.idx1)
        np.testing.assert_array_equal(p.dg_labels.numpy(), r.dg_labels)
        np.testing.assert_array_equal(p.bbv_labels.numpy(), r.bbv_labels)
        np.testing.assert_array_equal(p.rfv_labels.numpy(), r.rfv_labels)
        np.testing.assert_allclose(p.truth.numpy(), r.truth, rtol=1e-6)
        for w in ("bbv_weights", "rfv_weights", "dg_weights"):
            np.testing.assert_array_equal(getattr(p, w).numpy(),
                                          getattr(r, w))
        np.testing.assert_array_equal(p.bbv_feats.numpy(), r.bbv_feats)


@pytest.mark.parametrize("scheme", ["rfv", "bbv", "dg"])
def test_picks_match(engines, scheme):
    ref, port, _ = engines
    pr, vr, wr = R.plan_selection_bank(
        ref.build(APPS), rplan.SamplingPlan.from_strings(scheme))
    pt, vt, wt = T.plan_selection_bank(
        port.build(APPS), tplan.SamplingPlan.from_strings(scheme))
    np.testing.assert_array_equal(pt.numpy(), pr)
    np.testing.assert_array_equal(vt.numpy(), vr)
    np.testing.assert_array_equal(wt.numpy(), wr)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_sweep_estimates_match(engines, scheme):
    _, _, tables = engines
    rt, tt = tables[scheme]
    assert len(tt) == len(rt) == len(APPS) * 7
    for field in ("app", "scheme", "config_index", "n_units"):
        assert list(tt.column(field)) == list(rt.column(field))
    np.testing.assert_allclose(tt.column("estimate"), rt.column("estimate"),
                               rtol=1e-5)
    np.testing.assert_allclose(tt.column("truth"), rt.column("truth"),
                               rtol=1e-6)
    if scheme is None:
        np.testing.assert_allclose(tt.column("margin_pct"),
                                   rt.column("margin_pct"), rtol=1e-4)


def test_ledgers_match(engines):
    ref, port, _ = engines
    assert [e.sim.ledger.regions_simulated for e in port.build(APPS)] == \
        [e.sim.ledger.regions_simulated for e in ref.build(APPS)]
    np.testing.assert_array_equal(port.memo.charges, ref.memo.charges)
    assert port.memo.hit_count == ref.memo.hit_count
    assert port.memo.miss_count == ref.memo.miss_count


def test_restored_bank_serves_sweeps_free(engines):
    """A new bank, restored from the reference's snapshot, behind the
    port's built state: the sweeps hit it without one new charge, and
    serve the reference's own CPI values (estimates then agree with the
    reference's to float32 rounding of its f32 estimate policy)."""
    ref, port, tables = engines
    restored = copy.copy(port)
    restored.memo = MemoBank(device="cpu")
    ledgers = [Ledger() for _ in APPS]
    for name, ledger in zip(APPS, ledgers):
        restored.memo.add_app(name, get_population(name).n_regions, ledger)
    restored.memo.load_state(*ref.memo.state(), universe=port.configs)
    before = [ledger.regions_simulated for ledger in ledgers]
    assert before == [e.sim.ledger.regions_simulated
                      for e in ref.build(APPS)]
    for scheme in SCHEMES:
        table = T.run_sweep(restored, _specs(scheme)[1])
        np.testing.assert_allclose(table.column("estimate"),
                                   tables[scheme][0].column("estimate"),
                                   rtol=1e-6)
    assert [ledger.regions_simulated for ledger in ledgers] == before
    np.testing.assert_array_equal(restored.memo.charges, ref.memo.charges)


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        assert T.ExperimentEngine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            T.ExperimentEngine()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)
