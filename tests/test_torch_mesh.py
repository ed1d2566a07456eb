"""The port's multi-device app axis on the CPU: sharded == unsharded.

Counterpart of ``tests/test_sharded_sweeps.py``'s sharded cases,
``tests/test_distributed.py``'s distributed k-means and the
``multidevice`` cases of ``tests/test_fault_tolerance.py`` and
``tests/test_streaming_trials.py``. A mesh here names the one CPU device
several times (``make_app_mesh(devices=["cpu"] * 4)``), the port's
counterpart of the reference's ``--xla_force_host_platform_device_count``:
the split, padding, merge and re-mesh logic runs for real.

* **Port against port, bit for bit**, over ``("505.mcf_r",
  "520.omnetpp_r")`` (two apps pad to 2, 2, 3, 4 lanes over 1 to 4
  shards) and over ten synthetic lanes (10, 10, 12, 12): the build state,
  the census, phase-1 and BBV-projection passes, the bank fits, staged
  and fused sweeps (rows, memo tables, charges, counters, ledgers), and
  the trials' leaves and per-trial arrays, over app meshes of 1 to 4
  shards and ``("app", "trial")`` meshes (1, 2) and (2, 2). The trials'
  float moments are folded from the trial shards' block partial sums in
  the unsharded block order, so they too are bitwise (the reference's own
  sharded test holds its trials to rtol 1e-6).
* **The elastic re-mesh**: a supervised sweep and supervised trials lose
  one of four shards mid-run, re-plan over three, resume from the
  checkpoint and equal the uninterrupted run bit for bit; the trials
  resume trial-sharded where three divides a chunk's blocks, and
  unsharded where it does not.
* **Port against the reference**: the one-device mesh against the
  reference's one-device mesh, to the tolerances of the unsharded slices;
  the distributed k-means against the reference's ``distributed_kmeans``
  (labels equal except counted near-ties, centroids and inertia rtol
  1e-5); then one Lloyd step over 4 shards against 1 (labels equal, the
  centroids within the bound of two float32 summation orders); one
  ``multidevice`` case against the reference's 8-device mesh (it runs
  under ``CI_FORCE_DEVICES=8``).
"""

from __future__ import annotations

import copy
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.experiments as R
from repro.core.precision import PrecisionPolicy as RPolicy
from repro.core.sampling import plan as rplan
import repro_torch.experiments as T
from repro_torch.core import ordered
from repro_torch.core.clustering import distributed_kmeans, kmeans_bank
from repro_torch.core.sampling.plan import SamplingPlan
from repro_torch.distributed import appaxis
from repro_torch.launch.mesh import (Mesh, axis_size, data_axes,
                                     make_app_mesh, make_app_trial_mesh)
from repro_torch.runtime import elastic
from repro_torch.runtime.faults import FaultEvent, FaultPlan
from repro_torch.serving import SweepService, run_coalesced_sweeps
from repro_torch.simcpu import cpi_bank, rfv_bank
from repro_torch.simcpu.uarch import CONFIGS

APPS = ("505.mcf_r", "520.omnetpp_r")
CPU = torch.device("cpu")
MESHES = {"app1": (1, None), "app2": (2, None), "app3": (3, None),
          "app4": (4, None), "app_trial_1x2": (1, 2),
          "app_trial_2x2": (2, 2)}
TIE_RTOL = 1e-5
# two whole distributed k-means runs, 4 shards against 1, part at points
# near a boundary: at most this share of labels may differ (26 to 42 of
# 40,000 over seeds 0-2 after 6 steps; one shard's statistics counted
# twice moves 901, see test_distributed_kmeans_whole_runs_by_seed)
DKM_LABEL_SHARE = 0.01

needs_devices = pytest.mark.skipif(
    len(jax.devices()) < 8,
    reason="needs XLA_FLAGS=--xla_force_host_platform_device_count=8")


def _mesh(name):
    app, trial = MESHES[name]
    if trial is None:
        return make_app_mesh(devices=[CPU] * app)
    return make_app_trial_mesh(app, devices=[CPU] * (app * trial))


def _quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kw)


@pytest.fixture(scope="module")
def built():
    """(the unsharded port engine, the same built over a 4-shard app
    mesh), both with every config column registered."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        engines = []
        for mesh in (None, _mesh("app4")):
            eng = T.ExperimentEngine(device="cpu", mesh=mesh)
            _quiet(eng.build, APPS)
            eng.memo.cols_for(eng.configs)
            engines.append(eng)
        yield tuple(engines)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def reference_shard_map(monkeypatch):
    """The reference's ``shard_map`` calls pass ``check_rep=False``, which
    jax 0.9.0's ``jax.shard_map`` no longer takes (it is ``check_vma``
    there): without this shim every reference mesh path raises a
    ``TypeError`` here (``ROADMAP.md``, reference caveats). The shim
    passes the same flag under its new name; nothing else changes."""
    from repro.core.clustering import distributed as rdistributed
    from repro.distributed import appaxis as rappaxis

    def shard_map(f=None, *, check_rep=True, **kw):
        if f is None:
            return lambda g: jax.shard_map(g, check_vma=check_rep, **kw)
        return jax.shard_map(f, check_vma=check_rep, **kw)

    monkeypatch.setattr(rappaxis, "shard_map", shard_map)
    monkeypatch.setattr(rdistributed, "_shard_map", shard_map)
    rappaxis.app_sharded_cached.cache_clear()


def _copy(engine, mesh):
    eng = copy.deepcopy(engine)
    eng.mesh = mesh
    return eng


def _memo_tables(engine):
    tree, _ = engine.memo.state()
    return {k: v for k, v in tree.items() if k != "version"}


def _assert_memo_equal(a, b):
    ta, tb = _memo_tables(a), _memo_tables(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


def _assert_rows_bitwise(got, want):
    assert [(r.app, r.config_index) for r in got.rows] == \
        [(r.app, r.config_index) for r in want.rows]
    for col in ("estimate", "err_pct", "truth", "n_units", "margin_pct"):
        g = np.asarray([np.nan if v is None else v
                        for v in got.column(col)], float)
        w = np.asarray([np.nan if v is None else v
                        for v in want.column(col)], float)
        assert g.tobytes() == w.tobytes(), col


def _assert_trials(got, want):
    for s in want.spec.schemes:
        for i, (g, w) in enumerate(zip(got.stats[s].leaves(),
                                       want.stats[s].leaves())):
            assert g.dtype == w.dtype and g.shape == w.shape, (s, i)
            assert g.numpy().tobytes() == w.numpy().tobytes(), (s, i)
        for field in ("estimates", "errors", "half_widths"):
            assert getattr(got, field)[s].tobytes() == \
                getattr(want, field)[s].tobytes(), (s, field)


# ----------------------------------------------------- mesh helpers
def test_mesh_helpers():
    m = make_app_mesh(devices=["cpu"] * 4)
    assert m.shape == {"app": 4} and m.axis_names == ("app",)
    assert m.size == 4 and all(d == CPU for d in m.devices)
    assert make_app_mesh(2, devices=["cpu"] * 4).shape == {"app": 2}
    assert make_app_mesh(9, devices=["cpu"] * 3).shape == {"app": 3}
    t = make_app_trial_mesh(2, devices=["cpu"] * 5)
    assert t.shape == {"app": 2, "trial": 2}
    assert make_app_trial_mesh(8, devices=["cpu"] * 3).shape == \
        {"app": 3, "trial": 1}
    assert m == make_app_mesh(devices=[CPU] * 4) and hash(m) == hash(
        make_app_mesh(devices=[CPU] * 4))
    assert m != make_app_mesh(devices=["cpu"] * 3)
    grid = np.empty((2, 2, 2), dtype=object)
    grid[...] = CPU
    multi = Mesh(grid, ("pod", "data", "model"))
    assert data_axes(multi) == ("pod", "data")
    assert axis_size(multi, ("pod", "data", "absent")) == 4
    with pytest.raises(ValueError):
        make_app_mesh(devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_app_mesh()
        with pytest.raises(RuntimeError):
            make_app_mesh(devices=["cuda:0"])


def test_mesh_shapes_match_reference():
    """The port's meshes over n entries have the reference's shapes over
    n devices (the reference's are built on a list of stand-ins)."""
    from repro.launch import mesh as rmesh

    class FakeMesh:
        def __init__(self, grid, axes):
            self.shape = dict(zip(axes, np.asarray(grid).shape))

    orig = rmesh.Mesh
    rmesh.Mesh = FakeMesh
    try:
        for n in range(1, 9):
            for app in (1, 2, 3):
                want = rmesh.make_app_trial_mesh(app, devices=list(range(n)))
                got = make_app_trial_mesh(app, devices=["cpu"] * n)
                assert got.shape == want.shape
            assert make_app_mesh(devices=["cpu"] * n).shape == \
                rmesh.make_app_mesh(devices=list(range(n))).shape
    finally:
        rmesh.Mesh = orig


def test_pad_app_axis_matches_reference():
    from repro.distributed.appaxis import pad_app_axis as rpad
    a = np.arange(10 * 3).reshape(10, 3)
    for m in (1, 2, 3, 4, 8):
        want = rpad(a, m)
        np.testing.assert_array_equal(appaxis.pad_app_axis(a, m), want)
        np.testing.assert_array_equal(
            appaxis.pad_app_axis(torch.as_tensor(a), m).numpy(), want)
    assert appaxis.pad_app_axis(a, 5) is a


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
def test_make_app_sharded_over_ten_lanes(n_dev):
    """Ten lanes pad to 10, 10, 12, 12 over 1-4 shards; every shard gets
    a contiguous block, the replicated argument whole, and the output is
    the unsharded one, in app order."""
    seen = []

    def fn(x, scale):
        seen.append((x.shape[0], tuple(scale.shape)))
        return {"y": x * scale, "s": (x.sum(dim=1),)}

    x = torch.arange(10 * 4, dtype=torch.float32).reshape(10, 4)
    scale = torch.tensor([1.0, 2.0, 3.0, 4.0])
    mesh = make_app_mesh(devices=["cpu"] * n_dev)
    got = appaxis.make_app_sharded(fn, mesh, replicated=(1,))(x, scale)
    assert [s[0] for s in seen] == [-(-10 // n_dev)] * n_dev
    assert all(s[1] == (4,) for s in seen)
    assert torch.equal(got["y"], x * scale)
    assert torch.equal(got["s"][0], x.sum(dim=1))
    assert appaxis.app_sharded_cached(fn, mesh, (1,)) is \
        appaxis.app_sharded_cached(fn, mesh, (1,))


def test_make_app_trial_sharded_merges_in_trial_order():
    """Each device of an ``("app", "trial")`` mesh runs its app row's
    lanes with its own ``Shard``; a row's outputs merge in trial order."""
    calls = []

    def fn(x, shard):
        calls.append((shard.app, shard.trial, x.shape[0]))
        return x * 10 + shard.trial

    mesh = make_app_trial_mesh(2, devices=["cpu"] * 6)
    merged = []

    def merge(outs):
        merged.append(len(outs))
        return sum(outs[1:], outs[0])

    x = torch.arange(5, dtype=torch.float32)[:, None]
    got = appaxis.make_app_trial_sharded(fn, mesh, merge=merge)(x)
    assert calls == [(0, 0, 3), (0, 1, 3), (0, 2, 3),
                     (1, 0, 3), (1, 1, 3), (1, 2, 3)]
    assert merged == [3, 3]
    assert torch.equal(got, x * 30 + 3)


def test_elastic_build_mesh_and_reshard_beyond_one_device():
    plan = elastic.plan_app_mesh(3)
    mesh = elastic.build_mesh(plan, ["cpu"] * 4)
    assert mesh == make_app_mesh(devices=["cpu"] * 3)
    trial = elastic.build_mesh(elastic.plan_app_trial_mesh(4, app_devices=2),
                               ["cpu"] * 4)
    assert trial == make_app_trial_mesh(2, devices=["cpu"] * 4)
    assert elastic.build_mesh(elastic.plan_app_mesh(1), ["cpu"] * 4) is None
    with pytest.raises(ValueError):
        elastic.build_mesh(elastic.plan_app_mesh(5), ["cpu"] * 4)
    tree = {"a": np.arange(3.0), "b": [torch.ones(2), torch.zeros(1)]}
    out = elastic.reshard(tree, {"a": "cpu", "b": ["cpu", CPU]})
    assert isinstance(out["a"], torch.Tensor)
    assert torch.equal(out["b"][0], torch.ones(2))
    with pytest.raises(ValueError):
        elastic.reshard(tree, {"a": "cpu", "b": ["cpu"] * 3})


# ------------------------------------------------------ build state
def test_sharded_build_equals_unsharded(built):
    """The build over a 4-shard mesh (two apps on lanes 0-1, two padding
    lanes) equals the unsharded build bit for bit."""
    base, sharded = built
    for a, b in zip(base.build(APPS), sharded.build(APPS)):
        for f in ("truth", "census_mat", "bbv_labels", "bbv_weights",
                  "bbv_feats", "bbv_centroids", "idx1", "cpi0_1", "rfv_z",
                  "rfv_labels", "rfv_weights", "rfv_centroids", "dg_labels",
                  "dg_weights"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (a.name, f)
    _assert_memo_equal(base, sharded)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
def test_sharded_build_passes_over_ten_lanes(built, n_dev):
    """The build's sharded passes over ten lanes (the two apps five times
    over: 10, 10, 12, 12 padded lanes, local B = 10, 5, 4, 3): the
    census, the phase-1 measurement and the RFV bank fit equal their
    unsharded runs bit for bit."""
    base, _ = built
    exps = base.build(APPS)
    stack = base.stack(APPS)
    mesh = make_app_mesh(devices=["cpu"] * n_dev)
    feats = stack.feats[:, :2000].repeat(5, 1, 1)
    cfgs = CONFIGS[:3]
    assert torch.equal(cpi_bank(feats, cfgs, mesh=mesh),
                       cpi_bank(feats, cfgs))
    for got, want in zip(rfv_bank(feats, CONFIGS[0], mesh=mesh),
                         rfv_bank(feats, CONFIGS[0])):
        assert torch.equal(got, want)
    zr = torch.stack([e.rfv_z[:960].float() for e in exps] * 5)
    w = torch.ones(zr.shape[:2])
    w[1::2, 900:] = 0.0
    got = kmeans_bank(zr, 6, weights=w, seed=3, mesh=mesh, max_iters=8)
    want = kmeans_bank(zr, 6, weights=w, seed=3, max_iters=8)
    for f in ("centroids", "labels", "inertia", "iterations"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_local_shapes_have_dot_order_rows():
    """Every local k-means shape that the sharded build, the distributed
    k-means and ``chip_smoke.py``'s mesh phase launch has a row of the
    dot-order table (``tests/test_torch_paper_figs.py`` holds each row
    against the reference's einsum), and each row's order is its
    unsharded shape's: no lane of these fits changes order when sharded,
    so their labels do not move."""
    # ten apps (BBV (B, 120000, 20, 15), RFV (B, 6861, 20, 38)) over 1-4
    # shards and the (2, 2) trial mesh's app axis: B = 10, 5, 4, 3; the
    # two test apps: B = 2 and 1; the distributed fits: 1 or 4 shards of
    # 120000 / 40000 points and the seeding's 8192-point restarts
    unsharded = {(10, 120000, 20, 15), (10, 6861, 20, 38),
                 (2, 40000, 20, 15), (2, 967, 20, 38),
                 (1, 120000, 20, 15), (1, 40000, 20, 15)}
    local = {(b, 120000, 20, 15) for b in (1, 2, 3, 4, 5)} \
        | {(b, 6861, 20, 38) for b in (1, 2, 3, 4, 5)} \
        | {(1, 40000, 20, 15), (1, 967, 20, 38), (1, 30000, 20, 15),
           (1, 10000, 20, 15), (2, 8192, 20, 15)}
    for shape in sorted(local | unsharded):
        assert shape in ordered.DOT_ORDERS, shape
    orders = {ordered.DOT_ORDERS[s] for s in local | unsharded}
    assert orders == {"four"}
    for n, d in ((120000, 15), (6861, 38), (40000, 15), (967, 38)):
        assert ordered.norm_vector_rows(n, d) == 0


# ----------------------------------------------------------- sweeps
def _sweep_specs():
    specs = [T.SweepSpec(apps=APPS, config_indices=(0, 6))]
    for scheme, policy in (("rfv", "centroid"), ("bbv", "random"),
                           ("dg", "mean")):
        for fused in (True, False):
            specs.append(T.SweepSpec(
                apps=APPS, plan=SamplingPlan.from_strings(scheme, policy),
                fused=fused, selection_seed=2, config_indices=(0, 3, 6)))
    return specs


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_sweeps_equal_unsharded(built, mesh_name):
    """SRS, staged and fused sweeps over the mesh equal the unsharded
    sweeps bit for bit: rows, memo tables, charges, counters, ledgers;
    the fused sharded sweep equals the staged sharded one too."""
    base, _ = built
    mesh = _mesh(mesh_name)
    plain, sharded = _copy(base, None), _copy(base, mesh)
    for spec in _sweep_specs():
        want = _quiet(T.run_sweep, plain, spec)
        got = _quiet(T.run_sweep, sharded, spec)
        _assert_rows_bitwise(got, want)
        _assert_memo_equal(sharded, plain)
    staged = _copy(base, mesh)
    fused = _copy(base, mesh)
    for spec in _sweep_specs()[1::2]:
        _assert_rows_bitwise(
            _quiet(T.run_sweep, fused, spec),
            _quiet(T.run_sweep, staged, dataclasses.replace(spec,
                                                            fused=False)))
    _assert_memo_equal(fused, staged)


# ----------------------------------------------------------- trials
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_trials_equal_unsharded(built, mesh_name):
    """Trials over the mesh: every leaf and per-trial array bit for bit,
    the float moments included where the trial axis splits the blocks.
    ``kb`` (four blocks) divides by the trial axis."""
    base, _ = built
    mesh = _mesh(mesh_name)
    spec = T.TrialSpec(trials=2000, chunk_size=1024, keep_trials=True)
    plain, sharded = _copy(base, None), _copy(base, mesh)
    want = _quiet(T.run_trials, plain, spec, apps=APPS)
    got = _quiet(T.run_trials, sharded, spec, apps=APPS)
    _assert_trials(got, want)
    _assert_memo_equal(sharded, plain)


def test_trial_chunk_rounds_up_to_the_trial_axis(built):
    """``kb`` is rounded up to a multiple of the trial axis (the
    reference's ``_chunk_blocks``): 3 blocks a chunk over 2 trial shards
    become 4, with the same results."""
    from repro_torch.experiments.montecarlo import _chunk_blocks
    spec = T.TrialSpec(trials=1500, chunk_size=768, keep_trials=True)
    assert _chunk_blocks(spec, 1) == (3, 2)
    assert _chunk_blocks(spec, 2) == (4, 2)
    base, _ = built
    want = _quiet(T.run_trials, _copy(base, None), spec, apps=APPS)
    got = _quiet(T.run_trials, _copy(base, None), spec, apps=APPS,
                 mesh=_mesh("app_trial_1x2"))
    _assert_trials(got, want)


# ------------------------------------------------- elastic re-mesh
def test_supervised_sweep_re_meshes_after_losing_a_device(built, tmp_path):
    """A pool of four shards loses one at quantum 1: the supervisor
    re-plans over three, rebuilds (a copy of the built engine on the new
    mesh), resumes from the checkpoint, and equals the uninterrupted run
    bit for bit."""
    base, _ = built
    spec = T.SweepSpec(apps=APPS, config_indices=(0, 6),
                       plan=SamplingPlan.from_strings("rfv", "centroid"))
    want_eng = _copy(base, None)
    want = _quiet(T.run_sweep_resumable, want_eng, spec, tmp_path / "u",
                  app_block=1, config_block=1)
    meshes, engines = [], []

    def make(mesh):
        meshes.append(mesh)
        engines.append(_copy(base, mesh))
        return engines[-1]

    plan = FaultPlan((FaultEvent("kill", 1, devices_lost=1),))
    got, rep = _quiet(T.supervise_sweep, make, spec, tmp_path / "f",
                      faults=plan, app_block=1, config_block=1,
                      devices=["cpu"] * 4)
    assert meshes == [_mesh("app4"), _mesh("app3")]
    assert [a["mesh_shape"] for a in rep.attempts] == [(4,), (3,)]
    assert [a["outcome"] for a in rep.attempts] == ["host_loss",
                                                    "completed"]
    _assert_rows_bitwise(got, want)
    _assert_memo_equal(engines[-1], want_eng)


def test_supervised_trials_re_mesh_after_losing_a_device(built, tmp_path):
    """Trials on a (1, 4) ``("app", "trial")`` mesh lose a device and
    resume on (1, 3), where the trial axis no longer divides the four
    blocks of a chunk and the attempt runs unsharded: every leaf and
    per-trial array equals the uninterrupted run bit for bit."""
    base, _ = built
    spec = T.TrialSpec(trials=2048, chunk_size=1024, keep_trials=True,
                       schemes=("random", "rfv"))
    want = _quiet(T.run_trials_resumable, _copy(base, None), spec,
                  tmp_path / "u", apps=APPS, segment_trials=1024)
    meshes = []

    def make(mesh):
        meshes.append(mesh)
        return _copy(base, mesh)

    plan = FaultPlan((FaultEvent("kill_dirty", 2, devices_lost=1),))
    got, rep = _quiet(T.supervise_trials, make, spec, tmp_path / "f",
                      apps=APPS, faults=plan, segment_trials=1024,
                      devices=["cpu"] * 4)
    assert [m.shape for m in meshes] == [{"app": 1, "trial": 4},
                                         {"app": 1, "trial": 3}]
    assert rep.restarts == 1
    _assert_trials(got, want)


def test_supervised_trials_resume_trial_sharded(built, tmp_path,
                                                monkeypatch):
    """Trials on a (1, 4) ``("app", "trial")`` mesh lose a device at
    quantum 2 and resume on (1, 3): twelve blocks a chunk divide by both,
    so the resumed attempt's program runs over three trial shards from
    the checkpoint. Every leaf and per-trial array equals the
    uninterrupted unsharded run bit for bit."""
    from repro_torch.experiments import resumable
    base, _ = built
    spec = T.TrialSpec(trials=6144, chunk_size=3072, keep_trials=True,
                       schemes=("random", "rfv"))
    want = _quiet(T.run_trials_resumable, _copy(base, None), spec,
                  tmp_path / "u", apps=APPS, segment_trials=3072)
    programs, quanta = [], []
    real_program, real_run = resumable._streaming_program, \
        resumable._run_program

    def program(*args, **kw):
        programs.append(kw["n_trial"])
        return real_program(*args, **kw)

    def run_program(prog, x, **kw):
        quanta.append((prog.n_trial, kw["chunk0"]))
        return real_run(prog, x, **kw)

    monkeypatch.setattr(resumable, "_streaming_program", program)
    monkeypatch.setattr(resumable, "_run_program", run_program)
    plan = FaultPlan((FaultEvent("kill_dirty", 2, devices_lost=1),))
    got, rep = _quiet(T.supervise_trials, lambda m: _copy(base, m), spec,
                      tmp_path / "f", apps=APPS, faults=plan,
                      segment_trials=3072, devices=["cpu"] * 4)
    assert [a["mesh_shape"] for a in rep.attempts] == [(1, 4), (1, 3)]
    assert rep.restarts == 1
    # quanta 0 and 1 on four trial shards; the kill is dirty, so quantum
    # 2 ran once on four and again, from the checkpoint, on three
    assert [q[0] for q in quanta] == [4, 4, 4, 3, 3], quanta
    assert set(programs) == {4, 3}
    _assert_trials(got, want)


# ---------------------------------------------------------- serving
def test_coalesced_requests_under_a_mesh(built):
    """A tick's coalesced groups over a 3-shard mesh (one graph-free
    shard program each on the CPU) equal the same requests run one by one
    unsharded, bit for bit, in rows and the memo; so does the service."""
    base, _ = built
    plan_r = SamplingPlan.from_strings("rfv", "random")
    plan_c = SamplingPlan.from_strings("rfv", "centroid")
    specs = [T.SweepSpec(apps=APPS, plan=plan_r, config_indices=(0, 1, 2),
                         selection_seed=s) for s in (1, 2, 3)] + [
        T.SweepSpec(apps=APPS, plan=plan_c, config_indices=(0, 1, 2))] * 2
    serial_eng = _copy(base, None)
    serial = [_quiet(T.run_sweep, serial_eng, s) for s in specs]
    mesh = _mesh("app3")
    sharded = _copy(base, mesh)
    coal = _quiet(run_coalesced_sweeps, sharded, specs)
    for st, ct in zip(serial, coal):
        _assert_rows_bitwise(ct, st)
    _assert_memo_equal(sharded, serial_eng)

    service = SweepService(_copy(base, None), mesh=mesh)
    assert service.mesh == mesh
    ids = [service.submit(s) for s in specs]
    _quiet(service.drain)
    for rid, st in zip(ids, serial):
        _assert_rows_bitwise(service.result(rid), st)
    _assert_memo_equal(service.engine, serial_eng)


# ------------------------------------------- against the reference
def test_one_device_mesh_matches_reference(built, reference_shard_map):
    """The reference engine on ``make_app_mesh()`` over its one CPU
    device against the port on ``make_app_mesh(devices=["cpu"])``: build
    labels and picks exactly, a fused RFV sweep and the SRS sweep to rtol
    1e-5 with their charges exactly, trial counts exactly."""
    from repro.launch.mesh import make_app_mesh as rmake_app_mesh
    base, _ = built
    ref = R.ExperimentEngine(precision=RPolicy(), mesh=rmake_app_mesh())
    _quiet(ref.build, APPS)
    ref.memo.cols_for(ref.configs)
    port = _copy(base, make_app_mesh(devices=["cpu"]))
    for e_r, e_p in zip(ref.build(APPS), port.build(APPS)):
        for f in ("bbv_labels", "rfv_labels", "dg_labels", "idx1"):
            np.testing.assert_array_equal(getattr(e_p, f).numpy(),
                                          np.asarray(getattr(e_r, f)), f)
    port.memo.load_state(*ref.memo.state(), universe=port.configs)
    for scheme, policy in (("rfv", "centroid"), ("srs", None)):
        kw = {} if policy is None else {
            "plan": SamplingPlan.from_strings(scheme, policy)}
        rkw = {} if policy is None else {
            "plan": rplan.SamplingPlan.from_strings(scheme, policy)}
        got = _quiet(T.run_sweep, port, T.SweepSpec(apps=APPS, **kw))
        want = _quiet(R.run_sweep, ref, R.SweepSpec(apps=APPS, **rkw))
        np.testing.assert_allclose(got.column("estimate"),
                                   want.column("estimate"), rtol=1e-5)
        np.testing.assert_array_equal(got.column("n_units"),
                                      want.column("n_units"))
        np.testing.assert_array_equal(port.memo.charges, ref.memo.charges)
    spec_t = T.TrialSpec(trials=512, schemes=("random", "rfv"))
    got = _quiet(T.run_trials, port, spec_t, apps=APPS)
    want = _quiet(R.run_trials, ref, R.TrialSpec(trials=512,
                                                 schemes=("random", "rfv")),
                  apps=APPS)
    for s in spec_t.schemes:
        np.testing.assert_array_equal(got.stats[s].count.numpy(),
                                      np.asarray(want.stats[s].count))


def _near_ties(x, centroids, labels_a, labels_b):
    """Where two label vectors differ, whether the point's best and
    second-best squared distances lie within ``TIE_RTOL``."""
    d2 = ((x[:, None, :].double() - centroids[None].double()) ** 2).sum(-1)
    two = torch.topk(d2, 2, dim=1, largest=False).values
    tie = (two[:, 1] - two[:, 0]) <= TIE_RTOL * two[:, 1]
    differ = torch.as_tensor(labels_a) != torch.as_tensor(labels_b)
    return int(differ.sum()), int((differ & tie).sum())


def test_distributed_kmeans_matches_reference(built, reference_shard_map):
    """The port's ``distributed_kmeans`` over one shard against the
    reference's on its one-device host mesh (505.mcf_r's 40,000 projected
    BBVs, k = 20, 6 Lloyd steps): labels equal except counted near-ties,
    centroids and inertia to rtol 1e-5."""
    from repro.core.clustering.distributed import \
        distributed_kmeans as rdistributed
    from repro.launch.mesh import make_host_mesh
    base, _ = built
    x = base.app(APPS[0]).bbv_feats
    c1, l1, i1 = distributed_kmeans(x, 20, Mesh([CPU], ("data",)), iters=6)
    c_r, l_r, i_r = rdistributed(x.numpy(), 20, make_host_mesh(), iters=6)
    np.testing.assert_allclose(c1.numpy(), np.asarray(c_r), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(i1, i_r, rtol=1e-5)
    differ, ties = _near_ties(x, c1, l1, np.array(l_r))
    print(f"distributed k-means: {differ} labels differ from the "
          f"reference's, {ties} of them at near-ties")
    assert differ == ties


def test_distributed_kmeans_four_shards_against_one(built):
    """One Lloyd step over 4 shards of 10,000 points against 1 shard of
    40,000, from the same centroids: the shards' assignments equal the
    one shard's bit for bit; the new centroids differ only by the order
    of their float32 sums (within 2 * 2^-24 of the summed magnitudes of
    each cluster's points, the bound of two summation orders), the
    inertia to rtol 1e-6. Over several steps the reordered sums move
    points near a boundary in the next step, so two whole runs part
    slightly, as an all-reduce over devices makes any run do: the 4-shard
    run is held to the 1-shard run's inertia to 1e-3, at most
    ``DKM_LABEL_SHARE`` of its labels may differ, and its labels are
    those of its own centroids."""
    from repro_torch.core.clustering.distributed import (
        make_distributed_assign, make_distributed_kmeans_step, shard_points)
    base, _ = built
    x = base.app(APPS[0]).bbv_feats
    one, four = Mesh([CPU], ("data",)), Mesh([CPU] * 4, ("data",))
    c0, _, _ = distributed_kmeans(x, 20, one, iters=3)
    xs1 = shard_points(x, one, ("data",))
    xs4 = shard_points(x, four, ("data",))
    assert [b.shape[0] for b in xs4] == [10000] * 4
    lab1 = torch.cat(make_distributed_assign(one, ("data",))(xs1, c0))
    lab4 = torch.cat(make_distributed_assign(four, ("data",))(xs4, c0))
    assert torch.equal(lab4, lab1)
    n1, in1 = make_distributed_kmeans_step(one, ("data",), 20)(xs1, c0)
    n4, in4 = make_distributed_kmeans_step(four, ("data",), 20)(xs4, c0)
    mag = torch.zeros(20, x.shape[1]).index_add_(0, lab1.long(), x.abs())
    bound = 2 * 2.0 ** -24 * mag + torch.finfo(torch.float32).eps * n1.abs()
    assert ((n4 - n1).abs() <= bound).all()
    np.testing.assert_allclose(float(in4), float(in1), rtol=1e-6)
    c1, l1, i1 = distributed_kmeans(x, 20, one, iters=6)
    c4, l4, i4 = distributed_kmeans(x, 20, four, iters=6)
    print(f"4 shards against 1 after 6 steps: {int((l4 != l1).sum())} of "
          f"{len(l1)} labels differ, inertia {i4} against {i1}")
    assert abs(i4 - i1) <= 1e-3 * i1
    assert int((l4 != l1).sum()) <= DKM_LABEL_SHARE * len(l1)
    assert torch.equal(l4, torch.cat(make_distributed_assign(
        four, ("data",))(xs4, c4)).long())


@pytest.mark.parametrize("case", ["seed1", "seed2", "planted_fault"])
def test_distributed_kmeans_whole_runs_by_seed(built, monkeypatch, case):
    """Whole runs of 6 steps, 4 shards against 1, at two more seeds: the
    inertia within 1e-3 and at most ``DKM_LABEL_SHARE`` of the labels
    apart. With one shard's statistics counted twice in every step (a
    wrong merge) both bounds fail, so they can tell a fault from the
    reordered sums."""
    from repro_torch.core.clustering import distributed
    base, _ = built
    x = base.app(APPS[0]).bbv_feats
    one, four = Mesh([CPU], ("data",)), Mesh([CPU] * 4, ("data",))
    seed = {"seed1": 1, "seed2": 2, "planted_fault": 0}[case]
    c1, l1, i1 = distributed_kmeans(x, 20, one, iters=6, seed=seed)
    if case == "planted_fault":
        real, calls = distributed._local_stats, []

        def twice(xl, c, k):
            labels, sums, counts, inertia = real(xl, c, k)
            calls.append(1)
            if len(calls) % 4 == 1:                 # shard 0 of each step
                return labels, 2 * sums, 2 * counts, 2 * inertia
            return labels, sums, counts, inertia

        monkeypatch.setattr(distributed, "_local_stats", twice)
    c4, l4, i4 = distributed_kmeans(x, 20, four, iters=6, seed=seed)
    differ = int((l4 != l1).sum())
    print(f"{case}: {differ} of {len(l1)} labels differ, inertia "
          f"{i4} against {i1}")
    within = (abs(i4 - i1) <= 1e-3 * i1
              and differ <= DKM_LABEL_SHARE * len(l1))
    assert within == (case != "planted_fault")


@pytest.mark.multidevice
@needs_devices
def test_four_shard_port_matches_reference_eight_device_mesh(
        built, reference_shard_map):
    """The port's 4-shard sweep and trials against the reference's
    8-device app mesh: estimates to rtol 1e-5, charges and ``n_units``
    exactly; the trials' counts exactly and errors to rtol 1e-5."""
    from repro.launch.mesh import make_app_mesh as rmake_app_mesh
    base, _ = built
    ref = R.ExperimentEngine(precision=RPolicy(), mesh=rmake_app_mesh())
    _quiet(ref.build, APPS)
    ref.memo.cols_for(ref.configs)
    port = _copy(base, _mesh("app4"))
    port.memo.load_state(*ref.memo.state(), universe=port.configs)
    got = _quiet(T.run_sweep, port, T.SweepSpec(
        apps=APPS, plan=SamplingPlan.from_strings("rfv", "centroid")))
    want = _quiet(R.run_sweep, ref, R.SweepSpec(
        apps=APPS, plan=rplan.SamplingPlan.from_strings("rfv", "centroid")))
    np.testing.assert_allclose(got.column("estimate"),
                               want.column("estimate"), rtol=1e-5)
    np.testing.assert_array_equal(got.column("n_units"),
                                  want.column("n_units"))
    np.testing.assert_array_equal(port.memo.charges, ref.memo.charges)
    got_t = _quiet(T.run_trials, port, T.TrialSpec(trials=256), apps=APPS)
    want_t = _quiet(R.run_trials, ref, R.TrialSpec(trials=256), apps=APPS)
    for s in got_t.stats:
        np.testing.assert_array_equal(got_t.stats[s].count.numpy(),
                                      np.asarray(want_t.stats[s].count))
        np.testing.assert_allclose(got_t.errors[s], want_t.errors[s],
                                   rtol=1e-5, atol=1e-4)
