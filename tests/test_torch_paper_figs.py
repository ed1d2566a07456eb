"""The port's paper figures and tables against the reference, on the CPU.

Every function of ``repro_torch.experiments.paper_figs`` runs beside its
namesake in ``benchmarks/paper_figs.py`` on the two ragged apps of
``tests/test_torch_engine.py``. The reference runs as its own benchmark
runs it, with three substitutions made by ``monkeypatch`` (nothing in
``benchmarks/`` changes):

* its process-wide engine is an explicit float32-policy engine
  (``ExperimentEngine(precision=PrecisionPolicy())``): the default
  ``host_parity`` policy needs the x64 mode jax 0.9.0 no longer has;
* its sweeps are the staged ones (``SweepSpec(fused=False)``): under the
  float32 policy the reference's fused program computes ``Centroid``'s
  distances in float32 (``result_type(0.0)`` without x64), whose
  cancellation moves Dalenius-Gurney centroid picks (1.6 points of
  Fig 10 error on these apps), while its staged path and the port compute
  them in float64;
* Table IV's sizing is the reference's numpy host sizing (its jitted
  default needs x64), as ``tests/test_streaming_trials.py`` states it.

The gcc sensitivity runs on the first app (gcc's 120,000 regions are the
ten-app run's). Held to: label digests and picks exactly; figure
integers exactly; floats to rtol 1e-5, percent errors also within
``paper_figs.ERR_ATOL`` points (an estimate's rtol carried into a percent
error); Fig 8's coverage within its near-tie trials. A figure number may
differ only where that figure's own k-means fit picked another unit at a
near-tie; every fit gives the reference's labels, as the clustering
kernels and their plain versions take the reference's float32 dot order
at each fit's shape (``core.ordered.DOT_ORDERS``, held row by row here).

``reference_figures`` also writes ``paper_figs_reference.json`` (the
reference's ten-app numbers that ``chip_smoke.py`` holds the card
against): ``python tests/test_torch_paper_figs.py --write``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import pathlib
import sys
import time
import warnings

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import repro_torch.core.ordered as ORDERED  # noqa: E402
import repro_torch.experiments as T  # noqa: E402
from repro_torch.experiments import paper_figs as TP  # noqa: E402

APPS = ("505.mcf_r", "500.perlbench_r")
_digest = TP._digest


def _host_sizing(weights, within_stds, phase1_n, between_var, *,
                 target_margin_abs, confidence=0.95, allocation="neyman",
                 min_per_stratum=2, max_total=10**7):
    """The reference's numpy host sizing (tests/test_streaming_trials.py
    ``test_phase2_sizing_jit_matches_host_reference``)."""
    from repro.core.sampling.allocation import (neyman_allocation,
                                                proportional_allocation)
    from repro.core.sampling.types import critical_value

    w = np.asarray(weights, np.float64)
    s = np.asarray(within_stds, np.float64)
    z = critical_value(confidence, None)
    v_target = (target_margin_abs / z) ** 2
    v_budget = v_target - between_var / phase1_n
    if v_budget <= 0:
        raise ValueError("target margin unattainable")
    numer = (w * s).sum() ** 2 if allocation == "neyman" \
        else (w * s * s).sum()
    n_total = min(max(int(np.ceil(numer / v_budget)), 2 * len(w)),
                  max_total)
    if allocation == "neyman":
        return neyman_allocation(w, s, n_total,
                                 min_per_stratum=min_per_stratum)
    return proportional_allocation(w, n_total)


def _reference_selection(engine, apps) -> dict:
    """The reference's counterpart of ``paper_figs.selection_record``."""
    import repro.experiments as R
    from repro.core.sampling import plan as rplan

    exps = engine.build(tuple(apps))
    out = {e.name: {f: _digest(getattr(e, f)) for f in
                    ("bbv_labels", "rfv_labels", "dg_labels")}
           for e in exps}
    plans = [(s, p, 0) for s in ("bbv", "rfv", "dg")
             for p in ("centroid", "mean")] + [("rfv", "random", 3)]
    for scheme, policy, seed in plans:
        picks, valid, _ = R.plan_selection_bank(
            exps, rplan.SamplingPlan.from_strings(scheme, policy), seed)
        picks = np.where(valid, picks, -1)
        for a, e in enumerate(exps):
            out[e.name][f"{scheme}/{policy}"] = [int(v) for v in picks[a]]
    return out


def reference_figures(apps=APPS, gcc_app=None, trials=1000) -> dict:
    """Every reference figure on ``apps`` (the JSON layout of
    ``paper_figs_reference.json``): the figure dicts, the selection
    record, the label digests of the figures' own k-means fits and
    Fig 8's near-tie share per scheme."""
    import benchmarks.paper_figs as RP
    import benchmarks.simcpu_common as RC
    import repro.core.clustering as RCL
    import repro.core.sampling as RS
    import repro.experiments as R
    from repro.core.precision import PrecisionPolicy as RPolicy

    gcc_app = gcc_app or apps[0]
    engine = R.ExperimentEngine(precision=RPolicy())
    fits, trial_runs, current = {}, [], {}
    real_kmeans, real_select = RCL.kmeans, RS.select_centroid

    def kmeans(*args, **kwargs):
        km = real_kmeans(*args, **kwargs)
        tag, ks = TP.FIT_TAGS[current["fig"]]
        calls = current.setdefault("calls", [])
        if tag == "gcc":
            key = f"gcc/{gcc_app}/{ks[len(calls)]}"
        else:
            key = f"{tag}/{apps[len(calls)]}/{ks[0]}"
        calls.append(key)
        fits[key] = {"labels": _digest(km.labels)}
        return km

    def select_centroid(*args, **kwargs):
        # each figure fit is followed by its centroid picks
        local = real_select(*args, **kwargs)
        fits[current["calls"][-1]]["picks"] = [
            int(lo[0]) if lo.size else -1 for lo in local]
        return local

    def run_trials(*args, **kwargs):
        res = R.run_trials(*args, **kwargs)
        trial_runs.append(res)
        return res

    figures = {}
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mp.setattr(RC, "_ENGINE", engine)
        mp.setattr(RP, "all_apps", lambda: list(apps))
        mp.setattr(RP, "build_experiment", lambda name, kmeans_seed=0:
                   engine.app(gcc_app if name == TP.GCC else name,
                              kmeans_seed))
        mp.setattr(RP, "phase2_sizes_for_margin", _host_sizing)
        mp.setattr(RP, "SweepSpec", functools.partial(R.SweepSpec,
                                                      fused=False))
        mp.setattr(RP, "run_trials", run_trials)
        mp.setattr(RCL, "kmeans", kmeans)
        mp.setattr(RS, "select_centroid", select_centroid)
        with contextlib.redirect_stdout(sys.stderr):
            for name in TP.FIGURES:
                current.clear()
                current["fig"] = name
                fn = getattr(RP, name)
                figures[name] = fn(trials) if name == "bench_ci_empirical" \
                    else fn()
    res = trial_runs[0]
    truth = np.stack([e.truth[res.spec.config_index]
                      for e in engine.build(tuple(apps))])
    near = {}
    for scheme in res.estimates:
        gap = np.abs(res.estimates[scheme]
                     - truth[:, None].astype(np.float32))
        half = res.half_widths[scheme]
        ties = np.abs(gap - half) <= TP.TIE_RTOL * np.abs(half)
        near[scheme] = float(ties.sum()) / (len(apps) * trials)
    return {"apps": list(apps), "gcc_app": gcc_app, "trials": trials,
            "figures": TP.to_jsonable(figures),
            "selection": _reference_selection(engine, apps),
            "fits": fits, "fig8_near_ties": near}


def port_figures(engine, apps=APPS, gcc_app=None) -> dict:
    """The port's figures in the same layout (fits keyed alike)."""
    record = {}
    with contextlib.redirect_stdout(sys.stderr):
        figures = TP.run_all(engine, apps, gcc_app=gcc_app or apps[0],
                             record=record)
    return {"figures": TP.to_jsonable(figures),
            "selection": TP.selection_record(engine, apps),
            "fits": TP.fit_summary(record), "record": record}


@pytest.fixture(scope="module")
def figures():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        t0 = time.perf_counter()
        want = reference_figures()
        t_ref = time.perf_counter() - t0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t0 = time.perf_counter()
            got = port_figures(T.ExperimentEngine(device="cpu"))
            t_port = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    print(f"reference figures {t_ref:.1f} s, port figures {t_port:.1f} s")
    return got, want


def test_selection_record_matches_reference(figures):
    got, want = figures
    assert got["selection"] == want["selection"]


@pytest.mark.parametrize("figure", list(TP.FIGURES))
def test_figure_matches_reference(figures, figure):
    got, want = figures
    diffs = TP.compare({figure: got["figures"][figure]},
                       {figure: want["figures"][figure]},
                       near_ties=want["fig8_near_ties"])
    why = [TP.explain(d, got["record"], want["fits"], want["gcc_app"])
           for d in diffs]
    print(f"{figure}: {len(diffs)} differences, each where the figure's "
          f"own fit picked at near-ties: {list(zip(why, diffs))}")
    apart = [d for d, w in zip(diffs, why) if w is not None]
    assert [d for d in diffs if d not in apart] == []


def test_figure_fits_give_the_reference_labels(figures):
    """The figures' own fits give the reference's labels at every k (the
    dot order follows the reference's at each shape, so no fit parts);
    the picks agree except at near-ties."""
    got, want = figures
    assert set(got["fits"]) == set(want["fits"])
    apart = sorted(key for key, w in want["fits"].items()
                   if got["fits"][key]["labels"] != w["labels"])
    ties = {}
    for key, w in want["fits"].items():
        differing, near = TP.pick_ties(got["record"][key], w["picks"])
        assert differing == near, (key, differing, near)
        ties[key] = near
    print(f"fits that parted: {apart}; near-tie picks: {ties}")
    assert apart == []


def _dot_order_id(shape) -> str:
    return "x".join(map(str, shape))


# fits at d < 4 (the flow's stratifier fits and the tests' small ones):
# no row of the table, since both orders are one chain there
FIT_SHAPES_BELOW_4 = ((1, 32, 4, 3), (1, 120, 16, 2), (1, 200, 6, 2),
                      (1, 250, 8, 2), (3, 400, 5, 3))


@pytest.mark.parametrize(
    "shape", sorted(ORDERED.DOT_ORDERS) + list(FIT_SHAPES_BELOW_4),
    ids=_dot_order_id)
def test_reference_dot_order_at_figure_shapes(shape):
    """One row of the port's dot-order table against the reference's own
    distance einsum at that shape (B lanes, n points, k centroids, d
    features): where the row says one chain, the reference's float32 dot
    is one multiply-add chain over d, and elsewhere (d >= 4) it is not.
    The port's dot in the row's order, its squared norms in their rows'
    order (``sum_sq_rows``: at d = 5 to 8 the reference adds a norm in
    one order in its vector body over the rows and in another after it)
    and so its ``pairwise_d2`` equal the reference's bitwise at every
    row."""
    import jax
    import jax.numpy as jnp
    from repro_torch.core.ordered import dot_chain, dot_in_order, sum_sq_rows
    from repro_torch.kernels.kmeans_assign.ref import dot_order, pairwise_d2

    b, n, k, d = shape
    order = ORDERED.reference_dot_order(*shape)
    assert (shape in ORDERED.DOT_ORDERS) == (d >= 4)
    rng = np.random.default_rng(b * 7 + n + k + d)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    c = rng.standard_normal((b, k, d)).astype(np.float32)
    assert dot_order(torch.from_numpy(x), torch.from_numpy(c)) == order

    @jax.jit
    def reference(xa, ca):
        xc = jnp.einsum("bnd,bkd->bnk", xa, ca)
        x2 = jnp.sum(xa * xa, axis=2, keepdims=True)
        c2 = jnp.sum(ca * ca, axis=2)[:, None, :]
        return xc, x2, c2, x2 - 2.0 * xc + c2

    ref_dot, ref_x2, ref_c2, ref_d2 = (np.asarray(a)
                                       for a in reference(x, c))
    ct = torch.from_numpy(c)
    x2 = sum_sq_rows(torch.from_numpy(x))
    c2 = sum_sq_rows(ct)
    assert np.array_equal(x2.numpy(), ref_x2[..., 0])
    assert np.array_equal(c2.numpy(), ref_c2[:, 0])
    if n <= 8192:
        got = pairwise_d2(torch.from_numpy(x), ct, order=order).numpy()
        assert np.array_equal(got, ref_d2)
    for s0 in range(0, n, 8192):
        rows = slice(s0, s0 + 8192)
        xt = torch.from_numpy(x[:, rows])
        chain = dot_chain(xt, ct).numpy()
        if order == "chain" or d < 4:
            assert np.array_equal(chain, ref_dot[:, rows])
        else:
            assert not np.array_equal(chain, ref_dot[:, rows])
        dot = dot_in_order(xt, ct, order)
        assert np.array_equal(dot.numpy(), ref_dot[:, rows])
        # pairwise_d2's own sum, from the lane's whole norms
        got = x2[:, rows, None] - 2.0 * dot + c2[:, None, :]
        assert np.array_equal(got.numpy(), ref_d2[:, rows])


# rows of a norm around every switch of its order (norm_vector_rows)
NORM_ROWS = (1, 2, 3, 4, 5, 7, 8, 9, 12, 15, 16, 17, 19, 20, 23, 24, 28,
             31, 32, 33, 36, 39, 40, 44, 76, 79, 80, 84, 87, 88, 92, 100,
             915)


@pytest.mark.parametrize("d", (4, 5, 6, 7, 8, 9))
def test_reference_norm_order_by_row_place(d):
    """``sum_sq_rows`` against the reference's ``sum(x * x, -1)`` in its
    distance program, for the points' norms (n rows) and the centroids'
    (k rows), at every row count in ``NORM_ROWS``: rows chosen so that the
    two orders differ at every row, so each row's order is checked."""
    import jax
    import jax.numpy as jnp
    from repro_torch.core.ordered import (norm_vector_rows, sum_sq,
                                          sum_sq_rows)

    @jax.jit
    def reference(xa, ca):
        x2 = jnp.sum(xa * xa, axis=2, keepdims=True)
        c2 = jnp.sum(ca * ca, axis=2)[:, None, :]
        return x2, c2, x2 - 2.0 * jnp.einsum("bnd,bkd->bnk", xa, ca) + c2

    rng = np.random.default_rng(d)
    pool = (rng.standard_normal((20000, d))
            * 10.0 ** rng.uniform(-1, 1, (20000, d))).astype(np.float32)
    pt = torch.from_numpy(pool)
    one_chain = sum_sq(pt)
    in_order = torch.zeros(len(pool))
    for j in range(d):
        in_order = in_order + pt[:, j] * pt[:, j]
    pool = pool[(one_chain != in_order).numpy()]
    for m in NORM_ROWS:
        other = 3 if m != 3 else 5
        x = pool[:m][None]
        c = pool[m:m + other][None]
        ref_x2, ref_c2, _ = (np.asarray(a) for a in reference(x, c))
        assert np.array_equal(sum_sq_rows(torch.from_numpy(x)).numpy(),
                              ref_x2[..., 0]), (m, d)
        xs, cs = reference(c, x)[:2]
        assert np.array_equal(sum_sq_rows(torch.from_numpy(x)).numpy(),
                              np.asarray(cs)[:, 0]), (m, d)
        if not 5 <= d <= 8:
            assert norm_vector_rows(m, d) == 0


def test_reference_json_matches_what_chip_smoke_reads():
    """The committed reference numbers have the layout and types that
    ``chip_smoke.py`` reads."""
    ref = TP.load_reference()
    assert ref["apps"] == list(T.paper_figs.APP_NAMES)
    assert ref["gcc_app"] == TP.GCC and ref["trials"] == 1000
    assert set(ref["figures"]) == set(TP.FIGURES)
    assert set(ref["selection"]) == set(ref["apps"])
    for app, rec in ref["selection"].items():
        for f in ("bbv_labels", "rfv_labels", "dg_labels"):
            assert isinstance(rec[f], str) and len(rec[f]) == 40
        for key in ("bbv/centroid", "rfv/mean", "rfv/random"):
            assert len(rec[key]) == 20
            assert all(isinstance(v, int) for v in rec[key])
    for fit in ref["fits"].values():
        assert isinstance(fit["labels"], str) and len(fit["labels"]) == 40
        assert all(isinstance(v, int) for v in fit["picks"])
    assert {k.split("/")[0] for k in ref["fits"]} == \
        {"fig12", "gcc", "approx", "isa"}
    assert set(ref["fig8_near_ties"]) == {"random", "bbv", "rfv", "dg"}
    figs = ref["figures"]
    assert isinstance(figs["bench_cpi_distributions"]["monotone_apps"], int)
    for app in ref["apps"]:
        n1, rfv, bbv = figs["bench_two_phase_sizing"]["per_app"][app]
        assert all(isinstance(v, int) for v in (n1, rfv, bbv))
        margin, covered = figs["bench_ci_collapsed"][app]
        assert isinstance(margin, float) and isinstance(covered, bool)
        assert len(figs["bench_ci_analytical"]["margins"][app]) == 4
    assert set(figs["bench_gcc_cluster_sensitivity"]) == {"20", "50"}


def test_ten_app_reference_numbers_regenerate():
    """The reference's ten-app numbers, regenerated, equal the committed
    JSON exactly."""
    got = json.loads(json.dumps(reference_figures(
        tuple(T.paper_figs.APP_NAMES), TP.GCC)))
    assert got == TP.load_reference()


if __name__ == "__main__":
    if "--write" in sys.argv:
        t0 = time.perf_counter()
        data = reference_figures(tuple(T.paper_figs.APP_NAMES), TP.GCC)
        TP.REFERENCE_JSON.write_text(json.dumps(data, indent=1) + "\n")
        print(f"wrote {TP.REFERENCE_JSON} in {time.perf_counter() - t0:.1f} s")
