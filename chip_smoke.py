#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel of the main path from ``src/repro_torch/csrc``
(one ``nvcc`` per source, started together), holds each kernel against its
plain PyTorch version on the card at the main path's shapes and times both,
then drives the main path — ``ExperimentEngine(device="cuda").build`` over
all ten apps and the staged sweeps (srs, and rfv / bbv / dg with
``Centroid``) — with the kernels' launch counters set to 0 just before and
read just after. It rebuilds the same state through the plain versions to
hold the path's results against them, then once more through the kernels
(warm, as the plain build was) to time both builds alike, and traces one
more kernel build with ``torch.profiler`` for the card's busy time. Any
failure raises and exits non-zero.

Output: progress lines, then the card's name and power limit (as
``nvidia-smi`` reports them), one JSON line with each kernel's numbers and,
last, ``{"ok": true, "device": {...}}``. With no CUDA device, or without the
rest of the repository, it prints no result and exits non-zero.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 outside the
# tensor cores. Bounds use these whatever the card's power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# tolerances of the kernel checks (see CHANGES.md for the reasons)
ASSIGN_TIE_RTOL = 1e-5        # labels may differ only at such near-ties
ASSIGN_D2_RTOL, ASSIGN_D2_ATOL = 1e-5, 1e-6
SEGMENT_RTOL = 1e-5           # relative to the sum of |terms| per segment
MIN_LABEL_AGREEMENT = 0.999   # kernel build vs plain build, per app & fit


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, *, warmup: int = 3, iters: int = 20) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time (ms) for the work and what sets it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phase 1
def phase_build(backend_mod) -> None:
    import torch
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    info = backend_mod.build_all()
    for name, rec in sorted(info.items()):
        log(f"build {name}: nvcc {rec['seconds']:.2f} s")
        for line in rec["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry")):
                log(f"  ptxas {name}: {line.strip()}")


# ------------------------------------------------------------------ phase 2
def check_kmeans_assign(gen) -> dict:
    import torch
    from repro_torch.kernels.kmeans_assign import ops
    from repro_torch.kernels.kmeans_assign.ref import pairwise_d2

    out = {}
    # main-path shapes: BBV fit (lanes, N_max, 15) and RFV fit (lanes,
    # n1_max, 38), k = 20; neither n is a multiple of the 128-point tile
    for tag, (b, n, d) in {"bbv": (10, 120000, 15),
                           "rfv": (10, 6861, 38)}.items():
        k = 20
        x = torch.randn((b, n, d), generator=gen, device="cuda")
        c = torch.randn((b, k, d), generator=gen, device="cuda")
        lab_k, d2_k = ops.kmeans_assign(x, c)
        d2_all = pairwise_d2(x, c)
        best2 = torch.topk(d2_all, 2, dim=-1, largest=False).values
        d2_p, lab_p = torch.min(d2_all, dim=-1)
        d2_p = torch.clamp_min(d2_p, 0.0)
        tie = (best2[..., 1] - best2[..., 0]) \
            <= ASSIGN_TIE_RTOL * best2[..., 1].abs()
        bad = (lab_k.long() != lab_p) & ~tie
        if bool(bad.any()):
            raise AssertionError(f"kmeans_assign {tag}: {int(bad.sum())} "
                                 "labels differ away from near-ties")
        torch.testing.assert_close(d2_k, d2_p, rtol=ASSIGN_D2_RTOL,
                                   atol=ASSIGN_D2_ATOL)
        err = float((d2_k - d2_p).abs().max())
        ms = time_ms(lambda: ops.kmeans_assign(x, c))
        plain_ms = time_ms(lambda: ops.kmeans_assign(x, c, backend="plain"),
                           iters=5)
        nbytes = 4 * (b * n * d + b * k * d + 2 * b * n)
        flops = 2.0 * b * n * k * d + 2.0 * b * n * d
        bound_ms, bound_by = bound(nbytes, flops)
        log(f"kmeans_assign {tag} (b={b}, n={n}, d={d}, k={k}): "
            f"{int((lab_k.long() != lab_p).sum())} near-tie label diffs, "
            f"max |d2 err| {err:.3g}, bitwise equal to plain "
            f"{bool(torch.equal(d2_k, d2_p))}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"bound share {bound_ms / ms:.3f}")
        out[tag] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by}
    return out


def check_segment_stats(gen) -> dict:
    import torch
    from repro_torch.kernels.segment_stats import ops
    from repro_torch.kernels.segment_stats.ref import segment_stats_ref

    out = {}
    # main-path shapes: stratum summaries (d = 1) over the census and the
    # phase-1 sample, and the weighted centroid updates (d + 1 columns)
    shapes = {"census_d1": (10, 120000, 1), "phase1_d1": (10, 6861, 1),
              "bbv_update": (10, 120000, 16), "rfv_update": (10, 6861, 39)}
    for tag, (b, n, d) in shapes.items():
        k = 20
        x = torch.randn((b, n, d), generator=gen, device="cuda")
        lab = torch.randint(-1, k + 1, (b, n), generator=gen, device="cuda",
                            dtype=torch.int32)       # -1 and k are dead
        x = torch.where(((lab < 0) | (lab >= k))[..., None],
                        torch.full_like(x, float("nan")), x)
        s_k, q_k, c_k = ops.segment_stats(x, lab, k)
        s_2, q_2, c_2 = ops.segment_stats(x, lab, k)
        for a, b_ in ((s_k, s_2), (q_k, q_2), (c_k, c_2)):
            if not torch.equal(a, b_):
                raise AssertionError(f"segment_stats {tag}: two launches "
                                     "differ")
        s_p, q_p, c_p = segment_stats_ref(x, lab, k)
        if not torch.equal(c_k, c_p):
            raise AssertionError(f"segment_stats {tag}: counts differ")
        abs_sums = segment_stats_ref(x.abs(), lab, k)[0]
        for got, want, scale in ((s_k, s_p, abs_sums), (q_k, q_p, q_p)):
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"segment_stats {tag}: non-finite")
            limit = SEGMENT_RTOL * scale + 1e-6
            if bool(((got - want).abs() > limit).any()):
                raise AssertionError(
                    f"segment_stats {tag}: max err "
                    f"{float((got - want).abs().max()):.3g}")
        err = float(torch.maximum((s_k - s_p).abs().max(),
                                  (q_k - q_p).abs().max()))
        ms = time_ms(lambda: ops.segment_stats(x, lab, k))
        plain_ms = time_ms(lambda: segment_stats_ref(x, lab, k), iters=5)
        # one library call computing the sums: index_add_ by flat segment
        valid = (lab >= 0) & (lab < k)
        flat = (torch.where(valid, lab, 0).long()
                + k * torch.arange(b, device="cuda")[:, None]).reshape(-1)
        w = torch.where(valid[..., None], x, 0.0).reshape(b * n, d)
        acc = torch.zeros((b * k, d), device="cuda")
        lib_ms = time_ms(lambda: acc.zero_().index_add_(0, flat, w))
        nbytes = 4 * (b * n * d + b * n + 2 * b * k * d + b * k)
        flops = 3.0 * b * n * d + b * n
        bound_ms, bound_by = bound(nbytes, flops)
        # the kernel and the plain version both add in row order, on the
        # card as on the CPU: all three agree bitwise
        on_cpu = segment_stats_ref(x.cpu(), lab.cpu(), k)
        for name, got in (("kernel", (s_k, q_k, c_k)),
                          ("plain on CUDA", (s_p, q_p, c_p))):
            if not all(torch.equal(a.cpu(), b_)
                       for a, b_ in zip(got, on_cpu)):
                raise AssertionError(f"segment_stats {tag}: {name} is not "
                                     "bitwise equal to the plain version "
                                     "on the CPU")
        log(f"segment_stats {tag} (b={b}, n={n}, d={d}, k={k}): max err "
            f"{err:.3g}, kernel, plain on CUDA and plain on the CPU bitwise "
            f"equal; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, "
            f"index_add_ {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), bound share {bound_ms / ms:.3f}")
        out[tag] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib_ms}
    return out


# ------------------------------------------------------------------ phase 3
SCHEMES = ("srs", "rfv", "bbv", "dg")
FITS = ("bbv_labels", "rfv_labels", "dg_labels")


def drive_main_path(backend: str):
    """Build all apps and run the four staged sweeps; returns the engine,
    the tables by scheme and the seconds by phase."""
    import torch
    from repro_torch.core.sampling.plan import SamplingPlan, make_stratifier
    from repro_torch.experiments import (ExperimentEngine, SweepSpec,
                                         run_sweep)
    from repro_torch.simcpu import APP_NAMES

    secs = {}
    t0 = time.perf_counter()
    engine = ExperimentEngine(device="cuda", backend=backend)
    engine.build(APP_NAMES)
    torch.cuda.synchronize()
    secs["build"] = time.perf_counter() - t0
    tables = {}
    for scheme in SCHEMES:
        plan = None if scheme == "srs" \
            else SamplingPlan(make_stratifier(scheme))
        t0 = time.perf_counter()
        tables[scheme] = run_sweep(engine, SweepSpec(apps=APP_NAMES,
                                                     plan=plan, fused=False))
        torch.cuda.synchronize()
        secs[f"sweep_{scheme}"] = time.perf_counter() - t0
    return engine, tables, secs


def trace_build() -> None:
    """One more (warm) kernel build under ``torch.profiler``: the card's
    busy time against the wall time, and the kernels that fill it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.experiments import ExperimentEngine
    from repro_torch.simcpu import APP_NAMES

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ExperimentEngine(device="cuda").build(APP_NAMES)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rec = by_name.setdefault(e.name, [0, 0.0])
            rec[0] += 1
            rec[1] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in by_name.values())
    if not by_name:
        log(f"traced build: {wall_ms:.1f} ms wall; the profiler saw no "
            "device activity, so busy time is not measured")
        return
    log(f"traced build: {wall_ms:.1f} ms wall (profiler on), device busy "
        f"{busy_ms:.1f} ms in {sum(n for n, _ in by_name.values())} "
        f"device events, idle share {1 - busy_ms / wall_ms:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    for name, (n, ms) in top:
        log(f"  {ms:9.2f} ms {n:7d}x  {name[:90]}")


def check_tables(tables, n_apps: int, n_cfgs: int) -> None:
    import numpy as np
    for scheme, table in tables.items():
        est = table.column("estimate")
        if len(table) != n_apps * n_cfgs or not np.isfinite(est).all() \
                or not (est > 0).all():
            raise AssertionError(f"{scheme}: {len(table)} rows, finite "
                                 f"{np.isfinite(est).all()}")
        err = table.column("err_pct")
        log(f"  {scheme}: max err_pct {err.max():.4f}, median "
            f"{np.median(err):.4f}")


def phase_main_path() -> tuple[dict, object, dict]:
    import numpy as np
    import torch
    from repro_torch.core.clustering import kmeans_bank
    from repro_torch.kernels.kmeans_assign import ops as assign_ops
    from repro_torch.kernels.segment_stats import ops as segment_ops
    from repro_torch.simcpu import APP_NAMES

    torch.cuda.reset_peak_memory_stats()
    assign_ops.reset_launch_count()
    segment_ops.reset_launch_count()
    engine, tables, secs = drive_main_path("auto")
    launches = {"kmeans_assign": assign_ops.launch_count(),
                "segment_stats": segment_ops.launch_count()}
    for phase, s in secs.items():
        log(f"main path {phase}: {s:.2f} s")
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")
    ledger = [e.sim.ledger.regions_simulated for e in engine.build(APP_NAMES)]
    log(f"ledger regions simulated {ledger} (total {sum(ledger)}); memo "
        f"charges {engine.memo.total_charges()}")
    check_tables(tables, len(APP_NAMES), len(engine.configs))

    # the RFV fit again on the same input: labels must be bitwise stable
    exps = engine.build(APP_NAMES)
    stack = engine.stack(APP_NAMES)
    zr = torch.zeros((len(exps), stack.idx1.shape[1], exps[0].rfv_z.shape[1]),
                     dtype=torch.float64, device="cuda")
    for a, e in enumerate(exps):
        zr[a, :e.rfv_z.shape[0]] = e.rfv_z
    refit = kmeans_bank(zr, engine.num_strata,
                        weights=stack.idx1_valid.float(), seed=0)
    for a, e in enumerate(exps):
        if not torch.equal(refit.labels[a, :e.rfv_labels.shape[0]],
                           e.rfv_labels):
            raise AssertionError(f"RFV refit labels differ for {e.name}")
    log("RFV refit: labels bitwise equal for every app")

    # the same state through the plain versions, called explicitly (warm:
    # this process's host caches already hold the populations and BBVs)
    plain, plain_tables, plain_secs = drive_main_path("plain")
    lowest = 1.0
    for e, p in zip(exps, plain.build(APP_NAMES)):
        agree = {fit: float((getattr(e, fit) == getattr(p, fit))
                            .float().mean()) for fit in FITS}
        log(f"  {e.name}: kernel vs plain label agreement "
            + ", ".join(f"{fit} {a:.6f}" for fit, a in agree.items()))
        for fit, a in agree.items():
            if a < MIN_LABEL_AGREEMENT:
                raise AssertionError(f"{e.name} {fit}: kernel vs plain "
                                     f"agreement {a:.6f}")
        lowest = min(lowest, *agree.values())
    worst = max(float(np.max(np.abs(tables[s].column("estimate")
                                    - plain_tables[s].column("estimate"))
                             / plain_tables[s].column("estimate")))
                for s in SCHEMES)
    log(f"kernel vs plain build: lowest label agreement {lowest:.6f} over "
        f"apps and fits; largest relative estimate difference {worst:.3g}")

    # the kernels again, warm like the plain build, so that the two builds
    # are timed alike; the labels must not change between kernel builds
    warm, warm_tables, warm_secs = drive_main_path("auto")
    for e, w in zip(exps, warm.build(APP_NAMES)):
        for fit in FITS:
            if not torch.equal(getattr(e, fit), getattr(w, fit)):
                raise AssertionError(f"{e.name} {fit}: two kernel builds "
                                     "differ")
    for s in SCHEMES:
        if not np.array_equal(tables[s].column("estimate"),
                              warm_tables[s].column("estimate")):
            raise AssertionError(f"{s}: two kernel runs differ")
    log(f"build s: kernels cold {secs['build']:.2f}, plain warm "
        f"{plain_secs['build']:.2f}, kernels warm {warm_secs['build']:.2f}; "
        "sweeps s (plain / kernels warm): " + ", ".join(
            f"{s} {plain_secs['sweep_' + s]:.3f} / "
            f"{warm_secs['sweep_' + s]:.3f}" for s in SCHEMES)
        + "; second kernel build bitwise equal to the first")
    trace_build()
    return launches, engine, secs


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import backend as backend_mod
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 2

    card = gpu_name_and_limit()
    log(f"card: {card}")
    phase_build(backend_mod)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    assign = check_kmeans_assign(gen)
    segment = check_segment_stats(gen)
    launches, _, _ = phase_main_path()

    rows = [
        {"name": "kmeans_assign", "route": "cuda",
         "source": "src/repro_torch/csrc/kmeans_assign.cu",
         "replaces": "src/repro/kernels/kmeans_assign/kmeans_assign.py:41",
         "launches": launches["kmeans_assign"], **assign["bbv"],
         "library_ms": None},
        {"name": "segment_stats", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_stats.cu",
         "replaces": "src/repro/kernels/segment_stats/segment_stats.py:28",
         "launches": launches["segment_stats"], **segment["bbv_update"]},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
