#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
source, started together), counts the ``wgmma`` (HGMMA) and TMA (UTMALDG)
instructions of the bf16 flash-attention library, holds each kernel
against its plain PyTorch version on the card at the main paths' shapes
and times both, then measures the card's dependent float32 add latency (a
``clock64``-timed add chain beside ``nvidia-smi``'s SM clock) and holds
both clustering kernels bitwise against their plain versions on the
simulation build's own inputs -- the last Lloyd step of its BBV and RFV
fits, captured from ``ExperimentEngine.build`` -- timing them pass by pass
beside ``index_add_``, their bytes bound and the order bound of the
longest in-order add chain. Then it drives the port's paths, each with
the kernels' launch counters set to 0 just before it and read just
after:

* the simulation path — ``ExperimentEngine(device="cuda").build`` over all
  ten apps and the staged sweeps (srs, and rfv / bbv / dg with
  ``Centroid``). It rebuilds the same state through the plain versions to
  hold the path's results against them, then once more through the
  kernels (warm, as the plain build was) to time both builds alike, and
  traces one more kernel build with ``torch.profiler`` for the card's busy
  time;
* on the same ten-app engine, the fused sweeps of every stratifier (bbv,
  rfv, dg) and policy (centroid, mean, random) — cold (eager run and CUDA
  graph capture) and warm (replay, under ``torch.profiler``, which counts
  the ``segment_stats`` launches inside the graph: the wrapper makes
  none there) — each against the staged sweep from the same memo state,
  bit for bit, with the graph's ``segment_stats`` summary against its
  plain version; the paper's Fig 5/8/10/11 rows; the
  Monte-Carlo trials chunked against unchunked, bit for bit; and 10^5
  and 10^6 streamed trials under the reference's coverage gate;
* on the same engine, the paper's two-phase flow (``TwoPhaseFlow``) on
  every app at Table II's phase-1 size, then every paper figure and
  table (``repro_torch.experiments.paper_figs``) through the kernels and,
  on the plain-route engine, through the plain versions (all but the
  three of ``PLAIN_SKIPS``): the two held
  equal, and the kernels' numbers held against the reference's committed
  in ``paper_figs_reference.json``; both clustering kernels bitwise
  against their plain versions at the figures' new shapes (k = 50 over
  gcc's 120,000 BBVs, k = 500 over a phase-1 sample); every figure fit
  must give the reference's labels;
* the fault-tolerant fleet drivers and the sweep service on all ten apps
  and 7 configs (``phase_fleet_and_service``): supervised rfv and dg
  sweeps and 10^5 supervised trials, each killed three times (the rfv
  sweep's first and last attempts a fresh engine build), and
  ``SweepService``
  over 64 requests with a memo cap, each held bit for bit against the
  uninterrupted or serial run and against the plain route;
* the multi-device app axis (``phase_mesh``) on a 4-shard mesh that
  names the card four times: the ten-app build, the nine staged and
  fused sweeps, 10^5 trials on a (2, 2) app-trial mesh, a supervised
  sweep and supervised trials that lose a shard and re-mesh, the service
  and ``distributed_kmeans`` over gcc's 120,000 BBVs, each against the
  unsharded engine; both kernels at the new local shapes against their
  plain versions;
* the LM serving path at the full width of ``llama3.2-3b`` and 2 of its 28
  layers (bf16, random weights from a seeded generator): prefill of
  4 x 4096 tokens through the flash-attention kernel and through the
  plain attention route, prefill of 1 x 32768 tokens, the serve loop of
  ``repro_torch.launch.serve`` (each step a replay of one captured decode
  graph), and ``SampledEval`` over 16 eval batches, whose k-means runs
  the two clustering kernels;
* the MoE, hybrid and SSM families (``phase_families``) at full width:
  ``olmoe-1b-7b``, ``recurrentgemma-2b`` and ``rwkv6-7b`` whole,
  ``qwen3-moe-235b-a22b`` on 2 of its 94 layers: prefill through the
  kernel route and, for the MoE models, the plain route, logits compared
  (flash launches on each MoE prefill, never on the hybrid's windowed
  attention or the SSM, whose routes are one computation), the serve
  loop, the tokens dropped for capacity, and ``SampledEval`` over 16
  batches of the MoE model;
* the trainer (``repro_torch.launch.train``) of every family at full
  width (bf16 weights, float32 moments, 2 AdamW steps of 8 x 1024
  tokens): ``llama3.2-3b`` (28 layers, 2 microbatches) and
  ``seamless-m4t-large-v2`` (24 + 24 layers, 256 source frames a
  sequence) whole, ``recurrentgemma-2b`` on 3 of its 26 layers (one
  super, 4 microbatches), ``olmoe-1b-7b`` on 1 of its 16 and ``rwkv6-7b``
  on 1 of its 32 (whole, the last two's AdamW state would not fit one
  card; all three cut further since the sharded trainer joined; the
  phase fails unless a run accumulates microbatches), with step
  seconds, tokens/s, the model-FLOPs share, peak memory, every parameter
  with a gradient moved (leaves whose bf16 steps round away named) and
  the MoE's pairs dropped for capacity; then for each family at smoke
  size, the CLI's loop (3 steps
  that must descend, a resume from step 1 held to the uninterrupted
  run) and one step on the card against the same step on the CPU. No
  kernel runs there: training takes the reference's attention, and the
  phase fails if ``flash_attention`` launched;
* sharded training (``phase_sharded_train``): ``launch.train`` on meshes
  that name the card many times, bf16 at full width on 2 layers, 2 steps
  each, against the unsharded step's loop from the same weights:
  ``llama3.2-3b`` on the (2, 2) host mesh (8 x 1024) and the (16, 16)
  production mesh (16 x 1024, 256 positions), ``olmoe-1b-7b`` on (2, 2),
  whose ranks must keep, bit for bit, the pairs the unsharded step's
  capacity rule in its routing groups keeps of the experts they chose,
  ``recurrentgemma-2b`` on (2, 2) on 5 layers (one super and the
  two-layer tail) and ``rwkv6-7b`` on (2, 2) (32 of its 64 heads a rank);
  each computes tensor- (and expert-) parallel on ``"model"``
  (``distributed.tp``: the (16, 16) mesh with the query rows and the
  vocabulary over 16 model ranks); step seconds, the bytes gathered and
  reduce-scattered a step on distinct cards and the model axis's
  all-gathers, reduce-scatters and all-reduces, peak memory, bytes a
  position holds, the experts and kept pairs of each model rank; then at
  smoke size in float32 the sharded step of every family against the
  unsharded one ((2, 2) tensor parallel for every family; (1, 1) bit
  for bit) and the (2, 16, 16) multi-pod mesh over 512 entries. No
  kernel may launch there.

The two trainers run first, while ``nvcc`` builds the kernels: they
launch none of them. Any failure raises and exits non-zero.

Output: progress lines, then the card's name and power limit (as
``nvidia-smi`` reports them), one JSON line with each kernel's numbers and,
last, ``{"ok": true, "device": {...}}``. With no CUDA device, or without the
rest of the repository, it prints no result and exits non-zero.
"""

from __future__ import annotations

import dataclasses
import gc
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
PEAK_BF16_FLOPS = 989e12      # dense tensor-core rate

# tolerances of the kernel checks (see CHANGES.md for the reasons)
ASSIGN_TIE_RTOL = 1e-5        # labels may differ only at such near-ties
ASSIGN_D2_RTOL, ASSIGN_D2_ATOL = 1e-5, 1e-6
SEGMENT_RTOL = 1e-5           # relative to the sum of |terms| per segment
MIN_LABEL_AGREEMENT = 0.999   # kernel build vs plain build, per app & fit
# flash attention vs its plain version, as (rtol, atol): float32 differs
# only in the order of the sums; bf16 adds one rounding of the output, at
# most one bf16 unit in the last place, 2^-7 of the value (the atol covers
# outputs near zero, where the float32 sums' own difference shows)
FLASH_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-3, 1e-3)}


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


def time_ms_spread(fn, *, reps: int = 15, iters: int = 20
                   ) -> tuple[float, float, float]:
    """Median, least and most of ``reps`` readings of ``time_ms`` (each
    the mean of ``iters`` calls): for the short kernels whose single
    reading moves from run to run."""
    t = sorted(time_ms(fn, warmup=3 if i == 0 else 1, iters=iters)
               for i in range(reps))
    return t[len(t) // 2], t[0], t[-1]


def device_ms(fn, names, *, iters: int = 10) -> dict:
    """Device milliseconds per call of each kernel whose name holds one of
    ``names`` (``torch.profiler``), over ``iters`` warmed calls of
    ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    # a trace now and then holds no device event at all: trace again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for name in names:
                    if f"::{name}" in e.name:
                        out[name] = out.get(name, 0.0) + \
                            e.time_range.elapsed_us() / 1e3 / iters
        if out:
            break
    return out


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS
          ) -> tuple[float, str]:
    """Least time (ms) for the work and what sets it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def other_order(order: str) -> str:
    """The order a shape's timing is compared with: one chain against
    either interleave, the interleaved chains against one chain."""
    return "four" if order == "chain" else "chain"


def assign_ms_in_order(x, c, order: str) -> tuple[float, float, float]:
    """``kmeans_assign``'s milliseconds (``time_ms_spread``) at ``x (b, n,
    d)``, ``c (b, k, d)`` with its dot product in ``order`` (the wrapper
    takes the reference's order at the shape; this launches through its
    uncounted ``_launch``, for the time of another order). Not a launch
    of any path: the wrapper's count is untouched."""
    from repro_torch.kernels.kmeans_assign import ops
    return time_ms_spread(lambda: ops._launch(x, c, order))


def assign_device_ms(x, c, order: str) -> float:
    """The kernel's own time on the card (``torch.profiler``) in ``order``,
    uncounted as ``assign_ms_in_order``: CUDA events around a launch of a
    few tens of microseconds also read the host's share."""
    from repro_torch.kernels.kmeans_assign import ops
    return device_ms(lambda: ops._launch(x, c, order),
                     ["assign_kernel"]).get("assign_kernel")


def spread(t) -> str:
    return f"{t[0]:.4f} ms (median; {t[1]:.4f}-{t[2]:.4f})"


# ------------------------------------------------------------------ phase 1
def phase_build(backend_mod, also=None) -> None:
    """Build every kernel (one nvcc a source, started together); the
    host meanwhile makes the ten apps' populations and BBVs in a thread
    of their own, beside ``also`` (work that launches no kernel of the
    port) in this one."""
    import threading
    import torch
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = []
    failed = []

    def populations():
        # the ten apps' populations and BBVs, numpy on the host, are the
        # first build's longest step: made while nvcc runs
        from repro_torch.simcpu import (APP_NAMES, get_bbvs,
                                        get_population_bank)
        start = time.perf_counter()
        try:
            for pop in get_population_bank(APP_NAMES).pops:
                get_bbvs(pop)
        except BaseException as e:      # raised again in the caller
            failed.append(e)
        t0.append(time.perf_counter() - start)

    def meanwhile():
        worker = threading.Thread(target=populations)
        worker.start()
        try:
            if also is not None:
                also()
        finally:
            worker.join()
        if failed:
            raise failed[0]

    info = backend_mod.build_all(while_building=meanwhile)
    log(f"populations and BBVs of the ten apps, made meanwhile on the "
        f"host: {t0[0]:.2f} s")
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


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0].split()[0])


def measure_add_latency() -> dict:
    """The card's dependent float32 add latency: a one-warp add chain
    timed by ``clock64``, the SM clock read by ``nvidia-smi`` while the
    chain runs, and the chain's CUDA-event time as a cross-check."""
    import torch
    from repro_torch.kernels.segment_stats import ops

    adds = 1 << 26                       # about 0.1 s at 4 cycles an add
    ops.add_chain_cycles(1 << 16, "cuda")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    cycles = ops.add_chain_cycles(adds, "cuda")
    end.record()
    mhz = sm_clock_mhz()                 # read while the chain runs
    torch.cuda.synchronize()
    per_add = int(cycles.item()) / adds
    event_ns = start.elapsed_time(end) * 1e6 / adds
    ns = per_add / mhz * 1e3
    log(f"float32 add latency: {per_add:.4f} cycles (clock64, one warp, "
        f"{adds} dependent adds) at SM clock {mhz:.0f} MHz (nvidia-smi) = "
        f"{ns:.4f} ns; CUDA events over the chain {event_ns:.4f} ns an add")
    return {"cycles": per_add, "sm_mhz": mhz, "ns": ns, "event_ns": event_ns}


def capture_fit_steps() -> dict:
    """Build all ten apps through ``ExperimentEngine.build`` with a hook on
    the k-means centroid update: the inputs of each fit's last Lloyd step
    (the BBV fit, then the RFV fit) and, for every step, the longest
    chain of one (lane, segment) with all rows and with weight-0 rows
    dropped."""
    import importlib

    import torch
    from repro_torch.experiments import ExperimentEngine
    from repro_torch.simcpu import APP_NAMES

    km = importlib.import_module("repro_torch.core.clustering.kmeans")
    fits: dict[tuple, dict] = {}
    update = km._update_centroids

    def longest(flat, k, b):
        return torch.bincount(flat, minlength=b * k).reshape(b, k).amax(1)

    def hook(x, labels, k, old, w, backend):
        rec = fits.setdefault(tuple(x.shape), {"all": [], "weighted": []})
        b = x.shape[0]
        flat = labels.long() + k * torch.arange(b, device=x.device)[:, None]
        rec["all"].append(longest(flat.reshape(-1), k, b).cpu())
        rec["weighted"].append(longest(flat[w != 0], k, b).cpu())
        rec.update(x=x, labels=labels, k=k, old=old, w=w)
        return update(x, labels, k, old, w, backend)

    km._update_centroids = hook
    t0 = time.perf_counter()
    try:
        ExperimentEngine(device="cuda").build(APP_NAMES)
    finally:
        km._update_centroids = update
    torch.cuda.synchronize()
    log(f"capture build (the process's first, cold): "
        f"{time.perf_counter() - t0:.2f} s")
    if len(fits) != 2:
        raise AssertionError(f"expected the BBV and RFV fits, saw "
                             f"{list(fits)}")
    return dict(zip(("bbv", "rfv"), fits.values()))


def check_main_path_inputs(latency: dict) -> dict:
    """Both clustering kernels on the inputs the simulation build gives
    them: one ``kmeans_assign`` and one ``segment_stats`` launch of each
    fit's last Lloyd step. Each is held bitwise against its plain version
    and timed beside its bounds; ``segment_stats`` with all rows (as the
    update gave them before weight-0 rows were dropped) and with them
    dropped, pass by pass, beside ``index_add_``. The order bound of a
    launch is its longest chain of one (lane, segment) times the add
    latency."""
    import torch
    from repro_torch.kernels.kmeans_assign import ops as assign_ops
    from repro_torch.kernels.segment_stats import ops as seg_ops
    from repro_torch.kernels.segment_stats.ref import segment_stats_ref
    from repro_torch.simcpu import APP_NAMES

    ns_per_add = latency["ns"]
    out = {}
    for tag, rec in capture_fit_steps().items():
        x, labels, k, old, w = (rec[key] for key in
                                ("x", "labels", "k", "old", "w"))
        b, n, d = x.shape
        chains = {v: torch.stack(rec[v]) for v in ("all", "weighted")}
        per_launch = {v: c.amax(1) for v, c in chains.items()}
        log(f"{tag} fit: {len(rec['all'])} centroid updates; longest chain "
            "a launch, all rows / weight-0 rows dropped: median "
            f"{int(per_launch['all'].median())} / "
            f"{int(per_launch['weighted'].median())}, max "
            f"{int(per_launch['all'].max())} / "
            f"{int(per_launch['weighted'].max())}, total over the build "
            f"{int(per_launch['all'].sum())} / "
            f"{int(per_launch['weighted'].sum())}")
        log(f"  {tag} last update, longest chain by app (all / weight-0 "
            "dropped): " + ", ".join(
                f"{name} {int(a)} / {int(c)}" for name, a, c in
                zip(APP_NAMES, chains["all"][-1], chains["weighted"][-1])))
        row = {"updates": len(rec["all"]),
               "chain_total": int(per_launch["weighted"].sum()),
               "chain_total_all_rows": int(per_launch["all"].sum())}

        # kmeans_assign of the last step: the fit's points, the centroids
        # that labelled them
        lab_k, d2_k = assign_ops.kmeans_assign(x, old)
        lab_p, d2_p = assign_ops.kmeans_assign(x, old, backend="plain")
        if not (torch.equal(lab_k, lab_p) and torch.equal(d2_k, d2_p)):
            raise AssertionError(f"kmeans_assign {tag} main-path input: not "
                                 "bitwise equal to the plain version")
        ms_t = time_ms_spread(lambda: assign_ops.kmeans_assign(x, old))
        ms = ms_t[0]
        on_card = device_ms(lambda: assign_ops.kmeans_assign(x, old),
                            ["assign_kernel"]).get("assign_kernel")
        plain_ms = time_ms(lambda: assign_ops.kmeans_assign(
            x, old, backend="plain"), iters=5)
        bound_ms, bound_by = bound(4 * (b * n * d + b * k * d + 2 * b * n),
                                   2.0 * b * n * k * d + 2.0 * b * n * d)
        log(f"kmeans_assign {tag} main-path input (b={b}, n={n}, d={d}, "
            f"k={k}): bitwise equal to plain; kernel {spread(ms_t)} (on "
            f"the card {on_card:.4f} ms), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), bound "
            f"share {bound_ms / ms:.3f}; grid "
            f"{assign_ops.last_dispatch()['grid']}")
        err = float((d2_k - d2_p).abs().max())
        order = assign_ops.last_dispatch()["order"]
        other_t = assign_ms_in_order(x, old, other_order(order))
        other_dev = assign_device_ms(x, old, other_order(order))
        log(f"  kmeans_assign {tag}: the reference's dot order here is "
            f"{order}; in the other order {spread(other_t)} (on the card "
            f"{other_dev:.4f} ms)")
        row["kmeans_assign"] = {"max_abs_err": err, "ms": ms,
                                "ms_range": ms_t[1:],
                                "device_ms": on_card,
                                "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by, "library_ms": None,
                                "order": order,
                                "other_order_ms": other_t[0],
                                "other_order_range": other_t[1:],
                                "other_order_device_ms": other_dev}

        # segment_stats of the last step's centroid update
        vals = torch.cat([x * w[..., None], w[..., None]], dim=-1)
        dv = d + 1
        first = None
        for variant, lab in (("all_rows", labels),
                             ("weighted", torch.where(w != 0, labels, -1))):
            got = seg_ops.segment_stats(vals, lab, k)
            again = seg_ops.segment_stats(vals, lab, k)
            want = segment_stats_ref(vals.cpu(), lab.cpu(), k)
            if not all(torch.equal(g.cpu(), v) and torch.equal(g, a)
                       for g, a, v in zip(got, again, want)):
                raise AssertionError(f"segment_stats {tag} {variant}: not "
                                     "bitwise equal to the plain version on "
                                     "the CPU, or two launches differ")
            err = max(float((g.cpu() - v).abs().max()) if g.numel() else 0.0
                      for g, v in zip(got[:2], want[:2]))
            if first is None:
                first = got
            elif not (torch.equal(got[0], first[0])
                      and torch.equal(got[1], first[1])):
                raise AssertionError(f"segment_stats {tag}: dropping weight-0"
                                     " rows changed the sums")
            ms = time_ms(lambda: seg_ops.segment_stats(vals, lab, k))
            plain_ms = time_ms(lambda: segment_stats_ref(vals, lab, k),
                               iters=5)
            # each pass on its own, on the state a full launch left
            xb, lb = vals.contiguous(), lab.contiguous()
            work = seg_ops._launch(xb, lb, k)[3]
            passes = {}
            # the later passes read what count and scan left, which count
            # and scan rewrite: they go last
            order = [p for p in seg_ops.PASSES if p not in ("count", "scan")]
            for name in order + ["count", "scan"]:
                bit = seg_ops.PASSES[name]
                passes[name] = time_ms(
                    lambda: seg_ops._launch(xb, lb, k, bit, work))
            del work
            on_card = device_ms(lambda: seg_ops.segment_stats(vals, lab, k),
                                CLUSTER_KERNELS)
            valid = lab >= 0
            flat = (torch.where(valid, lab, 0).long()
                    + k * torch.arange(b, device="cuda")[:, None]).reshape(-1)
            wv = torch.where(valid[..., None], vals, 0.0).reshape(b * n, dv)
            acc = torch.zeros((b * k, dv), device="cuda")
            lib_ms = time_ms(lambda: acc.zero_().index_add_(0, flat, wv))
            rows = int(valid.sum())
            bound_ms, bound_by = bound(
                4 * (rows * dv + b * n + 2 * b * k * dv + b * k),
                3.0 * rows * dv + rows)
            chain = int(per_launch["all" if variant == "all_rows"
                                   else "weighted"][-1])
            order_ms = chain * ns_per_add * 1e-6
            log(f"segment_stats {tag} update {variant} (b={b}, n={n}, "
                f"d={dv}, k={k}, {rows} rows read): bitwise equal to plain on "
                f"the CPU; kernel {ms:.4f} ms ("
                + ", ".join(f"{p} {t:.4f}" for p, t in passes.items())
                + " ms alone; on the card: " + ", ".join(
                    f"{p.split('_')[0]} {t:.4f}" for p, t in on_card.items())
                + f" ms), plain {plain_ms:.4f} ms, index_add_ "
                f"{lib_ms:.4f} ms; bytes bound {bound_ms:.4f} ms "
                f"({bound_by}), order bound {order_ms:.4f} ms (longest chain "
                f"{chain}); sum pass / larger bound "
                f"{passes['sum'] / max(bound_ms, order_ms):.3f}")
            row[f"segment_stats_{variant}"] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms, "order_bound_ms": order_ms,
                "longest_chain": chain, "pass_ms": passes,
                "pass_device_ms": on_card}
        out[tag] = row
        del x, labels, old, w, vals, rec
    torch.cuda.empty_cache()
    return out


def flash_bound(b, hq, hkv, sq, skv, d, dtype, causal: bool = True
                ) -> tuple[float, str, float]:
    """Least time (ms) of one attention and what sets it, plus its FLOP:
    4 d FLOP per visible (row, column) pair (q.k and p.v), the pairs of
    end-aligned causal rows, or every pair without ``causal``; each of q,
    k, v read once and o written once. bf16 counts at the tensor-core
    rate, float32 at the float32 FMA rate."""
    import torch
    pairs = sq * (skv - sq + 1) + sq * (sq - 1) // 2 if causal \
        else sq * skv
    flops = 4.0 * b * hq * d * pairs
    size = torch.finfo(dtype).bits // 8
    nbytes = size * (2 * b * hq * sq * d + 2 * b * hkv * skv * d)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    ms, by = bound(nbytes, flops, peak)
    return ms, by, flops


def sass_counts(path) -> dict:
    """HGMMA (wgmma) and UTMALDG (TMA load) instructions in a built
    library, from ``cuobjdump -sass``."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    return {op: sum(op in line for line in sass.splitlines())
            for op in ("HGMMA", "UTMALDG")}


def flash_case(gen, shape, dtype, *, layout: str = "bhsd"):
    """Random q, k, v of a case: contiguous (b, h, s, d) tensors, or
    ``layout="bshd"`` for (b, h, s, d) views of (b, s, h, d) tensors, as
    the LM's projections make them."""
    import torch
    b, hq, hkv, sq, skv, d = shape
    if layout == "bhsd":
        return tuple(torch.randn(s, generator=gen, device="cuda").to(dtype)
                     for s in ((b, hq, sq, d), (b, hkv, skv, d),
                               (b, hkv, skv, d)))
    return tuple(torch.randn((b, s, h, d), generator=gen, device="cuda")
                 .to(dtype).transpose(1, 2)
                 for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))


# the other architectures' prefill attention at 4096 tokens (b, hq, hkv,
# sq, skv, d): the MoE prefills of phase_families and the four other dense
# configs (chameleon-34b and command-r-35b share 64/8)
FAMILY_FLASH = {
    "olmoe-1b-7b": (4, 16, 16, 4096, 4096, 128),
    "qwen3-moe-235b-a22b": (1, 64, 4, 4096, 4096, 128),
    "chameleon-34b, command-r-35b": (1, 64, 8, 4096, 4096, 128),
    "granite-8b": (1, 32, 8, 4096, 4096, 128),
    "internlm2-20b": (1, 48, 8, 4096, 4096, 128),
}


# seamless-m4t-large-v2's attention (16 heads of 64, MHA) over 4 x 4096
# tokens: the encoder's and the cross-attention's bidirectional branch
# (source and target 4096, and 1000 target rows against 4096 source frames
# and the other way round), and the decoder's causal self-attention, as
# (shape, causal)
ENCDEC_FLASH = {
    "seamless encoder": ((4, 16, 16, 4096, 4096, 64), False),
    "seamless cross 1000/4096": ((4, 16, 16, 1000, 4096, 64), False),
    "seamless cross 4096/1000": ((4, 16, 16, 4096, 1000, 64), False),
    "seamless decoder self": ((4, 16, 16, 4096, 4096, 64), True),
}


def check_flash(gen) -> dict:
    """The kernels against their plain version (``flash_attention_ref``)
    at the cases of ``tests/test_kernels.py``, at ragged lengths, appends,
    GQA groups and head widths, and at the LM's shapes (prefill, eval
    forward, the longest sequence the plain version fits), each in float32
    and bf16; the bidirectional branch at ragged shapes with sq below and
    above skv in both types; at the other architectures' prefill shapes
    (``FAMILY_FLASH``) and the enc-dec model's (``ENCDEC_FLASH``, the
    encoder's in float32 too) in bf16; strided (projection-layout) inputs
    against contiguous ones, bitwise; bf16 timings at the LM, family and
    enc-dec shapes beside their bounds and
    ``scaled_dot_product_attention``."""
    import torch
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    counts = sass_counts(backend._target("flash_attention_sm90")[1])
    log(f"flash_attention_sm90 SASS: {counts['HGMMA']} HGMMA, "
        f"{counts['UTMALDG']} UTMALDG instructions")
    if not all(counts.values()):
        raise AssertionError(f"bf16 flash kernel lacks wgmma or TMA: {counts}")

    small = [(1, 4, 2, 256, 256, 64), (2, 8, 4, 300, 300, 32),
             (1, 4, 1, 1, 512, 64), (1, 2, 2, 1, 700, 128),
             (1, 4, 4, 512, 512, 128),               # tests/test_kernels.py
             (1, 3, 1, 7, 1000, 128), (2, 4, 1, 7, 129, 32),  # 7-row appends
             (1, 4, 4, 1, 300, 40),                  # 1-row append, d 40
             (2, 6, 2, 333, 333, 40), (1, 4, 1, 257, 385, 64)]  # ragged
    bidirectional = [(1, 4, 2, 256, 512, 64), (1, 4, 4, 512, 256, 64),
                     (2, 6, 2, 333, 100, 40), (1, 2, 2, 1, 700, 128),
                     (2, 3, 3, 130, 7, 128)]
    main_shape = (4, 24, 8, 4096, 4096, 128)
    timed = {"main": (main_shape, True),
             "eval": ((4, 24, 8, 2048, 2048, 128), True),
             "long": ((1, 1, 1, 32768, 32768, 128), True),
             **{tag: (s, True) for tag, s in FAMILY_FLASH.items()},
             **ENCDEC_FLASH}
    cases = [(s, dt, "bhsd", True) for s in small
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(s, dt, "bhsd", False) for s in bidirectional
              for dt in (torch.float32, torch.bfloat16)]
    cases += [(s, dt, "bshd", causal) for tag, (s, causal) in timed.items()
              for dt in ((torch.bfloat16, torch.float32)
                         if tag in ("main", "eval", "long",
                                    "seamless encoder")
                         else (torch.bfloat16,))]
    out = {}
    for shape, dtype, layout, causal in cases:
        q, k, v = flash_case(gen, shape, dtype, layout=layout)
        got = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if got.shape != q.shape or not got.transpose(1, 2).is_contiguous():
            raise AssertionError(f"flash_attention {shape}: output is not "
                                 "the (b, hq, sq, d) view of a (b, sq, hq, "
                                 "d) tensor")
        if ops.last_dispatch()["causal"] != causal:
            raise AssertionError(f"flash_attention {shape}: launched the "
                                 "other branch")
        want = flash_attention_ref(q, k, v, causal=causal)
        rtol, atol = FLASH_TOL[str(dtype).split(".")[-1]]
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        # the largest error as a share of what the tolerance allows there
        share = float((diff / (atol + rtol * want.float().abs())).max())
        if not bool(torch.isfinite(got).all()) or share > 1.0:
            raise AssertionError(f"flash_attention {shape} {dtype} "
                                 f"causal={causal}: max error {err:.3g}, "
                                 f"{share:.3g} of the tolerance (rtol "
                                 f"{rtol}, atol {atol})")
        line = (f"flash_attention {shape} {str(dtype)[6:]} {layout} "
                f"{'causal' if causal else 'bidirectional'}: max |err| "
                f"{err:.3g}, {share:.3g} of the tolerance (rtol {rtol}, atol "
                f"{atol})")
        tag = next((t for t, (s, c) in timed.items()
                    if s == shape and c == causal), None)
        if tag is not None and dtype == torch.bfloat16:
            ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=causal))
            plain_ms = time_ms(lambda: flash_attention_ref(q, k, v,
                                                           causal=causal),
                               warmup=1, iters=3)
            bound_ms, bound_by, flops = flash_bound(*shape, dtype,
                                                    causal=causal)
            # the yardstick: one PyTorch call for the same function (a
            # causal case has sq == skv, so its top-left causal mask is
            # end-aligned)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
            lib_ms = time_ms(lambda: sdpa(qc, kc, vc, is_causal=causal,
                                          enable_gqa=True))
            line += (f"; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                     f"TFLOP/s), plain {plain_ms:.4f} ms, bound "
                     f"{bound_ms:.4f} ms ({bound_by}), bound share "
                     f"{bound_ms / ms:.4f}, scaled_dot_product_attention "
                     f"{lib_ms:.4f} ms")
            out[tag] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib_ms, "shape": list(shape),
                        "causal": causal}
            del qc, kc, vc
        log(line)
        del q, k, v, got, want, diff
    torch.cuda.empty_cache()

    # the projections' layout read in place gives the bits of contiguous
    # copies, through both entries
    for shape, causal in ((main_shape, True), ((2, 6, 2, 300, 300, 128), True),
                          ((1, 4, 1, 7, 260, 64), True),
                          ((3, 3, 3, 64, 200, 32), True),
                          ((2, 6, 2, 300, 100, 64), False)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = flash_case(gen, shape, dtype, layout="bshd")
            got = ops.flash_attention(q, k, v, causal=causal)
            flat = ops.flash_attention(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal=causal)
            torch.cuda.synchronize()
            if not torch.equal(got, flat):
                raise AssertionError(f"flash_attention {shape} {dtype}: "
                                     "strided views differ from contiguous "
                                     "inputs")
            del q, k, v, got, flat
    log("flash_attention: (b, s, h, d)-layout views equal contiguous inputs "
        "bitwise for both entries at 5 shapes (one bidirectional)")
    torch.cuda.empty_cache()
    out["sass"] = counts
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


def device_kernels(fn, *, cpu: bool = True) -> tuple[dict, float]:
    """Run ``fn`` once under ``torch.profiler``; returns the card's
    ``{kernel name: [launches, ms]}`` and the wall milliseconds of the
    call (profiler on). ``cpu=False`` records the card's activity alone,
    which a trace of many thousand launches needs to stay short."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rec = by_name.setdefault(e.name, [0, 0.0])
            rec[0] += 1
            rec[1] += e.time_range.elapsed_us() / 1e3
    return by_name, wall_ms


def segment_launches_seen(by_name: dict) -> int:
    """``segment_stats`` launches in a profiler trace: every launch runs
    the sum pass once, so one ``sum_kernel`` event each."""
    return sum(n for name, (n, _) in by_name.items()
               if "::sum_kernel" in name)


def trace_names(by_name: dict) -> str:
    """A trace's kernels as ``name x launches``, by name (ROADMAP C.8:
    what a warm replay's trace holds when it lacks its segment_stats
    launch)."""
    return "; ".join(f"{name[:90]} x{n}"
                     for name, (n, _) in sorted(by_name.items())) or "none"


def traced(label: str, fn, top: int = 10, *, cpu: bool = True) -> dict:
    """Run ``fn`` once under ``torch.profiler``: the card's busy time
    against the wall time, and the kernels that fill it. Returns
    ``{kernel name: [launches, ms]}`` (empty if the profiler saw no
    device activity)."""
    by_name, wall_ms = device_kernels(fn, cpu=cpu)
    busy_ms = sum(ms for _, ms in by_name.values())
    if not by_name:
        log(f"traced {label}: {wall_ms:.1f} ms wall; the profiler saw no "
            "device activity, so busy time is not measured")
        return by_name
    log(f"traced {label}: {wall_ms:.1f} ms wall (profiler on), device busy "
        f"{busy_ms:.1f} ms in {sum(n for n, _ in by_name.values())} "
        f"device events, idle share {1 - busy_ms / wall_ms:.3f}")
    for name, (n, ms) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:top]:
        log(f"  {ms:9.2f} ms {n:7d}x  {name[:90]}")
    return by_name


# the clustering kernels' passes, as the profiler names them
CLUSTER_KERNELS = ("count_kernel", "scan_kernel", "scatter_kernel",
                   "order_kernel", "sum_kernel", "assign_kernel")


def trace_build() -> dict:
    """One more (warm) kernel build under the profiler; returns the
    clustering kernels' [launches, ms] by pass."""
    from repro_torch.experiments import ExperimentEngine
    from repro_torch.simcpu import APP_NAMES

    by_name = traced("build",
                     lambda: ExperimentEngine(device="cuda").build(APP_NAMES))
    passes = {p: [0, 0.0] for p in CLUSTER_KERNELS}
    for name, (n, ms) in by_name.items():
        for p in CLUSTER_KERNELS:
            if f"::{p}" in name:
                passes[p][0] += n
                passes[p][1] += ms
    log("traced build, clustering kernels: " + ", ".join(
        f"{p} {ms:.2f} ms ({n})" for p, (n, ms) in passes.items())
        + " (the sum pass before each chain had its own thread: 61.87 ms "
        "in 99 launches)")
    return passes


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


def phase_main_path() -> tuple[dict, object, dict, dict, dict, object]:
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
    log(f"build s: kernels {secs['build']:.2f} (after the capture build), "
        f"plain warm "
        f"{plain_secs['build']:.2f}, kernels warm {warm_secs['build']:.2f}; "
        "sweeps s (plain / kernels warm): " + ", ".join(
            f"{s} {plain_secs['sweep_' + s]:.3f} / "
            f"{warm_secs['sweep_' + s]:.3f}" for s in SCHEMES)
        + "; second kernel build bitwise equal to the first")
    traced_passes = trace_build()
    return launches, engine, secs, traced_passes, tables, plain


# ---------------------------------------------------------------- phase 3b
STRATIFIERS = ("bbv", "rfv", "dg")
POLICIES = ("centroid", "mean", "random")
# the reference's streaming-trials gate: coverage of its one app, 505.mcf_r
# (tests/test_streaming_trials.py); every other app's is printed
MIN_COVERAGE, GATE_APP = 0.90, "505.mcf_r"


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (NaN payloads included)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.contiguous().view(ints[t.element_size()]) for t in (a, b))
    return torch.equal(a, b)


def memo_record(engine) -> dict:
    """The memo's tables and accounting (without its version) and the
    ledgers, as numpy arrays."""
    import numpy as np
    from repro_torch.simcpu import APP_NAMES
    tree, _ = engine.memo.state()
    out = {k: v for k, v in tree.items() if k != "version"}
    out["ledgers"] = np.asarray([e.sim.ledger.regions_simulated
                                 for e in engine.build(APP_NAMES)])
    return out


def fused_vs_staged(engine, plan) -> dict:
    """One fused sweep (cold: eager run + capture), the same sweep again
    (warm: a replay that must capture and charge nothing), then the
    staged sweep from the memo state the fused one started from; all
    equal bit for bit. The warm sweep runs under the profiler, which
    counts the segment_stats launches its replay makes: they must be the
    cold sweep's eager launches, and the wrapper must count none. Returns
    the seconds, the table and those replayed launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.sampling import plan as splan
    from repro_torch.experiments import (SweepSpec, fused,
                                         plan_selection_bank, run_sweep)
    from repro_torch.kernels.segment_stats import ops as segment_ops
    from repro_torch.kernels.segment_stats.ref import segment_stats_ref
    from repro_torch.simcpu import APP_NAMES

    tag = f"{plan.scheme}/{plan.policy_name}"
    spec = SweepSpec(apps=APP_NAMES, plan=plan)
    snap = engine.memo.state()
    captures = fused.program_captures()
    splan._reset_sweep_dispatch()
    n0 = segment_ops.launch_count()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    table = run_sweep(engine, spec)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    above = (torch.cuda.max_memory_allocated() - resident) / 2**30
    marker = splan.last_sweep_dispatch()
    if not (marker["fused"] and marker["count"] == 1 and marker["captured"]
            and fused.program_captures() == captures + 1):
        raise AssertionError(f"fused {tag}: marker {marker}, captures "
                             f"{fused.program_captures() - captures}")
    eager_launches = segment_ops.launch_count() - n0
    out = {k: v.clone() for k, v in engine.fused_outputs.items()}
    after_fused = memo_record(engine)
    charges = engine.memo.total_charges()
    n0 = segment_ops.launch_count()
    for attempt in range(2):
        # a warm replay charges nothing, so a second one (when the
        # profiler's trace held no segment_stats launch: no device event
        # at all, or a trace that dropped it among the others) changes no
        # state; a replay that lacks the launch lacks it again
        warm_run = {}
        by_name, warm_ms = device_kernels(
            lambda: warm_run.update(table=run_sweep(engine, spec)))
        if attempt:                     # ROADMAP C.8: both traces
            log(f"fused {tag}: the second trace's kernels: "
                + trace_names(by_name))
        if segment_launches_seen(by_name):
            break
        if not attempt:
            log(f"fused {tag}: the profiler's trace of the warm replay "
                f"held no segment_stats launch "
                f"({sum(n for n, _ in by_name.values())} device events; "
                f"kernels: {trace_names(by_name)}); replaying once more")
    warm_table, warm = warm_run["table"], warm_ms / 1e3
    replayed = segment_launches_seen(by_name)
    if segment_ops.launch_count() != n0 or replayed != eager_launches \
            or replayed <= 0:
        raise AssertionError(
            f"fused {tag}: the replay made {replayed} segment_stats "
            f"launches (profiler, of {sum(n for n, _ in by_name.values())} "
            f"device events) and the wrapper counted "
            f"{segment_ops.launch_count() - n0}; the eager run made "
            f"{eager_launches}")
    if fused.program_captures() != captures + 1 \
            or engine.memo.total_charges() != charges \
            or not (memo_record(engine)["ledgers"]
                    == after_fused["ledgers"]).all():
        raise AssertionError(f"fused {tag}: the warm sweep captured or "
                             "charged")
    for field in ("estimate", "err_pct"):
        if not np.array_equal(table.column(field),
                              warm_table.column(field)):
            raise AssertionError(f"fused {tag}: replay {field} differs")
    # the kernel inside the graph: the replay's stratum summary against
    # the plain version on the same inputs
    bank = engine.stratum_bank(plan.stratifier, APP_NAMES)
    lab = torch.where(bank.valid, bank.labels,
                      torch.full_like(bank.labels, -1)).int()
    sums, _, counts = segment_stats_ref(bank.baseline.float(), lab,
                                        engine.num_strata)
    replay_out = engine.fused_outputs
    if not (same_bits(replay_out["sums"], sums[..., 0].double())
            and same_bits(replay_out["counts"], counts.double())):
        raise AssertionError(f"fused {tag}: the graph's segment_stats "
                             "differs from its plain version")
    engine.memo.load_state(*snap)
    t0 = time.perf_counter()
    staged = run_sweep(engine, dataclasses.replace(spec, fused=False))
    torch.cuda.synchronize()
    staged_s = time.perf_counter() - t0
    after_staged = memo_record(engine)
    picks, valid, _ = plan_selection_bank(engine.build(APP_NAMES), plan)
    for field in ("estimate", "err_pct", "n_units"):
        if not np.array_equal(table.column(field), staged.column(field)):
            raise AssertionError(f"fused {tag}: {field} differs from staged")
    if not (torch.equal(out["picks"], picks)
            and torch.equal(out["valid"], valid)):
        raise AssertionError(f"fused {tag}: picks differ from staged")
    for key, value in after_fused.items():
        if not np.array_equal(value, after_staged[key]):
            raise AssertionError(f"fused {tag}: memo {key} differs from "
                                 "staged")
    log(f"fused {tag}: cold {cold:.4f} s (eager run + capture), warm "
        f"{warm:.4f} s (replay, profiler on), staged {staged_s:.4f} s; "
        f"segment_stats launches: {eager_launches} eager, {replayed} in "
        f"the replay (profiler); cold peak "
        f"{above:.3f} GiB above the resident state; estimates, "
        f"picks, memo tables, charges, counters and ledgers bitwise equal "
        f"to staged; in-graph segment_stats bitwise equal to plain; "
        f"marker {marker}")
    return {"table": table, "cold": cold, "warm": warm, "staged": staged_s,
            "replayed": replayed}


def paper_rows(main_tables: dict, fused_tables: dict) -> None:
    """Fig 5 (SRS margins) and Figs 10/11 (max error per app, centroid
    and mean selection) from this run's sweeps."""
    srs = main_tables["srs"]
    apps = list(dict.fromkeys(srs.column("app")))
    for app in apps:
        rows = srs.filter(app=app)
        log(f"  fig5 {app}: max err {rows.column('err_pct').max():.3f} %, "
            f"max 95% margin {rows.column('margin_pct').max():.3f} %")
    for fig, policy in (("fig10", "centroid"), ("fig11", "mean")):
        worst = {}
        for scheme in STRATIFIERS:
            table = fused_tables[(scheme, policy)]
            per_app = [table.filter(app=a).column("err_pct").max()
                       for a in apps]
            worst[scheme] = max(per_app)
            log(f"  {fig} {scheme}/{policy} max err per app: " + ", ".join(
                f"{a} {e:.3f}" for a, e in zip(apps, per_app)))
        log(f"  {fig}: worst BBV {worst['bbv']:.3f} %, worst RFV "
            f"{worst['rfv']:.3f} %, worst DG {worst['dg']:.3f} %")


def phase_fused_and_trials(engine, main_tables: dict) -> dict:
    """The fused sweeps against the staged ones on the ten-app engine of
    the main path, the paper rows, and the streaming trials. Returns the
    launches of segment_stats in the phase: the wrapper's count (eager
    launches) plus the launches inside graph replays, which the wrapper
    does not make, as the profiler saw them in a trace of every replay
    that holds the kernel."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.sampling.plan import SamplingPlan
    from repro_torch.experiments import (SweepSpec, TrialSpec, fused,
                                         montecarlo, run_sweep, run_trials)
    from repro_torch.kernels.segment_stats import ops as segment_ops
    from repro_torch.simcpu import APP_NAMES

    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    segment_ops.reset_launch_count()
    fused_tables, replayed = {}, 0
    for scheme in STRATIFIERS:
        for policy in POLICIES:
            rec = fused_vs_staged(engine,
                                  SamplingPlan.from_strings(scheme, policy))
            fused_tables[(scheme, policy)] = rec["table"]
            replayed += rec["replayed"]
    log(f"fused sweeps: {fused.program_captures()} graphs captured, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"segment_stats launches {segment_ops.launch_count()} by the "
        f"wrapper (eager fused and staged sweeps), {replayed} in replays "
        "(profiler)")
    traced_spec = SweepSpec(apps=APP_NAMES,
                            plan=SamplingPlan.from_strings("rfv", "centroid"))
    replayed += segment_launches_seen(traced(
        "fused sweep rfv/centroid (warm replay)",
        lambda: run_sweep(engine, traced_spec)))
    traced("staged sweep rfv/centroid",
           lambda: run_sweep(engine, dataclasses.replace(traced_spec,
                                                         fused=False)))
    paper_rows(main_tables, fused_tables)

    # Fig 8: the paper's 1000 trials of all four schemes, kept
    t0 = time.perf_counter()
    fig8 = run_trials(engine, TrialSpec(trials=1000), apps=APP_NAMES)
    torch.cuda.synchronize()
    fig8_s = time.perf_counter() - t0
    for scheme in fig8.spec.schemes:
        p95 = fig8.p95(scheme)
        log(f"  fig8 {scheme}: mean coverage "
            f"{np.mean(fig8.coverage[scheme]):.4f}; p95 |err| % " + ", ".join(
                f"{a} {v:.3f}" for a, v in zip(APP_NAMES, p95)))
        if not np.isfinite(fig8.estimates[scheme]).all():
            raise AssertionError(f"fig8 {scheme}: non-finite estimates")
    # chunking must not change a bit
    chunked = run_trials(engine, TrialSpec(trials=1000, chunk_size=256),
                         apps=APP_NAMES)
    for scheme in fig8.spec.schemes:
        for a, b in zip(fig8.stats[scheme].leaves(),
                        chunked.stats[scheme].leaves()):
            if not same_bits(a, b):
                raise AssertionError(f"trials {scheme}: chunked stats differ")
        for field in ("estimates", "errors", "half_widths"):
            if not np.array_equal(getattr(fig8, field)[scheme],
                                  getattr(chunked, field)[scheme],
                                  equal_nan=True):
                raise AssertionError(f"trials {scheme}: chunked {field} "
                                     "differ")
    log(f"fig8 run: {fig8_s:.3f} s for 1000 trials x 4 schemes x "
        f"{len(APP_NAMES)} apps; chunk_size=256 equal bit for bit in every "
        "TrialStats leaf and kept array")

    streamed = {}
    for trials in (100_000, 1_000_000):
        spec = TrialSpec(trials=trials, schemes=("random", "rfv"))
        captures = montecarlo.program_captures()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run_trials(engine, spec, apps=APP_NAMES)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for scheme in spec.schemes:
            st = res.stats[scheme]
            cov = res.coverage[scheme]
            if not (st.count == trials).all():
                raise AssertionError(f"{trials} trials {scheme}: count "
                                     f"{st.count.tolist()}")
            gate = cov[APP_NAMES.index(GATE_APP)]
            if not gate >= MIN_COVERAGE:
                raise AssertionError(f"{trials} trials {scheme}: coverage "
                                     f"{gate} of {GATE_APP} below "
                                     f"{MIN_COVERAGE}")
            log(f"  {trials} trials {scheme}: coverage {GATE_APP} "
                f"{gate:.5f} (gate {MIN_COVERAGE}); by app " + ", ".join(
                    f"{a} {c:.5f}" for a, c in zip(APP_NAMES, cov))
                + f"; p95 |err| % max {np.max(res.p95(scheme)):.3f}")
        streamed[trials] = secs
        log(f"streamed {trials} trials x 2 schemes x {len(APP_NAMES)} apps:"
            f" {secs:.3f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"{montecarlo.program_captures() - captures} graphs captured")
    traced("100000 trials x 2 schemes (warm: graph replays)",
           lambda: run_trials(engine, TrialSpec(trials=100_000,
                                                schemes=("random", "rfv")),
                              apps=APP_NAMES))
    wrapper = segment_ops.launch_count()
    log(f"fused sweeps and trials phase: {time.perf_counter() - phase_t0:.1f}"
        f" s; segment_stats launches {wrapper + replayed}: {wrapper} by the "
        f"wrapper, {replayed} inside graph replays (profiler)")
    return {"segment_stats": wrapper + replayed}


# ---------------------------------------------------------------- phase 3c
FLOW_N_PER_STRATUM = 8          # ci_check units per stratum


def _sync(engine) -> None:
    import torch
    if engine.device.type == "cuda":
        torch.cuda.synchronize()


def run_flows(engine, apps=None) -> dict:
    """``TwoPhaseFlow`` on each of the ten apps at Table II's phase-1
    size, through the engine's memo: RFV, BBV and Dalenius-Gurney strata,
    four selection policies, point estimates on configs 0-6, the
    collapsed CI on config 6 and a ``ci_check`` of 8 units a stratum.
    Every estimate must be finite; prints each step's seconds and ledger
    charges."""
    import numpy as np
    from repro_torch.core.sampling import (BBVClusters, Centroid,
                                           DaleniusGurney, RandomUnit,
                                           RankedSetUnit, RFVClusters,
                                           StratumMean, TwoPhaseFlow)
    from repro_torch.simcpu import APP_NAMES, APP_SPECS

    policies = {"centroid": Centroid(), "mean": StratumMean(),
                "random": RandomUnit(), "ranked_set": RankedSetUnit()}
    n1_of = {s.name: s.phase1_n for s in APP_SPECS}
    steps = {}
    out = {}

    def step(name, fn):
        c0, t0 = engine.memo.total_charges(), time.perf_counter()
        res = fn()
        _sync(engine)
        rec = steps.setdefault(name, [0.0, 0])
        rec[0] += time.perf_counter() - t0
        rec[1] += engine.memo.total_charges() - c0
        return res

    for app in apps or APP_NAMES:
        exp = engine.build((app,))[0]
        sim, cfgs = exp.sim, engine.configs
        flow = TwoPhaseFlow(population_size=sim.pop.n_regions,
                            rng=np.random.default_rng(11),
                            device=engine.device)
        idx1, y0, rfv, est1 = step("characterize", lambda: flow.characterize(
            lambda i: sim.simulate_rfv(i, cfgs[0]), n1_of[app]))
        feats = {"rfv": rfv, "bbv": exp.bbv_feats[idx1], "dg": None}
        schemes = {"rfv": RFVClusters(num_strata=20),
                   "bbv": BBVClusters(num_strata=20),
                   "dg": DaleniusGurney(num_strata=20)}
        rec = {"phase1_margin_pct": est1.margin_pct}
        for scheme, strat_obj in schemes.items():
            strat = step(f"stratify {scheme}", lambda: flow.stratify(
                idx1, y0, feats[scheme], scheme=strat_obj))
            for pname, policy in policies.items():
                sel = step("select", lambda: flow.select(strat, policy=policy,
                                                        seed=5))
                ests = step("point_estimate", lambda: [
                    flow.point_estimate(
                        strat, sel, lambda i, c=c: sim.simulate_cpi(i, c))
                    for c in cfgs])
                if not np.isfinite(ests).all():
                    raise AssertionError(f"flow {app} {scheme}/{pname}: "
                                         f"estimates {ests}")
                truth = exp.truth.cpu().numpy()
                rec[f"{scheme}/{pname}_maxerr_pct"] = float(
                    np.max(np.abs(np.asarray(ests) - truth) / truth) * 100)
            sel = flow.select(strat, policy=policies["random"], seed=5)
            ci = step("collapsed_ci", lambda: flow.collapsed_ci(
                strat, sel, lambda i: sim.simulate_cpi(i, cfgs[6])))
            check = step("ci_check", lambda: flow.ci_check(
                strat, lambda i: sim.simulate_cpi(i, cfgs[6]),
                per_stratum_sizes=np.full(20, FLOW_N_PER_STRATUM)))
            for tag, est in (("collapsed", ci), ("ci_check", check)):
                if not (np.isfinite(est.mean) and np.isfinite(est.margin)):
                    raise AssertionError(f"flow {app} {scheme} {tag}: {est}")
                rec[f"{scheme}/{tag}_margin_pct"] = est.margin_pct
                rec[f"{scheme}/{tag}_covers"] = est.covers(
                    float(exp.truth[6]))
        out[app] = rec
        log(f"  flow {app}: n1 {n1_of[app]}, phase-1 margin "
            f"{est1.margin_pct:.3f} %; max err % over configs 0-6 "
            + ", ".join(f"{k.split('_maxerr')[0]} {v:.3f}"
                        for k, v in rec.items() if "maxerr" in k)
            + "; collapsed / ci_check margin % " + ", ".join(
                f"{s} {rec[s + '/collapsed_margin_pct']:.2f} / "
                f"{rec[s + '/ci_check_margin_pct']:.2f}" for s in schemes))
    log("flow steps over ten apps (seconds, ledger charges): " + ", ".join(
        f"{k} {v[0]:.3f} s / {v[1]}" for k, v in steps.items()))
    return {"steps": steps, "apps": out}


# (b, n, k, d) of one shape in each of the reference's three dot orders,
# keyed "<order>_<width>_k<k>" (core.ordered.reference_dot_order)
ORDER_SHAPES = {"four_rfv_k20": (1, 6861, 20, 38),
                "chain_rfv_k50": (1, 6861, 50, 38),
                "swapped_rfv_k40": (1, 6861, 40, 38),
                "swapped_bbv_k28": (1, 120000, 28, 15)}


def check_new_shapes(engine, record: dict) -> dict:
    """Both clustering kernels bitwise against their plain versions at the
    figure path's new shapes, on its own inputs: gcc's 120,000 projected
    BBVs against the k = 50 fit's centroids, and the largest phase-1 RFV
    sample (523.xalancbmk_r, n1 = 6861, d = 38) against the Fig 12/13
    k = 500 fit's; the update's weighted sums for the labels that gives;
    ``kmeans_assign`` at one shape of each dot order (``ORDER_SHAPES``).
    Each timed with CUDA events beside its bytes bound (and index_add_
    for segment_stats)."""
    import torch
    from repro_torch.kernels.kmeans_assign import ops as assign_ops
    from repro_torch.kernels.segment_stats import ops as segment_ops
    from repro_torch.kernels.segment_stats.ref import segment_stats_ref

    cases = {"gcc_k50": record["gcc/502.gcc_r/50"],
             "fig12_k500": record["fig12/523.xalancbmk_r/500"]}
    out = {"kmeans_assign": {}, "segment_stats": {}}
    n_launch = (assign_ops.launch_count(), segment_ops.launch_count())
    for tag, fit in cases.items():
        x = fit["z"].float().contiguous()[None]
        c = fit["centroids"].float().contiguous()[None]
        b, n, d = x.shape
        k = c.shape[1]
        lab_k, d2_k = assign_ops.kmeans_assign(x, c)
        lab_p, d2_p = assign_ops.kmeans_assign(x, c, backend="plain")
        if not (torch.equal(lab_k, lab_p) and same_bits(d2_k, d2_p)):
            raise AssertionError(
                f"kmeans_assign {tag}: {int((lab_k != lab_p).sum())} labels,"
                f" {int((d2_k != d2_p).sum())} distances differ from plain")
        ms_t = time_ms_spread(lambda: assign_ops.kmeans_assign(x, c))
        ms = ms_t[0]
        plain_ms = time_ms(lambda: assign_ops.kmeans_assign(
            x, c, backend="plain"), iters=3)
        bound_ms, bound_by = bound(4 * (b * n * d + b * k * d + 2 * b * n),
                                   2.0 * b * n * k * d + 2.0 * b * n * d)
        order = assign_ops.last_dispatch()["order"]
        other_t = assign_ms_in_order(x, c, other_order(order))
        dev = assign_device_ms(x, c, order)
        other_dev = assign_device_ms(x, c, other_order(order))
        out["kmeans_assign"][tag] = {
            "max_abs_err": 0.0, "ms": ms, "ms_range": ms_t[1:],
            "device_ms": dev, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": [b, n, k, d], "order": order,
            "other_order_ms": other_t[0], "other_order_range": other_t[1:],
            "other_order_device_ms": other_dev}
        log(f"kmeans_assign {tag} (b={b}, n={n}, d={d}, k={k}): labels and "
            f"distances bitwise equal to plain; kernel {spread(ms_t)} in the "
            f"reference's order here ({order}; {spread(other_t)} in the "
            f"other; on the card {dev:.4f} and {other_dev:.4f} ms), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), bound share {bound_ms / ms:.3f}")
        # the centroid update of that step: [x, 1] summed by label
        vals = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
        lab = lab_k.int()
        s_k, q_k, c_k = segment_ops.segment_stats(vals, lab, k)
        s_p, q_p, c_p = segment_stats_ref(vals, lab, k)
        if not all(same_bits(g, w) for g, w in
                   ((s_k, s_p), (q_k, q_p), (c_k, c_p))):
            raise AssertionError(f"segment_stats {tag}: differs from plain")
        ms = time_ms(lambda: segment_ops.segment_stats(vals, lab, k))
        plain_ms = time_ms(lambda: segment_stats_ref(vals, lab, k), iters=3)
        flat = lab.long().reshape(-1)
        w = vals.reshape(b * n, d + 1)
        acc = torch.zeros((b * k, d + 1), device="cuda")
        lib_ms = time_ms(lambda: acc.zero_().index_add_(0, flat, w))
        bound_ms, bound_by = bound(
            4 * (b * n * (d + 1) + b * n + 2 * b * k * (d + 1) + b * k),
            3.0 * b * n * (d + 1) + b * n)
        out["segment_stats"][tag] = {
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "shape": [b, n, k, d + 1]}
        log(f"segment_stats {tag} (b={b}, n={n}, d={d + 1}, k={k}): bitwise "
            f"equal to plain; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"index_add_ {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), bound share {bound_ms / ms:.3f}")
    # one shape of each dot order on random points: the RFV width at the
    # engine's k = 20 (four chains, which are two at d = 38), k = 50 (one
    # chain) and k = 40 (the swapped order: four chains at d = 38), and
    # the BBV width at k = 28 (swapped: two chains at d = 15)
    for tag, (b, n, k, d) in ORDER_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(n + k + d)
        x = torch.randn((b, n, d), generator=gen, device="cuda")
        c = torch.randn((b, k, d), generator=gen, device="cuda")
        lab_k, d2_k = assign_ops.kmeans_assign(x, c)
        order = assign_ops.last_dispatch()["order"]
        lab_p, d2_p = assign_ops.kmeans_assign(x, c, backend="plain")
        if order != tag.split("_")[0] or not (
                torch.equal(lab_k, lab_p) and same_bits(d2_k, d2_p)):
            raise AssertionError(
                f"kmeans_assign {tag} ({order}): {int((lab_k != lab_p).sum())}"
                f" labels, {int((d2_k != d2_p).sum())} distances differ from "
                "plain")
        ms_t = time_ms_spread(lambda: assign_ops.kmeans_assign(x, c))
        plain_ms = time_ms(lambda: assign_ops.kmeans_assign(
            x, c, backend="plain"), iters=3)
        dev = assign_device_ms(x, c, order)
        bound_ms, bound_by = bound(4 * (b * n * d + b * k * d + 2 * b * n),
                                   2.0 * b * n * k * d + 2.0 * b * n * d)
        out["kmeans_assign"][tag] = {
            "max_abs_err": 0.0, "ms": ms_t[0], "ms_range": ms_t[1:],
            "device_ms": dev, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "shape": [b, n, k, d], "order": order}
        log(f"kmeans_assign {tag} (b={b}, n={n}, d={d}, k={k}): the "
            f"reference's order here is {order}; bitwise equal to plain; "
            f"kernel {spread(ms_t)} (on the card {dev:.4f} ms), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), bound "
            f"share {bound_ms / ms_t[0]:.3f}")
        del x, c, lab_k, d2_k, lab_p, d2_p
    # these launches hold the kernels against plain: they are not the path's
    assign_ops._launches, segment_ops._launches = n_launch
    return out


def fig12_breakdown(engine, app: str = "523.xalancbmk_r") -> dict:
    """Where Fig 12/13's seconds go for one app at k = 500 (the largest
    phase-1 sample): the k-means++ seeding alone (500 sequential draws),
    the whole fit, the centroid picks (a host loop over 500 strata) and
    the 500 one-region memo reads of the figure."""
    from repro_torch import prng
    from repro_torch.core.clustering import kmeans
    from repro_torch.core.clustering.kmeans import _kmeanspp_init
    from repro_torch.core.sampling import select_centroid
    from repro_torch.kernels.kmeans_assign import ops as assign_ops
    from repro_torch.kernels.segment_stats import ops as segment_ops

    n_launch = (assign_ops.launch_count(), segment_ops.launch_count())
    exp = engine.app(app)
    k = min(500, exp.idx1.numel() // 2)
    secs = {}

    def timed(name, fn):
        _sync(engine)
        t0 = time.perf_counter()
        out = fn()
        _sync(engine)
        secs[name] = time.perf_counter() - t0
        return out

    timed("seeding", lambda: _kmeanspp_init(
        prng.PRNGKey(0, device=engine.device)[None],
        exp.rfv_z.float()[None], k, None))
    km = timed("whole fit", lambda: kmeans(exp.rfv_z, k, seed=0))
    local = timed("centroid picks", lambda: select_centroid(
        km.labels, exp.rfv_z, km.centroids))
    timed("memo reads", lambda: [float(exp.cpi(0, exp.idx1[lo])[0])
                                 for lo in local if lo.numel()])
    log(f"Fig 12/13 at k = {k} on {app}: " + ", ".join(
        f"{name} {s:.3f} s" for name, s in secs.items())
        + f" ({km.iterations} Lloyd steps)")
    assign_ops._launches, segment_ops._launches = n_launch
    return secs


# figures the plain-route twin leaves out, to keep the smoke in its time
# budget: Fig 12/13 (bench_distribution_approx) is the slowest, host-bound
# (memo reads, per-stratum loops), and its k = 500 fits are held bitwise
# kernel against plain by check_new_shapes; the ISA-feature and
# approximate-phase-1 benches (out since the enc-dec phase joined) are the
# next two, k = 20 fits over phase-1 samples. Their kernel-route numbers,
# and every one of their fits' labels, are still held against the
# reference's
PLAIN_SKIPS = ("bench_distribution_approx", "bench_isa_features",
               "bench_approx_phase1")


def phase_flow_and_figures(engine, plain) -> tuple[dict, dict]:
    """The paper's two-phase flow on every app, then every paper figure
    and table on the card: through the kernels (on the main path's
    engine), through the plain versions (on its plain-route engine), and
    against the reference's numbers committed in
    ``paper_figs_reference.json``. Returns this path's kernel launches and
    the kernel rows' entries at its new shapes."""
    import torch
    from repro_torch.experiments import paper_figs as pf
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.kmeans_assign import ops as assign_ops
    from repro_torch.kernels.segment_stats import ops as segment_ops

    phase_t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    for ops in (flash_ops, assign_ops, segment_ops):
        ops.reset_launch_count()
    run_flows(engine)
    flow_launches = (assign_ops.launch_count(), segment_ops.launch_count())
    log(f"flow: {time.perf_counter() - phase_t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"kmeans_assign {flow_launches[0]}, segment_stats "
        f"{flow_launches[1]}")

    figure_s = {}

    def figures(eng, record: dict, route: str, names=pf.FIGURES) -> dict:
        out = {}
        for name in names:
            t0 = time.perf_counter()
            out[name] = pf.run_figure(eng, name, record=record)
            _sync(eng)
            figure_s.setdefault(name, {})[route] = time.perf_counter() - t0
        return out

    torch.cuda.reset_peak_memory_stats()
    record_k = {}
    t0 = time.perf_counter()
    got = figures(engine, record_k, "kernels")
    figs_s = time.perf_counter() - t0
    launches = {"kmeans_assign": assign_ops.launch_count(),
                "segment_stats": segment_ops.launch_count(),
                "flash_attention": flash_ops.launch_count()}
    log(f"figures through the kernels: {figs_s:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; path "
        f"launches {launches}")
    for name in ("kmeans_assign", "segment_stats"):
        if launches[name] <= 0:
            raise AssertionError(f"flow and figures never launched {name}")
    sel_k = pf.selection_record(engine)

    # the same figures through the plain versions, on the plain engine,
    # but for PLAIN_SKIPS (see there)
    record_p = {}
    t0 = time.perf_counter()
    got_p = figures(plain, record_p, "plain",
                    [n for n in pf.FIGURES if n not in PLAIN_SKIPS])
    log(f"figures through the plain versions: "
        f"{time.perf_counter() - t0:.1f} s")
    for name, secs in figure_s.items():
        log(f"  {name}: kernels {secs['kernels']:.3f} s, plain "
            + (f"{secs['plain']:.3f} s" if "plain" in secs else
               "not run (PLAIN_SKIPS)"))
    if pf.selection_record(plain) != sel_k:
        raise AssertionError("kernel and plain engines pick differently")
    ties = 0
    for key, other in record_p.items():
        fit = record_k[key]
        if not torch.equal(fit["labels"], other["labels"]):
            raise AssertionError(f"{key}: kernel and plain fit labels "
                                 "differ")
        differing, near = pf.pick_ties(fit, other["picks"])
        if differing != near:
            raise AssertionError(f"{key}: {differing - near} picks differ "
                                 "away from near-ties")
        ties += near
    diffs = pf.compare(got, got_p)
    explained = [d for d in diffs
                 if pf.explain(d, record_k, pf.fit_summary(record_p))]
    if len(explained) != len(diffs):
        raise AssertionError(f"kernel vs plain figures differ: "
                             f"{[d for d in diffs if d not in explained]}")
    log(f"figures, kernels vs plain versions on the card: labels, picks, "
        f"Table IV sizes and the Fig 7/9 counts equal, floats within rtol "
        f"{pf.RTOL}; {ties} near-tie pick exceptions, {len(diffs)} figure "
        "numbers resting on them")

    hold_against_reference(got, record_k, sel_k, pf.load_reference())
    fig12_breakdown(engine)
    new_shapes = check_new_shapes(engine, record_k)
    log(f"flow and figures phase: {time.perf_counter() - phase_t0:.1f} s")
    return {"kmeans_assign": launches["kmeans_assign"],
            "segment_stats": launches["segment_stats"]}, new_shapes


def hold_against_reference(got: dict, record: dict, selection: dict,
                           ref: dict) -> None:
    """The card's figure numbers against the reference's: integers
    exactly, floats as ``paper_figs.compare`` holds them. The engine's
    picks must agree for every app, and every figure fit of the card's
    own must give the reference's labels (the clustering kernels take the
    reference's dot order at each fit's shape, ``core.ordered``). Picks
    may differ only at near-ties. Every difference is printed with its
    app and both values, and one that no near-tie explains fails."""
    from repro_torch.experiments import paper_figs as pf

    picks_agree = {app: selection.get(app) == want
                   for app, want in ref["selection"].items()}
    if not all(picks_agree.values()):
        apart = [a for a, ok in picks_agree.items() if not ok]
        raise AssertionError(f"engine picks differ from the reference's "
                             f"in {apart}")
    fits_k = pf.fit_summary(record)
    parted = sorted(k for k, w in ref["fits"].items()
                    if fits_k[k]["labels"] != w["labels"])
    if parted:
        raise AssertionError(f"figure fits whose labels part from the "
                             f"reference's: {parted}")
    fit_ties = {k: pf.pick_ties(record[k], w["picks"])
                for k, w in ref["fits"].items()}
    log(f"against the reference: engine picks agree for all "
        f"{len(picks_agree)} apps; all {len(fit_ties)} figure fits give "
        "the reference's labels; picks at near-ties by fit: "
        + ", ".join(f"{k} {n}" for k, (_, n) in fit_ties.items() if n))
    for k, (differing, near) in fit_ties.items():
        if differing != near:
            raise AssertionError(f"{k}: labels agree with the reference "
                                 f"but {differing - near} picks differ "
                                 "away from near-ties")
    diffs = pf.compare(got, ref["figures"], near_ties=ref["fig8_near_ties"])
    failed = []
    for d in diffs:
        why = pf.explain(d, record, ref["fits"], ref["gcc_app"])
        log(f"  differs from the reference: {d['figure']} {d['path']} "
            f"(app {d['app']}): card {d['got']!r}, reference "
            f"{d['want']!r}; {why or 'no near-tie pick explains it'}")
        if why is None:
            failed.append(d)
    if failed:
        raise AssertionError(f"{len(failed)} figure numbers differ from "
                             "the reference with no near-tie to explain "
                             "them")
    log(f"figures against the reference: {len(diffs)} of "
        f"{len(list(pf._leaves(ref['figures'])))} numbers differ, each "
        "where a fit of the figure's own picked at near-ties")


# ---------------------------------------------------------------- phase 3d
# the fleet and service phase's blocking: 2 app blocks x 2 config blocks
# (4 + 3 configs) a sweep, 4 segments x 2 schemes for the trials; every
# checkpoint holds the (10, 7, 120000) memo mask and CPI, about 42 MB
FLEET_APP_BLOCK, FLEET_CONFIG_BLOCK = 5, 4
FLEET_SEED = 17
FLEET_TRIALS, FLEET_SEGMENT = 100_000, 25_000
SERVICE_REQUESTS, SERVICE_TICK, SERVICE_CAP = 64, 16, 4


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*")
               if f.is_file())


def memo_by_config(engine) -> dict:
    """The engine's memo snapshot (``state()``, which restores spilled
    columns first) with its config columns in ``engine.configs`` order,
    ``version`` left out (restarts legally repeat table writes)."""
    tree, meta = engine.memo.state()
    order = [meta["configs"].index(repr(c)) for c in engine.configs]
    out = {k: v for k, v in tree.items() if k != "version"}
    out["mask"], out["cpi"] = tree["mask"][:, order], tree["cpi"][:, order]
    out["charges"] = tree["charges"][:, order]
    return out


def same_memo(a: dict, b: dict, what: str, keys=None) -> None:
    import numpy as np
    for k in keys or a:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{what}: memo {k} differs")


def same_rows(got, want, what: str, fields=("estimate", "err_pct",
                                             "n_units")) -> None:
    import numpy as np
    if len(got.rows) != len(want.rows):
        raise AssertionError(f"{what}: {len(got.rows)} rows against "
                             f"{len(want.rows)}")
    for f in fields:
        a = np.asarray(got.column(f), np.float64)
        b = np.asarray(want.column(f), np.float64)
        if a.tobytes() != b.tobytes():
            raise AssertionError(f"{what}: {f} differs")


def same_trials(got, want, what: str, *, floats: bool) -> None:
    """Every ``TrialStats`` leaf (the float moments only when ``floats``)
    and every kept per-trial array, bit for bit."""
    for s in want.spec.schemes:
        for i, (a, b) in enumerate(zip(got.stats[s].leaves(),
                                       want.stats[s].leaves())):
            if (floats or not a.dtype.is_floating_point) \
                    and not same_bits(a, b):
                raise AssertionError(f"{what} {s}: TrialStats leaf {i}")
        for field in ("estimates", "errors", "half_widths"):
            if getattr(got, field)[s].tobytes() != \
                    getattr(want, field)[s].tobytes():
                raise AssertionError(f"{what} {s}: {field}")


def covering_faults(seed: int, n_quanta: int):
    """``FaultPlan.random(s, n_quanta, kills=3)`` for the first ``s >=
    seed`` whose three events are one of each kind (a kill before the
    checkpoint, a corrupt mid-write, a kill after it)."""
    from repro_torch.runtime.faults import FAULT_KINDS, FaultPlan
    for s in range(seed, seed + 1000):
        plan = FaultPlan.random(s, n_quanta, kills=3)
        if sorted(e.kind for e in plan.events) == sorted(FAULT_KINDS):
            return plan
    raise AssertionError(f"no seed in [{seed}, {seed + 1000}) draws all "
                         f"three fault kinds over {n_quanta} quanta")


def check_faults_fired(report, faults, what: str) -> None:
    """Every planned fault fired, in order, each costing one restart."""
    import re
    fired = [re.match(r"injected (\w+) scheduled at quantum (\d+)",
                      a.get("error", "")) for a in report.attempts[:-1]]
    fired = [(m.group(1), int(m.group(2))) for m in fired if m]
    planned = [(e.kind, e.quantum) for e in faults.events]
    if report.restarts != len(planned) or fired != planned:
        raise AssertionError(f"{what}: {report.restarts} restarts, faults "
                             f"fired {fired}, planned {planned}")


def phase_fleet_and_service(plain) -> dict:
    """The fault-tolerant fleet drivers and the sweep service on all ten
    apps at their real sizes and all 7 configs, through the kernels:

    * ``supervise_sweep`` of rfv and dg with ``Centroid`` under
      ``FaultPlan.random(seed, 4 quanta, kills=3)`` (``covering_faults``:
      one fault of each kind; each must fire, costing one restart), the
      first and final attempts of the rfv sweep building a fresh engine
      (the other attempts restart on the first engine, its memo put back
      to the post-build state: the rebuilds are the phase's longest step;
      2 builds since the sharded trainer joined, 4 before), against the
      uninterrupted ``run_sweep_resumable`` of the same blocking (rows,
      memo tables, charges, counters, ledgers bitwise), plain
      ``run_sweep`` (the same, the policies being deterministic) and the
      uninterrupted run through the plain versions (on the plain-route
      engine), bit for bit;
    * ``supervise_trials`` of 10^5 trials of random and rfv in segments
      of 25,000 with 3 faults (one of each kind, quanta counted by the
      driver's own plan), against the uninterrupted resumable run (all
      leaves and per-trial arrays bitwise) and ``run_trials`` (per-trial
      arrays and integer leaves bitwise);
    * ``SweepService`` on a fresh engine serving ``synthetic_stream(64)``
      over the ten apps, 16 a tick, memo cap 4 with spill, against the
      same requests run one by one through ``run_sweep`` and against the
      same service through the plain versions: rows and tables bitwise.

    The uninterrupted and serial runs share one engine (the first
    supervised run's first) whose memo is put back to its post-build
    state before each. Returns each path's kernel launches (the wrappers'
    counts: eager launches, none inside graph replays): fault_tolerance
    adds up the supervised runs' alone, each counted from 0 just before
    it, and serving is the service's run on the kernel route; the
    comparison runs count in neither."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.core.sampling.plan import SamplingPlan
    from repro_torch.experiments import (ExperimentEngine, SweepSpec,
                                         TrialSpec, resumable, run_sweep,
                                         run_sweep_resumable, run_trials,
                                         run_trials_resumable,
                                         supervise_sweep, supervise_trials)
    from repro_torch.kernels.kmeans_assign import ops as assign_ops
    from repro_torch.kernels.segment_stats import ops as segment_ops
    from repro_torch.serving import SweepService, batcher
    from repro_torch.serving.cli import synthetic_stream
    from repro_torch.simcpu import APP_NAMES, CONFIGS

    phase_t0 = time.perf_counter()
    root = ROOT / "build" / "fleet"
    shutil.rmtree(root, ignore_errors=True)
    writes = []

    def timed_save(directory, step, tree, **kw):
        t0 = time.perf_counter()
        path = save_checkpoint(directory, step, tree, **kw)
        writes.append((_dir_bytes(path), time.perf_counter() - t0))
        return path

    save_checkpoint = resumable.save_checkpoint
    resumable.save_checkpoint = timed_save
    builds = []

    def fresh():
        t0 = time.perf_counter()
        eng = ExperimentEngine()
        eng.memo.cols_for(eng.configs)     # config columns in one order
        eng.build(APP_NAMES)
        torch.cuda.synchronize()
        builds.append(time.perf_counter() - t0)
        return eng

    def counts():
        return {"kmeans_assign": assign_ops.launch_count(),
                "segment_stats": segment_ops.launch_count()}

    def zero_counts():
        for ops in (assign_ops, segment_ops):
            ops.reset_launch_count()

    fleet = {"kmeans_assign": 0, "segment_stats": 0}
    try:
        torch.cuda.reset_peak_memory_stats()
        # the first attempt's memo just after its build is every run's
        # start; the first supervised run's last engine then serves the
        # uninterrupted and serial runs, its memo put back to that state
        state0, base = [], None

        def reset(eng):
            eng.memo.load_state(*state0[0], universe=eng.configs)

        blocks = {"app_block": FLEET_APP_BLOCK,
                  "config_block": FLEET_CONFIG_BLOCK}
        n_quanta = (-(-len(APP_NAMES) // FLEET_APP_BLOCK)
                    * -(-len(CONFIGS) // FLEET_CONFIG_BLOCK))
        for i, scheme in enumerate(("rfv", "dg")):
            spec = SweepSpec(apps=APP_NAMES,
                             plan=SamplingPlan.from_strings(scheme,
                                                            "centroid"))
            faults = covering_faults(FLEET_SEED + 10 * i, n_quanta)
            last, starts, w0 = [], [], len(writes)

            def make(mesh):
                nonlocal base
                starts.append(time.perf_counter())
                # the rfv sweep's first and final attempts build afresh
                if base is None or (i == 0 and
                                    len(starts) > len(faults.events)):
                    last[:] = [fresh()]
                    if base is None:
                        base = last[0]
                        state0.append(base.memo.state())
                else:
                    # the other attempts restart on the first engine, its
                    # memo put back to the post-build state
                    reset(base)
                    last[:] = [base]
                return last[0]

            zero_counts()
            got, report = supervise_sweep(make, spec, root / f"s_{scheme}",
                                          faults=faults, **blocks)
            starts.append(time.perf_counter())
            n1 = counts()
            for name in fleet:
                fleet[name] += n1[name]
            check_faults_fired(report, faults, f"supervised {scheme}")
            final = memo_by_config(last[0])
            del last[:]
            gc.collect()
            reset(base)
            want = run_sweep_resumable(base, spec, root / f"u_{scheme}",
                                       **blocks)
            same_rows(got, want, f"supervised {scheme} vs uninterrupted")
            same_memo(final, memo_by_config(base),
                      f"supervised {scheme} vs uninterrupted")
            reset(base)
            same_rows(got, run_sweep(base, spec),
                      f"supervised {scheme} vs run_sweep")
            same_memo(final, memo_by_config(base),
                      f"supervised {scheme} vs run_sweep",
                      keys=("mask", "charges", "ledger_regions",
                            "ledger_instr"))
            reset(plain)
            want_p = run_sweep_resumable(plain, spec,
                                         root / f"p_{scheme}", **blocks)
            same_rows(got, want_p, f"supervised {scheme} vs plain route")
            same_memo(final, memo_by_config(plain),
                      f"supervised {scheme} vs plain route")
            ws = writes[w0:]
            log(f"supervised sweep {scheme}/centroid, {len(APP_NAMES)} apps "
                f"x {len(CONFIGS)} configs in {n_quanta} quanta, "
                f"faults {[(e.kind, e.quantum) for e in faults.events]}: "
                f"{report.restarts} restarts, {len(report.quanta)} quanta "
                f"run (s each: " + ", ".join(
                    f"{q['seconds']:.3f}" for q in report.quanta)
                + "); attempts (s, build included): " + ", ".join(
                    f"{b - a:.2f}" for a, b in zip(starts, starts[1:]))
                + f"; {len(ws)} checkpoints written here (and the "
                f"uninterrupted runs'), {ws[0][0] / 1e6:.1f} MB each, "
                f"write {np.mean([w[1] for w in ws]):.3f} s mean, "
                f"{max(w[1] for w in ws):.3f} s max; launches in the "
                f"supervised run: kmeans_assign {n1['kmeans_assign']}, "
                f"segment_stats {n1['segment_stats']}; equal bit for "
                "bit to the uninterrupted run (kernels and plain versions) "
                "and to run_sweep")

        spec = TrialSpec(trials=FLEET_TRIALS, schemes=("random", "rfv"),
                         keep_trials=True)
        n_quanta = len(resumable._trial_quanta(spec, FLEET_SEGMENT)[3])
        faults = covering_faults(FLEET_SEED + 20, n_quanta)
        last, w0 = [], len(writes)
        tries = []

        def make_t(mesh):
            tries.append(mesh)
            reset(base)
            last[:] = [base]
            return last[0]

        zero_counts()
        t0 = time.perf_counter()
        got, report = supervise_trials(make_t, spec, root / "t",
                                       apps=APP_NAMES, faults=faults,
                                       segment_trials=FLEET_SEGMENT)
        trial_s = time.perf_counter() - t0
        n1 = counts()
        for name in fleet:
            fleet[name] += n1[name]
        check_faults_fired(report, faults, "supervised trials")
        del last[:]
        gc.collect()
        reset(base)
        want = run_trials_resumable(base, spec, root / "tu", apps=APP_NAMES,
                                    segment_trials=FLEET_SEGMENT)
        same_trials(got, want, "supervised trials vs uninterrupted",
                    floats=True)
        reset(base)
        same_trials(got, run_trials(base, spec, apps=APP_NAMES),
                    "supervised trials vs run_trials", floats=False)
        ws = writes[w0:]
        log(f"supervised trials: {FLEET_TRIALS} x random, rfv x "
            f"{len(APP_NAMES)} apps in {n_quanta} quanta, faults "
            f"{[(e.kind, e.quantum) for e in faults.events]}: "
            f"{report.restarts} restarts, {trial_s:.2f} s, "
            f"{len(report.quanta)} quanta run; checkpoints "
            f"{ws[0][0] / 1e6:.1f} MB, write "
            f"{np.mean([w[1] for w in ws]):.3f} s mean; launches "
            f"{n1}; every leaf and "
            "per-trial array equal to the uninterrupted run, per-trial "
            "arrays and integer leaves to run_trials")
        log(f"fault-tolerance path: {len(builds)} engine builds "
            f"({np.mean(builds):.2f} s mean), launches in the supervised "
            f"runs {fleet}, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"{time.perf_counter() - phase_t0:.1f} s")

        # the service on a fresh engine: the build runs in its first tick
        zero_counts()
        serve_t0 = time.perf_counter()
        stream = synthetic_stream(SERVICE_REQUESTS, apps=APP_NAMES)
        captures = batcher.program_captures()

        def serve(engine):
            svc = SweepService(engine, memo_cap=SERVICE_CAP, spill=True)
            ticks = []
            for start in range(0, len(stream), SERVICE_TICK):
                for spec in stream[start:start + SERVICE_TICK]:
                    svc.submit(spec)
                t0 = time.perf_counter()
                svc.tick()
                ticks.append(time.perf_counter() - t0)
            return svc, ticks

        svc_engine = ExperimentEngine()
        svc_engine.memo.cols_for(svc_engine.configs)
        service, ticks = serve(svc_engine)
        torch.cuda.synchronize()
        served = counts()
        serve_s = time.perf_counter() - serve_t0
        st = service.stats()
        served_memo = memo_by_config(svc_engine)
        results = [service.result(i) for i in range(len(stream))]
        reset(base)
        for i, spec in enumerate(stream):
            same_rows(results[i], run_sweep(base, spec),
                      f"service request {i} vs run_sweep")
        same_memo(served_memo, memo_by_config(base),
                  "service vs serial run_sweep")
        reset(plain)
        service_p, _ = serve(plain)
        for i in range(len(stream)):
            same_rows(results[i], service_p.result(i),
                      f"service request {i}, kernels vs plain route")
        same_memo(served_memo, memo_by_config(plain),
                  "service, kernels vs plain route")
        if service_p.stats().dispatches != st.dispatches:
            raise AssertionError("service dispatches differ by route")
        del svc_engine, service, service_p
        log(f"service: {st.completed} requests over {len(APP_NAMES)} apps "
            f"in {st.ticks} ticks of {SERVICE_TICK} (s each, the first "
            "with the engine build: " + ", ".join(f"{t:.2f}" for t in ticks)
            + f"), {st.dispatches} dispatches, {st.coalesced_requests} "
            f"coalesced requests, latency p50 {st.latency_p50_s * 1e3:.1f} "
            f"ms p95 {st.latency_p95_s * 1e3:.1f} ms, "
            f"{st.throughput_rps:.1f} requests/s, cache hit rate "
            f"{st.cache_hit_rate:.4f}, peak resident columns "
            f"{st.peak_resident_cols}, {st.evicted_cols} columns evicted "
            f"(spilled), {batcher.program_captures() - captures} group "
            f"graphs captured (both routes); launches {served}; rows and "
            "tables equal bit for bit to the requests run one by one and "
            f"to the plain route; {serve_s:.1f} s")
    finally:
        resumable.save_checkpoint = save_checkpoint
        shutil.rmtree(root, ignore_errors=True)
    for path, n in (("fault_tolerance", fleet), ("serving", served)):
        for name in ("kmeans_assign", "segment_stats"):
            if n[name] <= 0:
                raise AssertionError(f"{path} never launched {name}")
    log(f"fleet and service phase: {time.perf_counter() - phase_t0:.1f} s")
    return {"fault_tolerance": fleet, "serving": served}


# ------------------------------------------------------------------ phase 3e
MESH_SHARDS = 4
MESH_TRIALS, MESH_SEGMENT = 100_000, 25_000
MESH_SERVICE_REQUESTS = 16
# twelve blocks a chunk: the (2, 2) mesh's two trial shards and the
# re-meshed trials' four and three all divide it
MESH_CHUNK_BLOCKS = 12
DKM_APP, DKM_K, DKM_ITERS = "502.gcc_r", 20, 25
# two whole distributed k-means runs, 4 shards against 1, part at points
# near a boundary: at most this share of labels may differ (the CPU
# tests' readings and planted fault: tests/test_torch_mesh.py)
DKM_LABEL_SHARE = 0.01
BUILD_FIELDS = ("truth", "census_mat", "bbv_labels", "bbv_weights",
                "bbv_feats", "bbv_centroids", "idx1", "cpi0_1", "rfv_z",
                "rfv_labels", "rfv_weights", "rfv_centroids", "dg_labels",
                "dg_weights")


def mesh_local_shapes(base, dkm: dict) -> dict:
    """Both clustering kernels bitwise against their plain versions at the
    mesh path's new local shapes, on the unsharded build's own inputs: one
    shard's lanes (B = 3, 4, 5: 12 padded lanes over 4 shards, 12 over 3,
    10 over the (2, 2) mesh's 2 app rows) of the ten-app stack's last BBV
    and RFV Lloyd steps (the fits' final centroids) and their weighted
    updates, and one distributed k-means shard (30,000 of gcc's BBVs).
    Timed with CUDA events beside the bytes bound, the plain version and,
    for segment_stats, ``index_add_``. These launches are not the path's:
    the counts are put back."""
    import torch
    from repro_torch.distributed.appaxis import pad_app_axis
    from repro_torch.kernels.kmeans_assign import ops as assign_ops
    from repro_torch.kernels.kmeans_assign.ref import dot_order
    from repro_torch.kernels.segment_stats import ops as segment_ops
    from repro_torch.kernels.segment_stats.ref import segment_stats_ref
    from repro_torch.simcpu import APP_NAMES

    exps = base.build(APP_NAMES)
    dev = base.device
    n_max = max(e.bbv_feats.shape[0] for e in exps)
    n1_max = max(e.rfv_z.shape[0] for e in exps)

    def stack(field, rows):
        out = torch.zeros((len(exps), rows, getattr(exps[0], field).shape[1]),
                          device=dev)
        for a, e in enumerate(exps):
            v = getattr(e, field)
            out[a, :v.shape[0]] = v.float()
        return out

    def mask(field, rows):
        out = torch.zeros((len(exps), rows), device=dev)
        for a, e in enumerate(exps):
            out[a, :getattr(e, field).shape[0]] = 1.0
        return out

    fits = {"bbv": (stack("bbv_feats", n_max), mask("bbv_feats", n_max),
                    torch.stack([e.bbv_centroids for e in exps]).float()),
            "rfv": (stack("rfv_z", n1_max), mask("rfv_z", n1_max),
                    torch.stack([e.rfv_centroids for e in exps]).float())}
    cases = {}
    for fit, (x, w, c) in fits.items():
        for b in (3, 4, 5):
            sl = slice(0, b)
            cases[f"{fit}_b{b}"] = (pad_app_axis(x, 12)[sl].contiguous(),
                                    pad_app_axis(w, 12)[sl],
                                    pad_app_axis(c, 12)[sl].contiguous())
    xs = dkm["x"][:dkm["x"].shape[0] // MESH_SHARDS][None].contiguous()
    cases["distributed_shard"] = (xs, torch.ones(xs.shape[:2], device=dev),
                                  dkm["centroids"][None].contiguous())
    n_launch = (assign_ops._launches, segment_ops._launches)
    out = {"kmeans_assign": {}, "segment_stats": {}}
    for tag, (x, w, c) in cases.items():
        b, n, d = x.shape
        k = c.shape[1]
        lab_k, d2_k = assign_ops.kmeans_assign(x, c)
        lab_p, d2_p = assign_ops.kmeans_assign(x, c, backend="plain")
        if not (torch.equal(lab_k, lab_p) and same_bits(d2_k, d2_p)):
            raise AssertionError(f"kmeans_assign {tag}: differs from plain")
        ms = time_ms(lambda: assign_ops.kmeans_assign(x, c))
        plain_ms = time_ms(lambda: assign_ops.kmeans_assign(
            x, c, backend="plain"), warmup=1, iters=2)
        bound_ms, bound_by = bound(4 * (b * n * d + b * k * d + 2 * b * n),
                                   2.0 * b * n * k * d + 2.0 * b * n * d)
        out["kmeans_assign"][tag] = {
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": [b, n, k, d],
            "order": dot_order(x, c)}
        vals = torch.cat([x * w[..., None], w[..., None]], dim=-1)
        lab = torch.where(w != 0, lab_k, -1).int()
        got = segment_ops.segment_stats(vals, lab, k)
        want = segment_stats_ref(vals, lab, k)
        if not all(same_bits(g, v) for g, v in zip(got, want)):
            raise AssertionError(f"segment_stats {tag}: differs from plain")
        seg_ms = time_ms(lambda: segment_ops.segment_stats(vals, lab, k))
        seg_plain = time_ms(lambda: segment_stats_ref(vals, lab, k),
                            warmup=1, iters=2)
        ok = lab.reshape(-1) >= 0
        flat = (lab.long() + k * torch.arange(b, device=dev)[:, None]
                ).reshape(-1)[ok]
        rows = vals.reshape(b * n, d + 1)[ok]
        acc = torch.zeros((b * k, d + 1), device=dev)
        lib_ms = time_ms(lambda: acc.zero_().index_add_(0, flat, rows))
        s_bound, s_by = bound(
            4 * (b * n * (d + 1) + b * n + 2 * b * k * (d + 1) + b * k),
            3.0 * b * n * (d + 1) + b * n)
        out["segment_stats"][tag] = {
            "max_abs_err": 0.0, "ms": seg_ms, "plain_ms": seg_plain,
            "bound_ms": s_bound, "bound_by": s_by, "library_ms": lib_ms,
            "shape": [b, n, k, d + 1]}
        log(f"mesh local shape {tag} (b={b}, n={n}, d={d}, k={k}): both "
            f"kernels bitwise equal to plain; kmeans_assign {ms:.4f} ms "
            f"(plain {plain_ms:.4f}, bound {bound_ms:.4f} {bound_by}), "
            f"segment_stats {seg_ms:.4f} ms (plain {seg_plain:.4f}, "
            f"index_add_ {lib_ms:.4f}, bound {s_bound:.4f} {s_by})")
    assign_ops._launches, segment_ops._launches = n_launch
    return out


def phase_mesh(card=None) -> tuple[dict, dict]:
    """The multi-device app axis over a 4-shard ``("app",)`` mesh that
    names the one card four times (the port's counterpart of the
    reference's forced host devices; no run on several cards is made),
    at full width: ten apps, 7 configs, N = 120,000. Against the
    unsharded engine, bit for bit unless said:

    * the build (every field of every app, and the memo);
    * the nine staged and fused sweeps (bbv, rfv, dg x centroid, mean,
      random; fused twice, the second replaying each shard's graph),
      rows and memo tables; fused equal to staged;
    * 10^5 trials of random and rfv on a (2, 2) ``("app", "trial")``
      mesh, twelve blocks a chunk: every leaf (the float moments folded
      in the unsharded block order) and per-trial array;
    * a supervised rfv sweep and supervised trials over a pool of four
      shards that loses one (an elastic re-mesh to three; the attempts
      re-mesh the built engine instead of rebuilding it, the fleet phase
      rebuilds for real), against the uninterrupted unsharded runs; the
      trials run over four trial shards, then resume from the checkpoint
      over three (twelve blocks a chunk divide by both);
    * ``SweepService`` over ``synthetic_stream(16)`` under the mesh,
      against the requests run one by one unsharded;
    * ``distributed_kmeans`` over gcc's 120,000 BBVs (k = 20, 4 shards of
      30,000, 25 Lloyd steps): one step from the same centroids equal to
      the one-shard step (assignments bitwise, centroids within the
      bound of two float32 summation orders); the whole run within 1e-3
      of the one-shard run's inertia, at most ``DKM_LABEL_SHARE`` of its
      labels apart;
    * both kernels at the new local shapes against their plain versions.

    Returns the path's launches (the runs above, each counted from 0 just
    before it and added up; comparison runs left out) and, per kernel,
    its launches by shard and its local-shape rows for the JSON line.
    ``card``: the device the mesh names (default: the current card)."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.core.clustering import distributed_kmeans
    from repro_torch.core.clustering.distributed import (
        make_distributed_assign, make_distributed_kmeans_step, shard_points)
    from repro_torch.core.sampling.plan import SamplingPlan
    from repro_torch.experiments import (TRIAL_BLOCK, ExperimentEngine,
                                         SweepSpec, TrialSpec, resumable,
                                         run_sweep, run_sweep_resumable,
                                         run_trials, run_trials_resumable,
                                         supervise_sweep, supervise_trials)
    from repro_torch.kernels.kmeans_assign import ops as assign_ops
    from repro_torch.kernels.segment_stats import ops as segment_ops
    from repro_torch.launch.mesh import (Mesh, make_app_mesh,
                                         make_app_trial_mesh)
    from repro_torch.runtime.faults import FaultEvent, FaultPlan
    from repro_torch.serving import SweepService
    from repro_torch.serving.cli import synthetic_stream
    from repro_torch.simcpu import APP_NAMES

    phase_t0 = time.perf_counter()
    root = ROOT / "build" / "mesh"
    shutil.rmtree(root, ignore_errors=True)
    if card is None:
        card = torch.device("cuda", torch.cuda.current_device())
    mesh = make_app_mesh(devices=[card] * MESH_SHARDS)
    trial_mesh = make_app_trial_mesh(2, devices=[card] * MESH_SHARDS)
    kernels = {"kmeans_assign": assign_ops, "segment_stats": segment_ops}
    path = {name: 0 for name in kernels}
    by_shard = {name: {} for name in kernels}
    steps = {}

    def run(step, fn, *args, **kw):
        """One run of the path, its launches counted from 0 and added."""
        for ops in kernels.values():
            ops.reset_launch_count()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        steps[step] = steps.get(step, 0.0) + time.perf_counter() - t0
        for name, ops in kernels.items():
            path[name] += ops.launch_count()
            for s, n in ops.launch_counts_by_shard().items():
                by_shard[name][s] = by_shard[name].get(s, 0) + n
        return out

    torch.cuda.reset_peak_memory_stats()
    try:
        base = ExperimentEngine()
        base.memo.cols_for(base.configs)
        base.build(APP_NAMES)
        sharded = ExperimentEngine(mesh=mesh)
        sharded.memo.cols_for(sharded.configs)
        run("build", sharded.build, APP_NAMES)
        for a, b in zip(base.build(APP_NAMES), sharded.build(APP_NAMES)):
            for f in BUILD_FIELDS:
                if not same_bits(getattr(a, f), getattr(b, f)):
                    raise AssertionError(f"sharded build {a.name}: {f}")
        same_memo(memo_by_config(sharded), memo_by_config(base),
                  "sharded build")
        state0 = (base.memo.state(), sharded.memo.state())

        def reset():
            for eng, st in zip((base, sharded), state0):
                eng.memo.load_state(*st, universe=eng.configs)

        for scheme in STRATIFIERS:
            for policy in POLICIES:
                plan = SamplingPlan.from_strings(scheme, policy)
                spec = SweepSpec(apps=APP_NAMES, plan=plan)
                staged = dataclasses.replace(spec, fused=False)
                fused_rows = run("fused sweeps", run_sweep, sharded, spec)
                same_rows(fused_rows, run_sweep(base, spec),
                          f"sharded fused {scheme}/{policy}")
                same_rows(run("fused sweeps", run_sweep, sharded, spec),
                          fused_rows, f"sharded fused {scheme}/{policy}, "
                          "graph replays")
                run_sweep(base, spec)
                staged_rows = run("staged sweeps", run_sweep, sharded,
                                  staged)
                same_rows(staged_rows, run_sweep(base, staged),
                          f"sharded staged {scheme}/{policy}")
                same_rows(fused_rows, staged_rows,
                          f"sharded fused vs staged {scheme}/{policy}")
        same_memo(memo_by_config(sharded), memo_by_config(base),
                  "sharded sweeps")
        log(f"mesh: build over {MESH_SHARDS} shards equal to the unsharded "
            f"build; 9 fused (cold, then graph replays) and 9 staged "
            "sweeps equal to the unsharded sweeps and to each other; "
            f"{len([k for k in sharded.graphs if k[0] == 'fused_mesh'])} "
            "sharded fused programs kept (one graph a shard)")

        reset()
        spec_t = TrialSpec(trials=MESH_TRIALS, schemes=("random", "rfv"),
                           keep_trials=True,
                           chunk_size=MESH_CHUNK_BLOCKS * TRIAL_BLOCK)
        got = run("trials", run_trials, sharded, spec_t, apps=APP_NAMES,
                  mesh=trial_mesh)
        want = run_trials(base, spec_t, apps=APP_NAMES)
        same_trials(got, want, "trials on the (2, 2) mesh", floats=True)
        log(f"mesh: {MESH_TRIALS} trials x random, rfv on the (2, 2) "
            "(app, trial) mesh: every leaf, the float moments included, "
            "and every per-trial array equal to the unsharded run")

        reset()
        spec = SweepSpec(apps=APP_NAMES,
                         plan=SamplingPlan.from_strings("rfv", "centroid"))
        blocks = {"app_block": FLEET_APP_BLOCK,
                  "config_block": FLEET_CONFIG_BLOCK}
        meshes = []

        def remesh(m):
            meshes.append(m)
            sharded.mesh = m
            return sharded

        lose = FaultPlan((FaultEvent("kill", 2, devices_lost=1),))
        got, report = run("supervised sweep", supervise_sweep, remesh, spec,
                          root / "s", faults=lose, devices=[card] * 4,
                          **blocks)
        want = run_sweep_resumable(base, spec, root / "u", **blocks)
        same_rows(got, want, "re-meshed supervised sweep vs uninterrupted")
        same_memo(memo_by_config(sharded), memo_by_config(base),
                  "re-meshed supervised sweep vs uninterrupted")
        shapes = [a["mesh_shape"] for a in report.attempts]
        if shapes != [(4,), (3,)]:
            raise AssertionError(f"supervised sweep meshes {shapes}")

        reset()
        lose = FaultPlan((FaultEvent("kill_dirty", 3, devices_lost=1),))
        quanta, run_program = [], resumable._run_program

        def traced_program(program, x, **kw):
            quanta.append(program.n_trial)
            return run_program(program, x, **kw)

        resumable._run_program = traced_program
        try:
            got, report = run("supervised trials", supervise_trials, remesh,
                              spec_t, root / "t", apps=APP_NAMES,
                              faults=lose, segment_trials=MESH_SEGMENT,
                              devices=[card] * 4)
        finally:
            resumable._run_program = run_program
        want = run_trials_resumable(base, spec_t, root / "tu",
                                    apps=APP_NAMES,
                                    segment_trials=MESH_SEGMENT)
        same_trials(got, want, "re-meshed supervised trials", floats=True)
        t_shapes = [a["mesh_shape"] for a in report.attempts]
        if t_shapes != [(1, 4), (1, 3)]:
            raise AssertionError(f"supervised trials meshes {t_shapes}")
        # a dirty kill at quantum 3: quanta 0-3 ran over four trial
        # shards, then quantum 3 on from the checkpoint over three
        n_q = len(resumable._trial_quanta(spec_t, MESH_SEGMENT)[3])
        if quanta != [4] * 4 + [3] * (n_q - 3):
            raise AssertionError(f"supervised trials' trial shards by "
                                 f"quantum {quanta}")
        sharded.mesh = mesh
        log(f"mesh: supervised rfv sweep over meshes {shapes} and "
            f"supervised trials over {t_shapes} (one shard lost each, "
            "re-planned, resumed from the checkpoint; the trials' quanta "
            f"over {quanta} trial shards) equal to the uninterrupted "
            "unsharded runs, every leaf bit for bit")

        reset()
        stream = synthetic_stream(MESH_SERVICE_REQUESTS, apps=APP_NAMES)
        service = SweepService(sharded, mesh=mesh)
        for s in stream:
            service.submit(s)
        run("service", service.tick)
        for i, s in enumerate(stream):
            same_rows(service.result(i), run_sweep(base, s),
                      f"mesh service request {i} vs run_sweep")
        same_memo(memo_by_config(sharded), memo_by_config(base),
                  "mesh service vs serial run_sweep")
        st = service.stats()
        log(f"mesh: service over {st.completed} requests in one tick, "
            f"{st.dispatches} dispatches, {st.coalesced_requests} "
            "coalesced; rows and tables equal to the requests run one by "
            "one unsharded")

        x = base.app(DKM_APP).bbv_feats.float().contiguous()
        one = Mesh([card], ("data",))
        four = Mesh([card] * MESH_SHARDS, ("data",))
        c4, l4, i4 = run("distributed k-means", distributed_kmeans, x,
                         DKM_K, four, iters=DKM_ITERS)
        dkm_s = steps["distributed k-means"]
        c1, l1, i1 = distributed_kmeans(x, DKM_K, one, iters=DKM_ITERS)
        xs1, xs4 = shard_points(x, one, ("data",)), \
            shard_points(x, four, ("data",))
        lab1 = torch.cat(make_distributed_assign(one, ("data",))(xs1, c4))
        lab4 = torch.cat(make_distributed_assign(four, ("data",))(xs4, c4))
        if not torch.equal(lab1, lab4):
            raise AssertionError("distributed assignment: 4 shards differ")
        n1, _ = make_distributed_kmeans_step(one, ("data",), DKM_K)(xs1, c4)
        n4, _ = make_distributed_kmeans_step(four, ("data",), DKM_K)(xs4, c4)
        mag = torch.zeros((DKM_K, x.shape[1]), device=x.device).index_add_(
            0, lab1.long(), x.abs())
        if not ((n4 - n1).abs() <= 2 * 2.0 ** -24 * mag
                + torch.finfo(torch.float32).eps * n1.abs()).all():
            raise AssertionError("distributed step: centroids past the "
                                 "summation-order bound")
        differ = int((l4 != l1).sum())
        if abs(i4 - i1) > 1e-3 * i1 or differ > DKM_LABEL_SHARE * len(l1):
            raise AssertionError(f"distributed k-means whole run: inertia "
                                 f"{i4} against {i1}, {differ} labels "
                                 "differ")
        log(f"mesh: distributed k-means over {DKM_APP}'s {x.shape[0]} BBVs "
            f"(k = {DKM_K}, {MESH_SHARDS} shards, {DKM_ITERS} steps) "
            f"{dkm_s:.2f} s, {dkm_s / (DKM_ITERS + 1) * 1e3:.1f} ms a step; "
            "one step equal to the one-shard step (assignments bitwise, "
            "centroids within the summation-order bound); whole runs: "
            f"inertia {i4:.6f} against {i1:.6f} on one shard, "
            f"{differ} of {len(l1)} labels differ (at most "
            f"{DKM_LABEL_SHARE:.0%} allowed)")
        local = mesh_local_shapes(base, {"x": x, "centroids": c4})
        peak = torch.cuda.max_memory_allocated()
        del base, sharded, service
        gc.collect()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in kernels:
        if path[name] <= 0 or set(by_shard[name]) != set(range(MESH_SHARDS)):
            raise AssertionError(f"mesh path: {name} launches {path[name]}, "
                                 f"by shard {by_shard[name]}")
    log(f"mesh: launches {path}, by shard {by_shard}; seconds by step "
        + ", ".join(f"{k} {v:.2f}" for k, v in steps.items())
        + f"; peak {peak / 2**30:.2f} GiB; mesh phase "
        f"{time.perf_counter() - phase_t0:.1f} s")
    detail = {name: {"launches": path[name],
                     "launches_by_shard": {str(s): n for s, n in
                                           sorted(by_shard[name].items())},
                     "seconds_by_step": steps, "peak_gib": peak / 2**30,
                     "local_shapes": local[name]} for name in kernels}
    return path, detail


# ------------------------------------------------------------------ phase 4
LM_ARCH = "llama3.2-3b"
# the LM path runs at full width but 2 of the model's 28 layers (4 until
# the other families joined the smoke), so that the whole script stays
# near its time budget beside the figure and family paths
LM_LAYERS = 2
# 16 eval batches (64 until PR 19, 32 until PR 20): the smoke's 180 s
# budget leaves room for no more
EVAL_BATCHES, EVAL_SEQ, EVAL_BATCH = 16, 2048, 4


_LM_PEAKS: list[float] = []


def _step(name: str, t0: float, *, prefix: str = "LM",
          peaks: list = _LM_PEAKS) -> float:
    """Print a step's seconds and its own peak memory (kept in
    ``peaks``), then start the next step's peak afresh."""
    import torch
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    peaks.append(peak)
    log(f"{prefix} {name}: {s:.3f} s, peak memory {peak / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    return s


def compare_logits(tag: str, got, want, *, strict: bool = True) -> dict:
    """Report max |got - want| over want's std and the argmax agreement;
    with ``strict`` a differing argmax must sit where want's top two
    logits lie closer than max |got - want| (a near-tie)."""
    import torch
    got, want = got.float(), want.float()
    delta = float((got - want).abs().max())
    rel = delta / float(want.std())
    top2 = torch.topk(want, 2, dim=-1).values
    agree = got.argmax(-1) == want.argmax(-1)
    tie = (top2[:, 0] - top2[:, 1]) < delta
    if strict and bool((~agree & ~tie).any()):
        raise AssertionError(f"{tag}: argmax differs away from near-ties")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tag}: non-finite logits")
    log(f"{tag}: max |delta| {delta:.4g} = {rel:.4g} std; argmax agrees on "
        f"{int(agree.sum())}/{agree.numel()} rows "
        f"({int((~agree).sum())} near-ties)")
    return {"max_delta": delta, "rel": rel,
            "agree": int(agree.sum()), "rows": agree.numel()}


def phase_lm() -> dict:
    """The LM serving path at full width and ``LM_LAYERS`` layers; returns
    the launches of the three kernels in it."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.kmeans_assign import ops as assign_ops
    from repro_torch.kernels.segment_stats import ops as segment_ops
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models.registry import init_params, loss_fn
    from repro_torch.train.sampled_eval import SampledEval
    from repro_torch.train.step import make_prefill_fn

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    for ops in (flash_ops, assign_ops, segment_ops):
        ops.reset_launch_count()
    torch.cuda.reset_peak_memory_stats()
    kernel_forwards = 0

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, generator=gen)
    n_params = sum(p.numel() for p in params.parameters())
    _step(f"init {n_params / 1e9:.3f} B parameters "
          f"(config counts {cfg.param_count() / 1e9:.3f} B)", t0)

    # 1. prefill 4 x 4096: kernel route and plain route
    batch = make_pipeline(cfg, 4096, 4, seed=0, device="cuda").batch(0)
    t0 = time.perf_counter()
    kern = make_prefill_fn(cfg)(params, batch)
    kernel_forwards += 1
    _step("prefill 4 x 4096 (flash kernel)", t0)
    t0 = time.perf_counter()
    plain = make_prefill_fn(cfg, backend="plain")(params, batch)
    _step("prefill 4 x 4096 (plain attention)", t0)
    compare_logits("prefill 4 x 4096 kernel vs plain", kern, plain)
    del kern, plain

    # 2. prefill 1 x 32768 (the prefill_32k cell's sequence length)
    long_batch = make_pipeline(cfg, 32768, 1, seed=1,
                               device="cuda").batch(0)
    t0 = time.perf_counter()
    logits = make_prefill_fn(cfg)(params, long_batch)
    kernel_forwards += 1
    if logits.shape != (1, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("prefill 1 x 32768: bad logits")
    _step("prefill 1 x 32768 (flash kernel)", t0)
    del logits, long_batch
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    by_name = traced("prefill 4 x 4096 (flash kernel)",
                     lambda: make_prefill_fn(cfg)(params, batch), top=8)
    kernel_forwards += 1
    # direct copies between two dense tensors (casts) run the unrolled or
    # vectorized kernels; a copy out of a strided view (a layout copy such
    # as .contiguous() of a transposed q) runs the strided elementwise_kernel
    copies = {"dense": [0, 0.0], "strided": [0, 0.0]}
    for name, (n, ms) in by_name.items():
        if "direct_copy" in name:
            kind = "strided" if "at::native::elementwise_kernel<" in name \
                else "dense"
            copies[kind][0] += n
            copies[kind][1] += ms
    log(f"traced prefill 4 x 4096: direct copies {copies['dense'][0]} dense "
        f"(casts, {copies['dense'][1]:.2f} ms), {copies['strided'][0]} out "
        f"of strided views (layout copies, {copies['strided'][1]:.2f} ms)")
    _step("traced prefill 4 x 4096", t0)

    # 3. the serve loop: teacher-forced prefill through decode, greedy gen
    prompts = make_prompts(cfg, 4, 128, seed=0, device="cuda")
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, gen=32, cache_len=256)
    _step(f"serve loop (batch 4, prompt 128, gen 32, cache 256): "
          f"teacher-forced prefill {out.prefill_s:.3f} s, generation "
          f"{out.decode_s:.3f} s = {out.tokens_per_s:.1f} tokens/s", t0)
    if out.tokens.shape != (4, 32) or not bool(
            ((out.tokens >= 0) & (out.tokens < cfg.vocab)).all()):
        raise AssertionError("serve loop: bad tokens")
    t0 = time.perf_counter()
    traced("serve loop, 8 generated tokens",
           lambda: generate(params, cfg, prompts[:, :1], gen=8,
                            cache_len=16), top=6)
    _step("traced serve loop", t0)
    ref = make_prefill_fn(cfg)(params, {"tokens": prompts})
    kernel_forwards += 1
    compare_logits("serve first step (decode) vs prefill (flash kernel)",
                   out.first_logits, ref)

    # 4. sampled evaluation over a 64-batch corpus, each batch forwarded
    # once (memoised); the census first, then the three estimates
    pipe = make_pipeline(cfg, EVAL_SEQ, EVAL_BATCH, seed=999, device="cuda")
    loss_of = loss_fn(cfg)
    memo, calls = {}, {"n": 0}

    @torch.no_grad()
    def eval_batch(i: int):
        calls["n"] += 1
        if i not in memo:
            b = pipe.batch(i)
            loss = float(loss_of(params, b))
            toks = b["tokens"].float()
            memo[i] = (loss, np.array([
                loss, float((b["tokens"] == 0).float().mean()),
                float(toks.std(unbiased=False))]))
        return memo[i]

    t0 = time.perf_counter()
    census = float(np.mean([eval_batch(i)[0] for i in range(EVAL_BATCHES)]))
    kernel_forwards += len(memo)
    _step(f"eval census: {len(memo)} forwards of {EVAL_BATCH} x {EVAL_SEQ}"
          f" tokens, mean loss {census:.6f}", t0)
    se = SampledEval(n_batches=EVAL_BATCHES, eval_batch=eval_batch,
                     num_strata=4, device="cuda")
    t0 = time.perf_counter()
    c0 = calls["n"]
    est1 = se.characterize(n_phase1=EVAL_BATCHES // 2)
    n1, c0 = calls["n"] - c0, calls["n"]
    quick = se.quick_estimate()
    nq, c0 = calls["n"] - c0, calls["n"]
    ci = se.ci_check(per_stratum=2)
    nc = calls["n"] - c0
    _step("SampledEval characterize / quick_estimate / ci_check", t0)
    for name, val in (("phase-1", est1.mean), ("quick", quick),
                      ("ci", ci.mean)):
        if not np.isfinite(val):
            raise AssertionError(f"SampledEval {name} estimate {val}")
    log(f"SampledEval (random weights: shows the path runs, not a trained "
        f"model's eval): census {census:.6f} over {EVAL_BATCHES} forwards; "
        f"phase-1 {est1.mean:.6f} +- {est1.margin_pct:.3f}% ({n1} "
        f"forwards); quick {quick:.6f} ({nq}); ci {ci.mean:.6f} +- "
        f"{ci.margin_pct:.3f}% ({nc}); strata weights "
        f"{np.round(se._weights, 4).tolist()}")

    launches = {"flash_attention": flash_ops.launch_count(),
                "kmeans_assign": assign_ops.launch_count(),
                "segment_stats": segment_ops.launch_count()}
    log(f"LM path launches {launches}; peak memory "
        f"{max(_LM_PEAKS) / 2**30:.2f} GiB")
    if launches["flash_attention"] != cfg.n_layers * kernel_forwards:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times, expected"
                             f" {cfg.n_layers} x {kernel_forwards}")
    for name in ("kmeans_assign", "segment_stats"):
        if launches[name] <= 0:
            raise AssertionError(f"SampledEval never launched {name}")
    if max(_LM_PEAKS) >= 80e9:
        raise AssertionError("peak memory at or above 80 GB")
    del params
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------- phase 4b
# the MoE, hybrid and SSM families at full width, one after another:
# (arch, layers on the card (None: all), prefill (batch, seq), serve loop
# (batch, prompt, generated), SampledEval over the MoE model)
FAMILY_RUNS = (
    ("olmoe-1b-7b", None, (4, 4096), (4, 128, 32), True),
    ("qwen3-moe-235b-a22b", 2, (1, 4096), (4, 32, 8), False),
    ("recurrentgemma-2b", None, (4, 4096), (4, 128, 32), False),
    ("rwkv6-7b", None, (4, 4096), (4, 128, 32), False),
)
FAMILY_EVAL_BATCHES, FAMILY_EVAL_PHASE1 = 16, 8
FAMILY_CACHE = 256
ROUTING_TIE = 1e-5       # a token's k-th router score leads by less: a tie


def routing_record(routes) -> dict:
    """Pairs routed, pairs dropped for capacity, tokens that lost at least
    one pair, and near-tie tokens (``ROUTING_TIE``), over a list of
    ``Routing``s (one host sync)."""
    import torch
    if not routes:
        return {}
    counts = torch.stack([torch.stack([
        (~r.keep).sum(), (~r.keep).any(-1).sum(),
        (r.margin <= ROUTING_TIE).sum()]) for r in routes]).sum(0).tolist()
    return {"layers_routed": len(routes),
            "pairs": sum(r.keep.numel() for r in routes),
            "dropped_pairs": counts[0], "tokens_losing_a_pair": counts[1],
            "near_tie_tokens": counts[2]}


def trace_record(by_name: dict) -> dict:
    """Device events and busy milliseconds of a ``traced`` run."""
    return {"device_events": sum(n for n, _ in by_name.values()),
            "busy_ms": sum(ms for _, ms in by_name.values())}


def phase_families(card: str) -> dict:
    """The MoE, hybrid and SSM serving paths at full width
    (``FAMILY_RUNS``): prefill through the kernel route and, for the MoE
    models, the plain route, logits compared; the serve loop;
    ``SampledEval`` over the MoE model. Flash must launch on each MoE
    prefill and never on the hybrid (windowed attention) or SSM (no
    attention) paths. Returns the three kernels' launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.kmeans_assign import ops as assign_ops
    from repro_torch.kernels.segment_stats import ops as segment_ops
    from repro_torch.launch.serve import generate, make_prompts
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.registry import init_params, loss_fn
    from repro_torch.train.sampled_eval import SampledEval
    from repro_torch.train.step import make_prefill_fn

    for ops in (flash_ops, assign_ops, segment_ops):
        ops.reset_launch_count()
    records = {}
    for arch, layers, (pb, ps), (sb, sp, sg), with_eval in FAMILY_RUNS:
        full = get_config(arch)
        cfg = full if layers is None else \
            dataclasses.replace(full, n_layers=layers)
        peaks: list = []

        def step(name, t0, _peaks=peaks, _arch=arch):
            return _step(name, t0, prefix=_arch, peaks=_peaks)

        flash0 = flash_ops.launch_count()
        kernel_forwards = 0
        rec = {"layers": cfg.n_layers, "of_layers": full.n_layers}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, generator=torch.Generator(
            device="cuda").manual_seed(0))
        rec["parameters"] = sum(p.numel() for p in params.parameters())
        rec["init_s"] = step(f"init {rec['parameters'] / 1e9:.3f} B "
                             f"parameters, {cfg.n_layers} of "
                             f"{full.n_layers} layers (config counts "
                             f"{cfg.param_count() / 1e9:.3f} B)", t0)

        # 1. prefill: the kernel route, then the plain route
        batch = make_pipeline(cfg, ps, pb, seed=0, device="cuda").batch(0)
        with moe_mod.record_routing() as routes:
            t0 = time.perf_counter()
            kern = make_prefill_fn(cfg)(params, batch)
            rec["prefill_s"] = step(f"prefill {pb} x {ps} (kernel route)",
                                    t0)
        kernel_forwards += 1
        rec["prefill_tokens_per_s"] = pb * ps / rec["prefill_s"]
        rec["prefill_routing"] = routing_record(routes)
        del routes
        if cfg.family == "moe":
            # the hybrid's and the SSM's prefills launch no flash: their two
            # routes are one computation (compared until the sharded
            # trainer joined the smoke)
            t0 = time.perf_counter()
            plain = make_prefill_fn(cfg, backend="plain")(params, batch)
            rec["plain_prefill_s"] = step(
                f"prefill {pb} x {ps} (plain route)", t0)
            rec["kernel_vs_plain"] = compare_logits(
                f"{arch} prefill {pb} x {ps} kernel vs plain", kern, plain)
            del plain
            log(f"{arch} prefill routing: {rec['prefill_routing']}")
            # the first prefill warms the new GEMM shapes up: time the
            # kernel route again, warm, as the plain route ran
            t0 = time.perf_counter()
            make_prefill_fn(cfg)(params, batch)
            rec["warm_prefill_s"] = step(
                f"prefill {pb} x {ps} (kernel route, warm)", t0)
            kernel_forwards += 1
            rec["prefill_tokens_per_s"] = pb * ps / rec["warm_prefill_s"]
            # where the flash route's prefill goes (the card's activity)
            t0 = time.perf_counter()
            rec["prefill_trace"] = trace_record(traced(
                f"{arch} prefill {pb} x {ps} (kernel route)",
                lambda: make_prefill_fn(cfg)(params, batch), top=6,
                cpu=False))
            kernel_forwards += 1
            step("traced prefill", t0)
        del kern, batch
        torch.cuda.empty_cache()

        # 2. the serve loop: teacher-forced prefill through decode, greedy
        prompts = make_prompts(cfg, sb, sp, seed=0, device="cuda")
        t0 = time.perf_counter()
        out = generate(params, cfg, prompts, gen=sg, cache_len=FAMILY_CACHE)
        rec["serve_s"] = step(
            f"serve loop (batch {sb}, prompt {sp}, gen {sg}, cache "
            f"{FAMILY_CACHE}): teacher-forced prefill {out.prefill_s:.3f} s,"
            f" generation {out.decode_s:.3f} s = {out.tokens_per_s:.1f} "
            "tokens/s", t0)
        rec.update(serve_prefill_s=out.prefill_s, decode_s=out.decode_s,
                   tokens_per_s=out.tokens_per_s)
        if out.tokens.shape != (sb, sg) or not bool(
                ((out.tokens >= 0) & (out.tokens < cfg.vocab)).all()):
            raise AssertionError(f"{arch} serve loop: bad tokens")
        # the first generated step against a prefill of the prompt: equal
        # but for rounding, except where the MoE's prefill, routing sb x sp
        # tokens in one group, drops pairs that one-token steps keep
        ref = make_prefill_fn(cfg)(params, {"tokens": prompts})
        kernel_forwards += 1
        rec["decode_vs_prefill"] = compare_logits(
            f"{arch} serve first step (decode) vs prefill", out.first_logits,
            ref, strict=cfg.family != "moe")
        del out, ref

        # 3. SampledEval: a census of the corpus, then the estimates,
        # each batch forwarded once (memoised); features: the loss, the
        # share of pairs dropped for capacity (router load), the tokens'
        # spread
        if with_eval:
            pipe = make_pipeline(cfg, EVAL_SEQ, EVAL_BATCH, seed=999,
                                 device="cuda")
            loss_of = loss_fn(cfg)
            memo = {}

            @torch.no_grad()
            def eval_batch(i: int):
                if i not in memo:
                    b = pipe.batch(i)
                    with moe_mod.record_routing() as rl:
                        loss = float(loss_of(params, b))
                    r = routing_record(rl)
                    memo[i] = (loss, np.array([
                        loss, r["dropped_pairs"] / r["pairs"],
                        float(b["tokens"].float().std(unbiased=False))]))
                return memo[i]

            t0 = time.perf_counter()
            census = float(np.mean([eval_batch(i)[0]
                                    for i in range(FAMILY_EVAL_BATCHES)]))
            kernel_forwards += len(memo)
            rec["eval_census_s"] = step(
                f"eval census: {len(memo)} forwards of {EVAL_BATCH} x "
                f"{EVAL_SEQ} tokens, mean loss {census:.6f}", t0)
            se = SampledEval(n_batches=FAMILY_EVAL_BATCHES,
                             eval_batch=eval_batch, num_strata=2,
                             device="cuda")
            t0 = time.perf_counter()
            est1 = se.characterize(n_phase1=FAMILY_EVAL_PHASE1)
            quick = se.quick_estimate()
            ci = se.ci_check(per_stratum=2)
            rec["sampled_eval_s"] = step(
                "SampledEval characterize / quick_estimate / ci_check", t0)
            for name, val in (("phase-1", est1.mean), ("quick", quick),
                              ("ci", ci.mean)):
                if not np.isfinite(val):
                    raise AssertionError(f"{arch} SampledEval {name} "
                                         f"estimate {val}")
            rec["sampled_eval"] = {"census": census, "phase1": est1.mean,
                                   "quick": quick, "ci": ci.mean,
                                   "ci_margin_pct": ci.margin_pct}
            log(f"{arch} SampledEval (random weights): census {census:.6f}; "
                f"phase-1 {est1.mean:.6f}; quick {quick:.6f}; ci "
                f"{ci.mean:.6f} +- {ci.margin_pct:.3f}%; drop shares "
                f"{sorted(round(float(f[1]), 4) for _, f in memo.values())}")

        flash = flash_ops.launch_count() - flash0
        want = cfg.n_layers * kernel_forwards if cfg.family == "moe" else 0
        if flash != want:
            raise AssertionError(f"{arch}: flash_attention launched {flash}"
                                 f" times, expected {want}")
        rec["flash_launches"] = flash
        rec["peak_gib"] = max(peaks) / 2**30
        if max(peaks) >= 80e9:
            raise AssertionError(f"{arch}: peak memory at or above 80 GB")
        records[arch] = rec
        del params
        torch.cuda.empty_cache()

    launches = {"flash_attention": flash_ops.launch_count(),
                "kmeans_assign": assign_ops.launch_count(),
                "segment_stats": segment_ops.launch_count()}
    for name in ("kmeans_assign", "segment_stats"):
        if launches[name] <= 0:
            raise AssertionError(f"families SampledEval never launched "
                                 f"{name}")
    log(f"families path launches {launches} ({card})")
    log("families record " + json.dumps(records))
    return launches


# ----------------------------------------------------------------- phase 4c
# the enc-dec family at seamless-m4t-large-v2's full size (24 + 24 layers,
# d_model 1024, 16 heads of 64, vocabulary 256,206; bf16): prefill over 4 x
# 4096 source frames and target tokens, the serve loop (batch 4, 4096
# frames, 32 tokens), SampledEval over 16 batches of 4 x 2048 tokens (the
# reference's pipeline gives them 256 frames)
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_PREFILL = (4, 4096)
ENCDEC_SERVE = (4, 4096, 32)
ENCDEC_CACHE = 64


def phase_encdec(card: str) -> dict:
    """The enc-dec serving path at full size: prefill through the kernel
    route and the plain route, logits compared; the serve loop (encode,
    cross K/V, one captured decode graph a step), its first step held
    against a forward of that one token; ``SampledEval`` over the model.
    Each kernel-route forward must launch flash 24 times causal (the
    decoder's self-attention) and 48 times bidirectional (the encoder and
    the cross-attention), the serve loop's encode 24 bidirectional.
    Returns the launches of the kernels, flash split by branch."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticEncDec, make_pipeline
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.kmeans_assign import ops as assign_ops
    from repro_torch.kernels.segment_stats import ops as segment_ops
    from repro_torch.launch.serve import generate, make_source
    from repro_torch.models.registry import forward_fn, init_params, loss_fn
    from repro_torch.train.sampled_eval import SampledEval
    from repro_torch.train.step import make_prefill_fn

    for ops in (flash_ops, assign_ops, segment_ops):
        ops.reset_launch_count()
    cfg = get_config(ENCDEC_ARCH)
    peaks: list = []
    want = {"causal": 0, "non_causal": 0}

    def step(name, t0):
        return _step(name, t0, prefix=ENCDEC_ARCH, peaks=peaks)

    def forwards(n: int, *, encoder_only: bool = False) -> None:
        want["non_causal"] += n * cfg.encoder_layers
        if not encoder_only:
            want["causal"] += n * cfg.n_layers
            want["non_causal"] += n * cfg.n_layers

    rec = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    rec["parameters"] = sum(p.numel() for p in params.parameters())
    rec["init_s"] = step(f"init {rec['parameters'] / 1e9:.4f} B parameters "
                         f"({cfg.encoder_layers} + {cfg.n_layers} layers; "
                         f"the config counts {cfg.param_count() / 1e9:.4f} "
                         "B)", t0)

    # 1. prefill: the kernel route (cold, then warm), then the plain route
    pb, ps = ENCDEC_PREFILL
    batch = SyntheticEncDec(vocab=cfg.vocab, seq_len=ps, global_batch=pb,
                            seed=0, device="cuda", d_model=cfg.d_model,
                            src_len=ps).batch(0)
    t0 = time.perf_counter()
    kern = make_prefill_fn(cfg)(params, batch)
    rec["cold_prefill_s"] = step(f"prefill {pb} x {ps} frames and tokens "
                                 "(kernel route, cold)", t0)
    t0 = time.perf_counter()
    kern = make_prefill_fn(cfg)(params, batch)
    rec["prefill_s"] = step(f"prefill {pb} x {ps} (kernel route, warm)", t0)
    forwards(2)
    rec["prefill_tokens_per_s"] = pb * ps / rec["prefill_s"]
    by_branch = {b: flash_ops.launch_count(b) for b in want}
    if by_branch != want:
        raise AssertionError(f"{ENCDEC_ARCH} prefill: flash launched "
                             f"{by_branch}, expected {want}")
    t0 = time.perf_counter()
    plain = make_prefill_fn(cfg, backend="plain")(params, batch)
    rec["plain_prefill_s"] = step(f"prefill {pb} x {ps} (plain route)", t0)
    rec["kernel_vs_plain"] = compare_logits(
        f"{ENCDEC_ARCH} prefill {pb} x {ps} kernel vs plain", kern, plain)
    t0 = time.perf_counter()
    rec["prefill_trace"] = trace_record(traced(
        f"{ENCDEC_ARCH} prefill {pb} x {ps} (kernel route)",
        lambda: make_prefill_fn(cfg)(params, batch), top=6, cpu=False))
    forwards(1)
    step("traced prefill", t0)
    del kern, plain, batch
    torch.cuda.empty_cache()

    # 2. the serve loop: encode the frames, the cross K/V, greedy decoding
    # from token 0 at position 0
    sb, sp, sg = ENCDEC_SERVE
    prompts, src = make_source(cfg, sb, sp, seed=0, device="cuda")
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, gen=sg, cache_len=ENCDEC_CACHE,
                   src=src)
    forwards(1, encoder_only=True)
    rec["serve_s"] = step(
        f"serve loop (batch {sb}, {sp} frames, gen {sg}, cache "
        f"{ENCDEC_CACHE}): encode, cross K/V and capture {out.prefill_s:.3f}"
        f" s, generation {out.decode_s:.3f} s = {out.tokens_per_s:.1f} "
        "tokens/s", t0)
    rec.update(serve_prefill_s=out.prefill_s, decode_s=out.decode_s,
               tokens_per_s=out.tokens_per_s)
    if out.tokens.shape != (sb, sg) or not bool(
            ((out.tokens >= 0) & (out.tokens < cfg.vocab)).all()):
        raise AssertionError(f"{ENCDEC_ARCH} serve loop: bad tokens")
    # the first step (decode of token 0 at position 0 against the cross
    # K/V) against the full forward of that one token
    first = forward_fn(cfg)(params, {
        "src_embeds": src, "tokens": torch.zeros_like(prompts[:, :1])})
    forwards(1)
    rec["decode_vs_forward"] = compare_logits(
        f"{ENCDEC_ARCH} serve first step (decode) vs forward",
        out.first_logits, first[:, -1])
    del out, first, src, prompts
    torch.cuda.empty_cache()

    # 3. SampledEval: a census of the corpus, then the estimates, each
    # batch forwarded once (memoised); features: the loss, the tokens' and
    # the frames' spread
    pipe = make_pipeline(cfg, EVAL_SEQ, EVAL_BATCH, seed=999, device="cuda")
    loss_of = loss_fn(cfg)
    memo = {}

    @torch.no_grad()
    def eval_batch(i: int):
        if i not in memo:
            b = pipe.batch(i)
            loss = float(loss_of(params, b))
            memo[i] = (loss, np.array([
                loss, float(b["tokens"].float().std(unbiased=False)),
                float(b["src_embeds"].std(unbiased=False))]))
        return memo[i]

    t0 = time.perf_counter()
    census = float(np.mean([eval_batch(i)[0]
                            for i in range(FAMILY_EVAL_BATCHES)]))
    forwards(len(memo))
    rec["eval_census_s"] = step(
        f"eval census: {len(memo)} forwards of {EVAL_BATCH} x {EVAL_SEQ} "
        f"tokens and {pipe.src_len} frames, mean loss {census:.6f}", t0)
    se = SampledEval(n_batches=FAMILY_EVAL_BATCHES, eval_batch=eval_batch,
                     num_strata=2, device="cuda")
    t0 = time.perf_counter()
    est1 = se.characterize(n_phase1=FAMILY_EVAL_PHASE1)
    quick = se.quick_estimate()
    ci = se.ci_check(per_stratum=2)
    rec["sampled_eval_s"] = step(
        "SampledEval characterize / quick_estimate / ci_check", t0)
    for name, val in (("phase-1", est1.mean), ("quick", quick),
                      ("ci", ci.mean)):
        if not np.isfinite(val):
            raise AssertionError(f"{ENCDEC_ARCH} SampledEval {name} "
                                 f"estimate {val}")
    rec["sampled_eval"] = {"census": census, "phase1": est1.mean,
                           "quick": quick, "ci": ci.mean,
                           "ci_margin_pct": ci.margin_pct}
    log(f"{ENCDEC_ARCH} SampledEval (random weights): census "
        f"{census:.6f}; phase-1 {est1.mean:.6f}; quick {quick:.6f}; ci "
        f"{ci.mean:.6f} +- {ci.margin_pct:.3f}%")

    by_branch = {b: flash_ops.launch_count(b) for b in want}
    if by_branch != want:
        raise AssertionError(f"{ENCDEC_ARCH}: flash launched {by_branch}, "
                             f"expected {want}")
    rec["flash_launches"] = by_branch
    rec["peak_gib"] = max(peaks) / 2**30
    if max(peaks) >= 80e9:
        raise AssertionError(f"{ENCDEC_ARCH}: peak memory at or above 80 GB")
    del params
    torch.cuda.empty_cache()
    launches = {"flash_attention": by_branch["causal"],
                "flash_attention_noncausal": by_branch["non_causal"],
                "kmeans_assign": assign_ops.launch_count(),
                "segment_stats": segment_ops.launch_count()}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the enc-dec path never launched {name}")
    log(f"encdec path launches {launches} ({card})")
    log("encdec record " + json.dumps(rec))
    return launches


# ------------------------------------------------------------------ phase 5
# the trainer at full width, 2 AdamW steps of 8 x 1024 tokens each, bf16
# weights, float32 moments: (arch, layers run, microbatches), None for the
# whole depth and the reference's default microbatches. llama3.2-3b and
# seamless-m4t-large-v2 as they are; recurrentgemma-2b in 4 microbatches
# (whole, in the default 2 its 256k-vocab logits and their gradient ran
# out of the card's 80 GB beside its 57 GB of state); olmoe-1b-7b and
# rwkv6-7b cut in depth (about 16 B a parameter: bf16 weights, float32
# moments and gradient sums, one microbatch's bf16 gradients; whole they
# need about 110 GB); recurrentgemma-2b, olmoe-1b-7b and rwkv6-7b cut
# (further) for the smoke's time once the sharded trainer joined: 13 of
# 26, 2 of 16 (from 8) and 4 of 32 (from 16) layers; once the sharded
# trainer ran the hybrid (on 5 layers, its tail included) and the SSM
# at full width too, 3 of 26 (one super, still in 4 microbatches), 1 of
# 16 and 1 of 32. llama3.2-3b (2 microbatches by default) and
# recurrentgemma-2b are the runs that accumulate gradients on the card
# (``train_full_size``'s bf16 rounding check reads two steps' moments)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 1024, 8, 2, 3e-3
TRAIN_RUNS = (("llama3.2-3b", None, None), ("recurrentgemma-2b", 3, 4),
              ("seamless-m4t-large-v2", None, None), ("olmoe-1b-7b", 1, None),
              ("rwkv6-7b", 1, None))
# the smoke-size runs on the card: the CLI's loop (batch 4, seq 64, lr
# 5e-3, 3 steps, a checkpoint at step 1) and one step against the CPU's
SMOKE_TRAIN = dict(steps=3, batch=4, seq=64, lr=5e-3, ckpt_every=2)
TRAIN_RTOL = 1e-4             # the reference's bound for a resumed run
STEP_LR = 1e-3                # lr of the card-vs-CPU step
# its (batch, seq): the families' 2 x 128 run RWKV-6's chunk loop over two
# chunks and past the hybrid's 64-token local window; the dense step keeps
# its 4 x 64
STEP_SHAPE = {LM_ARCH: (4, 64)}
PROBE = 256                   # leading elements of a parameter's last axis


def train_flops(cfg, model, tokens: int, seq: int, src_len: int) -> float:
    """Model FLOPs of one train step: 6 per active parameter and token it
    acts on (the enc-dec encoder's on the source frames), plus
    attention's products, 12 x heads x head width x keys per query and
    layer (the full square, which the plain route computes; the hybrid's
    attention layers alone, none in the SSM, whose chunked products are
    not counted); recomputation is not counted."""
    hd = cfg.n_heads * cfg.head_dim
    if cfg.family == "encdec":
        n_enc = sum(p.numel() for p in model.enc_layers.parameters())
        n_rest = sum(p.numel() for p in model.parameters()) - n_enc
        frames = tokens // seq * src_len
        return (6 * n_enc * frames + 6 * n_rest * tokens
                + 12 * cfg.encoder_layers * hd * src_len * frames
                + 12 * cfg.n_layers * hd * (seq + src_len) * tokens)
    layers = {"ssm": 0, "hybrid": cfg.n_layers // 3}.get(cfg.family,
                                                          cfg.n_layers)
    return (6 * cfg.active_param_count() * tokens
            + 12 * layers * hd * seq * tokens)


def parted_after_step(got, want, grads, lr: float, what: str) -> int:
    """Hold two models after one Adam step from the same weights: every
    element within TRAIN_RTOL (and lr x 1e-3), except where the reference
    gradient lies within 1e-4 of its leaf's max |g| of zero, where the
    first update (about +-lr) may take either sign; those are counted and
    bounded at 0.1 % of a leaf. Returns their number."""
    import torch
    parted = 0
    for (name, a), b in zip(got.named_parameters(), want.parameters()):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        far = (a - b).abs() > TRAIN_RTOL * b.abs() + lr * 1e-3
        if bool(far.any()):
            g = grads[name].float().cpu().abs()
            near_zero = g <= 1e-4 * g.max()
            if not bool(near_zero[far].all()) or \
                    int(far.sum()) > 1e-3 * far.numel():
                raise AssertionError(f"{what}: {name} parts at "
                                     f"{int(far.sum())} elements")
            parted += int(far.sum())
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: {name} not finite")
    return parted


def step_on_card_grads(card_model, cpu_model, start, grads_cpu, grads_card,
                       what: str) -> dict:
    """Hold the card's new weights against the CPU's AdamW step (STEP_LR)
    from the same weights ``start`` on the card's own gradients: every
    element within TRAIN_RTOL (and lr x 1e-3), none exempt (the
    gradients' agreement is held apart). Counts the elements that part
    from the CPU's whole step ``cpu_model`` by as much, and the largest
    of their clipped gradients in Adam eps, where lr g / (|g| + eps) is
    steep in g."""
    import torch
    from repro_torch.optim import AdamW
    opt = AdamW(lr=STEP_LR)
    gnorm = float(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                 for g in grads_cpu.values())))
    scale = min(1.0, opt.clip_norm / (gnorm + 1e-9))
    opt.apply_({n: g.cpu() for n, g in grads_card.items()},
               opt.init(start), start)
    worst, parted, parted_g = 0.0, 0, 0.0
    for (name, a), b, c in zip(card_model.named_parameters(),
                               start.parameters(), cpu_model.parameters()):
        a, b, c = a.detach().float().cpu(), b.detach(), c.detach()
        far = (a - b).abs() > TRAIN_RTOL * b.abs() + STEP_LR * 1e-3
        if bool(far.any()) or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: {name} parts from the CPU's step "
                                 f"on the card's gradients at "
                                 f"{int(far.sum())} elements")
        worst = max(worst, float((a - b).abs().max()))
        far = (a - c).abs() > TRAIN_RTOL * c.abs() + STEP_LR * 1e-3
        if bool(far.any()):
            parted += int(far.sum())
            parted_g = max(parted_g, float(grads_cpu[name][far].abs().max())
                           * scale / opt.eps)
    return {"max_abs_vs_card_grads": worst, "parted": parted,
            "parted_max_g_over_eps": parted_g}


def bf16_steps_move(name: str, w, m, v, schedule):
    """Where a step of a 2-step AdamW run from bf16 weights ``w`` (leaf
    ``name``) could have moved an element with a gradient, given the
    run's final moments ``m`` and ``v`` and lr ``schedule`` (True also
    for any element of a leaf that is not bf16). Each step is the port's
    own ``AdamW.update``, its bf16 update added to ``w``: the second on
    the final moments (a zero gradient on ``m / b1`` and ``v / b2``), the
    first from zero moments at the largest first gradient ``v`` allows,
    of either sign (a smaller one's update lies between those two).
    (RWKV-6's ``w_bias``: its gradient flows only where the decay's log
    escapes the -0.5 floor, mostly at |w| > 0.25, whose half gap 2^-10
    exceeds the warm-up's steps of 3e-4 and 6e-4, and elsewhere it is
    near eps.)"""
    import torch
    from repro_torch.optim import AdamW, AdamWState
    if w.dtype != torch.bfloat16:
        return torch.ones_like(m, dtype=torch.bool)
    opt = AdamW(lr=schedule, clip_norm=None)

    def moves(grad, m0, v0, step: int):
        state = AdamWState(step=torch.tensor(step, dtype=torch.int32,
                                             device=w.device),
                           m={name: m0}, v={name: v0})
        update, _ = opt.update({name: grad}, state, {name: w})
        return w + update[name] != w
    zero = torch.zeros_like(m)
    g_max = torch.sqrt(v / ((1 - opt.b2) * opt.b2))
    first = moves(g_max, zero, zero, 0) | moves(-g_max, zero, zero, 0)
    second = moves(zero, m / opt.b1, v / opt.b2, 1)
    return (m != 0) & (first | second)


def train_full_size(arch: str, layers, microbatches, card: str,
                    echo) -> dict:
    """``launch.train`` at ``arch``'s full width (``layers`` of its depth,
    or all; ``microbatches``, or the reference's default): TRAIN_STEPS
    steps from random weights. Fails unless every
    loss is finite, the peak stays under 80 GB and every parameter whose
    gradient was not zero moved, over its first PROBE columns. Named
    apart: the leaves whose gradient was zero there (a zero first
    moment), and the bf16 leaves where no step of the run could move an
    element (``bf16_steps_move``)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.train import WARMUP_STEPS, train
    from repro_torch.models import moe
    from repro_torch.models.registry import init_params
    from repro_torch.optim import cosine_with_warmup
    from repro_torch.train.step import default_microbatches

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cell = ShapeCell("train_8x1024", "train", TRAIN_SEQ, TRAIN_BATCH)
    mb = microbatches or default_microbatches(cfg, cell)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    probe = {n: p.detach()[..., :PROBE].clone()
             for n, p in params.named_parameters()}
    built = sum(p.numel() for p in params.parameters())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    with moe.record_routing() as routes:
        run = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                    seq=TRAIN_SEQ, lr=TRAIN_LR, microbatches=mb,
                    device="cuda", params=params, log=echo)
    peak = torch.cuda.max_memory_allocated()
    losses = [run.losses[s] for s in range(TRAIN_STEPS)]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{arch} full-size train: losses {losses}")
    zero_grad = sorted(n for n, m in run.opt_state.m.items()
                       if not bool((m[..., :PROBE] != 0).any()))
    unmoved = sorted(n for n, p in params.named_parameters()
                     if torch.equal(p.detach()[..., :PROBE], probe[n]))
    schedule = cosine_with_warmup(TRAIN_LR, WARMUP_STEPS, TRAIN_STEPS)
    rounded_away = []
    for name in sorted(set(unmoved) - set(zero_grad)):
        moves = bf16_steps_move(name, probe[name],
                                run.opt_state.m[name][..., :PROBE],
                                run.opt_state.v[name][..., :PROBE], schedule)
        if bool(moves.any()):
            i = int(torch.nonzero(moves.flatten())[0])
            raise AssertionError(
                f"{arch} full-size train: {name} has a gradient and did not "
                f"move (element {i}: w {float(probe[name].flatten()[i])})")
        rounded_away.append(name)
    if peak >= 80e9:
        raise AssertionError(f"{arch} full-size train: peak "
                             f"{peak / 1e9:.2f} GB")
    src_len = min(TRAIN_SEQ, 256) if cfg.family == "encdec" else 0
    tokens = TRAIN_BATCH * TRAIN_SEQ
    warm_s = float(np.mean(run.times[1:]))
    flops = train_flops(cfg, params, tokens, TRAIN_SEQ, src_len)
    rec = {"layers": cfg.n_layers, "of_layers": get_config(arch).n_layers,
           "params": cfg.param_count(), "built_params": built,
           "microbatches": mb,
           "default_microbatches": default_microbatches(cfg, cell),
           "init_s": init_s, "losses": losses,
           "step_s": [float(t) for t in run.times],
           "first_step_s": float(run.times[0]), "warm_step_s": warm_s,
           "tokens_per_s": tokens / warm_s, "model_flops": flops,
           "mfu": flops / (warm_s * PEAK_BF16_FLOPS),
           "peak_gb": peak / 1e9, "zero_grad_leaves": zero_grad,
           "rounded_away_leaves": rounded_away}
    if cfg.family == "moe":
        rec["dropped_pairs"] = sum(int((~r.keep).sum()) for r in routes)
        rec["routed_pairs"] = sum(r.keep.numel() for r in routes)
    log(f"train {arch} full width ({cfg.n_layers} of "
        f"{rec['of_layers']} layers, {built / 1e9:.4f} B parameters "
        f"built, bf16, float32 moments, {TRAIN_BATCH} x {TRAIN_SEQ} tokens"
        f"{f' and {src_len} source frames' if src_len else ''} in {mb} "
        f"microbatch(es); {card}): init {init_s:.3f} s; steps "
        f"{', '.join(f'{t:.3f}' for t in run.times)} s (first "
        f"{rec['first_step_s']:.3f}, warm {warm_s:.3f}); "
        f"{rec['tokens_per_s']:.1f} tokens/s; model-FLOPs share "
        f"{rec['mfu']:.4f} of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16; "
        f"losses {', '.join(f'{v:.4f}' for v in losses)}; peak memory "
        f"{peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB); zero-gradient "
        f"leaves {len(zero_grad)} {zero_grad[:6]}; leaves whose steps "
        f"round away in bf16 {len(rounded_away)} {rounded_away[:4]}"
        + (f"; pairs dropped for capacity {rec['dropped_pairs']} of "
           f"{rec['routed_pairs']}" if cfg.family == "moe" else ""))
    del run, params, probe, routes
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def train_smoke_size(arch: str, echo) -> dict:
    """At ``arch``'s smoke size, float32: the CLI's loop descends, a run
    resumed from its step-1 checkpoint follows it (rtol TRAIN_RTOL), and
    one step on the card (STEP_SHAPE tokens) equals the same step on the
    CPU: the loss, the gradients, and the new weights, against the CPU's
    (``parted_after_step``) for the dense model, against the CPU's step
    on the card's own gradients for the families
    (``step_on_card_grads``)."""
    import copy
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.launch.train import train
    from repro_torch.models.registry import init_params
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import GradTransform
    from repro_torch.train.step import make_train_fn

    t0 = time.perf_counter()
    small = get_config(arch, smoke=True)
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    full_run = train(small, device="cuda", ckpt_dir=root / "a", log=echo,
                     **SMOKE_TRAIN)
    steps = SMOKE_TRAIN["steps"]
    smoke_losses = [full_run.losses[s] for s in range(steps)]
    if not smoke_losses[-1] < smoke_losses[0]:
        raise AssertionError(f"{arch} smoke train: no descent "
                             f"{smoke_losses}")
    # a host that died after step 1's checkpoint: its directory is the
    # uninterrupted run's without the last checkpoint
    shutil.copytree(root / "a", root / "b")
    shutil.rmtree(root / "b" / f"step_{steps - 1}")
    resumed = train(small, device="cuda", ckpt_dir=root / "b", log=echo,
                    **SMOKE_TRAIN)
    shutil.rmtree(root, ignore_errors=True)
    pairs = [(resumed.losses[s], full_run.losses[s])
             for s in range(resumed.start, steps)]
    np.testing.assert_allclose([a for a, _ in pairs], [b for _, b in pairs],
                               rtol=TRAIN_RTOL)
    bitwise = all(a == b for a, b in pairs)
    loop_s = time.perf_counter() - t0

    class Stash(GradTransform):
        def apply(self, grads, ef):
            return grads, grads

    cpu_model = init_params(small, generator=torch.Generator().manual_seed(1),
                            device="cpu")
    card_model = copy.deepcopy(cpu_model).to("cuda")
    start = copy.deepcopy(cpu_model)
    opt = AdamW(lr=STEP_LR, compress=Stash())
    rows, seq = STEP_SHAPE.get(arch, (2, 128))
    out = {}
    for dev, model in (("cpu", cpu_model), ("cuda", card_model)):
        batch = make_pipeline(small, seq, rows, seed=3, device=dev).batch(0)
        _, state, loss = make_train_fn(small, opt)(model, opt.init(model),
                                                   batch)
        out[dev] = (float(loss), state.ef)
    loss_delta = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    if loss_delta > TRAIN_RTOL:
        raise AssertionError(f"{arch} card vs CPU step: loss "
                             f"{out['cuda'][0]} vs {out['cpu'][0]}")
    worst = 0.0
    for name, g in out["cpu"][1].items():
        err = float((out["cuda"][1][name].cpu() - g).abs().max())
        worst = max(worst, err / max(float(g.abs().max()), 1e-30))
    if worst > TRAIN_RTOL:
        raise AssertionError(f"{arch} card vs CPU step: gradients differ "
                             f"by {worst:.3g} of a leaf's max")
    what = f"{arch} card vs CPU step"
    if arch == LM_ARCH:
        weights = {"parted": parted_after_step(
            card_model, cpu_model, out["cpu"][1], STEP_LR, what)}
        held = "parted at near-zero gradients"
    else:
        weights = step_on_card_grads(card_model, cpu_model, start,
                                     out["cpu"][1], out["cuda"][1], what)
        held = (f"parted from the CPU's step (the largest clipped gradient "
                f"among them {weights['parted_max_g_over_eps']:.3g} Adam "
                f"eps), the CPU's step on the card's gradients within "
                f"{weights['max_abs_vs_card_grads']:.3g}")
    rec = {"losses": smoke_losses, "resume_bitwise": bitwise,
           "resume_max_rel": max(abs(a - b) / abs(b) for a, b in pairs),
           "card_vs_cpu": {"batch": rows, "seq": seq,
                           "loss_rel": loss_delta,
                           "grad_rel": worst, **weights},
           "loop_s": loop_s, "step_s": time.perf_counter() - t0 - loop_s}
    log(f"train {arch} smoke size (float32, {small.n_layers} layers): CLI "
        f"loop losses {', '.join(f'{v:.6f}' for v in smoke_losses)}; "
        f"resumed from step {resumed.start - 1}: "
        f"{'bitwise equal' if bitwise else 'NOT bitwise'} to the "
        f"uninterrupted run (max rel {rec['resume_max_rel']:.3g}); card vs "
        f"CPU step ({rows} x {seq} tokens): loss rel {loss_delta:.3g}, "
        f"gradients within {worst:.3g} of each leaf's max, "
        f"{weights['parted']} "
        f"parameter elements {held}; {loop_s:.1f} s + "
        f"{rec['step_s']:.1f} s")
    return rec


def phase_train(card: str) -> dict:
    """The trainer (``repro_torch.launch.train``) of every family at full
    width (TRAIN_RUNS) and at smoke size; returns the three kernels'
    launches on the path (none: training takes the reference's
    attention, as the reference does)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.kmeans_assign import ops as assign_ops
    from repro_torch.kernels.segment_stats import ops as segment_ops

    phase_t0 = time.perf_counter()
    for ops in (flash_ops, assign_ops, segment_ops):
        ops.reset_launch_count()

    def echo(line: str) -> None:
        log(f"  train: {line}")

    # torch.utils.checkpoint imports torch._dynamo at its first call, once
    # a process: timed apart from the first step
    t0 = time.perf_counter()
    import torch._dynamo  # noqa: F401
    dynamo_s = time.perf_counter() - t0

    # the smoke-size runs first: on the host they share the CPU with the
    # populations' thread (``phase_build``), which is done before the
    # full-size runs are timed
    seconds = {}
    smoke = {}
    for arch, _, _ in TRAIN_RUNS:
        t0 = time.perf_counter()
        smoke[arch] = train_smoke_size(arch, echo)
        seconds[f"{arch} smoke"] = time.perf_counter() - t0
    full = {}
    for arch, layers, microbatches in TRAIN_RUNS:
        t0 = time.perf_counter()
        full[arch] = train_full_size(arch, layers, microbatches, card, echo)
        seconds[f"{arch} full"] = time.perf_counter() - t0
    if not any(rec["microbatches"] > 1 for rec in full.values()):
        raise AssertionError("no full-size train run accumulated gradients "
                             "over microbatches")

    launches = {"flash_attention": flash_ops.launch_count("causal"),
                "flash_attention_noncausal":
                    flash_ops.launch_count("non_causal"),
                "kmeans_assign": assign_ops.launch_count(),
                "segment_stats": segment_ops.launch_count()}
    if flash_ops.launch_count() != 0:
        raise AssertionError(f"the train path launched flash_attention "
                             f"{flash_ops.launch_count()} times")
    log(f"train path launches {launches}; torch._dynamo import "
        f"(checkpoint's first call) {dynamo_s:.3f} s; seconds: "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; the phase {time.perf_counter() - phase_t0:.1f}")
    log("train record " + json.dumps({
        "card": card, "dynamo_import_s": dynamo_s, "full_size": full,
        "smoke": smoke, "seconds": seconds}))
    return launches


# the sharded trainer (``phase_sharded_train``): bf16 at full width, 2 of
# each config's layers, 2 AdamW steps (``launch.train``'s loop) on meshes
# that name the card many times, each held against the unsharded run from
# the same weights and batches; (tag, arch, mesh, model parallel, pool,
# batch, layers): recurrentgemma-2b on 5, one super (R, R, A) and the
# two-layer tail, as the full model ends (on 2 it would run no attention)
SHARDED_LAYERS, SHARDED_SEQ, SHARDED_STEPS, SHARDED_LR = 2, 1024, 2, 3e-3
SHARDED_RUNS = (
    ("llama (2, 2)", LM_ARCH, "host", 2, 4, 8, SHARDED_LAYERS),
    ("llama (16, 16)", LM_ARCH, "production", 1, 256, 16, SHARDED_LAYERS),
    ("olmoe (2, 2)", "olmoe-1b-7b", "host", 2, 4, 8, SHARDED_LAYERS),
    ("recurrentgemma (2, 2)", "recurrentgemma-2b", "host", 2, 4, 8, 5),
    ("rwkv6 (2, 2)", "rwkv6-7b", "host", 2, 4, 8, SHARDED_LAYERS))
SHARDED_LOSS_RTOL = 3e-2      # bf16 losses (the families' serving bound)
POD_STEPS = 2                 # the multi-pod smoke-size run
SHARDED_FAMILIES = (LM_ARCH, "olmoe-1b-7b", "recurrentgemma-2b", "rwkv6-7b",
                    "seamless-m4t-large-v2")


def sharded_bf16_run(tag: str, arch: str, mesh: str, mp: int, pool: int,
                     batch: int, layers: int, card: str, echo) -> dict:
    """``launch.train`` at ``arch``'s full width on ``layers`` layers,
    bf16, on ``mesh`` over ``pool`` entries naming the card, against the
    unsharded step's loop (``make_train_fn``, the loop's schedule and
    batches) from the same weights (a copy) under ``activation_sharding``
    with the mesh's data degree, so that the MoE routes in the same
    groups: losses within SHARDED_LOSS_RTOL, and every weight within the
    two steps' Adam bound of the unsharded run's (``adam_bound_share``).
    The step is tensor- (and expert-) parallel on ``"model"``
    (``distributed.tp``): the record holds the compute it took, its
    activation layouts, and ``ShardedModel.traffic`` by type (parameter
    gathers, gradient reduce-scatters, the model axis's all-gathers,
    reduce-scatters and all-reduces). For the MoE, the experts each
    model rank ran (every expert on one rank) and the kept pairs it
    computed are recorded, and in the first step each rank's slots and
    kept pairs must be, bit for bit, those of the unsharded step's
    capacity rule in the data ranks' groups (``moe.place_pairs``) on the
    experts the ranks chose. In bf16 the row-parallel partial sums
    change the MoE's inputs in the last bit, so tokens at a routing
    near-tie may take other experts than in the unsharded step: those
    tokens, and how far the drops by rank lie from the unsharded step's
    groups', are recorded (the float32 smoke-size step,
    ``sharded_smoke_checks``, holds those drops equal)."""
    import copy
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.distributed import ctx as pctx
    from repro_torch.distributed import spmd
    from repro_torch.launch.train import WARMUP_STEPS, make_mesh, train
    from repro_torch.models import moe
    from repro_torch.models.registry import init_params, loss_fn, tp_compute
    from repro_torch.optim import AdamW, cosine_with_warmup
    from repro_torch.train.step import make_train_fn

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    grid = make_mesh(mesh, mp, ["cuda:0"] * pool)
    ranks = len(spmd.data_ranks(grid))
    params = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    plain = copy.deepcopy(params)
    schedule = cosine_with_warmup(SHARDED_LR, WARMUP_STEPS, SHARDED_STEPS)
    pipe = make_pipeline(cfg, SHARDED_SEQ, batch, seed=0, device="cuda")
    rec = {"arch": arch, "layers": cfg.n_layers,
           "of_layers": get_config(arch).n_layers, "batch": batch,
           "seq": SHARDED_SEQ}
    one_group = None
    if cfg.family == "moe":
        with torch.no_grad(), moe.record_routing() as routes:
            loss_fn(cfg, backend="plain")(plain, pipe.batch(0))
        one_group = [r.dropped_by_group().tolist() for r in routes]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    opt = AdamW(lr=schedule)
    step = make_train_fn(cfg, opt)
    state = opt.init(plain)
    base_losses, base_times, grouped, base_routes = [], [], None, None
    for s in range(SHARDED_STEPS):
        t0 = time.perf_counter()
        with pctx.activation_sharding(_duck_mesh(ranks)), \
                moe.record_routing() as routes:
            plain, state, loss = step(plain, state, pipe.batch(s))
        base_losses.append(float(loss))
        base_times.append(time.perf_counter() - t0)
        if s == 0:
            grouped = [r.dropped_by_group().tolist() for r in routes]
            base_routes = list(routes)
    rec.update({"unsharded_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "unsharded_step_s": base_times,
                "unsharded_losses": base_losses})
    want = dict(plain.named_parameters())       # kept on the card
    del state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with moe.record_routing() as routes:
        run = train(cfg, params=params, mesh=mesh, model_parallel=mp,
                    mesh_devices=["cuda:0"] * pool, steps=SHARDED_STEPS,
                    batch=batch, seq=SHARDED_SEQ, lr=SHARDED_LR,
                    device="cuda", log=echo)
    peak = torch.cuda.max_memory_allocated()
    sm = run.params
    group = sm.last_step["group"]
    losses = [run.losses[s] for s in range(SHARDED_STEPS)]
    rec.update({"mesh": sm.mesh.shape, "positions": sm.mesh.size,
                "data_ranks": ranks, "compute": tp_compute(cfg, sm.mesh),
                "layouts": sorted({f"{k} {d}" for k, _, d in group.layouts}),
                "step_s": [float(t) for t in run.times],
                "first_step_s": float(run.times[0]),
                "warm_step_s": float(np.mean(run.times[1:])),
                "peak_gb": peak / 1e9, "losses": losses,
                "loss_rel": max(abs(a - b) / abs(b)
                                for a, b in zip(losses, base_losses)),
                **sm.traffic(), **sm.shard_nbytes()})
    if group is None:
        raise AssertionError(f"sharded {tag}: the step was not tensor "
                             "parallel")
    if peak >= 80e9:
        raise AssertionError(f"sharded {tag}: peak {peak / 1e9:.2f} GB")
    if not rec["loss_rel"] <= SHARDED_LOSS_RTOL:
        raise AssertionError(f"sharded {tag}: losses {losses}, unsharded "
                             f"{base_losses}")
    lr_sum = sum(float(schedule(torch.tensor(s + 1)))
                 for s in range(SHARDED_STEPS))
    worst, differ, total = adam_bound_share(
        sm.named_parameters(), want, lr_sum, SHARDED_STEPS, f"sharded {tag}")
    rec.update({"weights_within_share_of_bound": worst,
                "weights_differing": differ, "weights": total})
    if cfg.family == "moe":
        n = cfg.n_layers
        by_rank = [[int((~routes[r * n + layer].keep).sum())
                    for r in range(ranks)] for layer in range(n)]
        experts, kept = group.moe_ranks[-1]
        rec.update({"dropped_by_rank": by_rank,
                    "dropped_by_group_unsharded": grouped,
                    "dropped_one_group": one_group,
                    "experts_by_model_rank": [len(x) for x in experts],
                    "kept_pairs_by_model_rank": [
                        int(sum(k[m] for _, k in group.moe_ranks))
                        for m in range(len(experts))]})
        if sorted(e for x in experts for e in x) != list(range(
                cfg.moe_experts)):
            raise AssertionError(f"sharded {tag}: experts by model rank "
                                 f"{experts}")
        # the capacity rule of the unsharded step's groups (data ranks
        # groups) on the experts the ranks chose: their slots and kept
        # pairs bit for bit
        for layer in range(n):
            mine = [routes[r * n + layer] for r in range(ranks)]
            slot, keep, cap = moe.place_pairs(
                torch.cat([x.expert for x in mine]), cfg, ranks)
            if not (cap == mine[0].cap and torch.equal(
                    slot, torch.cat([x.slot for x in mine])) and torch.equal(
                    keep, torch.cat([x.keep for x in mine]))):
                raise AssertionError(
                    f"sharded {tag}: layer {layer}'s ranks keep "
                    f"{[int(x.keep.sum()) for x in mine]} pairs, the "
                    f"unsharded groups' rule on their experts "
                    f"{(keep.reshape(ranks, -1).sum(1)).tolist()}")
        rerouted = []                   # tokens whose experts differ
        for layer, u in enumerate(base_routes):
            t = u.expert.shape[0] // ranks
            got = torch.cat([routes[r * n + layer].expert
                             for r in range(ranks)])
            rerouted.append(int((torch.sort(got, -1).values != torch.sort(
                u.expert, -1).values).any(-1).sum()))
        off = sum(abs(a - b) for ra, rb in zip(by_rank, grouped)
                  for a, b in zip(ra, rb))
        rec.update({"dropped_off_by": off, "tokens_rerouted_by_layer":
                    rerouted, "tokens": ranks * t})
        if sum(map(sum, by_rank)) == sum(map(sum, one_group)):
            raise AssertionError(f"sharded {tag}: the groups drop as many "
                                 f"pairs as one group ({one_group})")
    echo(f"{tag} ({card}): {arch} full width, {cfg.n_layers} of "
         f"{rec['of_layers']} layers, bf16, {batch} x {SHARDED_SEQ} tokens "
         f"on {sm.mesh.shape} ({sm.mesh.size} positions naming cuda:0, "
         f"{ranks} data ranks, {rec['compute']}; layouts "
         f"{', '.join(rec['layouts'])}): steps "
         f"{', '.join(f'{t:.3f}' for t in run.times)} s (unsharded "
         f"{', '.join(f'{t:.3f}' for t in base_times)}); "
         f"gathered {rec['gathered_bytes'] / 1e9:.3f} GB and "
         f"reduce-scattered {rec['reduce_scatter_bytes'] / 1e9:.3f} GB a "
         f"step on distinct cards, on \"model\" all-gathered "
         f"{rec['model_all_gather_bytes'] / 1e9:.3f}, reduce-scattered "
         f"{rec['model_reduce_scatter_bytes'] / 1e9:.3f}, all-reduced "
         f"{rec['model_all_reduce_bytes'] / 1e9:.6f} GB; peak "
         f"{peak / 1e9:.2f} GB (unsharded "
         f"{rec['unsharded_peak_gb']:.2f}); per position "
         f"{rec['params_per_shard'] / 1e6:.2f} MB of "
         f"{rec['params_total'] / 1e9:.3f} GB of parameters, "
         f"{rec['moment_per_shard'] / 1e6:.2f} MB of "
         f"{rec['moment_total'] / 1e9:.3f} GB a moment; losses "
         f"{', '.join(f'{v:.4f}' for v in losses)} (rel "
         f"{rec['loss_rel']:.3g}); weights within {worst:.3g} of the bound, "
         f"{differ} of {total} differ"
         + (f"; dropped by rank {rec['dropped_by_rank']}, the unsharded "
            f"groups' rule on the ranks' experts bit for bit; the unsharded "
            f"step's groups {grouped} (apart by {off} pairs: tokens "
            f"rerouted by layer {rerouted} of {ranks * t}), one group "
            f"{one_group}; experts by model rank "
            f"{rec['experts_by_model_rank']}, kept pairs by model rank "
            f"{rec['kept_pairs_by_model_rank']}"
            if cfg.family == "moe" else ""))
    del run, sm, group, params, routes, base_routes, want, plain
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def adam_bound_share(got, want: dict, lr_sum: float, steps: int, what: str
                     ) -> tuple[float, int, int]:
    """Hold weights ``got`` (named parameters) against ``want`` (name ->
    tensor on the same device) after ``steps`` AdamW steps of two runs
    from the same weights: each part by less than twice the steps' lr sum
    times (1 + 0.1 |w|) plus a bf16 unit of |w| a step. Returns the
    largest share of that bound used, the differing elements and all."""
    import torch
    worst, differ, total = 0.0, 0, 0
    for name, p in got:
        a, b = p.detach().float(), want[name].detach().float()
        d = (a - b).abs()
        room = 2 * lr_sum * (1 + 0.1 * b.abs()) + steps * 2.0 ** -7 * b.abs()
        if bool((d > room).any()) or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: {name} parts from the unsharded "
                                 f"run by {float(d.max()):.3g}")
        worst = max(worst, float((d / room).max()))
        differ += int((d > 0).sum())
        total += d.numel()
    return worst, differ, total


def sharded_smoke_checks(echo) -> dict:
    """At each family's smoke size, float32, one step on the card from the
    same weights (STEP_SHAPE tokens, STEP_LR): the sharded step on (2, 2)
    against the unsharded step under ``activation_sharding`` with data 2
    (the same MoE groups): loss and every gradient within TRAIN_RTOL (of
    a leaf's max), the weights against the unsharded AdamW step on the
    sharded step's own gradients (``step_on_card_grads``); the (1, 1) mesh
    against the unsharded step, bit for bit. On (2, 2) every family's
    step is tensor- (and, the MoE's, expert-) parallel (the hybrid's over
    128 tokens, past its 64-token window); the record holds each family's
    compute and bytes by type; the MoE's ranks drop exactly the pairs of
    the unsharded step's groups. Then ``launch.train`` on the (2, 16, 16)
    multi-pod mesh over 512 entries naming the card, POD_STEPS steps of
    the dense smoke model on SHARDED_LAYERS layers (16 model ranks: the
    query rows and the vocabulary over them), against the unsharded loop
    (losses rtol TRAIN_RTOL, weights by ``adam_bound_share``)."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.distributed import ctx as pctx
    from repro_torch.distributed.sharding import (opt_state_specs,
                                                  param_specs)
    from repro_torch.distributed.spmd import ShardedModel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import WARMUP_STEPS, train
    from repro_torch.models import moe
    from repro_torch.models.registry import (TP_FAMILIES, init_params,
                                             tp_compute)
    from repro_torch.optim import AdamW, cosine_with_warmup
    from repro_torch.optim.adamw import GradTransform
    from repro_torch.train.step import make_train_fn

    class Stash(GradTransform):
        def apply(self, grads, ef):
            return grads, grads

    out = {}
    for arch in SHARDED_FAMILIES:
        small = get_config(arch, smoke=True)
        model = init_params(small, generator=torch.Generator(
            device="cuda").manual_seed(1), device="cuda")
        rows, seq = STEP_SHAPE.get(arch, (2, 128))
        batch = make_pipeline(small, seq, rows, seed=3,
                              device="cuda").batch(0)
        opt = AdamW(lr=STEP_LR, compress=Stash())
        step = make_train_fn(small, opt)
        runs, drops = {}, {}
        for shape in ((2, 2), (1, 1)):
            mesh = make_host_mesh(shape[1], devices=["cuda:0"] * (
                shape[0] * shape[1]))
            if shape == (1, 1) and small.family != "moe":
                # the data degree moves only the MoE's routing groups: the
                # unsharded step under data 1 is the one under data 2
                plain, pstate, ploss = runs[(2, 2)][:3]
                grouped = []
            else:
                plain = copy.deepcopy(model)
                with pctx.activation_sharding(_duck_mesh(shape[0])), \
                        moe.record_routing() as grouped:
                    _, pstate, ploss = step(plain, opt.init(plain), batch)
            sm = ShardedModel(copy.deepcopy(model), mesh,
                              param_specs(model, mesh),
                              opt_state_specs(model, mesh))
            with pctx.activation_sharding(mesh), \
                    moe.record_routing() as ranked:
                _, sstate, sloss = make_train_fn(small, opt, mesh=mesh)(
                    sm, opt.init(sm), batch)
            runs[shape] = (plain, pstate, ploss, sm, sstate, sloss)
            n = small.n_layers
            drops[shape] = (
                [r.dropped_by_group().tolist() for r in grouped],
                [[int((~ranked[r * n + layer].keep).sum())
                  for r in range(shape[0])] for layer in range(n)]
                if grouped else [])
        if drops[(2, 2)][0] != drops[(2, 2)][1]:
            raise AssertionError(f"{arch}: (2, 2) drops by rank "
                                 f"{drops[(2, 2)][1]}, the unsharded "
                                 f"groups' {drops[(2, 2)][0]}")
        plain, pstate, ploss, sm, sstate, sloss = runs[(1, 1)]
        bitwise = bool(torch.equal(sloss, ploss)) and all(
            torch.equal(a, b) for (_, a), b in zip(sm.named_parameters(),
                                                   plain.parameters()))
        if not bitwise:
            raise AssertionError(f"{arch}: the (1, 1) mesh's step is not the "
                                 "unsharded step bit for bit")
        plain, pstate, ploss, sm, sstate, sloss = runs[(2, 2)]
        if (sm.last_step["group"] is None) == (small.family in TP_FAMILIES):
            raise AssertionError(f"{arch}: (2, 2) computed "
                                 f"{sm.last_step}, not "
                                 f"{tp_compute(small, sm.mesh)}")
        loss_rel = abs(float(sloss) - float(ploss)) / abs(float(ploss))
        grad_rel = 0.0
        for name, g in pstate.ef.items():
            err = float((sstate.ef[name].gather("cuda") - g).abs().max())
            grad_rel = max(grad_rel, err / max(float(g.abs().max()), 1e-30))
        if loss_rel > TRAIN_RTOL or grad_rel > TRAIN_RTOL:
            raise AssertionError(f"{arch} sharded vs unsharded step: loss "
                                 f"rel {loss_rel:.3g}, gradients "
                                 f"{grad_rel:.3g} of a leaf's max")
        weights = step_on_card_grads(
            sm, copy.deepcopy(plain).cpu(), copy.deepcopy(model).cpu(),
            {n: g.cpu() for n, g in pstate.ef.items()},
            {n: sh.gather("cuda") for n, sh in sstate.ef.items()},
            f"{arch} sharded vs unsharded step")
        out[arch] = {"loss_rel": loss_rel, "grad_rel": grad_rel,
                     **weights, "one_position_bitwise": bitwise,
                     "compute": tp_compute(small, sm.mesh), **sm.traffic(),
                     "dropped_by_rank": drops[(2, 2)][1]}
        echo(f"{arch} smoke size, float32, (2, 2) "
             f"({out[arch]['compute']}) vs unsharded under data "
             f"2: loss rel {loss_rel:.3g}, gradients within {grad_rel:.3g} "
             f"of each leaf's max; weights within "
             f"{weights['max_abs_vs_card_grads']:.3g} of the unsharded "
             f"AdamW step on the sharded gradients, {weights['parted']} "
             f"elements part from the unsharded step (clipped gradients up "
             f"to {weights['parted_max_g_over_eps']:.3g} Adam eps); (1, 1) "
             f"bitwise the unsharded step")
        del runs, model
    small = dataclasses.replace(get_config(LM_ARCH, smoke=True),
                                n_layers=SHARDED_LAYERS)
    model = init_params(small, generator=torch.Generator(
        device="cuda").manual_seed(2), device="cuda")
    kw = dict(steps=POD_STEPS, batch=32, seq=64, lr=5e-3, device="cuda",
              log=echo)
    t0 = time.perf_counter()
    base = train(small, params=copy.deepcopy(model), **kw)
    plain_s = time.perf_counter() - t0
    want = dict(base.params.named_parameters())
    t0 = time.perf_counter()
    run = train(small, params=model, mesh="production-multipod",
                mesh_devices=["cuda:0"] * 512, **kw)
    pod_s = time.perf_counter() - t0
    if run.params.mesh.shape != {"pod": 2, "data": 16, "model": 16}:
        raise AssertionError(f"multi-pod mesh {run.params.mesh.shape}")
    losses = [run.losses[s] for s in range(POD_STEPS)]
    wanted = [base.losses[s] for s in range(POD_STEPS)]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, wanted))
    if loss_rel > TRAIN_RTOL:
        raise AssertionError(f"multi-pod: losses {losses}, unsharded "
                             f"{wanted}")
    schedule = cosine_with_warmup(5e-3, WARMUP_STEPS, POD_STEPS)
    lr_sum = sum(float(schedule(torch.tensor(s + 1)))
                 for s in range(POD_STEPS))
    worst, differ, total = adam_bound_share(
        run.params.named_parameters(), want, lr_sum, POD_STEPS,
        "multi-pod")
    group = run.params.last_step["group"]
    out["multipod"] = {"mesh": run.params.mesh.shape, "losses": losses,
                       "loss_rel": loss_rel, "step_s": [
                           float(t) for t in run.times],
                       "seconds": pod_s, "unsharded_seconds": plain_s,
                       "weights_within_share_of_bound": worst,
                       "weights_differing": differ, "weights": total,
                       "layouts": sorted({f"{k} {d}"
                                          for k, _, d in group.layouts}),
                       **run.params.traffic()}
    echo(f"multi-pod (2, 16, 16) over 512 entries naming cuda:0, smoke "
         f"{LM_ARCH} on {small.n_layers} layers, tensor-parallel (layouts "
         f"{', '.join(out['multipod']['layouts'])}), {POD_STEPS} step(s) "
         f"of 32 x 64: steps "
         f"{', '.join(f'{t:.3f}' for t in run.times)} s; losses rel "
         f"{loss_rel:.3g} to the unsharded loop; weights within {worst:.3g} "
         f"of the bound, {differ} of {total} differ")
    return out


def _duck_mesh(data: int):
    import types
    return types.SimpleNamespace(axis_names=("data",), shape={"data": data})


def phase_sharded_train(card: str) -> dict:
    """Sharded training (``distributed.spmd``, ``launch.train`` on meshes
    that name the card many times): SHARDED_RUNS at full width in bf16,
    then ``sharded_smoke_checks``; returns the three kernels' launches
    on the path (none: training takes the reference's attention)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.kmeans_assign import ops as assign_ops
    from repro_torch.kernels.segment_stats import ops as segment_ops

    phase_t0 = time.perf_counter()
    for ops in (flash_ops, assign_ops, segment_ops):
        ops.reset_launch_count()

    def echo(line: str) -> None:
        log(f"  sharded train: {line}")

    seconds, full = {}, {}
    for tag, arch, mesh, mp, pool, batch, layers in SHARDED_RUNS:
        t0 = time.perf_counter()
        full[tag] = sharded_bf16_run(tag, arch, mesh, mp, pool, batch,
                                     layers, card, echo)
        seconds[tag] = time.perf_counter() - t0
    t0 = time.perf_counter()
    smoke = sharded_smoke_checks(echo)
    seconds["smoke size"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_ops.launch_count("causal"),
                "flash_attention_noncausal":
                    flash_ops.launch_count("non_causal"),
                "kmeans_assign": assign_ops.launch_count(),
                "segment_stats": segment_ops.launch_count()}
    if any(launches.values()):
        raise AssertionError(f"the sharded train path launched kernels: "
                             f"{launches}")
    log(f"sharded train path launches {launches}; seconds: "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; the phase {time.perf_counter() - phase_t0:.1f}")
    log("sharded train record " + json.dumps({
        "card": card, "full_width": full, "smoke": smoke,
        "seconds": seconds}))
    return launches


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
    # full float32 products everywhere (the plain versions and the checks)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    # the trainer launches no kernel of the port: it runs while nvcc builds
    train_path = {}

    def train_while_building():
        train_path["launches"] = timed("train path (inside the build)",
                                       phase_train, card)
        train_path["sharded"] = timed(
            "sharded train path (inside the build)", phase_sharded_train,
            card)

    timed("build", phase_build, backend_mod, train_while_building)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    assign = timed("kmeans_assign checks", check_kmeans_assign, gen)
    segment = timed("segment_stats checks", check_segment_stats, gen)
    main_inputs = timed("main-path inputs", lambda: check_main_path_inputs(
        measure_add_latency()))
    flash = timed("flash checks", check_flash, gen)
    before = torch.cuda.memory_allocated()
    simulation, engine, _, traced_passes, main_tables, plain = \
        timed("simulation path", phase_main_path)
    fused_path = timed("fused sweeps and trials", phase_fused_and_trials,
                       engine, main_tables)
    flow_path, new_shapes = timed("flow and figures",
                                  phase_flow_and_figures, engine, plain)
    del engine
    gc.collect()
    fleet_paths = timed("fleet and service", phase_fleet_and_service, plain)
    del plain
    gc.collect()
    mesh_path, mesh_detail = timed("mesh", phase_mesh)
    left = torch.cuda.memory_allocated() - before
    # torch keeps a cuBLAS workspace for every stream that ran a GEMM,
    # the graphs' capture stream among them; free them, to tell them
    # apart from anything else the phases left
    torch._C._cuda_clearCublasWorkspaces()
    log("allocated after the simulation phases, the engine dropped: "
        f"{left / 2**20:.1f} MiB more than before them, "
        f"{(torch.cuda.memory_allocated() - before) / 2**20:.1f} MiB "
        "once cuBLAS's workspaces are freed")
    by_path = {"simulation": simulation, "fused_and_trials": fused_path,
               "flow_and_figures": flow_path, **fleet_paths,
               "mesh": mesh_path, "lm": timed("LM path", phase_lm)}
    by_path["families"] = timed("families path", phase_families, card)
    by_path["encdec"] = timed("enc-dec path", phase_encdec, card)
    by_path["train"] = train_path["launches"]
    by_path["sharded_train"] = train_path["sharded"]
    log("seconds by phase: " + ", ".join(
        f"{name} {s:.1f}" for name, s in seconds.items())
        + f"; the whole script {time.perf_counter() - started:.1f}")

    def launches(name: str) -> dict:
        per = {path: n.get(name, 0) for path, n in by_path.items()}
        return {"launches": sum(per.values()), "launches_by_path": per}

    # the clustering kernels' rows: the BBV fit's last Lloyd step as the
    # build gives it; the RFV step, synthetic labels and the traced
    # build's pass totals beside it
    traced = {p: {"launches": n, "ms": ms}
              for p, (n, ms) in traced_passes.items()}
    rows = [
        {"name": "kmeans_assign", "route": "cuda",
         "source": "src/repro_torch/csrc/kmeans_assign.cuh",
         "build_units": ["src/repro_torch/csrc/kmeans_assign.cu",
                         "src/repro_torch/csrc/kmeans_assign_wide.cu",
                         "src/repro_torch/csrc/kmeans_assign_128.cu"],
         "replaces": "src/repro/kernels/kmeans_assign/kmeans_assign.py:41",
         **launches("kmeans_assign"), **main_inputs["bbv"]["kmeans_assign"],
         "other_shapes": {"rfv": main_inputs["rfv"]["kmeans_assign"],
                          **new_shapes["kmeans_assign"],
                          "synthetic": assign},
         "traced_build": traced["assign_kernel"],
         "mesh": mesh_detail["kmeans_assign"]},
        {"name": "segment_stats", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_stats.cu",
         "replaces": "src/repro/kernels/segment_stats/segment_stats.py:28",
         **launches("segment_stats"),
         "launch_counting": "the wrapper's count of the launches it makes "
                            "(none while a CUDA graph is captured) plus, "
                            "on the fused path, the launches inside graph "
                            "replays: sum_kernel events in a torch.profiler "
                            "trace of each replay",
         **main_inputs["bbv"]["segment_stats_weighted"],
         "other_shapes": {
             "bbv_all_rows": main_inputs["bbv"]["segment_stats_all_rows"],
             "rfv": main_inputs["rfv"]["segment_stats_weighted"],
             **new_shapes["segment_stats"],
             "synthetic": segment},
         "traced_build": {p: traced[p] for p in CLUSTER_KERNELS
                          if p != "assign_kernel"},
         "mesh": mesh_detail["segment_stats"]},
        {"name": "flash_attention", "route": "cuda", "branch": "causal",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "float32_source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces":
             "src/repro/kernels/flash_attention/flash_attention.py:32",
         **launches("flash_attention"), **flash["main"],
         "other_shapes": {"eval": flash["eval"], "long": flash["long"],
                          **{tag: flash[tag] for tag in FAMILY_FLASH},
                          "seamless decoder self":
                              flash["seamless decoder self"]},
         "sass": flash["sass"]},
        {"name": "flash_attention_noncausal", "route": "cuda",
         "branch": "bidirectional",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "float32_source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces":
             "src/repro/kernels/flash_attention/flash_attention.py:32",
         **launches("flash_attention_noncausal"),
         **flash["seamless encoder"],
         "other_shapes": {tag: flash[tag] for tag in
                          ("seamless cross 1000/4096",
                           "seamless cross 4096/1000")}},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
