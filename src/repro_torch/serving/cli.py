"""Command-line driver for ``SweepService``.

Counterpart of ``repro.serving.cli``. Feeds the service a deterministic
synthetic request stream (a mix of stratified plans, selection seeds and
config subsets over a few apps), serves it in ``--batch``-sized ticks on
the card (``ExperimentEngine.auto()``: an app mesh over the cards when
there are several) and prints the latency, throughput, coalescing and cache
statistics:

    PYTHONPATH=src python -m repro_torch.serving.cli --requests 64 \\
        --batch 16 --memo-cap 4 --evict-policy lru --spill

``--quick`` shrinks the stream for smoke runs; ``--device cpu`` runs it
on the CPU, unsharded.
"""

from __future__ import annotations

import argparse
from typing import Sequence

import numpy as np

from ..core.sampling.plan import (Centroid, DaleniusGurney, RFVClusters,
                                  RandomUnit, SamplingPlan)
from ..experiments.engine import ExperimentEngine
from ..experiments.sweep import SweepSpec
from .service import SweepService

__all__ = ["main", "synthetic_stream"]

_APPS = ("505.mcf_r", "520.omnetpp_r", "525.x264_r")


def synthetic_stream(n: int, seed: int = 0,
                     apps: Sequence[str] = _APPS) -> list[SweepSpec]:
    """``n`` deterministic sweep requests mixing plans, seeds and config
    subsets (the reference's stream for the same seed): repeats are
    common by construction, so the stream exercises both coalescing (same
    shape, other seeds) and the memo's cross-request hits."""
    rng = np.random.default_rng(seed)
    plans = (SamplingPlan(RFVClusters(), Centroid()),
             SamplingPlan(RFVClusters(), RandomUnit()),
             SamplingPlan(DaleniusGurney(), Centroid()))
    cfg_subsets = ((0, 1, 2), (0, 1, 2), (3, 4, 5, 6))
    out = []
    for _ in range(n):
        plan = plans[int(rng.integers(len(plans)))]
        out.append(SweepSpec(
            apps=tuple(apps), plan=plan,
            config_indices=cfg_subsets[int(rng.integers(len(cfg_subsets)))],
            selection_seed=int(rng.integers(4))))
    return out


def main(argv: Sequence[str] | None = None) -> None:
    """Run a synthetic request stream through ``SweepService``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=64,
                    help="synthetic requests to serve")
    ap.add_argument("--batch", type=int, default=16,
                    help="requests submitted per tick")
    ap.add_argument("--memo-cap", type=int, default=None,
                    help="max resident memo columns (default: unbounded)")
    ap.add_argument("--evict-policy", choices=("lru", "charge"),
                    default="lru")
    ap.add_argument("--spill", action="store_true",
                    help="host-spill evicted columns instead of dropping")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device, unsharded (default: "
                    "ExperimentEngine.auto(), the cards)")
    ap.add_argument("--quick", action="store_true",
                    help="small stream for smoke runs")
    args = ap.parse_args(argv)

    if args.quick:
        args.requests = min(args.requests, 12)
        args.batch = min(args.batch, 6)

    engine = ExperimentEngine.auto() if args.device is None \
        else ExperimentEngine(device=args.device)
    service = SweepService(engine,
                           memo_cap=args.memo_cap,
                           evict_policy=args.evict_policy,
                           spill=args.spill)
    stream = synthetic_stream(args.requests, seed=args.seed)
    for start in range(0, len(stream), args.batch):
        for spec in stream[start:start + args.batch]:
            service.submit(spec)
        service.tick()

    s = service.stats()
    print(f"served {s.completed} requests in {s.ticks} ticks "
          f"({s.dispatches} dispatches, {s.coalesced_requests} coalesced)")
    print(f"latency p50 {s.latency_p50_s * 1e3:.1f} ms  "
          f"p95 {s.latency_p95_s * 1e3:.1f} ms  "
          f"throughput {s.throughput_rps:.1f} req/s")
    print(f"cache hit rate {s.cache_hit_rate:.3f}  "
          f"peak resident cols {s.peak_resident_cols}  "
          f"evicted {s.evicted_cols}")


if __name__ == "__main__":
    main()
