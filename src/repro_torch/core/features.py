"""Rich Feature Vector (RFV) construction (paper Section III.B, Table III).

An RFV is the per-region vector of CPI plus microarchitectural counters
(cache misses, branch mispredicts, top-down stall bins, ...) measured on the
*baseline* configuration during phase 1. Counters are normalized per
kilo-instruction so region length never enters, then z-standardized before
k-means (paper IV.B).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

# Table III metric names (38 total): 1 global + 5 frontend + 5 LSU + 3 L2 +
# 3 L3 + 21 top-down stall bins.
FRONTEND_EVENTS = (
    "branch_mispredicts", "cond_branch_mispredicts",
    "target_branch_mispredicts", "icache_misses", "itlb_misses",
)
LSU_EVENTS = (
    "l1d_access", "l1d_load_miss", "l1d_store_miss",
    "l1d_total_miss", "l1d_writeback",
)
L2_EVENTS = ("l2_misses", "l2_load_misses", "l2_writebacks")
L3_EVENTS = ("l3_read_accesses", "l3_write_accesses", "l3_misses")
STALL_BINS = tuple(f"stall_bin_{i:02d}" for i in range(21))

RFV_METRICS: tuple[str, ...] = (
    ("cpi",) + FRONTEND_EVENTS + LSU_EVENTS + L2_EVENTS + L3_EVENTS + STALL_BINS
)
assert len(RFV_METRICS) == 38, len(RFV_METRICS)


def build_rfv(stats: Mapping[str, np.ndarray],
              metrics: Sequence[str] = RFV_METRICS) -> np.ndarray:
    """Stack per-region metric arrays into an (n_regions, n_metrics) matrix.

    ``stats`` maps metric name -> (n_regions,) array (already rate-
    normalized by the simulator). Missing metrics raise — a truncated RFV
    silently degrades stratification quality.
    """
    cols = []
    n = None
    for m in metrics:
        if m not in stats:
            raise KeyError(f"RFV metric {m!r} missing from simulator stats")
        col = np.asarray(stats[m], dtype=np.float64).reshape(-1)
        if n is None:
            n = col.shape[0]
        elif col.shape[0] != n:
            raise ValueError(f"metric {m!r} length {col.shape[0]} != {n}")
        cols.append(col)
    return np.stack(cols, axis=1)
