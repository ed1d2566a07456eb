"""Sweep-as-a-service: request coalescing over a persistent MemoBank.

Counterpart of ``repro.serving``:

* ``SweepService`` — submit/tick/drain request loop with memo-cap
  eviction (``service``);
* ``run_coalesced_sweeps`` — one fused dispatch per program-shape group,
  bitwise equal to serial runs, ledgers included (``batcher``);
* ``coalescible`` / ``coalesce_key`` / ``prepare_sweep`` — the grouping
  predicate and key (``coalesce``);
* ``python -m repro_torch.serving.cli`` — a synthetic request stream.
"""

from .batcher import run_coalesced_sweeps
from .coalesce import PreparedSweep, coalesce_key, coalescible, prepare_sweep
from .service import ServiceStats, SweepRequest, SweepService

__all__ = [
    "PreparedSweep",
    "ServiceStats",
    "SweepRequest",
    "SweepService",
    "coalesce_key",
    "coalescible",
    "prepare_sweep",
    "run_coalesced_sweeps",
]
