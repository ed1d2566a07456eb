"""Batched experiment engine and staged sweeps, on the card.

``ExperimentEngine(device=...).build(names)`` constructs per-app state for
a stack of apps on one device (census truth, phase-1 sample, BBV/RFV/DG
stratifications) over one shared ``MemoBank``;
``run_sweep(engine, SweepSpec(...))`` runs apps x configs for one
``SamplingPlan`` (or the phase-1 SRS) through the staged path.
"""

from .engine import (NUM_STRATA, PHASE1_SEED, AppExperiment,
                     ExperimentEngine, SweepStack, plan_selection,
                     plan_selection_bank)
from .sweep import (SRS_SCHEME, ResultsTable, SweepRow, SweepSpec,
                    assemble_rows, run_sweep)

__all__ = [
    "ExperimentEngine", "AppExperiment", "SweepStack",
    "plan_selection", "plan_selection_bank",
    "SweepSpec", "SweepRow", "ResultsTable", "assemble_rows", "run_sweep",
    "SRS_SCHEME", "NUM_STRATA", "PHASE1_SEED",
]
