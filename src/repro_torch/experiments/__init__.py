"""Batched experiment engine, sweeps and Monte-Carlo trials, on the card.

``ExperimentEngine(device=...).build(names)`` constructs per-app state for
a stack of apps on one device (census truth, phase-1 sample, BBV/RFV/DG
stratifications) over one shared ``MemoBank``;
``run_sweep(engine, SweepSpec(...))`` runs apps x configs for one
``SamplingPlan`` (or the phase-1 SRS), fused into one program by default;
``run_trials(engine, TrialSpec(...))`` streams the Monte-Carlo selection
trials of Fig 8; ``paper_figs`` reproduces every paper figure and table;
``run_sweep_resumable`` / ``run_trials_resumable`` and their supervisors
(``supervise_sweep`` / ``supervise_trials``) run them as checkpointed,
fault-tolerant jobs.
"""

from . import paper_figs
from .engine import (NUM_STRATA, PHASE1_SEED, AppExperiment,
                     ExperimentEngine, SweepStack, plan_selection,
                     plan_selection_bank, scheme_selection,
                     scheme_selection_bank)
from .fused import fused_sweep_program, program_captures, run_fused_sweep
from .montecarlo import (SRS_DRAWS, TRIAL_BLOCK, TRIAL_SCHEMES, TrialResult,
                         TrialSpec, run_trials, trial_uniforms)
from .resumable import (FleetReport, run_sweep_resumable,
                        run_trials_resumable, supervise_sweep,
                        supervise_trials)
from .sweep import (SRS_SCHEME, ResultsTable, SweepRow, SweepSpec,
                    assemble_rows, known_schemes, run_sweep)

__all__ = [
    "ExperimentEngine", "AppExperiment", "SweepStack",
    "plan_selection", "plan_selection_bank",
    "scheme_selection", "scheme_selection_bank", "paper_figs",
    "SweepSpec", "SweepRow", "ResultsTable", "assemble_rows", "run_sweep",
    "fused_sweep_program", "run_fused_sweep", "program_captures",
    "SRS_SCHEME", "known_schemes",
    "TrialSpec", "TrialResult", "run_trials", "trial_uniforms",
    "SRS_DRAWS", "TRIAL_SCHEMES", "TRIAL_BLOCK",
    "FleetReport", "run_sweep_resumable", "run_trials_resumable",
    "supervise_sweep", "supervise_trials",
    "NUM_STRATA", "PHASE1_SEED",
]
