"""Synthetic CPU-simulation substrate (stands in for gem5 + SPECint 2017).

Populations and BBVs are built by numpy from the seed, bitwise as the
reference builds them; the perf model and the memo table run in PyTorch
on the caller's device.
"""

from .bbv import NUM_BLOCKS, get_bbvs, synthesize_bbvs
from .cache import CachedSimulator, MemoBank, make_cached_simulator
from .perfmodel import (config_matrix, cpi_bank, cpi_batch, cpi_only,
                        evaluate_regions, evaluate_regions_approx,
                        evaluate_regions_batch, rfv_bank, stats_matrix)
from .simulator import CycleAccurateSimulator, Ledger, make_simulator
from .uarch import BASELINE, CONFIGS, UarchConfig
from .workload import (APP_NAMES, APP_SPECS, REGION_LEN_INSTR, AppPopulation,
                       AppSpec, PopulationBank, build_population_bank,
                       generate_population, get_population,
                       get_population_bank, stack_ragged)

__all__ = [
    "UarchConfig", "CONFIGS", "BASELINE",
    "AppSpec", "AppPopulation", "APP_SPECS", "APP_NAMES",
    "generate_population", "get_population", "REGION_LEN_INSTR",
    "PopulationBank", "build_population_bank", "get_population_bank",
    "stack_ragged",
    "evaluate_regions", "evaluate_regions_batch", "cpi_batch", "cpi_only",
    "cpi_bank", "rfv_bank", "stats_matrix", "evaluate_regions_approx",
    "config_matrix", "synthesize_bbvs", "get_bbvs", "NUM_BLOCKS",
    "CycleAccurateSimulator", "Ledger", "make_simulator",
    "CachedSimulator", "MemoBank", "make_cached_simulator",
]
