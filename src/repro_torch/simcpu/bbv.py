"""Basic-block-vector synthesis (SimPoint's stratification variable).

Each application has ``NUM_BLOCKS`` static basic blocks. Every BBV *profile*
(one per non-aliased phase) is a sparse Dirichlet draw over blocks; a
region's BBV is its phase's profile with small execution noise. Crucially:

* regions from *aliased* phases (same code, different input data) share a
  profile — their very different memory behavior is invisible here;
* within-phase input jitter (perfmodel's rate jitter) does NOT perturb the
  BBV — the paper's III.A limitation ("a function's CPI may vary widely
  depending on its input data, even if the same basic blocks are executed").
"""

from __future__ import annotations

import zlib

import numpy as np

from .workload import REGION_LEN_INSTR, AppPopulation

NUM_BLOCKS = 256
BBV_NOISE = 0.04
# How strongly a region's input-heaviness z-score bends its BBV along the
# profile's "data-size direction" (loop-iteration counts shift with input
# size). Small vs profile separation: k-means only resolves it once clusters
# are plentiful — the reason the paper's gcc improves from k=20 to k=50.
JITTER_VISIBILITY = 0.03


def synthesize_bbvs(pop: AppPopulation, *, seed: int = 1) -> np.ndarray:
    """(n_regions, NUM_BLOCKS) float32 block execution counts."""
    rng = np.random.default_rng(
        np.random.SeedSequence([zlib.crc32(pop.spec.name.encode()), seed, 7]))
    n_profiles = int(pop.bbv_profile_ids.max()) + 1
    # Sparse-ish profiles: ~10% of blocks active per profile.
    profiles = rng.dirichlet(np.full(NUM_BLOCKS, 0.06), size=n_profiles)
    directions = rng.choice([-1.0, 1.0], size=(n_profiles, NUM_BLOCKS))
    region_profiles = profiles[pop.bbv_profile_ids[pop.phase_ids]]
    region_dirs = directions[pop.bbv_profile_ids[pop.phase_ids]]
    noise = rng.normal(1.0, BBV_NOISE, region_profiles.shape)
    sway = 1.0 + JITTER_VISIBILITY * pop.jitter_u[:, None] * region_dirs
    bbv = region_profiles * np.clip(noise * np.clip(sway, 0.2, 3.0), 0.2, 3.0)
    bbv /= bbv.sum(axis=1, keepdims=True)
    return (bbv * REGION_LEN_INSTR).astype(np.float32)


_BBV_CACHE: dict[tuple[str, int], np.ndarray] = {}


def get_bbvs(pop: AppPopulation, *, seed: int = 1) -> np.ndarray:
    key = (pop.spec.name, seed)
    if key not in _BBV_CACHE:
        _BBV_CACHE[key] = synthesize_bbvs(pop, seed=seed)
    return _BBV_CACHE[key]
