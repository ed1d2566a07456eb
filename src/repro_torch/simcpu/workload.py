"""Generative SPECint-2017-like region populations.

Every application is a seeded generative model producing, per 1 M-instruction
region, a vector of *intrinsic* (config-independent) workload features. The
analytical core model (perfmodel.py) then maps features × UarchConfig to CPI
and the 38 Table III counters.

The generator encodes the phenomena the paper's methodology depends on:

* **Latent phases** (sticky Markov sequence) — multimodal CPI distributions
  (paper Figs 1, 6).
* **Input-data jitter** — within-phase variation of memory/branch behavior
  *not* reflected in the code profile, the reason BBV↔CPI correlation is
  imperfect (paper III.A).
* **BBV aliasing** — distinct behavior phases sharing one basic-block
  profile (same function, different data), which makes BBV stratification
  *worse than random* for some apps (paper V.A.1: gcc, mcf, omnetpp,
  xalancbmk, xz).
* **Heavy-tail outliers** — e.g. a gcc-like L2-miss-chain mode with CPI≈28
  against a 1.36 mean (paper V.A.1), invisible to BBVs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import zlib

# Feature column indices (see perfmodel.py for their use).
FEATURES = (
    "ilp",              # 0  sustainable IPC ignoring stalls
    "br_pki",           # 1  branches / kilo-instruction
    "br_mpr",           # 2  baseline mispredict rate per branch (config0 TAGE)
    "br_predict",       # 3  TAGE capacity scaling exponent
    "cond_frac",        # 4  conditional share of mispredicts
    "ic_mpki",          # 5  icache MPKI at 32 KB
    "ic_alpha",         # 6  icache size sensitivity
    "itlb_mpki",        # 7
    "l1d_apki",         # 8  L1D accesses / ki
    "load_frac",        # 9
    "l1d_mpki",         # 10 L1D MPKI at 32 KB
    "l1d_alpha",        # 11
    "l2_mpki",          # 12 L2 MPKI at 512 KB
    "l2_alpha",         # 13
    "l3_mpki",          # 14 L3 MPKI at 2 MB
    "l3_alpha",         # 15
    "wb_frac",          # 16 dirty-evict fraction
    "sms_cov",          # 17 SMS prefetch coverage of DRAM misses
    "bo_cov",           # 18 Best-Offset coverage of L3-hit misses
    "mlp",              # 19 memory-level parallelism of the miss stream
    "rob_sens",         # 20 ILP gain from a larger ROB (0..1)
)
NUM_FEATURES = len(FEATURES)
REGION_LEN_INSTR = 1_000_000   # paper IV.A: 1 M-instruction regions


@dataclasses.dataclass(frozen=True)
class AppSpec:
    """Knobs of one synthetic application's population generator."""

    name: str
    n_regions: int
    n_phases: int
    phase1_n: int                    # Table II sample size
    # lognormal sigma of within-phase input-data jitter on rate features
    jitter: float
    # per-app scale factors applied to phase-mean draws
    ilp_range: tuple[float, float]
    br_pki_mean: float
    br_mpr_mean: float
    mem_l1_mpki_mean: float          # L1D MPKI scale
    mem_escape: float                # fraction surviving each cache level
    mlp_range: tuple[float, float]
    prefetchability: float           # mean SMS/BO coverage
    phase_spread: float              # multiplicative spread of phase means
    # heavy-tail outliers
    outlier_prob: float = 0.0
    outlier_l3_mpki: float = 0.0
    outlier_sms_cov: float = 0.7
    # BBV aliasing: number of phase pairs sharing a BBV profile.
    # "adjacent" pairs neighbouring-popularity phases (balanced mixtures);
    # "spread" pairs popular with rare phases (skewed mixtures).
    alias_pairs: int = 0
    alias_scheme: str = "adjacent"
    # memory-rate multiplier range for the aliased (heavier-input) phase
    alias_mem_scale: tuple[float, float] = (2.0, 3.5)
    zipf: float = 0.7                # phase-popularity skew
    # The dominant phase (id 0) may model "one hot code path, wildly varying
    # input data": its own jitter sigma and a memory-rate multiplier.
    dominant_jitter: Optional[float] = None
    dominant_mem_scale: float = 1.0
    # Bimodal input regime for the dominant phase: (heavy fraction, u-shift).
    # Small working sets vs huge ones running the same code; k=20 BBV
    # clustering keeps both regimes in one cluster, k=50 separates them —
    # the paper's gcc 20->50 sensitivity.
    dominant_bimodal: Optional[tuple[float, float]] = None
    markov_stickiness: float = 0.995


# Populations sized so a full census stays cheap while Table II phase-1
# sample sizes remain small fractions (<~15 %) of the population.
APP_SPECS: tuple[AppSpec, ...] = (
    AppSpec("500.perlbench_r", 60_000, 8, 1_997, jitter=0.30,
            ilp_range=(2.2, 5.0), br_pki_mean=190.0, br_mpr_mean=0.013,
            mem_l1_mpki_mean=15.8, mem_escape=0.28, mlp_range=(1.8, 5.0),
            prefetchability=0.45, phase_spread=0.47),
    AppSpec("502.gcc_r", 120_000, 40, 6_195, jitter=0.30,
            ilp_range=(2.0, 5.0), br_pki_mean=210.0, br_mpr_mean=0.011,
            mem_l1_mpki_mean=11.4, mem_escape=0.38, mlp_range=(1.8, 4.5),
            prefetchability=0.40, phase_spread=0.55, zipf=1.3,
            dominant_jitter=1.00, dominant_mem_scale=1.6,
            dominant_bimodal=(0.40, 2.8),
            outlier_prob=0.0010, outlier_l3_mpki=70.0, outlier_sms_cov=0.72,
            alias_pairs=4),
    AppSpec("505.mcf_r", 40_000, 4, 964, jitter=0.45,
            ilp_range=(2.0, 3.5), br_pki_mean=160.0, br_mpr_mean=0.016,
            mem_l1_mpki_mean=34.0, mem_escape=0.46, mlp_range=(3.0, 7.0),
            prefetchability=0.30, phase_spread=0.12, alias_pairs=1,
            alias_mem_scale=(1.5, 2.0)),
    AppSpec("520.omnetpp_r", 40_000, 6, 967, jitter=0.08,
            ilp_range=(2.0, 4.0), br_pki_mean=180.0, br_mpr_mean=0.010,
            mem_l1_mpki_mean=9.3, mem_escape=0.38, mlp_range=(1.8, 3.0),
            prefetchability=0.35, phase_spread=0.10, alias_pairs=2,
            alias_mem_scale=(1.35, 1.7)),
    AppSpec("523.xalancbmk_r", 100_000, 10, 6_861, jitter=0.40,
            ilp_range=(2.5, 5.5), br_pki_mean=200.0, br_mpr_mean=0.009,
            mem_l1_mpki_mean=12.6, mem_escape=0.31, mlp_range=(2.0, 6.0),
            prefetchability=0.55, phase_spread=0.10, alias_pairs=4,
            alias_mem_scale=(1.5, 2.2)),
    AppSpec("525.x264_r", 40_000, 5, 915, jitter=0.12,
            ilp_range=(3.6, 7.5), br_pki_mean=90.0, br_mpr_mean=0.006,
            mem_l1_mpki_mean=7.0, mem_escape=0.30, mlp_range=(6.0, 12.0),
            prefetchability=0.80, phase_spread=0.58),
    AppSpec("531.deepsjeng_r", 40_000, 4, 1_041, jitter=0.07,
            ilp_range=(3.0, 5.0), br_pki_mean=170.0, br_mpr_mean=0.017,
            mem_l1_mpki_mean=5.0, mem_escape=0.22, mlp_range=(2.0, 4.0),
            prefetchability=0.35, phase_spread=0.30),
    AppSpec("541.leela_r", 40_000, 3, 1_062, jitter=0.05,
            ilp_range=(3.0, 4.5), br_pki_mean=150.0, br_mpr_mean=0.014,
            mem_l1_mpki_mean=5.0, mem_escape=0.20, mlp_range=(2.0, 4.0),
            prefetchability=0.40, phase_spread=0.03),
    AppSpec("548.exchange2_r", 40_000, 2, 1_030, jitter=0.05,
            ilp_range=(2.8, 4.2), br_pki_mean=140.0, br_mpr_mean=0.012,
            mem_l1_mpki_mean=0.48, mem_escape=0.10, mlp_range=(2.0, 4.0),
            prefetchability=0.30, phase_spread=0.04),
    AppSpec("557.xz_r", 80_000, 30, 3_047, jitter=0.35,
            ilp_range=(2.0, 6.0), br_pki_mean=170.0, br_mpr_mean=0.015,
            mem_l1_mpki_mean=16.5, mem_escape=0.38, mlp_range=(1.5, 8.0),
            prefetchability=0.45, phase_spread=0.60, zipf=1.2,
            dominant_jitter=0.95, dominant_mem_scale=1.5,
            dominant_bimodal=(0.45, 2.9),
            outlier_prob=0.001, outlier_l3_mpki=45.0, outlier_sms_cov=0.6,
            alias_pairs=6, alias_scheme="spread"),
)

APP_NAMES = tuple(s.name for s in APP_SPECS)


@dataclasses.dataclass(frozen=True)
class AppPopulation:
    """Fully materialized population: one row of features per region."""

    spec: AppSpec
    features: np.ndarray          # (n_regions, NUM_FEATURES) float64
    phase_ids: np.ndarray         # (n_regions,) int32 — latent truth
    bbv_profile_ids: np.ndarray   # (n_phases,) int32 — phase -> BBV profile
    is_outlier: np.ndarray        # (n_regions,) bool
    jitter_u: np.ndarray          # (n_regions,) float32 — input-heaviness
                                  # z-score; weakly visible in BBVs

    @property
    def n_regions(self) -> int:
        return int(self.features.shape[0])


def _phase_means(spec: AppSpec, rng: np.random.Generator) -> np.ndarray:
    """Draw per-phase mean feature vectors from app-level priors."""
    P = spec.n_phases
    m = np.zeros((P, NUM_FEATURES))
    spread = spec.phase_spread

    def ln(mean, sig):  # lognormal with given mean, multiplicative sigma
        return mean * np.exp(rng.normal(0.0, sig, P))

    m[:, 0] = rng.uniform(*spec.ilp_range, P)                       # ilp
    m[:, 1] = ln(spec.br_pki_mean, 0.2)                             # br_pki
    m[:, 2] = np.clip(ln(spec.br_mpr_mean, spread), 1e-4, 0.08)     # br_mpr
    m[:, 3] = rng.uniform(0.10, 0.45, P)                            # br_predict
    m[:, 4] = rng.uniform(0.6, 0.95, P)                             # cond_frac
    m[:, 5] = np.clip(ln(1.2, spread), 0.01, 40.0)                  # ic_mpki
    m[:, 6] = rng.uniform(0.3, 1.0, P)                              # ic_alpha
    m[:, 7] = np.clip(ln(0.15, 0.4), 0.0, 4.0)                      # itlb_mpki
    m[:, 8] = ln(350.0, 0.10)                                       # l1d_apki
    m[:, 9] = rng.uniform(0.6, 0.8, P)                              # load_frac
    m[:, 10] = np.clip(ln(spec.mem_l1_mpki_mean, spread), 0.02, 120.)  # l1d_mpki
    m[:, 11] = rng.uniform(0.2, 0.9, P)                             # l1d_alpha
    esc = np.clip(spec.mem_escape * np.exp(rng.normal(0, spread/2, P)),
                  0.02, 0.85)
    m[:, 12] = m[:, 10] * esc                                       # l2_mpki
    m[:, 13] = rng.uniform(0.2, 0.9, P)                             # l2_alpha
    esc3 = np.clip(spec.mem_escape * np.exp(rng.normal(0, spread/2, P)),
                   0.02, 0.85)
    m[:, 14] = m[:, 12] * esc3                                      # l3_mpki
    m[:, 15] = rng.uniform(0.1, 0.8, P)                             # l3_alpha
    m[:, 16] = rng.uniform(0.15, 0.5, P)                            # wb_frac
    m[:, 17] = np.clip(spec.prefetchability *
                       np.exp(rng.normal(0, 0.3, P)), 0.02, 0.95)   # sms_cov
    m[:, 18] = np.clip(spec.prefetchability *
                       np.exp(rng.normal(0, 0.3, P)), 0.02, 0.95)   # bo_cov
    m[:, 19] = rng.uniform(*spec.mlp_range, P)                      # mlp
    m[:, 20] = rng.uniform(0.1, 0.9, P)                             # rob_sens
    return m


def _phase_sequence(spec: AppSpec, rng: np.random.Generator) -> np.ndarray:
    """Sticky Markov phase sequence over the region timeline."""
    P, n = spec.n_phases, spec.n_regions
    # stationary-ish: stay with prob s, else jump to a random phase with
    # phase-specific popularity (Zipf-ish so cluster weights are unbalanced).
    pop = 1.0 / np.arange(1, P + 1) ** spec.zipf
    pop /= pop.sum()
    seq = np.empty(n, dtype=np.int32)
    seq[0] = rng.choice(P, p=pop)
    stay = spec.markov_stickiness
    jumps = rng.random(n) > stay
    targets = rng.choice(P, size=n, p=pop)
    for i in range(1, n):
        seq[i] = targets[i] if jumps[i] else seq[i - 1]
    return seq


# Rate-like feature columns that receive within-phase input-data jitter
# (invisible to BBVs — same code, different data).
_JITTER_COLS = (2, 5, 10, 12, 14, 19)


def _alias_profiles(spec: AppSpec) -> tuple[np.ndarray, dict[int, int]]:
    """BBV profile per phase; aliased pairs share one profile id.

    "adjacent" pairs neighbouring-popularity phases (balanced mixtures, the
    worst case for centroid selection); "spread" pairs popular with rare
    phases (skewed mixtures).
    """
    profile_ids = np.arange(spec.n_phases, dtype=np.int32)
    alias_of: dict[int, int] = {}
    for a in range(spec.alias_pairs):
        if spec.alias_scheme == "adjacent":
            i, j = 2 * a, 2 * a + 1
        else:  # "spread"
            i, j = a, spec.n_phases - 1 - a
        if i < j < spec.n_phases:
            profile_ids[j] = profile_ids[i]
            alias_of[j] = i
    return profile_ids, alias_of


# Feature columns shared by aliased phases (same static code => same ILP,
# branch structure, footprint profile) vs scaled (bigger input data).
_CODE_COLS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11, 13, 15, 16, 20)
_DATA_SCALE_COLS = (10, 12, 14)   # l1d/l2/l3 MPKI: larger working set


def generate_population(spec: AppSpec, *, seed: int = 0) -> AppPopulation:
    # Independent child streams so tuning one mechanism (e.g. alias scale)
    # does not reshuffle the draws of every other mechanism.
    root = np.random.SeedSequence([zlib.crc32(spec.name.encode()), seed])
    rng_means, rng_alias, rng_seq, rng_jit, rng_out = [
        np.random.default_rng(s) for s in root.spawn(5)]

    means = _phase_means(spec, rng_means)
    profile_ids, alias_of = _alias_profiles(spec)
    # Aliased phase j executes phase i's code on a heavier input: code
    # features copied, memory rates scaled up, MLP degraded. This is the
    # systematic (same-sign) error source for BBV centroid selection: the
    # popular regime's centroid region stands in for the slow regime too.
    for j, i in alias_of.items():
        means[j, list(_CODE_COLS)] = means[i, list(_CODE_COLS)]
        scale = rng_alias.uniform(*spec.alias_mem_scale)
        means[j, list(_DATA_SCALE_COLS)] = means[i, list(_DATA_SCALE_COLS)] * scale
        means[j, 19] = max(1.0, means[i, 19] * rng_alias.uniform(0.55, 0.8))
        means[j, 17] = means[i, 17]
        means[j, 18] = means[i, 18]
    if spec.dominant_mem_scale != 1.0:
        means[0, list(_DATA_SCALE_COLS)] *= spec.dominant_mem_scale
    seq = _phase_sequence(spec, rng_seq)
    feats = means[seq].copy()

    # Within-phase input-data jitter (lognormal). A single latent
    # "input-heaviness" z-score u drives all memory-rate deviations of a
    # region, so jitter is one direction in behavior space (as a data-set
    # size would be), not independent noise per counter. The dominant phase
    # may carry its own (heavier) sigma.
    n = spec.n_regions
    sigma = np.full(n, spec.jitter)
    if spec.dominant_jitter is not None:
        sigma[seq == 0] = spec.dominant_jitter
    u = rng_jit.normal(0.0, 1.0, n)
    if spec.dominant_bimodal is not None and spec.dominant_jitter is not None:
        frac_heavy, delta_u = spec.dominant_bimodal
        dom = seq == 0
        u[dom] = rng_jit.normal(0.0, 0.55, int(dom.sum()))
        heavy = dom & (rng_jit.random(n) < frac_heavy)
        u[heavy] += delta_u
    for col in _JITTER_COLS:
        mix = 0.75 * u + 0.25 * rng_jit.normal(0.0, 1.0, n)
        feats[:, col] *= np.exp(sigma * mix)
    feats[:, 0] = np.clip(feats[:, 0] + rng_jit.normal(0, 0.15, n), 1.0, 8.0)
    feats[:, 19] = np.clip(
        feats[:, 19] * np.exp(-0.3 * sigma * u +
                              (spec.jitter / 2) * rng_jit.normal(0.0, 1.0, n)),
        1.0, 16.0)

    # Heavy-tail outliers: dependent L2/L3-miss chains (mlp -> 1).
    rng = rng_out
    is_out = rng.random(n) < spec.outlier_prob
    if is_out.any():
        feats[is_out, 14] = spec.outlier_l3_mpki * \
            np.exp(rng.normal(0, 0.15, int(is_out.sum())))
        feats[is_out, 12] = np.maximum(feats[is_out, 12], feats[is_out, 14] * 1.1)
        feats[is_out, 10] = np.maximum(feats[is_out, 10], feats[is_out, 12] * 1.2)
        feats[is_out, 19] = 1.0                      # no MLP: serialized chain
        feats[is_out, 15] = 0.05                     # bigger L3 doesn't help
        feats[is_out, 17] = spec.outlier_sms_cov     # SMS-prefetchable chain
        feats[is_out, 20] = 0.1

    return AppPopulation(spec=spec, features=feats, phase_ids=seq,
                         bbv_profile_ids=profile_ids, is_outlier=is_out,
                         jitter_u=u.astype(np.float32))


_POP_CACHE: dict[tuple[str, int], AppPopulation] = {}


def get_population(name: str, *, seed: int = 0) -> AppPopulation:
    """Cached population lookup by application name."""
    key = (name, seed)
    if key not in _POP_CACHE:
        spec = next((s for s in APP_SPECS if s.name == name), None)
        if spec is None:
            raise KeyError(f"unknown application {name!r}; "
                           f"available: {APP_NAMES}")
        _POP_CACHE[key] = generate_population(spec, seed=seed)
    return _POP_CACHE[key]


@dataclasses.dataclass(frozen=True)
class PopulationBank:
    """Stacked populations: the app axis as a data-parallel array dimension.

    All apps' region features live in ONE ``(A, N, F)`` array (zero-padded
    to the largest population, with a validity ``mask``) so the perf model,
    the memo table, and the k-means fits can treat "application" as just
    another batch axis.
    """

    names: tuple[str, ...]
    pops: tuple[AppPopulation, ...]
    features: np.ndarray      # (A, N_max, NUM_FEATURES) float32, zero-padded
    mask: np.ndarray          # (A, N_max) bool — True for real regions
    n_regions: np.ndarray     # (A,) int64

    @property
    def num_apps(self) -> int:
        return len(self.names)

    @property
    def max_regions(self) -> int:
        return int(self.features.shape[1])

    def row(self, name: str) -> int:
        return self.names.index(name)

    def pop(self, name: str) -> AppPopulation:
        return self.pops[self.row(name)]


def stack_ragged(arrays, *, dtype=None, fill=0) -> tuple[np.ndarray, np.ndarray]:
    """Stack same-rank arrays of ragged leading length into (A, K_max, ...).

    Returns ``(stacked, valid)`` where ``valid`` is the (A, K_max) bool
    row-validity mask. The padded tail is filled with ``fill``.
    """
    arrays = [np.asarray(a) for a in arrays]
    k_max = max((a.shape[0] for a in arrays), default=0)
    trail = arrays[0].shape[1:] if arrays else ()
    out = np.full((len(arrays), k_max) + trail, fill,
                  dtype=dtype or arrays[0].dtype)
    valid = np.zeros((len(arrays), k_max), bool)
    for i, a in enumerate(arrays):
        out[i, :a.shape[0]] = a
        valid[i, :a.shape[0]] = True
    return out, valid


def build_population_bank(names, *, seed: int = 0) -> PopulationBank:
    names = tuple(names)
    pops = tuple(get_population(n, seed=seed) for n in names)
    feats, mask = stack_ragged([p.features for p in pops], dtype=np.float32)
    return PopulationBank(
        names=names, pops=pops, features=feats, mask=mask,
        n_regions=np.asarray([p.n_regions for p in pops], np.int64))


_BANK_CACHE: dict[tuple[tuple[str, ...], int], PopulationBank] = {}


def get_population_bank(names=APP_NAMES, *, seed: int = 0) -> PopulationBank:
    """Cached stacked-population lookup (shares ``get_population`` entries)."""
    key = (tuple(names), seed)
    if key not in _BANK_CACHE:
        _BANK_CACHE[key] = build_population_bank(names, seed=seed)
    return _BANK_CACHE[key]
