"""Monte-Carlo selection trials (paper Fig 8) as a streaming reduction.

Counterpart of ``repro.experiments.montecarlo``. Each scheme's trials run
in chunks of ``TRIAL_BLOCK``-trial blocks; every chunk folds its
per-trial outcomes into an additive ``TrialStats`` carry that stays on
the device (coverage counts, error and half-width moments, log-histogram
sketches), so memory is bounded by one chunk at any trial count and the
per-trial arrays come home only when kept.

PRNG contract: block ``b`` of app ``a`` draws
``uniform(fold_in(fold_in(trial_key, b), a))`` — a pure function of
(seed, scheme, block, app), bitwise the reference's draws
(``repro_torch.prng``). The block index is a device tensor, so a chunk
needs no host value but its first block.

Chunk invariance: a chunk's program reduces each block to partial sums
in a fixed order (``tables.fixed_sum``; per-trial sums over draws and
strata too) and adds the blocks into the carry one at a time in block
order, so any chunking gives the same bits in every leaf. The reference
sums a chunk at once and is chunk-invariant only to rounding.

Over a mesh (``run_trials(..., mesh=)``, default the engine's) the app
axis is split as in the sweeps, and on an ``("app", "trial")`` mesh each
chunk's ``kb`` blocks split evenly over the trial axis (``kb`` is rounded
up to a multiple of its size): trial shard ``ti`` draws blocks
``(chunk0 + c) * kb + ti * kb / n_trial`` onward, folds them into its own
carry, and the shards' carries are merged in trial-index order
(``tables.trial_stats_merge``, the reference's ``psum``): the integer
leaves exactly, and the float moments from each shard's block partial
sums, folded in the global block order as the unsharded run folds them
(``tables.fold_block_moments``), so every leaf is the unsharded one bit
for bit (the reference's ``psum`` of the float moments is equal only to
rounding). Kept per-trial arrays are assembled along the trial axis in
block order.

On a CUDA device each chunk geometry — (chunk function, blocks per
chunk, draws, accumulator dtype, kept or not, input shapes) — is
captured once as a ``torch.cuda.CUDAGraph`` after one eager chunk and
kept in the engine's ``graphs`` (freed with it); each run copies its
inputs and fresh carry into the graph's buffers, and the host loop
replays it with the chunk's first block index written into a device
scalar. On the CPU the same step runs eagerly.

Per-trial math as in the reference: the SRS scheme evaluates the eq. (2)
t-interval, the one-unit-per-stratum schemes the eq. (4) collapsed-pairs
variance over occupied strata in baseline-CPI order. Schemes drawing
from the census (``random``, ``bbv``) are free; schemes drawing from the
phase-1 sample (``rfv``, ``dg``) pull their pool through the engine's
charged ``MemoBank`` once.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from .. import prng
from ..core.precision import PrecisionPolicy, resolve_precision
from ..core.sampling import plan as sampling_plan
from ..core.sampling import tables as sampling_tables
from ..core.sampling.types import critical_values
from ..device import resolve_device
from ..simcpu import APP_NAMES
from .engine import ExperimentEngine, _segment_sums_counts, stratum_tables

__all__ = ["SRS_DRAWS", "TRIAL_SCHEMES", "TRIAL_BLOCK", "TrialSpec",
           "TrialResult", "charged_pool_fill", "run_trials", "trial_key",
           "trial_uniforms", "program_captures"]

# the plan-less trial scheme: n-unit uniform draws from the census
SRS_DRAWS = "random"
# canonical scheme order: a scheme's key is folded in at its position, so
# its draws do not depend on which subset a TrialSpec asks for
TRIAL_SCHEMES = (SRS_DRAWS, "bbv", "rfv", "dg")
# trials per PRNG block; chunk sizes are multiples of it
TRIAL_BLOCK = 256
_DEFAULT_CHUNK = 4096
# per-trial arrays are kept by default up to this many trials
_KEEP_TRIALS_MAX = 8192

_captures = 0


def program_captures() -> int:
    """CUDA graphs captured by the trial programs in this process."""
    return _captures


@dataclasses.dataclass(frozen=True)
class TrialSpec:
    """Monte-Carlo repetition axes for one study.

    ``schemes``: ``"random"`` (the plan-less SRS) and registered
    stratifier names, checked here. ``chunk_size``: trials per chunk, a
    positive multiple of ``TRIAL_BLOCK`` (default 4096, at most the
    trials); it changes memory and scheduling, never results.
    ``keep_trials``: keep the per-trial ``(A, T)`` arrays (default: up to
    8192 trials). ``precision`` overrides the engine's policy; the trials
    draw float32 uniforms, so its trace dtype must be float32.
    """

    trials: int = 1000
    units_per_trial: int = 20          # SRS draw size (scheme "random")
    schemes: tuple[str, ...] = TRIAL_SCHEMES
    config_index: int = 6              # study config (paper: Config 6)
    seed: int = 7
    confidence: float = 0.95           # per-trial CI level
    chunk_size: Optional[int] = None   # trials per chunk
    keep_trials: Optional[bool] = None  # keep the (A, T) arrays
    precision: Optional[PrecisionPolicy] = None

    def __post_init__(self):
        unknown = (set(self.schemes) - {SRS_DRAWS}
                   - set(sampling_plan.registered_stratifiers()))
        if unknown:
            raise ValueError(
                f"unknown trial scheme(s) {sorted(unknown)}; known: "
                f"{(SRS_DRAWS,) + sampling_plan.registered_stratifiers()}")
        if self.chunk_size is not None and (
                self.chunk_size <= 0 or self.chunk_size % TRIAL_BLOCK):
            raise ValueError(
                f"chunk_size must be a positive multiple of TRIAL_BLOCK="
                f"{TRIAL_BLOCK}, got {self.chunk_size}")


@dataclasses.dataclass(frozen=True)
class TrialResult:
    """Per-scheme outcomes of one ``run_trials`` study.

    ``stats[scheme]``: the streamed ``TrialStats`` (tensors on the CPU),
    from which ``coverage``, ``p95`` and ``half_width_pct`` read at any
    trial count. ``estimates``/``errors``/``half_widths[scheme]``: the
    ``(A, T)`` per-trial estimate, percent |error| and CI half-width, only
    when the spec keeps them.
    """

    apps: tuple[str, ...]
    spec: TrialSpec
    stats: dict[str, sampling_tables.TrialStats]
    estimates: dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)
    errors: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    half_widths: dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)

    @property
    def coverage(self) -> dict[str, np.ndarray]:
        """scheme -> (A,) share of trials whose CI contains the truth."""
        return {s: st.coverage for s, st in self.stats.items()}

    def p95(self, scheme: str) -> np.ndarray:
        """(A,) 95th-percentile |error| per app (Fig 8), from the sketch."""
        return self.stats[scheme].err_quantile(0.95)

    def half_width_pct(self, scheme: str, truth) -> np.ndarray:
        """(A,) mean CI half-width as a percentage of ``truth``."""
        return 100.0 * self.stats[scheme].half_mean / np.asarray(truth)


def trial_key(spec: TrialSpec, scheme: str, *, device=None) -> torch.Tensor:
    """The scheme's PRNG key (bitwise ``repro``'s): ``PRNGKey(seed)``
    folded with the scheme's index (``plan.trial_scheme_index``)."""
    dev = resolve_device(device, what="trial_key")
    return prng.fold_in(
        prng.PRNGKey(spec.seed, device=dev),
        sampling_plan.trial_scheme_index(scheme, TRIAL_SCHEMES))


def _block_uniforms(key: torch.Tensor, blocks: torch.Tensor,
                    app_ids: torch.Tensor, draws: int) -> torch.Tensor:
    """(A, nb * TRIAL_BLOCK, D) float32 draws for the blocks ``blocks``
    (nb,): block ``b`` of app ``a`` from ``fold_in(fold_in(key, b), a)``,
    trial ``t`` of a block at offset ``t`` of its rows."""
    block_keys = prng.fold_in(key, blocks)                      # (nb, 2)
    keys = prng.fold_in(block_keys[:, None, :], app_ids[None, :])
    u = prng.uniform(keys, (TRIAL_BLOCK, draws))        # (nb, A, TB, D)
    nb, a_n = keys.shape[:2]
    return u.permute(1, 0, 2, 3).reshape(a_n, nb * TRIAL_BLOCK, draws)


def trial_uniforms(spec: TrialSpec, scheme: str, num_apps: int,
                   draws_per_trial: int, *, device=None) -> np.ndarray:
    """The (A, T, D) uniforms behind one scheme's trials: the dense view
    of the block contract (trial ``t`` is at offset ``t % TRIAL_BLOCK``
    of block ``t // TRIAL_BLOCK``)."""
    dev = resolve_device(device, what="trial_uniforms")
    n_blocks = -(-spec.trials // TRIAL_BLOCK)
    u = _block_uniforms(trial_key(spec, scheme, device=dev),
                        torch.arange(n_blocks, device=dev),
                        torch.arange(num_apps, device=dev), draws_per_trial)
    return u[:, :spec.trials].cpu().numpy()


def _srs_chunk(u, truth, crit, pool, n_valid):
    """(A, Tc, n) uniforms over an (A, N) value pool -> per-trial
    estimate, percent error, eq. (2) t-interval half-width and whether it
    covers the truth."""
    a, t, n = u.shape
    nv = n_valid[:, None, None]
    idx = torch.minimum((u * nv).to(torch.int32), (nv - 1).to(torch.int32))
    vals = torch.gather(pool[:, None, :].expand(a, t, pool.shape[1]), 2,
                        idx.long())
    est = sampling_tables.fixed_sum(vals) / n
    dev = torch.abs(est - truth[:, None])
    err = 100.0 * dev / truth[:, None]
    ss = sampling_tables.fixed_sum((vals - est[:, :, None]) ** 2)
    s2 = ss / max(n - 1, 1) if n > 1 else torch.full_like(ss, float("nan"))
    half = crit[:, None] * torch.sqrt(s2 / n)
    return est, err, half, dev <= half


def _stratified_chunk(u, truth, crit, sorted_vals, offsets, counts,
                      weights, key_order, w_sorted, n_occ):
    """One unit per non-empty stratum per trial, weighted sum (empty
    strata add nothing, no renormalisation), and the eq. (4)
    collapsed-pairs CI over the occupied strata in key order."""
    a, t, l_n = u.shape
    cnt = counts[:, None, :]
    pick = offsets[:, None, :] + torch.minimum(
        (u * cnt).to(torch.int32), torch.clamp_min(cnt - 1, 0))
    # trailing empty strata put offsets at the row width: clamp (the pick
    # is weighted 0 through `occupied`)
    pick = torch.clamp_max(pick, sorted_vals.shape[1] - 1)
    vals = torch.gather(
        sorted_vals[:, None, :].expand(a, t, sorted_vals.shape[1]), 2,
        pick.long())
    occupied = (counts > 0)[:, None, :]
    est = sampling_tables.fixed_sum(vals * weights[:, None, :] * occupied)
    dev = torch.abs(est - truth[:, None])
    err = 100.0 * dev / truth[:, None]
    y_sorted = torch.gather(vals, 2,
                            key_order[:, None, :].expand(a, t, l_n).long())
    var, _ = sampling_tables.collapsed_pairs_variance(
        y_sorted, w_sorted[:, None, :], n_occ[:, None], num_strata=l_n)
    half = crit[:, None] * torch.sqrt(var)
    return est, err, half, dev <= half


class _ChunkGraph:
    """One captured chunk: static buffers for its inputs and carry, and
    its outputs."""

    def __init__(self, step, carry, x: dict):
        global _captures
        self.static = {k: v.clone() for k, v in x.items()}
        self.carry = carry.map(torch.clone)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            new, self.out = step(self.carry, self.static)
            for dst, src in zip(self.carry.leaves(), new.leaves()):
                dst.copy_(src)
        _captures += 1

    def load(self, carry, x: dict) -> None:
        """Copy a run's carry and inputs in."""
        for dst, src in zip(self.carry.leaves(), carry.leaves()):
            dst.copy_(src)
        for k, v in x.items():
            self.static[k].copy_(v)

    def replay(self, b0: int):
        self.static["b0"].fill_(b0)
        self.graph.replay()
        return self.out


class _StreamingProgram:
    """The chunk program of one geometry: ``run`` folds ``n_chunks``
    chunks of ``kb`` blocks, starting ``chunk0`` chunks into the global
    block sequence, into a fresh carry; with ``n_trial`` trial shards, a
    run takes trial shard ``trial``'s ``kb / n_trial`` blocks of each
    chunk. Inputs: ``key`` (2,), ``trials`` and ``b0`` (0-d int64),
    ``app_ids`` (A,), ``truth``/``crit`` (A,), and the chunk function's
    tables as ``t0``, ``t1``..."""

    def __init__(self, chunk_fn, kb: int, draws: int,
                 accum_dtype: torch.dtype, keep: bool, n_trial: int = 1):
        if kb % n_trial:
            raise ValueError(f"{kb} blocks a chunk do not split over "
                             f"{n_trial} trial shards")
        self.chunk_fn, self.kb, self.draws = chunk_fn, kb, draws
        self.accum_dtype, self.keep = accum_dtype, keep
        self.n_trial, self.kbd = n_trial, kb // n_trial

    def step(self, carry, x: dict):
        """One chunk: draws, per-trial outcomes, the carry update."""
        dev = x["key"].device
        blocks = x["b0"] + torch.arange(self.kbd, device=dev)
        u = _block_uniforms(x["key"], blocks, x["app_ids"], self.draws)
        tables = []
        while f"t{len(tables)}" in x:
            tables.append(x[f"t{len(tables)}"])
        est, err, half, covered = self.chunk_fn(u, x["truth"], x["crit"],
                                                *tables)
        trial = x["b0"] * TRIAL_BLOCK \
            + torch.arange(self.kbd * TRIAL_BLOCK, device=dev)
        new, moments = sampling_tables.trial_stats_update(
            carry, err, half, covered, (trial < x["trials"])[None, :],
            block=TRIAL_BLOCK, with_moments=True)
        return new, ((est, err, half) if self.keep else None,
                     moments if self.n_trial > 1 else None)

    def run(self, x: dict, *, chunk0: int, n_chunks: int, graphs: dict,
            trial: int = 0):
        """(TrialStats on the device, per-chunk (est, err, half) when
        kept, per-chunk block moments ``(A, 4, kb / n_trial)`` of a trial
        shard: empty on an unsplit trial axis). On the card the chunk's
        graph is kept in ``graphs`` (the engine's) per device and input
        shapes; trial shards on one device share it."""
        dev = x["key"].device
        carry = sampling_tables.trial_stats_init(
            x["app_ids"].shape, accum_dtype=self.accum_dtype, device=dev)
        key = ("trials", self, str(dev),
               tuple((k, tuple(v.shape), v.dtype) for k, v in x.items()))
        loaded = False
        chunks, moments = [], []
        for c in range(n_chunks):
            b0 = (chunk0 + c) * self.kb + trial * self.kbd
            graph = graphs.get(key) if dev.type == "cuda" else None
            if graph is None:
                xc = {**x, "b0": torch.full((), b0, dtype=torch.int64,
                                            device=dev)}
                carry, (ys, mom) = self.step(carry, xc)
                if dev.type == "cuda":
                    # the eager chunk warmed everything up; capture it
                    graphs[key] = _ChunkGraph(self.step, carry, xc)
            else:
                if not loaded:
                    graph.load(carry, x)
                    loaded = True
                ys, mom = graph.replay(b0)
                carry = graph.carry
            if self.keep:
                chunks.append(tuple(y.clone() for y in ys))
            if mom is not None:
                moments.append(mom.clone())
        return carry.map(torch.clone), chunks, moments


@functools.lru_cache(maxsize=None)
def _streaming_program(chunk_fn, *, kb: int, draws: int, accum: str,
                       keep: bool, n_trial: int = 1) -> _StreamingProgram:
    """The chunk program of one geometry (its graphs are kept by the
    engine that runs it)."""
    return _StreamingProgram(chunk_fn, kb, draws,
                             PrecisionPolicy(accum=accum).accum_dtype, keep,
                             n_trial)


def _trial_axis_size(mesh) -> int:
    """Devices along a mesh's trial axis (1 without one)."""
    if mesh is None:
        return 1
    from ..distributed.appaxis import app_trial_axes
    _, trial_axis = app_trial_axes(mesh)
    return 1 if trial_axis is None else int(mesh.shape[trial_axis])


def _chunk_blocks(spec: TrialSpec, ntd: int = 1) -> tuple[int, int]:
    """(kb, n_chunks): PRNG blocks per chunk, a multiple of the trial
    axis's ``ntd`` devices so each owns whole blocks, and the number of
    chunks."""
    blocks_needed = -(-spec.trials // TRIAL_BLOCK)
    kb = -(-(spec.chunk_size or _DEFAULT_CHUNK) // TRIAL_BLOCK)
    kb = min(kb, blocks_needed)
    kb = -(-kb // ntd) * ntd
    return kb, -(-blocks_needed // kb)


def _merge_trial_shards(outs: list):
    """One app row's trial-shard outputs, in trial-index order, as one:
    the carries' counters and sketches summed in that order; the float
    moments folded from zero over every shard's block partial sums in the
    global block order (chunk by chunk, then trial shard by trial shard),
    the adds of the unsharded run, so the same bits; each chunk's kept
    arrays concatenated along the trial axis (block order)."""
    stats = outs[0][0]
    for st, _, _ in outs[1:]:
        stats = sampling_tables.trial_stats_merge(stats, st)
    moments = torch.cat([o[2][c] for c in range(len(outs[0][2]))
                         for o in outs], dim=-1)
    stats = sampling_tables.fold_block_moments(dataclasses.replace(
        stats, **{f: torch.zeros_like(getattr(stats, f))
                  for f in sampling_tables.TRIAL_MOMENTS}), moments)
    chunks = [tuple(torch.cat([o[1][c][i] for o in outs], dim=1)
                    for i in range(len(outs[0][1][c])))
              for c in range(len(outs[0][1]))]
    return stats, chunks, []


def _run_program(program: _StreamingProgram, x: dict, *, chunk0: int,
                 n_chunks: int, graphs: dict, mesh=None):
    """``program.run`` over the whole app axis, or over ``mesh``: each
    (app shard, trial shard) runs its lanes and blocks on its device
    (``distributed.appaxis.make_app_trial_sharded``); the result is the
    merged (TrialStats, kept chunks) on ``x``'s device."""
    if mesh is None:
        return program.run(x, chunk0=chunk0, n_chunks=n_chunks,
                           graphs=graphs)[:2]
    from ..distributed.appaxis import make_app_trial_sharded
    names = list(x)
    rep = tuple(i for i, k in enumerate(names) if k in ("key", "trials"))

    def fn(*args, shard):
        return program.run(dict(zip(names, args)), chunk0=chunk0,
                           n_chunks=n_chunks, graphs=graphs,
                           trial=shard.trial)

    sharded = make_app_trial_sharded(fn, mesh, rep,
                                     merge=_merge_trial_shards)
    return sharded(*(x[k] for k in names))[:2]


def _stratum_key_counts(baseline, labels, valid, num_strata: int, *,
                        backend: str = "auto"):
    """(A, L) stratum mean-baseline ordering key (+inf for empty strata)
    and the stratum counts, from one ``segment_stats`` summary."""
    sums, cnts = _segment_sums_counts(labels, valid, num_strata, baseline,
                                      backend=backend)
    key = torch.where(cnts > 0, sums / torch.clamp_min(cnts, 1.0),
                      torch.full_like(sums, float("inf")))
    return key, cnts


def _stratifiers(spec: TrialSpec, stratifiers: Optional[dict]) -> dict:
    return {s: (stratifiers or {}).get(s)
            or sampling_plan.make_stratifier(s)
            for s in spec.schemes if s != SRS_DRAWS}


def charged_pool_fill(engine: ExperimentEngine, spec: TrialSpec, apps,
                      mesh=None, stratifiers: Optional[dict] = None
                      ) -> Optional[torch.Tensor]:
    """The trials' only charged memo interaction: schemes whose
    stratifier draws from the phase-1 sample (``pool_kind == "phase1"``)
    pull its CPI at the study config through the engine's ``MemoBank``
    (paid once, hits after). Returns the (A, n1_max) pool, or ``None``
    when no scheme needs one. ``mesh`` shards the fill's perf-model
    pass."""
    if not any(s.pool_kind == "phase1"
               for s in _stratifiers(spec, stratifiers).values()):
        return None
    stack = engine.stack(tuple(apps))
    cfg = engine.configs[spec.config_index]
    cpi, _ = engine.memo.fill(stack.rows, stack.idx1, stack.idx1_valid,
                              (cfg,), feats=stack.gather_feats(stack.idx1),
                              mesh=mesh)
    return cpi[:, 0, :]


def _scheme_setup(engine: ExperimentEngine, spec: TrialSpec, apps,
                  mesh=None, stratifiers: Optional[dict] = None):
    """``(truth, pp, setups)``: the (A,) census truth at the study
    config, the precision policy and, per scheme, ``(chunk_fn, draws,
    crit, tables)``; every table a device tensor. One ``segment_stats``
    summary per stratified scheme serves its ordering key and counts."""
    exps = engine.build(apps)
    stack = engine.stack(apps)
    ci = spec.config_index
    l_n = engine.num_strata
    pp = resolve_precision(spec.precision, engine.precision)
    tdt = pp.trace_dtype
    dev = engine.device
    truth = stack.truth[:, ci]
    strats = _stratifiers(spec, stratifiers)

    census, _ = sampling_plan.stack_ragged_tensors(
        [e.census(ci) for e in exps])
    census = census.to(tdt)
    p1_pool = charged_pool_fill(engine, spec, apps, mesh, stratifiers)

    def crit_of(dfs):
        return torch.as_tensor(critical_values(spec.confidence, dfs),
                               dtype=tdt, device=dev)

    setups: dict[str, tuple] = {}
    for scheme in spec.schemes:
        if scheme == SRS_DRAWS:
            n = spec.units_per_trial
            dfs = np.full(len(apps), float(n - 1) if n < 30 else np.inf)
            setups[scheme] = (_srs_chunk, n, crit_of(dfs),
                              (census, stack.n_regions))
            continue
        strat = strats[scheme]
        bank = engine.stratum_bank(strat, apps)
        if strat.pool_kind == "phase1":
            pool = p1_pool.to(tdt)
        elif bank.pool is None:
            pool = census
        else:
            pool = torch.take_along_dim(census, bank.pool, dim=1)
        key, countsf = _stratum_key_counts(
            bank.baseline.to(tdt), bank.labels, bank.valid, l_n,
            backend=engine.backend)
        order, offsets, counts = stratum_tables(bank.labels, bank.valid,
                                                l_n, counts=countsf)
        sorted_vals = torch.take_along_dim(pool, order, dim=1)
        key_order = torch.argsort(key, dim=1, stable=True)
        w_sorted = torch.take_along_dim(bank.weights, key_order, dim=1)
        n_occ = (counts > 0).sum(dim=1)
        dfs = torch.clamp_min(n_occ - n_occ // 2, 1).cpu().numpy()
        setups[scheme] = (_stratified_chunk, l_n,
                          crit_of(dfs.astype(np.float64)),
                          (sorted_vals, offsets.int(), counts.int(),
                           bank.weights.to(tdt), key_order.int(),
                           w_sorted.to(tdt), n_occ.int()))
    return truth, pp, setups


def _program_inputs(spec: TrialSpec, scheme: str, truth: torch.Tensor,
                    crit: torch.Tensor, tables) -> dict:
    """The named inputs of a scheme's chunk program (``b0`` is set per
    chunk)."""
    dev = truth.device
    return {"key": trial_key(spec, scheme, device=dev),
            "trials": torch.full((), spec.trials, dtype=torch.int64,
                                 device=dev),
            "app_ids": torch.arange(truth.shape[0], device=dev),
            "truth": truth, "crit": crit,
            **{f"t{i}": t for i, t in enumerate(tables)}}


def run_trials(engine: ExperimentEngine, spec: TrialSpec = TrialSpec(),
               apps: Optional[Sequence[str]] = None, mesh=None,
               stratifiers: Optional[dict] = None) -> TrialResult:
    """Monte-Carlo selection trials, one streaming program per scheme.

    Each scheme's chunks fold into the additive ``TrialStats`` carry on
    the engine's device; results are invariant to the chunking, bit for
    bit. ``stratifiers`` optionally maps scheme names to configured
    ``Stratifier`` instances (``run_sweep`` passes its plan's); other
    schemes come from the registry with defaults. ``mesh`` (default: the
    engine's) shards the apps and, on an ``("app", "trial")`` mesh, each
    chunk's blocks.
    """
    apps = tuple(apps or APP_NAMES)
    mesh = engine.mesh if mesh is None else mesh
    ntd = _trial_axis_size(mesh)
    kb, n_chunks = _chunk_blocks(spec, ntd)
    keep = (spec.keep_trials if spec.keep_trials is not None
            else spec.trials <= _KEEP_TRIALS_MAX)
    truth, pp, setups = _scheme_setup(engine, spec, apps, mesh, stratifiers)
    if pp.trace_dtype != torch.float32:
        raise ValueError("the trials draw float32 uniforms (as the "
                         "reference's float32 policy does); a float64 "
                         f"trace policy is not ported: {pp}")
    tdt = pp.trace_dtype
    stats: dict[str, sampling_tables.TrialStats] = {}
    dense = ({}, {}, {})
    for scheme in spec.schemes:
        chunk_fn, draws, crit, tables = setups[scheme]
        program = _streaming_program(chunk_fn, kb=kb, draws=draws,
                                     accum=pp.accum, keep=keep,
                                     n_trial=ntd)
        x = _program_inputs(spec, scheme, truth.to(tdt), crit, tables)
        st, chunks = _run_program(program, x, chunk0=0, n_chunks=n_chunks,
                                  graphs=engine.graphs, mesh=mesh)
        stats[scheme] = st.map(lambda t: t.cpu())
        if keep:
            for out, ys in zip(dense, zip(*chunks)):
                out[scheme] = torch.cat(ys, dim=1)[:, :spec.trials] \
                    .cpu().numpy()
    return TrialResult(apps=apps, spec=spec, stats=stats,
                       estimates=dense[0], errors=dense[1],
                       half_widths=dense[2])
