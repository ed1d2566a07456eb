"""Checkpointed, fault-tolerant drivers over ``run_sweep``/``run_trials``.

Counterpart of ``repro.experiments.resumable``. Long sweep campaigns are
restartable batch jobs: this module adds restart boundaries ("quanta")
at the paths' natural grain, and a killed-and-resumed run is the same
run, bit for bit:

* **Sweeps** (``run_sweep_resumable``): a quantum is one (app block x
  config block) sub-sweep through the ordinary ``run_sweep`` (fused or
  staged). Selection, fills and estimates are pure functions of (engine
  build, spec, block), and the memo charges misses only, so any
  blocking's union of fills equals the unblocked run's.
* **Trials** (``run_trials_resumable``): a quantum is one segment of
  chunks of one scheme. PRNG blocks are pure functions of (seed, scheme,
  block, app), so the streaming program replays any chunk range through
  its ``chunk0`` offset; segment ``TrialStats`` merge additively.

After every quantum the driver snapshots the ``MemoBank``, the partial
results and the cursor through ``repro_torch.runtime.checkpoint`` (the
reference's format: a directory either package wrote is accepted or
refused by the other exactly as by its writer). Restore ORDER matters:
the engine is rebuilt (re-paying its phase-1 fill), then
``MemoBank.load_state`` OVERWRITES all accounting with the snapshot's, so
nothing is charged twice.

The supervisors (``supervise_sweep``/``supervise_trials``) wrap a driver
in the retry loop: catch ``HostLoss`` (real or injected through
``repro_torch.runtime.faults``), shrink the device pool, re-plan, rebuild
the engine, restore the latest checkpoint and continue, with
``QuantumHealth`` recording per-quantum wall times for the
``FleetReport``. ``devices=None`` is a pool of the engine's one device;
over a pool of more devices each attempt plans a mesh over the healthy
pool (``runtime.elastic``; the pool may name one device more than once),
builds it and resumes from the checkpoint, whose blocking does not depend
on the mesh, so an elastic re-mesh resumes its own checkpoints.

Selection policies that draw host randomness (``random``/``rankedset``)
draw per app block, so their picks depend on the blocking; the paper's
deterministic policies (``centroid``/``mean``) do not.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.sampling import tables as sampling_tables
from ..runtime.checkpoint import (latest_step, restore_checkpoint,
                                  save_checkpoint)
from ..runtime.elastic import ElasticRunner, build_mesh
from ..runtime.faults import FaultPlan, HostLoss
from ..runtime.health import QuantumHealth
from ..simcpu import APP_NAMES
from .engine import ExperimentEngine
from .montecarlo import (_KEEP_TRIALS_MAX, TRIAL_BLOCK, TrialResult,
                         TrialSpec, _chunk_blocks, _program_inputs,
                         _run_program, _scheme_setup, _streaming_program,
                         _trial_axis_size)
from .sweep import ResultsTable, SweepRow, SweepSpec, run_sweep

__all__ = ["FleetReport", "run_sweep_resumable", "run_trials_resumable",
           "supervise_sweep", "supervise_trials"]


def _run_quanta(engine, directory, run_id, snapshot, restore, quanta,
                run_quantum, *, injector, monitor, keep) -> None:
    """The quantum loop both drivers share: restore the latest checkpoint
    of this run (if any), then run, snapshot and publish each remaining
    quantum, firing the injector's lifecycle points."""
    start = 0
    if latest_step(directory) is not None:
        template, _ = snapshot()
        tree, extra = restore_checkpoint(directory, template,
                                         expect={"run": run_id})
        engine.memo.load_state(tree["memo"], extra["memobank"],
                               universe=engine.configs)
        restore(tree)
        start = int(extra["next_quantum"])
    if injector is not None:
        injector.on_resume(start)

    for q in range(start, len(quanta)):
        t0 = time.perf_counter()
        run_quantum(quanta[q])
        if injector is not None:
            injector.quantum_computed()
        tree, meta = snapshot()
        save_checkpoint(directory, q, tree,
                        extra={"run": run_id, "memobank": meta,
                               "next_quantum": q + 1},
                        keep=keep,
                        fault_hook=None if injector is None
                        else injector.hook)
        if monitor is not None:
            monitor(q, time.perf_counter() - t0)
        if injector is not None:
            injector.quantum_checkpointed()


# ------------------------------------------------------------------ sweeps
def run_sweep_resumable(engine: ExperimentEngine, spec: SweepSpec,
                        directory, *, app_block: int = 1,
                        config_block: Optional[int] = None,
                        injector=None, mesh=None,
                        monitor: Optional[Callable] = None,
                        keep: int = 3) -> ResultsTable:
    """``run_sweep`` with restart boundaries at app/config blocks.

    The (apps x configs) grid is cut into quanta of ``app_block`` apps x
    ``config_block`` configs (default: all configs a quantum); each runs
    through ``run_sweep`` (fused or staged per ``spec.fused``) and is
    followed by one atomic checkpoint of the memo, the partial result
    matrices and the cursor in ``directory``. A checkpoint there of the
    SAME run (scheme, policy, apps, configs, seed, path, blocking;
    validated manifest-first) resumes at its cursor; another run's raises
    ``ManifestMismatch`` before anything is loaded.

    ``injector`` is a ``FaultInjector`` threaded through the quantum
    lifecycle; ``monitor(quantum, seconds)`` feeds the supervisor's
    health trace. ``mesh`` (default: the engine's) shards each quantum's
    sweep. Returns the table an uninterrupted run of this blocking gives.
    """
    if spec.trials is not None:
        raise ValueError(
            "run_sweep_resumable checkpoints the sweep grid only; run the "
            "Monte-Carlo study through run_trials_resumable")
    mesh = engine.mesh if mesh is None else mesh
    apps = tuple(spec.apps)
    cfg_is = (tuple(range(len(engine.configs)))
              if spec.config_indices is None
              else tuple(int(i) for i in spec.config_indices))
    a_n, c_n = len(apps), len(cfg_is)
    ab = max(1, int(app_block))
    cb = c_n if config_block is None else max(1, int(config_block))
    quanta = [(a0, min(a0 + ab, a_n), c0, min(c0 + cb, c_n))
              for a0 in range(0, a_n, ab) for c0 in range(0, c_n, cb)]

    exps = engine.build(apps)                   # deterministic rebuild
    # the memo's config axis is fixed up front, so every checkpoint of
    # this run (and of its resumed continuations) has the same shapes
    engine.memo.cols_for(tuple(engine.configs[i] for i in cfg_is))
    truth = torch.stack([e.truth for e in exps]).cpu().numpy()[
        :, list(cfg_is)]

    run_id = {"kind": "sweep", "scheme": spec.scheme,
              "policy": spec.policy, "apps": list(apps),
              "config_indices": list(cfg_is),
              "selection_seed": int(spec.selection_seed),
              "fused": bool(spec.fused),
              "app_block": ab, "config_block": cb}

    res = {"ests": np.full((a_n, c_n), np.nan),
           "errs": np.full((a_n, c_n), np.nan),
           "margins": np.full((a_n, c_n), np.nan),
           "n_units": np.zeros(a_n, np.int64)}

    def snapshot():
        tree, meta = engine.memo.state()
        return {"memo": tree, "results": dict(res)}, meta

    def restore(tree):
        res.update(tree["results"])

    def run_quantum(quantum):
        a0, a1, c0, c1 = quantum
        sub = dataclasses.replace(spec, apps=apps[a0:a1],
                                  config_indices=cfg_is[c0:c1])
        table = run_sweep(engine, sub, mesh=mesh)
        for i in range(a1 - a0):
            for j in range(c1 - c0):
                row = table.rows[i * (c1 - c0) + j]
                res["ests"][a0 + i, c0 + j] = row.estimate
                res["errs"][a0 + i, c0 + j] = row.err_pct
                if row.margin_pct is not None:
                    res["margins"][a0 + i, c0 + j] = row.margin_pct
                res["n_units"][a0 + i] = row.n_units

    _run_quanta(engine, directory, run_id, snapshot, restore, quanta,
                run_quantum, injector=injector, monitor=monitor, keep=keep)

    srs = spec.plan is None
    rows = []
    for a, name in enumerate(apps):
        for j, cix in enumerate(cfg_is):
            rows.append(SweepRow(
                app=name, scheme=spec.scheme, config_index=int(cix),
                estimate=float(res["ests"][a, j]),
                truth=float(truth[a, j]),
                err_pct=float(res["errs"][a, j]),
                n_units=int(res["n_units"][a]),
                margin_pct=float(res["margins"][a, j]) if srs else None))
    return ResultsTable(rows)


# ------------------------------------------------------------------ trials
def _trial_quanta(spec: TrialSpec, segment_trials: Optional[int] = None):
    """``(kb, n_chunks, seg_chunks, quanta)`` of a resumable trials run:
    PRNG blocks a chunk, chunks, chunks a segment (``segment_trials``
    rounded up to whole chunks; all of them when None), and its quanta,
    one ``(scheme, first chunk, chunks)`` per scheme and segment, in run
    order."""
    kb, n_chunks = _chunk_blocks(spec)
    seg_chunks = (n_chunks if segment_trials is None
                  else max(1, -(-int(segment_trials) // (kb * TRIAL_BLOCK))))
    segments = [(c0, min(seg_chunks, n_chunks - c0))
                for c0 in range(0, n_chunks, seg_chunks)]
    return kb, n_chunks, seg_chunks, [(scheme, c0, nc)
                                      for scheme in spec.schemes
                                      for (c0, nc) in segments]


def run_trials_resumable(engine: ExperimentEngine,
                         spec: TrialSpec, directory, *,
                         apps: Optional[Sequence[str]] = None,
                         segment_trials: Optional[int] = None,
                         injector=None, mesh=None,
                         monitor: Optional[Callable] = None,
                         keep: int = 3) -> TrialResult:
    """``run_trials`` with restart boundaries at chunk segments.

    A quantum is one (scheme, chunk segment) cell: ``segment_trials``
    trials' worth of chunks (default: the scheme's whole run), run by the
    scheme's streaming program from its ``chunk0`` offset, so its chunks
    are bitwise the same chunks of an uninterrupted run. Segment
    ``TrialStats`` merge additively into the running accumulator (integer
    leaves exact; float moments add by segment, identically in every
    replay of the same blocking); the per-trial arrays, when kept, slot
    into their trial range. Checkpoints carry the accumulators, the
    per-trial partials, the memo and the cursor; ``injector`` and
    ``monitor`` as in ``run_sweep_resumable``.

    The blocking is part of the run's identity, so it does not depend on
    the attempt's ``mesh`` (default: the engine's): an elastic re-mesh
    would otherwise refuse its own checkpoints. The trial axis is sharded
    only where it divides the blocks of a chunk; elsewhere the attempt
    runs unsharded. Either way every leaf and dense array is the
    unsharded run's, bit for bit.
    """
    apps = tuple(apps or APP_NAMES)
    mesh = engine.mesh if mesh is None else mesh
    kb, n_chunks, seg_chunks, quanta = _trial_quanta(spec, segment_trials)
    ntd = _trial_axis_size(mesh)
    prog_mesh = mesh if kb % ntd == 0 else None
    ntd = _trial_axis_size(prog_mesh)
    keep_dense = (spec.keep_trials if spec.keep_trials is not None
                  else spec.trials <= _KEEP_TRIALS_MAX)

    truth, pp, setups = _scheme_setup(engine, spec, apps, mesh)
    if pp.trace_dtype != torch.float32:
        raise ValueError("the trials draw float32 uniforms (as the "
                         "reference's float32 policy does); a float64 "
                         f"trace policy is not ported: {pp}")
    tdt = np.float32
    a_n = len(apps)
    t_pad = n_chunks * kb * TRIAL_BLOCK

    run_id = {"kind": "trials", "apps": list(apps),
              "schemes": list(spec.schemes), "trials": int(spec.trials),
              "units_per_trial": int(spec.units_per_trial),
              "config_index": int(spec.config_index),
              "seed": int(spec.seed), "confidence": float(spec.confidence),
              "precision": [str(pp.trace), str(pp.accum)],
              "kb": int(kb), "seg_chunks": int(seg_chunks),
              "keep": bool(keep_dense)}

    state = {"stats": {s: sampling_tables.trial_stats_init(
        (a_n,), accum_dtype=pp.accum_dtype, device="cpu")
        for s in spec.schemes}}
    if keep_dense:
        state["dense"] = {s: {"est": np.zeros((a_n, t_pad), tdt),
                              "err": np.zeros((a_n, t_pad), tdt),
                              "half": np.zeros((a_n, t_pad), tdt)}
                          for s in spec.schemes}

    def snapshot():
        tree, meta = engine.memo.state()
        return {"memo": tree, **state}, meta

    def restore(tree):
        state["stats"] = tree["stats"]
        if keep_dense:
            state["dense"] = tree["dense"]

    def run_quantum(quantum):
        scheme, c0, nc = quantum
        chunk_fn, draws, crit, tables = setups[scheme]
        program = _streaming_program(chunk_fn, kb=kb, draws=draws,
                                     accum=pp.accum, keep=keep_dense,
                                     n_trial=ntd)
        x = _program_inputs(spec, scheme, truth.to(pp.trace_dtype), crit,
                            tables)
        st, chunks = _run_program(program, x, chunk0=c0, n_chunks=nc,
                                  graphs=engine.graphs, mesh=prog_mesh)
        state["stats"][scheme] = sampling_tables.trial_stats_merge(
            state["stats"][scheme], st.map(lambda t: t.cpu()))
        if keep_dense:
            off = c0 * kb * TRIAL_BLOCK
            for name, ys in zip(("est", "err", "half"), zip(*chunks)):
                arr = torch.cat(ys, dim=1).cpu().numpy()
                state["dense"][scheme][name][:, off:off + arr.shape[1]] = arr

    _run_quanta(engine, directory, run_id, snapshot, restore, quanta,
                run_quantum, injector=injector, monitor=monitor, keep=keep)

    estimates, errors, halves = {}, {}, {}
    if keep_dense:
        for s in spec.schemes:
            estimates[s] = state["dense"][s]["est"][:, :spec.trials]
            errors[s] = state["dense"][s]["err"][:, :spec.trials]
            halves[s] = state["dense"][s]["half"][:, :spec.trials]
    return TrialResult(apps=apps, spec=spec, stats=dict(state["stats"]),
                       estimates=estimates, errors=errors,
                       half_widths=halves)


# -------------------------------------------------------------- supervisor
@dataclasses.dataclass
class FleetReport:
    """Postmortem of one supervised (fault-tolerant) run.

    ``attempts`` records each driver attempt (device count, mesh shape,
    outcome); ``mesh_history`` the re-plans; ``quanta`` / ``stragglers``
    the per-quantum health trace from ``QuantumHealth``.
    """

    attempts: list
    mesh_history: list
    quanta: list
    stragglers: list

    @property
    def restarts(self) -> int:
        """Restart count: attempts beyond the first."""
        return max(0, len(self.attempts) - 1)


def _supervise(run_attempt, *, faults: Optional[FaultPlan],
               max_restarts: int, mesh_kind: str, app_devices: int = 1,
               devices: Optional[Sequence] = None):
    """The elastic retry loop shared by both supervisors.

    Each attempt plans a mesh over the current healthy pool, builds it on
    those devices (``elastic.build_mesh``) and calls ``run_attempt(mesh,
    injector, monitor)``. A ``HostLoss`` shrinks the pool by
    ``devices_lost`` (never below 1) and retries; the driver's checkpoint
    restore carries the run forward. One injector spans all attempts, so
    each planned fault fires once. ``devices=None`` is a pool of the
    engine's one device.
    """
    pool = [None] if devices is None else list(devices)
    injector = None if faults is None else faults.injector()
    runner = ElasticRunner(mesh_kind=mesh_kind, app_devices=app_devices)
    health = QuantumHealth()
    attempts: list[dict] = []
    for attempt in range(max_restarts + 1):
        n = len(pool)
        if n > 1:
            plan = runner.on_pool_change(n)
            mesh = build_mesh(plan, pool)
            shape = tuple(plan.shape)
        else:
            # one device needs no mesh: the unsharded dispatch
            mesh, shape = None, (1,)
            runner.history.append({"n_devices": 1, "shape": shape})
        record = {"attempt": attempt, "n_devices": n, "mesh_shape": shape}
        try:
            result = run_attempt(mesh, injector, health.record)
            record["outcome"] = "completed"
            attempts.append(record)
            return result, FleetReport(attempts=attempts,
                                       mesh_history=list(runner.history),
                                       quanta=list(health.quanta),
                                       stragglers=list(health.stragglers))
        except HostLoss as loss:
            record["outcome"] = "host_loss"
            record["error"] = str(loss)
            attempts.append(record)
            lost = max(0, int(loss.devices_lost))
            pool = pool[:max(1, n - lost)]
    raise RuntimeError(
        f"supervised run did not complete within {max_restarts} restarts")


def supervise_sweep(make_engine: Callable, spec: SweepSpec, directory, *,
                    faults: Optional[FaultPlan] = None, app_block: int = 1,
                    config_block: Optional[int] = None,
                    max_restarts: int = 8, keep: int = 3,
                    devices: Optional[Sequence] = None
                    ) -> tuple[ResultsTable, FleetReport]:
    """Run a checkpointed sweep under the supervisor.

    ``make_engine(mesh)`` builds a fresh ``ExperimentEngine`` for each
    attempt (``mesh`` is None on one device; state comes from the
    checkpoint in ``directory``); ``faults`` optionally injects a
    deterministic failure schedule. Returns ``(ResultsTable,
    FleetReport)``.
    """
    def attempt(mesh, injector, monitor):
        engine = make_engine(mesh)
        return run_sweep_resumable(
            engine, spec, directory, app_block=app_block,
            config_block=config_block, injector=injector, mesh=mesh,
            monitor=monitor, keep=keep)
    return _supervise(attempt, faults=faults, max_restarts=max_restarts,
                      mesh_kind="app", devices=devices)


def supervise_trials(make_engine: Callable, spec: TrialSpec, directory, *,
                     apps: Optional[Sequence[str]] = None,
                     faults: Optional[FaultPlan] = None,
                     segment_trials: Optional[int] = None,
                     max_restarts: int = 8, app_devices: int = 1,
                     keep: int = 3, devices: Optional[Sequence] = None
                     ) -> tuple[TrialResult, FleetReport]:
    """Run a checkpointed Monte-Carlo study under the supervisor: the
    contract of ``supervise_sweep`` over ``run_trials_resumable``.
    Returns ``(TrialResult, FleetReport)``."""
    def attempt(mesh, injector, monitor):
        engine = make_engine(mesh)
        return run_trials_resumable(
            engine, spec, directory, apps=apps,
            segment_trials=segment_trials, injector=injector, mesh=mesh,
            monitor=monitor, keep=keep)
    return _supervise(attempt, faults=faults, max_restarts=max_restarts,
                      mesh_kind="app_trial", app_devices=app_devices,
                      devices=devices)
