"""``SweepService``: a request-coalescing estimation front end.

Counterpart of ``repro.serving.service``. Many ``SweepSpec``/``TrialSpec``
requests are served against ONE persistent engine and ``MemoBank`` on the
card. Requests enqueue through ``submit``; each ``tick`` drains the queue
and

1. groups coalescible sweep requests by program shape and runs each
   group as one stacked fused dispatch (``run_coalesced_sweeps``);
   non-coalescible sweeps run serially in submission order;
2. dedups identical Monte-Carlo requests: one ``run_trials`` per
   distinct (spec, apps), with the charged phase-1 fill replayed per
   duplicate (a pure cache hit), so counters and ledgers equal the serial
   schedule's;
3. enforces the memo residency cap: ``memo_cap`` bounds the resident
   config columns through ``MemoBank.evict_to_cap`` (LRU or by charge,
   dropped or spilled to host memory) after the tick's dispatches.

Cache accounting: repeat configs across requests are hits against the
shared bank; an evicted column is charged again exactly once when asked
for again; a spilled column comes back free. The service is synchronous
and single-threaded: "concurrency" is queue depth per tick, which the
coalescer turns into one dispatch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Union

import numpy as np

from ..experiments.engine import ExperimentEngine
from ..experiments.montecarlo import (TrialResult, TrialSpec,
                                      charged_pool_fill, run_trials)
from ..experiments.sweep import ResultsTable, SweepSpec
from .batcher import run_coalesced_sweeps
from .coalesce import coalesce_key, coalescible, prepare_sweep

__all__ = ["ServiceStats", "SweepRequest", "SweepService"]


@dataclasses.dataclass
class SweepRequest:
    """One queued request and its lifecycle timestamps and result."""

    req_id: int
    spec: Union[SweepSpec, TrialSpec]
    apps: Optional[tuple]                 # TrialSpec carries no app axis
    submitted: float
    completed: Optional[float] = None
    result: Union[ResultsTable, TrialResult, None] = None

    @property
    def latency_s(self) -> Optional[float]:
        """Submit-to-completion wall seconds (None while pending)."""
        return (None if self.completed is None
                else self.completed - self.submitted)


@dataclasses.dataclass
class ServiceStats:
    """Aggregate service counters (``SweepService.stats``)."""

    completed: int
    ticks: int
    dispatches: int            # launches: groups + serial runs
    coalesced_requests: int    # requests served by a stacked dispatch
    latency_p50_s: float
    latency_p95_s: float
    throughput_rps: float      # completed requests / busy seconds
    cache_hit_rate: float      # bank hits / requested units, lifetime
    peak_resident_cols: int    # max resident memo columns at tick ends
    evicted_cols: int


class SweepService:
    """Request-coalescing sweep/trial service over one shared engine.

    ``engine=None`` builds ``ExperimentEngine.auto()`` (an ``("app",)``
    mesh over the cards when there is more than one).
    ``memo_cap`` bounds the resident memo columns (``None``: unbounded);
    ``evict_policy`` is ``"lru"`` or ``"charge"``; ``spill=True`` parks
    evicted columns in host memory (free restore) instead of dropping
    them (charged again on re-request). ``mesh`` (default: the engine's)
    shards every dispatch's app axis.
    """

    def __init__(self, engine: Optional[ExperimentEngine] = None, *,
                 mesh=None, memo_cap: Optional[int] = None,
                 evict_policy: str = "lru", spill: bool = True):
        self.engine = engine if engine is not None \
            else ExperimentEngine.auto()
        self.mesh = self.engine.mesh if mesh is None else mesh
        self.memo_cap = memo_cap
        self.evict_policy = evict_policy
        self.spill = spill
        self._pending: list[SweepRequest] = []
        self._done: dict[int, SweepRequest] = {}
        self._next_id = 0
        self._ticks = 0
        self._busy_s = 0.0
        self._dispatches = 0
        self._coalesced = 0
        self._peak_resident = len(self.engine.memo.resident_columns())
        self._evicted = 0

    # ------------------------------------------------------------- queue
    def submit(self, spec: Union[SweepSpec, TrialSpec],
               apps: Optional[Sequence[str]] = None) -> int:
        """Enqueue a request; returns its id (``result(id)`` after a
        tick). ``apps`` is required for ``TrialSpec`` requests (the spec
        carries no app axis) and ignored for sweeps."""
        if isinstance(spec, TrialSpec) and apps is None:
            raise ValueError("TrialSpec requests need apps=(...): the "
                             "spec carries no app axis")
        req = SweepRequest(req_id=self._next_id, spec=spec,
                           apps=None if apps is None else tuple(apps),
                           submitted=time.perf_counter())
        self._next_id += 1
        self._pending.append(req)
        return req.req_id

    def result(self, req_id: int):
        """A completed request's result (``KeyError`` while it is still
        pending: call ``tick``/``drain`` first)."""
        return self._done[req_id].result

    @property
    def pending(self) -> int:
        """Requests waiting for the next tick."""
        return len(self._pending)

    # -------------------------------------------------------------- tick
    def tick(self) -> int:
        """Serve everything queued: coalesce and dispatch sweeps, dedup
        and run trials, then enforce the memo cap. Returns the number of
        requests completed this tick."""
        batch, self._pending = self._pending, []
        if not batch:
            return 0
        t0 = time.perf_counter()

        sweeps = [r for r in batch if isinstance(r.spec, SweepSpec)]
        trials = [r for r in batch if not isinstance(r.spec, SweepSpec)]

        if sweeps:
            tables = run_coalesced_sweeps(
                self.engine, [r.spec for r in sweeps], mesh=self.mesh)
            for req, table in zip(sweeps, tables):
                req.result = table
            self._count_sweep_dispatches(sweeps)

        # identical trial studies dedup to ONE run; duplicates replay the
        # charged fill (a pure hit) for serial-equal accounting
        by_study: dict = {}
        for req in trials:
            by_study.setdefault((req.spec, req.apps), []).append(req)
        for (spec, apps), reqs in by_study.items():
            result = run_trials(self.engine, spec, apps=apps,
                                mesh=self.mesh)
            self._dispatches += len(spec.schemes)
            for _ in reqs[1:]:
                charged_pool_fill(self.engine, spec, apps, mesh=self.mesh)
            for req in reqs:
                req.result = result

        now = time.perf_counter()
        for req in batch:
            req.completed = now
            self._done[req.req_id] = req
        self._busy_s += now - t0
        self._ticks += 1
        self._enforce_cap()
        return len(batch)

    def drain(self) -> int:
        """Tick until the queue is empty; returns requests completed."""
        total = 0
        while self._pending:
            total += self.tick()
        return total

    def _count_sweep_dispatches(self, sweeps) -> None:
        """Launch and coalescing counters from the tick's sweeps (a group
        of K counts one dispatch serving K requests)."""
        groups: dict = {}
        serial = 0
        for req in sweeps:
            if coalescible(req.spec):
                key = coalesce_key(prepare_sweep(self.engine, req.spec))
                groups[key] = groups.get(key, 0) + 1
            else:
                serial += 1
        for size in groups.values():
            self._dispatches += 1
            if size > 1:
                self._coalesced += size
        self._dispatches += serial

    def _enforce_cap(self) -> None:
        """Apply ``memo_cap`` through the bank's eviction policy and
        sample the residency for the peak statistic."""
        memo = self.engine.memo
        if self.memo_cap is not None:
            self._evicted += len(memo.evict_to_cap(
                self.memo_cap, policy=self.evict_policy, spill=self.spill))
        self._peak_resident = max(self._peak_resident,
                                  len(memo.resident_columns()))

    # ------------------------------------------------------------- stats
    def stats(self) -> ServiceStats:
        """Aggregate latency, throughput and cache counters so far."""
        lats = [r.latency_s for r in self._done.values()]
        memo = self.engine.memo
        hits = float(sum(memo.hit_count))
        units = hits + float(sum(memo.miss_count))
        return ServiceStats(
            completed=len(self._done),
            ticks=self._ticks,
            dispatches=self._dispatches,
            coalesced_requests=self._coalesced,
            latency_p50_s=float(np.percentile(lats, 50)) if lats else 0.0,
            latency_p95_s=float(np.percentile(lats, 95)) if lats else 0.0,
            throughput_rps=(len(self._done) / self._busy_s
                            if self._busy_s > 0 else 0.0),
            cache_hit_rate=hits / units if units else 0.0,
            peak_resident_cols=self._peak_resident,
            evicted_cols=self._evicted)
