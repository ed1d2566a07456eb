"""Step-time health monitoring with stratified sampled profiling.

Counterpart of ``repro.runtime.health``. Per-step (or per-quantum) wall
times form a population; the runtime profiles a stratified sample of
steps instead of a uniform one, and the estimators below turn those
profiles into a mean step time with a CI (the paper's estimators from the
port's ``core.sampling``). ``StragglerDetector`` flags steps slower than
median + k * IQR, the restart trigger of a fleet run; ``QuantumHealth``
is the resumable drivers' per-quantum trace.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np

from ..core.sampling import (collapsed_strata_estimate, srs_estimate,
                             stratified_estimate_from_samples)

__all__ = ["StepTimer", "StragglerDetector", "QuantumHealth",
           "stratified_steptime_estimate", "one_per_stratum_steptime_ci",
           "srs_steptime_estimate"]


@dataclasses.dataclass
class StepTimer:
    """Rolling step-duration tracker."""

    window: int = 512
    _times: deque = dataclasses.field(default_factory=lambda: deque())
    _last: Optional[float] = None

    def tick(self) -> Optional[float]:
        """Seconds since the previous tick (None on the first), recorded."""
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.record(dt)
        self._last = now
        return dt

    def record(self, dt: float) -> None:
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.popleft()

    @property
    def times(self) -> np.ndarray:
        return np.asarray(self._times)


@dataclasses.dataclass
class StragglerDetector:
    """Flag outlier steps (median + k*IQR rule over a rolling window)."""

    k: float = 3.0
    min_samples: int = 32

    def is_straggler(self, times: np.ndarray, dt: float) -> bool:
        if times.size < self.min_samples:
            return False
        q1, med, q3 = np.percentile(times, [25, 50, 75])
        return dt > med + self.k * max(q3 - q1, 1e-9)


@dataclasses.dataclass
class QuantumHealth:
    """Per-quantum wall-time monitor for the resumable sweep supervisor.

    The checkpointed drivers report ``(quantum_index, seconds)`` after
    every quantum; durations feed a rolling ``StepTimer`` window and the
    ``StragglerDetector``, so a supervised run ends with a postmortem
    trace: which quanta ran, how long, and which straggled.
    """

    timer: StepTimer = dataclasses.field(default_factory=StepTimer)
    detector: StragglerDetector = dataclasses.field(
        default_factory=StragglerDetector)
    quanta: list = dataclasses.field(default_factory=list)
    stragglers: list = dataclasses.field(default_factory=list)

    def record(self, quantum: int, seconds: float) -> bool:
        """Fold one quantum's duration in; True if it straggled."""
        slow = self.detector.is_straggler(self.timer.times, seconds)
        self.timer.record(seconds)
        self.quanta.append({"quantum": int(quantum),
                            "seconds": float(seconds),
                            "straggler": bool(slow)})
        if slow:
            self.stragglers.append((int(quantum), float(seconds)))
        return slow

    def summary(self) -> dict:
        """Totals for reports: quanta recorded, wall seconds, stragglers."""
        total = float(sum(q["seconds"] for q in self.quanta))
        return {"quanta": len(self.quanta), "seconds": total,
                "stragglers": len(self.stragglers)}


def stratified_steptime_estimate(times, strata_labels, *, num_strata: int,
                                 confidence: float = 0.95):
    """Mean step time + CI from a stratified sample of profiled steps."""
    return stratified_estimate_from_samples(
        np.asarray(times), np.asarray(strata_labels),
        num_strata=num_strata, confidence=confidence)


def one_per_stratum_steptime_ci(times_per_stratum, weights, *,
                                confidence: float = 0.95):
    """Collapsed-strata CI when only one profiled step per stratum exists
    (the cheapest profiling budget, paper Section V.A.3)."""
    return collapsed_strata_estimate(np.asarray(times_per_stratum),
                                     np.asarray(weights),
                                     confidence=confidence)


def srs_steptime_estimate(times, *, confidence: float = 0.95):
    """Mean step time + CI from a simple random sample of steps."""
    return srs_estimate(np.asarray(times), confidence=confidence)
