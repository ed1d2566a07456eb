"""Deterministic, seedable fault injection for the resumable sweep fleet.

Counterpart of ``repro.runtime.faults``; pure Python and numpy, so a
``FaultPlan.random(seed, ...)`` here gives the reference's events for the
same seed.

A fleet-scale claim ("a killed run resumes bitwise-identically") is only
testable if failures are *reproducible*. This module makes every failure
scenario a value: a ``FaultPlan`` is a frozen schedule of ``FaultEvent``
records — kill after quantum ``k``, kill before its checkpoint lands,
corrupt the checkpoint tmp-dir mid-write, optionally shrinking the
device pool — derived from a seed, so the same plan replays the same
crash sequence forever.

The ``FaultInjector`` is the live consumer the resumable drivers
(``repro_torch.experiments.resumable``) thread through their quantum loop:

* ``quantum_computed()``   — after a quantum's results exist in memory
  but BEFORE its checkpoint: a ``kill_dirty`` event here loses the
  uncheckpointed work (the resume must recompute the quantum);
* ``hook(stage, tmpdir)``  — the ``save_checkpoint`` fault hook: a
  ``corrupt`` event truncates the half-written ``arrays.npz`` and dies
  mid-write (the atomic-rename contract must keep the previous
  checkpoint restorable);
* ``quantum_checkpointed()`` — after the checkpoint is published: a
  ``kill`` event here is the clean crash (resume skips the quantum).

Faults surface as ``HostLoss`` — the supervisor loop catches it, shrinks
the healthy pool by ``devices_lost``, re-plans the mesh and restores.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

__all__ = ["FAULT_KINDS", "FaultEvent", "FaultInjector", "FaultPlan",
           "HostLoss"]

# the three failure modes of a checkpointed quantum loop, in lifecycle
# order: crash before the checkpoint (work lost), crash inside the
# checkpoint write (tmp dir corrupt), crash after publish (clean)
FAULT_KINDS = ("kill_dirty", "corrupt", "kill")


class HostLoss(RuntimeError):
    """A simulated host/process death mid-run.

    ``devices_lost`` is how many devices leave the healthy pool with the
    host (0 = the process dies but its devices come back on restart);
    ``quantum`` records where the plan fired, for postmortems.
    """

    def __init__(self, message: str, *, devices_lost: int = 0,
                 quantum: Optional[int] = None):
        super().__init__(message)
        self.devices_lost = int(devices_lost)
        self.quantum = quantum


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled failure: ``kind`` fires at quantum ``quantum``.

    ``kind`` is one of ``FAULT_KINDS``; ``devices_lost`` shrinks the
    supervisor's device pool when the event fires (elastic re-mesh).
    """

    kind: str
    quantum: int
    devices_lost: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}")
        if self.quantum < 0:
            raise ValueError(f"quantum must be >= 0, got {self.quantum}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A reproducible failure schedule (events sorted by quantum).

    Build explicitly from events, or randomized-but-deterministic via
    ``FaultPlan.random(seed, n_quanta)`` — the test suite's source of
    "killed at >= 3 randomized boundaries".
    """

    events: tuple[FaultEvent, ...]

    def __post_init__(self):
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda e: e.quantum)))

    @classmethod
    def random(cls, seed: int, n_quanta: int, *, kills: int = 3,
               kinds: Sequence[str] = FAULT_KINDS,
               max_devices_lost: int = 0) -> "FaultPlan":
        """``kills`` failures at distinct random quanta in
        ``[0, n_quanta)``, kinds drawn from ``kinds``, each losing
        ``0..max_devices_lost`` devices — all a pure function of
        ``seed``."""
        rng = np.random.default_rng(seed)
        n_ev = max(0, min(int(kills), int(n_quanta)))
        quanta = sorted(rng.choice(int(n_quanta), size=n_ev,
                                   replace=False).tolist())
        events = []
        for q in quanta:
            kind = kinds[int(rng.integers(len(kinds)))]
            lost = (int(rng.integers(max_devices_lost + 1))
                    if max_devices_lost > 0 else 0)
            events.append(FaultEvent(kind=kind, quantum=int(q),
                                     devices_lost=lost))
        return cls(events=tuple(events))

    def injector(self) -> "FaultInjector":
        """A fresh live consumer of this plan (supervisor-owned: one
        injector survives across restart attempts so each event fires
        exactly once)."""
        return FaultInjector(self)


class FaultInjector:
    """Fires a ``FaultPlan``'s events at the driver's lifecycle points.

    Events are consumed strictly in order; an event fires at the first
    matching lifecycle point whose quantum counter has reached its
    scheduled quantum (so a plan built for more quanta than a run has
    simply never fires its tail). ``fired`` records the consumed events
    for assertions and postmortems.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.pending: list[FaultEvent] = list(plan.events)
        self.fired: list[FaultEvent] = []
        self.quantum = 0

    def _due(self, kind: str) -> Optional[FaultEvent]:
        if self.pending:
            ev = self.pending[0]
            if ev.kind == kind and ev.quantum <= self.quantum:
                return ev
        return None

    def _fire(self, ev: FaultEvent, why: str) -> None:
        self.pending.pop(0)
        self.fired.append(ev)
        raise HostLoss(
            f"injected {ev.kind} scheduled at quantum {ev.quantum} ({why})",
            devices_lost=ev.devices_lost, quantum=ev.quantum)

    def on_resume(self, quantum: int) -> None:
        """Re-align the quantum counter after a restore (the supervisor
        calls this with the restored driver's next quantum)."""
        self.quantum = int(quantum)

    def quantum_computed(self) -> None:
        """Lifecycle point: quantum results exist, checkpoint not yet
        written — ``kill_dirty`` loses the uncheckpointed work here."""
        ev = self._due("kill_dirty")
        if ev is not None:
            self._fire(ev, "uncheckpointed quantum lost")

    def hook(self, stage: str, tmpdir) -> None:
        """``save_checkpoint`` fault hook: a ``corrupt`` event truncates
        the half-written array archive in the tmp dir and dies mid-write
        — atomic publish must keep the previous checkpoint intact."""
        ev = self._due("corrupt")
        if ev is not None and stage == "arrays":
            p = Path(tmpdir) / "arrays.npz"
            raw = p.read_bytes()
            p.write_bytes(raw[:max(1, len(raw) // 2)])
            self._fire(ev, "crashed mid-checkpoint-write, tmp truncated")

    def quantum_checkpointed(self) -> None:
        """Lifecycle point: checkpoint published — ``kill`` is the clean
        crash (resume continues from the very next quantum). Advances
        the quantum counter."""
        ev = self._due("kill")
        self.quantum += 1
        if ev is not None:
            self._fire(ev, "killed after checkpoint publish")
