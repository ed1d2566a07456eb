"""Simulation API over the synthetic populations + a cost ledger.

Counterpart of ``repro.simcpu.simulator``. ``CycleAccurateSimulator``
stands in for a detailed simulator farm: it evaluates regions of one
application on a configuration and charges the ``Ledger`` (the paper's
cost unit: one 1 M-instruction region simulation).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import resolve_device
from .perfmodel import evaluate_regions_batch
from .uarch import UarchConfig
from .workload import REGION_LEN_INSTR, AppPopulation, get_population

__all__ = ["Ledger", "CycleAccurateSimulator", "make_simulator"]


@dataclasses.dataclass
class Ledger:
    """Accounting of simulation cost (regions x configs actually run)."""

    regions_simulated: int = 0
    instructions_simulated: int = 0

    def charge(self, n_regions: int) -> None:
        self.regions_simulated += int(n_regions)
        self.instructions_simulated += int(n_regions) * REGION_LEN_INSTR

    def reset(self) -> None:
        self.regions_simulated = 0
        self.instructions_simulated = 0


class CycleAccurateSimulator:
    """Detailed-simulation stand-in for one application, on ``device``
    (the card when None)."""

    def __init__(self, pop: AppPopulation, ledger: Optional[Ledger] = None,
                 *, device=None):
        self.pop = pop
        self.ledger = ledger if ledger is not None else Ledger()
        self.device = resolve_device(device, what="CycleAccurateSimulator")

    @property
    def features(self) -> torch.Tensor:
        """(N, F) float32 region features on the simulator's device."""
        return torch.as_tensor(self.pop.features, dtype=torch.float32,
                               device=self.device)

    def simulate(self, indices, cfg: UarchConfig) -> dict[str, torch.Tensor]:
        """All 38 Table III counters for the regions; charges the ledger."""
        idx = torch.as_tensor(indices, dtype=torch.int64,
                              device=self.device).reshape(-1)
        self.ledger.charge(idx.numel())
        stats = evaluate_regions_batch(self.features, (cfg,), idx)
        return {m: v[0] for m, v in stats.items()}

    def simulate_cpi(self, indices, cfg: UarchConfig) -> torch.Tensor:
        return self.simulate(indices, cfg)["cpi"]


def make_simulator(app_name: str, *, seed: int = 0,
                   ledger: Optional[Ledger] = None,
                   device=None) -> CycleAccurateSimulator:
    return CycleAccurateSimulator(get_population(app_name, seed=seed), ledger,
                                  device=device)
