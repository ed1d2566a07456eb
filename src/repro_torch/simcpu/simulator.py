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
from .perfmodel import evaluate_regions_batch, stats_matrix
from .uarch import UarchConfig
from .workload import REGION_LEN_INSTR, AppPopulation, get_population

__all__ = ["Ledger", "CycleAccurateSimulator", "make_simulator",
           "rfv_from_stats"]


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
        self._features: Optional[torch.Tensor] = None

    @property
    def features(self) -> torch.Tensor:
        """(N, F) float32 region features on the simulator's device (a
        copy, made once: the population's cached array is never
        shared)."""
        if self._features is None:
            self._features = torch.tensor(self.pop.features,
                                          dtype=torch.float32,
                                          device=self.device)
        return self._features

    def simulate(self, indices, cfg: UarchConfig) -> dict[str, torch.Tensor]:
        """All 38 Table III counters for the regions; charges the ledger."""
        idx = torch.as_tensor(indices, dtype=torch.int64,
                              device=self.device).reshape(-1)
        self.ledger.charge(idx.numel())
        stats = evaluate_regions_batch(self.features, (cfg,), idx)
        return {m: v[0] for m, v in stats.items()}

    def simulate_cpi(self, indices, cfg: UarchConfig) -> torch.Tensor:
        return self.simulate(indices, cfg)["cpi"]

    def simulate_rfv(self, indices, cfg: UarchConfig
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(cpi, rfv) for the regions, the phase-1 output: float32 CPI and
        the float64 ``(n, 38)`` RFV matrix (``core.features.build_rfv``'s
        column order)."""
        return rfv_from_stats(self.simulate(indices, cfg))

    # -- ground truth (free of charge: analysis-only, not part of the flow) --
    def census_stats(self, cfg: UarchConfig) -> dict[str, torch.Tensor]:
        """Every metric of every region (never charged)."""
        stats = evaluate_regions_batch(self.features, (cfg,))
        return {m: v[0] for m, v in stats.items()}

    def true_mean_cpi(self, cfg: UarchConfig) -> float:
        """Census mean CPI: the float32 mean of the census, as the
        reference's ``census_stats(cfg)["cpi"].mean()`` takes it."""
        return float(self.census_stats(cfg)["cpi"].cpu().numpy().mean())


def rfv_from_stats(stats: dict[str, torch.Tensor]
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cpi, rfv) from a metric dict of ``(n,)`` tensors, the RFV matrix
    in float64 as the reference's ``build_rfv`` gives it."""
    return stats["cpi"], stats_matrix(stats).double()


def make_simulator(app_name: str, *, seed: int = 0,
                   ledger: Optional[Ledger] = None,
                   device=None) -> CycleAccurateSimulator:
    return CycleAccurateSimulator(get_population(app_name, seed=seed), ledger,
                                  device=device)
