"""Device-resident memoizing simulation cache (app x config x region).

Counterpart of ``repro.simcpu.cache`` for the staged sweep. ``MemoBank``
is the cost-accounting heart of the engine: one ``(A, C, N)`` mask and
CPI table, held as tensors on the engine's device, covering every
(application, config, region) the experiments have paid for. The ledger
is charged for misses only — a real simulation farm keeps the results it
already paid for — and because the perf model is deterministic the bank
can be filled by any batched path.

``state()`` / ``load_state()`` snapshot and restore the full bank,
cost accounting included, as numpy arrays and plain dicts: the same
``(tree, meta)`` layout as the reference's ``MemoBank.state()``, so a port
bank restored from a reference snapshot serves the same fills with no new
charges.

``CachedSimulator`` is a one-row view of a bank with the base simulator's
surface (``simulate_cpi``, ``simulate_cpi_batch``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .perfmodel import cpi_bank
from .simulator import CycleAccurateSimulator, Ledger
from .uarch import UarchConfig

__all__ = ["MemoBank", "CachedSimulator"]


class MemoBank:
    """Growable ``(A, C, N)`` mask + CPI memo with per-app ledgers."""

    def __init__(self, *, device="cpu"):
        self.device = torch.device(device)
        self.names: list[str] = []
        self.ledgers: list[Optional[Ledger]] = []
        self.n_regions: list[int] = []
        self.hit_count: list[int] = []      # per-app requested-and-cached
        self.miss_count: list[int] = []     # per-app newly charged
        self._cfg_cols: dict[UarchConfig, int] = {}
        self.configs: list[UarchConfig] = []
        self.mask = torch.zeros((0, 0, 0), dtype=torch.bool,
                                device=self.device)
        self.cpi = torch.zeros((0, 0, 0), dtype=torch.float32,
                               device=self.device)
        self.charges = np.zeros((0, 0), np.int64)   # (A, C) miss counts
        # bumped on every table mutation (content or shape)
        self.version = 0

    def _grow(self, a: int, c: int, n: int) -> None:
        a0, c0, n0 = self.mask.shape
        if (a, c, n) == (a0, c0, n0):
            return
        mask = torch.zeros((a, c, n), dtype=torch.bool, device=self.device)
        cpi = torch.zeros((a, c, n), dtype=torch.float32, device=self.device)
        charges = np.zeros((a, c), np.int64)
        mask[:a0, :c0, :n0] = self.mask
        cpi[:a0, :c0, :n0] = self.cpi
        charges[:a0, :c0] = self.charges
        self.mask, self.cpi, self.charges = mask, cpi, charges
        self.version += 1

    def add_app(self, name: str, n_regions: int,
                ledger: Optional[Ledger] = None) -> int:
        """Register an app row; returns its row index."""
        row = len(self.names)
        self.names.append(name)
        self.ledgers.append(ledger)
        self.n_regions.append(int(n_regions))
        self.hit_count.append(0)
        self.miss_count.append(0)
        _, c0, n0 = self.mask.shape
        self._grow(row + 1, c0, max(n0, int(n_regions)))
        return row

    def cols_for(self, cfgs: Sequence[UarchConfig]) -> np.ndarray:
        """Column indices for configs, growing the config axis as needed."""
        for cfg in cfgs:
            if cfg not in self._cfg_cols:
                self._cfg_cols[cfg] = len(self.configs)
                self.configs.append(cfg)
        a0, _, n0 = self.mask.shape
        self._grow(a0, len(self.configs), n0)
        return np.asarray([self._cfg_cols[c] for c in cfgs], np.int64)

    # -- the one batched fill path ------------------------------------------
    def fill(self, rows, idx, valid, cfgs: Sequence[UarchConfig], *,
             feats=None, values=None) -> tuple[torch.Tensor, np.ndarray]:
        """Serve ``(R, C, K)`` CPI through the memo; charge misses only.

        ``rows``: (R,) app rows; ``idx``: (R, K) region indices (padding
        allowed, flagged False in ``valid``; ``None`` = all valid);
        ``feats``: (R, K, F) gathered features, evaluated in one batched
        pass for the misses — or ``values``: (R, C, K) precomputed CPI.
        Returns the CPI tensor and the (R, C) newly-charged counts.
        """
        dev = self.device
        rows_np = np.asarray(rows, np.int64)
        idx = torch.as_tensor(idx, dtype=torch.int64).to(dev)
        valid = torch.ones(idx.shape, dtype=torch.bool, device=dev) \
            if valid is None else torch.as_tensor(valid).to(dev, torch.bool)
        cols_np = self.cols_for(cfgs)
        rows_t = torch.as_tensor(rows_np, device=dev)
        cols_t = torch.as_tensor(cols_np, device=dev)
        n = self.mask.shape[2]
        r_n, k = idx.shape
        c_n = cols_np.size
        sub = (rows_t[:, None], cols_t[None, :])

        rr = torch.arange(r_n, device=dev)[:, None].expand(idx.shape)
        req = torch.zeros((r_n, n), dtype=torch.bool, device=dev)
        req[rr[valid], idx[valid]] = True
        miss = req[:, None, :] & ~self.mask[sub]           # (R, C, N)
        n_miss = miss.sum(dim=2).cpu().numpy()              # (R, C)
        requested = (valid.sum(dim=1) * c_n).cpu().numpy()  # incl. dups
        for i, row in enumerate(rows_np.tolist()):
            self.miss_count[row] += int(n_miss[i].sum())
            self.hit_count[row] += int(requested[i] - n_miss[i].sum())

        gather = idx[:, None, :].expand(r_n, c_n, k)
        if not n_miss.any():
            return torch.gather(self.cpi[sub], 2, gather), n_miss

        if values is None:
            values = cpi_bank(torch.as_tensor(feats).to(dev), cfgs)
        values = torch.as_tensor(values).to(dev, torch.float32)

        dense = torch.zeros((r_n, c_n, n), dtype=torch.float32, device=dev)
        r3 = rr[:, None, :].expand(r_n, c_n, k)
        c3 = torch.arange(c_n, device=dev)[None, :, None].expand(r_n, c_n, k)
        v3 = valid[:, None, :].expand(r_n, c_n, k)
        dense[r3[v3], c3[v3], gather[v3]] = values[v3]
        self.cpi[sub] = torch.where(miss, dense, self.cpi[sub])
        self.mask[sub] = self.mask[sub] | miss
        self.charges[rows_np[:, None], cols_np[None, :]] += n_miss
        self.version += 1
        for i, row in enumerate(rows_np.tolist()):
            ledger = self.ledgers[row]
            if ledger is not None:
                ledger.charge(int(n_miss[i].sum()))
        return torch.gather(self.cpi[sub], 2, gather), n_miss

    # -- snapshot / restore ---------------------------------------------------
    def state(self) -> tuple[dict, dict]:
        """``(tree, meta)`` snapshot of the bank's full mutable state, as
        numpy arrays (``tree``) and JSON-able identity (``meta``)."""
        regions = [0 if lg is None else int(lg.regions_simulated)
                   for lg in self.ledgers]
        instr = [0 if lg is None else int(lg.instructions_simulated)
                 for lg in self.ledgers]
        tree = {
            "mask": self.mask.cpu().numpy().copy(),
            "cpi": self.cpi.cpu().numpy().copy(),
            "charges": self.charges.copy(),
            "hit_count": np.asarray(self.hit_count, np.int64),
            "miss_count": np.asarray(self.miss_count, np.int64),
            "ledger_regions": np.asarray(regions, np.int64),
            "ledger_instr": np.asarray(instr, np.int64),
            "version": np.asarray(self.version, np.int64),
        }
        meta = {"names": list(self.names),
                "n_regions": [int(n) for n in self.n_regions],
                "configs": [repr(c) for c in self.configs]}
        return tree, meta

    def prepare_restore(self, meta: dict, *, universe: Sequence = ()
                        ) -> np.ndarray:
        """Validate a snapshot's identity against this bank and align its
        config columns (configs resolved by repr from ``universe`` and the
        bank's own). Returns the local column of each snapshot column;
        raises ``ValueError`` on any identity drift."""
        if list(meta["names"]) != self.names:
            raise ValueError(
                f"memobank snapshot is for apps {meta['names']}, "
                f"this bank holds {self.names}")
        if [int(n) for n in meta["n_regions"]] != \
                [int(n) for n in self.n_regions]:
            raise ValueError("memobank snapshot region counts differ")
        by_repr = {repr(c): c for c in list(self.configs) + list(universe)}
        missing = [r for r in meta["configs"] if r not in by_repr]
        if missing:
            raise ValueError(
                f"snapshot configs not resolvable from the given universe:"
                f" {missing}")
        snap = set(meta["configs"])
        extra = [repr(c) for c in self.configs if repr(c) not in snap]
        if extra:
            raise ValueError(
                f"bank holds config columns the snapshot does not cover "
                f"(restore would leave them inconsistent): {extra}")
        return self.cols_for([by_repr[r] for r in meta["configs"]])

    def load_state(self, tree: dict, meta: dict, *,
                   universe: Sequence = ()) -> None:
        """Overwrite this bank's state with a ``state()`` snapshot (this
        port's or the reference's). All cost accounting is replaced by the
        snapshot's; ``version`` restores as saved unless this bank already
        moved past it, when it moves forward instead."""
        cols = self.prepare_restore(meta, universe=universe)
        cols_t = torch.as_tensor(cols, device=self.device)
        self.mask[:, cols_t, :] = torch.as_tensor(
            np.asarray(tree["mask"], bool)).to(self.device)
        self.cpi[:, cols_t, :] = torch.as_tensor(
            np.asarray(tree["cpi"], np.float32)).to(self.device)
        self.charges[:, cols] = np.asarray(tree["charges"], np.int64)
        self.hit_count = [int(x) for x in np.asarray(tree["hit_count"])]
        self.miss_count = [int(x) for x in np.asarray(tree["miss_count"])]
        regions = np.asarray(tree["ledger_regions"])
        instr = np.asarray(tree["ledger_instr"])
        for i, ledger in enumerate(self.ledgers):
            if ledger is not None:
                ledger.regions_simulated = int(regions[i])
                ledger.instructions_simulated = int(instr[i])
        saved = int(np.asarray(tree["version"]))
        self.version = saved if saved >= self.version else self.version + 1

    def total_charges(self) -> int:
        return int(self.charges.sum())


class CachedSimulator:
    """``CycleAccurateSimulator`` with a row view over a ``MemoBank``:
    the ledger is charged only for cache misses."""

    def __init__(self, sim: CycleAccurateSimulator, *,
                 bank: Optional[MemoBank] = None, row: Optional[int] = None):
        self.sim = sim
        if bank is None:
            bank = MemoBank(device=sim.device)
            row = bank.add_app(sim.pop.spec.name, sim.pop.n_regions,
                               sim.ledger)
        self.bank = bank
        self.row = int(row)

    @property
    def hits(self) -> int:
        return self.bank.hit_count[self.row]

    @property
    def misses(self) -> int:
        return self.bank.miss_count[self.row]

    @property
    def pop(self):
        return self.sim.pop

    @property
    def ledger(self) -> Ledger:
        return self.sim.ledger

    def _fill(self, indices, cfgs: Sequence[UarchConfig]) -> torch.Tensor:
        idx = torch.as_tensor(np.atleast_1d(np.asarray(indices, np.int64)),
                              device=self.bank.device)
        feats = self.sim.features[idx][None]
        cpi, _ = self.bank.fill([self.row], idx[None, :], None, tuple(cfgs),
                                feats=feats)
        return cpi[0]

    def simulate_cpi(self, indices, cfg: UarchConfig) -> torch.Tensor:
        """(n,) CPI for one config; misses charged once."""
        return self._fill(indices, (cfg,))[0]

    def simulate_cpi_batch(self, indices, cfgs: Sequence[UarchConfig]
                           ) -> torch.Tensor:
        """(C, n) CPI across configs in one batched pass."""
        return self._fill(indices, cfgs)
