"""Device-resident memoizing simulation cache (app x config x region).

Counterpart of ``repro.simcpu.cache`` for the sweeps. ``MemoBank``
is the cost-accounting heart of the engine: one ``(A, C, N)`` mask and
CPI table, held as tensors on the engine's device, covering every
(application, config, region) the experiments have paid for. The ledger
is charged for misses only — a real simulation farm keeps the results it
already paid for — and because the perf model is deterministic the bank
can be filled by any batched path: the staged ``fill``, or the fused
sweep's in-place update of its picked cells (``write_selected`` on the
card, ``charge_selected`` on the host), whose accounting is ``fill``'s.

``state()`` / ``load_state()`` snapshot and restore the full bank,
cost accounting included, as numpy arrays and plain dicts: the same
``(tree, meta)`` layout as the reference's ``MemoBank.state()``, so a port
bank restored from a reference snapshot serves the same fills with no new
charges.

The serving layer's residency policy works on config columns:
``evict`` / ``spill`` / ``evict_to_cap`` clear columns of the live tables
IN PLACE (captured fused graphs read the tables where they are, so they
are never reallocated for an eviction), a spilled column parks in host
memory and ``cols_for`` restores it free on its next request, and
``absorb_picks`` re-derives one coalesced request's misses against the
tables as the earlier requests left them. Every table change bumps
``version``.

``CachedSimulator`` is a one-row view of a bank with the base simulator's
surface (``simulate``, ``simulate_cpi``, ``simulate_rfv`` and their
batched forms). Full-metric requests (``simulate``, ``simulate_rfv``,
``simulate_batch``) evaluate the perf model again each call and memoize
their CPI, so they are charged for misses only, as CPI requests are.
``census_stats`` and ``true_mean_cpi`` are analysis-only: free, and they
never fill the memo.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .perfmodel import cpi_bank, evaluate_regions_batch
from .simulator import CycleAccurateSimulator, Ledger, rfv_from_stats
from .uarch import UarchConfig
from .workload import get_population

__all__ = ["MemoBank", "CachedSimulator", "make_cached_simulator"]


class MemoBank:
    """Growable ``(A, C, N)`` mask + CPI memo with per-app ledgers."""

    def __init__(self, *, device=None):
        self.device = resolve_device(device, what="MemoBank")
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
        # column reuse bookkeeping of the serving path's eviction policy:
        # last-use tick per column (LRU order) and the host spill store
        self._col_tick: dict[int, int] = {}
        self._lru_clock = 0
        self._spill: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    @property
    def num_apps(self) -> int:
        return len(self.names)

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
        """Column indices for configs, growing the config axis as needed.

        Every fill and dispatch resolves its columns here, so this is also
        the eviction policy's touch point: each column's last-use tick
        advances (LRU order), and a spilled column is restored from the
        host spill store, free (its values were paid for)."""
        for cfg in cfgs:
            if cfg not in self._cfg_cols:
                self._cfg_cols[cfg] = len(self.configs)
                self.configs.append(cfg)
        a0, _, n0 = self.mask.shape
        self._grow(a0, len(self.configs), n0)
        cols = [self._cfg_cols[c] for c in cfgs]
        self._lru_clock += 1
        for c in cols:
            self._col_tick[c] = self._lru_clock
            if c in self._spill:
                self._unspill(c)
        return np.asarray(cols, np.int64)

    # -- eviction / host spill (the serving path's residency policy) --------
    def _unspill(self, col: int) -> None:
        """Restore one spilled column into the live tables (free)."""
        mask_c, cpi_c = self._spill.pop(col)
        a, n = mask_c.shape
        self.mask[:a, col, :n] = torch.as_tensor(mask_c).to(self.device)
        self.cpi[:a, col, :n] = torch.as_tensor(cpi_c).to(self.device)
        self.version += 1

    def resident_columns(self) -> list[int]:
        """Config columns holding memo data in the live tables (spilled
        or evicted columns are not resident until requested again)."""
        held = self.mask.any(dim=2).any(dim=0).tolist()
        return [c for c in range(len(self.configs))
                if c not in self._spill and held[c]]

    def evict(self, cols: Sequence[int], *, spill: bool = False) -> None:
        """Clear the given config columns of the live tables, in place.

        ``spill=False`` drops the data: a later request for the config
        misses again and is charged again (once, like a first fill). With
        ``spill=True`` the column's mask and values move to host memory
        first, and ``cols_for`` restores them on the next request, free,
        so ledger totals equal a never-evicted run's. Charges stay either
        way (they are the cost history); ``version`` bumps.
        """
        cols = [int(c) for c in cols if int(c) not in self._spill]
        for c in cols:
            if spill:
                self._spill[c] = (self.mask[:, c, :].cpu().numpy().copy(),
                                  self.cpi[:, c, :].cpu().numpy().copy())
            self._col_tick.pop(c, None)
        if cols:
            idx = torch.as_tensor(cols, device=self.device)
            self.mask.index_fill_(1, idx, False)
            self.cpi.index_fill_(1, idx, 0.0)
            self.version += 1

    def spill(self, cols: Sequence[int]) -> None:
        """``evict`` with host spill (see ``evict``)."""
        self.evict(cols, spill=True)

    def evict_to_cap(self, cap: int, *, policy: str = "lru",
                     spill: bool = False) -> list[int]:
        """Evict (or spill) columns until at most ``cap`` stay resident.

        ``policy="lru"`` drops the least recently used columns first;
        ``policy="charge"`` the cheapest to recompute first (lowest
        accumulated charge, LRU tie-break). Returns the evicted columns
        (empty when already within the cap).
        """
        if policy not in ("lru", "charge"):
            raise ValueError(f"unknown eviction policy {policy!r}; "
                             "choose 'lru' or 'charge'")
        resident = self.resident_columns()
        if cap < 0 or len(resident) <= cap:
            return []
        if policy == "charge":
            order = sorted(resident,
                           key=lambda c: (int(self.charges[:, c].sum()),
                                          self._col_tick.get(c, 0)))
        else:
            order = sorted(resident, key=lambda c: self._col_tick.get(c, 0))
        victims = order[:len(resident) - cap]
        self.evict(victims, spill=spill)
        return victims

    # -- the one batched fill path ------------------------------------------
    def fill(self, rows, idx, valid, cfgs: Sequence[UarchConfig], *,
             feats=None, values=None, mesh=None
             ) -> tuple[torch.Tensor, np.ndarray]:
        """Serve ``(R, C, K)`` CPI through the memo; charge misses only.

        ``rows``: (R,) app rows; ``idx``: (R, K) region indices (padding
        allowed, flagged False in ``valid``; ``None`` = all valid);
        ``feats``: (R, K, F) gathered features, evaluated in one batched
        pass for the misses (app-sharded over ``mesh`` when given) — or
        ``values``: (R, C, K) precomputed CPI.
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
            values = cpi_bank(torch.as_tensor(feats).to(dev), cfgs,
                              mesh=mesh)
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

    # -- the fused sweep's in-place update ------------------------------------
    def write_selected(self, rows: torch.Tensor, cols: torch.Tensor,
                       picks: torch.Tensor, valid: torch.Tensor,
                       miss_sel: torch.Tensor, values: torch.Tensor) -> None:
        """Write a fused sweep's selected cells into the tables in place.

        ``rows (R,)``/``cols (C,)`` device index tensors, ``picks (R, K)``
        region indices (invalid ones point anywhere in range), ``valid
        (R, K)``, ``miss_sel (R, C, K)`` newly computed cells and
        ``values (R, C, K)`` the CPI at the picks (stored on hits). Every
        pick is written (hits write back their stored value); where two
        picks of a row name one region, both write the values of the
        first valid one, so the result does not depend on which write
        lands last. No host read: the fused sweep captures this into its
        CUDA graph. The counterpart of the reference's
        ``absorb_selected``, with its accounting in ``charge_selected``.
        """
        r_n, c_n, k = miss_sel.shape
        same = (picks[:, :, None] == picks[:, None, :]) & valid[:, None, :]
        first = torch.where(same.any(dim=2), same.int().argmax(dim=2),
                            torch.arange(k, device=picks.device))
        src = first[:, None, :].expand(r_n, c_n, k)
        miss_sel = torch.gather(miss_sel, 2, src)
        values = torch.gather(values, 2, src)
        cells = (rows[:, None, None].expand(r_n, c_n, k),
                 cols[None, :, None].expand(r_n, c_n, k),
                 picks[:, None, :].expand(r_n, c_n, k))
        self.mask.index_put_(cells, self.mask[cells] | miss_sel)
        self.cpi.index_put_(cells, values.to(self.cpi.dtype))

    def charge_selected(self, rows, cols, n_miss, requested) -> None:
        """Account a fused sweep as ``fill`` would: ``n_miss (R, C)`` the
        dedup-exact newly computed counts, ``requested (R,)`` the valid
        picks times the configs (duplicates included). Charges, hit/miss
        counters and ledgers advance exactly as one equivalent ``fill``;
        ``version`` moves when a cell was written."""
        if self._account(rows, cols, n_miss, requested):
            self.version += 1

    def _account(self, rows, cols, n_miss, requested) -> bool:
        """Advance counters, charges and ledgers by one request's misses;
        whether any cell missed."""
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        n_miss = np.asarray(n_miss, np.int64)
        requested = np.asarray(requested, np.int64)
        for i, row in enumerate(rows.tolist()):
            row_miss = int(n_miss[i].sum())
            self.miss_count[row] += row_miss
            self.hit_count[row] += int(requested[i]) - row_miss
        if not n_miss.any():
            return False
        self.charges[rows[:, None], cols[None, :]] += n_miss
        for i, row in enumerate(rows.tolist()):
            ledger = self.ledgers[row]
            if ledger is not None:
                ledger.charge(int(n_miss[i].sum()))
        return True

    def absorb_selected(self, rows, cols, picks, miss_sel, values, n_miss,
                        requested) -> None:
        """Write one request's newly computed selected cells and account
        as ``fill`` would: ``picks (R, K)`` region indices, ``miss_sel
        (R, C, K)`` True where the pick was newly computed, ``values
        (R, C, K)`` the CPI at the picks (only missed cells are written),
        ``n_miss (R, C)`` / ``requested (R,)`` as in ``charge_selected``.
        """
        dev = self.device
        rows_t = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
        cols_t = torch.as_tensor(np.asarray(cols, np.int64), device=dev)
        picks = torch.as_tensor(picks).to(dev, torch.int64)
        miss_sel = torch.as_tensor(miss_sel).to(dev, torch.bool)
        values = torch.as_tensor(values).to(dev, torch.float32)
        shape = miss_sel.shape
        r3 = rows_t[:, None, None].expand(shape)[miss_sel]
        c3 = cols_t[None, :, None].expand(shape)[miss_sel]
        i3 = picks[:, None, :].expand(shape)[miss_sel]
        if r3.numel():
            self.cpi[r3, c3, i3] = values[miss_sel]
            self.mask[r3, c3, i3] = True
            self.version += 1
        self._account(rows, cols, n_miss, requested)

    def absorb_picks(self, rows, cols, picks, valid, values) -> np.ndarray:
        """Absorb one request's selected-unit results, its miss flags
        re-derived against the CURRENT tables.

        The coalescing batcher (``repro_torch.serving``) runs many requests
        in one program that reads the tables as they were before it, so
        two requests touching the same cold cell would each count it a
        miss. Called once per request in submission order, this recomputes
        ``fill``'s dedup-exact request scatter against the tables as the
        earlier requests left them, then writes and accounts through
        ``absorb_selected``: charges, counters and ledgers land as a
        serial run's. ``values (R, C, K)`` is the request's selected CPI
        (bitwise equal whether computed or stored). Returns the (R, C)
        miss counts.
        """
        dev = self.device
        rows_t = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
        cols_t = torch.as_tensor(np.asarray(cols, np.int64), device=dev)
        picks = torch.as_tensor(picks).to(dev, torch.int64)
        valid = torch.as_tensor(valid).to(dev, torch.bool)
        r_n, k = picks.shape
        c_n = cols_t.numel()
        n = self.mask.shape[2]
        requested = (valid.sum(dim=1) * c_n).cpu().numpy()
        blk = self.mask[rows_t[:, None], cols_t[None, :]]        # (R, C, N)
        picks_b = picks[:, None, :].expand(r_n, c_n, k)
        hit_sel = torch.gather(blk, 2, picks_b)
        if bool((hit_sel | ~valid[:, None, :]).all()):
            # every valid pick is present: zero misses anywhere
            n_miss = np.zeros((r_n, c_n), np.int64)
            self._account(rows, cols, n_miss, requested)
            return n_miss
        safe = torch.where(valid, picks, torch.full_like(picks, n))
        req = torch.zeros((r_n, n + 1), dtype=torch.bool, device=dev)
        req.scatter_(1, safe, True)
        miss = req[:, None, :n] & ~blk
        n_miss = miss.sum(dim=2).cpu().numpy()
        miss_sel = torch.gather(miss, 2, picks_b) & valid[:, None, :]
        self.absorb_selected(rows, cols, picks, miss_sel, values, n_miss,
                             requested)
        return n_miss

    def touch(self) -> None:
        """Mark the tables changed by a direct write (bumps ``version``)."""
        self.version += 1

    # -- snapshot / restore ---------------------------------------------------
    def state(self) -> tuple[dict, dict]:
        """``(tree, meta)`` snapshot of the bank's full mutable state, as
        numpy arrays (``tree``) and JSON-able identity (``meta``). Spilled
        columns are restored into the live tables first, so a snapshot
        always carries the whole memo."""
        for col in sorted(self._spill):
            self._unspill(col)
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
        # the snapshot carries the whole live tables: no stale spill entry
        # may restore over them later
        self._spill.clear()
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

    # -- cross-bank merge -----------------------------------------------------
    def merge(self, other: "MemoBank") -> None:
        """Fold another bank into this one.

        Apps and configs unknown here are added. Values both banks hold
        agree by determinism; charges, counters and ledgers ADD (each bank
        paid for its own misses). Apps the banks share must agree on their
        region counts (else ``ValueError``, naming them).
        """
        mismatched = [
            (name, self.n_regions[self.names.index(name)], int(n_reg))
            for name, n_reg in zip(other.names, other.n_regions)
            if name in self.names
            and self.n_regions[self.names.index(name)] != int(n_reg)]
        if mismatched:
            detail = ", ".join(f"{name!r} ({mine} regions here, {theirs} "
                               "in the other bank)"
                               for name, mine, theirs in mismatched)
            raise ValueError(
                "cannot merge MemoBanks with mismatched app universes: "
                + detail)
        for col in sorted(other._spill):
            other._unspill(col)
        for col in sorted(self._spill):
            self._unspill(col)
        row_map = []
        for name, n_reg in zip(other.names, other.n_regions):
            if name in self.names:
                row_map.append(self.names.index(name))
            else:
                row_map.append(self.add_app(name, n_reg, Ledger()))
        cols = self.cols_for(other.configs)
        cols_t = torch.as_tensor(cols, device=self.device)
        n_other = other.mask.shape[2]
        for i, row in enumerate(row_map):
            om = other.mask[i].to(self.device)          # (C_other, N_other)
            oc = other.cpi[i].to(self.device)
            mine_m = self.mask[row, cols_t, :n_other]
            mine_c = self.cpi[row, cols_t, :n_other]
            new = om & ~mine_m
            self.cpi[row, cols_t, :n_other] = torch.where(new, oc, mine_c)
            self.mask[row, cols_t, :n_other] = mine_m | om
            self.version += 1
            self.charges[row, cols] += other.charges[i]
            self.hit_count[row] += other.hit_count[i]
            self.miss_count[row] += other.miss_count[i]
            ledger = self.ledgers[row]
            if ledger is not None:
                ledger.charge(int(other.charges[i].sum()))

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

    def _fill(self, idx: torch.Tensor, cfgs: Sequence[UarchConfig],
              values=None) -> torch.Tensor:
        feats = None if values is not None else self.sim.features[idx][None]
        cpi, _ = self.bank.fill([self.row], idx[None, :], None, tuple(cfgs),
                                feats=feats, values=values)
        return cpi[0]

    def _index(self, indices) -> torch.Tensor:
        if isinstance(indices, torch.Tensor):
            return indices.reshape(-1).long().to(self.bank.device)
        return torch.as_tensor(np.atleast_1d(np.asarray(indices, np.int64)),
                               device=self.bank.device)

    def simulate(self, indices, cfg: UarchConfig) -> dict[str, torch.Tensor]:
        """All 38 Table III counters; CPI memoized, misses charged once."""
        stats = self.simulate_batch(indices, (cfg,))
        return {m: v[0] for m, v in stats.items()}

    def simulate_cpi(self, indices, cfg: UarchConfig) -> torch.Tensor:
        """(n,) CPI for one config; misses charged once."""
        return self._fill(self._index(indices), (cfg,))[0]

    def simulate_rfv(self, indices, cfg: UarchConfig
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """(cpi, float64 (n, 38) RFV) for the regions; misses charged
        once."""
        return rfv_from_stats(self.simulate(indices, cfg))

    def simulate_batch(self, indices, cfgs: Sequence[UarchConfig]
                       ) -> dict[str, torch.Tensor]:
        """Metric dict of ``(C, n)`` tensors for ``indices`` across
        ``cfgs`` in one batched pass; misses charged per config."""
        idx = self._index(indices)
        stats = evaluate_regions_batch(self.sim.features, tuple(cfgs), idx)
        self._fill(idx, tuple(cfgs), values=stats["cpi"][None])
        return stats

    def simulate_cpi_batch(self, indices, cfgs: Sequence[UarchConfig]
                           ) -> torch.Tensor:
        """(C, n) CPI across configs in one batched pass."""
        return self._fill(self._index(indices), cfgs)

    # -- ground truth (free of charge, never touches the charged memo) ------
    def census_stats(self, cfg: UarchConfig) -> dict[str, torch.Tensor]:
        return self.sim.census_stats(cfg)

    def true_mean_cpi(self, cfg: UarchConfig) -> float:
        return self.sim.true_mean_cpi(cfg)


def make_cached_simulator(app_name: str, *, seed: int = 0,
                          ledger: Optional[Ledger] = None,
                          bank: Optional[MemoBank] = None,
                          row: Optional[int] = None,
                          device=None) -> CachedSimulator:
    """A ``CachedSimulator`` of one app (a private bank unless ``bank``
    and ``row`` are given), on ``device`` (the card when None)."""
    if bank is not None:
        device = bank.device
    sim = CycleAccurateSimulator(get_population(app_name, seed=seed), ledger,
                                 device=device)
    return CachedSimulator(sim, bank=bank, row=row)
