"""The fused sweep: selection -> memo update -> estimates, one program.

Counterpart of ``repro.experiments.fused``. The staged sweep runs four
host-synchronised stages — ``plan_selection_bank``, ``MemoBank.fill``,
the stratum tables and the estimator — and each waits on the host. Here
the whole chain is one traced function (``_make_traced``):

* the selection context is built through the engine's own stratum
  summary (``_segment_sums_counts``, the ``segment_stats`` kernel on the
  card);
* the policy's picks drive a miss-only memo update: a dense ``(A, N)``
  request scatter gives dedup-exact miss counts, the perf model
  (``cpi_bank``) evaluates the picks' features, and the picked cells are
  written into ``MemoBank.mask`` / ``.cpi`` in place
  (``MemoBank.write_selected``; the reference donates an ``(A, C, N)``
  block instead, which the port, whose tables already live on the card,
  does not need);
* ``Estimator.estimate_stage`` turns the picked CPI into estimates.

Only the ``(A, C)`` miss counts and the ``(A, C)`` estimates come home;
``MemoBank.charge_selected`` advances charges, counters and ledgers as
``fill`` would.

On a CUDA device the function runs once eagerly (its result is that
sweep's) and is then captured as a ``torch.cuda.CUDAGraph``, once per
(plan, precision policy, apps, configs) of an engine; later sweeps copy
their per-call inputs (uniforms, truth, memo rows and columns) into the
graph's static buffers and replay it. The graph reads the engine's
resident tensors in place (the ``StratumBank``, the population features,
the memo tables) and is kept in ``engine.graphs``, so it is freed with
the engine. ``program_captures()`` counts captures, the counterpart of
the reference's recompile guard. On the CPU the same function runs
eagerly every time. The fused and staged paths call the same torch
functions in the same order, so their picks, estimates and memo tables
are equal bit for bit.

Over an ``("app",)`` mesh (``run_fused_sweep(..., mesh=)``) each shard
runs the function on its block of the padded app axis, on its device,
read-only: the memo cells of its rows and the sweep's configs are checked
out into a block there (the reference's sharded checkout), and the picked
cells are written into the memo after all shards have run. On the card
each shard has its own graph, kept by the engine with its lanes' inputs.
Each lane computes what it computes unsharded, so a sharded sweep equals
the unsharded one, and the staged sharded one, bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.precision import PrecisionPolicy, resolve_precision
from ..core.sampling import plan as sampling_plan
from ..simcpu.perfmodel import config_matrix, cpi_bank
from .engine import _segment_sums_counts

__all__ = ["fused_sweep_program", "run_fused_sweep", "program_captures"]

# CUDA graphs captured in this process: the fused sweeps' and the
# coalesced groups' (``repro_torch.serving.batcher``)
_captures = {"fused": 0, "group": 0}


def program_captures() -> int:
    """CUDA graphs captured by the fused sweep programs in this process."""
    return _captures["fused"]


@functools.lru_cache(maxsize=None)
def fused_sweep_program(plan: sampling_plan.SamplingPlan,
                        precision: PrecisionPolicy, backend: str = "auto",
                        write: bool = True):
    """The selection -> fill -> estimate function of one plan, estimates
    in the policy's trace dtype, the stratum summary through ``backend``
    (the engine's kernel route), kept per (plan, policy, route, write).

    ``traced(memo, bank, feats_pop, cm, x)`` reads the plan's
    ``StratumBank``, the (A, N, F) population features, the (C, 14)
    config matrix, the memo's tables and the per-call inputs ``x``
    (``uniforms`` (A, L) or None, ``truth`` (A, C), memo ``rows`` (A,)
    and ``cols`` (C,)); with ``write`` it updates the tables in place
    (without, it only reads them: a coalesced group's requests are
    absorbed one by one afterwards). It returns a dict of tensors:
    ``est``, ``err`` (A, C); ``valid``, ``picks`` (A, L); ``n_miss``
    (A, C); ``miss_sel`` and ``cpi_sel`` (A, C, L), which picks were
    computed and the CPI at the picks; and the stratum
    summary it computed, ``sums`` and ``counts`` (A, L), for checks of
    the kernel inside the program."""
    dt = precision.trace_dtype

    def traced(memo, bank, feats_pop, cm, x: dict) -> dict:
        summary = {}

        def summarize(labels, valid, num_strata, values):
            sums, counts = _segment_sums_counts(labels, valid, num_strata,
                                                values, backend=backend)
            summary.update(sums=sums, counts=counts)
            return sums, counts

        ctx = sampling_plan.build_selection_context(
            bank, summarize=summarize, uniforms=x["uniforms"])
        local = plan.policy(ctx)
        valid = ctx.counts > 0
        picks = local if bank.pool is None \
            else torch.take_along_dim(bank.pool, local, dim=1)
        picks = torch.where(valid, picks, torch.zeros_like(picks))

        rows, cols = x["rows"], x["cols"]
        a_n, n_strata = picks.shape
        c_n = cols.shape[0]
        mask_blk = memo.mask[rows[:, None], cols[None, :]]     # (A, C, N)
        n_memo = mask_blk.shape[2]
        # the dense request scatter of fill: a region picked twice counts
        # once; invalid picks land in a scratch column that is dropped
        safe = torch.where(valid, picks, torch.full_like(picks, n_memo))
        req = torch.zeros((a_n, n_memo + 1), dtype=torch.bool,
                          device=picks.device)
        req.scatter_(1, safe, True)
        miss = req[:, None, :n_memo] & ~mask_blk
        n_miss = miss.sum(dim=2)

        ar = torch.arange(a_n, device=picks.device)[:, None]
        computed = cpi_bank(feats_pop[ar, picks], cm)           # (A, C, L)
        picks_b = picks[:, None, :].expand(a_n, c_n, n_strata)
        stored = memo.cpi[rows[:, None, None], cols[None, :, None], picks_b]
        miss_sel = torch.gather(miss, 2, picks_b)
        cpi_sel = torch.where(miss_sel, computed, stored)
        if write:
            memo.write_selected(rows, cols, picks, valid, miss_sel, cpi_sel)

        est, err = plan.estimator.estimate_stage(
            cpi_sel.to(dt), valid, bank.weights.to(dt), x["truth"].to(dt))
        return {"est": est, "err": err, "valid": valid, "picks": picks,
                "n_miss": n_miss, "miss_sel": miss_sel, "cpi_sel": cpi_sel,
                "sums": summary["sums"],
                "counts": summary["counts"]}

    return traced


class _Graph:
    """One captured sweep: the resident tensors it reads in place, static
    buffers for the per-call inputs, and its outputs. ``kind`` names the
    capture counter it adds to."""

    def __init__(self, traced, memo, bank, feats_pop, cm, x: dict, *,
                 kind: str = "fused"):
        self.resident = (bank, feats_pop, memo.mask, memo.cpi, cm)
        self.static = {k: None if v is None else v.clone()
                       for k, v in x.items()}
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = traced(memo, bank, feats_pop, cm, self.static)
        _captures[kind] += 1

    def reads(self, memo) -> bool:
        """Whether the memo's tables are still the ones captured (they
        are reallocated when the memo grows)."""
        return self.resident[2] is memo.mask and self.resident[3] is memo.cpi

    def replay(self, x: dict) -> dict:
        for k, v in x.items():
            if v is not None:
                self.static[k].copy_(v)
        self.graph.replay()
        return self.out


class _Block:
    """A shard's checkout of the memo: the ``(A_s, C, N)`` mask and CPI
    cells of its rows and the sweep's configs, read by the function as
    the memo's tables (with rows and columns ``0..A_s`` and ``0..C``)."""

    def __init__(self, mask: torch.Tensor, cpi: torch.Tensor):
        self.mask, self.cpi = mask, cpi


class _Shard:
    """One shard of a sharded fused program: its lanes' bank and features
    and the config matrix on its device and, on the card, its graph
    (which reads them, and its block, in place)."""

    def __init__(self, bank, feats, cm):
        self.bank, self.feats, self.cm = bank, feats, cm
        self.block: _Block | None = None
        self.graph: _Graph | None = None

    def run(self, traced, mask: torch.Tensor, cpi: torch.Tensor, x: dict,
            kind: str) -> dict:
        if self.graph is not None and self.block.mask.shape == mask.shape:
            self.block.mask.copy_(mask)
            self.block.cpi.copy_(cpi)
            return self.graph.replay(x)
        self.block = _Block(mask, cpi)
        out = traced(self.block, self.bank, self.feats, self.cm, x)
        if mask.is_cuda:
            self.graph = _Graph(traced, self.block, self.bank, self.feats,
                                self.cm, x, kind=kind)
        return out


def run_sharded(memo, traced, bank, feats, cfgs, x: dict, mesh, shards,
                *, kind: str = "fused") -> tuple[dict, list]:
    """The read-only ``traced`` over an ``("app",)`` mesh: the app axis of
    ``bank``, ``feats`` and the per-call ``x`` padded to the mesh by edge
    replication and cut into contiguous shards, each run on its device
    against its checkout of the memo (``x["rows"]`` x ``x["cols"]``).
    ``shards``: the ``_Shard`` list of an earlier call with the same
    bank, features and configs (its graphs replay), or None. Returns the
    outputs on the memo's device, in app order, padding dropped, and the
    shard list to keep."""
    from ..distributed.appaxis import (gather, lane_shards, mesh_grid,
                                       on_shard, pad_app_axis, to_device,
                                       tree_map)
    grid = mesh_grid(mesh)[:, :1]
    a_n = bank.weights.shape[0]
    parts = lane_shards(grid, a_n)

    def pad(t):
        return pad_app_axis(t, len(grid))

    if shards is None:
        pbank, pfeats = tree_map(pad, bank), pad(feats)
        shards = [_Shard(
            to_device(tree_map(lambda t: t[p.lanes], pbank), p.device),
            to_device(pfeats[p.lanes], p.device),
            config_matrix(cfgs, device=p.device)) for p in parts]
    rows = pad(x["rows"])
    cols = x["cols"]
    calls = {k: None if v is None else pad(v)
             for k, v in x.items() if k not in ("rows", "cols")}
    outs = []
    for p, shard in zip(parts, shards):
        dev = p.device
        with on_shard(p):
            sub = (rows[p.lanes][:, None], cols[None, :])
            mask = to_device(memo.mask[sub], dev)
            cpi = to_device(memo.cpi[sub], dev)
            xs = {k: None if v is None else to_device(v[p.lanes], dev)
                  for k, v in calls.items()}
            xs["rows"] = torch.arange(mask.shape[0], device=dev)
            xs["cols"] = torch.arange(mask.shape[1], device=dev)
            outs.append(shard.run(traced, mask, cpi, xs, kind))
    return gather(outs, memo.device, a_n), shards


def run_fused_sweep(engine, spec, exps, stack, cfgs, truth, mesh=None):
    """One fused sweep: the plan's ``StratumBank``, the program's single
    dispatch, then the host accounting of its miss counts.

    ``exps`` are the built apps (the bank comes from the engine's cache
    of them), ``truth`` the (A, C) census means of ``cfgs``. Returns
    ``(ests, errs, valid, weights)`` as device tensors, keeps the
    program's outputs in ``engine.fused_outputs`` (on the card, the
    graph's static outputs: valid until its next replay) and records the
    ``fused=True`` dispatch marker (``sampling_plan.last_sweep_dispatch``).
    ``mesh`` (an ``("app",)`` mesh) runs the read-only program once per
    shard (``run_sharded``; one graph a shard on the card, kept by the
    engine) and then writes the picked cells into the memo.
    """
    del exps                      # the engine's cached bank is built on them
    plan = spec.plan
    memo = engine.memo
    dev = memo.device
    bank = engine.stratum_bank(plan.stratifier, spec.apps)
    a_n, n_strata = bank.weights.shape
    pp = resolve_precision(engine.precision, PrecisionPolicy.host_parity())
    traced = fused_sweep_program(plan, pp, engine.backend, mesh is None)
    uniforms = None
    if plan.policy.uses_uniforms:
        # the staged policy's float64 draws from the selection seed, so
        # that fused picks equal staged picks bit for bit
        uniforms = torch.as_tensor(
            np.random.default_rng(spec.selection_seed).random(
                (a_n, n_strata)), device=dev)
    cols = memo.cols_for(cfgs)
    x = {"uniforms": uniforms, "truth": truth,
         "rows": torch.as_tensor(stack.rows, device=dev),
         "cols": torch.as_tensor(cols, device=dev)}
    captured = dev.type == "cuda"
    if mesh is not None:
        key = ("fused_mesh", traced, tuple(spec.apps), tuple(cfgs), mesh)
        out, engine.graphs[key] = run_sharded(
            memo, traced, bank, stack.feats, cfgs, x, mesh,
            engine.graphs.get(key))
        memo.write_selected(x["rows"], x["cols"], out["picks"],
                            out["valid"], out["miss_sel"], out["cpi_sel"])
        return _finish(engine, out, stack, cols, cfgs, pp, bank,
                       captured=captured, in_place=False)
    key = ("fused", traced, tuple(spec.apps), tuple(cfgs))
    graph = engine.graphs.get(key) if captured else None
    if graph is not None and not graph.reads(memo):
        # the memo grew: every fused graph reads its old tables
        for k in [k for k, g in engine.graphs.items()
                  if k[0] == "fused" and not g.reads(memo)]:
            del engine.graphs[k]
        graph = None
    if graph is None:
        # on the card the eager run warms every kernel up (library loads,
        # cached device queries) and is this sweep's result; the capture
        # then records the same launches without running them
        cm = config_matrix(cfgs, device=dev)
        out = traced(memo, bank, stack.feats, cm, x)
        if captured:
            engine.graphs[key] = _Graph(traced, memo, bank, stack.feats, cm,
                                        x)
    else:
        out = graph.replay(x)
    return _finish(engine, out, stack, cols, cfgs, pp, bank,
                   captured=captured, in_place=True)


def _finish(engine, out, stack, cols, cfgs, pp, bank, *, captured: bool,
            in_place: bool):
    """The host accounting of a fused sweep's outputs and its marker."""
    memo = engine.memo
    a_n, n_strata = bank.weights.shape
    engine.fused_outputs = out
    n_miss = out["n_miss"].cpu().numpy()
    requested = (out["valid"].sum(dim=1) * len(cfgs)).cpu().numpy()
    memo.charge_selected(stack.rows, cols, n_miss, requested)
    sampling_plan._record_sweep_dispatch(
        batch_shape=(a_n, len(cfgs)), num_strata=n_strata,
        x64=pp.trace_dtype == torch.float64, backend=memo.device.type,
        fused=True, in_place=in_place, captured=captured)
    return out["est"], out["err"], out["valid"], bank.weights
