"""App-axis request coalescing: K same-shape sweeps, ONE fused dispatch.

Counterpart of ``repro.serving.batcher``. ``run_coalesced_sweeps`` takes a
tick's sweep requests and runs each program-shape group
(``coalesce_key``) as one stacked fused program: the members' banks and
population features concatenate along the app axis (the program is
data-parallel over apps), and the one program computes every member's
selection, CPI at the picks and estimates. 32 queued sweeps of one shape
cost one dispatch, not 32.

Why coalesced results equal serial ``run_sweep`` calls bit for bit:

* **Estimates**: each request's lanes are rows of the same batched
  operations a serial dispatch runs (the perf model, the stratum
  summaries and the estimator work lane by lane, in an order no other
  lane changes). Where two requests of a group share a cold memo cell,
  each lane computes its CPI, which is bitwise the value the serial
  second request would read back.
* **Accounting**: the group program runs the fused function in its
  read-only form (``fused_sweep_program(..., write=False)``): it reads the
  tables as they were before it and writes nothing, so its per-request
  miss counts, which would charge a shared cold cell twice, are dropped.
  ``MemoBank.absorb_picks`` then writes each request's picks and
  re-derives its misses against the tables in submission order, so
  charges, counters and ledgers equal the serial schedule's. (The
  serial fused sweep writes its picked cells inside its program; a group
  that did so would leave ``absorb_picks`` nothing to charge.)

Groups run one after another, so a later group reads every earlier
group's fills, as serial order would. Non-coalescible requests (SRS,
staged, riding trials) and groups of one run through ``run_sweep``.

Each group's stacked inputs, and on the card its captured CUDA graph
(reading the memo's tables in place, as the fused sweep's graphs do), are
kept per group composition in ``engine.groups``, at most
``GROUP_CACHE_CAP`` of them, so they are freed with the engine;
``program_captures()`` counts the captures.

Under an ``("app",)`` mesh (``mesh=``, default the engine's) a group's
stacked lanes are cut into the mesh's shards as a fused sweep's are
(``fused.run_sharded``: each shard reads its checkout of the memo, one
graph a shard on the card); only without a mesh does the group's graph
read the memo's tables in place, the reference's rule. The members are
absorbed in submission order either way.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.precision import PrecisionPolicy, resolve_precision
from ..core.sampling import plan as sampling_plan
from ..experiments import fused
from ..experiments.sweep import (ResultsTable, _warn_partial_coverage,
                                 assemble_rows, run_sweep)
from ..simcpu.perfmodel import config_matrix
from .coalesce import coalesce_key, coalescible, prepare_sweep

__all__ = ["run_coalesced_sweeps", "program_captures", "GROUP_CACHE_CAP"]

GROUP_CACHE_CAP = 16


def program_captures() -> int:
    """CUDA graphs captured by coalesced group programs in this process."""
    return fused._captures["group"]


class _Group:
    """One group composition's stacked inputs (held with the members'
    banks and features, whose identities key it) and its graph."""

    def __init__(self, preps):
        self.members = tuple((p.bank, p.stack.feats) for p in preps)

        def cat(field):
            parts = [getattr(p.bank, field) for p in preps]
            return None if parts[0] is None else torch.cat(parts)
        self.bank = sampling_plan.StratumBank(
            labels=cat("labels"), valid=cat("valid"),
            weights=cat("weights"), baseline=cat("baseline"),
            feats=cat("feats"), centroids=cat("centroids"),
            pool=cat("pool"))
        self.feats = torch.cat([p.stack.feats for p in preps])
        self.graph = None
        self.shards = None           # fused._Shard list under a mesh

    def holds(self, preps) -> bool:
        return len(preps) == len(self.members) and all(
            b is p.bank and f is p.stack.feats
            for (b, f), p in zip(self.members, preps))


def _group(engine, traced, preps) -> _Group:
    """The engine's cached ``_Group`` of this composition (made, and the
    oldest dropped beyond ``GROUP_CACHE_CAP``, on a miss)."""
    key = (traced, preps[0].cfgs,
           tuple(id(p.bank) for p in preps),
           tuple(id(p.stack.feats) for p in preps))
    group = engine.groups.get(key)
    if group is None or not group.holds(preps):
        group = _Group(preps)
        if len(engine.groups) >= GROUP_CACHE_CAP:
            engine.groups.pop(next(iter(engine.groups)))
        engine.groups[key] = group
    return group


def _dispatch_group(engine, members, mesh=None) -> list:
    """ONE stacked fused dispatch for a same-key group (one per shard of
    ``mesh``), then each member's absorb in submission order; returns
    ``(request_index, ResultsTable)`` pairs in member order."""
    preps = [p for _, p in members]
    plan, cfgs = preps[0].spec.plan, preps[0].cfgs
    memo = engine.memo
    dev = memo.device
    pp = resolve_precision(engine.precision, PrecisionPolicy.host_parity())
    traced = fused.fused_sweep_program(plan, pp, engine.backend, False)
    group = _group(engine, traced, preps)
    a_sizes = [p.num_apps for p in preps]
    rows_cat = np.concatenate([p.stack.rows for p in preps])
    cols = memo.cols_for(cfgs)
    uniforms = None
    if preps[0].uniforms is not None:
        uniforms = torch.as_tensor(
            np.concatenate([p.uniforms for p in preps]), device=dev)
    x = {"uniforms": uniforms, "truth": torch.cat([p.truth for p in preps]),
         "rows": torch.as_tensor(rows_cat, device=dev),
         "cols": torch.as_tensor(cols, device=dev)}
    captured = dev.type == "cuda"
    if mesh is not None:
        out, group.shards = fused.run_sharded(
            memo, traced, group.bank, group.feats, cfgs, x, mesh,
            group.shards, kind="group")
    else:
        if group.graph is not None and not group.graph.reads(memo):
            group.graph = None          # the memo grew: the tables moved
        if group.graph is None:
            cm = config_matrix(cfgs, device=dev)
            out = traced(memo, group.bank, group.feats, cm, x)
            if captured:
                group.graph = fused._Graph(traced, memo, group.bank,
                                           group.feats, cm, x, kind="group")
        else:
            out = group.graph.replay(x)
    est, err = out["est"].cpu().numpy(), out["err"].cpu().numpy()
    picks, valid = out["picks"].clone(), out["valid"].clone()
    cpi_sel = out["cpi_sel"].clone()
    valid_np = valid.cpu().numpy()

    results, off = [], 0
    for (i, prep), a_n in zip(members, a_sizes):
        sl = slice(off, off + a_n)
        off += a_n
        memo.absorb_picks(prep.stack.rows, cols, picks[sl], valid[sl],
                          cpi_sel[sl])
        _warn_partial_coverage(prep.spec, valid_np[sl],
                               prep.bank.weights.cpu().numpy())
        results.append((i, assemble_rows(
            prep.spec, prep.cfg_is, est[sl], err[sl],
            valid_np[sl].sum(axis=1), prep.truth.cpu().numpy())))
    sampling_plan._record_sweep_dispatch(
        batch_shape=(int(sum(a_sizes)), len(cfgs)),
        num_strata=int(preps[0].bank.weights.shape[1]),
        x64=pp.trace_dtype == torch.float64, backend=dev.type, fused=True,
        in_place=False, captured=captured, coalesced=len(members),
        sharded=mesh is not None)
    return results


def run_coalesced_sweeps(engine, specs: Sequence, mesh=None
                         ) -> list[ResultsTable]:
    """Run many sweep requests, one fused dispatch per shape group.

    Returns one ``ResultsTable`` per request, in request order. Requests
    sharing a ``coalesce_key`` run as one stacked program; groups of one
    and non-coalescible requests run through ``run_sweep``. Results AND
    cost accounting equal the same requests run serially in submission
    order; the dispatch marker (``sampling_plan.last_sweep_dispatch``)
    records ``coalesced=K`` for a stacked dispatch. ``mesh`` (default: the
    engine's) shards every dispatch's app axis.
    """
    mesh = engine.mesh if mesh is None else mesh
    results: list = [None] * len(specs)
    groups: dict = {}
    for i, spec in enumerate(specs):
        if not coalescible(spec):
            results[i] = run_sweep(engine, spec, mesh=mesh)
            continue
        prep = prepare_sweep(engine, spec)
        groups.setdefault(coalesce_key(prep), []).append((i, prep))
    for members in groups.values():
        if len(members) == 1:
            i, prep = members[0]
            results[i] = run_sweep(engine, prep.spec, mesh=mesh)
        else:
            for i, table in _dispatch_group(engine, members, mesh):
                results[i] = table
    return results
