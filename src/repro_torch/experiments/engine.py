"""Batched experiment engine over the simulation substrate, on the card.

Counterpart of ``repro.experiments.engine``. ``build(names)`` stacks every
requested app's population into one ``(A, N, F)`` tensor on the engine's
device and runs each build phase once for all apps:

* census ground truth: ``cpi_bank`` over (app, config, region);
* BBV projection + weighted k-means (``kmeans_bank``) over the full
  populations, padding rows carrying zero weight;
* the phase-1 simple random sample, measured with ``rfv_bank`` and charged
  through the shared ``MemoBank``;
* RFV standardization + weighted k-means on the phase-1 sample;
* Dalenius-Gurney boundaries on baseline CPI (a scalar host search per
  app, as in the reference).

Every stratum summary (weights, selection targets) goes through
``segment_stats`` (``_segment_sums_counts``), and every Lloyd step of the
two fits through ``kmeans_assign``: on CUDA tensors these are the
hand-written kernels. The reference engine calls ``kmeans_bank`` with its
default ``"jnp"`` backend, i.e. its TPU kernel never ran there; the port
computes the same function through its kernel.

``device=None`` means the card (``"cuda"``) and raises when there is none;
tests pass ``device="cpu"``. ``mesh`` (``repro_torch.launch.mesh``) shards
the app axis of the census, the BBV projection, both fits and the phase-1
measurement over its devices, with the unsharded results
(``repro_torch.distributed.appaxis``); ``ExperimentEngine.auto()`` makes
an ``("app",)`` mesh over the visible cards when there is more than one.
``backend`` chooses the kernel route for the whole engine: ``"auto"``
(kernels on CUDA, plain versions on the CPU) or ``"plain"`` (the plain
versions on any device, for holding the kernels against them).
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from .. import prng
from ..core.clustering import kmeans_bank, kmeans_batch, random_project
from ..core.ordered import seq_sum
from ..core.sampling import dalenius_gurney_strata, draw_srs
from ..core.sampling import plan as sampling_plan
from ..device import resolve_device
from ..kernels.segment_stats.ops import segment_stats
from ..simcpu import (APP_NAMES, CONFIGS, NUM_BLOCKS, CachedSimulator,
                      MemoBank,
                      config_matrix, cpi_bank, get_bbvs, get_population_bank,
                      make_simulator, rfv_bank, stack_ragged)

NUM_STRATA = 20
PHASE1_SEED = 42
BBV_DIMS = 15

__all__ = ["NUM_STRATA", "PHASE1_SEED", "AppExperiment", "SweepStack",
           "ExperimentEngine", "plan_selection", "plan_selection_bank",
           "scheme_selection", "scheme_selection_bank", "stratum_tables"]


@dataclasses.dataclass
class AppExperiment:
    """Per-application view shared by every sweep (tensors on the
    engine's device)."""

    name: str
    sim: CachedSimulator
    configs: tuple
    truth: torch.Tensor           # (C,) census mean CPI per config, f64
    census_mat: torch.Tensor      # (C, N) census CPI (analysis-only)
    bbv_labels: torch.Tensor      # (N,)
    bbv_weights: torch.Tensor     # (L,)
    bbv_feats: torch.Tensor       # projected (N, 15)
    bbv_centroids: torch.Tensor   # (L, 15)
    idx1: torch.Tensor            # phase-1 region indices
    cpi0_1: torch.Tensor          # baseline CPI of phase-1 units
    rfv_z: torch.Tensor           # standardized RFVs of phase-1 units, f64
    rfv_labels: torch.Tensor
    rfv_weights: torch.Tensor
    rfv_centroids: torch.Tensor
    dg_labels: torch.Tensor
    dg_weights: torch.Tensor
    num_strata: int = NUM_STRATA

    def census(self, cfg_i: int) -> torch.Tensor:
        """(N,) census CPI for config ``cfg_i`` (free of charge)."""
        return self.census_mat[cfg_i]

    def cpi(self, cfg_i: int, indices) -> torch.Tensor:
        """(n,) CPI for one config, through the memo (misses charged)."""
        return self.sim.simulate_cpi(indices, self.configs[cfg_i])

    def cpi_for(self, indices,
                config_indices: Optional[Sequence[int]] = None
                ) -> torch.Tensor:
        """(C', n) CPI for a config subset in one batched pass; only the
        requested configs are simulated (and charged)."""
        cfgs = (self.configs if config_indices is None
                else tuple(self.configs[i] for i in config_indices))
        return self.sim.simulate_cpi_batch(indices, cfgs)

    def cpi_all(self, indices) -> torch.Tensor:
        """(C, n) CPI across all configs in one batched pass."""
        return self.cpi_for(indices)

    def weighted_cpi_all(self, selected: Sequence, weights, *,
                         config_indices: Optional[Sequence[int]] = None,
                         strict: bool = False) -> torch.Tensor:
        """(C',) float64 stratified weighted-mean CPI per config, one
        batched pass.

        ``selected``: per-stratum population index tensors (any count
        per stratum). Strata with no selected unit renormalize the
        estimate by the covered weight, with a ``UserWarning``
        (``strict=True`` raises); when every stratum is empty there is
        nothing to renormalize to: that raises under ``strict`` and
        otherwise warns and gives NaN.
        """
        dev = self.sim.bank.device
        n_cfg = len(self.configs) if config_indices is None \
            else len(tuple(config_indices))
        w = torch.as_tensor(weights).to(dev, torch.float64)
        sel = [torch.as_tensor(s).to(dev, torch.int64).reshape(-1)
               for s in selected]
        nonempty = [s for s in sel if s.numel()]
        if not nonempty:
            msg = ("every stratum selection is empty; no units to "
                   "estimate from")
            if strict:
                raise ValueError(msg)
            warnings.warn(msg, UserWarning, stacklevel=2)
            return torch.full((n_cfg,), float("nan"), dtype=torch.float64,
                              device=dev)
        flat = torch.cat(nonempty)
        seg = torch.cat([torch.full((s.numel(),), h, dtype=torch.int64,
                                    device=dev)
                         for h, s in enumerate(sel) if s.numel()])
        counts = torch.bincount(seg, minlength=len(sel))
        covered = float(w[counts > 0].sum())
        total = float(w.sum())
        if covered < total * (1.0 - 1e-6):
            msg = (f"selected units cover only {covered / total:.4f} of the "
                   "stratum weight; renormalizing biases the estimate "
                   "toward the covered strata")
            if strict:
                raise ValueError(msg)
            warnings.warn(msg, UserWarning, stacklevel=2)
        mat = self.cpi_for(flat, config_indices)
        per_unit = w[seg] / torch.clamp_min(counts[seg], 1)
        return (mat.double() * per_unit[None, :]).sum(dim=1) / covered


@dataclasses.dataclass(frozen=True)
class SweepStack:
    """Stacked per-app tensors backing the engine's batched paths."""

    names: tuple[str, ...]
    rows: np.ndarray               # (A,) MemoBank rows
    n_regions: torch.Tensor        # (A,) int64 population sizes
    feats: torch.Tensor            # (A, N_max, F) float32, zero-padded
    idx1: torch.Tensor             # (A, n1_max) phase-1 indices (padded)
    idx1_valid: torch.Tensor       # (A, n1_max) bool
    truth: torch.Tensor            # (A, C) census mean CPI, f64

    def gather_feats(self, idx: torch.Tensor) -> torch.Tensor:
        """(A, K, F) features at per-app region indices."""
        rows = torch.arange(len(self.names), device=idx.device)[:, None]
        return self.feats[rows, idx]


def _segment_sums_counts(labels: torch.Tensor, valid: torch.Tensor,
                         num_strata: int, values: torch.Tensor, *,
                         backend: str = "auto"
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(A, L) per-stratum value sums and counts over valid entries, from
    ONE ``segment_stats`` launch; float32 sums (counts exact), returned
    as float64."""
    lab = torch.where(valid, labels, torch.full_like(labels, -1))
    sums, _, counts = segment_stats(values.float(), lab.to(torch.int32),
                                    num_strata, backend=backend)
    return sums[..., 0].double(), counts.double()


def _offset_bincount(labels: torch.Tensor, valid: torch.Tensor,
                     num_strata: int, *, backend: str = "auto"
                     ) -> torch.Tensor:
    """(A, L) per-app stratum counts over valid entries."""
    return _segment_sums_counts(labels, valid, num_strata,
                                torch.ones(labels.shape,
                                           device=labels.device),
                                backend=backend)[1]


def stratum_tables(labels: torch.Tensor, valid: torch.Tensor,
                   num_strata: int, counts: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-stratum gather tables ``(order, offsets, counts)`` for an
    (A, n) label stack: stratum ``h`` of app ``a`` owns
    ``order[a, offsets[a, h] : offsets[a, h] + counts[a, h]]`` in index
    order (a stable sort on the device, invalid entries last). Shared
    with the selection context (``plan.stratum_order``), so draw indexing
    cannot drift between selection and the trials. ``counts`` from a
    ``_segment_sums_counts`` summary saves a second launch. Trailing
    empty strata put their offset at the row width: gathers clamp."""
    if counts is None:
        counts = _offset_bincount(labels, valid, num_strata)
    counts = counts.long()
    order = sampling_plan.stratum_order(labels, valid, num_strata)
    offsets = torch.cumsum(counts, dim=1) - counts
    return order, offsets, counts


class ExperimentEngine:
    """Builds ``AppExperiment`` state batched over apps; runs batched
    sweeps.

    ``mesh``: an ``("app",)`` mesh, over which every batched build and
    sweep pass shards its app axis, or an ``("app", "trial")`` mesh, which
    also splits Monte-Carlo trial chunks over its second axis (build and
    sweeps use its app axis only). ``None`` (the default) runs the same
    programs on the engine's device. The engine's state lives on
    ``device`` whatever the mesh: shards' results come back there.
    """

    @classmethod
    def auto(cls, **kwargs) -> "ExperimentEngine":
        """An engine with an ``("app",)`` mesh over the visible cards when
        there is more than one, else none. It shards over distinct cards
        only: a mesh that repeats a device is asked for by name
        (``make_app_mesh(devices=...)``)."""
        if "mesh" not in kwargs:
            mesh = None
            if torch.cuda.is_available() and torch.cuda.device_count() > 1:
                from ..launch.mesh import make_app_mesh
                mesh = make_app_mesh()
            kwargs["mesh"] = mesh
        return cls(**kwargs)

    def __init__(self, *, configs: Sequence = CONFIGS,
                 num_strata: int = NUM_STRATA,
                 phase1_seed: int = PHASE1_SEED, mesh=None, precision=None,
                 device=None, backend: str = "auto"):
        self.device = resolve_device(device, what="ExperimentEngine")
        self.mesh = mesh
        self.configs = tuple(configs)
        self.num_strata = num_strata
        self.phase1_seed = phase1_seed
        # sweep-estimate PrecisionPolicy override (None: host_parity, f64)
        self.precision = precision
        self.backend = backend
        self.memo = MemoBank(device=self.device)
        self._apps: dict[tuple[str, int], AppExperiment] = {}
        self._stacks: dict[tuple[tuple[str, ...], int], SweepStack] = {}
        self._banks: dict[tuple, sampling_plan.StratumBank] = {}
        # CUDA graphs of the fused sweeps and the trial chunks, keyed by
        # their modules (experiments.fused, experiments.montecarlo); held
        # here so that they, their pools and buffers go with the engine
        self.graphs: dict[tuple, object] = {}
        # the coalesced groups' stacked inputs and graphs, per group
        # composition, bounded (serving.batcher)
        self.groups: dict[tuple, object] = {}
        # the latest fused sweep's outputs (experiments.fused)
        self.fused_outputs: Optional[dict] = None

    def app(self, name: str, kmeans_seed: int = 0) -> AppExperiment:
        """The ``AppExperiment`` of one app (built on demand)."""
        return self.build((name,), kmeans_seed)[0]

    def apps(self, names: Optional[Sequence[str]] = None
             ) -> list[AppExperiment]:
        """Views of ``names`` (default: all paper apps), built batched."""
        return self.build(tuple(names or APP_NAMES))

    def rfv_stratifications(self, name: str, seeds: Sequence[int]):
        """k-means RFV fits of one app for many clustering seeds, as the
        lanes of one stacked fit (the paper's Figs 7-8 repetitions)."""
        exp = self.app(name)
        return kmeans_batch(exp.rfv_z, self.num_strata, seeds=list(seeds),
                            backend=self.backend)

    def build(self, names: Sequence[str],
              kmeans_seed: int = 0) -> list[AppExperiment]:
        """Every not-yet-built app in ``names`` is built in one stacked
        pass."""
        names = tuple(names)
        todo = tuple(dict.fromkeys(
            n for n in names if (n, kmeans_seed) not in self._apps))
        if todo:
            self._build_stacked(todo, kmeans_seed)
        return [self._apps[(n, kmeans_seed)] for n in names]

    def stratum_bank(self, stratifier: sampling_plan.Stratifier,
                     names: Sequence[str]) -> sampling_plan.StratumBank:
        """``stratifier.resolve`` over the built apps ``names``, kept per
        (stratifier, apps) so repeated sweeps see the same tensors (the
        fused sweep's graphs read them in place)."""
        key = (stratifier, tuple(names))
        if key not in self._banks:
            self._banks[key] = stratifier.resolve(self.build(names))
        return self._banks[key]

    def stack(self, names: Sequence[str],
              kmeans_seed: int = 0) -> SweepStack:
        """Stacked view over (already built) apps for batched paths."""
        names = tuple(names)
        key = (names, kmeans_seed)
        if key not in self._stacks:
            exps = self.build(names, kmeans_seed)
            bank = get_population_bank(names)
            dev = self.device
            idx1, idx1_valid = sampling_plan.stack_ragged_tensors(
                [e.idx1 for e in exps])
            self._stacks[key] = SweepStack(
                names=names,
                rows=np.asarray([e.sim.row for e in exps], np.int64),
                n_regions=torch.tensor(bank.n_regions, dtype=torch.int64,
                                       device=dev),
                feats=torch.tensor(bank.features, device=dev),
                idx1=idx1, idx1_valid=idx1_valid,
                truth=torch.stack([e.truth for e in exps]))
        return self._stacks[key]

    # ------------------------------------------------------------------ build
    def _build_stacked(self, names: tuple[str, ...], kmeans_seed: int) -> None:
        L = self.num_strata
        dev = self.device
        be = self.backend
        mesh = self.mesh
        bank = get_population_bank(names)
        a_n = bank.num_apps
        ar = torch.arange(a_n, device=dev)
        # copies, on the CPU too: the population bank is a process-wide
        # cache that the engine must never share a buffer with
        feats = torch.tensor(bank.features, device=dev)
        mask = torch.tensor(bank.mask, device=dev)
        n_regions = torch.tensor(bank.n_regions, device=dev)

        sims = []
        for name, pop in zip(names, bank.pops):
            base = make_simulator(name, device=dev)
            row = self.memo.add_app(name, pop.n_regions, base.ledger)
            sims.append(CachedSimulator(base, bank=self.memo, row=row))

        # census ground truth for every config (analysis-only, free)
        census = cpi_bank(feats, config_matrix(self.configs, device=dev),
                          mesh=mesh)
        truth = torch.where(mask[:, None, :], census,
                            torch.zeros((), device=dev)).double().sum(dim=2) \
            / n_regions[:, None]

        # SimPoint-style BBV stratification over the full populations
        bbvs = torch.zeros((a_n, bank.max_regions, NUM_BLOCKS),
                           dtype=torch.float32, device=dev)
        for a, pop in enumerate(bank.pops):
            bbvs[a, :pop.n_regions] = torch.as_tensor(get_bbvs(pop),
                                                      device=dev)
        z = _project_bank(bbvs, mesh=mesh)
        del bbvs
        bbv_fit = kmeans_bank(z, L, weights=mask.float(), seed=kmeans_seed,
                              backend=be, mesh=mesh)
        bbv_w = _offset_bincount(bbv_fit.labels, mask, L, backend=be) \
            / n_regions[:, None]

        # phase 1: SRS at the paper's Table II sizes, measured on config 0
        # in one stacked pass and charged through the shared memo bank
        idx1_list = [draw_srs(np.random.default_rng(self.phase1_seed),
                              pop.n_regions, pop.spec.phase1_n)
                     for pop in bank.pops]
        idx1_np, valid_np = stack_ragged(idx1_list)
        idx1 = torch.as_tensor(idx1_np, device=dev)
        idx1_valid = torch.as_tensor(valid_np, device=dev)
        cpi0, rfv = rfv_bank(feats[ar[:, None], idx1], self.configs[0],
                             mesh=mesh)
        rows = np.asarray([s.row for s in sims], np.int64)
        self.memo.fill(rows, idx1, idx1_valid, (self.configs[0],),
                       values=cpi0[:, None, :])

        # RFV stratification: masked z-scoring + weighted k-means. The sums
        # run in the reference's host order and dtypes (a float32 sum for
        # the mean, float64 for the variance) so the z-scores match it.
        n1 = idx1_valid.sum(dim=1)
        v3 = idx1_valid[:, :, None]
        zero = torch.zeros((), device=dev)
        mean = seq_sum(torch.where(v3, rfv, zero), 1).double() \
            / n1[:, None]
        centered = rfv.double() - mean[:, None, :]
        var = seq_sum(torch.where(v3, centered ** 2, zero.double()), 1) \
            / n1[:, None]
        scale = torch.sqrt(var)
        scale = torch.where(scale > 1e-12, scale, torch.ones_like(scale))
        zr = torch.where(v3, centered / scale[:, None, :], zero.double())
        rfv_fit = kmeans_bank(zr, L, weights=idx1_valid.float(),
                              seed=kmeans_seed, backend=be, mesh=mesh)
        rfv_w = _offset_bincount(rfv_fit.labels, idx1_valid, L, backend=be) \
            / n1[:, None]

        # Dalenius-Gurney on baseline CPI (host-side scalar refinement)
        n1_np = valid_np.sum(axis=1)
        cpi0_np = cpi0.cpu().numpy()
        dg_list = [dalenius_gurney_strata(cpi0_np[a, :n1_np[a]], L)
                   for a in range(a_n)]
        dg = torch.as_tensor(stack_ragged(dg_list)[0], device=dev)
        dg_w = _offset_bincount(dg, idx1_valid, L, backend=be) / n1[:, None]

        for a, (name, sim, pop) in enumerate(zip(names, sims, bank.pops)):
            n, m = pop.n_regions, int(n1_np[a])
            self._apps[(name, kmeans_seed)] = AppExperiment(
                name=name, sim=sim, configs=self.configs,
                truth=truth[a], census_mat=census[a, :, :n],
                bbv_labels=bbv_fit.labels[a, :n], bbv_weights=bbv_w[a],
                bbv_feats=z[a, :n], bbv_centroids=bbv_fit.centroids[a],
                idx1=idx1[a, :m], cpi0_1=cpi0[a, :m], rfv_z=zr[a, :m],
                rfv_labels=rfv_fit.labels[a, :m], rfv_weights=rfv_w[a],
                rfv_centroids=rfv_fit.centroids[a],
                dg_labels=dg[a, :m], dg_weights=dg_w[a], num_strata=L)


def _project_bank_fn(bbvs: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    return random_project(bbvs, BBV_DIMS, key=key)


def _project_bank(bbvs: torch.Tensor, *, mesh=None) -> torch.Tensor:
    """(A, N, 256) BBVs -> (A, N, 15) projections: every app through the
    same JL matrix (``PRNGKey(0)``), app-sharded over ``mesh`` when
    given."""
    key = prng.PRNGKey(0, device=bbvs.device)
    if mesh is None:
        return _project_bank_fn(bbvs, key)
    from ..distributed.appaxis import app_sharded_cached
    return app_sharded_cached(_project_bank_fn, mesh, (1,))(bbvs, key)


# --------------------------------------------------------------- selection
def plan_selection_bank(exps: Sequence[AppExperiment],
                        plan: sampling_plan.SamplingPlan, *, seed: int = 0,
                        backend: str = "auto"
                        ) -> tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """One-unit-per-stratum selection for a stack of apps.

    The plan's stratifier resolves the engine-built artifacts into a
    ``StratumBank``; ONE ``segment_stats`` launch serves the counts and
    stratum-mean baselines; the plan's policy picks one unit per stratum
    (``seed`` seeds ``RandomUnit``'s draw). Returns ``(picks, valid,
    weights)``: (A, L) population indices, an (A, L) mask (False for
    empty strata) and the (A, L) weights.
    """
    bank = plan.stratifier.resolve(exps)
    ctx = sampling_plan.build_selection_context(
        bank, seed=seed,
        summarize=functools.partial(_segment_sums_counts, backend=backend))
    local = plan.policy(ctx)
    valid = ctx.counts > 0
    picks = local if bank.pool is None \
        else torch.take_along_dim(bank.pool, local, dim=1)
    return torch.where(valid, picks, torch.zeros_like(picks)), valid, \
        bank.weights


def plan_selection(exp: AppExperiment, plan: sampling_plan.SamplingPlan,
                   *, seed: int = 0, backend: str = "auto"
                   ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Population indices per stratum + weights for one app's plan."""
    picks, valid, weights = plan_selection_bank([exp], plan, seed=seed,
                                                backend=backend)
    sel = [picks[0, h:h + 1] if bool(valid[0, h])
           else picks.new_empty(0) for h in range(exp.num_strata)]
    return sel, weights[0]


def scheme_selection_bank(exps: Sequence[AppExperiment], scheme: str,
                          policy: str, seed: int = 0, *,
                          backend: str = "auto"
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Deprecated string shim over ``plan_selection_bank``: the plan
    ``SamplingPlan.from_strings(scheme, policy)``, one
    ``DeprecationWarning``."""
    sampling_plan.warn_string_dispatch(
        "scheme_selection_bank",
        "use plan_selection_bank(exps, SamplingPlan.from_strings(...))")
    return plan_selection_bank(
        exps, sampling_plan.SamplingPlan.from_strings(scheme, policy),
        seed=seed, backend=backend)


def scheme_selection(exp: AppExperiment, scheme: str, policy: str,
                     seed: int = 0, *, backend: str = "auto"
                     ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Deprecated string shim over ``plan_selection``."""
    sampling_plan.warn_string_dispatch(
        "scheme_selection",
        "use plan_selection(exp, SamplingPlan.from_strings(...))")
    return plan_selection(
        exp, sampling_plan.SamplingPlan.from_strings(scheme, policy),
        seed=seed, backend=backend)
