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
tests pass ``device="cpu"``. ``backend`` chooses the kernel route for the
whole engine: ``"auto"`` (kernels on CUDA, plain versions on the CPU) or
``"plain"`` (the plain versions on any device, for holding the kernels
against them).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from .. import prng
from ..core.clustering import kmeans_bank, random_project
from ..core.ordered import seq_sum
from ..core.sampling import dalenius_gurney_strata, draw_srs
from ..core.sampling import plan as sampling_plan
from ..kernels.segment_stats.ops import segment_stats
from ..simcpu import (CONFIGS, NUM_BLOCKS, CachedSimulator, MemoBank,
                      config_matrix, cpi_bank, get_bbvs, get_population_bank,
                      make_simulator, rfv_bank, stack_ragged)

NUM_STRATA = 20
PHASE1_SEED = 42
BBV_DIMS = 15

__all__ = ["NUM_STRATA", "PHASE1_SEED", "AppExperiment", "SweepStack",
           "ExperimentEngine", "plan_selection", "plan_selection_bank",
           "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The engine's device: the card unless the caller names another."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ExperimentEngine runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


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


@dataclasses.dataclass(frozen=True)
class SweepStack:
    """Stacked per-app tensors backing the engine's batched paths."""

    names: tuple[str, ...]
    rows: np.ndarray               # (A,) MemoBank rows
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
                     num_strata: int, *, backend: str) -> torch.Tensor:
    """(A, L) per-app stratum counts over valid entries."""
    return _segment_sums_counts(labels, valid, num_strata,
                                torch.ones(labels.shape,
                                           device=labels.device),
                                backend=backend)[1]


class ExperimentEngine:
    """Builds ``AppExperiment`` state batched over apps, on one device."""

    def __init__(self, *, configs: Sequence = CONFIGS,
                 num_strata: int = NUM_STRATA,
                 phase1_seed: int = PHASE1_SEED, precision=None,
                 device=None, backend: str = "auto"):
        self.device = resolve_device(device)
        self.configs = tuple(configs)
        self.num_strata = num_strata
        self.phase1_seed = phase1_seed
        # sweep-estimate PrecisionPolicy override (None: host_parity, f64)
        self.precision = precision
        self.backend = backend
        self.memo = MemoBank(device=self.device)
        self._apps: dict[tuple[str, int], AppExperiment] = {}
        self._stacks: dict[tuple[tuple[str, ...], int], SweepStack] = {}

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
                feats=torch.as_tensor(bank.features, device=dev),
                idx1=idx1, idx1_valid=idx1_valid,
                truth=torch.stack([e.truth for e in exps]))
        return self._stacks[key]

    # ------------------------------------------------------------------ build
    def _build_stacked(self, names: tuple[str, ...], kmeans_seed: int) -> None:
        L = self.num_strata
        dev = self.device
        be = self.backend
        bank = get_population_bank(names)
        a_n = bank.num_apps
        ar = torch.arange(a_n, device=dev)
        feats = torch.as_tensor(bank.features, device=dev)
        mask = torch.as_tensor(bank.mask, device=dev)
        n_regions = torch.as_tensor(bank.n_regions, device=dev)

        sims = []
        for name, pop in zip(names, bank.pops):
            base = make_simulator(name, device=dev)
            row = self.memo.add_app(name, pop.n_regions, base.ledger)
            sims.append(CachedSimulator(base, bank=self.memo, row=row))

        # census ground truth for every config (analysis-only, free)
        census = cpi_bank(feats, config_matrix(self.configs, device=dev))
        truth = torch.where(mask[:, None, :], census,
                            torch.zeros((), device=dev)).double().sum(dim=2) \
            / n_regions[:, None]

        # SimPoint-style BBV stratification over the full populations
        bbvs = torch.zeros((a_n, bank.max_regions, NUM_BLOCKS),
                           dtype=torch.float32, device=dev)
        for a, pop in enumerate(bank.pops):
            bbvs[a, :pop.n_regions] = torch.as_tensor(get_bbvs(pop),
                                                      device=dev)
        z = random_project(bbvs, BBV_DIMS, key=prng.PRNGKey(0, device=dev))
        del bbvs
        bbv_fit = kmeans_bank(z, L, weights=mask.float(), seed=kmeans_seed,
                              backend=be)
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
        cpi0, rfv = rfv_bank(feats[ar[:, None], idx1], self.configs[0])
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
                              seed=kmeans_seed, backend=be)
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


# --------------------------------------------------------------- selection
def plan_selection_bank(exps: Sequence[AppExperiment],
                        plan: sampling_plan.SamplingPlan, *,
                        backend: str = "auto"
                        ) -> tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """One-unit-per-stratum selection for a stack of apps.

    The plan's stratifier resolves the engine-built artifacts into a
    ``StratumBank``; ONE ``segment_stats`` launch serves the counts and
    stratum-mean baselines; the plan's policy picks one unit per stratum.
    Returns ``(picks, valid, weights)``: (A, L) population indices, an
    (A, L) mask (False for empty strata) and the (A, L) weights.
    """
    bank = plan.stratifier.resolve(exps)
    ctx = sampling_plan.build_selection_context(
        bank, summarize=functools.partial(_segment_sums_counts,
                                          backend=backend))
    local = plan.policy(ctx)
    valid = ctx.counts > 0
    picks = local if bank.pool is None \
        else torch.take_along_dim(bank.pool, local, dim=1)
    return torch.where(valid, picks, torch.zeros_like(picks)), valid, \
        bank.weights


def plan_selection(exp: AppExperiment, plan: sampling_plan.SamplingPlan,
                   *, backend: str = "auto"
                   ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Population indices per stratum + weights for one app's plan."""
    picks, valid, weights = plan_selection_bank([exp], plan, backend=backend)
    sel = [picks[0, h:h + 1] if bool(valid[0, h])
           else picks.new_empty(0) for h in range(exp.num_strata)]
    return sel, weights[0]
