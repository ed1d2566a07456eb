"""Analytical out-of-order core performance model, in PyTorch.

Counterpart of ``repro.simcpu.perfmodel``: maps (region intrinsic
features x ``UarchConfig``) to CPI plus the 38 Table III counters. It is
plain elementwise float32 tensor code on whatever device the features
live on; the reference's vmapped config axis is an explicit batch
dimension here (features ``(..., N, F)`` against configs ``(C, 14)`` give
``(..., C, N)``). Deterministic per (region, config): the same region
evaluates to the same bits however it is batched, which is what lets
the memo table serve any fill path.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.features import RFV_METRICS
from .uarch import UarchConfig
from .workload import NUM_FEATURES

__all__ = ["NUM_CONFIG_FIELDS", "config_vector", "config_matrix",
           "evaluate_regions_batch", "cpi_batch", "cpi_bank", "rfv_bank"]

NUM_CONFIG_FIELDS = 14

_F = {name: i for i, name in enumerate(
    ("ilp", "br_pki", "br_mpr", "br_predict", "cond_frac", "ic_mpki",
     "ic_alpha", "itlb_mpki", "l1d_apki", "load_frac", "l1d_mpki",
     "l1d_alpha", "l2_mpki", "l2_alpha", "l3_mpki", "l3_alpha", "wb_frac",
     "sms_cov", "bo_cov", "mlp", "rob_sens"))}
if len(_F) != NUM_FEATURES:
    raise ImportError("perf model feature table out of step with workload")


def config_vector(cfg: UarchConfig) -> list[float]:
    """The 14 model inputs of one configuration, in model order."""
    return [
        cfg.issue_width, cfg.retire_width, cfg.rob_size,
        cfg.icache_kb, cfg.dcache_kb, cfg.l2_kb, cfg.l3_mb,
        cfg.l2_hit_lat, cfg.l3_hit_latency_cyc, cfg.mem_latency_cyc,
        1.0 if cfg.sms_pf else 0.0, 1.0 if cfg.bo_pf else 0.0,
        cfg.tage_capacity_ratio, cfg.fetch_width,
    ]


def config_matrix(cfgs: Sequence[UarchConfig], *, device=None
                  ) -> torch.Tensor:
    """(C, 14) float32 matrix of config vectors."""
    if not cfgs:
        raise ValueError("need at least one config")
    return torch.tensor([config_vector(c) for c in cfgs],
                        dtype=torch.float32, device=device)


def _pow(base: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """float32 power, correctly rounded from float64 (the reference's
    float32 ``**`` agrees with this on all but ~0.06% of arguments)."""
    return torch.pow(base.double(), exp.double()).float()


def _evaluate(features: torch.Tensor, cm: torch.Tensor, *,
              counters: bool) -> dict[str, torch.Tensor]:
    """Model terms for ``features (..., N, F)`` x ``cm (C, 14)``.

    Every output is ``(..., C, N)``. ``counters=False`` computes CPI only
    (the census path), skipping the 37 counters it does not need.
    """
    x = features.float()[..., None, :, :]             # (..., 1, N, F)
    cv = cm.to(x.device, torch.float32)[:, None, :]   # (C, 1, 14)

    def f(name):
        return x[..., _F[name]]

    (issue_w, retire_w, rob, ic_kb, dc_kb, l2_kb, l3_mb, l2_lat, l3_lat,
     mem_lat, sms_on, bo_on, tage_ratio, fetch_w) = [cv[..., i]
                                                     for i in range(14)]

    # --- core-bound term ----------------------------------------------------
    ilp_eff = f("ilp") * (1.0 + 0.08 * f("rob_sens") * (rob / 128.0 - 1.0))
    ipc_core = torch.minimum(torch.minimum(ilp_eff, retire_w), issue_w)
    base_cpi = 1.0 / ipc_core

    # --- branch mispredictions ----------------------------------------------
    mpr_eff = f("br_mpr") * _pow(tage_ratio, -f("br_predict"))
    br_mpki = f("br_pki") * torch.clamp(mpr_eff, 0.0, 0.15)
    flush_penalty = 12.0 + rob / 32.0
    stall_br = br_mpki / 1000.0 * flush_penalty

    # --- frontend misses ----------------------------------------------------
    ic_mpki = f("ic_mpki") * _pow(32.0 / ic_kb, f("ic_alpha"))
    stall_ic = ic_mpki / 1000.0 * l2_lat * 0.7
    itlb_mpki = f("itlb_mpki")
    stall_itlb = itlb_mpki / 1000.0 * 20.0

    # --- data-side cache hierarchy -------------------------------------------
    l1d_mpki = f("l1d_mpki") * _pow(32.0 / dc_kb, f("l1d_alpha"))
    l2_mpki = torch.minimum(
        l1d_mpki, f("l2_mpki") * _pow(512.0 / l2_kb, f("l2_alpha")))
    l3_mpki = torch.minimum(
        l2_mpki, f("l3_mpki") * _pow(2.0 / l3_mb, f("l3_alpha")))

    l2_served = torch.clamp_min(l1d_mpki - l2_mpki, 0.0)
    l3_served = torch.clamp_min(l2_mpki - l3_mpki, 0.0)
    mem_served = l3_mpki

    cov_sms = f("sms_cov") * sms_on
    cov_bo = f("bo_cov") * bo_on
    mem_cost = mem_served * ((1.0 - cov_sms) * mem_lat + cov_sms * l2_lat)
    l3_cost = l3_served * ((1.0 - cov_bo) * l3_lat + cov_bo * l2_lat)
    l2_cost = l2_served * l2_lat * 0.5

    rob_cap = rob / 32.0
    mlp = f("mlp")
    mlp_eff = 1.0 + (mlp - 1.0) * torch.clamp(rob_cap / mlp, 0.0, 1.0)
    stall_mem = (mem_cost + l3_cost + l2_cost) / 1000.0 / mlp_eff

    cpi = base_cpi + stall_br + stall_ic + stall_itlb + stall_mem
    if not counters:
        return {"cpi": cpi}

    # --- Table III counters (rates per kilo-instruction) ---------------------
    cond = f("cond_frac")
    l1d_total = l1d_mpki
    demand_l3_misses = mem_served * (1.0 - cov_sms)
    demand_l2_misses = l3_served * (1.0 - cov_bo) + mem_served
    shape = cpi.shape
    out: dict[str, torch.Tensor] = {
        "cpi": cpi,
        "branch_mispredicts": br_mpki,
        "cond_branch_mispredicts": br_mpki * cond,
        "target_branch_mispredicts": br_mpki * (1.0 - cond),
        "icache_misses": ic_mpki,
        "itlb_misses": itlb_mpki,
        "l1d_access": f("l1d_apki"),
        "l1d_load_miss": l1d_total * f("load_frac"),
        "l1d_store_miss": l1d_total * (1.0 - f("load_frac")),
        "l1d_total_miss": l1d_total,
        "l1d_writeback": l1d_total * f("wb_frac"),
        "l2_misses": demand_l2_misses,
        "l2_load_misses": demand_l2_misses * f("load_frac"),
        "l2_writebacks": l2_mpki * f("wb_frac"),
        "l3_read_accesses": demand_l2_misses,
        "l3_write_accesses": l2_mpki * f("wb_frac"),
        "l3_misses": demand_l3_misses,
    }

    # --- 21 top-down stall bins (cycles per instruction, x1000 => per ki) ----
    dram_stall = mem_cost / 1000.0 / mlp_eff
    l3_stall = l3_cost / 1000.0 / mlp_eff
    l2_stall = l2_cost / 1000.0 / mlp_eff
    fe_bw = torch.clamp_min((1.0 / fetch_w) - (1.0 / ipc_core), 0.0) \
        + 0.01 * base_cpi
    rob_press = torch.clamp_min(mlp - rob_cap, 0.0) / (mlp + 1.0)
    bins = [
        stall_ic,                          # 00 frontend icache
        stall_itlb,                        # 01 frontend itlb
        stall_br * 0.4,                    # 02 branch resteer
        fe_bw,                             # 03 frontend bandwidth
        stall_br * 0.6,                    # 04 bad speculation
        l2_stall,                          # 05 backend mem L2-bound
        l3_stall,                          # 06 backend mem L3-bound
        dram_stall,                        # 07 backend mem DRAM-bound
        l1d_total * f("wb_frac") / 1000.0 * 2.0,  # 08 store-bound
        rob_press * stall_mem,             # 09 ROB-full
        base_cpi * 0.10,                   # 10 RS-full proxy
        base_cpi * 0.05,                   # 11 phys-reg pressure
        dram_stall * 0.30 + l3_stall * 0.10,       # 12 mem latency-bound
        dram_stall * 0.10 + l2_stall * 0.40,       # 13 mem bandwidth proxy
        stall_mem * rob_press * 0.50,              # 14 ROB-blocked mem
        stall_br * 0.25 + fe_bw * 0.30,            # 15 resteer bandwidth
        stall_ic * 0.50 + stall_itlb * 0.20,       # 16 fetch latency split
        base_cpi * 0.08 + stall_br * 0.05,         # 17 dispatch stalls
        l2_stall * 0.20 + l3_stall * 0.30,         # 18 L2/L3 queueing
        stall_mem * 0.15,                          # 19 store/forwarding
        base_cpi * 0.04 + stall_mem * 0.02,        # 20 misc core
    ]
    for i, b in enumerate(bins):
        out[f"stall_bin_{i:02d}"] = b
    return {k: v.expand(shape) for k, v in out.items()}


def evaluate_regions_batch(features: torch.Tensor,
                           cfgs: Sequence[UarchConfig],
                           indices=None) -> dict[str, torch.Tensor]:
    """Every metric for ``features (N, F)`` (rows ``indices`` when given)
    across ``cfgs``: a dict of ``(C, n)`` float32 tensors."""
    x = features if indices is None else features[indices]
    return _evaluate(x, config_matrix(cfgs, device=x.device), counters=True)


def cpi_batch(features: torch.Tensor, cfgs: Sequence[UarchConfig],
              indices=None) -> torch.Tensor:
    """(C, n) CPI across configs in one pass."""
    x = features if indices is None else features[indices]
    return _evaluate(x, config_matrix(cfgs, device=x.device),
                     counters=False)["cpi"]


def _as_config_matrix(cfgs, device) -> torch.Tensor:
    if isinstance(cfgs, torch.Tensor):
        return cfgs.to(device)
    return config_matrix(cfgs, device=device)


def cpi_bank(features: torch.Tensor, cfgs) -> torch.Tensor:
    """(A, C, N) CPI for stacked ``(A, N, F)`` app features; ``cfgs`` is a
    config sequence or a prebuilt (C, 14) matrix."""
    return _evaluate(features, _as_config_matrix(cfgs, features.device),
                     counters=False)["cpi"]


def rfv_bank(features: torch.Tensor, cfg: UarchConfig
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked phase-1 measurement: (A, N) CPI and (A, N, 38) RFVs."""
    stats = _evaluate(features, config_matrix((cfg,), device=features.device),
                      counters=True)
    rfv = torch.stack([stats[m][..., 0, :] for m in RFV_METRICS], dim=-1)
    return stats["cpi"][..., 0, :], rfv
