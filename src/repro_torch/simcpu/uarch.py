"""Microarchitecture configurations (paper Table I).

A four-wide-retire out-of-order ARMv9-class core (Config 0) plus six
progressively faster variants. Frequency is fixed at 3 GHz so the
nanosecond latencies in Table I convert to cycles.
"""

from __future__ import annotations

import dataclasses

FREQ_GHZ = 3.0


@dataclasses.dataclass(frozen=True)
class UarchConfig:
    name: str
    fetch_width: int = 8
    issue_width: int = 8
    dcache_hit_lat: int = 3          # cycles
    l2_hit_lat: int = 8              # cycles
    icache_kb: int = 32
    dcache_kb: int = 32
    l2_kb: int = 512
    l3_mb: int = 2
    sms_pf: bool = False             # Spatial Memory Streaming prefetcher
    rob_size: int = 128
    phys_regs: int = 128
    retire_width: int = 4
    mem_latency_ns: float = 130.0
    l3_hit_latency_ns: float = 30.0
    bo_pf: bool = False              # Best-Offset L2 prefetcher
    tage_tables: int = 4
    tage_entries: int = 2048

    @property
    def mem_latency_cyc(self) -> float:
        return self.mem_latency_ns * FREQ_GHZ

    @property
    def l3_hit_latency_cyc(self) -> float:
        return self.l3_hit_latency_ns * FREQ_GHZ

    @property
    def tage_capacity_ratio(self) -> float:
        """Branch-predictor capacity relative to Config 0."""
        return (self.tage_tables * self.tage_entries) / (4 * 2048)


# Table I, highlighted deltas relative to the baseline.
CONFIG_0 = UarchConfig(name="config0")
CONFIG_1 = dataclasses.replace(
    CONFIG_0, name="config1", icache_kb=64, dcache_kb=64, l2_kb=1024, l3_mb=4)
CONFIG_2 = dataclasses.replace(CONFIG_1, name="config2", sms_pf=True)
CONFIG_3 = dataclasses.replace(
    CONFIG_2, name="config3", rob_size=256, phys_regs=256, retire_width=8)
CONFIG_4 = dataclasses.replace(
    CONFIG_3, name="config4", mem_latency_ns=90.0, l3_hit_latency_ns=20.0)
CONFIG_5 = dataclasses.replace(CONFIG_4, name="config5", bo_pf=True)
CONFIG_6 = dataclasses.replace(
    CONFIG_5, name="config6", tage_tables=8, tage_entries=4096)

CONFIGS: tuple[UarchConfig, ...] = (
    CONFIG_0, CONFIG_1, CONFIG_2, CONFIG_3, CONFIG_4, CONFIG_5, CONFIG_6)

BASELINE = CONFIG_0
