"""Fault-tolerant fleet runtime: checkpoints, fault injection, elastic
planning and step-time health.

Counterpart of ``repro.runtime``:

* ``checkpoint`` — atomic, manifest-validated checkpoints in the
  reference's on-disk format (either package reads the other's), and the
  ``MemoBank`` snapshot wrappers;
* ``faults`` — seedable failure schedules (``FaultPlan``) and their live
  injector;
* ``elastic`` — mesh planning over a changing device pool (one device on
  the port; more raise until the multi-device app axis is ported);
* ``health`` — per-quantum wall-time traces and straggler detection.
"""

from .checkpoint import (ManifestMismatch, latest_step, read_manifest,
                         restore_checkpoint, restore_memobank,
                         save_checkpoint, save_memobank)
from .elastic import (ElasticRunner, MeshPlan, build_mesh, plan_app_mesh,
                      plan_app_trial_mesh, plan_mesh, reshard)
from .faults import FAULT_KINDS, FaultEvent, FaultInjector, FaultPlan, HostLoss
from .health import (QuantumHealth, StepTimer, StragglerDetector,
                     one_per_stratum_steptime_ci, srs_steptime_estimate,
                     stratified_steptime_estimate)

__all__ = [
    "ManifestMismatch", "save_checkpoint", "latest_step", "read_manifest",
    "restore_checkpoint", "save_memobank", "restore_memobank",
    "MeshPlan", "plan_mesh", "plan_app_mesh", "plan_app_trial_mesh",
    "build_mesh", "reshard", "ElasticRunner",
    "FAULT_KINDS", "FaultEvent", "FaultPlan", "FaultInjector", "HostLoss",
    "StepTimer", "StragglerDetector", "QuantumHealth",
    "stratified_steptime_estimate", "one_per_stratum_steptime_ci",
    "srs_steptime_estimate",
]
