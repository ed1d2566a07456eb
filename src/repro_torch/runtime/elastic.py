"""Elastic scaling: re-plan a running job when the device pool changes.

Counterpart of ``repro.runtime.elastic``. Node failures shrink the
healthy pool and repaired nodes rejoin; the protocol is:

1. ``plan_mesh`` / ``plan_app_mesh`` / ``plan_app_trial_mesh`` choose the
   largest supportable grid for the pool (pure planning, the reference's
   plans exactly);
2. ``build_mesh`` and ``reshard`` place the live state on that grid;
3. the caller continues from the in-memory state, or restores the latest
   checkpoint if the failure lost device memory.

``build_mesh`` places a plan on the pool as a ``repro_torch.launch.mesh
.Mesh`` (the pool may name one device more than once: a mesh of shards
on one card); a one-device plan needs no mesh and gives None, the
unsharded dispatch every engine path takes. ``reshard`` moves each leaf
of the live state to its new device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..launch.mesh import Mesh, as_device

PyTree = Any

__all__ = ["MeshPlan", "plan_mesh", "plan_app_mesh", "plan_app_trial_mesh",
           "build_mesh", "reshard", "ElasticRunner"]

@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))


def plan_mesh(n_devices: int, *, model_parallel: int = 16,
              min_model_parallel: int = 1) -> MeshPlan:
    """Largest (data, model) grid fitting the healthy pool.

    Keeps the requested model-parallel degree if any multiple of it fits;
    otherwise degrades model parallelism by powers of two.
    """
    mp = model_parallel
    while mp >= max(min_model_parallel, 1):
        data = n_devices // mp
        if data >= 1:
            return MeshPlan(shape=(data, mp), axes=("data", "model"))
        mp //= 2
    raise ValueError(f"cannot build a mesh from {n_devices} devices")


def plan_app_mesh(n_devices: int) -> MeshPlan:
    """1-D ``("app",)`` plan over the healthy pool, the sweep engine's
    mesh: app lanes never communicate, so any device count works."""
    if n_devices < 1:
        raise ValueError(f"cannot build a mesh from {n_devices} devices")
    return MeshPlan(shape=(int(n_devices),), axes=("app",))


def plan_app_trial_mesh(n_devices: int, *, app_devices: int = 1) -> MeshPlan:
    """2-D ``("app", "trial")`` plan for the streaming trial engine: the
    app degree is kept (clamped to the pool) and the trial axis absorbs
    the change. Devices that do not fill the rectangle idle."""
    if n_devices < 1:
        raise ValueError(f"cannot build a mesh from {n_devices} devices")
    app = max(1, min(int(app_devices), int(n_devices)))
    trial = int(n_devices) // app
    return MeshPlan(shape=(app, trial), axes=("app", "trial"))


def build_mesh(plan: MeshPlan,
               devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """The mesh of ``plan`` on the first ``plan.n_devices`` of ``devices``
    (default: the card), in row-major order; None for a one-device plan,
    the unsharded case every engine path takes. Raises ``ValueError``
    when the pool is too small."""
    devs = list(devices) if devices is not None else [resolve_device(None)]
    need = plan.n_devices
    if len(devs) < need:
        raise ValueError(f"plan needs {need} devices, have {len(devs)}")
    if need == 1:
        return None
    grid = np.empty(need, dtype=object)
    grid[:] = [as_device(d) for d in devs[:need]]
    return Mesh(grid.reshape(plan.shape), plan.axes)


def _is_device(x) -> bool:
    return isinstance(x, (str, torch.device))


def reshard(tree: PyTree, new_shardings) -> PyTree:
    """Move live state onto its new placement: ``new_shardings`` is one
    device, where every array or tensor leaf of the nested dict / list
    ``tree`` goes, or a tree of the same structure whose leaves are each
    leaf's device (a one-device sequence stands for that device)."""
    def move(x, dev):
        if isinstance(x, dict):
            if _is_device(dev):
                return {k: move(v, dev) for k, v in x.items()}
            if not isinstance(dev, dict):
                raise ValueError(f"a dict placed on {dev!r}: one device "
                                 "or a dict of placements expected")
            return {k: move(v, dev[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            if _is_device(dev):
                return type(x)(move(v, dev) for v in x)
            if len(dev) != len(x):
                raise ValueError(f"{len(x)} leaves placed on "
                                 f"{len(dev)} devices")
            return type(x)(move(v, d) for v, d in zip(x, dev))
        if isinstance(x, (np.ndarray, torch.Tensor)):
            if not _is_device(dev):
                raise ValueError(f"a leaf placed on {dev!r}: one device "
                                 "expected")
            return torch.as_tensor(x).to(as_device(
                resolve_device(dev, what="reshard")))
        return x

    if isinstance(new_shardings, (list, tuple)) \
            and len(new_shardings) == 1 \
            and not isinstance(tree, (list, tuple)):
        new_shardings = new_shardings[0]
    return move(tree, new_shardings)


@dataclasses.dataclass
class ElasticRunner:
    """Bookkeeping for failure-driven re-planning.

    ``on_pool_change(n_devices)`` returns the new mesh plan and records
    it in ``history``. ``mesh_kind`` selects the planner: ``"data_model"``
    (``plan_mesh``), ``"app"`` (the sweep engine's 1-D mesh) or
    ``"app_trial"`` (the trial engine's 2-D mesh, app degree held at
    ``app_devices``).
    """

    model_parallel: int = 16
    mesh_kind: str = "data_model"
    app_devices: int = 1
    history: list = dataclasses.field(default_factory=list)

    def on_pool_change(self, n_devices: int) -> MeshPlan:
        if self.mesh_kind == "app":
            plan = plan_app_mesh(n_devices)
        elif self.mesh_kind == "app_trial":
            plan = plan_app_trial_mesh(n_devices,
                                       app_devices=self.app_devices)
        elif self.mesh_kind == "data_model":
            plan = plan_mesh(n_devices, model_parallel=self.model_parallel)
        else:
            raise ValueError(f"unknown mesh_kind {self.mesh_kind!r}")
        self.history.append({"n_devices": n_devices,
                             "shape": plan.shape})
        return plan
