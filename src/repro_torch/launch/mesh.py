"""Device meshes: the app and trial axes, the host and production
meshes.

Counterpart of ``repro.launch.mesh``. A ``Mesh`` is a grid of
``torch.device``s with one name per axis: the engine shards its app axis
(and the Monte-Carlo engine its trial axis) over it
(``repro_torch.distributed.appaxis``); the trainer shards parameters and
optimizer moments over a ``("data", "model")`` or ``("pod", "data",
"model")`` mesh (``make_host_mesh``, ``make_production_mesh``;
``repro_torch.distributed.spmd``).

The default pool is every visible CUDA device; an empty pool raises.
Entries may repeat: ``make_app_mesh(devices=["cpu"] * 4)`` or
``["cuda:0"] * 4`` is a four-shard mesh over one device, the counterpart
of the reference's ``--xla_force_host_platform_device_count``, which runs
the split, padding, merge and re-mesh logic for real on one device. A
CUDA entry that names a device which is not there raises: a shard never
quietly runs on another device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "make_app_mesh", "make_app_trial_mesh", "make_host_mesh",
           "make_production_mesh", "data_axes", "axis_size",
           "default_devices", "as_device"]


def as_device(dev) -> torch.device:
    """``dev`` as a ``torch.device``; a CUDA device gets its index (the
    current one when it names none) and must exist."""
    d = torch.device(dev)
    if d.type != "cuda":
        return d
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {d} named, but no CUDA device is "
                           "available")
    index = torch.cuda.current_device() if d.index is None else d.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"mesh device cuda:{index} is not there "
                           f"({torch.cuda.device_count()} visible)")
    return torch.device("cuda", index)


def default_devices() -> list[torch.device]:
    """Every visible CUDA device; raises when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device for the mesh; pass devices= "
                           "(for example ['cpu'] * 4) to mesh the CPU")
    return [torch.device("cuda", i) for i in range(n)]


class Mesh:
    """A grid of devices (an object array of ``torch.device``s) with one
    name per axis. ``shape`` maps each axis name to its size, as a JAX
    mesh's does. Meshes compare and hash by their grid and names."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        grid = np.empty(arr.shape, dtype=object)
        for at in np.ndindex(arr.shape):
            grid[at] = as_device(arr[at])
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-D device grid with axis names "
                             f"{tuple(axis_names)}")
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]})")


def _pool(max_devices: Optional[int], devices) -> list:
    devs = list(devices) if devices is not None else default_devices()
    if not devs:
        raise ValueError("an empty device pool cannot form a mesh")
    n = len(devs) if max_devices is None else max(1, min(int(max_devices),
                                                         len(devs)))
    return devs[:n]


def make_app_mesh(max_devices: Optional[int] = None, *,
                  devices: Optional[Sequence] = None) -> Mesh:
    """1-D ``("app",)`` mesh for app-sharded builds and sweeps: app lanes
    never communicate, so any device count works (the engine pads the app
    axis up to it by edge replication). ``devices`` overrides the pool
    (the elastic supervisor passes the surviving subset)."""
    return Mesh(_pool(max_devices, devices), ("app",))


def make_app_trial_mesh(app_devices: int = 1,
                        max_devices: Optional[int] = None, *,
                        devices: Optional[Sequence] = None) -> Mesh:
    """2-D ``("app", "trial")`` mesh for the Monte-Carlo engine:
    ``app_devices`` rows shard the app axis, the remaining devices form
    the trial axis across which each chunk's PRNG blocks split. Devices
    that do not fill the rectangle stay idle."""
    devs = _pool(max_devices, devices)
    app = max(1, min(int(app_devices), len(devs)))
    trial = len(devs) // app
    grid = np.empty((app, trial), dtype=object)
    for i in range(app * trial):
        grid[i // trial, i % trial] = devs[i]
    return Mesh(grid, ("app", "trial"))


def _grid(devs: list, shape: tuple) -> np.ndarray:
    grid = np.empty(shape, dtype=object)
    for i, at in enumerate(np.ndindex(shape)):
        grid[at] = devs[i]
    return grid


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """The reference's pod mesh: ``("data", "model")`` 16 x 16, or with
    ``multi_pod`` ``("pod", "data", "model")`` 2 x 16 x 16, over the first
    256 or 512 devices of the pool (``devices``, or every visible card).
    A smaller pool raises: the mesh is never shrunk."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    devs = list(devices) if devices is not None else default_devices()
    if len(devs) < need:
        raise RuntimeError(f"need {need} devices for mesh {shape}, have "
                           f"{len(devs)}: pass devices= (a pool may name "
                           "one device many times)")
    return Mesh(_grid(devs[:need], shape), axes)


def make_host_mesh(model_parallel: int = 1, *,
                   devices: Optional[Sequence] = None) -> Mesh:
    """``("data", "model")`` mesh of shape ``(n // mp, mp)`` over a pool
    of n devices (``devices``, or every visible card), ``mp`` the
    ``model_parallel`` asked for, at most n. As the reference's
    ``jax.make_mesh``, it raises where mp does not divide n."""
    devs = _pool(None, devices)
    mp = max(1, min(int(model_parallel), len(devs)))
    if len(devs) % mp:
        raise ValueError(f"--model-parallel {mp} does not divide the "
                         f"{len(devs)} devices of the pool")
    return Mesh(_grid(devs, (len(devs) // mp, mp)), ("data", "model"))


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The pure data-parallel axes of a mesh (``"pod"`` folds into
    ``"data"``)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def axis_size(mesh: Mesh, names: Sequence[str]) -> int:
    """The number of devices along the named axes (absent names count 1)."""
    size = 1
    for n in names:
        if n in mesh.axis_names:
            size *= mesh.shape[n]
    return size
