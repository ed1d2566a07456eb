"""App-axis (and trial-axis) data parallelism for batched programs.

Counterpart of ``repro.distributed.appaxis``. The experiment engine treats
the application as a leading batch axis: every heavy pass (census CPI,
memo fills, k-means fits, fused sweeps, Monte-Carlo trials) is one
batched program over ``(A, ...)`` stacks. Here the same programs run over
a ``("app",)`` mesh (``repro_torch.launch.mesh.make_app_mesh``):

* the app axis is padded up to a multiple of the mesh's app-axis size by
  edge replication (recomputing a real app is always safe; the padded
  rows are dropped on return);
* a shard is a contiguous block of the padded app axis: its inputs move
  to its device and the program runs there, once per shard, launched one
  shard after another without waiting on any (launches are asynchronous
  per device);
* the outputs come back to the home device (that of the first sharded
  input) in shard order, are concatenated along the app axis and trimmed.

Lanes never communicate, so a lane's result is the one the unsharded
program gives it, wherever it runs, as long as the program computes each
lane in an order that the other lanes do not change.

A ``("app", "trial")`` mesh (``make_app_trial_mesh``) adds a trial axis
for the Monte-Carlo engine (``make_app_trial_sharded``): every device of
an app row runs the program on the row's apps with its own ``Shard``
(its trial index picks its PRNG blocks), and the row's outputs are merged
in trial-index order by the caller's ``merge`` (the reference's ``psum``
over the trial axis; ``tables.trial_stats_merge`` for the trial
accumulators) before the rows are concatenated.

One process and no ``torch.distributed``: the mesh's devices are driven
from here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..kernels import backend as _backend

__all__ = ["Shard", "app_axis_name", "app_trial_axes", "pad_app_axis",
           "mesh_grid", "lane_shards", "gather",
           "make_app_sharded", "app_sharded_cached",
           "make_app_trial_sharded", "tree_map", "to_device", "cat_tree",
           "on_device", "on_shard"]


@dataclasses.dataclass(frozen=True)
class Shard:
    """Where one program of a sharded call runs: its place on the mesh's
    app and trial axes (``trial`` is 0 on a 1-D mesh), its row-major
    ``index`` on the mesh, its device and its lanes of the padded app
    axis."""

    app: int
    trial: int
    index: int
    device: torch.device
    lanes: slice


def app_axis_name(mesh) -> str:
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"app sharding expects a 1-D mesh, got axes {mesh.axis_names}")
    return mesh.axis_names[0]


def app_trial_axes(mesh) -> tuple[str, Optional[str]]:
    """``(app_axis, trial_axis)`` names of a trial-engine mesh: the 1-D
    ``("app",)`` mesh (no trial axis) or the 2-D ``("app", "trial")``
    mesh; the leading axis shards apps, the trailing one trials."""
    if len(mesh.axis_names) == 1:
        return mesh.axis_names[0], None
    if len(mesh.axis_names) == 2:
        return mesh.axis_names[0], mesh.axis_names[1]
    raise ValueError(
        f"trial sharding expects a 1-D ('app',) or 2-D ('app', 'trial') "
        f"mesh, got axes {mesh.axis_names}")


def pad_app_axis(arr, multiple: int):
    """Pad the leading axis to a multiple by edge-replicating the last row
    (a numpy array or a tensor)."""
    a = arr.shape[0]
    pad = (-a) % multiple
    if pad == 0:
        return arr
    reps = np.concatenate([np.arange(a), np.full(pad, a - 1)])
    if isinstance(arr, torch.Tensor):
        return arr[torch.as_tensor(reps, device=arr.device)]
    return arr[reps]


def mesh_grid(mesh) -> np.ndarray:
    """The mesh's devices as an (app rows, trial columns) grid: a 1-D
    mesh is one column."""
    grid = mesh.devices
    return grid if grid.ndim == 2 else grid[:, None]


def lane_shards(grid: np.ndarray, size: int) -> list[Shard]:
    """One ``Shard`` per device of an (rows, columns) device ``grid``,
    row-major: row ``s`` takes the contiguous lanes ``[s per, (s + 1)
    per)`` of a ``size``-lane axis, ``per = ceil(size / rows)`` (the lanes
    of an axis padded to a multiple of the rows, or the last row's fewer
    lanes of an unpadded one)."""
    rows, cols = grid.shape
    per = -(-size // rows)
    return [Shard(app=s, trial=t, index=s * cols + t, device=grid[s, t],
                  lanes=slice(s * per, (s + 1) * per))
            for s in range(rows) for t in range(cols)]


def gather(outs: Sequence, home: torch.device, size: int):
    """Lane-leading output trees, one a shard in shard order, on ``home``,
    concatenated along the lanes and cut to the first ``size``."""
    out = cat_tree([to_device(o, home) for o in outs])
    return tree_map(lambda o: o[:size], out)


def on_device(dev: torch.device):
    """A context that makes ``dev`` current while its shard's kernels
    launch (a CUDA device), or nothing."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


@contextlib.contextmanager
def on_shard(shard: Shard):
    """``on_device`` for one shard, whose kernel launches the wrappers
    also count by its index."""
    with on_device(shard.device), _backend.shard_scope(shard.index):
        yield


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor or array leaf of nested tuples, lists,
    dicts and dataclasses (``None`` and other leaves pass through)."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(*(tree_map(fn, getattr(tree, f.name))
                            for f in dataclasses.fields(tree)))
    return tree


def _zip_map(fn: Callable, trees: Sequence):
    """``fn`` on the lists of corresponding leaves of equal-structured
    trees."""
    t0 = trees[0]
    if isinstance(t0, (torch.Tensor, np.ndarray)):
        return fn(list(trees))
    if isinstance(t0, dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_zip_map(fn, [t[i] for t in trees])
                        for i in range(len(t0)))
    if dataclasses.is_dataclass(t0) and not isinstance(t0, type):
        return type(t0)(*(_zip_map(fn, [getattr(t, f.name) for t in trees])
                          for f in dataclasses.fields(t0)))
    return t0


def to_device(tree, dev: torch.device):
    """Every leaf as a tensor on ``dev`` (copies are asynchronous where
    the devices allow)."""
    def move(x):
        t = torch.as_tensor(x)
        return t if t.device == dev else t.to(dev, non_blocking=True)
    return tree_map(move, tree)


def cat_tree(trees: Sequence, dim: int = 0):
    """Concatenate equal-structured trees leaf by leaf along ``dim``."""
    if len(trees) == 1:
        return trees[0]
    return _zip_map(lambda xs: torch.cat(xs, dim=dim), trees)


def _home(args, rep) -> Optional[torch.device]:
    for i, a in enumerate(args):
        if i not in rep and isinstance(a, torch.Tensor):
            return a.device
    return None


def _split_args(args, rep, lanes: slice, dev: torch.device):
    return tuple(to_device(a, dev) if i in rep
                 else to_device(a[lanes], dev)
                 for i, a in enumerate(args))


def _sharded(fn: Callable, grid: np.ndarray, replicated: Sequence[int],
             merge: Optional[Callable]) -> Callable:
    """``fn(*local, shard=Shard)`` once per device of ``grid``; each row's
    outputs merged in trial order (``merge``, one column passed as is),
    the rows gathered along the app axis."""
    n_app, n_trial = grid.shape
    rep = frozenset(replicated)

    def call(*args: Any):
        a_size = next(a.shape[0] for i, a in enumerate(args)
                      if i not in rep)
        home = _home(args, rep) or grid[0, 0]
        padded = tuple(a if i in rep else pad_app_axis(a, n_app)
                       for i, a in enumerate(args))
        rows, row = [], []
        for shard in lane_shards(grid, a_size):
            local = _split_args(padded, rep, shard.lanes, shard.device)
            with on_shard(shard):
                row.append(fn(*local, shard=shard))
            if shard.trial == n_trial - 1:
                row = [to_device(o, home) for o in row]
                rows.append(row[0] if n_trial == 1 else merge(row))
                row = []
        return gather(rows, home, a_size)

    return call


def make_app_sharded(fn: Callable, mesh,
                     replicated: Sequence[int] = ()) -> Callable:
    """Wrap a batched-over-app ``fn`` so its app axis runs over the mesh.

    ``fn`` takes tensors whose leading axis is the app axis (argument
    positions in ``replicated`` are given whole to every shard, e.g. a
    config matrix or a PRNG key) and returns a tree of tensors with the
    app axis leading. On a 2-D ``("app", "trial")`` mesh only the app
    axis is used: each app row runs once, on its first device."""
    return _sharded(lambda *a, shard: fn(*a), mesh_grid(mesh)[:, :1],
                    replicated, None)


@functools.lru_cache(maxsize=None)
def app_sharded_cached(fn: Callable, mesh,
                       replicated: tuple = ()) -> Callable:
    """``make_app_sharded`` kept per (function, mesh, replicated) for
    module-level functions."""
    return make_app_sharded(fn, mesh, replicated)


def make_app_trial_sharded(fn: Callable, mesh,
                           replicated: Sequence[int] = (), *,
                           merge: Callable) -> Callable:
    """``make_app_sharded`` generalized to ``("app", "trial")`` meshes.

    Inputs follow the app contract (app-leading, ``replicated`` positions
    whole). ``fn(*local, shard=Shard)`` runs once per device of the mesh;
    ``merge(outs)`` folds one app row's outputs, given in trial-index
    order (one output on a 1-D mesh is passed through as is), and the
    rows are then concatenated along the app axis, every leaf app-leading,
    and the padding dropped."""
    return _sharded(fn, mesh_grid(mesh), replicated, merge)
