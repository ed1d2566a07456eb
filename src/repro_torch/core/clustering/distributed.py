"""Distributed k-means over a mesh's data axes (multi-device stratification).

Counterpart of ``repro.core.clustering.distributed``. The paper's §VII.B
scalability argument clusters a large phase-1 sample instead of the whole
application; at fleet scale even that is data-parallel: the points are
split over the mesh's ``data`` axes (contiguous blocks, in order), every
shard computes its points' labels (``kmeans_assign``) and its per-cluster
sums and counts (``segment_stats``) on its own device, and the shards'
statistics are summed in shard order on one device, O(k·d) bytes a Lloyd
step whatever n is. The k-means++ initialisation runs on a subsample of
the first 8192 points, as the reference's does.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch

from ...distributed.appaxis import lane_shards, on_shard, to_device
from ...kernels.kmeans_assign.ops import kmeans_assign
from ...kernels.segment_stats.ops import segment_stats
from ..ordered import tree_sum

__all__ = ["shard_points", "make_distributed_kmeans_step",
           "make_distributed_assign", "distributed_kmeans"]


def _data_grid(mesh, data_axes: Sequence[str]) -> np.ndarray:
    """The devices along ``data_axes`` (row-major) as a one-column grid,
    the mesh's other axes held at index 0 (their devices would repeat the
    work and are not used)."""
    names = mesh.axis_names
    missing = [a for a in data_axes if a not in names]
    if missing:
        raise ValueError(f"mesh axes {names} lack data axes {missing}")
    ranges = [range(mesh.devices.shape[i]) if a in data_axes else range(1)
              for i, a in enumerate(names)]
    devs = [mesh.devices[at] for at in itertools.product(*ranges)]
    grid = np.empty((len(devs), 1), dtype=object)
    grid[:, 0] = devs
    return grid


def shard_points(x: torch.Tensor, mesh,
                 data_axes: Sequence[str] = ("data",)) -> list[torch.Tensor]:
    """``(n, d)`` points as contiguous blocks, one on each data shard's
    device (the last block may be shorter)."""
    return [to_device(x[shard.lanes], shard.device)
            for shard in lane_shards(_data_grid(mesh, data_axes),
                                     x.shape[0])]


def _local_stats(x: torch.Tensor, centroids: torch.Tensor, k: int):
    """One shard's labels, per-cluster sums and counts, and inertia."""
    labels, min_d2 = kmeans_assign(x[None], centroids[None])
    sums, _, counts = segment_stats(x[None], labels, k)
    return labels[0], sums[0], counts[0], tree_sum(min_d2[0])


def _each_shard(mesh, data_axes: Sequence[str], fn):
    """``run(xs, centroids)``: ``fn(block, centroids)`` on each data
    shard's device, the centroids copied there, in shard order."""
    grid = _data_grid(mesh, data_axes)

    def run(xs: list[torch.Tensor], centroids: torch.Tensor) -> list:
        shards = lane_shards(grid, sum(xl.shape[0] for xl in xs))
        if len(xs) != len(shards):
            raise ValueError(f"{len(xs)} blocks for {len(shards)} data "
                             "shards: shard the points with shard_points")
        out = []
        for shard, xl in zip(shards, xs):
            with on_shard(shard):
                out.append(fn(*to_device((xl, centroids), shard.device)))
        return out

    return run


def make_distributed_kmeans_step(mesh, data_axes: Sequence[str], k: int):
    """One Lloyd iteration over sharded points: ``step(xs, centroids)``
    takes ``shard_points``' blocks and the (k, d) centroids (on the home
    device) and returns the new centroids and the global inertia there."""
    local = _each_shard(mesh, data_axes,
                        lambda xl, c: _local_stats(xl, c, k)[1:])

    def step(xs: list[torch.Tensor], centroids: torch.Tensor):
        parts = local(xs, centroids)
        home = centroids.device
        sums, counts, inertia = to_device(parts[0], home)
        for part in parts[1:]:                      # shard order
            s, c, i = to_device(part, home)
            sums, counts, inertia = sums + s, counts + c, inertia + i
        safe = torch.clamp_min(counts, 1.0)
        new_c = torch.where((counts > 0)[:, None], sums / safe[:, None],
                            centroids)
        return new_c, inertia

    return step


def make_distributed_assign(mesh, data_axes: Sequence[str]):
    """The final assignment over sharded points: ``assign(xs, centroids)``
    gives each block's labels on its own device."""
    return _each_shard(
        mesh, data_axes,
        lambda xl, c: kmeans_assign(xl[None], c[None])[0][0])


def distributed_kmeans(x, k: int, mesh, *,
                       data_axes: Sequence[str] = ("data",),
                       iters: int = 25, seed: int = 0):
    """Shard ``x (n, d)``, seed from a k-means++ fit of the first 8192
    points (one Lloyd step, two restarts), run ``iters`` Lloyd steps over
    the shards, and return ``(centroids (k, d), labels (n,), inertia)``
    with the centroids and labels on ``x``'s device."""
    from .kmeans import kmeans
    x = torch.as_tensor(x).float()
    n = x.shape[0]
    centroids = kmeans(x[:min(n, 8192)], k, seed=seed, max_iters=1,
                       restarts=2).centroids
    xs = shard_points(x, mesh, data_axes)
    step = make_distributed_kmeans_step(mesh, data_axes, k)
    inertia = torch.tensor(float("inf"))
    for _ in range(iters):
        centroids, inertia = step(xs, centroids)
    labels = make_distributed_assign(mesh, data_axes)(xs, centroids)
    return (centroids, torch.cat(to_device(labels, x.device)).long(),
            float(inertia))
