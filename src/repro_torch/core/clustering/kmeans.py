"""k-means clustering in PyTorch (SimPoint's stratification step).

Counterpart of ``repro.core.clustering.kmeans``:

* k-means++ seeding (weighted: zero-weight padding rows never seed), then
  Lloyd iterations until every lane's centroid shift is at most ``tol``
  or ``max_iters`` steps have run;
* every fit runs through ONE stacked Lloyd loop (``_kmeans_fit_stacked``)
  whose leading axis is the lane — keys/restarts in ``kmeans_batch``,
  apps in ``kmeans_bank``. Converged lanes are frozen with per-lane masks,
  so lane ``b``'s result equals an unbatched fit with ``keys[b]``;
* each Lloyd step is one ``kmeans_assign`` launch over all lanes, and one
  ``segment_stats`` launch for the centroid update (the weights ride as
  an extra column, so one launch gives both sum(w x) and sum(w)). The
  kernel adds in a fixed order, so fits on the card are deterministic;
  ``torch.index_add_`` on CUDA adds atomically in an order that changes
  from run to run, and is not used here;
* the seeding draws come from ``repro_torch.prng`` (threefry, bit-exact
  with ``jax.random``) and its float32 sums follow the reference's order
  (``core.ordered``), so a seed picks the same points as the reference.

``backend``: ``"auto"`` (the kernels for CUDA tensors, the plain versions
on the CPU) or ``"plain"`` — see
``repro_torch.kernels.backend``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ... import prng
from ...kernels import backend as _backend
from ...kernels.kmeans_assign.ops import kmeans_assign
from ...kernels.segment_stats.ops import segment_stats
from ..ordered import sum_sq, tree_sum

__all__ = ["KMeansResult", "KMeansBank", "kmeans", "kmeans_batch",
           "kmeans_multi_seed", "kmeans_bank", "best_of"]


@dataclasses.dataclass(frozen=True)
class KMeansResult:
    """One fitted stratification (tensors on the fit's device)."""

    centroids: torch.Tensor   # (k, d)
    labels: torch.Tensor      # (n,)
    inertia: float
    iterations: int
    backend: str = "plain"    # route that ran: "plain" | "kernel"


@dataclasses.dataclass(frozen=True)
class KMeansBank:
    """Stacked per-lane fits of an ``(A, n, d)`` stack."""

    centroids: torch.Tensor   # (A, k, d)
    labels: torch.Tensor      # (A, n)
    inertia: torch.Tensor     # (A,)
    iterations: torch.Tensor  # (A,)
    backend: str = "plain"

    def __len__(self) -> int:
        return int(self.labels.shape[0])


def _update_centroids(x: torch.Tensor, labels: torch.Tensor, k: int,
                      old: torch.Tensor, w: torch.Tensor,
                      backend: str) -> torch.Tensor:
    """Weighted mean of each lane's assigned points from one
    ``segment_stats`` launch; empty clusters keep their old centroid."""
    vals = torch.cat([x * w[..., None], w[..., None]], dim=-1)
    # a weight-0 row adds w·x = ±0 (x finite) and w = 0 to sums that start
    # at +0 and so are never -0: label -1 (never read) changes no bit
    labels = torch.where(w != 0, labels, -1)
    sums, _, _ = segment_stats(vals, labels, k, backend=backend)
    counts = sums[..., -1]
    means = sums[..., :-1] / torch.clamp_min(counts, 1.0)[..., None]
    return torch.where((counts > 0)[..., None], means, old)


def _kmeanspp_init(keys: torch.Tensor, x: torch.Tensor, k: int,
                   w: Optional[torch.Tensor]) -> torch.Tensor:
    """Batched k-means++ seeding: ``keys (B, 2)``, ``x (B, n, d)``,
    ``w (B, n)`` or None; returns ``(B, k, d)`` seeds. Point ``i`` is drawn
    with probability proportional to ``w_i`` times its squared distance
    to the nearest seed so far.

    The reference draws step ``i`` from the ``i``-th subkey of a chain of
    splits; the chain and the uniforms depend on the keys alone, so they
    are made up front (``prng.split_chain``, one ``uniform`` call) and a
    draw is left with its data-dependent work. On the card the draws run
    as replays of one CUDA graph of that work: a draw is a few hundred
    small launches in the reference's float32 order, which Python would
    otherwise launch one by one."""
    b, n, d = x.shape
    rows = torch.arange(b, device=x.device)
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=x.device)
    subs = prng.split_chain(keys, k)
    if w is None:
        first = prng.randint(subs[:, 0], (), 0, n)
    else:
        first = prng.choice(subs[:, 0], w / torch.maximum(
            tree_sum(w), tiny)[:, None])
    u = prng.uniform(subs[:, 1:], ())
    cents = torch.zeros((b, k, d), dtype=torch.float32, device=x.device)
    cents[:, 0] = x[rows, first]
    min_d2 = sum_sq(x - cents[:, :1])
    u_step = torch.empty(b, dtype=torch.float32, device=x.device)
    new_c = torch.empty((b, d), dtype=torch.float32, device=x.device)

    def draw():
        p = min_d2 if w is None else min_d2 * w
        idx = prng.choice_u(u_step, p / torch.maximum(tree_sum(p),
                                                      tiny)[:, None])
        new_c.copy_(x[rows, idx])
        min_d2.copy_(torch.minimum(min_d2, sum_sq(x - new_c[:, None])))

    graph = None
    for i in range(1, k):
        u_step.copy_(u[:, i - 1])
        if graph is not None:
            graph.replay()
        else:
            draw()
            if x.is_cuda and k > 2:
                # the eager draw warmed every op up; the capture records
                # the next draws without running them
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    draw()
        cents[:, i] = new_c
    return cents


class _Lloyd:
    """THE Lloyd loop over a ``(B, n, d)`` stack, one step at a time:
    ``step`` launches a step for the lanes still moving and waits for
    nothing; ``moving`` reads (waits for) whether any lane still moves;
    ``result`` is the final assignment. An app-sharded fit
    (``kmeans_bank(mesh=)``) runs one per shard in lockstep, launching
    every shard's step before it reads any shard's flag."""

    def __init__(self, keys: torch.Tensor, x: torch.Tensor, k: int,
                 max_iters: int, tol: float,
                 w: Optional[torch.Tensor] = None, backend: str = "auto"):
        b = keys.shape[0]
        if x.dim() == 2:
            x = x.expand(b, *x.shape)
        self.x = x.float().contiguous()
        self.k, self.max_iters, self.tol = k, max_iters, tol
        self.w, self.backend = w, backend
        self.wu = torch.ones(self.x.shape[:2], dtype=torch.float32,
                             device=self.x.device) if w is None else w
        self.centroids = _kmeanspp_init(keys, self.x, k, w)
        self.it = torch.zeros(b, dtype=torch.int64, device=self.x.device)
        self.shift = torch.full((b,), float("inf"), dtype=torch.float32,
                                device=self.x.device)
        self._active = self._is_active()

    def _is_active(self) -> torch.Tensor:
        return (self.it < self.max_iters) & (self.shift > self.tol)

    def moving(self) -> bool:
        return bool(self._active.any())

    def step(self) -> None:
        active = self._active
        labels, _ = kmeans_assign(self.x, self.centroids,
                                  backend=self.backend)
        new_c = _update_centroids(self.x, labels, self.k, self.centroids,
                                  self.wu, self.backend)
        new_shift = sum_sq(new_c - self.centroids).amax(dim=1)
        self.centroids = torch.where(active[:, None, None], new_c,
                                     self.centroids)
        self.shift = torch.where(active, new_shift, self.shift)
        self.it = self.it + active.long()
        self._active = self._is_active()

    def result(self):
        """``(centroids (B, k, d), labels (B, n) int64, inertia (B,),
        iterations (B,))``."""
        labels, min_d2 = kmeans_assign(self.x, self.centroids,
                                       backend=self.backend)
        inertia = tree_sum(min_d2 if self.w is None else min_d2 * self.w)
        return self.centroids, labels.long(), inertia, self.it


def _kmeans_fit_stacked(keys: torch.Tensor, x: torch.Tensor, k: int,
                        max_iters: int, tol: float,
                        w: Optional[torch.Tensor] = None,
                        backend: str = "auto"):
    """THE Lloyd loop over a ``(B, n, d)`` stack (``x`` may be ``(n, d)``,
    shared by every lane). Returns ``(centroids (B, k, d), labels (B, n)
    int64, inertia (B,), iterations (B,))``."""
    fit = _Lloyd(keys, x, k, max_iters, tol, w, backend)
    while fit.moving():
        fit.step()
    return fit.result()


def _fit_sharded(key: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                 k: int, max_iters: int, tol: float, backend: str, mesh):
    """``kmeans_bank``'s fit over an ``("app",)`` mesh: each shard's lanes
    fit on its device at its local shape (``(B_local, n, k, d)``, whose
    dot and norm orders the kernel and the plain version read, as the
    reference's sharded program compiles them), all shards' Lloyd loops
    in lockstep; results come home in shard order, padding trimmed."""
    from ...distributed.appaxis import (gather, lane_shards, mesh_grid,
                                        on_shard, pad_app_axis, to_device)
    grid = mesh_grid(mesh)[:, :1]
    a_n = x.shape[0]
    xp, wp = pad_app_axis(x, len(grid)), pad_app_axis(w, len(grid))
    fits = []
    for shard in lane_shards(grid, a_n):
        with on_shard(shard):
            xs, ws = to_device((xp[shard.lanes], wp[shard.lanes]),
                               shard.device)
            fits.append((shard, _Lloyd(
                key.to(shard.device).expand(xs.shape[0], 2), xs, k,
                max_iters, tol, ws, backend)))
    live = [f for f in fits if f[1].moving()]
    while live:
        for shard, fit in live:
            with on_shard(shard):
                fit.step()
        live = [f for f in live if f[1].moving()]
    outs = []
    for shard, fit in fits:
        with on_shard(shard):
            outs.append(fit.result())
    return gather(outs, x.device, a_n)


def _as_keys(keys, seeds, device) -> torch.Tensor:
    if (keys is None) == (seeds is None):
        raise ValueError("pass exactly one of keys= or seeds=")
    if keys is None:
        keys = torch.stack([prng.PRNGKey(int(s), device=device)
                            for s in seeds])
    keys = torch.as_tensor(keys, dtype=torch.int64).to(device)
    return keys[None] if keys.dim() == 1 else keys


def _as_points(features, device, rank: int) -> torch.Tensor:
    x = torch.as_tensor(features)
    x = x.to(device if device is not None else x.device, torch.float32)
    if x.dim() != rank:
        shape = "(n, d)" if rank == 2 else "(A, n, d)"
        raise ValueError(f"expected {shape}, got {tuple(x.shape)}")
    return x


def kmeans_batch(features, k: int, *, keys=None, seeds=None,
                 max_iters: int = 100, backend: str = "auto",
                 tol: float = 1e-8, device=None) -> list[KMeansResult]:
    """One fit of ``features (n, d)`` per key/seed, as one stacked loop."""
    x = _as_points(features, device, 2)
    if k < 1 or k > x.shape[0]:
        raise ValueError(f"k={k} invalid for n={x.shape[0]}")
    kb = _as_keys(keys, seeds, x.device)
    cents, labels, inertia, iters = _kmeans_fit_stacked(
        kb, x, k, max_iters, tol, backend=backend)
    route = _backend.resolve_route(x, backend)
    return [KMeansResult(centroids=cents[i], labels=labels[i],
                         inertia=float(inertia[i]),
                         iterations=int(iters[i]), backend=route)
            for i in range(kb.shape[0])]


def kmeans(features, k: int, *, key=None, seed: int = 0,
           max_iters: int = 100, backend: str = "auto", tol: float = 1e-8,
           restarts: int = 1, device=None) -> KMeansResult:
    """Fit k-means; ``restarts > 1`` keeps the lowest-inertia of several
    seedings (keys split from ``key`` as the reference splits them)."""
    x = _as_points(features, device, 2)
    if key is None:
        key = prng.PRNGKey(seed, device=x.device)
    key = torch.as_tensor(key, dtype=torch.int64).to(x.device)
    if restarts <= 1:
        return kmeans_batch(x, k, keys=key[None], max_iters=max_iters,
                            backend=backend, tol=tol)[0]
    subs = []
    for _ in range(restarts):
        pair = prng.split(key)
        key, sub = pair[0], pair[1]
        subs.append(sub)
    return best_of(kmeans_batch(x, k, keys=torch.stack(subs),
                                max_iters=max_iters, backend=backend,
                                tol=tol))


def kmeans_multi_seed(features, k: int, *, seeds, max_iters: int = 100,
                      backend: str = "auto", device=None
                      ) -> list[KMeansResult]:
    """One fit per seed (the paper's 10-seed repetitions for Figs 7-8),
    all seeds as the lanes of one stacked Lloyd loop."""
    return kmeans_batch(features, k, seeds=list(seeds), max_iters=max_iters,
                        backend=backend, device=device)


def best_of(results: list[KMeansResult]) -> KMeansResult:
    """The lowest-inertia fit of a batch."""
    return min(results, key=lambda r: r.inertia)


def kmeans_bank(features, k: int, *, weights=None, key=None, seed: int = 0,
                max_iters: int = 100, backend: str = "auto",
                tol: float = 1e-8, device=None, mesh=None) -> KMeansBank:
    """One weighted fit per lane of an ``(A, n, d)`` stack.

    Every lane fits its own points with its own ``weights`` (0 = padded
    row: never seeds a centroid, never moves one), all from the same
    ``key``/``seed``, so lane ``a`` equals a single weighted fit with that
    key. Each Lloyd step is one assignment launch for all lanes. With
    ``mesh`` (an ``("app",)`` mesh) the lanes are split over its devices:
    each shard's steps launch both kernels at its local shape, so a lane's
    result is the unsharded one wherever the local shape's dot and norm
    orders are the full shape's (``core.ordered.reference_dot_order``: the
    dot's depends on k and d alone, so only the norms' can part).
    """
    x = _as_points(features, device, 3)
    if k < 1 or k > x.shape[1]:
        raise ValueError(f"k={k} invalid for n={x.shape[1]}")
    w = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device) \
        if weights is None else torch.as_tensor(weights).to(x.device,
                                                            torch.float32)
    if key is None:
        key = prng.PRNGKey(seed, device=x.device)
    key = torch.as_tensor(key, dtype=torch.int64).to(x.device)
    if mesh is None:
        cents, labels, inertia, iters = _kmeans_fit_stacked(
            key.expand(x.shape[0], 2), x, k, max_iters, tol, w=w,
            backend=backend)
    else:
        cents, labels, inertia, iters = _fit_sharded(
            key, x, w, k, max_iters, tol, backend, mesh)
    return KMeansBank(centroids=cents, labels=labels, inertia=inertia,
                      iterations=iters, backend=_backend.resolve_route(x, backend))
