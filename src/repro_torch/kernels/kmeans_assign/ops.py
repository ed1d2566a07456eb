"""Public wrapper of the batch-native k-means assignment kernel.

Counterpart of ``repro.kernels.kmeans_assign.ops``. Every input rank
takes one path: the axes before the trailing ``(n, d)`` flatten into the
kernel's lane axis, so a ``(B, n, d)`` stack of fits is one launch.
A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel of ``csrc/kmeans_assign.cuh`` or raises
(``repro_torch.kernels.backend``). The kernel is built as three units that
nvcc builds at once: ``kmeans_assign.cu`` (the one-chain order at d <=
40, and the interleaved orders at d <= 48), ``kmeans_assign_wide.cu``
(the interleaved orders at 48 < d <= 64) and ``kmeans_assign_128.cu``
(above 64); a launch goes through the first unit whose library says it serves the launch's
order and width (``kmeans_assign_serves``).

The kernel reads the points and centroids at their real widths: there is
no padding, so no padded centroid can win. Both the kernel and the plain
version take the dot product's order from the reference's rule at the
launch's shape (``ref.dot_order``): interleaved chains, one chain, or the
other interleave (``core.ordered.reference_dot_order``), and each squared
norm's from its row's place (``core.ordered.norm_vector_rows``), so they
agree bitwise at every shape. The kernel's one-chain order is built for
d <= 40: no unit serves a wider launch in it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from ...core.ordered import DOT_ORDER_NAMES, norm_vector_rows
from ...device import resolve_device
from .. import backend as _backend
from .ref import dot_order, kmeans_assign_ref

__all__ = ["kmeans_assign", "kmeans_assign_np", "last_dispatch",
           "launch_count", "reset_launch_count", "launch_counts_by_shard"]

# launches of the CUDA kernel in this process, and the latest one's shape
_launches = 0
_by_shard: dict[int, int] = {}
_last_dispatch: Optional[dict] = None


def launch_count() -> int:
    """Number of CUDA kernel launches since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0
    _by_shard.clear()


def launch_counts_by_shard() -> dict[int, int]:
    """The launches counted since the last reset that a mesh shard's
    program made, by shard index (``backend.shard_scope``)."""
    return dict(_by_shard)


def _count_launch() -> None:
    global _launches
    _launches += 1
    shard = _backend.current_shard()
    if shard is not None:
        _by_shard[shard] = _by_shard.get(shard, 0) + 1


def last_dispatch() -> Optional[dict]:
    """Shape record of the latest kernel launch (``None`` before any):
    ``batch``, ``batch_shape``, ``n``, ``k``, ``d``, ``order`` (the dot
    product's: ``"four"``, ``"chain"`` or ``"swapped"``), ``grid`` (the
    persistent blocks), ``tiles`` (the (lane, point tile) items they walk) and
    ``split`` (threads that share a point, each scanning a share of the
    centroids). Plain calls leave it untouched."""
    return None if _last_dispatch is None else dict(_last_dispatch)


def _reset_dispatch_record() -> None:
    global _last_dispatch
    _last_dispatch = None


# the build units, asked in this order which serves a launch (a unit is
# built the first time it is asked)
_UNITS = ("kmeans_assign", "kmeans_assign_wide", "kmeans_assign_128")


@functools.lru_cache(maxsize=None)
def _entry(order: str, d: int):
    """The C entry of the first build unit that serves this order and
    width (each library reports it: ``kmeans_assign_serves``)."""
    for unit in _UNITS:
        lib = _backend.library(unit)
        if lib.kmeans_assign_serves(ctypes.c_int(d),
                                    ctypes.c_int(DOT_ORDER_NAMES.index(
                                        order))):
            fn = lib.kmeans_assign_f32
            vp, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [vp, vp, i, i, i, i, i, i, i, vp, vp, vp, vp]
            fn.restype = ctypes.c_int
            return fn
    raise ValueError(f"no kmeans_assign build unit serves d = {d} in the "
                     f"{order!r} dot order")


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor, *,
                  backend: str = "auto"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment over any leading batch axes.

    ``x``: ``(..., n, d)`` points; ``centroids``: ``(..., k, d)`` with the
    same leading axes. Returns int32 labels and float32 ``max(min d2, 0)``,
    both ``(..., n)``; ties go to the lowest centroid index.
    """
    if x.dim() < 2 or centroids.dim() != x.dim():
        raise ValueError(
            f"rank mismatch: x {tuple(x.shape)} vs centroids "
            f"{tuple(centroids.shape)} (need matching leading axes plus "
            "trailing (n|k, d))")
    if x.shape[:-2] != centroids.shape[:-2]:
        raise ValueError(f"batch mismatch: x {tuple(x.shape)} vs centroids "
                         f"{tuple(centroids.shape)}")
    if centroids.shape[-1] != x.shape[-1]:
        raise ValueError(f"dim mismatch: x {tuple(x.shape)} vs centroids "
                         f"{tuple(centroids.shape)}")
    if _backend.resolve_route(x, backend) == "plain":
        return kmeans_assign_ref(x, centroids)
    if centroids.device != x.device:
        raise ValueError("x and centroids must be on the same device")

    batch_shape = tuple(x.shape[:-2])
    n, d = x.shape[-2:]
    k = centroids.shape[-2]
    b = math.prod(batch_shape)
    order = dot_order(x, centroids)
    labels, mind2, geometry = _launch(x.reshape(b, n, d),
                                      centroids.reshape(b, k, d), order)
    global _last_dispatch
    _count_launch()
    _last_dispatch = {"batch": b, "batch_shape": batch_shape, "n": n,
                      "k": k, "d": d, "order": order,
                      "grid": (geometry[0],), "tiles": geometry[1],
                      "split": geometry[2]}
    return (labels.reshape(*batch_shape, n), mind2.reshape(*batch_shape, n))


def kmeans_assign_np(x: np.ndarray, centroids: np.ndarray, *,
                     device=None) -> tuple[np.ndarray, np.ndarray]:
    """``kmeans_assign`` with numpy in and out (host-side callers): the
    arrays go to ``device`` (the card when None) and the int32 labels and
    float32 distances come back."""
    dev = resolve_device(device, what="kmeans_assign_np")
    labels, mind2 = kmeans_assign(
        torch.as_tensor(np.asarray(x, np.float32), device=dev),
        torch.as_tensor(np.asarray(centroids, np.float32), device=dev))
    return labels.cpu().numpy(), mind2.cpu().numpy()


def _launch(x: torch.Tensor, c: torch.Tensor, order: str):
    """One launch of the kernel on CUDA ``x (b, n, d)`` and ``c (b, k, d)``
    with the dot product in ``order`` (``core.ordered.DOT_ORDER_NAMES``):
    ``(labels, mind2, geometry)``. Not counted: ``kmeans_assign`` counts
    its own launches, and a caller timing the other order calls this."""
    b, n, d = x.shape
    k = c.shape[1]
    xb = x.float().contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()            # the tiles' bulk copies read 16-byte units
    cb = c.float().contiguous()
    labels = torch.empty((b, n), dtype=torch.int32, device=x.device)
    mind2 = torch.empty((b, n), dtype=torch.float32, device=x.device)
    geometry = (ctypes.c_int * 3)()
    fn = _entry(order, d)
    code = fn(_backend.ptr(xb), _backend.ptr(cb), b, n, k, d,
              DOT_ORDER_NAMES.index(order), norm_vector_rows(n, d),
              norm_vector_rows(k, d), _backend.ptr(labels),
              _backend.ptr(mind2), geometry,
              _backend.stream_handle(x.device))
    _backend.check_launch("kmeans_assign", code)
    return labels, mind2, geometry
