"""Public wrapper of the batch-native k-means assignment kernel.

Counterpart of ``repro.kernels.kmeans_assign.ops``. Every input rank
takes one path: the axes before the trailing ``(n, d)`` flatten into the
kernel's lane axis, so a ``(B, n, d)`` stack of fits is one launch.
A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
``csrc/kmeans_assign.cu`` or raises (``repro_torch.kernels.backend``).

The kernel reads the points and centroids at their real widths: there is
no padding, so no padded centroid can win and every valid row's result is
what the plain version computes, up to float32 rounding of the sums.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import backend as _backend
from .ref import kmeans_assign_ref

__all__ = ["kmeans_assign", "last_dispatch", "launch_count",
           "reset_launch_count"]

# launches of the CUDA kernel in this process, and the latest one's shape
_launches = 0
_last_dispatch: Optional[dict] = None


def launch_count() -> int:
    """Number of CUDA kernel launches since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def last_dispatch() -> Optional[dict]:
    """Shape record of the latest kernel launch (``None`` before any):
    ``batch``, ``batch_shape``, ``n``, ``k``, ``d`` and ``grid``. Plain
    calls leave it untouched."""
    return None if _last_dispatch is None else dict(_last_dispatch)


def _reset_dispatch_record() -> None:
    global _last_dispatch
    _last_dispatch = None


def _lib():
    lib = _backend.library("kmeans_assign")
    fn = lib.kmeans_assign_f32
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, i, i, i, i, vp, vp, vp]
        fn.restype = ctypes.c_int
    return fn


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
    xb = x.reshape(b, n, d).float().contiguous()
    cb = centroids.reshape(b, k, d).float().contiguous()
    labels = torch.empty((b, n), dtype=torch.int32, device=x.device)
    mind2 = torch.empty((b, n), dtype=torch.float32, device=x.device)
    code = _lib()(_backend.ptr(xb), _backend.ptr(cb), b, n, k, d,
                  _backend.ptr(labels), _backend.ptr(mind2),
                  _backend.stream_handle(x.device))
    _backend.check_launch("kmeans_assign", code)
    global _launches, _last_dispatch
    _launches += 1
    _last_dispatch = {"batch": b, "batch_shape": batch_shape, "n": n,
                      "k": k, "d": d, "grid": (-(-n // 128), b)}
    return (labels.reshape(*batch_shape, n), mind2.reshape(*batch_shape, n))
