"""Within-stratum sample-unit selection (paper Section V.B).

Counterpart of ``repro.core.sampling.selection``. ``select_centroid`` is
SimPoint's deterministic choice: the units whose feature vectors lie
nearest their stratum's centroid (ties to the lower index).
``select_random`` is textbook stratified sampling and ``select_mean`` the
paper's mean selection (the unit whose baseline CPI is nearest its
stratum's mean). ``weighted_point_estimate`` is the weighted mean over
the selected units.

The random and mean choices are host algorithms over one app's labels,
as in the reference: they draw from the caller's ``np.random.Generator``
and take the float32 stratum mean in numpy's order, so the same inputs
pick the same units. Every function returns one int64 index tensor per
stratum, on the labels' device.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import apply_coverage_contract

__all__ = ["select_random", "select_centroid", "select_mean",
           "weighted_point_estimate"]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _device_of(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def select_random(labels, num_strata: int, rng: np.random.Generator, *,
                  per_stratum: int = 1) -> list[torch.Tensor]:
    """Uniform without-replacement choice of ``per_stratum`` units per
    stratum (fewer in a smaller stratum, none in an empty one), drawn as
    the reference draws them from ``rng``."""
    lab, dev = _host(labels), _device_of(labels)
    out = []
    for h in range(num_strata):
        idx = np.flatnonzero(lab == h)
        if idx.size:
            idx = rng.choice(idx, size=min(per_stratum, idx.size),
                             replace=False)
        out.append(torch.as_tensor(idx.astype(np.int64), device=dev))
    return out


def select_mean(labels, baseline_y, *, num_strata: int,
                per_stratum: int = 1) -> list[torch.Tensor]:
    """Mean selection (paper V.B.2): the ``per_stratum`` units whose
    baseline CPI lies nearest their stratum's mean baseline CPI (ties to
    the lower index)."""
    lab, dev = _host(labels), _device_of(labels)
    base = _host(baseline_y)
    out = []
    for h in range(num_strata):
        idx = np.flatnonzero(lab == h)
        if idx.size:
            d = np.abs(base[idx] - base[idx].mean())
            idx = idx[np.argsort(d, kind="stable")[:min(per_stratum,
                                                         idx.size)]]
        out.append(torch.as_tensor(idx.astype(np.int64), device=dev))
    return out


def select_centroid(labels, features, centroids, *, per_stratum: int = 1
                    ) -> list[torch.Tensor]:
    """The ``per_stratum`` units nearest each stratum's centroid.

    ``labels`` ``(n,)``; ``features`` ``(n, d)`` (the standardised matrix
    the strata were clustered on); ``centroids`` ``(L, d)``. Returns one
    int64 index tensor per stratum, on the labels' device (empty for an
    empty stratum). Distances are Euclidean norms in the features' type.
    """
    labels = torch.as_tensor(labels)
    features = torch.as_tensor(features)
    centroids = torch.as_tensor(centroids).to(features.device,
                                              features.dtype)
    out = []
    for h in range(centroids.shape[0]):
        idx = torch.nonzero(labels == h).reshape(-1)
        if idx.numel() == 0:
            out.append(idx)
            continue
        d = torch.linalg.vector_norm(
            features[idx.to(features.device)] - centroids[h][None, :], dim=1)
        order = torch.sort(d, stable=True).indices.to(idx.device)
        out.append(idx[order[:min(per_stratum, idx.numel())]])
    return out


def weighted_point_estimate(selected, y, weights, *, strict: bool = False
                            ) -> float:
    """Weighted mean over deterministically selected units:
    ``weights[h]`` = W_h; several units of a stratum are averaged first.
    Strata with positive weight and no unit follow the coverage contract
    (``types.apply_coverage_contract``): renormalised with a warning, or
    raised under ``strict``."""
    y = torch.as_tensor(y, dtype=torch.float64)
    w = torch.as_tensor(weights, dtype=torch.float64)
    mean = 0.0
    total_w = 0.0
    for h, idx in enumerate(selected):
        idx = torch.as_tensor(idx).reshape(-1)
        if idx.numel() == 0:
            continue
        mean += float(w[h]) * float(y[idx.to(y.device)].mean())
        total_w += float(w[h])
    apply_coverage_contract(
        total_w, float(w.sum()), strict=strict, empty_action="raise",
        empty_msg="no strata selected", what="selected units")
    return mean / total_w
