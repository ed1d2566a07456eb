"""Within-stratum unit selection (the ported subset of
``repro.core.sampling.selection``).

``select_centroid`` is SimPoint's deterministic choice: the units whose
feature vectors lie nearest their stratum's centroid (ties to the lower
index). ``weighted_point_estimate`` is the weighted mean over the
selected units. The random and mean policies wait for the flow modules
(ROADMAP.md).
"""

from __future__ import annotations

import torch

from .types import apply_coverage_contract

__all__ = ["select_centroid", "weighted_point_estimate"]


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
