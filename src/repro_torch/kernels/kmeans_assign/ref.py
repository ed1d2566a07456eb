"""Plain PyTorch version of the k-means assignment kernel."""

from __future__ import annotations

import torch

from ...core.ordered import dot_nt, sum_sq


def pairwise_d2(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """``(..., n, k)`` float32 squared distances |x|^2 - 2 x.c^T + |c|^2,
    summed in the reference's order (``core.ordered``)."""
    x = x.float()
    c = centroids.float()
    return sum_sq(x)[..., :, None] - 2.0 * dot_nt(x, c) \
        + sum_sq(c)[..., None, :]


def kmeans_assign_ref(x: torch.Tensor, centroids: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment, any leading batch axes.

    ``x``: ``(..., n, d)``; ``centroids``: ``(..., k, d)``. Returns int32
    labels and float32 ``max(min d2, 0)``, both ``(..., n)``, from the
    expanded form |x|^2 - 2 x.c^T + |c|^2 in float32; ties go to the
    lowest index (``pairwise_d2``).
    """
    mind2, labels = torch.min(pairwise_d2(x, centroids), dim=-1)
    return labels.to(torch.int32), torch.clamp_min(mind2, 0.0)
