"""Plain PyTorch version of the k-means assignment kernel."""

from __future__ import annotations

import math
from typing import Optional

import torch

from ...core.ordered import dot_in_order, reference_dot_order, sum_sq_rows


def dot_order(x: torch.Tensor, centroids: torch.Tensor) -> str:
    """The reference's dot order (``core.ordered.reference_dot_order``) at
    this assignment's shape: leading axes flatten into the lane count."""
    b = math.prod(x.shape[:-2])
    n, d = x.shape[-2:]
    return reference_dot_order(b, n, centroids.shape[-2], d)


def pairwise_d2(x: torch.Tensor, centroids: torch.Tensor, *,
                order: Optional[str] = None) -> torch.Tensor:
    """``(..., n, k)`` float32 squared distances |x|^2 - 2 x.c^T + |c|^2,
    summed in the reference's order (``core.ordered``): squared norms by
    their rows' places (``sum_sq_rows``), the dot in ``order`` (default:
    the reference's at this shape, ``dot_order``)."""
    x = x.float()
    c = centroids.float()
    dot = dot_in_order(x, c, order or dot_order(x, c))
    return sum_sq_rows(x)[..., :, None] - 2.0 * dot \
        + sum_sq_rows(c)[..., None, :]


def kmeans_assign_ref(x: torch.Tensor, centroids: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment, any leading batch axes.

    ``x``: ``(..., n, d)``; ``centroids``: ``(..., k, d)``. Returns int32
    labels and float32 ``max(min d2, 0)``, both ``(..., n)``, from the
    expanded form |x|^2 - 2 x.c^T + |c|^2 in float32; ties go to the
    lowest index (``pairwise_d2``, in the reference's order at this shape).
    """
    mind2, labels = torch.min(pairwise_d2(x, centroids), dim=-1)
    return labels.to(torch.int32), torch.clamp_min(mind2, 0.0)
