"""Random projection for BBV dimensionality reduction (SimPoint step 2).

Counterpart of ``repro.core.clustering.random_projection``: a dense
Gaussian (Johnson-Lindenstrauss) matrix scaled by 1/sqrt(d_out), drawn
from ``repro_torch.prng`` so that a key gives the reference's matrix.
"""

from __future__ import annotations

import math

import torch

from ... import prng
from ..ordered import dot_nt, tree_sum

__all__ = ["projection_matrix", "random_project"]


def projection_matrix(key: torch.Tensor, d_in: int, d_out: int
                      ) -> torch.Tensor:
    """(d_in, d_out) float32 N(0, 1) / sqrt(d_out).

    Computed as the reference's compiled projection computes it: the
    normal draw's two constant factors fold into one,
    erf_inv(u) * (sqrt(2) / sqrt(d_out)), each rounded to float32.
    """
    f32 = torch.float32
    scale = torch.tensor(math.sqrt(2), dtype=f32) \
        / torch.tensor(math.sqrt(d_out), dtype=f32)
    return prng.erf_inv(prng.normal_uniforms(key, (d_in, d_out))) \
        * scale.to(key.device)


def random_project(features: torch.Tensor, d_out: int, *,
                   key: torch.Tensor, normalize_rows: bool = True
                   ) -> torch.Tensor:
    """Project ``(..., n, d_in)`` rows to ``(..., n, d_out)`` float32.

    ``normalize_rows`` first L1-normalizes each row (BBVs are frequency
    distributions, so region length must not dominate distances). The
    product accumulates in float32 in the reference's order
    (``core.ordered.dot_nt``), never in TF32.
    """
    x = features.float()
    if x.dim() < 2:
        raise ValueError(f"expected (..., n, d) rows, got {tuple(x.shape)}")
    if normalize_rows:
        norm = torch.clamp_min(tree_sum(x.abs()), 1e-12)
        x = x / norm[..., None]
    proj = projection_matrix(key.to(x.device), x.shape[-1], d_out)
    return dot_nt(x, proj.T)
