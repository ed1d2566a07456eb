"""Feature standardization for RFV clustering (paper IV.B: "we did
standardize the values")."""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Standardizer"]


@dataclasses.dataclass(frozen=True)
class Standardizer:
    """Column-wise z-score transform fitted on phase-1 data (float64).

    Constant columns get scale 1 so they map to 0 instead of NaN.
    """

    mean: torch.Tensor
    scale: torch.Tensor

    @staticmethod
    def fit(features: torch.Tensor) -> "Standardizer":
        arr = features.double()
        if arr.dim() != 2:
            raise ValueError(f"expected (n, d) matrix, got {tuple(arr.shape)}")
        mean = arr.mean(dim=0)
        std = arr.std(dim=0, unbiased=False)
        scale = torch.where(std > 1e-12, std, torch.ones_like(std))
        return Standardizer(mean=mean, scale=scale)

    def transform(self, features: torch.Tensor) -> torch.Tensor:
        return (features - self.mean.to(features.dtype)) \
            / self.scale.to(features.dtype)

    @staticmethod
    def fit_transform(features: torch.Tensor
                      ) -> tuple["Standardizer", torch.Tensor]:
        st = Standardizer.fit(features)
        return st, st.transform(features)
