"""Feature standardization for RFV clustering (paper IV.B: "we did
standardize the values")."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Standardizer"]


@dataclasses.dataclass(frozen=True)
class Standardizer:
    """Column-wise z-score transform fitted on phase-1 data (float64).

    The fit is a float64 host statistic, taken in numpy's order as the
    reference takes it (the phase-1 matrix is small), so a shared input
    gives the reference's mean and scale bit for bit; they come back on
    the features' device. Constant columns get scale 1 so they map to 0
    instead of NaN.
    """

    mean: torch.Tensor
    scale: torch.Tensor

    @staticmethod
    def fit(features: torch.Tensor) -> "Standardizer":
        features = torch.as_tensor(features)
        if features.dim() != 2:
            raise ValueError(
                f"expected (n, d) matrix, got {tuple(features.shape)}")
        arr = features.detach().cpu().numpy().astype(np.float64)
        mean = arr.mean(axis=0)
        std = arr.std(axis=0)
        scale = np.where(std > 1e-12, std, 1.0)
        dev = features.device
        return Standardizer(mean=torch.as_tensor(mean, device=dev),
                            scale=torch.as_tensor(scale, device=dev))

    def transform(self, features: torch.Tensor) -> torch.Tensor:
        return (features - self.mean.to(features.dtype)) \
            / self.scale.to(features.dtype)

    @staticmethod
    def fit_transform(features: torch.Tensor
                      ) -> tuple["Standardizer", torch.Tensor]:
        st = Standardizer.fit(features)
        return st, st.transform(features)
