"""Two-phase stratified sampled evaluation for LMs.

Counterpart of ``repro.train.sampled_eval``: estimating the eval loss
over a large corpus is the LM analogue of estimating CPI over an
application's regions.

  phase 1   forward a random sample of eval batches once, recording a
            cheap per-batch feature vector;
  stratify  k-means on the standardised features — on a CUDA device the
            fit runs the ``kmeans_assign`` and ``segment_stats`` kernels;
  phase 2   day-to-day evals forward one batch per stratum (centroid
            selection); CI checks sample a few batches per stratum and
            apply the two-phase formula (eq. 6).

The sampling draws are the reference's numpy draws and the k-means seeds
its threefry draws, so with the same ``eval_batch`` both packages pick
the same batches. ``device`` is where the features are clustered (the
card when None). ``eval_batch`` runs under ``torch.no_grad()``: an eval
forward builds no autograd graph, and takes the flash route on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.clustering import Standardizer, kmeans
from ..core.sampling import (Estimate, select_centroid, srs_estimate,
                             summarize_strata, two_phase_estimate,
                             weighted_point_estimate)
from ..device import resolve_device

__all__ = ["SampledEval"]


@dataclasses.dataclass
class SampledEval:
    """``eval_batch(idx) -> (loss, feature_vector)`` over a corpus of
    ``n_batches`` batches; the class owns phase-1 sampling,
    stratification and the cheap phase-2 estimators."""

    n_batches: int
    eval_batch: Callable[[int], tuple[float, np.ndarray]]
    num_strata: int = 16
    seed: int = 0
    device: Any = None

    # phase-1 artifacts (host numpy, as in the reference)
    _idx1: Optional[np.ndarray] = None
    _losses1: Optional[np.ndarray] = None
    _labels: Optional[np.ndarray] = None
    _weights: Optional[np.ndarray] = None
    _selected: Optional[list] = None

    @torch.no_grad()
    def characterize(self, n_phase1: int) -> Estimate:
        rng = np.random.default_rng(self.seed)
        self._idx1 = rng.choice(self.n_batches,
                                size=min(n_phase1, self.n_batches),
                                replace=False)
        losses, feats = [], []
        for i in self._idx1:
            loss, f = self.eval_batch(int(i))
            losses.append(loss)
            feats.append(np.asarray(f, np.float64))
        self._losses1 = np.asarray(losses)
        dev = resolve_device(self.device, what="SampledEval")
        feats = torch.as_tensor(np.stack(feats), device=dev)
        # fitted in float64, applied in float32 (the reference's features
        # reach its transform as float32)
        z = Standardizer.fit(feats).transform(feats.float())
        km = kmeans(z, min(self.num_strata, len(self._idx1)),
                    seed=self.seed)
        self._labels = km.labels.cpu().numpy()
        counts = np.bincount(self._labels, minlength=km.centroids.shape[0])
        self._weights = counts / counts.sum()
        self._selected = [s.cpu().numpy() for s in
                          select_centroid(km.labels, z, km.centroids)]
        return srs_estimate(self._losses1)

    @torch.no_grad()
    def quick_estimate(self) -> float:
        """Day-to-day eval: one forward per stratum (centroid batches)."""
        if self._selected is None:
            raise RuntimeError("characterize() first")
        y = np.array([self.eval_batch(int(self._idx1[s[0]]))[0]
                      for s in self._selected if s.size])
        sel = [np.array([i]) for i in range(len(y))]
        w = self._weights[[h for h, s in enumerate(self._selected)
                           if s.size]]
        return weighted_point_estimate(sel, y, w / w.sum())

    @torch.no_grad()
    def ci_check(self, per_stratum: int = 4,
                 confidence: float = 0.95) -> Estimate:
        """Periodic multi-batch-per-stratum CI (paper step 4b)."""
        rng = np.random.default_rng(self.seed + 1)
        ys, labs = [], []
        for h in range(int(self._weights.shape[0])):
            pool = self._idx1[self._labels == h]
            if pool.size == 0:
                continue
            take = rng.choice(pool, size=min(per_stratum, pool.size),
                              replace=False)
            for i in take:
                ys.append(self.eval_batch(int(i))[0])
                labs.append(h)
        summaries = summarize_strata(np.asarray(ys), np.asarray(labs),
                                     weights=self._weights,
                                     num_strata=self._weights.shape[0])
        return two_phase_estimate(summaries, phase1_n=self._idx1.size,
                                  confidence=confidence)
