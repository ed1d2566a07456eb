"""Per-stratum summaries (the ported subset of
``repro.core.sampling.stratified``): ``summarize_strata`` builds the
``StratumSummary`` list the two-phase estimator takes, from the float64
host tables (``tables.stratum_tables``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import tables as _tables
from .types import StratumSummary, as_float_array

__all__ = ["StratumSummary", "summarize_strata"]


def summarize_strata(y, strata, *,
                     weights: Optional[Sequence[float]] = None,
                     num_strata: Optional[int] = None
                     ) -> list[StratumSummary]:
    """Per-stratum summaries from sampled values and stratum labels.

    ``weights`` are population weights W_h (summing to about 1); when
    omitted, the sample proportions. L comes from ``num_strata``, else
    ``len(weights)``, else the observed labels. Strata with no sampled
    unit get n = 0 (mean and variance NaN); a single unit gives a NaN
    variance.
    """
    yv = torch.from_numpy(as_float_array(y))
    sv = torch.as_tensor(strata).reshape(-1)
    if yv.shape[0] != sv.shape[0]:
        raise ValueError("y and strata must align")
    t = _tables.stratum_tables(yv, sv, weights=weights,
                               num_strata=num_strata)
    means, variances = t.means, t.variances
    out = []
    for h in range(t.num_strata):
        n_h = int(t.counts[h])
        out.append(StratumSummary(
            weight=float(t.weights[h]), n=n_h,
            mean=float(means[h]) if n_h > 0 else float("nan"),
            var=float(variances[h]) if n_h > 1 else float("nan")))
    return out
