"""Dalenius-Gurney optimal stratification on a scalar variable (Appendix A.E).

Orders units by the auxiliary variable x (here: baseline CPI) and picks
stratum boundaries so that W_h * s_h is approximately equal across strata
(paper eq. 7). Implemented exactly as the paper describes: start from
equidistant (equal-count) boundaries, iteratively refine.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "dalenius_gurney_strata",
    "stratum_products",
]



def dalenius_gurney_strata(
    x,
    num_strata: int,
    *,
    max_iters: int = 200,
    tol: float = 1e-3,
) -> np.ndarray:
    """Assign each unit a stratum label in [0, num_strata) by x-value.

    Returns integer labels aligned with ``x``. Boundaries are refined until
    the W_h*s_h products are within ``tol`` (relative spread) of equal, or
    ``max_iters`` is reached. Degenerate strata (constant x) are tolerated:
    their W_h*s_h is 0 and the algorithm shifts boundaries away from them.
    """
    xv = np.asarray(x, dtype=np.float64).reshape(-1)
    n = xv.shape[0]
    L = int(num_strata)
    if L < 1:
        raise ValueError("num_strata must be >= 1")
    if L == 1:
        return np.zeros(n, dtype=np.int32)
    if n < L:
        raise ValueError(f"cannot form {L} strata from {n} units")

    order = np.argsort(xv, kind="stable")
    sorted_x = xv[order]

    # Boundaries as cut positions in the sorted array: L-1 interior cuts.
    cuts = np.linspace(0, n, L + 1).round().astype(int)
    cuts[0], cuts[-1] = 0, n

    # products(c) is called after every boundary move; per-(lo, hi)
    # memoization makes each move cost two fresh segment stds instead of
    # L, which is the difference between O(L * iters) and O(n * L *
    # iters) std work on census-scale inputs (the fig5 bench hot spot)
    seg_cache: dict[tuple[int, int], float] = {}

    def product(lo: int, hi: int) -> float:
        key = (lo, hi)
        if key not in seg_cache:
            seg = sorted_x[lo:hi]
            w = seg.size / n
            s = seg.std(ddof=1) if seg.size > 1 else 0.0
            seg_cache[key] = w * s
        return seg_cache[key]

    def products(c: np.ndarray) -> np.ndarray:
        out = np.empty(L)
        for h in range(L):
            out[h] = product(c[h], c[h + 1])
        return out

    for _ in range(max_iters):
        p = products(cuts)
        target = p.mean()
        if target > 0 and (p.max() - p.min()) / target < tol:
            break
        moved = False
        # Move each interior boundary one step toward balancing its two
        # neighbouring strata (greedy coordinate descent; robust and simple).
        for b in range(1, L):
            left, right = p[b - 1], p[b]
            if left > right and cuts[b] - cuts[b - 1] > 1:
                step = max(1, (cuts[b] - cuts[b - 1]) // 16)
                cuts[b] -= step
                moved = True
            elif right > left and cuts[b + 1] - cuts[b] > 1:
                step = max(1, (cuts[b + 1] - cuts[b]) // 16)
                cuts[b] += step
                moved = True
            if moved:
                p = products(cuts)
        if not moved:
            break

    labels_sorted = np.empty(n, dtype=np.int32)
    for h in range(L):
        labels_sorted[cuts[h]:cuts[h + 1]] = h
    labels = np.empty(n, dtype=np.int32)
    labels[order] = labels_sorted
    return labels


def stratum_products(x, labels, num_strata: int) -> np.ndarray:
    """Diagnostic: the W_h * s_h products eq. (7) tries to equalize."""
    xv = np.asarray(x, dtype=np.float64).reshape(-1)
    lv = np.asarray(labels)
    n = xv.shape[0]
    out = np.zeros(num_strata)
    for h in range(num_strata):
        seg = xv[lv == h]
        if seg.size > 1:
            out[h] = (seg.size / n) * seg.std(ddof=1)
    return out
