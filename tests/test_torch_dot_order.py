"""The reference's float32 dot order at k-means distance shapes off the
port's table, against ``core.ordered.reference_dot_order``'s rule.

XLA:CPU (jax 0.9.0) adds the distance einsum ``bnd,bkd->bnk`` in one of
three orders, chosen by k and d: ``dot_nt``'s interleaved chains
(``"four"``), one multiply-add chain (``"chain"``) or the other interleave
(``"swapped"``). Each case computes the reference's jitted einsum at the
whole shape and holds the port's dot in the rule's order to it bit for
bit on the first 8,192 rows (and the other two orders apart from it),
then ``pairwise_d2`` to the reference's distances. The shapes: the ones
where the table's fallback gave the wrong order (one chain at k = 50, 56,
63, 64, 120, 128, 256, 300 and 500, the third order at k = 8 to 200 over
the RFV width and at k = 28 to 96 over the BBV width), the interleaved
ones beside them, and B = 2 to 9 lanes at k = 20 (some of them rows of
the table too). Every row of
``DOT_ORDERS``, the regression set, must come out of the rule; a sweep
of k at the port's fit widths checks the rule's boundaries.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import ordered as ORDERED
from repro_torch.core.ordered import (DOT_ORDER_NAMES, dot_in_order,
                                      reference_dot_order, sum_sq_rows)
from repro_torch.kernels.kmeans_assign.ref import dot_order, pairwise_d2

ROWS = 8192


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: beside the suite's other workers a thread pool
    per process waits on descheduled threads (``tests/lm_family_checks.py``
    says more)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

CHAIN = [(1, 50000, 50, 15), (1, 20000, 50, 15), (1, 120000, 64, 15),
         (1, 5000, 500, 38), (2, 6861, 50, 38)] + \
    [(1, 6861, k, 38) for k in (50, 56, 63, 64, 120, 128, 256, 300, 500)]
FOUR = [(1, 6861, k, 38) for k in list(range(20, 33)) + [96, 457]] + \
    [(b, 6861, 20, 38) for b in range(2, 10)] + \
    [(b, 120000, 20, 15) for b in range(2, 10)]
SWAPPED = [(1, 6861, k, 38) for k in (8, 12, 16, 33, 40, 48, 65, 80, 100,
                                      200)] + \
    [(1, 120000, k, 15) for k in (28, 30, 32, 96)] + \
    [(9, 5000, 18, 98)]          # k <= 24 at d > 90: four chains
CASES = [(s, "chain") for s in CHAIN] + [(s, "four") for s in FOUR] + \
    [(s, "swapped") for s in SWAPPED]


def _reference(x, c):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def reference(xa, ca):
        xc = jnp.einsum("bnd,bkd->bnk", xa, ca)
        x2 = jnp.sum(xa * xa, axis=2, keepdims=True)
        c2 = jnp.sum(ca * ca, axis=2)[:, None, :]
        return xc, x2 - 2.0 * xc + c2

    return tuple(np.asarray(a) for a in reference(x, c))


@pytest.mark.parametrize("shape,order", CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else v)
def test_reference_dot_order_off_the_table(shape, order):
    b, n, k, d = shape
    assert reference_dot_order(*shape) == order
    rng = np.random.default_rng(b * 7 + n + k + d)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    c = rng.standard_normal((b, k, d)).astype(np.float32)
    ref_dot, ref_d2 = _reference(x, c)
    xt = torch.from_numpy(x[:, :ROWS])
    ct = torch.from_numpy(c)
    assert dot_order(torch.from_numpy(x), ct) == order
    want = ref_dot[:, :ROWS]
    for other in DOT_ORDER_NAMES:
        got = dot_in_order(xt, ct, other).numpy()
        assert np.array_equal(got, want) == (other == order), other
    x2 = sum_sq_rows(torch.from_numpy(x))[:, :ROWS]
    got = x2[..., None] - 2.0 * dot_in_order(xt, ct, order) \
        + sum_sq_rows(ct)[:, None, :]
    assert np.array_equal(got.numpy(), ref_d2[:, :ROWS])
    if n <= ROWS:
        assert np.array_equal(pairwise_d2(xt, ct).numpy(), ref_d2)


@pytest.mark.parametrize("shape", sorted(ORDERED.DOT_ORDERS),
                         ids=lambda s: "x".join(map(str, s)))
def test_rule_reproduces_the_table(shape):
    """``DOT_ORDERS`` is the regression set: its rows were each held
    against the reference's einsum (``tests/test_torch_paper_figs.py``),
    and the rule gives every one."""
    assert reference_dot_order(*shape) == ORDERED.DOT_ORDERS[shape]


@pytest.mark.parametrize("d", [6, 7, 15, 21, 38, 94])
def test_rule_at_every_k_up_to_140(d):
    """Every k from 1 to 140 at the port's fit widths (and at d = 94,
    past the rule's d > 90 term; from k = 2 there, as k = 1 from d = 60
    is not modelled), against the reference's einsum on 16 rows and the
    first 48 centroids: this walks every boundary of the rule's first two
    64-column periods and the third's start."""
    import jax
    import jax.numpy as jnp
    ref = jax.jit(lambda xa, ca: jnp.einsum("bnd,bkd->bnk", xa, ca))
    parted = []
    for k in range(1 if d < 60 else 2, 141):
        rng = np.random.default_rng(k * 131 + d)
        x = rng.standard_normal((1, 256, d)).astype(np.float32)
        c = rng.standard_normal((1, k, d)).astype(np.float32)
        want = np.asarray(ref(x, c))[:, :16, :48]
        order = reference_dot_order(1, 256, k, d)
        got = dot_in_order(torch.from_numpy(x[:, :16]),
                           torch.from_numpy(c[:, :48]), order).numpy()
        if not np.array_equal(got, want):
            parted.append((k, order))
    assert parted == []


def test_unknown_order_raises():
    x = torch.zeros((1, 2, 5))
    with pytest.raises(ValueError, match="unknown dot order"):
        dot_in_order(x, x, "eight")


def _miss(shape, rows: int, cols: int) -> bool:
    """Whether the rule's order parts from the reference's einsum at
    ``shape`` (B, n, k, d), compared on ``rows`` rows and the first
    ``cols`` centroids (the order is one for the whole output)."""
    import jax
    import jax.numpy as jnp
    b, n, k, d = shape
    rng = np.random.default_rng(b * 7 + n + k + d)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    c = rng.standard_normal((b, k, d)).astype(np.float32)
    want = np.asarray(jax.jit(lambda xa, ca: jnp.einsum(
        "bnd,bkd->bnk", xa, ca))(x, c))[:, :rows, :cols]
    got = dot_in_order(torch.from_numpy(x[:, :rows]),
                       torch.from_numpy(c[:, :cols]),
                       reference_dot_order(b, n, k, d)).numpy()
    return not np.array_equal(got, want)


def _grid_misses(d: int) -> list:
    ks = range(1, 1025) if d <= 40 else range(2, 201)
    return [(1, 256, k, d) for k in ks if _miss((1, 256, k, d), 16, 48)]


def random_shapes(seed: int, count: int) -> list:
    """``count`` shapes: B 1-10, n 17-20,000 (cut so that the output stays
    under 2e8 bytes), k 2-4,100, d 4-128."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        b = int(rng.integers(1, 11))
        n = int(rng.choice([17, 64, 300, 915, 5000, 20000]))
        d = int(rng.integers(4, 129))
        k = int(rng.integers(2, 4101))
        out.append((b, min(n, max(17, int(2e8 / (b * k * 4)))), k, d))
    return out


def survey(seeds=(1, 2), count: int = 1000, processes: int = 6) -> dict:
    """The rule against the reference's einsum: at every k = 1-1024 for
    each d = 4-40 and every k = 2-200 for each d = 41-128 (B = 1, n = 256;
    16 rows, the first 48 centroids), and at ``count`` random shapes
    (``random_shapes``) for each seed (8 rows, 32 centroids). Returns the
    shapes checked and the misses, as (B, n, k, d). About ten minutes in
    six processes: ``python tests/test_torch_dot_order.py``."""
    import multiprocessing as mp
    with mp.get_context("spawn").Pool(processes) as pool:
        grid = pool.map(_grid_misses, range(4, 129))
        shapes = [s for seed in seeds for s in random_shapes(seed, count)]
        parted = pool.starmap(_miss, [(s, 8, 32) for s in shapes])
    return {"grid_shapes": 37 * 1024 + 88 * 199,
            "grid_misses": [s for g in grid for s in g],
            "random_shapes": len(shapes),
            "random_misses": [s for s, m in zip(shapes, parted) if m]}


def k1_survey() -> dict:
    """Where the rule's one chain at k = 1 parts from the reference (not
    modelled: one centroid gives every point label 0): the widths d =
    4-128 at which it parts over one lane and over two."""
    return {b: [d for d in range(4, 129) if _miss((b, 256, 1, d), 16, 1)]
            for b in (1, 2)}


if __name__ == "__main__":
    print(survey())
    print(k1_survey())
