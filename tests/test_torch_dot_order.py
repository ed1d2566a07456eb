"""The reference's float32 dot order at k-means distance shapes off the
port's table, against ``core.ordered.reference_dot_order``'s rule.

XLA:CPU (jax 0.9.0) adds the distance einsum ``bnd,bkd->bnk`` in one of
three orders where k >= 2, chosen by k and d: ``dot_nt``'s interleaved
chains (``"four"``), one multiply-add chain restarted every 512 columns
(``"chain"``) or the other interleave (``"swapped"``); with one centroid,
in an eight-lane vector loop (``"vector"`` over one lane, ``"gemv"`` over
several). Each case computes the reference's jitted einsum at the
whole shape and holds the port's dot in the rule's order to it bit for
bit on the first 8,192 rows (and the other two orders apart from it),
then ``pairwise_d2`` to the reference's distances. The shapes: the ones
where the table's fallback gave the wrong order (one chain at k = 50, 56,
63, 64, 120, 128, 256, 300 and 500, the third order at k = 8 to 200 over
the RFV width and at k = 28 to 96 over the BBV width), the interleaved
ones beside them, and B = 2 to 9 lanes at k = 20 (some of them rows of
the table too). Every row of
``DOT_ORDERS``, the regression set, must come out of the rule; a sweep
of k at the port's fit widths checks the rule's boundaries; a grid of
widths to d = 1000 by eleven k over one lane, and at k = 1 over two
(``test_rule_on_the_wide_grid``), and k = 1 on each side of the vector
loops' boundaries to d = 128 (``test_one_centroid_at_every_width``),
hold the rule, the norms and the distances bit for bit. ``python tests/test_torch_dot_order.py`` runs the
whole survey (``survey``, ``k1_survey``, ``norm_survey``).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import ordered as ORDERED
from repro_torch.core.ordered import (DOT_ORDER_NAMES, dot_in_order,
                                      reference_dot_order, sum_sq_rows)
from repro_torch.kernels.kmeans_assign.ref import (
    dot_order, kmeans_assign_ref, pairwise_d2)

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
    for other in DOT_ORDER_NAMES[:3]:      # the orders of k >= 2
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
    past the rule's d > 90 term and the one-centroid vector loop's start),
    against the reference's einsum on 16 rows and the first 48 centroids:
    this walks every boundary of the rule's first two 64-column periods and
    the third's start."""
    import jax
    import jax.numpy as jnp
    ref = jax.jit(lambda xa, ca: jnp.einsum("bnd,bkd->bnk", xa, ca))
    parted = []
    for k in range(1, 141):
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


def _reference_parts(x, c):
    """The reference's einsum, both squared norms and the distances, from
    one jitted distance program."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def reference(xa, ca):
        xc = jnp.einsum("bnd,bkd->bnk", xa, ca)
        x2 = jnp.sum(xa * xa, axis=2, keepdims=True)
        c2 = jnp.sum(ca * ca, axis=2)[:, None, :]
        return xc, x2[..., 0], c2[:, 0], x2 - 2.0 * xc + c2

    return tuple(np.asarray(a) for a in reference(x, c))


def _hold_shape(b: int, n: int, k: int, d: int, cols: int = 8) -> None:
    """The rule's dot, the norms and the distances against the reference's
    distance program at (b, n, k, d), bit for bit, on every row and the
    first ``cols`` centroids (all of them at k = 1, where a row's place
    decides ``"gemv"``'s order)."""
    rng = np.random.default_rng(b * 7 + n + k * 31 + d)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    c = rng.standard_normal((b, k, d)).astype(np.float32)
    ref_dot, ref_x2, ref_c2, ref_d2 = _reference_parts(x, c)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    order = reference_dot_order(b, n, k, d)
    dot = dot_in_order(xt, ct[:, :cols], order)
    assert np.array_equal(dot.numpy(), ref_dot[..., :cols]), order
    assert np.array_equal(sum_sq_rows(xt).numpy(), ref_x2)
    assert np.array_equal(sum_sq_rows(ct).numpy(), ref_c2)
    got = sum_sq_rows(xt)[..., None] - 2.0 * dot \
        + sum_sq_rows(ct)[:, None, :cols]
    assert np.array_equal(got.numpy(), ref_d2[..., :cols])
    if k <= cols:
        assert np.array_equal(pairwise_d2(xt, ct).numpy(), ref_d2)


WIDE_D = (60, 64, 100, 129, 130, 131, 132, 192, 255, 256, 257, 384, 512,
          1000)
WIDE_K = (1, 2, 20, 28, 40, 50, 64, 65, 100, 128, 500)
# every (d, k) over one lane; over two lanes k = 1 only, the one k at which
# the lane count picks the dot's order (``"vector"`` or ``"gemv"``; from
# k = 2 it depends on k and d alone, and at these widths the norms' on
# neither: ``survey`` and ``norm_survey`` hold both lane counts everywhere)
WIDE_GRID = [(d, k, 1) for d in WIDE_D for k in WIDE_K] \
    + [(d, 1, 2) for d in WIDE_D]


@pytest.mark.parametrize("d,k,b", WIDE_GRID)
def test_rule_on_the_wide_grid(d, k, b):
    """Above the port's fit widths, up to d = 1000 (the one chain's
    512-column blocks, the one-centroid vector loop unrolled and not):
    the rule's dot, both norms and the distances bit for bit against the
    reference's distance program, over 37 points (four whole tiles of 8
    and 5 rows after them)."""
    _hold_shape(b, 37, k, d)


# k = 1 widths on each side of the vector loops' boundaries: the one-lane
# loop from d = 60, in two parts below d = 64 and four from it, its
# epilogue's width by the columns left (d mod 16, then d mod 32); the
# several-lane loop from d = 8, its tail by d mod 8 (``k1_survey`` holds
# every d to 1024)
ONE_CENTROID_D = {1: (60, 61, 62, 63, 64, 65, 66, 68, 72, 76, 81, 82, 83,
                      90, 95, 96, 97, 100, 116, 127, 128),
                  2: (8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
                      22, 31, 32, 33, 40, 59, 60, 64, 100, 127, 128)}


@pytest.mark.parametrize("b", (1, 2))
def test_one_centroid_at_every_width(b):
    """k = 1 at the widths where ``k1_survey`` named the reference's
    vector orders before they were modelled (from d = 60 over one lane,
    from d = 8 over two, to 128), on each side of the loops' boundaries
    (``ONE_CENTROID_D``; the survey takes every width): the rule's dot
    bit for bit against the reference's einsum on all 37 points (the
    norms and distances at k = 1 are held on the wide grid)."""
    assert [d for d in ONE_CENTROID_D[b]
            if _miss((b, 37, 1, d), None, 1)] == []


def test_one_centroid_norms_vectorize_over_lanes():
    """One centroid a lane: the centroids' squared norms at d = 5 to 8 take
    their vector body's order by lane (two lanes at d = 5: four rounded
    products, then the fifth by a multiply-add)."""
    for b in (2, 3, 4, 8, 9, 16, 17, 40):
        for d in (5, 6, 7, 8):
            _hold_shape(b, 9, 1, d)


def test_one_point_one_centroid_over_lanes_is_unmodelled():
    """The one class the rule leaves unmodelled (ROADMAP C.5): one point
    and one centroid a lane over two lanes or more. The reference takes
    an order there that none of ``DOT_ORDER_NAMES`` gives (at d = 8 over
    two lanes); the rule returns one chain, and every label is 0 on
    either side."""
    import jax
    import jax.numpy as jnp
    assert reference_dot_order(2, 1, 1, 8) == "chain"
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 1, 8)).astype(np.float32)
    c = rng.standard_normal((2, 1, 8)).astype(np.float32)
    want = np.asarray(jax.jit(lambda xa, ca: jnp.einsum(
        "bnd,bkd->bnk", xa, ca))(x, c))
    for order in DOT_ORDER_NAMES:
        got = dot_in_order(torch.from_numpy(x), torch.from_numpy(c), order)
        assert not np.array_equal(got.numpy(), want), order
    assert torch.equal(kmeans_assign_ref(torch.from_numpy(x),
                                         torch.from_numpy(c))[0],
                       torch.zeros((2, 1), dtype=torch.int32))


# shapes at which the reference's bits are compared across thread settings
THREAD_SHAPES = ((1, 256, 50, 1000), (1, 256, 20, 1024), (1, 256, 50, 512),
                 (1, 256, 64, 256), (10, 12000, 20, 256), (1, 120000, 64, 64),
                 (1, 256, 1, 300), (2, 256, 1, 300), (1, 4096, 500, 1024),
                 (1, 20000, 128, 2000), (3, 256, 1, 1000))

_DIGESTS = """
import hashlib, numpy as np, jax, jax.numpy as jnp
def digests(shapes):
    f = jax.jit(lambda xa, ca: jnp.einsum("bnd,bkd->bnk", xa, ca))
    out = []
    for b, n, k, d in shapes:
        rng = np.random.default_rng(b * 7 + n + k + d)
        x = rng.standard_normal((b, n, d)).astype(np.float32)
        c = rng.standard_normal((b, k, d)).astype(np.float32)
        out.append(hashlib.sha256(np.asarray(f(x, c)).tobytes()).hexdigest())
    return out
"""

_EIGEN_OFF = "--xla_cpu_multi_thread_eigen=false"


def thread_digests(shapes=THREAD_SHAPES, settings=None) -> dict:
    """The reference's einsum bits (digests) at ``shapes`` under each
    thread setting, one process each: the default, one core (``taskset -c
    0``, where the tool exists), two cores, XLA's Eigen pool off
    (``--xla_cpu_multi_thread_eigen=false``), and one core with the pool
    off; ``settings`` picks some of them by name."""
    import os
    import shutil
    import subprocess
    import sys
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    off = {**env, "XLA_FLAGS": _EIGEN_OFF}
    runs = {"default": ([], env), "eigen_single_thread": ([], off)}
    if shutil.which("taskset"):
        runs["one_core"] = (["taskset", "-c", "0"], env)
        runs["two_cores"] = (["taskset", "-c", "0,1"], env)
        runs["one_core_eigen_single_thread"] = (["taskset", "-c", "0"], off)
    script = _DIGESTS + "import sys\nprint(*digests(eval(sys.argv[1])))\n"
    return {name: subprocess.run(
        [*pre, sys.executable, "-c", script, repr(list(shapes))],
        env=e, capture_output=True, text=True, check=True).stdout.split()
        for name, (pre, e) in runs.items()
        if settings is None or name in settings}


def test_reference_bits_do_not_depend_on_threads():
    """The rule needs no thread setting: the reference's einsum gives this
    process's bits (all cores, the pool on) with one core (where
    ``taskset`` exists) and Eigen's pool off, in one process, at one
    shape each of the one chain past its first 512-column block and of
    the several-lane matrix-vector loop (every setting at eleven shapes:
    ``thread_digests()``)."""
    import shutil
    shapes = ((1, 256, 50, 1000), (2, 256, 1, 300))
    scope = {}
    exec(_DIGESTS, scope)
    here = scope["digests"](shapes)
    setting = "one_core_eigen_single_thread" if shutil.which("taskset") \
        else "eigen_single_thread"
    there = thread_digests(shapes, (setting,))[setting]
    assert len(here) == len(shapes) and there == here, (here, there)


def _miss(shape, rows, cols: int) -> bool:
    """Whether the rule's order parts from the reference's einsum at
    ``shape`` (B, n, k, d), compared on ``rows`` rows (all where None) and
    the first ``cols`` centroids (the order is one for the whole output,
    but for ``"gemv"``'s by row place)."""
    import jax
    import jax.numpy as jnp
    b, n, k, d = shape
    rng = np.random.default_rng(b * 7 + n + k + d)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    c = rng.standard_normal((b, k, d)).astype(np.float32)
    rows = n if rows is None else rows
    want = np.asarray(jax.jit(lambda xa, ca: jnp.einsum(
        "bnd,bkd->bnk", xa, ca))(x, c))[:, :rows, :cols]
    got = dot_in_order(torch.from_numpy(x[:, :rows]),
                       torch.from_numpy(c[:, :cols]),
                       reference_dot_order(b, n, k, d)).numpy()
    return not np.array_equal(got, want)


# the grid's widths above the fits' (d = 41 to 512 at every k from 2 to
# 200), and three past the one chain's first 512-column block
_WIDE_GRID = tuple(range(41, 513)) + (640, 1000, 1024)


def _grid_misses(d: int) -> list:
    ks = range(1, 1025) if d <= 40 else range(2, 201)
    torch.set_num_threads(1)
    return [(1, 256, k, d) for k in ks if _miss((1, 256, k, d), 16, 48)]


def random_shapes(seed: int, count: int, d_max: int = 128) -> list:
    """``count`` shapes: B 1-10, n 17-20,000 (cut so that the output stays
    under 2e8 bytes), k 2-4,100, d 4-``d_max``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        b = int(rng.integers(1, 11))
        n = int(rng.choice([17, 64, 300, 915, 5000, 20000]))
        d = int(rng.integers(4, d_max + 1))
        k = int(rng.integers(2, 4101))
        out.append((b, min(n, max(17, int(2e8 / (b * k * 4)))), k, d))
    return out


def _random_miss(shape) -> bool:
    torch.set_num_threads(1)
    return _miss(shape, 8, 32)


def survey(seeds=(1, 2), count: int = 1000, processes: int = 6) -> dict:
    """The rule against the reference's einsum: at every k = 1-1024 for
    each d = 4-40 and every k = 2-200 for each d = 41-512 and d = 640, 1000,
    1024 (B = 1, n = 256; 16 rows, the first 48 centroids), at ``count``
    random shapes (``random_shapes``) for each seed (8 rows, 32
    centroids), and at ``count`` more up to d = 1024 (seed 3). Returns the
    shapes checked and the misses, as (B, n, k, d). About an hour in six
    processes: ``python tests/test_torch_dot_order.py``."""
    import multiprocessing as mp
    widths = tuple(range(4, 41)) + _WIDE_GRID
    with mp.get_context("spawn").Pool(processes) as pool:
        grid = pool.map(_grid_misses, widths)
        shapes = [s for seed in seeds for s in random_shapes(seed, count)]
        shapes += random_shapes(3, count, d_max=1024)
        parted = pool.map(_random_miss, shapes)
    return {"grid_shapes": 37 * 1024 + (len(widths) - 37) * 199,
            "grid_misses": [s for g in grid for s in g],
            "random_shapes": len(shapes),
            "random_misses": [s for s, m in zip(shapes, parted) if m]}


def _k1_misses(b: int) -> list:
    torch.set_num_threads(1)
    return [d for d in range(4, 1025) if _miss((b, 61, 1, d), None, 1)]


def k1_survey(processes: int = 3) -> dict:
    """Where the rule parts from the reference with one centroid: the
    widths d = 4-1024 at which it parts over one, two and three lanes (61
    points: seven whole tiles of 8 and 5 rows after them)."""
    import multiprocessing as mp
    with mp.get_context("spawn").Pool(processes) as pool:
        return dict(zip((1, 2, 3), pool.map(_k1_misses, (1, 2, 3))))


def _norm_misses(d: int) -> list:
    """Row counts m (and lanes b) at which ``sum_sq_rows`` parts from the
    reference's ``sum(x * x)`` in its distance program, at width d."""
    torch.set_num_threads(1)
    out = []
    for b, m in ((1, 1), (1, 2), (1, 3), (1, 37), (1, 256), (2, 1), (3, 1),
                 (2, 2), (2, 61), (5, 1)):
        rng = np.random.default_rng(m * 1000 + d + b)
        x = rng.standard_normal((b, m, d)).astype(np.float32)
        c = rng.standard_normal((b, 2, d)).astype(np.float32)
        ref_x2 = _reference_parts(x, c)[1]
        if not np.array_equal(sum_sq_rows(torch.from_numpy(x)).numpy(),
                              ref_x2):
            out.append((b, m, d))
    return out


def norm_survey(processes: int = 6) -> list:
    """The squared norms' order (``sum_sq_rows``) against the reference's
    at every d from 4 to 1100 and at 2048, 2049 and 5000, over one to five
    lanes and 1 to 256 rows: the misses as (B, m, d)."""
    import multiprocessing as mp
    widths = tuple(range(4, 1101)) + (2048, 2049, 5000)
    with mp.get_context("spawn").Pool(processes) as pool:
        return [s for g in pool.map(_norm_misses, widths) for s in g]


if __name__ == "__main__":
    print(survey())
    print(k1_survey())
    print(norm_survey())
    runs = thread_digests()
    print({name: d == next(iter(runs.values())) for name, d in runs.items()})
