"""Float32 arithmetic in a fixed, documented order.

The port is held bitwise against a reference whose float32 programs were
compiled by XLA for the CPU. Three of XLA's choices decide the low bits
of the results the port must reproduce exactly (k-means++ seeding draws
from cumulative sums, so one flipped bit can pick a different seed):

* a multiply feeding an add in one fused loop is contracted to a fused
  multiply-add (``fma32``);
* a sum over more than 32 elements is a tree: windows of 32 (padded
  symmetrically with zeros), each summed in order, then the window sums
  the same way until at most 32 remain (``tree_sum``);
* a cumulative sum is blocked by 16: in-order scans of 16-element
  blocks, plus the scan of the block totals, recursively
  (``blocked_cumsum``);
* a matrix product keeps interleaved multiply-add accumulators
  (``dot_nt``): at a depth that is 0 or 3 mod 4, four (depth index mod
  4), summed as (a0 + a1) + (a2 + a3), a tail of three added as the sum
  of its plain products; at a depth that is 1 or 2 mod 4, two (depth
  index mod 2), summed as a0 + a1, an odd last term added as a plain
  product; a depth below 4 is one multiply-add chain;
* but the k-means distance einsum ``(B, n, d) x (B, k, d)`` takes one of
  three orders, by k and d alone (``reference_dot_order``, the rule
  below): ``dot_nt``'s interleaved chains (``"four"``), ONE multiply-add
  chain over d in order (``dot_chain``, ``"chain"``), or the other
  interleave (``dot_swapped``, ``"swapped"``: four chains where d is 1 or
  2 mod 4, two where it is 0 or 3 mod 4). ``DOT_ORDERS`` is the
  regression set the rule must reproduce: the order at every shape where
  a fit of the port ran when the orders were first tabulated
  (``tests/test_torch_paper_figs.py`` holds each row against the
  reference's einsum, ``tests/test_torch_dot_order.py`` the rule at
  shapes off the table); ``dot_in_order`` computes any of the three;
* the distance's squared norms ``sum(x * x)`` over d = 5 to 8 are
  vectorized over rows: the leading ``norm_vector_rows(m, d)`` rows of an
  ``(..., m, d)`` stack add their rounded products in order, the rest are
  one multiply-add chain as ``sum_sq`` computes them (``sum_sq_rows``).
  The rule is the same for the points' and the centroids' norms, and
  holds at every shape the port's tests check against the reference.

numpy, which the reference's engine uses for its host statistics, sums
over an axis that is not the innermost one slice by slice, in order
(``seq_sum``).

The helpers compute in float32 on any device (``seq_sum`` in its input's
dtype); ``fma32`` rounds once from float64, which is exact for the
product of two float32 values.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["fma32", "tree_sum", "sum_sq", "sum_sq_rows", "norm_vector_rows",
           "blocked_cumsum", "dot_nt", "dot_chain", "dot_swapped",
           "dot_in_order", "reference_dot_order", "DOT_ORDERS",
           "DOT_ORDER_NAMES", "seq_sum"]

_WINDOW = 32
_SCAN_BLOCK = 16


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (a fused multiply-add)."""
    return (a.double() * b.double() + c.double()).float()


def _in_order(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right, in float32."""
    acc = torch.zeros(v.shape[:-1], dtype=torch.float32, device=v.device)
    for j in range(v.shape[-1]):
        acc = acc + v[..., j]
    return acc


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Float32 sum over the last axis in XLA-CPU's window-tree order."""
    v = v.float()
    n = v.shape[-1]
    while n > _WINDOW:
        m = -(-n // _WINDOW)
        pad = m * _WINDOW - n
        v = F.pad(v, (pad // 2, pad - pad // 2))
        v = _in_order(v.reshape(*v.shape[:-1], m, _WINDOW))
        n = m
    return _in_order(v)


def sum_sq(t: torch.Tensor) -> torch.Tensor:
    """``sum(t * t)`` over the last axis as the reference's fused loop
    computes it: multiply-adds in order up to 32 terms, else a window
    tree of plain products."""
    t = t.float()
    if t.shape[-1] > _WINDOW:
        return tree_sum(t * t)
    t = t.double()
    acc = torch.zeros(t.shape[:-1], dtype=torch.float32, device=t.device)
    for j in range(t.shape[-1]):
        acc = fma32(t[..., j], t[..., j], acc)
    return acc


# from this many rows on, the reference's vector body over the rows of a
# norm takes whole groups of 8 (below it, whole groups of 4), per d
_NORM_GROUP8_FROM = {5: 32, 6: 32, 7: 88, 8: 80}


def norm_vector_rows(m: int, d: int) -> int:
    """How many leading rows of an ``(..., m, d)`` stack the reference's
    float32 ``sum(x * x, -1)`` adds as rounded products in order (its
    vector body); the rows after them are one multiply-add chain. Only
    d = 5 to 8 is vectorized over rows; below 16 rows only m = 2, 4 and 8
    are. Not modelled: two rows at d = 5, which the reference sums in a
    third order (no fit of the port has that shape; 0 is returned)."""
    m, d = int(m), int(d)
    if d not in _NORM_GROUP8_FROM:
        return 0
    if m < 16:
        if m == 2:
            return 0 if d == 5 else 2
        return m if m in (4, 8) else 0
    return m - m % (8 if m >= _NORM_GROUP8_FROM[d] else 4)


def sum_sq_rows(t: torch.Tensor) -> torch.Tensor:
    """``sum(t * t)`` over the last axis of an ``(..., m, d)`` stack, each
    row in the reference's order at its place (``norm_vector_rows``): the
    squared norms of the k-means distance. ``sum_sq`` elsewhere (the
    seeding's ``(x - c)^2`` is one chain at every row)."""
    t = t.float()
    out = sum_sq(t)
    p = norm_vector_rows(t.shape[-2], t.shape[-1])
    if p:
        head = t[..., :p, :]
        out[..., :p] = _in_order(head * head)
    return out


def blocked_cumsum(v: torch.Tensor) -> torch.Tensor:
    """Float32 inclusive cumulative sum over the last axis, blocked by 16."""
    v = v.float()
    n = v.shape[-1]
    if n <= _SCAN_BLOCK:
        return torch.cumsum(v, dim=-1) if n < 2 else _scan_in_order(v)
    m = -(-n // _SCAN_BLOCK)
    blocks = F.pad(v, (0, m * _SCAN_BLOCK - n)).reshape(
        *v.shape[:-1], m, _SCAN_BLOCK)
    inner = _scan_in_order(blocks)
    carry = blocked_cumsum(inner[..., -1])
    out = torch.cat([inner[..., :1, :],
                     inner[..., 1:, :] + carry[..., :-1, None]], dim=-2)
    return out.reshape(*v.shape[:-1], m * _SCAN_BLOCK)[..., :n]


def _scan_in_order(v: torch.Tensor) -> torch.Tensor:
    """In-order float32 scan over the last axis (one add per step)."""
    cols = [v[..., 0]]
    for j in range(1, v.shape[-1]):
        cols.append(cols[-1] + v[..., j])
    return torch.stack(cols, dim=-1)


def _interleaved(x: torch.Tensor, y: torch.Tensor, lanes: int
                 ) -> torch.Tensor:
    """``x (..., n, K) . y (..., m, K)`` over ``K`` in float32 with
    ``lanes`` interleaved multiply-add accumulators (depth index mod
    ``lanes``, 2 or 4) over the largest multiple of ``lanes``, summed as
    a0 + a1 or (a0 + a1) + (a2 + a3), plus the tail's plain products
    summed in order; below 4 terms, one multiply-add chain."""
    # float64 copies: each product of two float32 values is exact there
    x = x.float().double()[..., :, None, :]
    y = y.float().double()[..., None, :, :]
    k = x.shape[-1]
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    if k < 4:
        for j in range(k):
            acc = fma32(x[..., j], y[..., j], acc)
        return acc
    main = k - k % lanes
    for j in range(0, main, lanes):
        acc = fma32(x[..., j:j + lanes], y[..., j:j + lanes], acc)
    out = acc[..., 0] + acc[..., 1]
    if lanes == 4:
        out = out + (acc[..., 2] + acc[..., 3])
    if main == k:
        return out
    tail = (x[..., main] * y[..., main]).float()
    for j in range(main + 1, k):
        tail = tail + (x[..., j] * y[..., j]).float()
    return out + tail


def dot_nt(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x (..., n, K) . y (..., m, K)`` over ``K`` -> ``(..., n, m)`` in
    float32, in the reference's accumulation order (see above): four
    interleaved chains, or two where K is 1 or 2 mod 4."""
    return _interleaved(x, y, 2 if x.shape[-1] % 4 in (1, 2) else 4)


def dot_swapped(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``dot_nt``'s product with the other interleave: four chains where K
    is 1 or 2 mod 4, two where it is 0 or 3 mod 4 (one chain below 4
    terms, as ``dot_nt``). The reference's distance einsum takes it where
    ``reference_dot_order`` says ``"swapped"``."""
    return _interleaved(x, y, 4 if x.shape[-1] % 4 in (1, 2) else 2)


def dot_chain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``dot_nt``'s product as ONE multiply-add chain over ``K``, in order:
    the reference's float32 distance einsum at the shapes ``DOT_ORDERS``
    marks ``"chain"`` (gcc's k = 50 fit, Fig 12/13's k = 500 fits)."""
    x = x.float().double()[..., :, None, :]
    y = y.float().double()[..., None, :, :]
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(x.shape[-1]):
        acc = fma32(x[..., j], y[..., j], acc)
    return acc


# (B, n, k, d) of a distance einsum (B lanes of n points against k
# centroids of d features) -> the reference's accumulation order there:
# the regression set of ``reference_dot_order``, each row held against the
# reference's einsum. Rows: the build's BBV and RFV fits (ten apps, and the
# tests' app pairs; over an app mesh, one shard's lanes: B = 1 to 5),
# the figures' k = 20 / 50 / 500 fits over full populations and phase-1
# samples (and their restarts), the flow's stratifier fits (3 restarts),
# kmeans_multi_seed's and SampledEval's, and the distributed k-means'
# shards of points and its seeding subsample. Fits at d < 4 (the flow's and
# the tests' small ones) have no row: there every order is one chain.
_CHAIN = (
    (1, 964, 482, 38), (1, 967, 483, 38), (1, 1030, 500, 38),
    (1, 1041, 500, 38), (1, 1062, 500, 38), (1, 1997, 500, 38),
    (1, 3047, 500, 38), (1, 6195, 500, 38), (1, 6861, 500, 38),
    (1, 40000, 50, 15), (1, 120000, 50, 15))
_FOUR = (
    (1, 915, 457, 38), (1, 964, 20, 38), (1, 967, 20, 38), (1, 6861, 20, 38),
    (1, 10000, 20, 15), (1, 30000, 20, 15), (1, 40000, 20, 15),
    (1, 120000, 20, 15), (2, 915, 20, 6), (2, 915, 20, 21), (2, 964, 20, 6),
    (2, 964, 20, 21), (2, 964, 20, 38), (2, 967, 20, 6), (2, 967, 20, 21),
    (2, 967, 20, 38), (2, 1030, 20, 6), (2, 1030, 20, 21), (2, 1041, 20, 6),
    (2, 1041, 20, 21), (2, 1062, 20, 6), (2, 1062, 20, 21), (2, 1997, 20, 6),
    (2, 1997, 20, 21), (2, 1997, 20, 38), (2, 3001, 20, 15), (2, 3047, 20, 6),
    (2, 3047, 20, 21), (2, 6195, 20, 6), (2, 6195, 20, 21), (2, 6195, 20, 38),
    (2, 6861, 20, 6), (2, 6861, 20, 21), (2, 6861, 20, 38), (2, 8192, 20, 15),
    (2, 40000, 20, 15), (2, 60000, 20, 15), (2, 120000, 20, 15),
    (3, 900, 20, 15), (3, 900, 20, 38), (3, 915, 20, 15), (3, 915, 20, 38),
    (3, 964, 20, 15), (3, 964, 20, 38), (3, 967, 20, 15), (3, 967, 20, 38),
    (3, 1030, 20, 15), (3, 1030, 20, 38), (3, 1041, 20, 15), (3, 1041, 20, 38),
    (3, 1062, 20, 15), (3, 1062, 20, 38), (3, 1201, 20, 38), (3, 1500, 12, 7),
    (3, 1997, 20, 15), (3, 1997, 20, 38), (3, 3047, 20, 15), (3, 3047, 20, 38),
    (3, 6195, 20, 15), (3, 6195, 20, 38), (3, 6861, 20, 15), (3, 6861, 20, 38),
    (3, 120000, 20, 15), (4, 6861, 20, 38), (4, 120000, 20, 15),
    (5, 6861, 20, 38), (5, 120000, 20, 15), (10, 6861, 20, 38),
    (10, 120000, 20, 15))
DOT_ORDERS: dict[tuple[int, int, int, int], str] = {
    **{s: "four" for s in _FOUR}, **{s: "chain" for s in _CHAIN}}


DOT_ORDER_NAMES = ("four", "chain", "swapped")


def _interleave(k: int, d: int) -> int:
    """Accumulators (4, 2 or 1 for one chain) of the reference's distance
    einsum with k centroids of d >= 4 features; see
    ``reference_dot_order``."""
    if k == 1:
        return 1
    p, q = divmod(k - 1, 64)
    q //= 16
    t = d % 4
    if q == 3:
        return 1
    if q == 2:
        return 4 if (4 - t) % 4 * (4 * p + 3) < d else 1
    if q == 1:
        if k <= 24 and (t in (0, 3) or d > 90):
            return 4
        return 2 if d % 2 * (4 * p + 2) < 2 * d else 1
    if t == 0:
        return 4
    if t == 3:
        return 4 if 4 * p + 1 < 3 * d else 1
    if p < (d // 4 + 1) // 2:
        return 4
    return 2 if t == 2 or 2 * p + 1 < d else 1


def reference_dot_order(b: int, n: int, k: int, d: int) -> str:
    """The reference's accumulation order for a distance einsum of ``b``
    lanes, ``n`` points, ``k`` centroids and ``d`` features: ``"four"``
    (``dot_nt``), ``"chain"`` (``dot_chain``) or ``"swapped"``
    (``dot_swapped``).

    The rule, found by holding the three orders against XLA:CPU's float32
    einsum at jax 0.9.0 on every k from 1 to 1024 at each d from 4 to 40,
    every k from 2 to 200 at each d from 41 to 128, and 2,000 random shapes
    up to B = 10, k = 4,100 and d = 128 (``tests/test_torch_dot_order.py``'s
    ``survey``: 0 misses): B and n play no part; the
    accumulators are 4, 2 or 1 by k's 64-column period p = (k - 1) // 64
    and its 16-column quarter q = (k - 1) % 64 // 16 there, with t = d
    mod 4 and w = (4 - t) mod 4 (the depth's missing lanes to a multiple
    of 4):

    * q = 3: one chain;
    * q = 2: four while w (4 p + 3) < d, then one chain;
    * q = 1: four at k <= 24 where t is 0 or 3 or d > 90; else two
      while (d mod 2)(4 p + 2) < 2 d, then one chain;
    * q = 0: t = 0, four; t = 3, four while 4 p + 1 < 3 d, then one
      chain; t = 1 or 2, four while p < (d // 4 + 1) // 2, then two (t =
      2, or while 2 p + 1 < d), then one chain;
    * k = 1: one chain (from d = 60 over one lane, and from d = 8 over two,
      the reference takes yet another order there, not modelled: one
      centroid gives every point label 0).

    ``dot_nt`` is four accumulators where t is 0 or 3 and two where it is
    1 or 2, ``dot_swapped`` the other way round. Below d = 4 every order is
    one chain, and ``"four"`` is returned."""
    k, d = int(k), int(d)
    if d < 4:
        return "four"
    lanes = _interleave(k, d)
    if lanes == 1:
        return "chain"
    return "four" if (lanes == 2) == (d % 4 in (1, 2)) else "swapped"


def dot_in_order(x: torch.Tensor, y: torch.Tensor, order: str
                 ) -> torch.Tensor:
    """``dot_nt`` (``order="four"``), ``dot_chain`` (``"chain"``) or
    ``dot_swapped`` (``"swapped"``)."""
    if order == "chain":
        return dot_chain(x, y)
    if order == "four":
        return dot_nt(x, y)
    if order == "swapped":
        return dot_swapped(x, y)
    raise ValueError(f"unknown dot order {order!r}; one of "
                     f"{DOT_ORDER_NAMES}")


def seq_sum(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` one slice at a time, in order, in ``v``'s dtype
    (numpy's order for a reduction over an outer axis)."""
    acc = torch.zeros_like(v.select(dim, 0))
    for j in range(v.shape[dim]):
        acc = acc + v.select(dim, j)
    return acc
