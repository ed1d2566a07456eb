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
* but the k-means distance einsum ``(B, n, d) x (B, k, d)`` does not
  always take the interleaved order: at some shapes XLA emits it as ONE
  multiply-add chain over d, in order (``dot_chain``), and which one it
  takes moves with n, k and B, not by a threshold (k = 20 and 40 four chains, 25-32
  neither, 49-64 one chain, 100 four, 128 one ...). ``DOT_ORDERS``
  tabulates the order at every shape where a fit of the port runs,
  derived from the reference's own einsum on the CPU
  (``tests/test_torch_paper_figs.py`` holds each row);
  ``reference_dot_order`` reads it, and ``dot_in_order`` computes either;
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
           "blocked_cumsum", "dot_nt",
           "dot_chain", "dot_in_order", "reference_dot_order", "DOT_ORDERS",
           "seq_sum"]

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


def dot_nt(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x (..., n, K) . y (..., m, K)`` over ``K`` -> ``(..., n, m)`` in
    float32, in the reference's accumulation order (see above)."""
    # float64 copies: each product of two float32 values is exact there
    x = x.float().double()[..., :, None, :]
    y = y.float().double()[..., None, :, :]
    k = x.shape[-1]
    if k < 4:
        acc = torch.zeros((), dtype=torch.float32, device=x.device)
        for j in range(k):
            acc = fma32(x[..., j], y[..., j], acc)
        return acc
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    if k % 4 in (1, 2):
        main = k - k % 2
        for j in range(0, main, 2):
            acc = fma32(x[..., j:j + 2], y[..., j:j + 2], acc)
        out = acc[..., 0] + acc[..., 1]
        if main == k:
            return out
        return out + (x[..., main] * y[..., main]).float()
    main = k - k % 4
    for j in range(0, main, 4):
        acc = fma32(x[..., j:j + 4], y[..., j:j + 4], acc)
    out = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])
    if main == k:
        return out
    tail = (x[..., main] * y[..., main]).float()
    for j in range(main + 1, k):
        tail = tail + (x[..., j] * y[..., j]).float()
    return out + tail


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
# centroids of d features) -> the reference's accumulation order there.
# Rows: the build's BBV and RFV fits (ten apps, and the tests' app pairs;
# over an app mesh, one shard's lanes: B = 1 to 5),
# the figures' k = 20 / 50 / 500 fits over full populations and phase-1
# samples (and their restarts), the flow's stratifier fits (3 restarts),
# kmeans_multi_seed's and SampledEval's, and the distributed k-means'
# shards of points and its seeding subsample. Fits at d < 4 (the flow's and
# the tests' small ones) have no row: there both orders are one chain.
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


def reference_dot_order(b: int, n: int, k: int, d: int) -> str:
    """The reference's accumulation order for a distance einsum of
    ``b`` lanes, ``n`` points, ``k`` centroids and ``d`` features:
    ``"chain"`` (``dot_chain``) or ``"four"`` (``dot_nt``'s interleaved
    chains: four, or two where d is 1 or 2 mod 4), from ``DOT_ORDERS``.
    A shape outside the table takes ``"four"``, the order of the engine's
    k = 20 fits (and, below d = 4, the one chain both orders are)."""
    return DOT_ORDERS.get((int(b), int(n), int(k), int(d)), "four")


def dot_in_order(x: torch.Tensor, y: torch.Tensor, order: str
                 ) -> torch.Tensor:
    """``dot_nt`` (``order="four"``) or ``dot_chain`` (``"chain"``)."""
    if order == "chain":
        return dot_chain(x, y)
    if order == "four":
        return dot_nt(x, y)
    raise ValueError(f"unknown dot order {order!r}; 'four' or 'chain'")


def seq_sum(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` one slice at a time, in order, in ``v``'s dtype
    (numpy's order for a reduction over an outer axis)."""
    acc = torch.zeros_like(v.select(dim, 0))
    for j in range(v.shape[dim]):
        acc = acc + v.select(dim, j)
    return acc
