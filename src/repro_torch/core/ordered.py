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
* a matrix product keeps four interleaved multiply-add accumulators
  (depth index mod 4), summed as (a0 + a1) + (a2 + a3); a tail of three
  is added with plain products, and a depth below 4 is one multiply-add
  chain (``dot_nt``). This is bitwise for depths that are 0 or 3 mod 4
  and below 4; for depths 1 or 2 mod 4 the reference's tail order is
  not reproduced and results differ in the last bits.

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

__all__ = ["fma32", "tree_sum", "sum_sq", "blocked_cumsum", "dot_nt",
           "dot_chain", "seq_sum"]

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
    main = k - k % 4
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
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
    the reference's float32 dot at the figures' k >= 50 (its order moves
    with the shape; ``dot_nt`` keeps the one of the engine's k = 20 fits,
    as both clustering kernels do)."""
    x = x.float().double()[..., :, None, :]
    y = y.float().double()[..., None, :, :]
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(x.shape[-1]):
        acc = fma32(x[..., j], y[..., j], acc)
    return acc


def seq_sum(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` one slice at a time, in order, in ``v``'s dtype
    (numpy's order for a reduction over an outer axis)."""
    acc = torch.zeros_like(v.select(dim, 0))
    for j in range(v.shape[dim]):
        acc = acc + v.select(dim, j)
    return acc
