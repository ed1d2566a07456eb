"""Counter-based threefry2x32 random numbers, bit-exact with ``jax.random``.

The reference package draws every random choice of the main path
(k-means++ seeds, the Johnson-Lindenstrauss projection) from
``jax.random`` with ``jax_threefry_partitionable=True``. Every integer
result downstream — seeds, hence stratum labels, picks and ledger
charges — depends on those bits, so the port reproduces them exactly
instead of drawing from ``torch.Generator``.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words;
leading axes are independent lanes (one key per lane). All arithmetic is
int64 with explicit 32-bit masking, so the same code runs on the CPU and
on the card. Float results are float32, as the reference draws them.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .core.ordered import blocked_cumsum, fma32

__all__ = ["PRNGKey", "split", "fold_in", "bits", "uniform", "randint",
           "choice", "normal", "normal_uniforms", "erf_inv"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) on broadcastable uint32-valued int64s."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x1 = (x1 + k1) & _M32
    x2 = (x2 + k2) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = ((x2 << r) | (x2 >> (32 - r))) & _M32
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def PRNGKey(seed: int, *, device=None) -> torch.Tensor:  # noqa: N802
    """The key ``jax.random.PRNGKey(seed)`` gives for a 32-bit seed."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def _iota(shape: Sequence[int], device) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of a row-major uint64 iota over ``shape``."""
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return (lo >> 32).reshape(shape), (lo & _M32).reshape(shape)


def _hash_counts(key: torch.Tensor, shape: Sequence[int]):
    """threefry(key, iota(shape)) per lane: two ``(..., *shape)`` words."""
    shape = tuple(shape)
    hi, lo = _iota(shape, key.device)
    pad = (None,) * len(shape)
    k1 = key[(..., 0) + pad]
    k2 = key[(..., 1) + pad]
    return _threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` keys -> ``(..., num, 2)``."""
    b1, b2 = _hash_counts(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a 32-bit integer ``data``."""
    b1, b2 = _threefry2x32(key[..., 0], key[..., 1], 0, int(data) & _M32)
    return torch.stack([b1, b2], dim=-1)


def bits(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.bits`` (32-bit) as int64 values in [0, 2**32)."""
    b1, b2 = _hash_counts(key, shape)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int] = (), minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on ``[minval, maxval)``."""
    mant = (bits(key, shape) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=key.device) - lo
    return torch.maximum(lo, fma32(floats, span, lo))


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32 bounds (int64 result)."""
    keys = split(key)
    hi = bits(keys[..., 0, :], shape)
    lo = bits(keys[..., 1, :], shape)
    span = (int(maxval) - int(minval)) & _M32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span       # uint32 product wraps
    off = (((hi % span) * mult) & _M32) + (lo % span)
    return int(minval) + (off & _M32) % span


def choice(key: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, n, p=p)`` (one draw, with replacement).

    ``key``: ``(..., 2)``; ``p``: ``(..., n)`` float32 weights, one row per
    lane. Returns the ``(...)`` int64 indices. The cumulative sum is taken
    in the reference's blocked order so that draws near a boundary land
    on the same side.
    """
    cum = blocked_cumsum(p).contiguous()
    u = uniform(key, ())
    r = cum[..., -1] * (1.0 - u)
    return torch.searchsorted(cum, r[..., None].contiguous())[..., 0]


# XLA's float32 erf_inv: Giles' single-precision polynomial in
# w = -log1p(-x^2), one coefficient set on each side of w = 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


# XLA's float32 log1p below |x| = sqrt(2) - 1: Cephes' rational form
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = fma32(p, x, torch.tensor(c, dtype=torch.float32, device=x.device))
    return p


# XLA-CPU's float32 log: Cephes' polynomial on the mantissa in [0.5, 1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _log(x: torch.Tensor) -> torch.Tensor:
    """Float32 log of positive normal ``x`` as XLA computes it on the CPU
    (agrees bitwise on all but ~0.05% of arguments, there by 1 ulp)."""
    def c(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device)

    xi = x.float().contiguous().view(torch.int32)
    e = 1.0 + ((xi >> 23) - 0x7F).float()
    m = ((xi & ~0x7F800000) | 0x3F000000).view(torch.float32)
    below = m < 0.707106781186547524
    e = e - below.float()
    t = (m - 1.0) + torch.where(below, m, c(0.0))
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = fma32(fma32(t, c(p[0]), c(p[1])), t, c(p[2]))
    y1 = fma32(fma32(t, c(p[3]), c(p[4])), t, c(p[5]))
    y2 = fma32(fma32(t, c(p[6]), c(p[7])), t, c(p[8]))
    y = fma32(fma32(y, x3, y1), x3, y2) * x3
    y = y + c(_LOG_Q1) * e
    t = (t - c(0.5) * x2) + y
    return t + c(_LOG_Q2) * e


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """Float32 log1p as XLA evaluates it on the CPU: Cephes' rational
    form below |x| = sqrt(2) - 1, else the log of the rounded 1 + x."""
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + fma32(torch.tensor(-0.5, device=x.device), x2, small)
    large = _log(1.0 + x)
    return torch.where(x.abs() < 0.41421356237309504880, small, large)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """Float32 inverse error function in XLA's formulation."""
    x = x.float()
    w = -_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=x.dtype,
                                            device=x.device),
                           torch.tensor(_ERFINV_GE5[i], dtype=x.dtype,
                                        device=x.device))

    p = coef(0).expand_as(x)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma32(p, w, coef(i))
    out = p * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       out)


def normal_uniforms(key: torch.Tensor, shape: Sequence[int] = ()
                    ) -> torch.Tensor:
    """The uniforms on (-1, 1) that ``normal`` maps through erf_inv."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    return uniform(key, shape, lo, 1.0)


def normal(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32: sqrt(2) * erf_inv(u)."""
    u = normal_uniforms(key, shape)
    sqrt2 = torch.tensor(math.sqrt(2), dtype=torch.float32, device=u.device)
    return sqrt2 * erf_inv(u)
