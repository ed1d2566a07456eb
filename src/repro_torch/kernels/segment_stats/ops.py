"""Public wrapper of the batch-native per-segment statistics kernel.

Counterpart of ``repro.kernels.segment_stats.ops``: ``(n,)``, ``(n, d)``,
``(A, n)``, ``(A, T, n)``... all flatten their leading axes into the
kernel's lane axis, one launch whatever the rank. A CPU tensor takes the
plain version (``ref.py``); a CUDA tensor launches
``csrc/segment_stats.cu`` or raises (``repro_torch.kernels.backend``).
The kernel adds each segment's rows in row order, as the plain version
does, so two launches on the same input are bitwise equal, and equal to
it. Like the reference's kernel it takes any number of segments and of
lanes: above ``RANGE`` segments its partition is ranged
(``partition_geometry``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import backend as _backend
from .ref import segment_stats_ref

__all__ = ["segment_stats", "stratum_moments", "last_dispatch",
           "launch_count", "reset_launch_count",
           "launch_counts_by_shard", "partition_geometry",
           "workspace_words", "RANGE"]

_launches = 0
_by_shard: dict[int, int] = {}
_last_dispatch: Optional[dict] = None


def launch_count() -> int:
    """Number of CUDA kernel launches since the last reset. A call made
    while a CUDA graph is being captured only records the launch, which
    runs when the graph is replayed, so it is not counted."""
    return _launches


def reset_launch_count() -> None:
    """Set the launch count, and the count by shard, to 0."""
    global _launches
    _launches = 0
    _by_shard.clear()


def launch_counts_by_shard() -> dict[int, int]:
    """The launches counted since the last reset that a mesh shard's
    program made, by shard index (``backend.shard_scope``)."""
    return dict(_by_shard)


def _count_launch() -> None:
    global _launches
    _launches += 1
    shard = _backend.current_shard()
    if shard is not None:
        _by_shard[shard] = _by_shard.get(shard, 0) + 1


def last_dispatch() -> Optional[dict]:
    """Shape record of the latest kernel launch (``None`` before any):
    ``batch``, ``batch_shape``, ``n``, ``k``, ``d``, ``tiles`` (row tiles
    of the partition passes), ``tile_rows`` and ``ranges`` (their rows,
    and the ranges of segments they take: ``partition_geometry``),
    ``grid`` of the sum pass (blocks of two (lane, segment, 16-column
    chunk) items) and ``ordered`` (whether the items went longest segment
    first, which only a launch of more blocks than fit on the card at once
    needs). Plain calls leave it untouched."""
    return None if _last_dispatch is None else dict(_last_dispatch)


# segments whose places one block keeps in shared memory; above it the
# partition is ranged (csrc/segment_stats.cu, kRange and kRangedRows)
RANGE = 11264
_RANGED_ROWS = 8192
_TILE_ROWS, _SUM_ROWS, _COLS = 256, 32, 16


def partition_geometry(n: int, k: int) -> dict:
    """The kernel's partition of ``n`` rows into ``k`` segments, as
    ``csrc/segment_stats.cu`` lays it out: ``tile_rows`` (256, or 256
    ``ceil(k / 8192)`` where the partition is ranged), ``tiles``,
    ``ranges`` (blocks of at most ``RANGE`` segments a tile), ``align``
    (each segment's gathered rows start at a multiple of it: 32, or 4 where
    ranged) and ``pad`` (gathered rows of a lane)."""
    ranged = k > RANGE
    tile_rows = _TILE_ROWS * (-(-k // _RANGED_ROWS) if ranged else 1)
    align = 4 if ranged else _SUM_ROWS
    pad = (-(-(n + 3 * k) // 4) * 4 + _SUM_ROWS if ranged
           else -(-(n + (_SUM_ROWS - 1) * k) // _SUM_ROWS) * _SUM_ROWS)
    return {"tile_rows": tile_rows, "tiles": -(-n // tile_rows),
            "ranges": -(-k // RANGE), "align": align, "pad": pad}


def workspace_words(b: int, n: int, k: int, d: int) -> int:
    """4-byte words of scratch a launch at ``(b, n, k, d)`` takes (the
    C entry ``segment_stats_workspace``): the gathered rows, the (tile,
    segment) places, starts, sizes and the sum pass's item order."""
    g = partition_geometry(n, k)
    return (b * g["pad"] * d + b * k * g["tiles"] + 2 * b * k
            + b * k * -(-d // _COLS))


# the kernel's passes, as bits of the launch's pass mask ("sum" includes
# the item order, where one is needed)
PASSES = {"count": 1, "scan": 2, "scatter": 4, "sum": 8}
ALL_PASSES = sum(PASSES.values())


def _lib():
    lib = _backend.library("segment_stats")
    fn, work = lib.segment_stats_f32, lib.segment_stats_workspace
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, i, i, i, i, vp, vp, vp, vp, i, vp, vp]
        fn.restype = ctypes.c_int
        work.argtypes = [i, i, i, i]
        work.restype = ctypes.c_longlong
        lat = lib.segment_stats_add_latency
        lat.argtypes = [i, vp, vp, vp]
        lat.restype = ctypes.c_int
    return fn, work


def _launch(xb: torch.Tensor, lb: torch.Tensor, k: int,
            passes: int = ALL_PASSES, work: Optional[torch.Tensor] = None):
    """Launch the kernel's passes on contiguous ``xb (b, n, d)`` float32
    and ``lb (b, n)`` int32; returns ``(sums, sumsq, counts, work,
    geometry)``, geometry being (partition tiles, sum-pass blocks,
    ordered, tile rows, ranges). A later call with the same ``work`` may
    run a single pass
    (``passes`` mask) on the state the earlier passes left: a timing
    hook."""
    b, n, d = xb.shape
    dev = xb.device
    f32 = torch.float32
    sums = torch.empty((b, k, d), dtype=f32, device=dev)
    sumsq = torch.empty((b, k, d), dtype=f32, device=dev)
    counts = torch.empty((b, k), dtype=f32, device=dev)
    launch, workspace = _lib()
    if work is None:
        work = torch.empty(max(int(workspace(b, n, k, d)), 1),
                           dtype=torch.int32, device=dev)
    geometry = (ctypes.c_int * 5)()
    p = _backend.ptr
    code = launch(p(xb), p(lb), b, n, k, d, p(sums), p(sumsq), p(counts),
                  p(work), passes, geometry, _backend.stream_handle(dev))
    _backend.check_launch("segment_stats", code)
    return sums, sumsq, counts, work, tuple(geometry)


def add_chain_cycles(adds: int, device) -> torch.Tensor:
    """Launch a one-warp chain of ``adds`` (a multiple of 8) dependent
    float32 adds, timed by ``clock64``; returns the int64 device tensor
    that receives its SM clock cycles (divide by ``adds`` for the add
    latency that bounds the sum pass's longest chain). Does not wait."""
    if adds <= 0 or adds % 8:
        raise ValueError(f"adds must be a positive multiple of 8: {adds}")
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    out = torch.empty(32, dtype=torch.float32, device=device)
    _lib()                                   # declares the entry's types
    code = _backend.library("segment_stats").segment_stats_add_latency(
        adds, _backend.ptr(cycles), _backend.ptr(out),
        _backend.stream_handle(cycles.device))
    _backend.check_launch("segment_stats add latency", code)
    return cycles


def segment_stats(x: torch.Tensor, labels: torch.Tensor, num_segments: int,
                  *, backend: str = "auto"
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-segment ``(sums, sumsq, counts)`` over any leading batch axes.

    ``x``: values, ``labels`` shape plus a trailing feature axis — or the
    same shape as ``labels``, when a feature axis of size 1 is appended
    (outputs keep it). ``labels``: integer segment ids; -1, or any id
    outside ``[0, num_segments)``, marks a row that adds nothing.
    Returns float32 ``sums (..., k, d)``, ``sumsq (..., k, d)`` and
    ``counts (..., k)``.
    """
    if x.shape == labels.shape:
        x = x[..., None]
    if x.shape[:-1] != labels.shape:
        raise ValueError(f"labels shape {tuple(labels.shape)} does not match "
                         f"x shape {tuple(x.shape)} (need x = labels shape "
                         "+ (d,))")
    k = int(num_segments)
    if _backend.resolve_route(x, backend) == "plain":
        return segment_stats_ref(x, labels, k)
    if labels.device != x.device:
        raise ValueError("x and labels must be on the same device")

    batch_shape = tuple(labels.shape[:-1])
    n, d = x.shape[-2], x.shape[-1]
    b = math.prod(batch_shape)
    xb = x.reshape(b, n, d).float().contiguous()
    lb = labels.reshape(b, n).to(torch.int32).contiguous()
    sums, sumsq, counts, _, (tiles, blocks, ordered, tile_rows, ranges) = \
        _launch(xb, lb, k)
    global _last_dispatch
    if not torch.cuda.is_current_stream_capturing():
        _count_launch()
    _last_dispatch = {"batch": b, "batch_shape": batch_shape, "n": n,
                      "k": k, "d": d, "tiles": tiles, "tile_rows": tile_rows,
                      "ranges": ranges, "grid": (blocks,),
                      "ordered": bool(ordered)}
    return (sums.reshape(*batch_shape, k, d),
            sumsq.reshape(*batch_shape, k, d),
            counts.reshape(*batch_shape, k))


def stratum_moments(x: torch.Tensor, labels: torch.Tensor,
                    num_segments: int, *, backend: str = "auto"
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(means, sample variances, counts) per stratum from the kernel stats.

    Variance uses the n-1 denominator (eq. 2); strata with fewer than two
    units get NaN variance.
    """
    sums, sumsq, counts = segment_stats(x, labels, num_segments,
                                        backend=backend)
    safe = torch.clamp_min(counts, 1.0)
    means = sums / safe[..., None]
    ss = sumsq - counts[..., None] * means * means
    var = torch.where((counts > 1)[..., None],
                      ss / torch.clamp_min(counts - 1.0, 1.0)[..., None],
                      torch.full_like(ss, float("nan")))
    return means, var, counts
