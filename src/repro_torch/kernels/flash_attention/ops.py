"""Public wrapper of the flash-attention kernels.

Counterpart of ``repro.kernels.flash_attention.ops``: q ``(b, hq, sq, d)``,
k and v ``(b, hkv, skv, d)``, causal with end alignment (row i sees key
columns j <= i + skv - sq) or, with ``causal=False``, bidirectional (every
row sees every column: the reference kernel's other branch, which its
public wrapper does not expose and the enc-dec model needs for its
encoder and cross-attention), grouped-query heads (query head h reads kv
head h // (hq // hkv)), float32 arithmetic from float32 or bfloat16
inputs, output in q's type. A CPU tensor takes the plain version
(``ref.flash_attention_ref``); a CUDA tensor launches a kernel or raises
(``repro_torch.kernels.backend``): bf16 goes to the tensor-core kernel of
``csrc/flash_attention_sm90.cu`` (TMA + ``wgmma``), float32 to the SIMT
kernel of ``csrc/flash_attention.cu``.

Layout contract (both routes, both types): q, k and v may be any strided
views whose last dimension is contiguous, whose other strides are
multiples of 8 elements and whose data start on a 16-byte boundary — the
``(b, h, s, d)`` views that ``x.reshape(b, s, h, d).transpose(1, 2)``
makes of a projection's output qualify, and are read in place. Anything
else raises ``ValueError``; nothing is copied behind the caller's back.
The output is allocated ``(b, sq, hq, d)`` and returned as its
``transpose(1, 2)`` view, so the caller's transpose back to
``(b, sq, hq * d)`` is a view too.

The kernels read the real sequence lengths and head width and mask the
ragged edge themselves, so nothing is padded and the reference's
``kv_start`` front-padding mask has no counterpart. Unlike the
reference's wrapper, this one refuses causal calls with sq > skv: those
rows would see no column (the reference's oracle gives NaN there, its
Pallas kernel a masked average), and no caller of the model makes them.
A non-causal call takes any sq and skv >= 1 (cross-attention has
sq != skv both ways).

There is no backward, on either route (the reference's kernel has none;
its model trains through ``attention_ref``): with grad mode on and q, k
or v requiring a gradient the wrapper raises ``RuntimeError``, so a
gradient is never dropped unseen. Training takes the model's
``backend="plain"`` route.

The kernel route goes through one operator, ``repro_torch::
flash_attention`` (``torch.library.custom_op``), so a program that
reaches flash can be traced: under ``FakeTensorMode`` (the cost model's
abstract path, ``launch.cost_analysis``) its fake gives the output's
shape and launches nothing, and its FLOPs formula (``flash_flops``,
registered with ``torch.utils.flop_counter``) counts the work the kernel
does. On a real CUDA tensor the operator launches the same kernel as
before (same grid, ``last_dispatch()``); the launch counter counts real
launches only, so a trace leaves it untouched (a traced program keeps
its flash calls in its own op log).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from .. import backend as _backend
from .ref import flash_attention_ref

__all__ = ["flash_attention", "last_dispatch", "launch_count",
           "reset_launch_count", "tensor_map_args", "flash_flops",
           "MAX_HEAD_DIM", "BF16_ROWS", "F32_ROWS"]

MAX_HEAD_DIM = 128
BF16_ROWS = 128          # query rows per block and keys per K/V tile (bf16)
F32_ROWS = 64            # query rows per block of the float32 kernel
# (source, C entry) of each type's kernel
_ENTRY = {torch.float32: ("flash_attention", "flash_attention_f32"),
          torch.bfloat16: ("flash_attention_sm90", "flash_attention_bf16")}

# launches of the CUDA kernels in this process by branch, and the latest
# one's shape
_launches = {"causal": 0, "non_causal": 0}
_last_dispatch: Optional[dict] = None


def launch_count(branch: Optional[str] = None) -> int:
    """Number of CUDA kernel launches since the last reset: of both
    branches, or of ``branch`` (``"causal"`` or ``"non_causal"``)."""
    if branch is None:
        return sum(_launches.values())
    return _launches[branch]


def reset_launch_count() -> None:
    for branch in _launches:
        _launches[branch] = 0


def last_dispatch() -> Optional[dict]:
    """Shape record of the latest kernel launch (``None`` before any):
    ``b``, ``hq``, ``hkv``, ``sq``, ``skv``, ``d``, ``causal``, ``dtype``,
    ``source`` and ``grid``. Plain calls leave it untouched."""
    return None if _last_dispatch is None else dict(_last_dispatch)


def _strides(shape, strides) -> tuple[int, int, int, int]:
    """Element strides of a ``(b, h, s, d)`` tensor, with each size-1
    dimension's (meaningless) stride replaced by the stride it would have
    if the tensor were contiguous."""
    out, step = [], 1
    for size, stride in reversed(list(zip(shape, strides))):
        out.append(stride if size > 1 else step)
        step *= size
    return tuple(reversed(out))


def tensor_map_args(shape, strides, itemsize: int = 2
                    ) -> tuple[tuple[int, ...], tuple[int, ...],
                               tuple[int, ...]]:
    """Arguments of the bf16 kernel's 4-D TMA tensor map for a
    ``(b, h, s, d)`` tensor of these element strides: dims
    ``(d, h, s, b)``, the byte strides of h, s and b (d is contiguous),
    and the box the kernel loads, ``(cols, 1, 128, 1)`` with cols 32 for
    d <= 32 (64-byte swizzle) and 64 otherwise (128-byte swizzle; d > 64
    takes two boxes). Size-1 dimensions get the stride of a contiguous
    tensor."""
    b, h, s, d = shape
    sb, sh, ss, _ = _strides(shape, strides)
    dims = (d, h, s, b)
    byte_strides = (sh * itemsize, ss * itemsize, sb * itemsize)
    box = (32 if d <= 32 else 64, 1, BF16_ROWS, 1)
    return dims, byte_strides, box


def _check_layout(name: str, t: torch.Tensor) -> None:
    b, h, s, d = t.shape
    if t.stride(3) != 1:
        raise ValueError(f"{name}: the last dimension must be contiguous "
                         f"(strides {tuple(t.stride())})")
    bad = [st for size, st in zip(t.shape[:3], t.stride()[:3])
           if size > 1 and st % 8]
    if bad:
        raise ValueError(f"{name}: strides {tuple(t.stride())} must be "
                         "multiples of 8 elements")
    if not is_fake(t) and t.data_ptr() % 16:
        raise ValueError(f"{name}: data must start on a 16-byte boundary")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (b, hq, sq, d) and k, v (b, hkv, skv, "
                         f"d); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"batch or head width mismatch: q {tuple(q.shape)}"
                         f" vs k {tuple(k.shape)}")
    hkv, skv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"GQA heads mismatch: {hq} % {hkv}")
    if d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"head width {d} must be a multiple of 8 and at "
                         f"most {MAX_HEAD_DIM}")
    if sq < 1 or skv < 1:
        raise ValueError(f"need sq >= 1 and skv >= 1 (got sq={sq}, "
                         f"skv={skv})")
    if causal and sq > skv:
        raise ValueError(f"a causal call needs sq <= skv (got sq={sq}, "
                         f"skv={skv}): rows past skv would see no key "
                         "column")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {sorted(map(str, _ENTRY))}"
                         f"; got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)


def bind(fn):
    """Declare a C entry's arguments (both entries share one signature:
    q, k, v, o, the q, k, v layout words, o's strides, b, hq, hkv, sq,
    skv, d, causal, scale, stream)."""
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        words = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [vp, vp, vp, vp, words, words, words, words,
                       i, i, i, i, i, i, i, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def _entry(dtype: torch.dtype):
    source, name = _ENTRY[dtype]
    return bind(getattr(_backend.library(source), name))


def _words(values) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*values)


def launch(q, k, v, out, scale: float, entry=None, *,
           causal: bool = True) -> tuple:
    """Launch the kernel of q's type (or the bound C ``entry`` given, of
    the same signature) on checked q, k, v into ``out``, causal or not;
    returns its grid."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        args = [_words(sum(tensor_map_args(t.shape, t.stride()), ()))
                for t in (q, k, v)]
        grid = (-(-sq // BF16_ROWS) * b * hq,)
    else:
        args = [_words(_strides(t.shape, t.stride())[:3]) for t in (q, k, v)]
        grid = (b * hq, -(-sq // F32_ROWS))
    args.append(_words(_strides(out.shape, out.stride())[:3]))
    entry = entry or _entry(q.dtype)
    code = entry(_backend.ptr(q), _backend.ptr(k), _backend.ptr(v),
                 _backend.ptr(out), *args, b, hq, hkv, sq, skv, d,
                 int(bool(causal)), float(scale),
                 _backend.stream_handle(q.device))
    _backend.check_launch("flash_attention", code)
    return grid


def flash_flops(q_shape, k_shape, dtype: torch.dtype, causal: bool) -> int:
    """FLOPs of one kernel launch as the kernel does them: per ``(b,
    hq)``, query tile ``i`` (``R`` rows: 128 in bf16, 64 in float32)
    takes ``n_i`` key tiles of ``K = R`` keys, each two ``R x K x d``
    products done whole (ragged edges masked, not skipped), so

        flops = 4 b hq R K d sum_i n_i,

    with ``n_i = ceil(skv / K)`` bidirectional (every tile) and, causal,
    ``n_i = ceil((min((i + 1) R, sq) + skv - sq) / K)`` (the tiles on or
    below the end-aligned diagonal; those wholly above it are skipped).
    Where ``sq = skv = n R`` that is ``2 b hq d s (s + R)`` causal and
    ``4 b hq d s^2`` bidirectional."""
    b, hq, sq, d = q_shape
    skv = k_shape[2]
    rows = BF16_ROWS if dtype == torch.bfloat16 else F32_ROWS
    tiles = 0
    for i in range(-(-sq // rows)):
        kv_end = min((i + 1) * rows, sq) + skv - sq if causal else skv
        tiles += -(-kv_end // rows)
    return 4 * b * hq * rows * rows * d * tiles


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, causal: bool) -> torch.Tensor:
    """The kernel of q's type on checked CUDA tensors: returns the
    ``(b, sq, hq, d)`` output."""
    b, hq, sq, d = q.shape
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    grid = launch(q, k, v, out.transpose(1, 2), scale, causal=causal)
    global _last_dispatch
    _launches["causal" if causal else "non_causal"] += 1
    _last_dispatch = {"b": b, "hq": hq, "hkv": k.shape[1], "sq": sq,
                      "skv": k.shape[2], "d": d, "causal": bool(causal),
                      "dtype": q.dtype,
                      "source": _ENTRY[q.dtype][0], "grid": grid}
    return out


@_flash_op.register_fake
def _(q, k, v, scale, causal):
    b, hq, sq, d = q.shape
    return q.new_empty((b, sq, hq, d))


@register_flop_formula(torch.ops.repro_torch.flash_attention, get_raw=True)
def _flash_op_flops(q, k, v, scale, causal, *, out_val=None, **kwargs
                    ) -> int:
    return flash_flops(tuple(q.shape), tuple(k.shape), q.dtype, causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention, causal (end-aligned) or, with ``causal=False``,
    bidirectional; ``scale`` defaults to 1/sqrt(d). Returns the
    ``(b, hq, sq, d)`` view of a ``(b, sq, hq, d)`` tensor. Raises
    ``RuntimeError`` under grad mode when an input requires a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward: call it under "
            "torch.no_grad(), or train through the model's "
            "backend='plain' attention route")
    _check(q, k, v, causal)
    b, hq, sq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    route = _backend.resolve_route(q, "auto")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on the same device")
    if route == "plain":
        out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        return out.copy_(flash_attention_ref(q, k, v, scale=scale,
                                             causal=causal))
    return torch.ops.repro_torch.flash_attention(
        q, k, v, float(scale), bool(causal)).transpose(1, 2)
