"""Public wrapper of the causal flash-attention kernel.

Counterpart of ``repro.kernels.flash_attention.ops``: q ``(b, hq, sq, d)``,
k and v ``(b, hkv, skv, d)``, causal with end alignment (row i sees key
columns j <= i + skv - sq), grouped-query heads (query head h reads kv
head h // (hq // hkv)), float32 arithmetic from float32 or bfloat16
inputs, output in q's type. A CPU tensor takes the plain version
(``ref.flash_attention_ref``); a CUDA tensor launches
``csrc/flash_attention.cu`` or raises (``repro_torch.kernels.backend``).

The kernel reads the real sequence lengths and head width and masks the
ragged edge itself, so nothing is padded and the reference's ``kv_start``
front-padding mask has no counterpart. Unlike the reference's wrapper,
this one refuses sq > skv: those rows would see no column (the
reference's oracle gives NaN there, its Pallas kernel a masked average),
and no caller of the model makes them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import backend as _backend
from .ref import flash_attention_ref

__all__ = ["flash_attention", "last_dispatch", "launch_count",
           "reset_launch_count", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 128
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}

# launches of the CUDA kernel in this process, and the latest one's shape
_launches = 0
_last_dispatch: Optional[dict] = None


def launch_count() -> int:
    """Number of CUDA kernel launches since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def last_dispatch() -> Optional[dict]:
    """Shape record of the latest kernel launch (``None`` before any):
    ``b``, ``hq``, ``hkv``, ``sq``, ``skv``, ``d``, ``dtype`` and
    ``grid``. Plain calls leave it untouched."""
    return None if _last_dispatch is None else dict(_last_dispatch)


def _entry(dtype: torch.dtype):
    fn = getattr(_backend.library("flash_attention"), _ENTRY[dtype])
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    if not causal:
        raise NotImplementedError("kernel path is causal-only; use "
                                  "ref.attention_ref")
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
    if sq < 1 or sq > skv:
        raise ValueError(f"need 1 <= sq <= skv (got sq={sq}, skv={skv}): "
                         "rows past skv would see no key column")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {sorted(map(str, _ENTRY))}"
                         f"; got {q.dtype}, {k.dtype}, {v.dtype}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention; ``scale`` defaults to 1/sqrt(d)."""
    _check(q, k, v, causal)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if _backend.resolve_route(q, "auto") == "plain":
        return flash_attention_ref(q, k, v, scale=scale)
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on the same device")
    qc, kc, vc = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(qc)
    code = _entry(q.dtype)(_backend.ptr(qc), _backend.ptr(kc),
                           _backend.ptr(vc), _backend.ptr(out), b, hq, hkv,
                           sq, skv, d, float(scale),
                           _backend.stream_handle(q.device))
    _backend.check_launch("flash_attention", code)
    global _launches, _last_dispatch
    _launches += 1
    _last_dispatch = {"b": b, "hq": hq, "hkv": hkv, "sq": sq, "skv": skv,
                      "d": d, "dtype": q.dtype,
                      "grid": (b * hq, -(-sq // 64))}
    return out
