"""The one precision policy for the port's numeric stack.

Counterpart of ``repro.core.precision``: a frozen triple of dtype names —

* ``trace`` — what device computations run in (kernels, estimates);
* ``accum`` — what streaming accumulators carry;
* ``host`` — what host-side statistics use.

PyTorch computes float64 natively on the CPU and on CUDA, so a wider
policy needs no context manager: code asks the policy for torch dtypes
(``trace_dtype`` ...) and computes in them.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["PrecisionPolicy", "DEFAULT_PRECISION", "resolve_precision"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Trace / accumulator / host dtype triple for one numeric pipeline."""

    trace: str = "float32"
    accum: str = "float32"
    host: str = "float64"

    def __post_init__(self):
        for field in ("trace", "accum", "host"):
            value = getattr(self, field)
            name = str(value).replace("torch.", "")
            if name not in _DTYPES:
                raise ValueError(
                    f"PrecisionPolicy.{field} must be one of "
                    f"{tuple(_DTYPES)}, got {value!r}")
            object.__setattr__(self, field, name)

    @property
    def trace_dtype(self) -> torch.dtype:
        return _DTYPES[self.trace]

    @property
    def accum_dtype(self) -> torch.dtype:
        return _DTYPES[self.accum]

    @property
    def host_dtype(self) -> torch.dtype:
        return _DTYPES[self.host]

    @classmethod
    def host_parity(cls) -> "PrecisionPolicy":
        """The sweep-estimate policy: float64 throughout, natively on the
        CPU and on CUDA."""
        return cls(trace="float64", accum="float64", host="float64")


DEFAULT_PRECISION = PrecisionPolicy()


def resolve_precision(precision: PrecisionPolicy | None,
                      *fallbacks: PrecisionPolicy | None) -> PrecisionPolicy:
    """First non-None of (precision, *fallbacks, DEFAULT_PRECISION)."""
    for p in (precision,) + fallbacks:
        if p is not None:
            return p
    return DEFAULT_PRECISION
