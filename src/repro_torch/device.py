"""Device resolution shared by the port's entry points.

Every entry point runs on the card unless the caller names another
device: ``device=None`` means ``"cuda"``, and asking for the card where
there is none raises one clear error instead of falling back to the CPU.

The one exception is asked for by name: inside ``tracing(device)`` the
port builds its programs for ``device`` without running them (the cost
model's abstract path, ``launch.cost_analysis``). Every tensor made
there is a ``FakeTensor`` (shapes, dtypes and a device, no storage), so
a machine without a card can trace the card's program, and nothing is
allocated or drawn. ``resolve_device`` then accepts the traced device,
and only it; outside ``tracing`` nothing changes.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

__all__ = ["resolve_device", "tracing", "traced_device", "is_traced",
           "traces_card"]

# the device ``tracing`` names, and the device its tensors are made on,
# while it is active
_TRACED: Optional[torch.device] = None
_STANDIN: Optional[torch.device] = None


def _indexed(dev: torch.device) -> torch.device:
    return torch.device(dev.type, 0) if dev.type == "cuda" \
        and dev.index is None else dev


@contextlib.contextmanager
def tracing(device="cuda"):
    """Build and run the port's programs for ``device`` abstractly: a
    ``FakeTensorMode`` is active inside, and ``resolve_device`` (and the
    meshes, ``launch.mesh.as_device``) accept ``device`` even where no
    such device exists. Yields the device to build on: ``device`` (a
    CUDA device gets index 0 where it names none) or, for a CUDA device
    where none is available, the meta device standing in for it (a build
    of torch without CUDA cannot open a CUDA device guard, which some
    operators' Python bindings do even on fake tensors; a process that
    sees no card would fail to). The kernels' routes
    (``kernels.backend.resolve_route``) take the stand-in for the card,
    so the traced program is the card's either way."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    global _TRACED, _STANDIN
    dev = _indexed(torch.device(device))
    standin = dev
    if dev.type == "cuda" and not torch.cuda.is_available():
        standin = torch.device("meta")
    prev = _TRACED, _STANDIN
    _TRACED, _STANDIN = dev, standin
    try:
        with FakeTensorMode(allow_non_fake_inputs=False):
            yield standin
    finally:
        _TRACED, _STANDIN = prev


def traced_device() -> Optional[torch.device]:
    """The device ``tracing`` names, or None outside it."""
    return _TRACED


def is_traced(dev) -> bool:
    """Whether ``dev`` is the device being traced (or its stand-in)."""
    if _TRACED is None:
        return False
    d = _indexed(torch.device(dev))
    return d == _TRACED or d == _STANDIN


def traces_card(dev) -> bool:
    """Whether ``dev`` is the stand-in of a traced CUDA device, whose
    tensors take the card's routes."""
    return _TRACED is not None and _TRACED.type == "cuda" \
        and _STANDIN != _TRACED and torch.device(dev) == _STANDIN


def resolve_device(device=None, *, what: str = "the port") -> torch.device:
    """``device``, or the card when it is None; raises if that is a CUDA
    device and none is available (unless it is the device ``tracing``
    names: then the device its tensors are made on). ``what`` names the
    caller in the error."""
    dev = torch.device("cuda" if device is None else device)
    if is_traced(dev):
        return _STANDIN
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
