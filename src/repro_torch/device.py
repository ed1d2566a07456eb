"""Device resolution shared by the port's entry points.

Every entry point runs on the card unless the caller names another
device: ``device=None`` means ``"cuda"``, and asking for the card where
there is none raises one clear error instead of falling back to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None, *, what: str = "the port") -> torch.device:
    """``device``, or the card when it is None; raises if that is a CUDA
    device and none is available. ``what`` names the caller in the error."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
