"""Kernel routing and the build of the port's CUDA kernels.

Every kernel wrapper in ``repro_torch.kernels`` follows one rule:

* a tensor on the CPU takes the kernel's plain PyTorch version;
* a tensor on a CUDA device launches the hand-written kernel, or raises.

There is no fallback: a kernel that does not build or does not launch is
an error, never a silent switch to the plain version. ``backend="auto"``
(the default) follows that rule; ``backend="plain"`` asks for the plain
version on any device (the chip smoke run uses it to hold the kernels
against their plain versions).

Kernels are CUDA C++ sources in ``src/repro_torch/csrc/``, compiled for
``sm_90a`` by ``nvcc`` into shared libraries with a plain C interface and
loaded with ``ctypes``. They build at first use, into ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``), one library per
``.cu`` source named by a hash of its text and of the ``.cuh`` headers
(a kernel whose instantiations are many is one header and several
``.cu`` units), so an edited source never loads a stale library.
``build_all`` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Callable, Optional

import torch

from ..device import traces_card

__all__ = ["ROUTES", "resolve_route", "library", "build_all", "build_info",
           "check_launch", "ptr", "stream_handle", "shard_scope",
           "current_shard", "BUILD_DIR", "CSRC_DIR"]

ROUTES = ("auto", "plain")
CSRC_DIR = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# loaded libraries and their build records, by source name
_LIBS: dict[str, ctypes.CDLL] = {}
_BUILD_INFO: dict[str, dict] = {}
# the mesh shard (its index in the mesh, row-major) whose program is
# launching kernels, set by repro_torch.distributed; None outside one
_SHARD: Optional[int] = None


@contextlib.contextmanager
def shard_scope(index: Optional[int]):
    """Mark the kernels launched inside as shard ``index``'s: the
    wrappers count their launches by shard too."""
    global _SHARD
    prev, _SHARD = _SHARD, index
    try:
        yield
    finally:
        _SHARD = prev


def current_shard() -> Optional[int]:
    """The shard whose program is running (``shard_scope``), or None."""
    return _SHARD


def resolve_route(t: torch.Tensor, backend: str) -> str:
    """``"plain"`` or ``"kernel"`` for a tensor under ``backend``."""
    if backend not in ROUTES:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{ROUTES}")
    if backend == "plain":
        return "plain"
    if t.is_cuda or traces_card(t.device):
        return "kernel"
    if t.device.type == "cpu":
        return "plain"
    raise RuntimeError(f"no kernel route for device {t.device}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):   # shared by the units
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; None when its library already exists."""
    src, out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    rec = {"t0": time.perf_counter()}

    def wait():
        # drains nvcc's output as it comes and times its own exit, however
        # long the caller's work beside the build takes
        rec["output"] = proc.communicate()
        rec["seconds"] = time.perf_counter() - rec["t0"]

    waiter = threading.Thread(target=wait, daemon=True)
    waiter.start()
    return proc, tmp, out, waiter, rec


def _finish(name: str, started) -> None:
    if started is None:
        _BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "(cached)"})
        return
    proc, tmp, out, waiter, rec = started
    waiter.join()
    stdout, stderr = rec["output"]
    seconds = rec["seconds"]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{stdout}{stderr}")
    os.replace(tmp, out)
    _BUILD_INFO[name] = {"seconds": seconds, "log": stdout + stderr}


def build_all(names: Optional[list[str]] = None, *,
              while_building: Optional[Callable[[], None]] = None
              ) -> dict[str, dict]:
    """Build every kernel source at once (one nvcc each); returns the
    build records (seconds, nvcc/ptxas output) by source name.
    ``while_building`` is host work to run while the compilers do."""
    names = names or sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    started = {n: _start(n) for n in names}
    try:
        if while_building is not None:
            while_building()
    finally:        # the compilers are waited for even if that work fails
        for n in names:
            _finish(n, started[n])
    for n in names:
        library(n)
    return build_info()


def build_info() -> dict[str, dict]:
    """Build records of the kernels built in this process."""
    return {k: dict(v) for k, v in _BUILD_INFO.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library built from ``csrc/<name>.cu``."""
    if name not in _LIBS:
        _finish(name, _start(name))
        _LIBS[name] = ctypes.CDLL(str(_target(name)[1]))
    return _LIBS[name]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """A tensor's data pointer as a C ``void *`` argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """The device's current CUDA stream as a C ``cudaStream_t`` argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(kernel: str, code: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error "
                           f"{code}")
