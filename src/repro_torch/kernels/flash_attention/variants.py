"""Register-budget variants of the flash-attention kernel, side by side.

    python -m repro_torch.kernels.flash_attention.variants [--blocks 1 2 3]

Builds ``csrc/flash_attention.cu`` once for each count of blocks that
must share an SM (``-DFLASH_MIN_BLOCKS``, which caps the registers a
thread at 65536 / (256 * blocks)), one ``nvcc`` each, all started
together. For each build it prints the registers and spilled bytes that
``ptxas`` reports for the d = 128 instances and times it with CUDA
events in bf16 at the LM's prefill shape and at one 32768-long head,
where its output must be bitwise equal to the default build's (the
arithmetic is the same, only the register allocation differs).
The builds are timed in the order given and then in reverse, within one
process, so that a drift of the card's clock shows as a spread between
the two readings. Needs one CUDA device and ``nvcc``. The last line is a
JSON object with every reading.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from typing import Optional

import torch

from .. import backend as _backend
from . import ops

SHAPES = {"prefill": (4, 24, 8, 4096, 4096, 128),
          "long": (1, 1, 1, 32768, 32768, 128)}

_ENTRY_RE = re.compile(r"Compiling entry function '([^']+)'")
_SPILL_RE = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS_RE = re.compile(r"Used (\d+) registers")


def parse_ptxas(log: str) -> dict[str, dict]:
    """Registers and spilled bytes by kernel instance, from ``ptxas -v``.

    Instances are named ``"<DP>/<type>"`` (``"128/bf16"``, ``"64/f32"``)
    from the mangled ``flash_fwd<DP, T>`` names."""
    out: dict[str, dict] = {}
    name: Optional[str] = None
    for line in log.splitlines():
        m = _ENTRY_RE.search(line)
        if m:
            inst = re.search(r"flash_fwdILi(\d+)E(13__nv_bfloat16|f)E",
                             m.group(1))
            name = None if inst is None else (
                f"{inst.group(1)}/"
                f"{'bf16' if inst.group(2) != 'f' else 'f32'}")
            if name:
                out[name] = {}
            continue
        if name is None:
            continue
        m = _SPILL_RE.search(line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = _REGS_RE.search(line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def _build(blocks: list[int]) -> dict[int, tuple[str, str]]:
    """One library per block count: ``{blocks: (path, ptxas log)}``; the
    default build (``ops.flash_attention``'s) alongside."""
    src, default = _backend._target("flash_attention")
    started = _backend._start("flash_attention")
    _backend.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in blocks:
        out = default.with_name(f"{default.stem}-minblocks{n}.so")
        cmd = [_backend._nvcc(), *_backend.NVCC_FLAGS,
               f"-DFLASH_MIN_BLOCKS={n}", "-o", str(out), str(src)]
        procs[n] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    built = {}
    for n, (out, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for FLASH_MIN_BLOCKS={n}:\n"
                               f"{stdout}{stderr}")
        built[n] = (str(out), stdout + stderr)
    _backend._finish("flash_attention", started)
    return built


def _bind(path: str):
    fn = ctypes.CDLL(path).flash_attention_bf16
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, ctypes.c_float, vp]
    fn.restype = ctypes.c_int
    return fn


def _call(fn, q, k, v, out) -> None:
    b, hq, sq, d = q.shape
    code = fn(_backend.ptr(q), _backend.ptr(k), _backend.ptr(v),
              _backend.ptr(out), b, hq, k.shape[1], sq, k.shape[2], d,
              1.0 / d ** 0.5, _backend.stream_handle(q.device))
    _backend.check_launch("flash_attention", code)


def _time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, nargs="+", default=[1, 2, 3])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    built = _build(args.blocks)
    fns = {n: _bind(path) for n, (path, _) in built.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = {n: {"ptxas": parse_ptxas(log)} for n, (_, log) in built.items()}
    for label, (b, hq, hkv, sq, skv, d) in SHAPES.items():
        q, k, v = (torch.randn(s, generator=gen, device="cuda")
                   .to(torch.bfloat16)
                   for s in ((b, hq, sq, d), (b, hkv, skv, d),
                             (b, hkv, skv, d)))
        outs = {n: torch.empty_like(q) for n in fns}
        want = ops.flash_attention(q, k, v)
        order = list(fns) + list(fns)[::-1]
        for n in order:
            ms = _time_ms(lambda: _call(fns[n], q, k, v, outs[n]))
            rec[n].setdefault(f"{label}_ms", []).append(ms)
        torch.cuda.synchronize()
        for n, out in outs.items():
            rec[n][f"{label}_bitwise_equal_default"] = bool(
                torch.equal(out, want))
        del q, k, v, outs, want
    for n, r in rec.items():
        regs = r["ptxas"].get("128/bf16", {})
        print(f"FLASH_MIN_BLOCKS={n}: d=128 bf16 {regs.get('registers')} "
              f"registers, spill stores/loads {regs.get('spill_stores')}/"
              f"{regs.get('spill_loads')} bytes; prefill "
              f"{r['prefill_ms'][0]:.4f} / {r['prefill_ms'][1]:.4f} ms; "
              f"32768 {r['long_ms'][0]:.4f} / {r['long_ms'][1]:.4f} ms; "
              f"bitwise equal to the default build: "
              f"{r['prefill_bitwise_equal_default']}, "
              f"{r['long_bitwise_equal_default']}", flush=True)
    for path, _ in built.values():
        os.remove(path)
    print(json.dumps({"card": card, "variants": {str(n): r for n, r in
                                                 rec.items()}}), flush=True)
    same = all(r["prefill_bitwise_equal_default"]
               and r["long_bitwise_equal_default"] for r in rec.values())
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
