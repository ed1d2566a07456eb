"""The bf16 flash-attention kernel with P split and with P rounded once.

    python -m repro_torch.kernels.flash_attention.variants

Builds ``csrc/flash_attention_sm90.cu`` twice, one ``nvcc`` each, started
together: as shipped, where P . V takes P as bf16 hi + lo (float32
accuracy, 1.5x the MMA work of S and P . V with one rounding), and with
``-DFLASH_SINGLE_P``, which drops the lo chain and rounds P to bf16 once
as FA2/3 and SDPA do. Only this script sets that define. For each build
it prints the registers and spilled bytes that ``ptxas`` reports for the
d = 128 instance, its time by CUDA events at the LM's prefill shape and
at one 32768-long head (q, k and v in the projections' (b, s, h, d)
layout, read as (b, h, s, d) views), and its largest error against the
plain version as a share of the card's bf16 tolerance (rtol 8e-3, atol
1e-3), after the output's bf16 rounding as the checks see it. The builds
are timed in the order given and then in reverse within one process, so
a drift of the card's clock shows as a spread between the two readings.
Needs one CUDA device and ``nvcc``. The last line is a JSON object with
every reading.
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
from .ref import flash_attention_ref

SHAPES = {"prefill": (4, 24, 8, 4096, 4096, 128),
          "long": (1, 1, 1, 32768, 32768, 128)}
VARIANTS = {"hi_lo": (), "single_p": ("-DFLASH_SINGLE_P",)}
RTOL, ATOL = 8e-3, 1e-3

_ENTRY_RE = re.compile(r"Compiling entry function '([^']+)'")
_SPILL_RE = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS_RE = re.compile(r"Used (\d+) registers")


def parse_ptxas(log: str) -> dict[str, dict]:
    """Registers and spilled bytes by kernel instance, from ``ptxas -v``.

    Instances are named by their padded head width (``"128"``, ``"64"``,
    ``"32"``) from the mangled ``flash_fwd_sm90<DP>`` names."""
    out: dict[str, dict] = {}
    name: Optional[str] = None
    for line in log.splitlines():
        m = _ENTRY_RE.search(line)
        if m:
            inst = re.search(r"flash_fwd_sm90ILi(\d+)EE", m.group(1))
            name = None if inst is None else inst.group(1)
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


def _build() -> dict[str, tuple[str, str]]:
    """One library per variant: ``{variant: (path, ptxas log)}``."""
    src, default = _backend._target("flash_attention_sm90")
    _backend.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defines in VARIANTS.items():
        out = default.with_name(f"{default.stem}-{name}.so")
        cmd = [_backend._nvcc(), *_backend.NVCC_FLAGS, *defines, "-o",
               str(out), str(src)]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE,
                                             text=True))
    built = {}
    for name, (out, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{stdout}{stderr}")
        built[name] = (str(out), stdout + stderr)
    return built


def _call(fn, q, k, v, out) -> None:
    ops.launch(q, k, v, out, 1.0 / q.shape[3] ** 0.5, entry=fn)


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
    """Time each variant on the card; 1 where no CUDA device is visible."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    built = _build()
    fns = {n: ops.bind(ctypes.CDLL(path).flash_attention_bf16)
           for n, (path, _) in built.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = {n: {"ptxas": parse_ptxas(log)} for n, (_, log) in built.items()}
    for label, (b, hq, hkv, sq, skv, d) in SHAPES.items():
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2)
                   for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
        outs = {n: torch.empty((b, sq, hq, d), dtype=torch.bfloat16,
                               device="cuda").transpose(1, 2) for n in fns}
        order = list(fns) + list(fns)[::-1]
        for n in order:
            ms = _time_ms(lambda: _call(fns[n], q, k, v, outs[n]))
            rec[n].setdefault(f"{label}_ms", []).append(ms)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v).float()
        for n, out in outs.items():
            share = ((out.float() - want).abs()
                     / (ATOL + RTOL * want.abs())).max()
            rec[n][f"{label}_tol_share"] = float(share)
        del q, k, v, outs, want
    for n, r in rec.items():
        regs = r["ptxas"].get("128", {})
        print(f"{n}: d=128 {regs.get('registers')} registers, spill "
              f"stores/loads {regs.get('spill_stores')}/"
              f"{regs.get('spill_loads')} bytes; prefill "
              f"{r['prefill_ms'][0]:.4f} / {r['prefill_ms'][1]:.4f} ms "
              f"({r['prefill_tol_share']:.4f} of the tolerance); 32768 "
              f"{r['long_ms'][0]:.4f} / {r['long_ms'][1]:.4f} ms "
              f"({r['long_tol_share']:.4f} of the tolerance)", flush=True)
    for path, _ in built.values():
        os.remove(path)
    print(json.dumps({"card": card, "variants": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
