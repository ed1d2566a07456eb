"""Performance variants of one cell on the card's roofline: the
counterpart of ``repro.launch.perf``.

For a chosen (arch x shape) cell, traces a set of VARIANTS
(``train.step.lower_cell``: the card's program, nothing allocated),
derives the three-term roofline from the traced costs
(``launch.roofline``: the H100 SXM5's datasheet figures) and writes one
record a variant. Variants:

    baseline        the sweep configuration (launch.dryrun)
    serving_params  drop FSDP axes for inference params (prefill/decode)
    mb<K>           gradient-accumulation depth K (train)
    kvchunk<N>      streaming-attention chunk size N
                    (models.attention.KV_CHUNK)
    f32attn         float32 operands and probabilities in the streaming
                    softmax (models.attention.BF16_ATTENTION_OPERANDS)
    bf16attn        the probabilities rounded to the values' type
    fsdp_on         as baseline: the lowering reads no fsdp flag (nor
    fsdp_off        does the reference's)
    moe_ffshard     expert d_ff / d_model over the data axes instead of
                    FSDP (distributed.sharding._MOE_3D)
    mbff<K>         moe_ffshard with K microbatches

``remat_off`` is refused, as the reference refuses it (its docstring
names it, its ``main`` has no branch for it, and its ``measure``'s
``remat`` is read by nothing).

Usage:
    python -m repro_torch.launch.perf --arch olmoe-1b-7b \\
        --shape prefill_32k --variants baseline,serving_params
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from ..configs import SHAPE_BY_NAME, get_config
from ..launch.cost_analysis import program_costs, summarize_collectives
from ..launch.dryrun import production_mesh_shape
from ..launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS
from ..train.step import lower_cell

__all__ = ["measure", "variant_kwargs", "main"]


def measure(cfg, cell, mesh, *, microbatches=None, serving_params=False,
            kv_chunk=None, bf16_attn=None, fsdp=None,
            moe_ffshard=False) -> dict:
    """One variant's traced costs and roofline terms."""
    from ..distributed import sharding as sh_mod
    from ..models import attention as attn_mod
    old_chunk = attn_mod.KV_CHUNK
    old_bf16 = attn_mod.BF16_ATTENTION_OPERANDS
    old_moe = dict(sh_mod._MOE_3D)
    if kv_chunk:
        attn_mod.KV_CHUNK = kv_chunk
    if bf16_attn is not None:
        attn_mod.BF16_ATTENTION_OPERANDS = bf16_attn
    if moe_ffshard:
        # shard expert d_ff/d_model over the data axes INSTEAD of FSDP:
        # same per-device bytes, but the per-microbatch weight all-gather
        # becomes an activation-sized collective inside the expert einsum.
        sh_mod._MOE_3D = {"w_gate": ("model", None, "__dp__"),
                          "w_up": ("model", None, "__dp__"),
                          "w_down": ("model", "__dp__", None)}
    try:
        t0 = time.time()
        lowered = lower_cell(cfg, cell, mesh, microbatches=microbatches,
                             serving_params=serving_params, fsdp=fsdp)
        compiled = lowered.compile()
        wall = time.time() - t0
        costs = program_costs(compiled)
        colls = summarize_collectives(compiled)
        ma = compiled.memory_analysis()
        t_comp = costs["flops"] / PEAK_FLOPS
        t_mem = costs["bytes"] / HBM_BW
        t_coll = colls["total_wire_bytes"] / LINK_BW
        bound = max(t_comp, t_mem, t_coll)
        return {
            "t_compute_ms": t_comp * 1e3,
            "t_memory_ms": t_mem * 1e3,
            "t_collective_ms": t_coll * 1e3,
            "bound_ms": bound * 1e3,
            "dominant": max((t_comp, "compute"), (t_mem, "memory"),
                            (t_coll, "collective"))[1],
            "temp_gb": ma.temp_size_in_bytes / 2**30,
            "arg_gb": ma.argument_size_in_bytes / 2**30,
            "compile_s": round(wall, 1),
            "hlo_flops": costs["flops"],
            "hlo_bytes": costs["bytes"],
            "wire_bytes": colls["total_wire_bytes"],
        }
    finally:
        attn_mod.KV_CHUNK = old_chunk
        attn_mod.BF16_ATTENTION_OPERANDS = old_bf16
        sh_mod._MOE_3D = old_moe


def variant_kwargs(variant: str) -> dict:
    """``measure``'s keyword arguments for a variant's name; raises
    ``SystemExit`` for one it does not know (``remat_off`` too)."""
    if variant == "baseline":
        return {}
    if variant == "serving_params":
        return {"serving_params": True}
    if variant.startswith("mbff"):
        return {"moe_ffshard": True, "microbatches": int(variant[4:])}
    if variant.startswith("mb"):
        return {"microbatches": int(variant[2:])}
    if variant.startswith("kvchunk"):
        return {"kv_chunk": int(variant[7:])}
    if variant in ("f32attn", "bf16attn"):
        return {"bf16_attn": variant == "bf16attn"}
    if variant in ("fsdp_on", "fsdp_off"):
        return {"fsdp": variant == "fsdp_on"}
    if variant == "moe_ffshard":
        return {"moe_ffshard": True}
    raise SystemExit(f"unknown variant {variant}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--out", default="results/perf")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    cell = SHAPE_BY_NAME[args.shape]
    mesh = production_mesh_shape(args.mesh)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    for variant in args.variants.split(","):
        kwargs = variant_kwargs(variant)
        rec = measure(cfg, cell, mesh, **kwargs)
        rec.update(arch=args.arch, shape=args.shape, mesh=args.mesh,
                   variant=variant)
        path = out_dir / f"{args.arch}__{args.shape}__{variant}.json"
        path.write_text(json.dumps(rec, indent=1))
        print(f"{args.arch},{args.shape},{variant},"
              f"compute={rec['t_compute_ms']:.1f}ms,"
              f"memory={rec['t_memory_ms']:.1f}ms,"
              f"collective={rec['t_collective_ms']:.1f}ms,"
              f"dominant={rec['dominant']},temp={rec['temp_gb']:.1f}GB",
              flush=True)


if __name__ == "__main__":
    main()
