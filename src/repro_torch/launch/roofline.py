"""Roofline of the dry run's records on the card: the counterpart of
``benchmarks/roofline.py``, kept in the package.

Per (arch x shape) cell of ``launch.dryrun`` (per device, from the
traced program's costs, ``launch.cost_analysis``):

    compute    = FLOPs / peak FLOP/s
    memory     = bytes accessed / HBM bandwidth
    collective = wire bytes / link bandwidth

and the bound is the largest. "Useful" work per device:
    train / prefill: MODEL_FLOPS per device at peak
    decode:          the minimum stream bytes (parameters and caches,
                     read once) over HBM

roofline_fraction = useful time / bound.

Neither ratio is capped at 1 (the reference caps both): a ratio above 1
means a count disagrees with the function's (the model FLOPs count an
untied input embedding's lookup as a product; the traced bytes are the
eager program's), and ``roofline_terms`` warns, naming the cell.

Hardware: the NVIDIA H100 SXM5 80 GB's datasheet figures at its 700 W
power limit: 989 TFLOP/s dense bf16 (tensor cores), 3.35 TB/s HBM3,
900 GB/s NVLink 4 (aggregate, per card). A card run below 700 W runs
below them, so a measured time is held against these as a lower bound
(``bound_ms``). The port's bytes are its eager program's (every
operator's operands), not a fused program's, so the memory term is an
upper estimate of what a fused program would stream.

Usage:
    python -m repro_torch.launch.roofline [--results results/dryrun]
"""

from __future__ import annotations

import argparse
import json
import warnings
from pathlib import Path

__all__ = ["CARD", "PEAK_FLOPS", "HBM_BW", "LINK_BW", "bound_ms",
           "load_cells", "roofline_terms", "main"]

CARD = "NVIDIA H100 SXM5 80GB, 700 W (datasheet)"
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 900e9

RESULTS = Path("results/dryrun")


def bound_ms(flops: float, nbytes: float, wire_bytes: float = 0.0
             ) -> tuple[float, str]:
    """The least time (ms) the card could take for ``flops`` FLOPs,
    ``nbytes`` HBM bytes and ``wire_bytes`` link bytes, and which term
    bounds it (``compute``, ``memory`` or ``collective``)."""
    terms = ((flops / PEAK_FLOPS, "compute"), (nbytes / HBM_BW, "memory"),
             (wire_bytes / LINK_BW, "collective"))
    t, name = max(terms)
    return t * 1e3, name


def load_cells(mesh: str = "single", results: Path = RESULTS) -> list[dict]:
    cells = []
    for p in sorted(Path(results).glob(f"*__{mesh}.json")):
        rec = json.loads(p.read_text())
        if rec.get("ok"):
            cells.append(rec)
    return cells


def _min_decode_bytes(rec: dict) -> float:
    """Per-device lower bound on decode-step HBM traffic: every live
    parameter byte + cache byte must stream once."""
    from ..configs import get_config
    from ..configs.base import SHAPE_BY_NAME
    cfg = get_config(rec["arch"])
    cell = SHAPE_BY_NAME[rec["shape"]]
    n_dev = 1
    for s in rec["mesh_shape"]:
        n_dev *= s
    param_bytes = cfg.active_param_count() * 2          # bf16
    if cfg.family in ("ssm", "hybrid"):
        cache = cfg.n_layers * cell.global_batch * cfg.d_model * 64 * 4
        if cfg.family == "hybrid":
            win = min(cfg.window or cell.seq_len, cell.seq_len)
            cache = (cfg.n_layers // 3) * cell.global_batch * \
                cfg.n_kv_heads * win * cfg.head_dim * 2 * 2
    else:
        cache = cfg.n_layers * cell.global_batch * cfg.n_kv_heads * \
            cell.seq_len * cfg.head_dim * 2 * 2
    return (param_bytes + cache) / n_dev


def roofline_terms(rec: dict) -> dict:
    cw = rec.get("cost_weighted") or {
        "flops": rec["cost"]["flops"], "bytes": rec["cost"]["bytes_accessed"]}
    flops = cw["flops"]
    bytes_acc = cw["bytes"]
    wire = rec["collectives"]["total_wire_bytes"]
    t_comp = flops / PEAK_FLOPS
    t_mem = bytes_acc / HBM_BW
    t_coll = wire / LINK_BW
    dominant = max((t_comp, "compute"), (t_mem, "memory"),
                   (t_coll, "collective"))[1]
    bound = max(t_comp, t_mem, t_coll, 1e-12)
    n_dev = 1
    for s in rec["mesh_shape"]:
        n_dev *= s
    model_flops_dev = rec["model_flops"] / n_dev
    if rec["shape"].startswith(("decode", "long")):
        useful_t = _min_decode_bytes(rec) / HBM_BW
    else:
        useful_t = model_flops_dev / PEAK_FLOPS
    ratios = {"useful_ratio": model_flops_dev / flops if flops else 0.0,
              "roofline_fraction": useful_t / bound}
    for name, r in ratios.items():
        if r > 1.0:
            warnings.warn(f"{rec['arch']} {rec['shape']} on "
                          f"{rec['mesh_shape']}: {name} {r:.4f} > 1")
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "t_compute_s": t_comp, "t_memory_s": t_mem,
        "t_collective_s": t_coll, "dominant": dominant, "bound_s": bound,
        "model_flops_per_dev": model_flops_dev,
        "hlo_flops_per_dev": flops, **ratios,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=str(RESULTS))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args(argv)
    cells = load_cells(args.mesh, Path(args.results))
    if not cells:
        print("roofline,0,no dry-run records found "
              "(run python -m repro_torch.launch.dryrun)")
        return
    print(f"# {CARD}")
    print("arch,shape,t_compute_ms,t_memory_ms,t_collective_ms,dominant,"
          "useful_ratio,roofline_fraction")
    rows = []
    for rec in cells:
        r = roofline_terms(rec)
        rows.append(r)
        print(f"{r['arch']},{r['shape']},{r['t_compute_s']*1e3:.2f},"
              f"{r['t_memory_s']*1e3:.2f},{r['t_collective_s']*1e3:.2f},"
              f"{r['dominant']},{r['useful_ratio']:.3f},"
              f"{r['roofline_fraction']:.3f}")
    out = Path(args.results).parent / "roofline.json"
    out.write_text(json.dumps(rows, indent=1))
    train_rows = [r for r in rows if r["shape"].startswith(
        ("train", "prefill"))]
    if train_rows:
        worst = min(train_rows, key=lambda r: r["roofline_fraction"])
        best = max(train_rows, key=lambda r: r["roofline_fraction"])
        print(f"roofline_worst_train_cell,{worst['arch']}|{worst['shape']},"
              f"fraction={worst['roofline_fraction']:.3f}")
        print(f"roofline_best_train_cell,{best['arch']}|{best['shape']},"
              f"fraction={best['roofline_fraction']:.3f}")
    coll = max(rows, key=lambda r: r["t_collective_s"] /
               max(r["bound_s"], 1e-12))
    print(f"roofline_most_collective,{coll['arch']}|{coll['shape']},"
          f"t_coll_ms={coll['t_collective_s']*1e3:.2f}")


if __name__ == "__main__":
    main()
