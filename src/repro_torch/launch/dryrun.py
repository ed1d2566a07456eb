"""Dry run of every (arch x shape x mesh) cell: the counterpart of
``repro.launch.dryrun``.

For each cell this traces the port's own program for the card
(``train.step.lower_cell``: fake tensors on the traced device, nothing
allocated, so it runs on a machine without a card too) on the
production mesh (``("data", "model")`` 16 x 16, or ``("pod", "data",
"model")`` 2 x 16 x 16) naming the traced device at every position, and
records to ``results/dryrun/<arch>__<shape>__<mesh>.json`` (the
reference's schema):

  * ``memory``: per-device argument / output / temp / alias bytes (and
    ``program_temp_bytes``, the one-process program's temporaries);
  * ``cost``: per-device FLOPs, bytes accessed, transcendentals;
  * ``collectives``: per-type counts and bytes per device (the
    reference's ring convention, ``launch.cost_analysis``);
  * ``cost_weighted``: ``program_costs`` (every loop iteration is
    already in the trace, so it equals ``cost``'s FLOPs and bytes);
  * ``model_flops``: 6 N D to train, 2 N D a forward (active N for MoE);
  * ``lower_s`` (the trace's seconds) and ``compile_s`` (its analysis).

A cell that fails is recorded ``ok: False`` with its error. Existing
result files are skipped (delete to re-run).

Usage:
    python -m repro_torch.launch.dryrun                    # full sweep
    python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape \\
        train_4k --mesh single
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path

from ..configs import ALL_ARCHS, SHAPE_BY_NAME, cells_for, get_config
from ..launch.cost_analysis import program_costs, summarize_collectives
from ..launch.mesh import make_production_mesh
from ..train.step import lower_cell

__all__ = ["model_flops_per_step", "production_mesh_shape", "run_cell",
           "main", "RESULTS_DIR"]

RESULTS_DIR = Path(os.environ.get("REPRO_RESULTS", "results/dryrun"))


def production_mesh_shape(mesh_kind: str):
    """The reference's production mesh, ``single`` or ``multi`` pod, over
    a pool that names the CPU at every position: ``lower_cell`` traces a
    mesh of its shape that names the traced card."""
    return make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                devices=["cpu"] * 512)


def model_flops_per_step(cfg, cell) -> float:
    """6·N_active·D for training; 2·N_active·D for inference forward;
    decode: 2·N_active per token · batch (+ attention cache reads are
    bytes, not flops)."""
    n = cfg.active_param_count()
    if cell.kind == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch  # one token per sequence


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path, *,
             cfg=None) -> dict:
    """Trace one cell and write its record (``cfg`` overrides the arch's
    config: a cut depth)."""
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_kind}.json"
    if out_path.exists():
        return json.loads(out_path.read_text())
    cfg = cfg or get_config(arch)
    cell = SHAPE_BY_NAME[shape_name]
    mesh = production_mesh_shape(mesh_kind)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "mesh_shape": [int(mesh.shape[a]) for a in mesh.axis_names],
           "axes": list(mesh.axis_names), "n_layers": cfg.n_layers}
    try:
        t0 = time.time()
        lowered = lower_cell(cfg, cell, mesh)
        rec["lower_s"] = round(time.time() - t0, 2)
        t0 = time.time()
        compiled = lowered.compile()
        ma = compiled.memory_analysis()
        rec["memory"] = {
            "argument_bytes": int(ma.argument_size_in_bytes),
            "output_bytes": int(ma.output_size_in_bytes),
            "temp_bytes": int(ma.temp_size_in_bytes),
            "alias_bytes": int(ma.alias_size_in_bytes),
            "program_temp_bytes": int(ma.program_temp_bytes),
        }
        ca = compiled.cost_analysis()
        rec["cost"] = {
            "flops": float(ca.get("flops", 0.0)),
            "bytes_accessed": float(ca.get("bytes accessed", 0.0)),
            "transcendentals": float(ca.get("transcendentals", 0.0)),
        }
        rec["collectives"] = summarize_collectives(compiled)
        rec["cost_weighted"] = program_costs(compiled)
        rec["model_flops"] = model_flops_per_step(cfg, cell)
        rec["flash_calls"] = compiled.trace.calls(
            "repro_torch.flash_attention")
        rec["compile_s"] = round(time.time() - t0, 2)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default all)")
    ap.add_argument("--shape", default=None, help="one shape (default all)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    archs = [args.arch] if args.arch else ALL_ARCHS
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_ok = n_fail = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([args.shape] if args.shape
                  else [c.name for c in cells_for(cfg)])
        for shape_name in shapes:
            for mesh_kind in meshes:
                t0 = time.time()
                rec = run_cell(arch, shape_name, mesh_kind, out_dir)
                status = "OK " if rec.get("ok") else "FAIL"
                n_ok += rec.get("ok", False)
                n_fail += not rec.get("ok", False)
                mem = rec.get("memory", {})
                tot = (mem.get("temp_bytes", 0) +
                       mem.get("argument_bytes", 0)) / 2**30
                print(f"[{status}] {arch:24s} {shape_name:12s} {mesh_kind:6s} "
                      f"{round(time.time()-t0,1):6}s mem {tot:6.1f} GB "
                      f"{rec.get('error','')[:90]}",
                      flush=True)
    print(f"dry-run sweep done: {n_ok} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
