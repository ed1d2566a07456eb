"""Training launcher: real steps on a mesh, a restartable loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --smoke --device cpu --steps 50 --batch 8 --seq 128 \\
        --ckpt-dir /tmp/ckpt

Counterpart of ``repro.launch.train``, with ``--device`` (the card by
default). It keeps the reference's loop, flags and log lines:
deterministic data from (seed, step), the cosine schedule with a 10-step
warmup, atomic checkpoints every ``--ckpt-every`` steps and at the end,
automatic resume from the latest one, straggler flagging. Weights are
random, drawn from ``--seed`` (the port's generator, so not the
reference's values). Every family trains: dense, MoE, hybrid, SSM and
enc-dec (whose batches add ``src_embeds``, 256 source frames at
``--seq`` 1024).

``--mesh host`` is ``launch.mesh.make_host_mesh(--model-parallel)``
over the device pool, ``production`` and ``production-multipod`` the
reference's 16 x 16 and 2 x 16 x 16 meshes, which raise on a pool too
small for them. The pool is ``train(mesh_devices=...)`` when given
(entries may repeat: ``["cpu"] * 4``, or the one card 256 times), else
the named ``--device`` alone, else every visible card. The loop runs
under ``distributed.ctx.activation_sharding(mesh)``; a mesh of more
than one position trains a ``distributed.spmd.ShardedModel`` through
``make_train_fn(mesh=)`` (parameters by ``param_specs``, moments by
``opt_state_specs``), a one-position mesh the unsharded model, which is
the same step bit for bit. With ``--model-parallel`` > 1 (or the
production meshes' 16) every family computes tensor- (and, the MoE,
expert-) parallel on ``"model"`` (``distributed.tp``; the hybrid's
RG-LRU and the SSM's RWKV mixes on the ranks' channels and heads). The
log names the compute a run took and, at the end, the last step's bytes
on distinct devices by type (``ShardedModel.traffic``).

A checkpoint holds ``(params, opt_state)`` in the reference's tree and
keys (``checkpoint_tree``, which gathers the shards): each stacked
group's leaves (``layers``, ``supers`` and ``tail``, ``enc_layers`` and
``dec_layers``) stacked, a hybrid's empty ``tail`` as ``{}``, the
optimizer state an ``AdamWState``, so either package resumes the
other's float32 checkpoint of the same config, on any mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..configs import get_config
from ..data.synthetic import make_pipeline
from ..device import resolve_device
from ..distributed.ctx import activation_sharding
from ..distributed.sharding import opt_state_specs, param_specs
from ..distributed.spmd import Sharded, ShardedModel
from ..models.common import ModelConfig
from ..models.convert import port_leaf, reference_tree
from ..models.registry import init_params, tp_compute
from ..optim import AdamW, AdamWState, cosine_with_warmup
from ..runtime.checkpoint import (latest_step, restore_checkpoint,
                                  save_checkpoint)
from ..runtime.health import StepTimer, StragglerDetector
from ..train.step import make_train_fn
from .mesh import default_devices, make_host_mesh, make_production_mesh

__all__ = ["TrainRun", "train", "make_mesh", "checkpoint_tree",
           "load_checkpoint_tree", "main"]

MESHES = ("host", "production", "production-multipod")
WARMUP_STEPS = 10


@dataclasses.dataclass
class TrainRun:
    params: object              # the LM or EncDec (a ShardedModel of it on
                                # a mesh), trained in place
    opt_state: AdamWState
    start: int                  # first step run here (after a resume)
    losses: dict                # step -> loss of the steps run here
    times: np.ndarray           # their seconds, host clock after a sync


def checkpoint_tree(params, opt_state: AdamWState) -> tuple:
    """``(params, opt_state)`` in the reference's tree: nested dicts with
    the stacked groups' leaves stacked (copies, on the parameters'
    device)."""
    home = opt_state.step.device

    def tree(named):
        if named is None:
            return None
        return reference_tree({n: t.gather(home) if isinstance(t, Sharded)
                               else t for n, t in named.items()},
                              torch.stack)
    return (tree({n: p.detach() for n, p in params.named_parameters()}),
            AdamWState(step=opt_state.step, m=tree(opt_state.m),
                       v=tree(opt_state.v), ef=tree(opt_state.ef)))


@torch.no_grad()
def load_checkpoint_tree(tree: tuple, params) -> AdamWState:
    """Copy a restored ``checkpoint_tree`` into ``params`` in place (a
    ``ShardedModel``'s shards) and return its optimizer state, keyed by
    the port's names (sharded by the moment layouts on a mesh)."""
    ptree, state = tree
    names = [n for n, _ in params.named_parameters()]
    if isinstance(params, ShardedModel):
        params.load_({n: port_leaf(ptree, n) for n in names})

        def unstack(t):
            return None if t is None else {
                n: Sharded.place(port_leaf(t, n), params.moment_layouts[n])
                for n in names}
    else:
        for name, p in params.named_parameters():
            p.copy_(port_leaf(ptree, name))

        def unstack(t):
            return None if t is None else {n: port_leaf(t, n).clone()
                                           for n in names}
    return AdamWState(step=state.step, m=unstack(state.m),
                      v=unstack(state.v), ef=unstack(state.ef))


def make_mesh(mesh: str = "host", model_parallel: int = 1, devices=None):
    """``--mesh``'s mesh over the pool ``devices`` (every visible card
    when None)."""
    if mesh == "host":
        return make_host_mesh(model_parallel, devices=devices)
    if mesh not in MESHES:
        raise ValueError(f"--mesh {mesh}: one of {MESHES}")
    return make_production_mesh(multi_pod=mesh == "production-multipod",
                                devices=devices)


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          lr: float = 3e-3, microbatches: int = 1, seed: int = 0,
          ckpt_dir=None, ckpt_every: int = 20, mesh: str = "host",
          model_parallel: int = 1, mesh_devices=None, device=None,
          params=None, log: Callable[[str], None] = print) -> TrainRun:
    """The reference's training loop on ``mesh`` (``make_mesh`` over
    ``mesh_devices``, else over ``device`` alone when named, else over
    every card), its data and unsharded model on ``device`` (the mesh's
    first device when None). ``params`` is the model to train in place
    (random weights from ``seed`` when None). With ``ckpt_dir`` it
    resumes from the latest checkpoint there and writes one every
    ``ckpt_every`` steps and at the end."""
    pool = mesh_devices
    if pool is None:
        named = device is not None
        device = resolve_device(device, what="repro_torch.launch.train")
        pool = [device] if named else default_devices()
    grid = make_mesh(mesh, model_parallel, pool)
    device = resolve_device(grid.devices.flat[0] if device is None
                            else device, what="repro_torch.launch.train")
    sharded = grid.size > 1
    opt = AdamW(lr=cosine_with_warmup(lr, WARMUP_STEPS, steps))
    train_fn = make_train_fn(cfg, opt, microbatches=microbatches,
                             mesh=grid if sharded else None)
    pipe = make_pipeline(cfg, seq, batch, seed=seed, device=device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_params(cfg, generator=gen, device=device)
    if sharded:
        params = ShardedModel(params, grid, param_specs(params, grid),
                              opt_state_specs(params, grid))
        log(f"mesh {grid.shape}: {cfg.name} ({cfg.family}) computes "
            f"{tp_compute(cfg, grid)}")
    opt_state = opt.init(params)

    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        tree, extra = restore_checkpoint(
            ckpt_dir, checkpoint_tree(params, opt_state))
        opt_state = load_checkpoint_tree(tree, params)
        start = int(extra["step"]) + 1
        log(f"resumed from step {start - 1}")

    timer = StepTimer()
    detector = StragglerDetector()
    losses = {}
    for step in range(start, steps):
        b = pipe.batch(step)
        t0 = time.perf_counter()
        with activation_sharding(grid):
            params, opt_state, loss = train_fn(params, opt_state, b)
        loss = float(loss)                  # waits for the device
        dt = time.perf_counter() - t0
        losses[step] = loss
        timer.record(dt)
        flag = " STRAGGLER" if detector.is_straggler(timer.times, dt) \
            else ""
        if step % 10 == 0 or step == steps - 1:
            log(f"step {step:5d} loss {loss:.4f} {dt*1e3:8.1f} ms{flag}")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step, checkpoint_tree(params, opt_state),
                            extra={"step": step, "seed": seed})
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps - 1,
                        checkpoint_tree(params, opt_state),
                        extra={"step": steps - 1, "seed": seed})
    if sharded and params.last_step is not None:
        log("traffic a step on distinct devices (bytes): " + ", ".join(
            f"{k} {v}" for k, v in params.traffic().items()))
    times = timer.times
    if times.size:
        log(f"mean step {np.mean(times)*1e3:.1f} ms  "
            f"p50 {np.percentile(times,50)*1e3:.1f}  "
            f"p95 {np.percentile(times,95)*1e3:.1f}")
    return TrainRun(params=params, opt_state=opt_state, start=start,
                    losses=losses, times=times)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default="host", choices=MESHES)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
          lr=args.lr, microbatches=args.microbatches, seed=args.seed,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
          mesh=args.mesh, model_parallel=args.model_parallel,
          device=args.device)


if __name__ == "__main__":
    main()
