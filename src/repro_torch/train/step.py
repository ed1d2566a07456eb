"""Train, prefill and serve step builders (counterpart of
``repro.train.step``).

The port runs eagerly: the builders return the step functions
themselves. ``lower_train_step``, ``lower_prefill``, ``lower_serve_step``
and ``lower_cell`` are the reference's dry run: each traces its step on
the card's program (``repro_torch.device.tracing``: fake tensors on the
device, nothing allocated, so a machine without a card traces it too)
on a mesh of the shape given that names the traced device at every
position, with every operator recorded (``launch.cost_analysis``), and
returns a ``Lowered`` whose ``compile()`` gives the memory, cost and
collective analyses. ``input_specs`` are the cell's model inputs
(``TensorSpec``: shape and dtype).

The train step differentiates the family's loss (``registry.loss_fn``:
dense, MoE, hybrid, SSM or enc-dec) through the reference's attention
(``backend="plain"``; the flash kernel has no backward) with each layer
rematerialised where the reference's is (every layer, the hybrid's
supers but not its tail, both enc-dec stacks), as ``jax.value_and_grad``
of the reference's loss does. With ``microbatches > 1`` every batch
entry (``src_embeds`` too) is split along its leading axis and
the microbatches' gradients are summed in float32 buffers and divided,
as the reference's ``lax.scan`` does, so the update sees float32
gradients; with one it sees them in the parameters' dtype. The AdamW
update then runs one parameter at a time, in place (``AdamW.apply_``).

With ``mesh`` the step takes a ``distributed.spmd.ShardedModel`` (and
the optimizer state ``AdamW.init`` gives for it): storage is sharded
over every mesh axis, ``"model"`` included (ZeRO-3), and compute is data
parallel. As in the reference, the global batch splits into microbatches
first and each microbatch's rows then split over the data-parallel
ranks in order; each rank runs forward and backward on its rows with
the gathered weights, under ``distributed.ctx.rank_local`` (its rows
are one MoE routing group, the reference's groups under
``activation_sharding``), and its gradient is added into the
gradients' pieces (``spmd.reduce_into``, in the moments' layouts), rank
after rank and microbatch after microbatch, in float32. The sum is
divided by ranks x microbatches (and cast to the parameters' type with
one microbatch), as is the loss, the mean of the ranks' means. On a
mesh whose ``"model"`` axis is 1 that is the whole story, and on a
one-position mesh the step is the unsharded one, bit for bit.

With ``"model"`` > 1 every family computes each position's share, as
the reference's GSPMD step does
(``distributed.tp``): each data rank runs its model positions as one
stack (``ShardedModel.tp_module_on``: each position's model shard of a
leaf, gathered over the data axes only, or the whole leaf where the
compute layout needs it, ``registry.tp_weight_splits``) through the
family's ``registry.tp_loss_fn``, and each position's gradient is added
into the pieces (``spmd.reduce_into(..., splits)``), in the same fixed
order of microbatches and ranks. The step leaves what it computed
with in ``params.last_step`` (its splits, its ``tp.Group`` with the
activation collectives' bytes and layouts, its microbatches), which
``ShardedModel.traffic`` reads.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..configs.base import ShapeCell
from ..device import tracing
from ..distributed import ctx
from ..distributed import spmd
from ..distributed import tp
from ..distributed.sharding import (batch_specs, cache_specs,
                                    opt_state_specs, param_specs)
from ..launch import cost_analysis as ca
from ..launch.mesh import Mesh
from ..models.common import ModelConfig
from ..models.registry import (decode_fn, forward_fn, init_params, loss_fn,
                               make_decode_state, tp_decode_fn,
                               tp_decode_splits, tp_loss_fn, tp_prefill_fn,
                               tp_weight_splits)
from ..optim.adamw import AdamW, AdamWState

__all__ = ["default_microbatches", "make_train_fn", "split_rows",
           "make_prefill_fn", "make_serve_fn", "TensorSpec", "input_specs",
           "lower_train_step", "lower_prefill", "lower_serve_step",
           "lower_cell"]


class TensorSpec(NamedTuple):
    """A model input's shape and dtype (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """The shape and dtype of every model input of a shape cell: int32
    tokens (and labels, to train) ``(b, s)``, the enc-dec family's
    ``src_embeds`` ``(b, s, d)`` in the model's type (source frames at
    the target's length, as the reference keeps them); decode, one new
    token ``(b, 1)`` against a cache of length s."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "decode":
        return {"tokens": TensorSpec((b, 1), torch.int32)}
    out = {"tokens": TensorSpec((b, s), torch.int32)}
    if cell.kind == "train":
        out["labels"] = TensorSpec((b, s), torch.int32)
    if cfg.family == "encdec":
        out["src_embeds"] = TensorSpec((b, s, cfg.d_model), cfg.dtype)
    return out


def default_microbatches(cfg: ModelConfig, cell: ShapeCell) -> int:
    """Gradient-accumulation depth: keep ~<=4k tokens x d_model-scaled
    activations per device; larger models accumulate more."""
    p = cfg.param_count()
    if cell.kind != "train":
        return 1
    if p >= 3e10:
        return 8
    if p >= 8e9:
        return 4
    if p >= 2e9:
        return 2
    return 1


@contextlib.contextmanager
def _requiring_grad(params: list[torch.Tensor]):
    """The parameters require gradients inside (and grad mode is on);
    their flags are put back after."""
    flags = [p.requires_grad for p in params]
    try:
        for p in params:
            p.requires_grad_(True)
        with torch.enable_grad():
            yield
    finally:
        for p, flag in zip(params, flags):
            p.requires_grad_(flag)


def make_train_fn(cfg: ModelConfig, opt: AdamW, *, microbatches: int = 1,
                  mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``: one optimizer step on ``batch`` (``tokens``, ``labels``, and
    ``src_embeds`` for the enc-dec family). ``params`` (the ``LM`` or
    ``EncDec``, or with ``mesh`` a ``ShardedModel`` on it) and the
    state's moments are updated in place; the loss is a float32 0-d
    tensor on the parameters' device."""
    lfn = loss_fn(cfg, backend="plain")
    if mesh is not None:
        return _sharded_train_fn(cfg, lfn, opt, microbatches, mesh)

    def loss_and_grads(params, batch):
        names, plist = zip(*params.named_parameters())
        with _requiring_grad(list(plist)):
            if microbatches <= 1:
                loss = lfn(params, batch)
                grads = torch.autograd.grad(loss, plist)
                return loss.detach(), dict(zip(names, grads))
            gsum = [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in plist]
            lsum = torch.zeros((), dtype=torch.float32,
                               device=plist[0].device)
            split = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                  *v.shape[1:]) for k, v in batch.items()}
            for i in range(microbatches):
                loss = lfn(params, {k: v[i] for k, v in split.items()})
                for acc, g in zip(gsum, torch.autograd.grad(loss, plist)):
                    acc.add_(g)
                lsum = lsum + loss.detach()
            grads = {n: g.div_(microbatches) for n, g in zip(names, gsum)}
            return lsum / microbatches, grads

    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = loss_and_grads(params, batch)
        opt_state = opt.apply_(grads, opt_state, params)
        return params, opt_state, loss

    return train_step


def split_rows(rows: int, microbatches: int, ranks: int) -> int:
    """Rows a data-parallel rank takes of a microbatch of a ``rows``-row
    batch; raises ``ValueError`` where they do not split evenly."""
    if rows % microbatches:
        raise ValueError(f"{rows} rows do not split into {microbatches} "
                         "microbatches")
    per_mb = rows // microbatches
    if per_mb % ranks:
        raise ValueError(f"a microbatch's {per_mb} rows do not split over "
                         f"{ranks} data-parallel ranks")
    return per_mb // ranks


def _sharded_train_fn(cfg: ModelConfig, lfn, opt: AdamW, microbatches: int,
                      mesh):
    ranks = len(spmd.data_ranks(mesh))
    tp_lfn = tp_loss_fn(cfg) if mesh.shape.get("model", 1) > 1 else None

    def train_step(params: spmd.ShardedModel, opt_state: AdamWState,
                   batch):
        if params.mesh != mesh:
            raise ValueError(f"parameters on {params.mesh}, step on {mesh}")
        mb = max(microbatches, 1)
        rows = next(iter(batch.values())).shape[0]
        per = split_rows(rows, mb, ranks)
        group = splits = None
        if tp_lfn is not None:
            group = tp.Group(mesh, seq_parallel=ctx.seq_parallel_enabled())
            src = batch.get("src_embeds")
            splits = tp_weight_splits(
                cfg, params.layouts, group, per, batch["tokens"].shape[1],
                0 if src is None else src.shape[1])
        grads = {n: spmd.Sharded.zeros(lay, torch.float32)
                 for n, lay in params.moment_layouts.items()}
        lsum = torch.zeros((), dtype=torch.float32, device=params.home)
        for i in range(mb):
            for r, dev in enumerate(params.compute_devices()):
                module = params.module_on(dev) if group is None \
                    else params.tp_module_on(dev, splits)
                lo = i * per * ranks + r * per
                sub = {k: v[lo:lo + per].to(dev) for k, v in batch.items()}
                names, plist = zip(*module.named_parameters())
                with ctx.rank_local(), _requiring_grad(list(plist)):
                    loss = lfn(module, sub) if group is None \
                        else tp_lfn(module, sub, group)
                    g = torch.autograd.grad(loss, plist)
                spmd.reduce_into(grads, dict(zip(names, g)), splits)
                del g
                lsum = lsum + loss.detach().to(params.home)
        n = ranks * mb
        if n > 1:
            for sh in grads.values():
                sh.map_(lambda t: t.div_(n))
        if mb == 1:
            for name, sh in grads.items():
                sh.map_(lambda t, d=params.dtypes[name]: t.to(d))
        loss = lsum / n if n > 1 else lsum
        opt_state = opt.apply_shards_(grads, opt_state, params)
        params.last_step = {"splits": splits, "group": group,
                            "microbatches": mb}
        return params, opt_state, loss

    return train_step


def make_prefill_fn(cfg: ModelConfig, *, backend: str = "auto",
                    mesh=None):
    """(params, batch) -> last-position logits ``(b, vocab)`` of the full
    forward (the enc-dec family's batch also holds ``src_embeds``).
    ``backend`` picks the attention route (``models.attention``). The
    head runs over every position on every mesh, as the reference's
    does, and the last position is kept.

    With ``mesh`` the prefill takes a ``spmd.ShardedModel`` (the
    serving specs, ``sharding.param_specs(serving=True)``, as the
    reference lowers it): the batch's rows split over the data-parallel
    ranks in order, and each rank computes its rows under
    ``ctx.rank_local`` (one MoE routing group a rank). On a ``"model"``
    > 1 mesh a rank's model positions compute per model rank
    (``registry.tp_prefill_fn``: the train step's forward, the reference's
    attention route, sequence parallel as the reference's
    ``activation_sharding(mesh)`` default, the logits from the
    vocab-parallel head); else the forward of ``backend``. The
    ranks' logits are joined in order on the model's home device; what
    the step computed with is left in ``params.last_step``."""
    fwd = forward_fn(cfg, backend=backend)
    if mesh is not None:
        return _sharded_prefill_fn(cfg, fwd, mesh)

    def prefill(params, batch):
        return fwd(params, batch)[:, -1, :]

    return prefill


def _sharded_prefill_fn(cfg: ModelConfig, fwd, mesh):
    ranks = len(spmd.data_ranks(mesh))
    tp_fwd = tp_prefill_fn(cfg) if mesh.shape.get("model", 1) > 1 else None

    @torch.no_grad()
    def prefill(params: spmd.ShardedModel, batch):
        if params.mesh != mesh:
            raise ValueError(f"parameters on {params.mesh}, step on {mesh}")
        rows = next(iter(batch.values())).shape[0]
        per = split_rows(rows, 1, ranks)
        group = splits = None
        if tp_fwd is not None:
            group = tp.Group(mesh, seq_parallel=True)
            src = batch.get("src_embeds")
            splits = tp_weight_splits(
                cfg, params.layouts, group, per, batch["tokens"].shape[1],
                0 if src is None else src.shape[1])
        outs = []
        for r, dev in enumerate(params.compute_devices()):
            module = params.module_on(dev) if group is None \
                else params.tp_module_on(dev, splits)
            sub = {k: v[r * per:(r + 1) * per].to(dev)
                   for k, v in batch.items()}
            with ctx.rank_local():
                out = fwd(module, sub)[:, -1, :] if group is None \
                    else tp_fwd(module, sub, group)
            outs.append(out.to(params.home))
        params.last_step = {"splits": splits, "group": group,
                            "microbatches": 1}
        return torch.cat(outs)

    return prefill


def make_serve_fn(cfg: ModelConfig, *, mesh=None):
    """(params, tokens, caches, pos) -> (greedy next tokens ``(b, 1)``
    int32, caches); the caches are updated in place.

    With ``mesh`` the step takes a ``spmd.ShardedModel`` (the serving
    specs) and the caches as a ``spmd.ShardedCaches`` (by
    ``sharding.cache_specs``, on a mesh that names one device): the
    rows split over the data-parallel ranks in order, or, where the
    ranks do not divide the batch, the whole batch runs once (the
    reference replicates it: batch 1 at ``long_500k``). Each rank
    computes under ``ctx.rank_local`` against its views of the caches;
    on a ``"model"`` > 1 mesh per model rank (``registry.tp_decode_fn``,
    ``seq_parallel=False``, the weights split as
    ``registry.tp_decode_splits`` says), else with ``decode_fn``. What
    the step computed with is left in ``params.last_step``."""
    dfn = decode_fn(cfg)
    if mesh is not None:
        return _sharded_serve_fn(cfg, dfn, mesh)

    def serve_step(params, tokens, caches, pos):
        logits, caches = dfn(params, tokens, caches, pos)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], caches

    return serve_step


def _sharded_serve_fn(cfg: ModelConfig, dfn, mesh):
    ranks = len(spmd.data_ranks(mesh))
    tp_dec = tp_decode_fn(cfg) if mesh.shape.get("model", 1) > 1 else None

    @torch.no_grad()
    def serve_step(params: spmd.ShardedModel, tokens,
                   caches: spmd.ShardedCaches, pos):
        if params.mesh != mesh or caches.mesh != mesh:
            raise ValueError(f"parameters on {params.mesh}, caches on "
                             f"{caches.mesh}, step on {mesh}")
        rows = tokens.shape[0]
        n = ranks if rows % ranks == 0 else 1
        per = rows // n
        group = splits = None
        dims = caches.dims()
        if tp_dec is not None:
            group = tp.Group(mesh, seq_parallel=False)
            splits = tp_decode_splits(cfg, params.layouts, group, per, dims)
        outs = []
        for r, dev in enumerate(params.compute_devices()[:n]):
            module = params.module_on(dev) if group is None \
                else params.tp_module_on(dev, splits)
            sub = tokens[r * per:(r + 1) * per].to(dev)
            views = caches.rank_views(r)
            with ctx.rank_local():
                if group is None:
                    last = dfn(module, sub, views, pos)[0][:, -1, :]
                else:
                    last = tp_dec(module, sub, views, dims, pos, group)
            outs.append(torch.argmax(last, dim=-1).to(torch.int32)
                        .to(params.home))
        caches.commit()
        params.last_step = {"splits": splits, "group": group,
                            "microbatches": 1, "data_ranks": n}
        return torch.cat(outs)[:, None], caches

    return serve_step


# ------------------------------------------------------------------ lowering
def _traced_mesh(mesh, dev: torch.device) -> Mesh:
    """A mesh of ``mesh``'s axes and shape (a ``launch.mesh.Mesh`` or
    anything with ``axis_names`` and a ``shape`` dict) naming the traced
    device at every position."""
    shape = tuple(int(mesh.shape[a]) for a in mesh.axis_names)
    grid = np.empty(shape, dtype=object)
    for at in np.ndindex(shape):
        grid[at] = dev
    return Mesh(grid, mesh.axis_names)


def _block_bytes(layouts: dict, dtypes) -> int:
    """Per-device bytes of the leaves laid out by ``layouts`` (``dtypes``
    a dtype each, or one for all)."""
    return sum(math.prod(lay.block) * (dtypes[n] if isinstance(dtypes, dict)
                                       else dtypes).itemsize
               for n, lay in layouts.items())


def _fake_inputs(cfg: ModelConfig, cell: ShapeCell, dev) -> dict:
    return {k: torch.empty(sp.shape, dtype=sp.dtype, device=dev)
            for k, sp in input_specs(cfg, cell).items()}


def _batch_bytes(cfg: ModelConfig, cell: ShapeCell, mesh, kind: str) -> int:
    specs = batch_specs(cfg, mesh, kind)
    return sum(math.prod(spmd.Layout(sp.shape, specs[k], mesh).block)
               * sp.dtype.itemsize
               for k, sp in input_specs(cfg, cell).items())


def _collectives(model: spmd.ShardedModel, grads: bool) -> dict:
    rec = model.last_step or {}
    group = rec.get("group")
    parts = [ca.data_axis_collectives(
        model.layouts, model.dtypes,
        model.moment_layouts if grads else None, rec.get("splits"),
        rec.get("microbatches", 1))]
    if group is not None:
        parts.append(ca.model_axis_collectives(
            group, len(spmd.data_ranks(model.mesh))))
    return ca.merge_collectives(*parts)


def _run_traced(fn, n_devices: int) -> ca.Trace:
    trace = ca.Trace(n_devices)
    t0 = time.perf_counter()
    with ca.CostMode(trace):
        fn()
    trace.seconds = time.perf_counter() - t0
    return trace


def lower_train_step(cfg: ModelConfig, cell: ShapeCell, mesh,
                     opt: Optional[AdamW] = None, *,
                     microbatches: Optional[int] = None,
                     fsdp: Optional[bool] = None) -> ca.Lowered:
    """Trace one sharded train step (``make_train_fn(mesh=)``) of the
    cell on the card over ``mesh``'s shape, nothing allocated. As the
    reference: bf16 moments from 1e11 parameters, ``default_microbatches``
    unless given, parameters and moments donated, and ``fsdp`` read by
    nothing (its dry run ignores it too). The memory analysis's
    argument bytes are the parameters, moments, step and batch a
    position holds (``param_specs``, ``opt_state_specs``,
    ``batch_specs``); outputs the first three and the loss; alias the
    donated ones."""
    del fsdp                        # unread, as in the reference
    if opt is None:
        opt = AdamW(moment_dtype=torch.bfloat16
                    if cfg.param_count() >= 1e11 else torch.float32)
    if microbatches is None:
        microbatches = default_microbatches(cfg, cell)
    with tracing("cuda") as dev:
        tmesh = _traced_mesh(mesh, dev)
        params = init_params(cfg, device=dev, abstract=True)
        model = spmd.ShardedModel(params, tmesh, param_specs(params, tmesh),
                                  opt_state_specs(params, tmesh))
        opt_state = opt.init(model, abstract=True)
        batch = _fake_inputs(cfg, cell, dev)
        step = make_train_fn(cfg, opt, microbatches=microbatches,
                             mesh=tmesh)
        with ctx.activation_sharding(tmesh):
            trace = _run_traced(lambda: step(model, opt_state, batch),
                                tmesh.size)
        trace.collectives = _collectives(model, grads=True)
        p_b = _block_bytes(model.layouts, model.dtypes)
        m_b = _block_bytes(model.moment_layouts, opt.moment_dtype) * (
            2 + (opt.compress is not None))
        state_b = p_b + m_b + 4                     # the int32 step
        memory = {"argument": state_b + _batch_bytes(cfg, cell, tmesh,
                                                     "train"),
                  "output": state_b + 4,            # the float32 loss
                  "alias": state_b}
    return ca.Lowered(trace, memory, f"train {cfg.name} {cell.name} "
                      f"mesh {dict(tmesh.shape)} mb {microbatches}")


def lower_prefill(cfg: ModelConfig, cell: ShapeCell, mesh,
                  serving_params: bool = True) -> ca.Lowered:
    """Trace the sharded prefill (``make_prefill_fn(mesh=)``) of the cell
    on the card over ``mesh``'s shape under the serving specs (with
    ``serving_params``); a ``"model"`` = 1 mesh takes the card's
    attention route (the flash kernel). The output is the replicated
    ``(b, vocab)`` last logits."""
    with tracing("cuda") as dev:
        tmesh = _traced_mesh(mesh, dev)
        params = init_params(cfg, device=dev, abstract=True)
        specs = param_specs(params, tmesh, serving=serving_params)
        model = spmd.ShardedModel(params, tmesh, specs, specs)
        batch = _fake_inputs(cfg, cell, dev)
        step = make_prefill_fn(cfg, mesh=tmesh)
        with ctx.activation_sharding(tmesh):
            trace = _run_traced(lambda: step(model, batch), tmesh.size)
        trace.collectives = _collectives(model, grads=False)
        memory = {"argument": _block_bytes(model.layouts, model.dtypes)
                  + _batch_bytes(cfg, cell, tmesh, "prefill"),
                  "output": cell.global_batch * cfg.vocab
                  * cfg.dtype.itemsize,
                  "alias": 0}
    return ca.Lowered(trace, memory, f"prefill {cfg.name} {cell.name} "
                      f"mesh {dict(tmesh.shape)}")


def lower_serve_step(cfg: ModelConfig, cell: ShapeCell, mesh,
                     serving_params: bool = True) -> ca.Lowered:
    """Trace one sharded decode step (``make_serve_fn(mesh=)``): one
    token a row against caches of the cell's length (``s_src = min(s,
    4096)`` source positions for the enc-dec family) laid out by
    ``cache_specs``, at position ``s - 1``; the caches donated. Where the
    data ranks do not divide the batch (``long_500k``'s one row) the
    port computes it once where the reference computes it on every data
    rank, so its per-device FLOPs are the reference's over the data
    ranks there."""
    b, s = cell.global_batch, cell.seq_len
    with tracing("cuda") as dev:
        tmesh = _traced_mesh(mesh, dev)
        params = init_params(cfg, device=dev, abstract=True)
        specs = param_specs(params, tmesh, serving=serving_params)
        model = spmd.ShardedModel(params, tmesh, specs, specs)
        whole = make_decode_state(cfg, b, s, s_src=min(s, 4096), device=dev,
                                  abstract=True)
        caches = spmd.ShardedCaches(whole, cache_specs(cfg, whole, tmesh),
                                    tmesh)
        del whole
        tokens = torch.empty((b, 1), dtype=torch.int32, device=dev)
        pos = torch.full((), s - 1, dtype=torch.int32, device=dev)
        step = make_serve_fn(cfg, mesh=tmesh)
        with ctx.activation_sharding(tmesh, seq_parallel=False):
            trace = _run_traced(lambda: step(model, tokens, caches, pos),
                                tmesh.size)
        trace.collectives = _collectives(model, grads=False)
        cache_b = caches.nbytes_per_device()
        dp = len(spmd.data_ranks(tmesh))
        tok_b = (b // dp if b % dp == 0 else b) * 4
        memory = {"argument": _block_bytes(model.layouts, model.dtypes)
                  + tok_b + cache_b + 4,
                  "output": tok_b + cache_b,
                  "alias": cache_b}
    return ca.Lowered(trace, memory, f"decode {cfg.name} {cell.name} "
                      f"mesh {dict(tmesh.shape)}")


def lower_cell(cfg: ModelConfig, cell: ShapeCell, mesh,
               opt: Optional[AdamW] = None,
               microbatches: Optional[int] = None,
               serving_params: bool = True,
               fsdp: Optional[bool] = None) -> ca.Lowered:
    """Dispatch on the cell kind (the dry-run entry point)."""
    if cell.kind == "train":
        return lower_train_step(cfg, cell, mesh, opt,
                                microbatches=microbatches, fsdp=fsdp)
    if cell.kind == "prefill":
        return lower_prefill(cfg, cell, mesh, serving_params=serving_params)
    return lower_serve_step(cfg, cell, mesh, serving_params=serving_params)
