"""Train, prefill and serve step builders (counterpart of
``repro.train.step``).

The port runs eagerly, so there is nothing to lower: the builders
return the step functions themselves (the reference's ``lower_*`` and
``input_specs`` wait for the cost-model slice, ROADMAP.md).

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

import torch

from ..configs.base import ShapeCell
from ..distributed import ctx
from ..distributed import spmd
from ..distributed import tp
from ..models.common import ModelConfig
from ..models.registry import (decode_fn, forward_fn, loss_fn, tp_loss_fn,
                               tp_weight_splits)
from ..optim.adamw import AdamW, AdamWState

__all__ = ["default_microbatches", "make_train_fn", "split_rows",
           "make_prefill_fn", "make_serve_fn"]


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


def make_prefill_fn(cfg: ModelConfig, *, backend: str = "auto"):
    """(params, batch) -> last-position logits ``(b, vocab)`` of the full
    forward (the enc-dec family's batch also holds ``src_embeds``).
    ``backend`` picks the attention route (``models.attention``)."""
    fwd = forward_fn(cfg, backend=backend)

    def prefill(params, batch):
        return fwd(params, batch)[:, -1, :]

    return prefill


def make_serve_fn(cfg: ModelConfig):
    """(params, tokens, caches, pos) -> (greedy next tokens ``(b, 1)``
    int32, caches); the caches are updated in place."""
    dfn = decode_fn(cfg)

    def serve_step(params, tokens, caches, pos):
        logits, caches = dfn(params, tokens, caches, pos)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], caches

    return serve_step
