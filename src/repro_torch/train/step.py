"""Train, prefill and serve step builders (counterpart of
``repro.train.step``).

The port runs eagerly on one device, so there is nothing to lower or
shard: the builders return the step functions themselves (the
reference's ``lower_*`` and ``input_specs`` wait for the dry-run slice,
ROADMAP.md).

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
"""

from __future__ import annotations

import contextlib

import torch

from ..configs.base import ShapeCell
from ..models.common import ModelConfig
from ..models.registry import decode_fn, forward_fn, loss_fn
from ..optim.adamw import AdamW, AdamWState

__all__ = ["default_microbatches", "make_train_fn", "make_prefill_fn",
           "make_serve_fn"]


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


def make_train_fn(cfg: ModelConfig, opt: AdamW, *, microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``: one optimizer step on ``batch`` (``tokens``, ``labels``, and
    ``src_embeds`` for the enc-dec family). ``params`` (the ``LM`` or
    ``EncDec``) and the state's moments are updated in place; the loss is
    a float32 0-d tensor on the parameters' device."""
    lfn = loss_fn(cfg, backend="plain")

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
