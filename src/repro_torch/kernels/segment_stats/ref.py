"""Plain PyTorch version of the per-segment statistics kernel."""

from __future__ import annotations

import torch


def segment_stats_ref(x: torch.Tensor, labels: torch.Tensor,
                      num_segments: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-segment (sum, sum of squares, count) of rows of ``x``, batched.

    ``x``: ``(..., n, d)`` (or ``(..., n)``, read as ``d = 1``);
    ``labels``: ``(..., n)`` integer segment ids. A label of -1, or one
    outside ``[0, num_segments)``, adds nothing, and its row is zeroed
    first so that a NaN there cannot spread. Returns float32 sums
    ``(..., k, d)``, sumsq ``(..., k, d)`` and counts ``(..., k)``. Rows
    are added in index order, one float32 rounding per add.
    """
    x = x.float()
    if x.shape == labels.shape:
        x = x[..., None]
    if x.shape[:-1] != labels.shape:
        raise ValueError(f"labels shape {tuple(labels.shape)} does not match "
                         f"x shape {tuple(x.shape)} (need x = labels shape "
                         "+ (d,))")
    k = int(num_segments)
    batch_shape = labels.shape[:-1]
    n, d = x.shape[-2], x.shape[-1]
    b = 1
    for s in batch_shape:
        b *= s
    lb = labels.reshape(b, n).long()
    valid = (lb >= 0) & (lb < k)
    flat = (torch.where(valid, lb, 0)
            + k * torch.arange(b, device=x.device)[:, None]).reshape(-1)
    w = torch.where(valid[..., None], x.reshape(b, n, d),
                    torch.zeros((), device=x.device)).reshape(b * n, d)
    # every output adds its rows in index order, one float32 rounding per
    # add: on the CPU index_add_ is a serial loop; on CUDA index_add_ would
    # add with atomics in a varying order, while index_put_ with accumulate
    # sorts the rows stably by index and then adds them in that order. That
    # is how torch 2.11 implements it, not a documented promise: the card
    # test test_segment_plain_cuda_bitwise_equals_plain_cpu pins it
    zeros = torch.zeros((b * k, d), dtype=torch.float32, device=x.device)
    ones = valid.reshape(-1).float()
    if x.is_cuda:
        # (rows of one value take a warp-reduction path instead: widen
        # them with a zero column, dropped again below)
        def add(out, vals):
            if vals.dim() == 1 or vals.shape[1] == 1:
                wide = torch.stack([vals.reshape(-1),
                                    torch.zeros_like(vals.reshape(-1))], 1)
                acc = torch.zeros((out.shape[0], 2), dtype=out.dtype,
                                  device=out.device)
                acc.index_put_((flat,), wide, accumulate=True)
                return acc[:, :1].reshape(out.shape).contiguous()
            return out.index_put_((flat,), vals, accumulate=True)
    else:
        def add(out, vals):
            return out.index_add_(0, flat, vals)
    sums = add(zeros.clone(), w)
    sumsq = add(zeros.clone(), w * w)
    counts = add(torch.zeros(b * k, dtype=torch.float32, device=x.device),
                 ones)
    return (sums.reshape(*batch_shape, k, d),
            sumsq.reshape(*batch_shape, k, d),
            counts.reshape(*batch_shape, k))
