"""AdamW with global-norm clipping and an optional gradient-compression
hook (counterpart of ``repro.optim.adamw``).

Parameters are an ``nn.Module`` (the LM) or a nested dict of tensors; the
optimizer state and gradients are flat dicts keyed by the parameters'
dotted names (``named_leaves``), one tensor per parameter. The order of
one update is the reference's: compress, then clip, then the moments.
Two traps of the reference's arithmetic are kept on purpose:

* the clip scale is cast to each gradient's type before the multiply
  (a bf16 product for bf16 gradients);
* weight decay applies to leaves of rank >= 2 *in the reference's tree*,
  where the members of each stacked group (``models.convert.STACKED``:
  ``layers``, the hybrid's ``supers`` and ``tail``, the enc-dec model's
  ``enc_layers`` and ``dec_layers``) are stacked along a leading axis:
  the port's ``layers.<i>.ln1`` is ``(d,)`` but the reference's
  ``layers.ln1`` is ``(n_layers, d)``, so it is decayed, while
  ``final_norm`` is not (``reference_ndim``).

``update`` is the reference's functional step (it returns the updates
and a new state); ``apply_`` does the same arithmetic one parameter at a
time and in place, adding each update to its parameter as soon as it is
computed, so the largest parameter bounds the step's temporaries.

On a mesh (``distributed.spmd.ShardedModel``) ``init`` gives moments
sharded by the moment layouts (``distributed.sharding.opt_state_specs``)
and ``apply_shards_`` runs the same arithmetic one moment piece at a
time, against the matching slice of the gradient's piece (the gradients
arrive in the moments' layout) and of the parameter's piece that holds
it. The clip's global norm and the compression's absmax are over whole
leaves: ``apply_shards_`` gathers each gradient leaf whole on the
model's home device (one copy where that device holds every piece) and
sums its squares as ``apply_`` does (``leaf_sum_sq``), so the norm's
bits do not depend on how a mesh splits or stacks the leaf's pieces;
summed piece by piece they would, and a clip scale one unit apart
changes the update from the second step on, when ``m / sqrt(v)`` no
longer cancels it. So ``apply_shards_`` on any mesh gives ``apply_``'s
weights bit for bit from the same gradients (on the same kind of
device), and only the sharded step pays for the gather.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch import nn

from ..models.convert import STACKED

__all__ = ["AdamW", "AdamWState", "GradTransform", "apply_updates",
           "named_leaves", "reference_ndim"]


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 0-d
    m: dict
    v: dict
    ef: Optional[dict] = None   # error-feedback residual (compression)


def named_leaves(tree) -> dict[str, torch.Tensor]:
    """A module's parameters by name, or a nested dict's leaves by dotted
    path (keys in sorted order, as the reference flattens a dict), as a
    new flat dict."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key in sorted(node):
            if isinstance(node[key], dict):
                walk(node[key], f"{prefix}{key}.")
            else:
                out[f"{prefix}{key}"] = node[key]
    walk(tree, "")
    return out


def leaf_sum_sq(g: torch.Tensor) -> torch.Tensor:
    """A whole gradient leaf's float32 sum of squares: the clip norm's
    term, on the whole-leaf and the sharded path alike."""
    return torch.sum(torch.square(g.float()))


def reference_ndim(name: str, p: torch.Tensor) -> int:
    """``p``'s rank in the reference's tree: the port's parameters
    ``<group>.<i>.…`` of a stacked group (``layers``, ``supers``,
    ``tail``, ``enc_layers``, ``dec_layers``) are the reference's leaves
    stacked along a leading axis over the group's members."""
    parts = name.split(".")
    stacked = len(parts) > 2 and parts[0] in STACKED and parts[1].isdigit()
    return p.ndim + int(stacked)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    compress: Optional["GradTransform"] = None
    moment_dtype: Any = torch.float32

    def init(self, params) -> AdamWState:
        """Zero moments (and error feedback, with ``compress``) in
        ``moment_dtype`` beside each parameter (sharded by its moment
        layout for a ``ShardedModel``); step 0."""
        from ..distributed.spmd import Sharded, ShardedModel
        if isinstance(params, ShardedModel):
            def zeros():
                return {n: Sharded.zeros(lay, self.moment_dtype)
                        for n, lay in params.moment_layouts.items()}
            return AdamWState(
                step=torch.zeros((), dtype=torch.int32, device=params.home),
                m=zeros(), v=zeros(),
                ef=zeros() if self.compress is not None else None)
        leaves = named_leaves(params)

        def zeros():
            return {n: torch.zeros(p.shape, dtype=self.moment_dtype,
                                   device=p.device)
                    for n, p in leaves.items()}
        device = next(iter(leaves.values())).device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m=zeros(), v=zeros(),
            ef=zeros() if self.compress is not None else None)

    def _prepare(self, grads, state: AdamWState):
        """Compress, the clip scale, the step's lr and bias corrections."""
        grads = named_leaves(grads)
        step = state.step + 1
        ef = state.ef
        if self.compress is not None:
            grads, ef = self.compress.apply(grads, ef)
        scale = None
        if self.clip_norm is not None:
            gnorm = torch.sqrt(sum(leaf_sum_sq(g) for g in grads.values()))
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        lr = self.lr(step) if callable(self.lr) else self.lr
        b1c = 1.0 - torch.pow(self.b1, step.float())
        b2c = 1.0 - torch.pow(self.b2, step.float())
        return grads, step, ef, scale, lr, b1c, b2c

    def _leaf(self, name, g, m, v, p, scale, lr, b1c, b2c, *,
              inplace: bool, decay: Optional[bool] = None):
        """One parameter's update (in its dtype) and new moments. In
        place, float32 moments are overwritten; otherwise (and for other
        moment types, whose sums the reference promotes to float32) new
        tensors are made. ``decay`` (by default whether ``p`` is a
        matrix in the reference's tree) adds weight decay."""
        if scale is not None:
            g = g * scale.to(g.dtype)
        g32 = g.float()
        m = _moment(m, self.b1, g32 * (1 - self.b1), inplace)
        v = _moment(v, self.b2, (g32 * (1 - self.b2)).mul_(g32), inplace)
        del g, g32
        u = m / b1c
        u.div_((v / b2c).sqrt_().add_(self.eps))
        if decay is None:
            decay = reference_ndim(name, p) >= 2
        if decay:                                  # decay matrices only
            u.add_(p.to(torch.float32, copy=True).mul_(self.weight_decay))
        return u.mul_(-lr).to(p.dtype), m, v

    def update(self, grads, state: AdamWState, params
               ) -> tuple[dict, AdamWState]:
        """The reference's step: ``(updates, new_state)``; nothing given
        is modified."""
        grads, step, ef, scale, lr, b1c, b2c = self._prepare(grads, state)
        updates, m_new, v_new = {}, {}, {}
        for name, p in named_leaves(params).items():
            updates[name], m_new[name], v_new[name] = self._leaf(
                name, grads[name], state.m[name], state.v[name], p, scale,
                lr, b1c, b2c, inplace=False)
        return updates, AdamWState(step=step, m=m_new, v=v_new, ef=ef)

    @torch.no_grad()
    def apply_(self, grads, state: AdamWState, params) -> AdamWState:
        """``update`` then ``apply_updates``, one parameter at a time and
        in place: the parameters and ``state``'s moment dicts are
        overwritten. Returns the new state."""
        grads, step, ef, scale, lr, b1c, b2c = self._prepare(grads, state)
        for name, p in named_leaves(params).items():
            u, state.m[name], state.v[name] = self._leaf(
                name, grads[name], state.m[name], state.v[name], p,
                scale, lr, b1c, b2c, inplace=True)
            p.add_(u)
            del u
        return AdamWState(step=step, m=state.m, v=state.v, ef=ef)

    @torch.no_grad()
    def apply_shards_(self, grads: dict, state: AdamWState, params
                      ) -> AdamWState:
        """``apply_`` on a ``ShardedModel``: ``grads`` are ``Sharded``
        leaves in the moments' layouts. Each moment piece is updated on
        every device that holds it, and its update added to the matching
        slice of each of the parameter's pieces that holds it (computed
        once more, or copied, where a device holds the parameter's piece
        but not the moment's)."""
        grads = named_leaves(grads)     # sorted, as the clip sums them
        step = state.step + 1
        ef = state.ef
        if self.compress is not None:
            grads, ef = self.compress.apply_shards(grads, ef)
        scale = None
        if self.clip_norm is not None:
            gnorm = torch.sqrt(sum(leaf_sum_sq(g.gather(params.home))
                                   for g in grads.values()))
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        lr = self.lr(step) if callable(self.lr) else self.lr
        b1c = 1.0 - torch.pow(self.b1, step.float())
        b2c = 1.0 - torch.pow(self.b2, step.float())
        on: dict = {}

        def here(x, dev):               # a 0-d tensor on ``dev``
            if not isinstance(x, torch.Tensor):
                return x
            if (id(x), dev) not in on:
                on[(id(x), dev)] = x.to(dev)
            return on[(id(x), dev)]

        for name, psh in params.leaves.items():
            m_sh, v_sh, g_sh = state.m[name], state.v[name], grads[name]
            decay = reference_ndim(name, psh) >= 2
            if psh.layout.spec == m_sh.layout.spec:
                # the same pieces: every device's stacks at once
                for dev in m_sh.stacks:
                    u, m, v = self._leaf(
                        name, g_sh.stacks[dev], m_sh.stacks[dev],
                        v_sh.stacks[dev], psh.stacks[dev], here(scale, dev),
                        here(lr, dev), here(b1c, dev), here(b2c, dev),
                        inplace=True, decay=decay)
                    psh.stacks[dev].add_(u)
                    if m is not m_sh.stacks[dev]:
                        m_sh.stacks[dev], v_sh.stacks[dev] = m, v
                m_sh.map_(lambda t: t)         # views (and dtype) anew
                v_sh.map_(lambda t: t)
                continue
            new_m: dict = {}
            new_v: dict = {}
            for key in m_sh.layout.keys:
                pkey, sub = psh.layout.covering(m_sh.layout.region(key))
                u_first = None
                for dev in m_sh.layout.holders[key]:
                    p = psh.pieces[pkey][dev][sub]
                    u, new_m[(key, dev)], new_v[(key, dev)] = self._leaf(
                        name, g_sh.pieces[key][dev], m_sh.pieces[key][dev],
                        v_sh.pieces[key][dev], p, here(scale, dev),
                        here(lr, dev), here(b1c, dev), here(b2c, dev),
                        inplace=True, decay=decay)
                    p.add_(u)
                    u_first = u if u_first is None else u_first
                for dev, piece in psh.pieces[pkey].items():
                    if dev not in m_sh.pieces[key]:
                        piece[sub].add_(u_first.to(dev))
            for sh, new in ((m_sh, new_m), (v_sh, new_v)):
                if any(t is not sh.pieces[k][d] for (k, d), t in new.items()):
                    sh.set_stacks({dev: torch.stack([
                        new[(k, dev)] for k in sh.layout.on_device[dev]])
                        for dev in sh.stacks})
                    sh.dtype = torch.float32
        params.updated()
        return AdamWState(step=step, m=state.m, v=state.v, ef=ef)


def _moment(mom: torch.Tensor, beta: float, term: torch.Tensor,
            inplace: bool) -> torch.Tensor:
    """``beta * mom + term``: the product in ``mom``'s type, the sum in
    float32 (``term`` is float32), as the reference promotes them."""
    if inplace and mom.dtype == torch.float32:
        return mom.mul_(beta).add_(term)
    return (mom * beta).float().add_(term)


@torch.no_grad()
def apply_updates(params, updates: dict):
    """Parameters plus their updates (cast to each parameter's type). A
    module is updated in place and returned; a nested dict gives a new
    nested dict."""
    if isinstance(params, nn.Module):
        for name, p in params.named_parameters():
            p.add_(updates[name].to(p.dtype))
        return params

    def walk(node, prefix):
        return {k: walk(v, f"{prefix}{k}.") if isinstance(v, dict)
                else v + updates[f"{prefix}{k}"].to(v.dtype)
                for k, v in node.items()}
    return walk(params, "")


class GradTransform:
    """Interface for gradient compression (see ``grad_compress``)."""

    def apply(self, grads: dict, ef: dict
              ) -> tuple[dict, dict]:  # pragma: no cover - interface
        raise NotImplementedError

    def apply_shards(self, grads: dict, ef: dict) -> tuple[dict, dict]:
        """``apply`` on ``Sharded`` leaves (``distributed.spmd``); by
        default ``apply`` itself, for transforms that only pass leaves
        on."""
        return self.apply(grads, ef)
