"""Parameters and optimizer state sharded over a device mesh, driven
from one process: the port's counterpart of what GSPMD does for the
reference's sharded train step.

A leaf's ``Layout`` (its shape, a ``PartitionSpec`` and a ``Mesh``) cuts
it into pieces: a dimension whose spec names axes splits into as many
equal blocks as their sizes' product, the first name major, as in JAX.
A piece is named by its block index along each dimension (its ``key``);
every mesh position holds the piece its coordinates pick, so positions
that differ only on axes the spec does not name hold replicas. A
``Sharded`` leaf stores each piece once per distinct device that holds
it, a device's pieces side by side in one stack: a mesh that names one
device many times (``make_host_mesh(devices=["cpu"] * 4)``, or the one
card 256 times) stores each piece once, so the shards of a leaf take
what the leaf takes, however many positions the mesh has, and that
device moves, sums and updates them with one operation a leaf.

``ShardedModel`` keeps a model's parameters so and computes with a
gathered module per device: data-parallel ranks that sit on one device
share one gathered copy, so on one card a step holds the shards plus one
copy of the weights, not one a rank. ``reduce_into`` adds a rank's full
gradient into the gradient's pieces; called rank after rank it sums them
in that fixed order, with no atomics, so two runs give the same bits.
``leaf_abs_max`` reduces a leaf's pieces (each piece once) to the whole
leaf's absmax; the clip norm sums a gathered whole leaf
(``optim.adamw``).

With ``"model"`` > 1 every family's step computes each position's
share (``distributed.tp``): ``tp_module_on`` gathers, for a
data rank, its model positions' weights as one stack a leaf, each
position's model shard gathered over the data axes only
(``Sharded.gather_ranks``: ``(R, ...)``, row ``r`` the shard of model
rank ``r``, on any dimension: the RG-LRU's ``lam`` ``(R, w / R)`` and
``conv_k`` ``(R, 4, w / R)`` too), and the whole leaf only where the
compute needs it whole
(a replicated weight, or the query-row fallback's attention weights);
``reduce_into(..., splits)`` adds each position's gradient into the
pieces. The positions of a data rank compute on the device of its first
position; a piece held on another device is copied there.

``ShardedCaches`` keeps a decode step's caches as ``Sharded`` leaves by
``sharding.cache_specs`` (the batch over the data axes, on ``"model"`` a
KV cache's heads, else its head width, and a recurrent state's longest
dimension past the batch), on a mesh whose positions all name one
device: each data rank's decode reads and writes its pieces in place,
as views ``(R, ...)`` of its model positions' pieces (``rank_views``).

``traffic(...)`` counts the bytes a step would move between distinct
devices. With data-parallel compute: what each data-parallel rank
gathers (the pieces its group of mesh positions does not hold) and what
it sends in the reduce-scatter (its gradient less the pieces its group
keeps). With tensor-parallel compute: what each position gathers of the
region it computes with (its model shard, or the whole leaf) and sends
of its gradient of that region, less what it holds; and the activation
collectives on ``"model"`` by type (counted as they run,
``tp.Group.traffic``). On one card nothing crosses a link; the numbers
are those of the same mesh on distinct cards.
"""

from __future__ import annotations

import copy
import math
from typing import Iterator, Optional

import numpy as np
import torch

from ..launch.mesh import data_axes
from .ctx import PartitionSpec
from .tp import COLLECTIVES

__all__ = ["Layout", "Sharded", "ShardedModel", "ShardedCaches",
           "reduce_into", "leaf_abs_max", "data_ranks", "traffic"]


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class Layout:
    """Where the pieces of a leaf of ``shape`` lie on ``mesh`` under
    ``spec``."""

    def __init__(self, shape, spec, mesh):
        self.shape = tuple(int(n) for n in shape)
        spec = tuple(spec)
        if len(spec) > len(self.shape):
            raise ValueError(f"spec {spec} for a {len(self.shape)}-D leaf")
        self.spec = PartitionSpec(*spec, *(None,) * (len(self.shape)
                                                     - len(spec)))
        self.mesh = mesh
        counts = []
        for dim, entry in zip(self.shape, self.spec):
            n = math.prod(mesh.shape[a] for a in _names(entry))
            if dim % n:
                raise ValueError(f"{entry} ({n}) does not divide {dim} "
                                 f"of {self.shape}")
            counts.append(n)
        self.counts = tuple(counts)
        self.block = tuple(d // n for d, n in zip(self.shape, counts))
        axis = {a: i for i, a in enumerate(mesh.axis_names)}
        self.key_at: dict[tuple, tuple] = {}       # mesh coordinate -> key
        self.holders: dict[tuple, list] = {}       # key -> distinct devices
        for coord in np.ndindex(mesh.devices.shape):
            key = []
            for entry in self.spec:
                idx = 0
                for a in _names(entry):
                    idx = idx * mesh.shape[a] + coord[axis[a]]
                key.append(idx)
            key = tuple(key)
            self.key_at[coord] = key
            devs = self.holders.setdefault(key, [])
            dev = mesh.devices[coord]
            if dev not in devs:
                devs.append(dev)
        self.keys = sorted(self.holders)
        self.on_device: dict = {}                  # device -> its keys
        for key in self.keys:
            for dev in self.holders[key]:
                self.on_device.setdefault(dev, []).append(key)
        self._regions = {key: tuple(slice(k * b, (k + 1) * b)
                                    for k, b in zip(key, self.block))
                         for key in self.keys}

    def region(self, key) -> tuple[slice, ...]:
        """The slices of the whole leaf that piece ``key`` holds."""
        return self._regions[key]

    def blocks(self, t: torch.Tensor) -> torch.Tensor:
        """A whole leaf ``t`` (contiguous) viewed as ``(*counts,
        *block)``: ``[k]`` is piece ``k``."""
        split = [n for c, b in zip(self.counts, self.block) for n in (c, b)]
        nd = len(self.shape)
        return t.view(split).permute(*range(0, 2 * nd, 2),
                                     *range(1, 2 * nd, 2))

    def ranked_blocks(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """A leaf cut along ``dim`` into its ``counts[dim]`` blocks and
        stacked, ``t`` ``(counts[dim], ...)``, viewed as ``(*counts,
        *block)``: ``[k]`` is piece ``k``."""
        split = [n for c, b in zip(self.counts, self.block) for n in (c, b)]
        nd = len(self.shape)
        return t.movedim(0, dim).view(split).permute(
            *range(0, 2 * nd, 2), *range(1, 2 * nd, 2))

    def ranked_region(self, key, dim: int) -> tuple[slice, ...]:
        """The slices of its rank's block (``ranked_blocks``) that piece
        ``key`` holds."""
        region = list(self._regions[key])
        region[dim] = slice(None)
        return tuple(region)

    def covering(self, region) -> tuple[tuple, tuple[slice, ...]]:
        """The key whose piece holds ``region`` (a region of a layout
        this one's refines) and the region within that piece."""
        key = tuple(r.start // b for r, b in zip(region, self.block))
        return key, tuple(slice(r.start - k * b, r.stop - k * b)
                          for r, k, b in zip(region, key, self.block))

    def held_share(self, coords) -> float:
        """The share of the leaf's pieces that the positions ``coords``
        hold between them."""
        return len({self.key_at[c] for c in coords}) / len(self.keys)


class Sharded:
    """A leaf stored as pieces. Each device that holds pieces of the leaf
    keeps them in ``stacks[device]`` ``(n, *block)``, in key order, and
    ``pieces[key][device]`` is piece ``key``'s row there (a contiguous
    view). A device that holds every piece (each one on a mesh that
    names one device many times) moves, sums and updates the leaf's
    pieces with one operation each, the same arithmetic as one piece at
    a time."""

    def __init__(self, layout: Layout, dtype: torch.dtype, stacks: dict):
        self.layout, self.dtype = layout, dtype
        self.set_stacks(stacks)

    def set_stacks(self, stacks: dict) -> None:
        self.stacks = stacks
        self.pieces = {key: {} for key in self.layout.keys}
        for dev, st in stacks.items():
            for key, piece in zip(self.layout.on_device[dev], st.unbind(0)):
                self.pieces[key][dev] = piece

    @property
    def ndim(self) -> int:
        return len(self.layout.shape)

    def grid(self, dev) -> Optional[torch.Tensor]:
        """``stacks[dev]`` as ``(*counts, *block)`` when ``dev`` holds
        every piece, else None."""
        lay = self.layout
        if len(lay.on_device[dev]) != len(lay.keys):
            return None
        return self.stacks[dev].view(*lay.counts, *lay.block)

    @classmethod
    def place(cls, full: torch.Tensor, layout: Layout,
              dtype: Optional[torch.dtype] = None) -> "Sharded":
        """``full``'s pieces copied to the devices that hold them."""
        dtype = dtype or full.dtype
        stacks = {}
        for dev, keys in layout.on_device.items():
            st = torch.empty((len(keys), *layout.block), dtype=dtype,
                             device=dev)
            if len(keys) == len(layout.keys):
                st.view(*layout.counts, *layout.block).copy_(
                    layout.blocks(full))
            else:
                for i, key in enumerate(keys):
                    st[i].copy_(full[layout.region(key)])
            stacks[dev] = st
        return cls(layout, dtype, stacks)

    @classmethod
    def zeros(cls, layout: Layout, dtype: torch.dtype) -> "Sharded":
        return cls(layout, dtype, {
            dev: torch.zeros((len(keys), *layout.block), dtype=dtype,
                             device=dev)
            for dev, keys in layout.on_device.items()})

    def items(self) -> Iterator[tuple[tuple, torch.device, torch.Tensor]]:
        for key in self.layout.keys:
            for dev, t in self.pieces[key].items():
                yield key, dev, t

    def first(self, key) -> torch.Tensor:
        return next(iter(self.pieces[key].values()))

    def gather(self, device, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """The whole leaf on ``device`` (into ``out``, contiguous, when
        given), each piece read from ``device`` where it is there."""
        device = torch.device(device)
        if out is None:
            out = torch.empty(self.layout.shape, dtype=self.dtype,
                              device=device)
        grid = self.grid(device) if device in self.stacks else None
        if grid is not None:
            self.layout.blocks(out).copy_(grid)
            return out
        for key in self.layout.keys:
            src = self.pieces[key].get(device, None)
            if src is None:
                src = self.first(key)
            out[self.layout.region(key)].copy_(src)
        return out

    def gather_ranks(self, device, dim: int,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The leaf's model shards on ``device``: the leaf cut along
        ``dim`` into its ``counts[dim]`` blocks, stacked ``(counts[dim],
        ..., shape[dim] / counts[dim], ...)`` (into ``out`` when given),
        each piece read from ``device`` where it is there."""
        device = torch.device(device)
        lay = self.layout
        if out is None:
            shape = list(lay.shape)
            shape[dim] = lay.block[dim]
            out = torch.empty((lay.counts[dim], *shape), dtype=self.dtype,
                              device=device)
        grid = self.grid(device) if device in self.stacks else None
        if grid is not None:
            lay.ranked_blocks(out, dim).copy_(grid)
            return out
        for key in lay.keys:
            src = self.pieces[key].get(device, None)
            if src is None:
                src = self.first(key)
            out[key[dim]][lay.ranked_region(key, dim)].copy_(src)
        return out

    @torch.no_grad()
    def load_(self, full: torch.Tensor) -> None:
        """Overwrite every piece with its part of the whole leaf
        ``full``."""
        for dev, st in self.stacks.items():
            grid = self.grid(dev)
            if grid is not None:
                grid.copy_(self.layout.blocks(full.contiguous()))
                continue
            for i, key in enumerate(self.layout.on_device[dev]):
                st[i].copy_(full[self.layout.region(key)])

    def map_(self, fn) -> "Sharded":
        """Every device's stack replaced by ``fn(stack)`` (the same
        operation on each piece); returns self."""
        self.set_stacks({dev: fn(st) for dev, st in self.stacks.items()})
        self.dtype = next(iter(self.stacks.values())).dtype
        return self


def reduce_into(bufs: dict, grads: dict,
                splits: Optional[dict] = None) -> None:
    """Add each gradient of ``grads`` (on any device) into the pieces of
    its leaf in ``bufs``: one rank's share of a reduce-scatter. A leaf
    whose ``splits`` entry names a dimension comes as its model shards'
    gradients, stacked as ``Sharded.gather_ranks`` stacks the shards;
    the others whole. Called rank after rank it sums the ranks in that
    order."""
    dst, src = [], []
    for name, g in grads.items():
        sh = bufs[name]
        lay = sh.layout
        dim = (splits or {}).get(name)
        for dev in sh.stacks:
            grid = sh.grid(dev)
            if grid is not None:
                dst.append(grid)
                src.append((lay.blocks(g.contiguous()) if dim is None
                            else lay.ranked_blocks(g, dim)).to(dev))
                continue
            for key in lay.on_device[dev]:
                dst.append(sh.pieces[key][dev])
                src.append((g[lay.region(key)] if dim is None else
                            g[key[dim]][lay.ranked_region(key, dim)]
                            ).to(dev))
    torch._foreach_add_(dst, src)


def _one_replica(sh: Sharded) -> list[torch.Tensor]:
    """Every piece once: a whole stack where one device holds them all."""
    for dev in sh.stacks:
        if sh.grid(dev) is not None:
            st = sh.stacks[dev]
            return [st[0]] if st.shape[0] == 1 else [st]
    return [sh.first(key) for key in sh.layout.keys]


def leaf_abs_max(sh: Sharded) -> torch.Tensor:
    """The largest |x| over the leaf's pieces (exact, in any order)."""
    out = None
    for t in _one_replica(sh):
        m = t.abs().max()
        out = m if out is None else torch.maximum(out, m.to(out.device))
    return out


def data_ranks(mesh) -> list[list[tuple]]:
    """The data-parallel ranks of ``mesh`` in order (row-major over its
    ``"pod"`` and ``"data"`` axes), each as the mesh coordinates of its
    group (the positions that differ only on the other axes)."""
    dp = set(data_axes(mesh))
    idx = [i for i, a in enumerate(mesh.axis_names) if a in dp]
    groups: dict[tuple, list] = {}
    for coord in np.ndindex(mesh.devices.shape):
        groups.setdefault(tuple(coord[i] for i in idx), []).append(coord)
    return [groups[k] for k in sorted(groups)]


def _overlap(a: tuple[slice, ...], b: tuple[slice, ...]) -> int:
    return math.prod(max(0, min(x.stop, y.stop) - max(x.start, y.start))
                     for x, y in zip(a, b))


def traffic(param_layouts: dict, grad_layouts: dict, dtypes: dict,
            microbatches: int = 1, splits: Optional[dict] = None,
            activations: Optional[dict] = None) -> dict:
    """Bytes one step moves on distinct devices: the parameters' gather
    (once a step) and the gradients' reduce-scatter (once a microbatch,
    in the parameters' type), and the activation collectives on
    ``"model"`` by type (``activations``, a ``tp.Group``'s ``traffic``:
    ``model_all_gather_bytes``, ...). Without ``splits`` the compute is
    data parallel: each data-parallel rank gathers the pieces its group
    of positions lacks and sends its gradient less the pieces its group
    keeps. With ``splits`` (each leaf's dimension cut over the model
    ranks, or None: whole) every position computes: it gathers what it
    lacks of its region (its model shard, or the whole leaf) and sends
    its gradient of that region less what it keeps."""
    mesh = next(iter(param_layouts.values())).mesh
    gathered = reduced = 0
    if splits is None:
        for group in data_ranks(mesh):
            for name, lay in param_layouts.items():
                nbytes = math.prod(lay.shape) * dtypes[name].itemsize
                gathered += nbytes * (1 - lay.held_share(group))
                reduced += microbatches * nbytes * (
                    1 - grad_layouts[name].held_share(group))
    else:
        axis = mesh.axis_names.index("model")
        ranks = mesh.shape["model"]
        coords = list(np.ndindex(mesh.devices.shape))
        for name, lay in param_layouts.items():
            glay, dim = grad_layouts[name], splits[name]
            # positions holding the same pieces of the same model shard
            # move the same bytes
            kinds: dict[tuple, int] = {}
            for c in coords:
                k = (lay.key_at[c], glay.key_at[c], c[axis])
                kinds[k] = kinds.get(k, 0) + 1
            for (pkey, gkey, m), n in kinds.items():
                need = [slice(0, d) for d in lay.shape]
                if dim is not None:
                    b = lay.shape[dim] // ranks
                    need[dim] = slice(m * b, (m + 1) * b)
                size = math.prod(r.stop - r.start for r in need)
                item = dtypes[name].itemsize
                gathered += n * item * (size - _overlap(need,
                                                        lay.region(pkey)))
                reduced += n * item * microbatches * (
                    size - _overlap(need, glay.region(gkey)))
    out = {"gathered_bytes": int(gathered),
           "reduce_scatter_bytes": int(reduced)}
    for name in COLLECTIVES:
        out[f"model_{name}_bytes"] = int((activations or {}).get(name, 0))
    return out


class ShardedModel:
    """A model's parameters as ``Sharded`` leaves on ``mesh`` by
    ``specs`` (the parameters' names to ``PartitionSpec``s), with the
    moments' layouts by ``moment_specs``. ``module`` (the model, on the
    device of the mesh's first position) becomes that device's gathered
    copy; other devices that compute get a copy of it."""

    def __init__(self, module: torch.nn.Module, mesh, specs: dict,
                 moment_specs: dict):
        self.mesh = mesh
        named = dict(module.named_parameters())
        self.dtypes = {n: p.dtype for n, p in named.items()}
        self.layouts = {n: Layout(p.shape, specs[n], mesh)
                        for n, p in named.items()}
        self.moment_layouts = {n: Layout(p.shape, moment_specs[n], mesh)
                               for n, p in named.items()}
        with torch.no_grad():
            self.leaves = {n: Sharded.place(p.detach(), self.layouts[n])
                           for n, p in named.items()}
        self.home = next(iter(named.values())).device
        self._modules = {self.home: module}
        self._fresh: set = {self.home}   # modules equal to the shards
        self._tp_modules: dict = {}      # device -> (splits, module)
        # what the last step computed with: its ``splits`` (None: data
        # parallel), its ``tp.Group`` (None: data parallel) and its
        # microbatches; ``traffic()`` reads it
        self.last_step: Optional[dict] = None

    def compute_devices(self) -> list[torch.device]:
        """The device of each data-parallel rank (its group's first
        position), in rank order."""
        return [self.mesh.devices[group[0]]
                for group in data_ranks(self.mesh)]

    @torch.no_grad()
    def module_on(self, device) -> torch.nn.Module:
        """The model on ``device`` holding the shards' values (gathered
        once after each update, shared by the ranks there)."""
        device = torch.device(device)
        if device not in self._modules:
            self._modules[device] = copy.deepcopy(
                self._modules[self.home]).to(device)
            self._fresh.discard(device)
        module = self._modules[device]
        if device not in self._fresh:
            for name, p in module.named_parameters():
                self.leaves[name].gather(device, out=p.data)
            self._fresh.add(device)
        return module

    @torch.no_grad()
    def tp_module_on(self, device, splits: dict) -> torch.nn.Module:
        """The model on ``device`` as a data rank's model positions
        compute with it: a leaf whose ``splits`` entry names a dimension
        holds the stack of its model shards (``Sharded.gather_ranks``),
        the others the whole leaf (gathered once after each update)."""
        device = torch.device(device)
        kept = self._tp_modules.get(device)
        if kept is None or kept[0] != splits:
            ranks = self.mesh.shape["model"]
            memo = {}
            for name, p in self._modules[self.home].named_parameters():
                dim = splits[name]
                shape = tuple(p.shape)
                if dim is not None:
                    for lay in (self.layouts[name],
                                self.moment_layouts[name]):
                        if lay.counts[dim] != ranks:
                            raise ValueError(
                                f"{name}: dim {dim} is stored in "
                                f"{lay.counts[dim]} pieces, not the "
                                f"{ranks} model ranks")
                    shape = (ranks, *shape[:dim], shape[dim] // ranks,
                             *shape[dim + 1:])
                memo[id(p)] = torch.nn.Parameter(
                    torch.empty(shape, dtype=p.dtype, device=device),
                    requires_grad=False)
            module = copy.deepcopy(self._modules[self.home], memo)
            kept = self._tp_modules[device] = (dict(splits), module)
            self._fresh.discard(("tp", device))
        module = kept[1]
        if ("tp", device) not in self._fresh:
            for name, p in module.named_parameters():
                dim = splits[name]
                if dim is None:
                    self.leaves[name].gather(device, out=p.data)
                else:
                    self.leaves[name].gather_ranks(device, dim, out=p.data)
            self._fresh.add(("tp", device))
        return module

    def updated(self) -> None:
        """The shards changed: every gathered module is stale."""
        self._fresh.clear()

    def traffic(self) -> dict:
        """``traffic`` of the last step (its microbatches, its compute's
        splits and its activation collectives)."""
        rec = self.last_step or {}
        group = rec.get("group")
        return traffic(self.layouts, self.moment_layouts, self.dtypes,
                       rec.get("microbatches", 1), rec.get("splits"),
                       group.traffic if group is not None else None)

    def named_parameters(self):
        """The gathered module's parameters on the home device."""
        return self.module_on(self.home).named_parameters()

    def parameters(self):
        return self.module_on(self.home).parameters()

    def load_(self, named: dict) -> None:
        """Put whole leaves ``{name: tensor}`` into the shards."""
        for name, t in named.items():
            self.leaves[name].load_(t)
        self.updated()

    def shard_nbytes(self) -> dict:
        """Bytes each mesh position holds of the parameters, and of one
        moment in ``float32``, beside the whole model's."""
        total = sum(math.prod(lay.shape) * self.dtypes[n].itemsize
                    for n, lay in self.layouts.items())
        per = sum(math.prod(lay.block) * self.dtypes[n].itemsize
                  for n, lay in self.layouts.items())
        moment = sum(math.prod(lay.block) * 4
                     for lay in self.moment_layouts.values())
        moment_total = sum(math.prod(lay.shape) * 4
                           for lay in self.moment_layouts.values())
        return {"params_per_shard": per, "params_total": total,
                "moment_per_shard": moment, "moment_total": moment_total}


def _is_leaf(x) -> bool:
    return x is not None and (not isinstance(x, tuple)
                              or isinstance(x, PartitionSpec))


def _leaves(tree) -> list:
    """The leaves of a tree of (named) tuples, in order (None is no
    leaf; a ``PartitionSpec`` is one)."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [tree]
    return [leaf for sub in tree for leaf in _leaves(sub)]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return next(leaves)
    parts = [_rebuild(sub, leaves) for sub in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") \
        else type(tree)(parts)


class ShardedCaches:
    """A decode step's caches (the family's cache tuple) stored as
    ``Sharded`` leaves on ``mesh`` by ``specs`` (the same structure,
    ``sharding.cache_specs``). Every position of the mesh must name one
    device, which then holds every piece as one stack a leaf, so a data
    rank's pieces are views of it and a step updates them in place. A
    leaf's ``model_dims`` entry is the dimension its spec puts on
    ``"model"`` (None: whole on every model position)."""

    def __init__(self, caches, specs, mesh):
        devs = {str(d) for d in mesh.devices.flat}
        if len(devs) != 1:
            raise NotImplementedError(
                "the sharded decode keeps its caches in place on a mesh "
                f"that names one device; this one names {sorted(devs)}")
        self.mesh = mesh
        self.device = mesh.devices.flat[0]
        self.structure = caches
        leaves, spec_leaves = _leaves(caches), _leaves(specs)
        if len(leaves) != len(spec_leaves):
            raise ValueError("the cache specs do not match the caches")
        self.leaves = [Sharded.place(t, Layout(t.shape, sp, mesh))
                       for t, sp in zip(leaves, spec_leaves)]
        self.model_dims = [next((i for i, e in enumerate(sh.layout.spec)
                                 if "model" in _names(e)), None)
                           for sh in self.leaves]
        self._whole: dict[int, torch.Tensor] = {}

    def dims(self):
        """``model_dims`` in the caches' structure."""
        return _rebuild(self.structure, iter(self.model_dims))

    def rank_views(self, data_index: int):
        """The caches as data rank ``data_index`` computes with them, in
        their structure: a leaf with a batch (dimension 1) is a view of
        the rank's pieces, ``(R, ...)`` stacked by model rank where the
        spec names ``"model"`` (its dimension cut in R), else the rank's
        one piece; a leaf without one (the hybrid's ring positions, the
        enc-dec's memory positions) is the whole leaf, gathered once a
        step and written back by ``commit``."""
        views = []
        for i, (sh, m) in enumerate(zip(self.leaves, self.model_dims)):
            lay = sh.layout
            if len(lay.shape) < 3:
                if i not in self._whole:
                    self._whole[i] = sh.gather(self.device)
                views.append(self._whole[i])
                continue
            grid = sh.grid(self.device)
            at = [slice(None) if d == m else
                  (data_index if d == 1 and lay.counts[1] > 1 else 0)
                  for d in range(len(lay.shape))]
            views.append(grid[tuple(at)])
        return _rebuild(self.structure, iter(views))

    @torch.no_grad()
    def commit(self) -> None:
        """Write the whole leaves ``rank_views`` handed out back into
        their pieces."""
        for i, whole in self._whole.items():
            self.leaves[i].load_(whole)
        self._whole.clear()

    def gather(self):
        """The whole caches on the mesh's device, in their structure."""
        return _rebuild(self.structure,
                        iter([sh.gather(self.device) for sh in self.leaves]))

    def nbytes_per_device(self) -> int:
        """The bytes of cache a mesh position holds."""
        return sum(math.prod(sh.layout.block) * sh.dtype.itemsize
                   for sh in self.leaves)
