"""Tensor- and expert-parallel compute on the ``"model"`` axis: the
collectives of one data-parallel rank's group of model positions.

The reference's sharded train step is one GSPMD program: every mesh
position computes its share of each matmul, in the layouts its model
code asks for with ``constrain`` (``distributed.ctx.constraint_spec``
names them). The port drives a data rank's ``R`` model positions from
one process, as a stack: a tensor a rank holds its own value of is
*ranked*, ``(R, ...)``, row ``r`` being model rank ``r``'s; a tensor
every rank holds the same value of is *replicated* and kept once,
without the rank dimension. A mesh that names the card ``R`` times on
``"model"`` so runs one batched operation a matmul (``torch.bmm`` over
the rank dimension), not ``R``.

The collectives move data between the ranks of the stack, each an
``autograd.Function`` whose backward is its conjugate (Megatron's
pairs):

    gather_to_ranks   (R, .., n/R, ..) -> (R, .., n, ..)  all-gather;
                      backward reduce-scatter
    scatter_sum       (R, .., n, ..) partial sums -> (R, .., n/R, ..)
                      reduce-scatter; backward all-gather
    reduce_from_ranks (R, ...) partial sums -> replicated   all-reduce;
                      backward: each rank takes the gradient
    copy_to_ranks     replicated -> (R, ...) (a view)  nothing; backward
                      all-reduce
    split_to_ranks    replicated -> (R, .., n/R, ..)  nothing; backward
                      all-gather
    gather_from_ranks (R, .., n/R, ..) -> replicated  all-gather;
                      backward: each rank takes its part
    max_from_ranks    (R, ...) -> replicated, the largest (no gradient)

Every sum over ranks adds them in rank order, rank 0 first, in float32
(cast back to the input's type), with no atomics, so two runs give the
same bits. A ranked output that every rank holds whole is an expanded
view of one copy. The MoE's dispatch moves no bytes here: the tokens
reach every rank by the all-gather before it (the reference asks for
them replicated over ``"model"``, ``gtd``), and each rank takes its own
experts' slots; its combine is ``scatter_sum`` (or
``reduce_from_ranks``) of the ranks' partial outputs.

``Group`` holds the mesh and the bytes each type of collective moves
between distinct devices, counted as a ring moves them: an all-gather
or a reduce-scatter of an ``N``-byte tensor ``(R - 1) N`` over the
group, an all-reduce ``2 (R - 1) N`` (``N`` in the tensor's type;
rematerialised layers count again, as they run again). ``calls`` keeps,
by type, how many collectives ran and the bytes of the result each
position holds after one (``N`` for an all-gather or an all-reduce,
``N / R`` for a reduce-scatter), the cost model's per-device view
(``launch.cost_analysis.model_axis_collectives``). ``model_dim``
asks ``ctx.constraint_spec`` where a kind of activation keeps
``"model"``; ``placed`` checks a tensor against that layout and logs
it, ``check`` a split the compute took from its weights' shape.
"""

# LM compute: bf16 weights with float32 partial sums is the design, as
# in the reference's model zoo, outside the estimator's PrecisionPolicy
# torchlint: disable-file=TL003

from __future__ import annotations

from typing import Optional

import torch

from . import ctx

__all__ = ["Group", "COLLECTIVES", "gather_to_ranks", "scatter_sum",
           "reduce_from_ranks", "copy_to_ranks", "split_to_ranks",
           "gather_from_ranks", "max_from_ranks", "split_ranks",
           "merge_ranks", "sum_ranks", "ranked_matmul"]

COLLECTIVES = ("all_gather", "reduce_scatter", "all_reduce")


class Group:
    """The ``mesh.shape["model"]`` model positions of a data-parallel
    rank, the layouts their activations take (``model_dim``, under
    ``seq_parallel``) and the bytes their collectives move
    (``traffic``, over every rank and microbatch the group served)."""

    def __init__(self, mesh, *, seq_parallel: bool = True):
        self.mesh = mesh
        self.size = int(mesh.shape["model"])
        self.seq_parallel = seq_parallel
        self.traffic = {name: 0 for name in COLLECTIVES}
        # by type: [collectives run, result bytes a position holds]
        self.calls = {name: [0, 0] for name in COLLECTIVES}
        self.layouts: list[tuple[str, tuple, Optional[int]]] = []
        # per MoE layer run (not its rematerialisation): the experts each
        # model rank ran and the kept (token, expert) pairs it computed,
        # ``(R,)`` tensors on the device
        self.moe_ranks: list[tuple[list, torch.Tensor]] = []
        self._dims: dict = {}

    def model_dim(self, kind: str, shape) -> Optional[int]:
        """The dimension of a ``kind`` activation of ``shape`` (its whole
        shape) that ``constraint_spec`` puts on ``"model"``, or None
        (replicated)."""
        key = (kind, tuple(shape))
        if key not in self._dims:
            with ctx.activation_sharding(self.mesh,
                                         seq_parallel=self.seq_parallel):
                spec = ctx.constraint_spec(key[1], kind)
            self._dims[key] = next(
                (i for i, e in enumerate(spec or ())
                 if e == "model" or (isinstance(e, tuple) and "model" in e)),
                None)
        return self._dims[key]

    def check(self, kind: str, shape, dim: Optional[int]) -> None:
        """Raises where the compute splits a ``kind`` activation of whole
        ``shape`` on another dimension (``dim``, None: replicated) than
        ``model_dim``."""
        want = self.model_dim(kind, tuple(shape))
        if dim != want:
            raise ValueError(f"{kind} {tuple(shape)}: the compute splits "
                             f"dim {dim} over the model ranks, the layout "
                             f"asks dim {want}")

    def record(self, kind: str, shape, dim: Optional[int]) -> None:
        """``check``, then log the layout (an activation the compute
        holds replicated inside a function it calls whole)."""
        self.check(kind, shape, dim)
        self.layouts.append((kind, tuple(shape), dim))

    def placed(self, kind: str, shape, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the compute holds a ``kind`` activation of whole
        ``shape``: ranked with ``model_dim`` cut in ``size`` parts, or,
        where it is None, replicated (kept once or a rank each). Raises
        where it is not; logs it; returns ``x``."""
        shape = tuple(shape)
        dim = self.model_dim(kind, shape)
        if dim is None:
            ok = tuple(x.shape) in (shape, (self.size, *shape))
        else:
            part = list(shape)
            part[dim] //= self.size
            ok = tuple(x.shape) == (self.size, *part)
        if not ok:
            raise ValueError(f"{kind} {shape}: the compute holds "
                             f"{tuple(x.shape)}, the layout asks model on "
                             f"dim {dim} of {self.size}")
        self.layouts.append((kind, shape, dim))
        return x

    # the residual stream ``(b, s, d)`` (``shape``): its sequence cut over
    # the ranks where ``bsd`` asks for sequence parallelism, else
    # replicated
    def seq_split(self, shape) -> bool:
        return self.model_dim("bsd", shape) == 1

    def whole(self, x: torch.Tensor, shape
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """The residual ``x`` whole on every rank, ``(R, b, s, d)`` (a
        view), and once (rank 0's copy, for the replicated compute)."""
        if self.seq_split(shape):
            y = gather_to_ranks(x, self, 1)
            return y, y[0]
        return copy_to_ranks(x, self), x

    def rows(self, x: torch.Tensor, shape) -> torch.Tensor:
        """Each rank's part of the residual's sequence."""
        return x if self.seq_split(shape) else split_to_ranks(x, self, 1)

    def from_rows(self, y: torch.Tensor, shape) -> torch.Tensor:
        """Sequence parts ``(R, b, s / R, d)`` in the residual's
        layout."""
        return y if self.seq_split(shape) else gather_from_ranks(y, self, 1)

    def from_partials(self, y: torch.Tensor, shape) -> torch.Tensor:
        """The ranks' partial sums ``(R, b, s, d)`` added into the
        residual's layout (reduce-scatter, or all-reduce)."""
        if self.seq_split(shape):
            return scatter_sum(y, self, 1)
        return reduce_from_ranks(y, self)

    def from_replicated(self, y: torch.Tensor, shape) -> torch.Tensor:
        """A replicated ``(b, s, d)`` in the residual's layout."""
        return split_to_ranks(y, self, 1) if self.seq_split(shape) else y

    def count(self, what: str, t: torch.Tensor, times: int = 1) -> None:
        """One collective of type ``what`` on the whole tensor ``t``
        (``times`` 2 for an all-reduce's two ring passes)."""
        nbytes = t.numel() * t.element_size()
        self.traffic[what] += times * (self.size - 1) * nbytes
        self.calls[what][0] += 1
        self.calls[what][1] += nbytes // self.size \
            if what == "reduce_scatter" else nbytes


def ranked_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each rank's ``x[r] @ w[r]``: ``x`` ``(R, ..., k)``, ``w`` ``(R, k,
    n)``; one batched product."""
    out = torch.bmm(x.reshape(x.shape[0], -1, x.shape[-1]), w)
    return out.view(*x.shape[:-1], w.shape[-1])


def sum_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t`` ``(R, ...)`` summed over its ranks in order, rank 0 first,
    in float32, cast back to ``t``'s type."""
    acc = t[0].float().clone()
    for r in range(1, t.shape[0]):
        acc.add_(t[r])
    return acc.to(t.dtype)


def split_ranks(t: torch.Tensor, dim: int, ranks: int) -> torch.Tensor:
    """A whole tensor cut into ``ranks`` equal parts along ``dim``,
    stacked ``(ranks, ...)`` (contiguous)."""
    return t.unflatten(dim, (ranks, -1)).movedim(dim, 0).contiguous()


def merge_ranks(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``split_ranks``' inverse: ``(R, ...)`` parts joined along
    ``dim``."""
    return t.movedim(0, dim).flatten(dim, dim + 1)


def _expand(t: torch.Tensor, ranks: int) -> torch.Tensor:
    return t.expand(ranks, *t.shape)


class _GatherToRanks(torch.autograd.Function):
    @staticmethod
    def forward(c, x, group, dim):
        c.group, c.dim = group, dim
        whole = merge_ranks(x, dim)
        group.count("all_gather", whole)
        return _expand(whole, x.shape[0])

    @staticmethod
    def backward(c, grad):
        total = sum_ranks(grad)
        c.group.count("reduce_scatter", total)
        return split_ranks(total, c.dim, grad.shape[0]), None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(c, x, group, dim):
        c.group, c.dim = group, dim
        total = sum_ranks(x)
        group.count("reduce_scatter", total)
        return split_ranks(total, dim, x.shape[0])

    @staticmethod
    def backward(c, grad):
        whole = merge_ranks(grad, c.dim)
        c.group.count("all_gather", whole)
        return _expand(whole, grad.shape[0]), None, None


class _ReduceFromRanks(torch.autograd.Function):
    @staticmethod
    def forward(c, x, group):
        c.ranks = x.shape[0]
        total = sum_ranks(x)
        group.count("all_reduce", total, 2)
        return total

    @staticmethod
    def backward(c, grad):
        return _expand(grad, c.ranks), None


class _CopyToRanks(torch.autograd.Function):
    @staticmethod
    def forward(c, x, group):
        c.group = group
        return _expand(x, group.size)

    @staticmethod
    def backward(c, grad):
        total = sum_ranks(grad)
        c.group.count("all_reduce", total, 2)
        return total, None


class _SplitToRanks(torch.autograd.Function):
    @staticmethod
    def forward(c, x, group, dim):
        c.group, c.dim = group, dim
        return split_ranks(x, dim, group.size)

    @staticmethod
    def backward(c, grad):
        whole = merge_ranks(grad, c.dim)
        c.group.count("all_gather", whole)
        return whole, None, None


class _GatherFromRanks(torch.autograd.Function):
    @staticmethod
    def forward(c, x, group, dim):
        c.dim, c.ranks = dim, x.shape[0]
        whole = merge_ranks(x, dim)
        group.count("all_gather", whole)
        return whole

    @staticmethod
    def backward(c, grad):
        return split_ranks(grad, c.dim, c.ranks), None, None


def gather_to_ranks(x: torch.Tensor, group: Group, dim: int
                    ) -> torch.Tensor:
    """All-gather: each rank's part ``x[r]`` joined along ``dim`` (of the
    parts), the whole on every rank ``(R, ...)`` (an expanded view)."""
    return _GatherToRanks.apply(x, group, dim)


def scatter_sum(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """Reduce-scatter: the ranks' partial sums ``x`` added, rank ``r``
    keeping part ``r`` along ``dim``."""
    return _ScatterSum.apply(x, group, dim)


def reduce_from_ranks(x: torch.Tensor, group: Group) -> torch.Tensor:
    """All-reduce: the ranks' partial sums ``x`` added, replicated."""
    return _ReduceFromRanks.apply(x, group)


def copy_to_ranks(x: torch.Tensor, group: Group) -> torch.Tensor:
    """A replicated tensor as each rank's ``(R, ...)`` (a view); the
    ranks' gradients are added (all-reduce)."""
    return _CopyToRanks.apply(x, group)


def split_to_ranks(x: torch.Tensor, group: Group, dim: int
                   ) -> torch.Tensor:
    """A replicated tensor's part ``r`` along ``dim`` on rank ``r``."""
    return _SplitToRanks.apply(x, group, dim)


def gather_from_ranks(x: torch.Tensor, group: Group, dim: int
                      ) -> torch.Tensor:
    """All-gather into a replicated tensor: the parts joined along
    ``dim``."""
    return _GatherFromRanks.apply(x, group, dim)


@torch.no_grad()
def max_from_ranks(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The largest of the ranks' ``x``, replicated (an all-reduce of the
    maximum; exact in any order, and no gradient)."""
    group.count("all_reduce", x[0], 2)
    return x.amax(dim=0)
