"""Costs of the port's own traced programs: the counterpart of
``repro.launch.hlo_analysis``, which reads compiled XLA HLO.

The port has no compiler to ask. A step is traced instead: built and run
on the device it would run on under ``repro_torch.device.tracing``
(``FakeTensorMode``: shapes, dtypes and devices, no storage), with every
aten operator the program dispatches recorded by ``CostMode``, a
``TorchDispatchMode``. The op log (a ``Trace``) is what this module
reads, with the same public functions and result keys as the
reference's: ``collective_bytes`` (``CollectiveStats`` by type),
``summarize_collectives`` (``per_type``, ``total_wire_bytes``,
``total_result_bytes``, ``total_count``) and ``program_costs``
(``flops``, ``bytes``). ``CostMode`` counts real tensors as well: the
same program run on the card gives the same counts.

What differs from the reference:

* **No trip counts.** An eager program dispatches every loop iteration
  (every layer, microbatch, data rank, KV chunk), so the log already
  holds each one; ``_trip_count`` and ``_split_computations`` have no
  counterpart.
* **FLOPs** are ``torch.utils.flop_counter``'s formulas (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, convolutions: 2 per multiply-add),
  plus the flash kernel's own (``kernels.flash_attention.ops.
  flash_flops``: the tiles the kernel computes). Like the reference's
  dot count, elementwise work adds no FLOPs.
* **Bytes** count the inputs and outputs (numel x itemsize) of every
  operator that is not a view, and not an uninitialised allocation:
  the card's eager program streams each of them. Indexed operators
  (``embedding``, ``gather``, ``index_copy_``, ``index_put_``, ...)
  count the rows they read and write, not the whole table. The reference counts
  only its ``_TRAFFIC_OPS``, because a TPU fuses elementwise chains, so
  **the two byte counts are not comparable**; the port's is what the
  eager program moves if every operand comes from memory.
* **Transcendentals** are the elements the program passes through
  ``exp``, ``log``, ``tanh``, ``sigmoid``, ``rsqrt``, ``sqrt``, ``sin``,
  ``cos``, ``erf``, ``pow`` and the operators built on them (softmax,
  SiLU, GELU, logsumexp), as XLA's ``cost_analysis`` reports them.
* **Collectives** are not in the op log: one process drives every mesh
  position. The model axis's come from ``distributed.tp.Group.calls``
  (``model_axis_collectives``), the data axes' parameter gathers and
  gradient reduce-scatters from the layouts
  (``data_axis_collectives``). Both are converted to the reference's
  per-device ring convention (``hlo_analysis.py:10-16``): all-gather
  wire = result bytes, reduce-scatter wire = result x group, all-reduce
  wire = 2 x result. ``Group.traffic``'s totals over all positions,
  ``(R - 1) N`` an all-gather or reduce-scatter and ``2 (R - 1) N`` an
  all-reduce, are the same numbers times ``(R - 1)`` and the data
  ranks: per-device wire = traffic / ((R - 1) x data ranks).

Per device: the trace covers the whole mesh (every data rank; a data
rank's model positions as one stack), so its FLOPs, bytes and
transcendentals are divided by the mesh's positions, its temporaries
too (``Lowered.memory_analysis``; the whole program's are kept as
``program_temp_bytes``). On a one-device mesh both views agree.

``Lowered`` gives ``train.step``'s ``lower_*`` the shape of a JAX AOT
lowering: ``lowered.compile()`` (nothing to compile: the lowered
program itself) gives ``memory_analysis()``, ``cost_analysis()`` and
``as_text()`` (an op listing).
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from collections import namedtuple
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["CollectiveStats", "Trace", "CostMode", "collective_bytes",
           "summarize_collectives", "program_costs", "model_axis_collectives",
           "data_axis_collectives", "merge_collectives", "MemoryAnalysis",
           "Lowered", "COLLECTIVE_NAMES"]

# the reference's collective names, by ``distributed.tp``'s
COLLECTIVE_NAMES = {"all_gather": "all-gather",
                    "reduce_scatter": "reduce-scatter",
                    "all_reduce": "all-reduce"}

# transcendental elements an operator computes per element of its first
# output (softmax: one exp; log-softmax and logsumexp of the input: an
# exp each, the log per row left out)
_TRANSCENDENTAL = {
    "exp": 1, "exp2": 1, "expm1": 1, "log": 1, "log1p": 1, "log2": 1,
    "tanh": 1, "sigmoid": 1, "rsqrt": 1, "sqrt": 1, "sin": 1, "cos": 1,
    "erf": 1, "pow": 1, "silu": 1, "gelu": 1, "log_sigmoid_forward": 1,
    "_softmax": 1, "_log_softmax": 1,
}
_INPUT_TRANSCENDENTAL = {"logsumexp"}
# allocations that write nothing
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "lift_fresh", "_local_scalar_dense"}
# indexed reads (the rows they gather) and writes (the rows they write):
# their whole source or destination is not streamed
_INDEXED = {"embedding", "index_select", "gather", "index", "index_copy",
            "index_copy_", "index_put", "index_put_", "scatter",
            "scatter_", "index_add", "index_add_"}


def _indexed_bytes(short: str, args, outs) -> int:
    """Bytes an indexed operator moves: a gather reads and writes its
    output's rows (and reads its indices); a scatter reads and writes
    its source's rows (and reads its indices)."""
    tensors = [t for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor)]
    index = sum(_nbytes(t) for t in tensors
                if not t.is_floating_point() and t.dtype != torch.bool)
    if short in ("embedding", "index_select", "gather", "index"):
        return 2 * sum(_nbytes(t) for t in outs) + index
    source = tensors[-1] if tensors else None
    if source is None or not source.is_floating_point():
        return index
    return 2 * _nbytes(source) + index


@dataclasses.dataclass
class CollectiveStats:
    count: float = 0.0
    result_bytes: float = 0.0
    wire_bytes: float = 0.0

    def as_dict(self):
        return dataclasses.asdict(self)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Trace:
    """The op log of one traced program: by operator name its calls,
    FLOPs, bytes and transcendentals (whole program), the peak of the
    bytes it allocated and still held, and its collectives per device
    (filled by the caller that knows the mesh). ``n_devices`` is the mesh
    positions the program drives."""

    def __init__(self, n_devices: int = 1):
        self.n_devices = int(n_devices)
        self.ops: dict[str, list] = {}
        self.collectives: dict[str, CollectiveStats] = {}
        self.peak_bytes = 0
        self.seconds = 0.0

    def add(self, name: str, flops: int, nbytes: int, trans: int) -> None:
        row = self.ops.setdefault(name, [0, 0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        row[3] += trans

    def total(self, column: int) -> int:
        return sum(row[column] for row in self.ops.values())

    @property
    def flops(self) -> int:
        """FLOPs of the whole program (every position)."""
        return self.total(1)

    @property
    def bytes(self) -> int:
        return self.total(2)

    @property
    def transcendentals(self) -> int:
        return self.total(3)

    def calls(self, name: str) -> int:
        """How many times the operator ``name`` (``"aten.mm"``,
        ``"repro_torch.flash_attention"``) ran."""
        return self.ops.get(name, [0])[0]


class CostMode(TorchDispatchMode):
    """Records every operator dispatched inside it into ``trace`` (a new
    ``Trace`` when None): FLOPs, bytes, transcendentals, and the live
    bytes of the storages the program allocates (their peak is
    ``trace.peak_bytes``; storages made before the mode do not count).
    Works on fake and on real tensors."""

    def __init__(self, trace: Optional[Trace] = None):
        super().__init__()
        self.trace = trace if trace is not None else Trace()
        self._live: dict[int, int] = {}
        self._current = 0

    def _free(self, key: int) -> None:
        self._current -= self._live.pop(key, 0)

    def _track(self, outs, ins) -> None:
        given = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in given:   # in place, or seen
                continue
            self._live[key] = st.nbytes()
            self._current += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.trace.peak_bytes = max(self.trace.peak_bytes, self._current)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":           # metadata (``t.device``)
            return out
        packet = func.overloadpacket
        name = str(packet)
        if func.is_view:                       # no flops, bytes or storage
            self.trace.add(name, 0, 0, 0)
            return out
        short = name.rsplit(".", 1)[-1]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        nbytes = 0
        if short in _INDEXED:
            nbytes = _indexed_bytes(short, args, outs)
        elif short not in _NO_TRAFFIC:
            nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                                        for t in outs)
        trans = 0
        base = short.rstrip("_")
        if base in _TRANSCENDENTAL and outs:
            trans = outs[0].numel() * _TRANSCENDENTAL[base]
        elif base in _INPUT_TRANSCENDENTAL and isinstance(args[0],
                                                          torch.Tensor):
            trans = args[0].numel()
        self.trace.add(name, flops, nbytes, trans)
        if outs:
            self._track(outs, ins)
        return out


# ------------------------------------------------------------ collectives
def model_axis_collectives(group, data_ranks: int
                           ) -> dict[str, CollectiveStats]:
    """Per-device collectives on ``"model"`` from ``group`` (a
    ``distributed.tp.Group`` that ``data_ranks`` data ranks each ran
    their step through): each of its ``calls`` is one collective on
    every model position of one data rank, so a device runs ``calls /
    data_ranks`` of them; wire bytes by the reference's convention."""
    out = {}
    for what, (count, result) in group.calls.items():
        if not count:
            continue
        result = result / data_ranks
        wire = {"all_gather": result, "reduce_scatter": result * group.size,
                "all_reduce": 2 * result}[what]
        out[COLLECTIVE_NAMES[what]] = CollectiveStats(count / data_ranks,
                                                      result, wire)
    return out


def _overlap(a, b) -> int:
    return math.prod(max(0, min(x.stop, y.stop) - max(x.start, y.start))
                     for x, y in zip(a, b))


def data_axis_collectives(layouts: dict, dtypes: dict,
                          grad_layouts: Optional[dict] = None,
                          splits: Optional[dict] = None,
                          microbatches: int = 1
                          ) -> dict[str, CollectiveStats]:
    """Per-device parameter gathers and gradient reduce-scatters over the
    data axes, averaged over the mesh's positions. A position needs of
    each leaf its region: its model shard where ``splits`` names a
    dimension, else the whole leaf. Where it holds less (``layouts``),
    one all-gather a step, result = the region. With ``grad_layouts``
    (a train step) each microbatch reduce-scatters the region's gradient
    onto the gradient's piece (``grad_layouts``): result = the piece's
    part of the region, wire = the region (result x group)."""
    lay0 = next(iter(layouts.values()))
    mesh = lay0.mesh
    axis = mesh.axis_names.index("model") if "model" in mesh.axis_names \
        else None
    ranks = mesh.shape.get("model", 1)
    coords = list(lay0.key_at)
    n = len(coords)
    ag = CollectiveStats()
    rs = CollectiveStats()
    for name, lay in layouts.items():
        dim = (splits or {}).get(name)
        item = dtypes[name].itemsize
        glay = (grad_layouts or {}).get(name)
        for c in coords:
            need = [slice(0, d) for d in lay.shape]
            if dim is not None and axis is not None:
                b = lay.shape[dim] // ranks
                need[dim] = slice(c[axis] * b, (c[axis] + 1) * b)
            size = math.prod(r.stop - r.start for r in need) * item
            held = _overlap(need, lay.region(lay.key_at[c])) * item
            if held < size:
                ag.count += 1
                ag.result_bytes += size
                ag.wire_bytes += size
            if glay is not None:
                kept = _overlap(need, glay.region(glay.key_at[c])) * item
                if kept < size:
                    rs.count += microbatches
                    rs.result_bytes += microbatches * kept
                    rs.wire_bytes += microbatches * size
    out = {}
    for kind, st in (("all-gather", ag), ("reduce-scatter", rs)):
        if st.count:
            out[kind] = CollectiveStats(st.count / n, st.result_bytes / n,
                                        st.wire_bytes / n)
    return out


def merge_collectives(*parts: dict) -> dict[str, CollectiveStats]:
    out: dict[str, CollectiveStats] = {}
    for part in parts:
        for kind, st in part.items():
            acc = out.setdefault(kind, CollectiveStats())
            acc.count += st.count
            acc.result_bytes += st.result_bytes
            acc.wire_bytes += st.wire_bytes
    return out


def _trace_of(x) -> Trace:
    return x.trace if isinstance(x, Lowered) else x


def collective_bytes(trace) -> dict[str, CollectiveStats]:
    """Per-device collectives of a traced program (a ``Trace``, or a
    ``Lowered``), by the reference's type names."""
    return {k: dataclasses.replace(v)
            for k, v in _trace_of(trace).collectives.items()}


def summarize_collectives(trace) -> dict:
    stats = collective_bytes(trace)
    return {
        "per_type": {k: v.as_dict() for k, v in stats.items()},
        "total_wire_bytes": sum(v.wire_bytes for v in stats.values()),
        "total_result_bytes": sum(v.result_bytes for v in stats.values()),
        "total_count": sum(v.count for v in stats.values()),
    }


def program_costs(trace) -> dict:
    """Per-device ``{flops, bytes}`` of a traced program: every loop
    iteration is in the log, so nothing is weighted."""
    tr = _trace_of(trace)
    return {"flops": tr.flops / tr.n_devices,
            "bytes": tr.bytes / tr.n_devices}


# --------------------------------------------------------- lowered/compiled
MemoryAnalysis = namedtuple("MemoryAnalysis", [
    "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
    "alias_size_in_bytes", "program_temp_bytes"])


class Lowered:
    """A traced program and its analysis, as a lowered and compiled JAX
    program give it; ``compile()`` returns it (there is nothing to
    compile). ``memory`` holds the per-device ``argument``, ``output`` and
    ``alias`` bytes (from the specs and the donations); the temporaries
    are the trace's peak of allocated, still-held bytes (the whole
    program's, and spread over the positions)."""

    def __init__(self, trace: Trace, memory: dict, header: str = ""):
        self.trace = trace
        self._memory = dict(memory)
        self._header = header

    def compile(self) -> "Lowered":
        return self

    def memory_analysis(self) -> MemoryAnalysis:
        tr = self.trace
        return MemoryAnalysis(
            argument_size_in_bytes=int(self._memory["argument"]),
            output_size_in_bytes=int(self._memory["output"]),
            temp_size_in_bytes=int(tr.peak_bytes // tr.n_devices),
            alias_size_in_bytes=int(self._memory["alias"]),
            program_temp_bytes=int(tr.peak_bytes))

    def cost_analysis(self) -> dict:
        """Per-device ``flops``, ``bytes accessed`` and
        ``transcendentals`` (the reference's keys)."""
        tr = self.trace
        return {"flops": tr.flops / tr.n_devices,
                "bytes accessed": tr.bytes / tr.n_devices,
                "transcendentals": tr.transcendentals / tr.n_devices}

    def as_text(self) -> str:
        """The op listing: one line per operator, by FLOPs then calls
        (whole program), then the collectives per device."""
        tr = self.trace
        lines = [self._header,
                 f"positions {tr.n_devices}  traced in {tr.seconds:.2f} s  "
                 f"peak temp {tr.peak_bytes} B",
                 f"{'op':44s} {'calls':>9s} {'flops':>20s} {'bytes':>18s} "
                 f"{'transc':>14s}"]
        for name, (calls, fl, by, trans) in sorted(
                tr.ops.items(), key=lambda kv: (-kv[1][1], -kv[1][0])):
            lines.append(f"{name:44s} {calls:9d} {fl:20d} {by:18d} "
                         f"{trans:14d}")
        for kind, st in tr.collectives.items():
            lines.append(f"{kind} per device: count {st.count:g} result "
                         f"{st.result_bytes:g} B wire {st.wire_bytes:g} B")
        return "\n".join(lines)
