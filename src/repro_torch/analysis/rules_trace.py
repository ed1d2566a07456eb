"""Capture-hygiene rules: TL001, TL005, TL006.

These enforce what the port's CUDA graphs rely on — the fused sweep's
(``experiments/fused.py``), the trial engine's chunk graph
(``experiments/montecarlo.py``), the k-means++ draws
(``core/clustering/kmeans.py``) and the serve loop's decode step
(``launch/serve.py``): a captured body never round-trips to the host
and never branches in Python on a tensor, since either fails the
capture or is frozen into the graph, and only on the card (every
capture is guarded by ``is_cuda``, so no CPU test ever captures). The
kernels are batch-native: ``vmap`` over a kernel op re-creates the
per-lane launches the batch lane removed.
"""

from __future__ import annotations

import ast

from .context import FileContext, own_body_walk
from .findings import Finding
from .registry import register_rule

__all__ = ["check_host_sync", "check_tensor_branch", "check_vmap_of_kernel"]

# numpy functions that copy their (tensor) argument to the host
_NP_SYNC_FNS = frozenset({"asarray", "array", "frombuffer",
                          "ascontiguousarray", "copyto", "save", "savez"})
# tensor methods that block on or copy a device value to the host
_SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})
# calls that copy a host value to the device (a pageable copy that a
# capture refuses, or records with the capture-time value)
_H2D_CALLS = frozenset({"torch.tensor", "torch.as_tensor",
                        "torch.from_numpy"})
# torch factories that make a host tensor unless given a device
_HOST_FACTORIES = frozenset({f"torch.{f}" for f in (
    "zeros", "ones", "empty", "full", "arange", "linspace", "eye", "rand",
    "randn", "randint")})
# tensor attributes that are static at capture time — reading them
# neither syncs (TL001) nor makes a Python branch dynamic (TL005)
_STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda",
                           "layout", "requires_grad", "is_sparse"})
# methods whose result is static: tensor metadata (no device read), and
# the Python containers of a dict or pytree (their length is static)
_STATIC_METHODS = frozenset({"size", "dim", "numel", "nelement",
                             "ndimension", "element_size", "get_device",
                             "is_floating_point", "is_complex",
                             "is_contiguous", "data_ptr",
                             "keys", "values", "items", "leaves"})
# builtins whose result on a non-constant argument is static/hashable
_STATIC_CALLS = frozenset({"len", "isinstance", "issubclass", "getattr",
                           "hasattr", "type", "id", "repr", "str",
                           "callable"})
# parameter names conventionally bound to static (hashable, non-tensor)
# configuration in this codebase — branching on them is capture-time
# specialization, not a tensor branch. Tensors must not use these names
# (rename or suppress if they do).
_STATIC_NAME_HINTS = frozenset({"cfg", "config", "spec", "plan", "policy",
                                "precision", "mesh", "backend", "axes",
                                "hparams", "strict"})
_VMAPS = frozenset({"torch.vmap", "torch.func.vmap"})


def _findings(ctx, rule, nodes_msgs):
    return [Finding(rule=rule, path=ctx.rel, line=n.lineno,
                    col=n.col_offset, message=m) for n, m in nodes_msgs]


def _regions(ctx: FileContext):
    """``(label, statements or function node, FunctionInfo or None,
    is_block)`` of everything inside a capture."""
    for info in ctx.captured_functions:
        yield f"captured function `{info.qualname}`", info.node, info, False
    for block, info in ctx.capture_blocks:
        where = f" in `{info.qualname}`" if info else ""
        yield f"CUDA-graph capture block{where}", block.body, info, True


def _is_cpu_target(node) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and node.args and \
            isinstance(node.func, ast.Attribute) and node.func.attr == "device":
        return _is_cpu_target(node.args[0])
    return False


def _is_host_value(node, ctx: FileContext) -> bool:
    """A value that certainly lives on the host: a literal, a numpy
    result, or a torch factory's tensor made without a ``device=``."""
    if isinstance(node, (ast.List, ast.Tuple, ast.Constant)):
        return True
    if isinstance(node, ast.Call):
        dotted = ctx.resolve(node.func)
        return dotted.startswith("numpy.") or (
            dotted in _HOST_FACTORIES
            and not any(kw.arg == "device" for kw in node.keywords))
    return False


@register_rule(
    "TL001", "host-sync-in-capture",
    "host round-trips (.item()/.cpu()/.numpy()/synchronize/print, numpy "
    "conversions) and host-to-device copies (torch.tensor/as_tensor/"
    "from_numpy, .cuda(), .to() of a host value) inside a CUDA-graph "
    "capture or a compiled/vmapped function fail the capture or freeze "
    "a capture-time value")
def check_host_sync(ctx: FileContext):
    """Flag host syncs and host-to-device copies inside a capture."""
    hits = []
    for label, body, _info, _ in _regions(ctx):
        for node in own_body_walk(body):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            dotted = ctx.resolve(fn)
            if isinstance(fn, ast.Attribute) and fn.attr in _SYNC_ATTRS:
                hits.append((node, f"`.{fn.attr}()` inside {label} waits "
                             "for the device; keep the value on the device "
                             "or read it after the replay"))
            elif isinstance(fn, ast.Attribute) and fn.attr == "cuda":
                hits.append((node, f"`.cuda()` inside {label} copies a "
                             "host value to the device; make it before the "
                             "capture or fill a device buffer"))
            elif isinstance(fn, ast.Attribute) and fn.attr == "to" and (
                    any(_is_cpu_target(a) for a in node.args)
                    or any(kw.arg == "device" and _is_cpu_target(kw.value)
                           for kw in node.keywords)):
                hits.append((node, f"`.to(cpu)` inside {label} copies a "
                             "device value to the host"))
            elif isinstance(fn, ast.Attribute) and fn.attr == "to" \
                    and _is_host_value(fn.value, ctx):
                hits.append((node, f"`.to()` of a host value inside {label} "
                             "is a host-to-device copy"))
            elif dotted in _H2D_CALLS:
                hits.append((node, f"`{dotted}` inside {label} copies host "
                             "data to the device; use torch.full/"
                             "torch.empty + fill_ or a static buffer"))
            elif (dotted.startswith("numpy.")
                    and dotted.rsplit(".", 1)[-1] in _NP_SYNC_FNS):
                hits.append((node, f"`{dotted}` inside {label} materializes "
                             "its argument on the host"))
            elif isinstance(fn, ast.Name) and fn.id == "print":
                hits.append((node, f"`print` inside {label} runs once at "
                             "capture time (or syncs on a tensor)"))
            elif (isinstance(fn, ast.Name) and fn.id in ("float", "int",
                                                         "bool")
                    and len(node.args) == 1
                    and _dynamic_names(node.args[0])):
                hits.append((node, f"`{fn.id}(...)` on a non-constant inside "
                             f"{label} reads a tensor on the host"))
    return _findings(ctx, "TL001", hits)


def _dynamic_names(node) -> set:
    """Names whose runtime VALUE the expression depends on.

    Skips subtrees that are static at capture time: ``.shape``-style
    attribute reads and ``.numel()``-style metadata calls,
    ``len``/``isinstance`` calls, pure ``is``/``is not`` comparisons
    (structural ``None`` checks) and ``"key" in d`` (dict-key
    membership).
    """
    out: set[str] = set()
    if isinstance(node, ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return out
        out |= _dynamic_names(node.value)
        return out
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in _STATIC_CALLS:
            return out
        if isinstance(fn, ast.Attribute) and fn.attr in _STATIC_METHODS:
            return out
        for child in ast.iter_child_nodes(node):
            out |= _dynamic_names(child)
        return out
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return out
        if all(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops) \
                and isinstance(node.left, (ast.Constant, ast.JoinedStr)):
            return out
    if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
        out.add(node.id)
        return out
    for child in ast.iter_child_nodes(node):
        out |= _dynamic_names(child)
    return out


def _assigned_names(target) -> set:
    return {n.id for n in ast.walk(target)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}


def _value_bound_names(fn_node) -> set:
    """Names a function binds from computed values (calls, arithmetic,
    subscripts) — the tensors a closure of it may read."""
    out: set[str] = set()
    for node in own_body_walk(fn_node):
        if isinstance(node, ast.Assign) and isinstance(
                node.value, (ast.Call, ast.BinOp, ast.UnaryOp,
                             ast.Subscript)):
            for t in node.targets:
                out |= _assigned_names(t)
    return out


def _called_names(fn_node) -> set:
    return {n.func.id for n in own_body_walk(fn_node)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}


def _seed_taint(info, is_block: bool) -> set:
    """Tensor-valued names on entry to a captured region."""
    if info is None:
        return set()
    params = set(info.params) - info.static_params - {"self", "cls"} \
        - _STATIC_NAME_HINTS
    if is_block:
        # a block runs on its function's state: its tensor parameters
        # (not the callables it calls) and the tensors it computed
        return (params - _called_names(info.node)) \
            | _value_bound_names(info.node)
    if info.parent is not None:
        # a closure also reads the tensors its encloser computed
        params |= _value_bound_names(info.parent.node) - set(info.params)
    return params


@register_rule(
    "TL005", "tensor-branch-in-capture",
    "Python if/while/for, and/or/not and conditional expressions on a "
    "tensor inside a CUDA-graph capture or a compiled/vmapped function "
    "either fail the capture (a host read) or freeze one branch into "
    "the graph; use torch.where or make the value a host scalar")
def check_tensor_branch(ctx: FileContext):
    """Flag Python control flow on tensor values inside a capture."""
    hits = []
    for label, body, info, is_block in _regions(ctx):
        tainted = _seed_taint(info, is_block) - _STATIC_NAME_HINTS
        if not tainted:
            continue
        nodes = list(own_body_walk(body))
        nodes.sort(key=lambda n: (getattr(n, "lineno", 0),
                                  getattr(n, "col_offset", 0)))
        # one forward pass of taint propagation through plain
        # assignments; names bound to list/tuple/dict literals stay
        # Python-structured (their LENGTH is static even when their
        # elements are tensors), so iterating them is fine
        container_names: set[str] = set()
        for node in nodes:
            if isinstance(node, ast.Assign):
                if isinstance(node.value, (ast.List, ast.Tuple,
                                           ast.ListComp, ast.Dict,
                                           ast.DictComp)):
                    container_names |= _assigned_names(node.targets[0])
                elif _dynamic_names(node.value) & tainted:
                    for t in node.targets:
                        tainted |= _assigned_names(t)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                if node.value is not None \
                        and _dynamic_names(node.value) & tainted:
                    tainted |= _assigned_names(node.target)
        tainted -= container_names
        in_tests: set[int] = set()
        for node in nodes:
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                in_tests |= {id(n) for n in ast.walk(node.test)}
        for node in nodes:
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                dyn = _dynamic_names(node.test) & tainted
                if dyn:
                    kind = {ast.If: "if", ast.While: "while",
                            ast.IfExp: "conditional expression"}[type(node)]
                    hits.append((node, f"Python `{kind}` on tensor value(s) "
                                 f"{sorted(dyn)} in {label}; use "
                                 "torch.where or pass a host scalar"))
            elif isinstance(node, ast.For):
                dyn = _dynamic_names(node.iter) & tainted
                if dyn:
                    hits.append((node, "Python `for` over tensor value(s) "
                                 f"{sorted(dyn)} in {label}; iterate a "
                                 "static range or vectorize"))
            elif isinstance(node, ast.BoolOp) and id(node) not in in_tests:
                dyn = set().union(*(_dynamic_names(v)
                                    for v in node.values[:-1])) & tainted
                if dyn:
                    hits.append((node, "Python `and`/`or` on tensor "
                                 f"value(s) {sorted(dyn)} in {label} reads "
                                 "their truth on the host; use "
                                 "torch.logical_and/or"))
            elif isinstance(node, ast.UnaryOp) and \
                    isinstance(node.op, ast.Not) and \
                    id(node) not in in_tests:
                dyn = _dynamic_names(node.operand) & tainted
                if dyn:
                    hits.append((node, "Python `not` on tensor value(s) "
                                 f"{sorted(dyn)} in {label}; use "
                                 "torch.logical_not"))
    return _findings(ctx, "TL005", hits)


def _is_kernel_op(dotted: str) -> bool:
    """``repro_torch.kernels.<name>.ops.<op>`` (a batch-native op)."""
    parts = dotted.split(".")
    return (len(parts) >= 5 and parts[:2] == ["repro_torch", "kernels"]
            and parts[3] == "ops")


def _is_launch(dotted: str) -> bool:
    return dotted == "repro_torch.kernels.backend.library" \
        or dotted.endswith("backend.library")


def _reaches_kernel(info, ctx: FileContext, seen=None) -> bool:
    """Whether a function (transitively, intra-module) calls a kernel op
    or opens a kernel library (``kernels.backend.library``)."""
    if seen is None:
        seen = set()
    if id(info.node) in seen:
        return False
    seen.add(id(info.node))
    for node in own_body_walk(info.node):
        if not isinstance(node, ast.Call):
            continue
        dotted = ctx.resolve(node.func)
        if _is_kernel_op(dotted) or _is_launch(dotted):
            return True
        for callee in ctx.callables_named(node.func, info):
            if _reaches_kernel(callee, ctx, seen):
                return True
    return False


@register_rule(
    "TL006", "vmap-of-kernel-op",
    "kernels are batch-native (a leading batch lane); vmapping a "
    "repro_torch.kernels op, or a function that launches one, "
    "re-creates the per-lane launches the batch lane removed")
def check_vmap_of_kernel(ctx: FileContext):
    """Flag ``vmap`` applied to kernel ops or to functions launching one."""
    hits = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) \
                or ctx.resolve(node.func) not in _VMAPS:
            continue
        targets = node.args[:1] + [kw.value for kw in node.keywords
                                   if kw.arg == "func"]
        if not targets:
            continue
        target = targets[0]
        reason = None
        dotted = ctx.resolve(target)
        if _is_kernel_op(dotted):
            reason = f"`{dotted}` (a batch-native kernel op)"
        else:
            caller = ctx.enclosing(node)
            for info in ctx.callables_named(target, caller):
                if _reaches_kernel(info, ctx):
                    name = getattr(target, "id", None) or \
                        getattr(target, "attr", None) or "a lambda"
                    reason = (f"`{name}`, which launches a kernel"
                              if name != "a lambda"
                              else "a lambda that launches a kernel")
                    break
        if reason:
            hits.append((node, f"vmap over {reason}; kernels take a "
                         "leading batch lane natively — pass the stacked "
                         "tensor instead"))
    return _findings(ctx, "TL006", hits)
