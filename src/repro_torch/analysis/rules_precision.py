"""Precision-policy and replay-buffer rules: TL003, TL004.

TL003 enforces the contract that ONE ``PrecisionPolicy`` (trace /
accum / host dtype triple, ``repro_torch.core.precision``) owns every
dtype decision in the estimator pipeline. A raw ``torch.float32``, a
``.float()`` or an ``astype("float32")`` in that scope is the class of
silent downcast behind the reference's ``Centroid`` float32
cancellation. Scope: the reference's (its ``rules_precision.py``), moved
to the port — ``core/sampling``, ``experiments``, ``serving``,
``simcpu``, ``distributed``. ``numpy.float64`` attribute references are
exempt, as in the reference: numpy never runs on the card and float64 IS
the policy's ``host`` role.

TL004 is the port's form of the reference's donation-after-use (JL004).
A CUDA graph's replay writes into the graph's own buffers, so what a
replay returns — ``_Graph.replay``'s dict, ``_ChunkGraph.replay``'s
tuple, the logits of ``_graphed_decode``'s step — is valid only until
the graph's next replay. The rule tracks names bound to a replay's
outputs (a tuple unpacked from it; a view of them: a subscript,
``.view``/``.reshape``/``.to`` without ``copy=True``...; a container
they were appended to) and flags a read after a later replay of the
same graph in the same scope, with loop bodies walked twice and
branches as alternatives. Rebinding from ``.clone()``, ``.cpu()``,
``.numpy()`` or ``.to(..., copy=True)`` — anything but a view — makes a
name the caller's own again.

What counts as a replay: ``<g>.replay(...)`` whose result is used (a
``torch.cuda.CUDAGraph``'s replay returns None; a wrapper's returns its
captured outputs), unless ``<g>`` was built in the same scope from a
class of the module whose ``replay`` returns no captured output; and a
call of a *replaying function* of the module: one that returns, at some
tuple positions, what a replay returns, or a name it captured in a
``with torch.cuda.graph(...)`` block after calling ``.replay()``; or a
name bound to what a *factory* (a function returning a replaying
function, such as ``_graphed_decode``) returns.
"""

from __future__ import annotations

import ast

from .context import FileContext, own_body_walk
from .findings import Finding
from .registry import register_rule

__all__ = ["check_dtype_literal", "check_read_after_replay"]

_PRECISION_SCOPE = (
    "src/repro_torch/core/sampling",
    "src/repro_torch/experiments",
    "src/repro_torch/serving",
    "src/repro_torch/simcpu",
    "src/repro_torch/distributed",
)

# dotted dtype attributes that bypass PrecisionPolicy in scope; numpy
# float64 is exempt (it IS the host role — numpy never runs on the card)
_BANNED_DTYPE_ATTRS = frozenset({
    "torch.float32", "torch.float64", "torch.float16", "torch.bfloat16",
    "torch.float", "torch.half", "torch.double",
    "numpy.float32", "numpy.float16",
})
# tensor methods that cast to a fixed float dtype
_CAST_METHODS = frozenset({"float", "double", "half", "bfloat16"})
_DTYPE_STRINGS = frozenset({"float32", "float64", "float16", "bfloat16",
                            "half", "double"})


@register_rule(
    "TL003", "raw-dtype-literal",
    "float dtype literals (torch.float32/..., .float()/.double()/..., "
    "\"float32\" strings) in the estimator pipeline bypass "
    "PrecisionPolicy (core/precision.py) — the silent-downcast class of "
    "bug behind the reference's Centroid cancellation",
    scope=_PRECISION_SCOPE)
def check_dtype_literal(ctx: FileContext):
    """Flag raw float dtype literals outside ``PrecisionPolicy``."""
    hits = []
    flagged: set[int] = set()

    def flag(node, msg, at=None):
        if id(node) not in flagged:
            flagged.add(id(node))
            hits.append((at or (node.lineno, node.col_offset), msg))

    def strings(args, how):
        for arg in args:
            if isinstance(arg, ast.Constant) and arg.value in _DTYPE_STRINGS:
                flag(arg, f"raw dtype string `{how}(\"{arg.value}\")` — use "
                     "the PrecisionPolicy dtype for this role")

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Attribute):
            dotted = ctx.resolve(node)
            if dotted in _BANNED_DTYPE_ATTRS:
                flag(node, f"raw dtype literal `{dotted}` — thread a "
                     "PrecisionPolicy and use policy.trace_dtype/"
                     "accum_dtype/host_dtype instead")
        elif isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in _CAST_METHODS \
                    and not node.args and not node.keywords:
                # reported where the method name is (a chained call
                # starts lines above it)
                flag(node, f"`.{fn.attr}()` casts to a fixed float dtype — "
                     "use .to(policy.<role>_dtype)",
                     at=(fn.end_lineno, fn.end_col_offset - len(fn.attr)))
            if isinstance(fn, ast.Attribute) and fn.attr in ("astype", "to"):
                strings(node.args, fn.attr)
            if ctx.resolve(fn) in ("numpy.dtype", "torch.dtype"):
                strings(node.args, "dtype")
            for kw in node.keywords:
                if kw.arg == "dtype" and isinstance(kw.value, ast.Constant) \
                        and kw.value.value in _DTYPE_STRINGS:
                    flag(kw.value, f"raw dtype string `dtype="
                         f"\"{kw.value.value}\"` — use the "
                         "PrecisionPolicy dtype for this role")
    return [Finding(rule="TL003", path=ctx.rel, line=line, col=col,
                    message=m) for (line, col), m in hits]


# ------------------------------------------------------------------ TL004
# methods whose result shares the receiver's storage (or may: ``.to``
# without copy=True returns the receiver when nothing changes)
_VIEW_METHODS = frozenset({
    "view", "view_as", "reshape", "reshape_as", "flatten", "unflatten",
    "squeeze", "unsqueeze", "permute", "transpose", "t", "expand",
    "expand_as", "narrow", "select", "unbind", "split", "chunk",
    "movedim", "diagonal", "as_strided", "detach", "contiguous", "to",
    "type", "float", "double", "half", "bfloat16", "long", "int", "bool",
    "values", "items", "get", "T", "mT", "real", "imag", "requires_grad_",
})
# container mutators that store their argument
_STORE_METHODS = frozenset({"append", "extend", "insert"})


def _is_copy_call(node) -> bool:
    """``.to(..., copy=True)``: an explicit copy."""
    return any(kw.arg == "copy" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in node.keywords)


class _Replays:
    """The module-level facts TL004 needs: which calls replay a graph,
    and which of their results are the graph's own buffers."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        # capture-block outputs: names bound in a with torch.cuda.graph
        # block, per enclosing function; self.<attr> per class
        self.block_names: dict[int, set] = {}
        self.block_attrs: dict[str, set] = {}
        for block, info in ctx.capture_blocks:
            for sub in own_body_walk(block.body):
                targets = []
                if isinstance(sub, ast.Assign):
                    targets = sub.targets
                elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                    targets = [sub.target]
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name) and info is not None \
                                and isinstance(n.ctx, ast.Store):
                            self.block_names.setdefault(
                                id(info.node), set()).add(n.id)
                        elif isinstance(n, ast.Attribute) and \
                                isinstance(n.value, ast.Name) and \
                                n.value.id == "self" and info is not None \
                                and _owner_class(info) is not None:
                            self.block_attrs.setdefault(
                                _owner_class(info).name, set()).add(n.attr)
        # classes of the module whose replay returns no captured output
        self.plain_classes: set[str] = set()
        for name, classes in ctx.classes_by_name.items():
            for cls in classes:
                for info in ctx.methods_of(cls, "replay"):
                    if not self._returns_captured_attr(info, name):
                        self.plain_classes.add(name)
        self._bindings: dict[int, dict] = {}
        self.replaying: dict[int, object] = {}   # id(fn node) -> positions
        self.factories: set[int] = set()
        self._fixpoint()

    def _returns_captured_attr(self, info, cls_name) -> bool:
        attrs = self.block_attrs.get(cls_name, set())

        def aliases(expr) -> bool:
            if isinstance(expr, ast.Attribute) and expr.attr in attrs \
                    and isinstance(expr.value, ast.Name) \
                    and expr.value.id == "self":
                return True
            if isinstance(expr, ast.Subscript):
                return aliases(expr.value)
            if isinstance(expr, (ast.Tuple, ast.List)):
                return any(aliases(e) for e in expr.elts)
            if isinstance(expr, ast.Call) and \
                    isinstance(expr.func, ast.Attribute) and \
                    expr.func.attr in _VIEW_METHODS and \
                    not _is_copy_call(expr):
                return aliases(expr.func.value)
            return False

        return any(isinstance(sub, ast.Return) and sub.value is not None
                   and aliases(sub.value)
                   for sub in own_body_walk(info.node))

    # ------------------------------------------------ what a call replays
    def replay_of(self, call, scope_info, local_classes: dict):
        """``(graph key, positions)`` if ``call`` replays a graph and
        returns its buffers (``positions``: None for the whole value,
        else the tuple indices that are buffers); None otherwise."""
        fn = call.func
        if isinstance(fn, ast.Attribute) and fn.attr == "replay":
            key = ast.unparse(fn.value)
            if local_classes.get(key) in self.plain_classes:
                return None
            return key, None
        if isinstance(fn, ast.Name):
            for info in self.ctx.functions_by_name.get(fn.id, []):
                if id(info.node) in self.replaying:
                    return fn.id, self.replaying[id(info.node)]
            if self._bound_to_factory(fn.id, scope_info):
                return fn.id, None
        return None

    def _bound_to_factory(self, name, scope_info) -> bool:
        """Whether ``name`` is bound, in the scope or an encloser, to
        what a factory returns."""
        scopes = []
        info = scope_info
        while info is not None:
            scopes.append(info.node)
            info = info.parent
        scopes.append(self.ctx.tree)
        for scope in scopes:
            for callee in self._call_bindings(scope).get(name, ()):
                for f in self.ctx.functions_by_name.get(callee, []):
                    if id(f.node) in self.factories:
                        return True
        return False

    def _call_bindings(self, scope) -> dict:
        """``name -> {callee names}`` of ``name = callee(...)`` in a scope."""
        out = self._bindings.get(id(scope))
        if out is None:
            out = {}
            for sub in own_body_walk(scope if scope is not self.ctx.tree
                                     else scope.body):
                if isinstance(sub, ast.Assign) and \
                        isinstance(sub.value, ast.Call) and \
                        isinstance(sub.value.func, ast.Name):
                    for t in sub.targets:
                        if isinstance(t, ast.Name):
                            out.setdefault(t.id, set()).add(
                                sub.value.func.id)
            self._bindings[id(scope)] = out
        return out

    def _replay_positions(self, expr, info, bound: dict):
        """Positions of ``expr`` that are graph buffers: None = the whole
        value, a set of tuple indices, or False when none."""
        if isinstance(expr, ast.Tuple):
            pos = {i for i, e in enumerate(expr.elts)
                   if self._replay_positions(e, info, bound) is not False}
            return pos or False
        if isinstance(expr, ast.Call):
            hit = self.replay_of(expr, info, {})
            if hit is not None:
                return hit[1]
            return False
        if isinstance(expr, ast.Name) and expr.id in bound:
            return None
        return False

    def _fixpoint(self):
        ctx = self.ctx
        facts = []
        for info in ctx.functions:
            body = list(own_body_walk(info.node))
            calls_replay = any(
                isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "replay" for n in body)
            captured = set()
            owner = info
            while owner is not None:
                captured |= self.block_names.get(id(owner.node), set())
                owner = owner.parent
            returns = [info.node.body] if isinstance(info.node, ast.Lambda) \
                else [n.value for n in body
                      if isinstance(n, ast.Return) and n.value is not None]
            facts.append((info, captured if calls_replay else set(),
                          returns))
        changed = True
        while changed:
            changed = False
            for info, bound, returns in facts:
                key = id(info.node)
                for value in returns:
                    pos = self._replay_positions(value, info, bound)
                    if pos is not False and key not in self.replaying:
                        self.replaying[key] = pos
                        changed = True
                    if isinstance(value, ast.Name) and key not in \
                            self.factories:
                        for inner in ctx.functions_by_name.get(value.id, []):
                            if inner.parent is info and \
                                    id(inner.node) in self.replaying:
                                self.factories.add(key)
                                changed = True


def _owner_class(info):
    while info is not None and info.cls is None:
        info = info.parent
    return info.cls if info is not None else None


class _ReplayState:
    """Per-scope state: names aliasing a graph's buffers (live), and
    names whose graph has replayed since (stale)."""

    def __init__(self):
        self.live: dict[str, tuple] = {}     # name -> (graph key, line)
        self.stale: dict[str, tuple] = {}    # name -> (graph key, line)

    def copy(self) -> "_ReplayState":
        dup = _ReplayState()
        dup.live, dup.stale = dict(self.live), dict(self.stale)
        return dup

    def merge(self, *branches: "_ReplayState") -> None:
        for b in branches:
            self.live.update(b.live)
            self.stale.update(b.stale)
        for name in self.stale:
            self.live.pop(name, None)

    def unbind(self, names) -> None:
        for n in names:
            self.live.pop(n, None)
            self.stale.pop(n, None)


@register_rule(
    "TL004", "read-after-replay",
    "what a CUDA graph's replay returns is the graph's own buffers; a "
    "name bound to it (or to a view of it) read after the graph's next "
    "replay reads the new replay's values — clone it first")
def check_read_after_replay(ctx: FileContext):
    """Flag reads of replay outputs after the graph's next replay."""
    if "replay" not in ctx.text:
        return []
    facts = _Replays(ctx)
    findings: list[Finding] = []
    reported: set[tuple] = set()

    def alias_key(expr, state):
        """The graph whose buffers ``expr`` aliases, or None."""
        if isinstance(expr, ast.Name):
            hit = state.live.get(expr.id) or state.stale.get(expr.id)
            return hit[0] if hit else None
        if isinstance(expr, ast.Subscript):
            return alias_key(expr.value, state)
        if isinstance(expr, ast.Attribute) and expr.attr in ("T", "mT"):
            return alias_key(expr.value, state)
        if isinstance(expr, ast.Call) and \
                isinstance(expr.func, ast.Attribute) and \
                expr.func.attr in _VIEW_METHODS and not _is_copy_call(expr):
            return alias_key(expr.func.value, state)
        if isinstance(expr, (ast.Tuple, ast.List)):
            for e in expr.elts:
                k = alias_key(e, state)
                if k is not None:
                    return k
        if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) \
                and expr.func.id in ("tuple", "list", "dict") \
                and expr.args and not isinstance(
                    expr.args[0], (ast.GeneratorExp, ast.ListComp)):
            return alias_key(expr.args[0], state)
        return None

    def bind(targets, value, state, info, local_classes, line):
        names_by_pos = []
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                names_by_pos.append([
                    {n.id for n in ast.walk(e) if isinstance(n, ast.Name)}
                    for e in t.elts])
            else:
                names_by_pos.append(None)
        all_names = {n.id for t in targets for n in ast.walk(t)
                     if isinstance(n, ast.Name)
                     and isinstance(n.ctx, ast.Store)}
        state.unbind(all_names)
        hit = facts.replay_of(value, info, local_classes) \
            if isinstance(value, ast.Call) else None
        if hit is not None:
            key, positions = hit
            for t, by_pos in zip(targets, names_by_pos):
                if by_pos is None or positions is None:
                    names = {n.id for n in ast.walk(t)
                             if isinstance(n, ast.Name)}
                else:
                    names = set().union(*(by_pos[i] for i in positions
                                          if i < len(by_pos)), set())
                for n in names:
                    state.live[n] = (key, line)
            return
        key = alias_key(value, state)
        if key is not None:
            for n in all_names:
                state.live[n] = (key, line)

    def scan(stmts, state, info, local_classes):
        for stmt in stmts:
            scan_one(stmt, state, info, local_classes)

    def reads(node, state, info):
        for sub in own_body_walk([node]):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) \
                    and sub.id in state.stale:
                key, line = state.stale[sub.id]
                tag = (id(info), sub.id)      # one report a name a scope
                if tag not in reported:
                    reported.add(tag)
                    findings.append(Finding(
                        rule="TL004", path=ctx.rel, line=sub.lineno,
                        col=sub.col_offset,
                        message=f"`{sub.id}` holds the buffers of graph "
                        f"`{key}`, which replayed again at line {line}; "
                        "it now reads that replay's values — `.clone()` "
                        "it before the next replay"))
                state.stale.pop(sub.id, None)

    def replays(node, state, info, local_classes):
        for sub in own_body_walk([node]):
            if isinstance(sub, ast.Call):
                hit = facts.replay_of(sub, info, local_classes)
                if hit is None and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == "replay":
                    hit = (ast.unparse(sub.func.value), None)
                if hit is None:
                    continue
                for name, (key, _) in list(state.live.items()):
                    if key == hit[0]:
                        del state.live[name]
                        state.stale[name] = (key, sub.lineno)

    def scan_one(stmt, state, info, local_classes):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.If):
            reads(stmt.test, state, info)
            replays(stmt.test, state, info, local_classes)
            a, b = state.copy(), state.copy()
            scan(stmt.body, a, info, local_classes)
            scan(stmt.orelse, b, info, local_classes)
            state.live, state.stale = {}, {}
            state.merge(a, b)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            head = stmt.iter if not isinstance(stmt, ast.While) \
                else stmt.test
            for _pass in range(2):
                reads(head, state, info)
                replays(head, state, info, local_classes)
                if not isinstance(stmt, ast.While):
                    state.unbind({n.id for n in ast.walk(stmt.target)
                                  if isinstance(n, ast.Name)})
                scan(stmt.body, state, info, local_classes)
            scan(stmt.orelse, state, info, local_classes)
            return
        if isinstance(stmt, ast.Try):
            scan(stmt.body, state, info, local_classes)
            for handler in stmt.handlers:
                scan(handler.body, state, info, local_classes)
            scan(stmt.orelse, state, info, local_classes)
            scan(stmt.finalbody, state, info, local_classes)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                reads(item.context_expr, state, info)
            scan(stmt.body, state, info, local_classes)
            return
        value = getattr(stmt, "value", None)
        reads(stmt, state, info)
        replays(value if value is not None else stmt, state, info,
                local_classes)
        if isinstance(stmt, ast.Assign):
            if isinstance(stmt.value, ast.Call) and \
                    isinstance(stmt.value.func, ast.Name):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        local_classes[t.id] = stmt.value.func.id
            bind(stmt.targets, stmt.value, state, info, local_classes,
                 stmt.lineno)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            bind([stmt.target], stmt.value, state, info, local_classes,
                 stmt.lineno)
        elif isinstance(stmt, ast.AugAssign):
            pass                    # an in-place update keeps the alias
        elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            # a container that stores a buffer holds it from now on
            fn = stmt.value.func
            if isinstance(fn, ast.Attribute) and \
                    fn.attr in _STORE_METHODS and \
                    isinstance(fn.value, ast.Name):
                for arg in stmt.value.args:
                    key = alias_key(arg, state)
                    if key is not None:
                        state.live[fn.value.id] = (key, stmt.lineno)
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Name):
                    key = alias_key(stmt.value, state)
                    if key is not None:
                        state.live[t.value.id] = (key, stmt.lineno)

    for info in ctx.functions:
        if isinstance(info.node, ast.Lambda):
            continue
        scan(info.node.body, _ReplayState(), info, {})
    scan(ctx.tree.body, _ReplayState(), None, {})
    return findings
