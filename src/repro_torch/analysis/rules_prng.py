"""PRNG-discipline rule: TL002 prng-key-reuse.

The port's keys (``repro_torch.prng``, a bit-exact threefry2x32) carry
the reference's contract: every key is consumed exactly once. The
trial engine's block ``b`` of app ``a`` draws from
``fold_in(fold_in(trial_key, b), a)``, a pure function of the (seed,
block, app) coordinates. A key fed to two draws produces *correlated*
samples — the two-phase estimator's variance math silently assumes
independence, so reuse biases the confidence intervals no unit test
will catch.

The check is the reference's order-aware walk of each function body: a
key consumed by a draw is poisoned until reassigned (typically via
``split``/``fold_in``, which only *derive* and never consume).
``if``/``else`` branches are alternatives — the same key drawn in both
arms is fine — so each arm starts from a snapshot and the merged state
is the conservative union. Loop bodies are processed twice: a draw from
a loop-invariant key is reuse on the second iteration even though a
single linear pass never sees it twice. Keys are tracked as names,
dotted chains and subscripts of them (``keys[:, 0]``, the port's stacked
lanes); rebinding any name a key expression reads frees it.
"""

from __future__ import annotations

import ast

from .context import FileContext
from .findings import Finding
from .registry import register_rule

__all__ = ["check_key_reuse", "DRAWS", "DERIVES", "PRNG_MODULE"]

PRNG_MODULE = "repro_torch.prng"
# repro_torch.prng functions that CONSUME their key argument (every
# function of prng.py that takes a key and returns values drawn from it)
DRAWS = frozenset({"bits", "uniform", "randint", "choice", "normal",
                   "normal_uniforms"})
# repro_torch.prng functions that DERIVE new keys without consuming
DERIVES = frozenset({"split", "split_chain", "fold_in"})


def _key_expr(node) -> tuple:
    """``(text, names read)`` for a key argument: a Name, a dotted chain
    or a subscript of one; ``("", ())`` otherwise."""
    base = node
    while isinstance(base, ast.Subscript):
        base = base.value
    chain = []
    while isinstance(base, ast.Attribute):
        chain.append(base.attr)
        base = base.value
    if not isinstance(base, ast.Name):
        return "", ()
    names = {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
    return ast.unparse(node), tuple(sorted(names))


class _KeyState:
    """Keys consumed so far, mapping to the draw that consumed them."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.consumed: dict[str, tuple] = {}    # text -> (call, names)
        self.findings: list[Finding] = []
        self._reported: set[int] = set()

    def copy(self) -> "_KeyState":
        dup = _KeyState(self.ctx)
        dup.consumed = dict(self.consumed)
        dup.findings = self.findings          # shared sink
        dup._reported = self._reported        # shared dedupe
        return dup

    def merge(self, *branches: "_KeyState") -> None:
        for b in branches:
            self.consumed.update(b.consumed)

    def reset(self, names) -> None:
        names = set(names)
        for key, (_, read) in list(self.consumed.items()):
            if key in names or names & set(read):
                del self.consumed[key]

    def draw(self, call: ast.Call, fn_name: str) -> None:
        if not call.args:
            return
        key, names = _key_expr(call.args[0])
        if not key:
            return
        prior = self.consumed.get(key)
        if prior is not None and id(call) not in self._reported:
            self._reported.add(id(call))
            self.findings.append(Finding(
                rule="TL002", path=self.ctx.rel, line=call.lineno,
                col=call.col_offset,
                message=f"PRNG key `{key}` already consumed by a "
                f"`prng.*` draw at line {prior[0].lineno}; draws from the "
                f"same key are correlated — `split`/`fold_in` before "
                f"`{fn_name}`"))
        self.consumed[key] = (call, names)


def _draw_name(call: ast.Call, ctx: FileContext) -> str:
    """The prng draw a call makes, or ``""``."""
    dotted = ctx.resolve(call.func)
    head, _, last = dotted.rpartition(".")
    if last not in DRAWS:
        return ""
    if head == PRNG_MODULE:
        return last
    # inside prng.py the draws call each other by bare name
    if not head and ctx.module == PRNG_MODULE:
        return last
    return ""


def _scan_expr(node, state: _KeyState) -> None:
    """Visit draw calls inside one expression, in walk order."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            name = _draw_name(sub, state.ctx)
            if name:
                state.draw(sub, name)


def _scan_stmts(stmts, state: _KeyState) -> None:
    for stmt in stmts:
        _scan_one(stmt, state)


def _scan_one(stmt, state: _KeyState) -> None:
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                         ast.ClassDef)):
        return                      # nested scopes are scanned separately
    if isinstance(stmt, ast.If):
        _scan_expr(stmt.test, state)
        then_state, else_state = state.copy(), state.copy()
        _scan_stmts(stmt.body, then_state)
        _scan_stmts(stmt.orelse, else_state)
        state.merge(then_state, else_state)
        return
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        _scan_expr(stmt.iter, state)
        loop_targets = {n.id for n in ast.walk(stmt.target)
                        if isinstance(n, ast.Name)}
        for _pass in range(2):      # 2nd pass: loop-invariant key reuse
            state.reset(loop_targets)
            _scan_stmts(stmt.body, state)
        _scan_stmts(stmt.orelse, state)
        return
    if isinstance(stmt, ast.While):
        _scan_expr(stmt.test, state)
        for _pass in range(2):
            _scan_stmts(stmt.body, state)
        _scan_stmts(stmt.orelse, state)
        return
    if isinstance(stmt, ast.Try):
        _scan_stmts(stmt.body, state)
        for handler in stmt.handlers:
            _scan_stmts(handler.body, state)
        _scan_stmts(stmt.orelse, state)
        _scan_stmts(stmt.finalbody, state)
        return
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        for item in stmt.items:
            _scan_expr(item.context_expr, state)
        _scan_stmts(stmt.body, state)
        return
    # plain statement: draws first (value side), then reassignment resets
    _scan_expr(stmt, state)
    targets = []
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.Delete):
        targets = stmt.targets
    reset = set()
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                reset.add(n.id)
            elif isinstance(n, (ast.Attribute, ast.Subscript)):
                key, _ = _key_expr(n)
                if key:
                    reset.add(key)
    # walrus assignments anywhere in the statement also rebind
    for n in ast.walk(stmt):
        if isinstance(n, ast.NamedExpr) and isinstance(n.target, ast.Name):
            reset.add(n.target.id)
    state.reset(reset)


@register_rule(
    "TL002", "prng-key-reuse",
    "a repro_torch.prng key consumed by two draws without an "
    "intervening split/fold_in yields correlated samples and biases the "
    "two-phase CI math")
def check_key_reuse(ctx: FileContext):
    """Flag PRNG keys consumed by more than one ``repro_torch.prng`` draw."""
    if ctx.module != PRNG_MODULE and not any(
            origin == PRNG_MODULE or origin.startswith(PRNG_MODULE + ".")
            for origin in ctx.imports.values()):
        return []
    findings: list[Finding] = []
    # module body counts as a scope too (driver scripts)
    scopes = [ctx.tree.body] + [info.body for info in ctx.functions]
    for body in scopes:
        state = _KeyState(ctx)
        state.findings = findings
        _scan_stmts(body, state)
    return findings
