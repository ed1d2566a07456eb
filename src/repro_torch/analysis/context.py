"""Per-file analysis context shared by the rule packs.

One :class:`FileContext` per linted Python file carries the parsed
tree plus lazily computed, cached analyses the torch-discipline rules
need:

* **import resolution** — a map from local names to the dotted origin
  they were imported from (``F`` → ``torch.nn.functional``, relative
  imports resolved against the module's package), and :meth:`resolve`
  turning a ``Name``/``Attribute`` chain into a dotted path through that
  map;
* **function index** — every ``def``/``lambda`` with its parameters,
  the class it is a method of, and its host-scalar parameters (those
  annotated ``int``/``float``/``bool``/``str``, which a capture freezes
  as Python values);
* **capture reachability** — the counterpart of the reference's traced
  reachability: the code recorded into a CUDA graph or handed to a
  tracer, which is what "inside a capture" means to TL001/TL005.

A function or block is inside a capture when

(a) it is the body of a ``with torch.cuda.graph(...)`` block
    (:attr:`FileContext.capture_blocks`);
(b) it is decorated with, or passed to, one of :data:`CAPTURE_WRAPPERS`
    (``torch.compile``, ``torch.cuda.make_graphed_callables``,
    ``torch.vmap``, ``torch.func.vmap``);
(c) it is called, transitively, from (a) or (b) in the same module — by
    name, or as ``self.<method>`` of the caller's class;
(d) it is passed to a *capture wrapper* of the same module: a function
    or class whose capture block calls one of its own parameters
    (``fused._Graph(traced, ...)``, ``montecarlo._ChunkGraph(step,
    ...)``). The callable at that position — a name, a lambda or
    ``self.<method>`` — is captured.

Everything is intra-module by design: a dependency-free ``ast`` pass
cannot see across imports. A bare name matches every function of the
module with that name, as in the reference, so a name shared by two
functions may mark both; the fixture suite pins the patterns the
analysis must catch. What it cannot see: ``serving/batcher.py`` builds
``fused._Graph`` from another module, so the callable it passes is not
known to be captured there; ``launch/serve.py``'s ``_graphed_decode``
captures ``dfn``, the result of ``decode_fn(cfg)``, a callable returned
by a call rather than defined in the module. ``torch.utils.checkpoint``
is not a capture: it re-runs its function eagerly.
"""

from __future__ import annotations

import ast
import pathlib
from functools import cached_property

__all__ = ["FileContext", "FunctionInfo", "CAPTURE_WRAPPERS",
           "CAPTURE_CONTEXTS", "own_body_walk"]

# dotted names (post import-resolution) that capture or trace the
# function they are given; bare-name imports resolve to these through
# the import map
CAPTURE_WRAPPERS = frozenset({
    "torch.compile",
    "torch.cuda.make_graphed_callables",
    "torch.cuda.graphs.make_graphed_callables",
    "torch.vmap", "torch.func.vmap",
})
# context managers whose body is recorded into a CUDA graph
CAPTURE_CONTEXTS = frozenset({"torch.cuda.graph", "torch.cuda.graphs.graph"})
# annotations naming host scalars: a capture freezes such a parameter as
# a Python value, so branching on it is capture-time specialization
_HOST_ANNOTATIONS = frozenset({"int", "float", "bool", "str", "bytes"})


def own_body_walk(node):
    """Walk a function body or block WITHOUT descending into nested defs
    (nested functions are analyzed separately if reachable)."""
    stack = list(node) if isinstance(node, list) \
        else list(ast.iter_child_nodes(node))
    while stack:
        sub = stack.pop()
        yield sub
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(sub))


class FunctionInfo:
    """Static facts about one function definition (or lambda)."""

    def __init__(self, node, qualname: str, parent, cls=None):
        self.node = node
        self.qualname = qualname
        self.parent = parent          # enclosing FunctionInfo or None
        self.cls = cls                # ClassDef it is a method of, or None
        args = node.args
        self.positional = [a.arg for a in (args.posonlyargs + args.args)]
        self.params = self.positional + [a.arg for a in args.kwonlyargs]
        if args.vararg:
            self.params.append(args.vararg.arg)
        if args.kwarg:
            self.params.append(args.kwarg.arg)
        self.static_params: set[str] = {
            a.arg for a in (args.posonlyargs + args.args + args.kwonlyargs)
            if _is_host_annotation(a.annotation)}

    @property
    def name(self) -> str:
        """Bare function name (``<lambda>`` for lambdas)."""
        return getattr(self.node, "name", "<lambda>")

    @property
    def body(self) -> list:
        """The statements of the body (a lambda's expression wrapped)."""
        if isinstance(self.node, ast.Lambda):
            return [ast.Expr(value=self.node.body)]
        return self.node.body

    def call_offset(self) -> int:
        """Arguments a call supplies before the first parameter: 1 for
        ``self``/``cls`` of a method called on an object or class."""
        if self.cls is not None and self.positional \
                and self.positional[0] in ("self", "cls"):
            return 1
        return 0


def _is_host_annotation(ann) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value in _HOST_ANNOTATIONS
    return isinstance(ann, ast.Name) and ann.id in _HOST_ANNOTATIONS


class FileContext:
    """Parsed file + cached shared analyses handed to every rule."""

    def __init__(self, path: pathlib.Path, rel: str, text: str):
        self.path = path
        self.rel = rel                  # root-relative posix path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=str(path))
        self.module = self._module_name(rel)

    @staticmethod
    def _module_name(rel: str) -> str:
        parts = pathlib.PurePosixPath(rel).with_suffix("").parts
        if "src" in parts:
            parts = parts[parts.index("src") + 1:]
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    @property
    def _is_package(self) -> bool:
        return pathlib.PurePosixPath(self.rel).stem == "__init__"

    # ------------------------------------------------------------ imports
    def _from_base(self, node: ast.ImportFrom) -> str:
        """The absolute module a ``from ... import`` statement names."""
        if not node.level:
            return node.module or ""
        parts = self.module.split(".") if self.module else []
        if not self._is_package:
            parts = parts[:-1]
        base = ".".join(parts[:len(parts) - (node.level - 1)])
        if node.module:
            base = f"{base}.{node.module}" if base else node.module
        return base

    @cached_property
    def imports(self) -> dict:
        """Local name -> dotted origin, for every import in the file."""
        out: dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        out[alias.asname] = alias.name
                    else:
                        head = alias.name.split(".")[0]
                        out[head] = head
            elif isinstance(node, ast.ImportFrom):
                base = self._from_base(node)
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    out[local] = f"{base}.{alias.name}" if base else alias.name
        return out

    @cached_property
    def imported_modules(self) -> list:
        """``(dotted module, line)`` of every import statement, relative
        ones resolved: what each ``import`` and each ``from`` names."""
        out = []
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                out.extend((alias.name, node.lineno) for alias in node.names)
            elif isinstance(node, ast.ImportFrom):
                out.append((self._from_base(node), node.lineno))
        return out

    def resolve(self, node) -> str:
        """Dotted path of a Name/Attribute chain through the import map.

        Unresolvable roots keep their raw name (``x.item`` stays
        ``x.item``), so callers can still match on suffixes. Returns
        ``""`` for non-chain expressions.
        """
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return ""
        root = self.imports.get(node.id, node.id)
        parts.append(root)
        return ".".join(reversed(parts))

    def is_capture_wrapper(self, node) -> bool:
        """Whether an expression names a ``torch.compile``/``vmap``-style
        capturer."""
        return self.resolve(node) in CAPTURE_WRAPPERS

    def is_capture_context(self, node) -> bool:
        """Whether a ``with`` item opens a CUDA-graph capture."""
        return isinstance(node, ast.Call) \
            and self.resolve(node.func) in CAPTURE_CONTEXTS

    # ---------------------------------------------------------- functions
    @cached_property
    def functions(self) -> list:
        """Every function/lambda in the file as :class:`FunctionInfo`."""
        infos: list[FunctionInfo] = []

        def visit(node, qual, parent, cls):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    info = FunctionInfo(child, f"{qual}{child.name}", parent,
                                        cls)
                    infos.append(info)
                    visit(child, f"{qual}{child.name}.", info, None)
                elif isinstance(child, ast.Lambda):
                    info = FunctionInfo(child, f"{qual}<lambda>", parent)
                    infos.append(info)
                    visit(child, f"{qual}<lambda>.", info, None)
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{qual}{child.name}.", parent, child)
                else:
                    visit(child, qual, parent, cls)

        visit(self.tree, "", None, None)
        return infos

    @cached_property
    def functions_by_name(self) -> dict:
        """Bare name -> list[FunctionInfo] (conservative, module-wide)."""
        out: dict[str, list] = {}
        for info in self.functions:
            out.setdefault(info.name, []).append(info)
        return out

    @cached_property
    def _info_by_node(self) -> dict:
        return {id(info.node): info for info in self.functions}

    @cached_property
    def classes_by_name(self) -> dict:
        """Bare class name -> list[ClassDef] in the module."""
        out: dict[str, list] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                out.setdefault(node.name, []).append(node)
        return out

    def methods_of(self, cls, name: str) -> list:
        """The methods called ``name`` defined directly in ``cls``."""
        return [info for info in self.functions_by_name.get(name, [])
                if info.cls is cls]

    def enclosing(self, node):
        """The innermost :class:`FunctionInfo` whose body holds ``node``."""
        return self._enclosing_map.get(id(node))

    @cached_property
    def _enclosing_map(self) -> dict:
        out: dict[int, FunctionInfo] = {}
        for info in self.functions:
            for sub in own_body_walk(info.node):
                out[id(sub)] = info
        return out

    def callables_named(self, node, caller) -> list:
        """Module functions an expression names: a bare name (every
        function of that name), a lambda, or ``self.<m>``/``cls.<m>``
        (the methods ``m`` of the caller's class)."""
        if isinstance(node, ast.Lambda):
            info = self._info_by_node.get(id(node))
            return [info] if info is not None else []
        if isinstance(node, ast.Name):
            return list(self.functions_by_name.get(node.id, []))
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id in ("self", "cls"):
            owner = caller
            while owner is not None and owner.cls is None:
                owner = owner.parent
            if owner is not None:
                return self.methods_of(owner.cls, node.attr)
        return []

    # ---------------------------------------------------------- captures
    @cached_property
    def capture_blocks(self) -> list:
        """``(with node, enclosing FunctionInfo or None)`` of every
        ``with torch.cuda.graph(...)`` block."""
        out = []
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                    self.is_capture_context(item.context_expr)
                    for item in node.items):
                out.append((node, self.enclosing(node)))
        return out

    @cached_property
    def capture_wrappers(self) -> dict:
        """Callee name -> set of argument positions (and keyword names)
        it captures: the functions and classes whose capture block calls
        one of their own parameters."""
        out: dict[str, set] = {}
        for block, info in self.capture_blocks:
            if info is None:
                continue
            for sub in own_body_walk(block.body):
                if not (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Name)
                        and sub.func.id in info.params):
                    continue
                param = sub.func.id
                if info.cls is not None and info.name == "__init__":
                    callee = info.cls.name
                else:
                    callee = info.name
                slots = out.setdefault(callee, set())
                slots.add(param)
                if param in info.positional:
                    slots.add(info.positional.index(param)
                              - info.call_offset())
        return out

    def _wrapper_args(self, call: ast.Call) -> list:
        """Arguments a call hands to a capture wrapper's captured slots."""
        fn = call.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None)
        slots = self.capture_wrappers.get(name)
        if not slots:
            return []
        out = [a for i, a in enumerate(call.args) if i in slots]
        out += [kw.value for kw in call.keywords if kw.arg in slots]
        return out

    @cached_property
    def captured_functions(self) -> list:
        """Functions inside a capture (rules (b)-(d) of the module
        docstring, closed over intra-module calls)."""
        captured: set[int] = set()
        infos = self._info_by_node

        def mark(node, caller):
            for info in self.callables_named(node, caller):
                captured.add(id(info.node))

        for info in self.functions:
            for deco in getattr(info.node, "decorator_list", []):
                target = deco.func if isinstance(deco, ast.Call) else deco
                if self.is_capture_wrapper(target):
                    captured.add(id(info.node))
                elif (isinstance(deco, ast.Call)
                      and self.resolve(deco.func) in ("functools.partial",
                                                      "partial")
                      and deco.args
                      and self.is_capture_wrapper(deco.args[0])):
                    captured.add(id(info.node))

        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            args = self._wrapper_args(node)
            if self.is_capture_wrapper(node.func):
                args += list(node.args) + [kw.value for kw in node.keywords]
            for arg in args:
                mark(arg, self.enclosing(node))

        def calls_from(stmts, caller):
            for sub in own_body_walk(stmts):
                if isinstance(sub, ast.Call):
                    yield from self.callables_named(sub.func, caller)
                elif isinstance(sub, ast.Lambda):
                    yield from self.callables_named(sub, caller)

        for block, info in self.capture_blocks:
            for callee in calls_from(block.body, info):
                captured.add(id(callee.node))

        todo = list(captured)
        while todo:
            info = infos[todo.pop()]
            for callee in calls_from(info.node, info):
                if id(callee.node) not in captured:
                    captured.add(id(callee.node))
                    todo.append(id(callee.node))
        return [info for info in self.functions if id(info.node) in captured]
