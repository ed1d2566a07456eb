"""Repo-contract rules: TL100 api-surface, TL101 missing-docstring,
TL102 broken-doc-link.

The reference's JL100-JL102 with their scopes moved to the port's
package (``src/repro_torch/...``). TL100 asks for ``__all__`` on every
module of the sampling/experiment/serving/analysis surface and forbids
scheme/policy string-literal and ``isinstance`` dispatch on the
sampling-plan types outside ``core/sampling/plan.py``: branching on
``isinstance(x, Stratifier)`` (or a concrete plan type) re-creates
closed-world dispatch that every registry plug-in would silently fall
through. TL101 asks for module and public docstrings on the
experiment/kernel/serving/analysis surface. TL102 checks that every
relative markdown link of ``README.md`` and ``docs/*.md`` resolves, as
JL102 does (the two gates share those files).
"""

from __future__ import annotations

import ast
import pathlib
import re

from .context import FileContext
from .findings import Finding
from .registry import register_rule

__all__ = ["check_api_surface", "check_docstrings", "check_doc_links"]

_API_SCOPE = ("src/repro_torch/core/sampling", "src/repro_torch/experiments",
              "src/repro_torch/serving", "src/repro_torch/analysis")
_DOCSTRING_SCOPE = ("src/repro_torch/experiments", "src/repro_torch/kernels",
                    "src/repro_torch/serving", "src/repro_torch/analysis")

# scheme/policy names the pre-plan engine dispatched on;
# comparisons against them outside plan.py are re-grown string dispatch
_DISPATCH_LITERALS = frozenset(
    {"bbv", "rfv", "dg", "centroid", "mean", "random"})

# sampling-plan types; isinstance chains on them outside plan.py bypass
# the registry (base protocols AND the concrete built-ins)
_PLAN_TYPES = frozenset({
    "Stratifier", "SelectionPolicy", "Estimator",
    "BBVClusters", "RFVClusters", "DaleniusGurney",
    "Centroid", "StratumMean", "RandomUnit", "RankedSetUnit",
    "WeightedPoint", "CollapsedPairsCI", "TwoPhaseCI",
})
_PLAN_MODULE = "src/repro_torch/core/sampling/plan.py"


def _literal_strs(node):
    """String constants inside a comparator (descending into tuples &c)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        yield node.value
    elif isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        for elt in node.elts:
            yield from _literal_strs(elt)


def _type_names(node):
    """Bare/dotted type names in an isinstance second argument."""
    if isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _type_names(elt)
    elif isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, ast.Attribute):
        yield node.attr
    elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        yield from _type_names(node.left)
        yield from _type_names(node.right)


@register_rule(
    "TL100", "api-surface",
    "__all__ on every public module; no scheme/policy string-literal "
    "or isinstance dispatch outside the sampling-plan registry",
    scope=_API_SCOPE)
def check_api_surface(ctx: FileContext):
    """``__all__`` on every module, plus the string- and isinstance-
    dispatch registry guard."""
    findings: list[Finding] = []

    def declares_all(node) -> bool:
        if isinstance(node, ast.Assign):
            return any(isinstance(t, ast.Name) and t.id == "__all__"
                       for t in node.targets)
        if isinstance(node, ast.AnnAssign):
            return isinstance(node.target, ast.Name) \
                and node.target.id == "__all__"
        return False

    has_all = any(declares_all(node) for node in ctx.tree.body)
    if not has_all:
        findings.append(Finding(
            rule="TL100", path=ctx.rel, line=1, col=0,
            message="module does not declare __all__ — the public import "
            "contract must be explicit"))

    is_plan = ctx.rel == _PLAN_MODULE
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Compare) and not is_plan:
            hit = sorted(
                s for operand in (node.left, *node.comparators)
                for s in _literal_strs(operand) if s in _DISPATCH_LITERALS)
            if hit:
                findings.append(Finding(
                    rule="TL100", path=ctx.rel, line=node.lineno,
                    col=node.col_offset,
                    message=f"scheme/policy string-literal dispatch on "
                    f"{hit} — route through the sampling-plan registry "
                    "(repro_torch.core.sampling.plan) instead"))
        elif (isinstance(node, ast.Call) and not is_plan
                and isinstance(node.func, ast.Name)
                and node.func.id == "isinstance" and len(node.args) == 2):
            hit = sorted(set(_type_names(node.args[1])) & _PLAN_TYPES)
            if hit:
                findings.append(Finding(
                    rule="TL100", path=ctx.rel, line=node.lineno,
                    col=node.col_offset,
                    message=f"isinstance dispatch on plan type(s) {hit} "
                    "outside plan.py bypasses the registry — registry "
                    "plug-ins would fall through; dispatch on registered "
                    "behavior (methods/attributes) instead"))
    return findings


def _is_public(name: str) -> bool:
    return not name.startswith("_")


@register_rule(
    "TL101", "missing-docstring",
    "module + public class/function docstrings on the documented "
    "experiment/kernel/serving surface (pydocstyle-lite)",
    scope=_DOCSTRING_SCOPE)
def check_docstrings(ctx: FileContext):
    """Module and public class/function docstrings."""
    findings: list[Finding] = []
    if ast.get_docstring(ctx.tree) is None:
        findings.append(Finding(rule="TL101", path=ctx.rel, line=1, col=0,
                                message="missing module docstring"))

    def visit(body, qual):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _is_public(node.name) and ast.get_docstring(node) is None:
                    findings.append(Finding(
                        rule="TL101", path=ctx.rel, line=node.lineno,
                        col=node.col_offset,
                        message=f"missing docstring on function "
                        f"{qual}{node.name}"))
            elif isinstance(node, ast.ClassDef):
                if _is_public(node.name):
                    if ast.get_docstring(node) is None:
                        findings.append(Finding(
                            rule="TL101", path=ctx.rel, line=node.lineno,
                            col=node.col_offset,
                            message=f"missing docstring on class "
                            f"{qual}{node.name}"))
                    visit(node.body, f"{qual}{node.name}.")

    visit(ctx.tree.body, "")
    return findings


_LINK_RE = re.compile(r"\[[^\]]*\]\(([^)\s]+)\)")
_HEADING_RE = re.compile(r"^#{1,6}\s+(.*)$", re.MULTILINE)


def _slug(heading: str) -> str:
    """GitHub-style anchor slug for a heading line."""
    text = re.sub(r"[`*_]", "", heading.strip().lower())
    text = re.sub(r"[^\w\- ]", "", text)
    return text.replace(" ", "-")


def _anchors(md: pathlib.Path) -> set:
    return {_slug(h) for h in _HEADING_RE.findall(md.read_text())}


@register_rule(
    "TL102", "broken-doc-link",
    "every relative markdown link in README.md/docs/ resolves, and "
    "#anchors match a heading in the target (offline lychee-lite)",
    kind="repo")
def check_doc_links(root: pathlib.Path):
    """Relative markdown links and their anchors resolve."""
    findings: list[Finding] = []
    files = [root / "README.md", *sorted((root / "docs").glob("*.md"))]
    for md in files:
        if not md.exists():
            continue
        rel = md.relative_to(root).as_posix()
        for lineno, line in enumerate(md.read_text().splitlines(), start=1):
            for target in _LINK_RE.findall(line):
                if target.startswith(("http://", "https://", "mailto:")):
                    continue
                path_part, _, fragment = target.partition("#")
                dest = (md.parent / path_part).resolve() if path_part else md
                if path_part and not dest.exists():
                    findings.append(Finding(
                        rule="TL102", path=rel, line=lineno, col=0,
                        message=f"broken link -> {target}"))
                    continue
                if fragment and dest.suffix == ".md":
                    if fragment not in _anchors(dest):
                        findings.append(Finding(
                            rule="TL102", path=rel, line=lineno, col=0,
                            message=f"missing anchor #{fragment} in "
                            f"{path_part or md.name}"))
    return findings
