"""torchlint driver: discovery, rule dispatch, baseline, output, CLI.

``run_lint`` is the library surface (the fixture tests call it
in-process); ``main`` is the CLI behind ``python -m
repro_torch.analysis``.

Exit codes: 0 clean (baselined findings included), 1 active findings /
stale or unjustified baseline entries, 2 usage or parse errors.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

from .context import FileContext
from .findings import Baseline, Finding, Suppressions, fingerprint
from .registry import RULES, rules_for

__all__ = ["LintReport", "run_lint", "main", "DEFAULT_ROOTS",
           "DEFAULT_BASELINE"]

# scanned by default, relative to the repo root: the port's package and
# its card check (the port has no benchmarks/examples/scripts of its own)
DEFAULT_ROOTS = ("src/repro_torch", "chip_smoke.py")
DEFAULT_BASELINE = "lint_baseline_torch.json"


@dataclasses.dataclass
class LintReport:
    """Everything one lint run produced."""

    root: str
    files: int
    active: list        # findings failing the build
    baselined: list     # findings absorbed by lint_baseline_torch.json
    suppressed: int     # findings silenced by # torchlint: comments
    stale: list         # baseline entries matching nothing (must prune)
    errors: list        # parse/config errors (fail the build)
    duration_s: float

    @property
    def ok(self) -> bool:
        """Build verdict: no active findings, stale entries, or errors."""
        return not self.active and not self.stale and not self.errors

    def to_json(self) -> dict:
        """The machine-readable report (the reference gate's schema)."""
        def row(f: Finding, status: str) -> dict:
            return {"rule": f.rule, "path": f.path, "line": f.line,
                    "col": f.col, "message": f.message, "status": status}
        return {
            "version": 1,
            "root": self.root,
            "rules": [{"id": r.id, "name": r.name, "help": r.help}
                      for r in sorted(RULES.values(), key=lambda r: r.id)],
            "findings": ([row(f, "active") for f in self.active]
                         + [row(f, "baselined") for f in self.baselined]),
            "summary": {
                "files": self.files,
                "active": len(self.active),
                "baselined": len(self.baselined),
                "suppressed": self.suppressed,
                "stale_baseline": len(self.stale),
                "errors": list(self.errors),
                "duration_s": round(self.duration_s, 3),
                "ok": self.ok,
            },
        }


def _repo_root() -> pathlib.Path:
    # src/repro_torch/analysis/driver.py -> repo root is four levels up
    return pathlib.Path(__file__).resolve().parents[3]


def _discover(root: pathlib.Path, paths) -> list:
    """Python files to lint, as (abs_path, root-relative posix) pairs."""
    tops = [root / p for p in DEFAULT_ROOTS] if not paths \
        else [pathlib.Path(p) if pathlib.Path(p).is_absolute()
              else root / p for p in paths]
    out = []
    seen = set()
    for top in tops:
        if top.is_file():
            candidates = [top]
        elif top.is_dir():
            candidates = sorted(top.rglob("*.py"))
        else:
            continue
        for path in candidates:
            if "__pycache__" in path.parts or path in seen:
                continue
            seen.add(path)
            try:
                rel = path.resolve().relative_to(root).as_posix()
            except ValueError:
                rel = path.as_posix()
            out.append((path, rel))
    return out


def run_lint(paths=None, *, root=None, baseline_path=None, select=None,
             update_baseline: bool = False) -> LintReport:
    """Run every registered rule and reconcile against the baseline.

    ``paths`` (root-relative or absolute files/dirs) override the
    default roots; ``select`` is an iterable of rule ids to run
    exclusively; ``update_baseline`` rewrites the baseline from the
    current findings instead of failing on them.
    """
    t0 = time.time()
    root = pathlib.Path(root).resolve() if root else _repo_root()
    select_set = set(select) if select else None
    bl_path = pathlib.Path(baseline_path) if baseline_path \
        else root / DEFAULT_BASELINE

    errors: list[str] = []
    collected: list[tuple[Finding, tuple]] = []
    suppressed = 0
    files = _discover(root, paths)
    for path, rel in files:
        try:
            text = path.read_text()
            ctx = FileContext(path, rel, text)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append(f"{rel}: unparseable ({e})")
            continue
        supp = Suppressions(text)
        for rule in rules_for(rel, select_set):
            try:
                found = list(rule.fn(ctx) or [])
            except Exception as e:  # noqa: BLE001 — a crashing rule
                errors.append(f"{rel}: rule {rule.id} crashed: "
                              f"{type(e).__name__}: {e}")
                continue
            for f in found:
                if supp.covers(f):
                    suppressed += 1
                else:
                    collected.append((f, fingerprint(f, ctx.lines)))

    # repo-level rules run once (markdown link integrity)
    if paths is None:
        for rule in RULES.values():
            if rule.kind != "repo" or \
                    (select_set is not None and rule.id not in select_set):
                continue
            try:
                for f in rule.fn(root) or []:
                    collected.append((f, (f.rule, f.path, "")))
            except Exception as e:  # noqa: BLE001
                errors.append(f"rule {rule.id} crashed: "
                              f"{type(e).__name__}: {e}")

    baseline = Baseline(bl_path if bl_path.exists() else None)
    errors.extend(baseline.errors)
    if update_baseline:
        Baseline.write(bl_path, collected, baseline.entries)
        active, baselined, stale = [], [f for f, _ in collected], []
    else:
        active, baselined, stale = baseline.partition(collected)

    active.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintReport(root=str(root), files=len(files), active=active,
                      baselined=baselined, suppressed=suppressed,
                      stale=stale, errors=errors,
                      duration_s=time.time() - t0)


def main(argv=None) -> int:
    """CLI entry for ``python -m repro_torch.analysis``."""
    ap = argparse.ArgumentParser(
        prog="torchlint",
        description="static analysis of the PyTorch port: capture "
        "hygiene, PRNG discipline, replay-buffer safety, precision-policy "
        "conformance, and the api/docstring/doc-link gates")
    ap.add_argument("paths", nargs="*",
                    help="files or directories (default: "
                    f"{', '.join(DEFAULT_ROOTS)})")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help=f"baseline file (default {DEFAULT_BASELINE} at "
                    "the repo root)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings "
                    "(preserving existing justifications)")
    ap.add_argument("--select", default=None, metavar="IDS",
                    help="comma-separated rule ids to run exclusively")
    ap.add_argument("--root", default=None, metavar="DIR",
                    help="treat DIR as the repo root (testing)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in sorted(RULES.values(), key=lambda r: r.id):
            scope = "all files" if rule.scope is None \
                else ", ".join(rule.scope)
            print(f"{rule.id} {rule.name}\n    {rule.help}\n"
                  f"    scope: {scope}")
        return 0

    select = [s.strip() for s in args.select.split(",")] \
        if args.select else None
    if select:
        unknown = [s for s in select if s not in RULES]
        if unknown:
            print(f"torchlint: unknown rule id(s): {', '.join(unknown)}; "
                  f"known: {', '.join(sorted(RULES))}", file=sys.stderr)
            return 2

    report = run_lint(args.paths or None, root=args.root,
                      baseline_path=args.baseline, select=select,
                      update_baseline=args.update_baseline)

    if args.json:
        print(json.dumps(report.to_json(), indent=2))
    else:
        for f in report.active:
            print(f.render())
        for entry in report.stale:
            print(f"{entry.get('path')}: stale baseline entry "
                  f"({entry.get('rule')}: {str(entry.get('code'))[:60]!r}) "
                  "— the finding is gone, prune it from the baseline")
        for e in report.errors:
            print(f"error: {e}")
        print(f"torchlint: {report.files} files, {len(RULES)} rules, "
              f"{len(report.active)} finding(s), "
              f"{len(report.baselined)} baselined, "
              f"{report.suppressed} suppressed, "
              f"{len(report.stale)} stale baseline entr(ies) "
              f"[{report.duration_s:.2f}s]")
    if report.errors:
        return 2 if not report.active else 1
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
