"""Rule registry for the torchlint driver.

A rule is a plain function registered with :func:`register_rule`. Two
kinds exist:

* ``kind="python"`` (default) — called once per in-scope Python file
  with a :class:`~repro_torch.analysis.context.FileContext`;
  yields/returns :class:`~repro_torch.analysis.findings.Finding`s.
* ``kind="repo"`` — called once per run with the repo root path;
  used for cross-file checks (markdown link integrity).

``scope`` is a tuple of root-relative posix path prefixes the rule
applies to (``None`` = every scanned file). Scoping is part of each
rule's contract — e.g. TL003 sweeps only the estimator-pipeline
packages where ``PrecisionPolicy`` is the law, not the model zoo where
mixed-precision float32 pinning is idiomatic.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

__all__ = ["Rule", "RULES", "register_rule", "rules_for"]


@dataclasses.dataclass(frozen=True)
class Rule:
    """One registered lint rule."""

    id: str                       # "TL001"
    name: str                     # "host-sync-in-capture"
    help: str                     # one-line rationale for --list-rules
    fn: Callable
    scope: Optional[tuple]        # path prefixes, None = all files
    kind: str                     # "python" | "repo"

    def applies_to(self, rel: str) -> bool:
        """Whether a root-relative posix path is in this rule's scope."""
        if self.scope is None:
            return True
        return any(rel == p or rel.startswith(p.rstrip("/") + "/")
                   for p in self.scope)


RULES: dict[str, Rule] = {}


def register_rule(rule_id: str, name: str, help_text: str, *,
                  scope: Optional[tuple] = None,
                  kind: str = "python") -> Callable:
    """Decorator registering a rule function under ``rule_id``."""
    if kind not in ("python", "repo"):
        raise ValueError(f"unknown rule kind {kind!r}")

    def deco(fn: Callable) -> Callable:
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id}")
        RULES[rule_id] = Rule(id=rule_id, name=name, help=help_text,
                              fn=fn, scope=scope, kind=kind)
        return fn

    return deco


def rules_for(rel: str, select: Optional[set] = None) -> list[Rule]:
    """Python-file rules applying to ``rel``, optionally id-filtered."""
    return [r for r in RULES.values()
            if r.kind == "python" and r.applies_to(rel)
            and (select is None or r.id in select)]
