"""Finding records, suppression comments, and the grandfathering baseline.

A finding is identified for baseline purposes by its *fingerprint*:
``(rule, path, stripped source line)``. Line numbers drift with every
edit, but the offending line's text only changes when the finding
itself changes, so a committed ``lint_baseline_torch.json`` survives
unrelated refactors while any NEW violation (even in a heavily
baselined file) still fails the build.

Suppression comments are the in-code alternative for findings whose
justification belongs next to the code:

* ``# torchlint: disable=TL003`` (same line, comma-separated ids) —
  suppresses those rules on that one line;
* ``# torchlint: disable-file=TL003`` (its own line, anywhere) —
  suppresses the rule for the whole file.

Baseline entries MUST carry a non-empty ``justification``; stale
entries (no longer matching any finding) fail the lint so the ledger
never rots. The schema (version 1) is the reference gate's, so this
``Baseline`` reads ``lint_baseline.json`` as well.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
from collections import Counter

__all__ = ["Finding", "Suppressions", "Baseline", "fingerprint"]

_SUPPRESS_RE = re.compile(
    r"#\s*torchlint:\s*disable(?P<file>-file)?\s*=\s*"
    r"(?P<rules>[A-Z]{2}\d{3}(?:\s*,\s*[A-Z]{2}\d{3})*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint violation at a source location."""

    rule: str       # "TL001"
    path: str       # repo-root-relative posix path
    line: int       # 1-based
    col: int        # 0-based
    message: str

    def render(self) -> str:
        """Human one-liner, ``path:line:col: RULE message``."""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def fingerprint(finding: Finding, source_lines: list[str]) -> tuple:
    """Line-content fingerprint used for baseline matching."""
    idx = finding.line - 1
    code = source_lines[idx].strip() if 0 <= idx < len(source_lines) else ""
    return (finding.rule, finding.path, code)


class Suppressions:
    """Per-file suppression state parsed from ``# torchlint:`` comments."""

    def __init__(self, text: str):
        self.line_rules: dict[int, set[str]] = {}
        self.file_rules: set[str] = set()
        for lineno, line in enumerate(text.splitlines(), start=1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            rules = {r.strip() for r in m.group("rules").split(",")}
            if m.group("file"):
                self.file_rules |= rules
            else:
                self.line_rules.setdefault(lineno, set()).update(rules)

    def covers(self, finding: Finding) -> bool:
        """Whether this finding is suppressed in-code."""
        if finding.rule in self.file_rules:
            return True
        return finding.rule in self.line_rules.get(finding.line, set())


class Baseline:
    """The committed grandfathered-findings ledger
    (``lint_baseline_torch.json``).

    Matching is a multiset draw on fingerprints: each entry absorbs at
    most one finding with the same ``(rule, path, code)``, so adding a
    second identical violation to an already-baselined line count still
    fails.
    """

    def __init__(self, path: pathlib.Path | None):
        self.path = path
        self.entries: list[dict] = []
        self.errors: list[str] = []
        if path is not None and path.exists():
            try:
                payload = json.loads(path.read_text())
            except json.JSONDecodeError as e:
                self.errors.append(f"{path.name}: invalid JSON ({e})")
                payload = {}
            self.entries = list(payload.get("entries", []))
        for i, entry in enumerate(self.entries):
            if not str(entry.get("justification", "")).strip():
                self.errors.append(
                    f"{path.name}: entry {i} ({entry.get('rule')} "
                    f"{entry.get('path')}) has no justification — every "
                    "baselined finding must say why it is unavoidable")

    @staticmethod
    def _key(entry: dict) -> tuple:
        return (entry.get("rule"), entry.get("path"),
                str(entry.get("code", "")).strip())

    def partition(self, findings_with_fp: list[tuple[Finding, tuple]]
                  ) -> tuple[list[Finding], list[Finding], list[dict]]:
        """Split findings into (active, baselined) and return stale entries."""
        budget = Counter(self._key(e) for e in self.entries)
        active: list[Finding] = []
        baselined: list[Finding] = []
        for finding, fp in findings_with_fp:
            if budget.get(fp, 0) > 0:
                budget[fp] -= 1
                baselined.append(finding)
            else:
                active.append(finding)
        # whatever budget is left after the draw corresponds to entries
        # no finding matched — they are stale and must be pruned
        stale: list[dict] = []
        for e in self.entries:
            key = self._key(e)
            if budget.get(key, 0) > 0:
                budget[key] -= 1
                stale.append(e)
        return active, baselined, stale

    @classmethod
    def write(cls, path: pathlib.Path,
              findings_with_fp: list[tuple[Finding, tuple]],
              prior_entries: list[dict]) -> None:
        """Regenerate the baseline from the current findings.

        Justifications of surviving entries are preserved (matched by
        fingerprint); new entries get an explicit placeholder that a
        reviewer must replace.
        """
        prior_just: dict[tuple, str] = {}
        for e in prior_entries:
            prior_just.setdefault(cls._key(e),
                                  str(e.get("justification", "")))
        entries = []
        for finding, fp in sorted(findings_with_fp,
                                  key=lambda t: (t[0].path, t[0].line,
                                                 t[0].rule)):
            entries.append({
                "rule": finding.rule,
                "path": finding.path,
                "line": finding.line,
                "code": fp[2],
                "justification": prior_just.get(
                    fp, "grandfathered by --update-baseline; justify or fix"),
            })
        payload = {"version": 1, "entries": entries}
        path.write_text(json.dumps(payload, indent=2) + "\n")
