"""Pragma grammar: ``# repro-torch-lint: ignore[RULE-ID, ...] <reason>``.

A pragma at the end of a flagged line suppresses the matching findings on
that line; a pragma on a line of its own suppresses them on the next
line.  ``--strict`` also demands a reason.  An unknown rule id is a
finding (RL000) in every mode.  The prefix differs from the JAX
package's linter's (``repro-lint:``), so neither linter counts the
other's pragmas.

Comments are found with :mod:`tokenize`, never with a regex over raw
lines, so pragma-shaped strings do not count.
"""
from __future__ import annotations

import dataclasses
import io
import re
import tokenize
from typing import Iterable

PRAGMA_RE = re.compile(
    r"#\s*repro-torch-lint:\s*ignore\[(?P<rules>[^\]]*)\]\s*(?P<reason>.*)$"
)


@dataclasses.dataclass(frozen=True)
class Pragma:
    """One parsed suppression comment."""

    path: str
    line: int            # 1-based line the comment sits on
    rules: tuple[str, ...]
    reason: str
    own_line: bool       # the comment is the whole line: applies to line + 1

    @property
    def target_line(self) -> int:
        return self.line + 1 if self.own_line else self.line

    def matches(self, rule: str, line: int) -> bool:
        return line == self.target_line and rule in self.rules


def scan_pragmas(path: str, source: str) -> list[Pragma]:
    """Every pragma comment of ``source``."""
    out: list[Pragma] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = PRAGMA_RE.search(tok.string)
        if m is None:
            continue
        rules = tuple(r.strip() for r in m.group("rules").split(",")
                      if r.strip())
        out.append(Pragma(
            path=path, line=tok.start[0], rules=rules,
            reason=m.group("reason").strip(),
            own_line=tok.line[: tok.start[1]].strip() == ""))
    return out


def apply_suppressions(findings, pragmas: Iterable[Pragma]):
    """Split ``findings`` into (active, suppressed) under ``pragmas``."""
    active, suppressed = [], []
    pragmas = list(pragmas)
    for f in findings:
        if any(p.path == f.path and p.matches(f.rule, f.line)
               for p in pragmas):
            suppressed.append(f)
        else:
            active.append(f)
    return active, suppressed
