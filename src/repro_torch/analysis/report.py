"""Finding records and the human and JSON reporters.

A ``Finding`` is a plain frozen dataclass, so the JSON report round-trips
it exactly: ``Finding(**entry)`` over a decoded report rebuilds the
original objects (``findings_from_json``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import IO, Sequence

JSON_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic: ``path:line:col: RULE message``."""

    path: str
    line: int
    col: int
    rule: str
    message: str

    def human(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def render_human(result, stream: IO[str]) -> None:
    """Write the findings one a line, then a one-line summary."""
    for f in result.findings:
        print(f.human(), file=stream)
    bits = [f"{len(result.findings)} finding(s)"]
    if result.suppressed:
        bits.append(f"{len(result.suppressed)} suppressed by pragma")
    bits.append(f"{result.files} file(s)")
    print(f"repro-torch-lint: {', '.join(bits)}", file=stream)


def render_json(result, *, strict: bool = False) -> dict:
    """A ``LintResult`` in the stable report schema."""
    return {
        "version": JSON_SCHEMA_VERSION,
        "strict": strict,
        "files": result.files,
        "rules": list(result.rules),
        "findings": [f.asdict() for f in result.findings],
        "suppressed": [f.asdict() for f in result.suppressed],
        "pragmas": [
            {"path": p.path, "line": p.line, "rules": list(p.rules),
             "reason": p.reason}
            for p in result.pragmas
        ],
        "summary": _summary(result.findings),
    }


def _summary(findings: Sequence[Finding]) -> dict:
    per_rule: dict[str, int] = {}
    for f in findings:
        per_rule[f.rule] = per_rule.get(f.rule, 0) + 1
    return {"total": len(findings), "per_rule": dict(sorted(per_rule.items()))}


def findings_from_json(report: dict) -> list[Finding]:
    """The inverse of ``render_json`` for the ``findings`` list."""
    return [Finding(**entry) for entry in report["findings"]]


def dump_json(result, stream: IO[str], *, strict: bool = False) -> None:
    json.dump(render_json(result, strict=strict), stream, indent=2,
              sort_keys=True)
    stream.write("\n")
