"""The lint driver: walk the paths, build the index, run the rules, apply
the pragmas.

``run_lint_sources`` lints in-memory sources, so a test can lint a
modified copy of a real file without touching the tree.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Iterable, Mapping, Optional, Sequence

from .context import FileCtx, ProjectIndex
from .pragmas import Pragma, apply_suppressions
from .registry import META_RULE, RULES, known_rule_ids
from .report import Finding

# Directories the tree walk never enters.  ``lint_corpus`` holds the
# deliberately bad exemplars of the linters' tests: they are linted only
# when named as files.
EXCLUDED_DIRS = {"__pycache__", ".git", "lint_corpus", ".ipynb_checkpoints"}


@dataclasses.dataclass
class LintResult:
    findings: list[Finding]
    suppressed: list[Finding]
    pragmas: list[Pragma]
    files: int
    rules: list[str] = dataclasses.field(default_factory=list)  # run

    @property
    def ok(self) -> bool:
        return not self.findings

    def per_rule(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out


def walk_paths(paths: Sequence[str]) -> list[pathlib.Path]:
    """Files and directories expanded into the sorted set of Python files.

    A file named explicitly is always linted; a directory walk skips
    ``EXCLUDED_DIRS``.  Raises FileNotFoundError for a missing path.
    """
    files: set[pathlib.Path] = set()
    for raw in paths:
        p = pathlib.Path(raw)
        if p.is_file():
            files.add(p)
        elif p.is_dir():
            for f in p.rglob("*.py"):
                if not EXCLUDED_DIRS.intersection(f.parts):
                    files.add(f)
        else:
            raise FileNotFoundError(raw)
    return sorted(files)


def run_lint(paths: Sequence[str], *, rules: Optional[Iterable[str]] = None,
             strict: bool = False) -> LintResult:
    files = walk_paths(paths)
    sources = {}
    unreadable: list[Finding] = []
    for f in files:
        try:
            sources[str(f)] = f.read_text()
        except (OSError, UnicodeDecodeError) as e:
            unreadable.append(
                Finding(str(f), 0, 0, META_RULE, f"unreadable: {e}"))
    result = run_lint_sources(sources, rules=rules, strict=strict)
    result.findings = sorted(unreadable + result.findings)
    return result


def run_lint_sources(sources: Mapping[str, str], *,
                     rules: Optional[Iterable[str]] = None,
                     strict: bool = False) -> LintResult:
    selected = _select_rules(rules)
    ctxs: list[FileCtx] = []
    meta: list[Finding] = []
    for path in sorted(sources):
        try:
            ctxs.append(FileCtx.parse(path, sources[path]))
        except SyntaxError as e:
            meta.append(Finding(path, e.lineno or 0, e.offset or 0,
                                META_RULE, f"syntax error: {e.msg}"))
    index = ProjectIndex.build(ctxs)

    raw: list[Finding] = []
    pragmas: list[Pragma] = []
    for ctx in ctxs:
        pragmas.extend(ctx.pragmas)
        for rule in selected:
            raw.extend(rule.check(ctx, index))
        meta.extend(_pragma_diagnostics(ctx, strict=strict))

    active, suppressed = apply_suppressions(sorted(raw), pragmas)
    return LintResult(findings=sorted(meta + active), suppressed=suppressed,
                      pragmas=pragmas, files=len(sources),
                      rules=[r.rule_id for r in selected])


def _select_rules(rules: Optional[Iterable[str]]):
    if rules is None:
        return [RULES[r] for r in sorted(RULES)]
    wanted = list(rules)
    unknown = [r for r in wanted if r not in RULES]
    if unknown:
        raise KeyError(f"unknown rule id(s): {', '.join(unknown)}")
    return [RULES[r] for r in sorted(set(wanted))]


def _pragma_diagnostics(ctx: FileCtx, *, strict: bool) -> list[Finding]:
    """Malformed pragmas are findings themselves (meta rule RL000)."""
    out: list[Finding] = []
    known = known_rule_ids()
    for p in ctx.pragmas:
        bad = [r for r in p.rules if r not in known]
        if bad or not p.rules:
            out.append(Finding(
                p.path, p.line, 0, META_RULE,
                "pragma names unknown rule id(s): "
                + (", ".join(bad) if bad else "<empty>")))
        if strict and not p.reason:
            out.append(Finding(
                p.path, p.line, 0, META_RULE,
                f"pragma ignore[{','.join(p.rules)}] has no reason "
                "(--strict requires one)"))
    return out
