"""Rule registry: each rule module registers one check pass.

A rule is a callable ``check(ctx: FileCtx, index: ProjectIndex) ->
Iterable[Finding]`` plus catalogue metadata (summary and rationale) that
``--list-rules`` prints.  ``RL000`` is the linter's own meta rule (syntax
errors, malformed pragmas): always on, never registered here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable

RULE_ID_RE = r"RL\d{3}"


@dataclasses.dataclass(frozen=True)
class Rule:
    rule_id: str
    summary: str
    rationale: str
    check: Callable

    def __call__(self, ctx, index) -> Iterable:
        return self.check(ctx, index)


RULES: Dict[str, Rule] = {}

# The meta rule id of parse errors and malformed pragmas; always enabled,
# and no pragma suppresses it.
META_RULE = "RL000"


def rule(rule_id: str, summary: str, rationale: str):
    """Decorator registering a check function under ``rule_id``."""

    def deco(fn: Callable) -> Rule:
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id}")
        r = Rule(rule_id=rule_id, summary=summary, rationale=rationale,
                 check=fn)
        RULES[rule_id] = r
        return r

    return deco


def known_rule_ids() -> set[str]:
    return set(RULES) | {META_RULE}
