"""repro-torch-lint: static checks of the PyTorch port's own contracts.

The port holds itself to the JAX package bit for bit on an int32 engine,
and runs its open-loop segment on the card with no host sync.  Those
contracts live in docstrings and in run-time checks on the card
(``chip_smoke.py`` phase 15, ``tests/test_torch_cuda.py``).  This package
checks the forms of them it can see in the source, on any machine, in
seconds, with ``ast`` alone: importing it imports neither torch nor JAX.
It does not replace the run-time checks: RL004 knows a list of
synchronizing calls and follows only the calls its index resolves, so a
clean run says that none of those forms is reached, and the sync count
on the card stays the guard of the open-loop segment.

* RL003 int32 lane pins: a value that is not int32 entering an int32
  lane of an engine state type (``Msg``, ``Metrics``, ``LockTable``,
  ``WaveState``, ``Telemetry``, ``LoadGenState``, ...).
* RL004 host syncs (``rules.rl004`` lists the forms) in code tagged
  ``sync-free`` and in what it calls.
* RL005 scatters in code tagged ``scatter-free``.

It keeps the JAX package linter's engine, pragmas, reporters and exit
codes; ``rules`` says why RL001 and RL002 are not ported.  Entry points:
``python -m repro_torch.analysis`` or the ``repro-torch-lint`` console
script.  Pragmas: ``# repro-torch-lint: ignore[RULE-ID] <reason>``
(``pragmas``).
"""
from __future__ import annotations

from .engine import LintResult, run_lint, run_lint_sources, walk_paths
from .pragmas import Pragma, scan_pragmas
from .registry import RULES, Rule
from .report import Finding, render_human, render_json

# importing the rules package registers RL003-RL005
from . import rules as _rules  # noqa: F401

__all__ = [
    "Finding",
    "LintResult",
    "Pragma",
    "RULES",
    "Rule",
    "render_human",
    "render_json",
    "run_lint",
    "run_lint_sources",
    "scan_pragmas",
    "walk_paths",
]
