"""Command-line front end: ``repro-torch-lint`` / ``python -m
repro_torch.analysis``.

With no path it lints the port: the ``repro_torch`` package and, where
the package sits in a checkout, the checkout's ``chip_smoke.py``.
``--json`` alone prints the JSON report in place of the human one;
``--json PATH`` writes it to PATH as well.

Exit codes: 0 clean, 1 unsuppressed findings, 2 usage error.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import sys
from typing import Optional, Sequence

from .engine import run_lint
from .registry import RULES
from .report import dump_json, render_human


def default_paths() -> list[str]:
    """The port's package and its checkout's ``chip_smoke.py``, relative to
    the working directory where they lie under it."""
    pkg = pathlib.Path(__file__).resolve().parent.parent
    paths = [pkg]
    smoke = pkg.parent.parent / "chip_smoke.py"
    if pkg.parent.name == "src" and smoke.is_file():
        paths.append(smoke)
    cwd = pathlib.Path.cwd().resolve()
    return [os.path.relpath(p, cwd) if cwd in p.parents else str(p)
            for p in paths]


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro-torch-lint",
        description=("Static contract linter of the PyTorch port: int32 "
                     "lane pins, host syncs in sync-free code, scatter "
                     "discipline."))
    ap.add_argument("paths", nargs="*",
                    help="files or directories to lint (default: the "
                         "repro_torch package and chip_smoke.py)")
    ap.add_argument("--strict", action="store_true",
                    help="require a reason on every pragma")
    ap.add_argument("--json", metavar="PATH", nargs="?", const="-",
                    default=None,
                    help="print the machine-readable report instead of the "
                         "human one, or with PATH also write it there")
    ap.add_argument("--rules", metavar="IDS", default=None,
                    help="comma-separated subset of rule ids to run")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        for rid in sorted(RULES):
            r = RULES[rid]
            print(f"{rid}  {r.summary}")
            print(f"       {r.rationale}")
        return 0
    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    try:
        result = run_lint(args.paths or default_paths(), rules=rules,
                          strict=args.strict)
    except FileNotFoundError as e:
        print(f"repro-torch-lint: error: no such path: {e.args[0]}",
              file=sys.stderr)
        return 2
    except KeyError as e:
        print(f"repro-torch-lint: error: {e.args[0]}", file=sys.stderr)
        return 2
    if args.json == "-":
        dump_json(result, sys.stdout, strict=args.strict)
    else:
        render_human(result, sys.stdout)
        if args.json:
            with open(args.json, "w") as fh:
                dump_json(result, fh, strict=args.strict)
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
