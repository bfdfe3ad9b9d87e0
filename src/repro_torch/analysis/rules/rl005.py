"""RL005 scatter discipline: no scatter in code tagged scatter-free.

The segmented fabric (``core/chain.py::segmented_route``) and the cluster
router (``cluster_route``) route with one sort and binary searches; the
reference's dense fabric scattered, and its O(n^2) cost curve is what the
sort replaced.  A function that advertises the guarantee carries the
docstring tag::

    repro-torch-lint: scatter-free

and this pass flags every scatter in the tagged body and its nested defs:
``index_put_``/``index_put``, ``scatter``/``scatter_*``, ``index_copy_``,
``index_add_``, ``index_reduce_``, ``masked_scatter_`` (and their
out-of-place forms, as methods or ``torch.*`` functions), and subscript
assignment, ``x[idx] = v`` or ``x[idx] += v``, to anything but a list,
dict or set the function built itself.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..context import FileCtx, ProjectIndex, statements, tags_of
from ..registry import rule
from ..report import Finding

RULE_ID = "RL005"

TAG = "scatter-free"
SCATTERS = {"index_put_", "index_put", "index_copy_", "index_copy",
            "index_add_", "index_add", "index_reduce_", "index_reduce",
            "masked_scatter_", "masked_scatter"}
_CONTAINER_CALLS = {"dict", "list", "set", "defaultdict", "OrderedDict"}


def _is_scatter(call: ast.Call) -> bool:
    f = call.func
    return isinstance(f, ast.Attribute) and (
        f.attr in SCATTERS or f.attr.startswith("scatter"))


def _containers(fn: ast.AST) -> set[str]:
    """Names the def binds to a list, dict or set it builds."""
    out = set()
    for stmt in statements(fn.body):
        if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            continue
        val = stmt.value
        built = isinstance(val, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                                 ast.DictComp, ast.SetComp)) or (
            isinstance(val, ast.Call) and isinstance(val.func, ast.Name)
            and val.func.id in _CONTAINER_CALLS)
        tgts = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
        for t in tgts:
            if built and isinstance(t, ast.Name):
                out.add(t.id)
    return out


def _subscript_targets(node: ast.AST):
    targets = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    for t in targets:
        for sub in ast.walk(t):
            if isinstance(sub, ast.Subscript) and isinstance(
                    sub.ctx, ast.Store):
                yield sub


@rule(
    RULE_ID,
    "a scatter or a subscript assignment inside a function tagged "
    "scatter-free",
    "the segmented fabric's cost rests on sort + binary-search routing; "
    "one scatter quietly brings back the dense fabric's serialised cost "
    "curve.",
)
def check(ctx: FileCtx, index: ProjectIndex) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if TAG not in tags_of(node):
            continue
        owned = _containers(node)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and _is_scatter(sub):
                yield Finding(
                    ctx.path, sub.lineno, sub.col_offset, RULE_ID,
                    f"scatter .{sub.func.attr}(...) inside '{node.name}', "
                    f"which is tagged `{TAG}`; route with a sort and "
                    "searchsorted instead")
            for tgt in _subscript_targets(sub):
                base = tgt.value
                if isinstance(base, ast.Name) and base.id in owned:
                    continue
                yield Finding(
                    ctx.path, tgt.lineno, tgt.col_offset, RULE_ID,
                    f"subscript assignment inside '{node.name}', which is "
                    f"tagged `{TAG}`, scatters into a tensor; gather "
                    "instead")
