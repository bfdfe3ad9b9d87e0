"""RL003 int32 lane pins: a value of another dtype entering an int32 lane.

The engine's state is int32 throughout: the NamedTuple lanes of ``Msg``,
``Metrics``, ``LockTable``, ``WaveState``, ``Telemetry``, ``ReplyLog``,
``Store`` and the int32 scalars of ``LoadGenState``.  Parity with the
JAX package is exact equality on that state, and a lane that turns int64
doubles its bytes, changes what wraps and where, and spreads through
arithmetic into every lane it meets.  torch makes int64 by default: a
dtype-less integer ``torch.full``, ``torch.tensor`` or ``torch.arange``
is int64, as is ``torch.where(c, 1, 0)`` and an int32 sum; a dtype-less
``torch.zeros``/``ones``/``empty`` is float32.

The pass finds the constructions (``Msg(op=..., ...)``) and the
``._replace(field=...)`` updates of the index's state types and types each
value that enters an int32 lane (``context.Infer``).  A value of another
known type is a finding: an int64 or float32 tensor, or a Python scalar
where a tensor belongs.  ``.to(torch.int32)``, ``.int()``, a constructor
with ``dtype=torch.int32`` and ``*_like`` of an int32 lane are int32;
what the inference cannot type is not flagged.  A construction chained
into ``.mask(...)`` is skipped: ``Msg.mask`` pins every lane to int32.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..context import FileCtx, Infer, ProjectIndex, TENSOR, dotted
from ..registry import rule
from ..report import Finding

RULE_ID = "RL003"

PINNING_WRAPPERS = {"mask"}


def _masked_ctors(tree: ast.AST) -> set[int]:
    """ids of the Call nodes an immediately chained ``.mask(...)`` pins."""
    pinned: set[int] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in PINNING_WRAPPERS):
            continue
        # Msg(...).mask(m) and msg._replace(...)._replace(...).mask(m) both
        # pin every link of the chain
        recv = node.func.value
        while isinstance(recv, ast.Call):
            pinned.add(id(recv))
            if (isinstance(recv.func, ast.Attribute)
                    and recv.func.attr == "_replace"):
                recv = recv.func.value
            else:
                break
    return pinned


def _lane_assignments(call: ast.Call, index: ProjectIndex, infer: Infer,
                      env):
    """(class, field, value) of each lane a construction or a
    ``._replace`` update sets."""
    lanes = index.lane_classes
    name = dotted(call.func)
    short = name.rpartition(".")[2] if name else None
    if short in lanes and not (isinstance(call.func, ast.Attribute)
                               and call.func.attr == "_replace"):
        lc = lanes[short]
        for i, arg in enumerate(call.args):
            if isinstance(arg, ast.Starred):
                break
            if i < len(lc.order):
                yield short, lc.order[i], arg
        for kw in call.keywords:
            if kw.arg in lc.types:
                yield short, kw.arg, kw.value
        return
    if not (isinstance(call.func, ast.Attribute)
            and call.func.attr == "_replace" and call.keywords
            and all(k.arg is not None for k in call.keywords)):
        return
    recv = infer.infer(call.func.value, env)
    if recv is not None and recv.startswith("obj:") and recv[4:] in lanes:
        cls_name = recv[4:]
    else:
        # the receiver's type unknown: the smallest state type whose
        # fields cover every keyword
        kw_names = {k.arg for k in call.keywords}
        candidates = [(len(lc.order), n) for n, lc in lanes.items()
                      if kw_names <= set(lc.order)]
        if not candidates:
            return
        cls_name = min(candidates)[1]
    for kw in call.keywords:
        yield cls_name, kw.arg, kw.value


def _describe(tok: str) -> str:
    if tok.startswith("py:"):
        return f"a Python {tok[3:]}, not a tensor"
    return f"an {tok} tensor" if tok[0] in "aeiou" else f"a {tok} tensor"


@rule(
    RULE_ID,
    "a value that is not int32 entering an int32 lane of an engine state "
    "type",
    "the engine is int32 throughout and held bit for bit to the JAX "
    "package; torch's integer default is int64 (a dtype-less full, tensor, "
    "arange or where(c, 1, 0), an int32 sum), so pin with .to(torch.int32), "
    ".int(), dtype=torch.int32, or Msg.mask(...).",
)
def check(ctx: FileCtx, index: ProjectIndex) -> Iterator[Finding]:
    pinned = _masked_ctors(ctx.tree)
    infer = Infer(index)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or id(node) in pinned:
            continue
        env = infer.env(ctx, node)
        for cls_name, field, value in _lane_assignments(node, index, infer,
                                                        env):
            if index.lane_classes[cls_name].types.get(field) != "int32":
                continue
            tok = infer.infer(value, env)
            if tok is None or tok in ("int32", TENSOR) or tok.startswith(
                    "obj:"):
                continue
            src = ast.get_source_segment(ctx.source, value) or "..."
            src = " ".join(src.split())
            if len(src) > 60:
                src = src[:57] + "..."
            yield Finding(
                ctx.path, value.lineno, value.col_offset, RULE_ID,
                f"{cls_name}.{field} is an int32 lane and receives "
                f"{_describe(tok)}: `{src}`; pin it with .to(torch.int32) "
                "or dtype=torch.int32")
