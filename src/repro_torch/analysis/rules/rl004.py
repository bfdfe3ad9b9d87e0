"""RL004 host syncs in code tagged sync-free.

The open-loop segment (``loadgen.gen_tick`` then ``ChainSim.tick``, tick
after tick) makes no host sync on the card: the CPU queues tick after
tick while the card runs, and a segment that syncs cannot become one
captured CUDA graph.  A function that carries the guarantee has the
docstring tag::

    repro-torch-lint: sync-free

and this pass flags, in the tagged body and in every def it reaches
through calls the index resolves (``context.ProjectIndex.resolve``):

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` and ``.to("cpu")``;
* the ops whose output size depends on the data, so the host reads a
  count back: ``nonzero``, ``argwhere``, ``masked_select``, ``unique``,
  ``unique_consecutive`` (as methods or ``torch.*`` functions),
  ``torch.where`` with one argument, ``repeat_interleave`` with a tensor
  of counts and no ``output_size``, and indexing with a bool tensor
  (``x[mask]``);
* ``.synchronize()`` (``torch.cuda.synchronize()``, a stream's, an
  event's);
* ``int()``, ``float()`` or ``bool()`` of a tensor expression;
* ``if``, ``while``, ``assert`` and conditional-expression tests that read
  a tensor's value, such as ``(x > 0).any()``.

Reads of ``.shape``, ``.ndim``, ``.dtype``, ``.device``, ``.numel()`` and
``len()`` are metadata and no sync.  A finding in a reached def names the
call chain from the tagged function.  This is the torch meaning of the
JAX package's "jitted code": ``jax.jit`` traces the whole call tree,
while a torch function reaches the card through whatever it calls.
Calls the index cannot resolve (through a variable, or a method of an
object of unknown type) are not followed, and a bool mask or a count
whose type the inference cannot tell is not flagged.  So a clean run says
that none of these forms is reached, not that the segment makes no sync:
the run-time count on the card (``chip_smoke.py`` phase 15,
``tests/test_torch_cuda.py``) stays the guard.
"""
from __future__ import annotations

import ast
from collections import deque
from typing import Iterator

from ..context import (FileCtx, FuncInfo, Infer, ProjectIndex, dotted,
                       is_tensor)
from ..registry import rule
from ..report import Finding

RULE_ID = "RL004"

TAG = "sync-free"
SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
# the output's size is the data's: the host reads it back to allocate
DATA_SIZED = {"nonzero", "argwhere", "masked_select", "unique",
              "unique_consecutive"}
HOST_CASTS = {"int", "float", "bool"}
TORCH_MODULES = {"torch", "torch.cuda"}


def _on_torch(ctx: FileCtx, f: ast.Attribute) -> bool:
    """A call of a method, or of a ``torch``/``torch.cuda`` function: not a
    function of another module (``np.unique``)."""
    recv = dotted(f.value)
    if recv is None or recv.split(".")[0] not in ctx.module_aliases:
        return True
    return recv in TORCH_MODULES


def _to_cpu(call: ast.Call) -> bool:
    """``.to("cpu")``, ``.to(device="cpu")``, ``.to(torch.device("cpu"))``."""
    for arg in list(call.args) + [k.value for k in call.keywords
                                  if k.arg == "device"]:
        if (isinstance(arg, ast.Call) and dotted(arg.func) == "torch.device"
                and arg.args):
            arg = arg.args[0]
        if (isinstance(arg, ast.Constant) and isinstance(arg.value, str)
                and arg.value.split(":")[0] == "cpu"):
            return True
    return False


def _call_sync(node: ast.Call, fi: FuncInfo, infer: Infer):
    """What a call syncs on, or None."""
    f = node.func
    tensor = lambda x: is_tensor(infer.infer(x, infer.env(fi.ctx, node)))
    if isinstance(f, ast.Name):
        if f.id in HOST_CASTS and len(node.args) == 1 and tensor(
                node.args[0]):
            return f"{f.id}() of a tensor"
        return None
    if not isinstance(f, ast.Attribute) or not _on_torch(fi.ctx, f):
        return None
    fn = dotted(f.value) in TORCH_MODULES
    if f.attr in SYNC_METHODS or f.attr in DATA_SIZED:
        return f"{dotted(f.value) if fn else ''}.{f.attr}()"
    if f.attr == "to" and not fn and _to_cpu(node):
        return ".to('cpu')"
    if f.attr == "where" and fn and len(node.args) == 1 and not (
            node.keywords):
        return "torch.where() with one argument"
    if f.attr == "repeat_interleave" and not any(
            k.arg == "output_size" for k in node.keywords):
        pos = 1 if fn and len(node.args) > 1 else 0
        counts = [k.value for k in node.keywords if k.arg == "repeats"] or (
            node.args[pos:pos + 1])
        if counts and tensor(counts[0]):
            return "repeat_interleave() of tensor counts with no output_size"
    return None


def _bool_mask(node: ast.Subscript, fi: FuncInfo, infer: Infer) -> bool:
    """``x[mask]`` read with a bool tensor ``mask`` (alone or in a tuple)."""
    if not isinstance(node.ctx, ast.Load):
        return False
    env = infer.env(fi.ctx, node)
    idx = node.slice.elts if isinstance(node.slice, ast.Tuple) else [
        node.slice]
    return any(infer.infer(i, env) == "bool" for i in idx)


def _syncs(fi: FuncInfo, infer: Infer):
    """(node, what) of every host sync in a def's body, nested defs and
    lambdas included."""
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Call):
            what = _call_sync(node, fi, infer)
            if what is not None:
                yield node, what
        elif isinstance(node, ast.Subscript) and _bool_mask(node, fi, infer):
            yield node, "indexing with a bool tensor"
        test, kind = None, None
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            test = node.test
            kind = {ast.If: "if", ast.While: "while",
                    ast.IfExp: "conditional expression"}[type(node)]
        elif isinstance(node, ast.Assert):
            test, kind = node.test, "assert"
        if test is not None and is_tensor(
                infer.infer(test, infer.env(fi.ctx, test))):
            yield test, f"`{kind}` on a tensor's value"


def _callees(fi: FuncInfo, index: ProjectIndex, infer: Infer):
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Call):
            yield from index.resolve(fi.ctx, node, fi.cls, infer,
                                     infer.env(fi.ctx, node))


@rule(
    RULE_ID,
    "a host sync (.item(), .tolist(), .cpu(), .numpy(), .to('cpu'), "
    ".synchronize(), a data-sized op such as nonzero or x[mask], "
    "int/float/bool of a tensor, control flow on a tensor's value) in code "
    "tagged sync-free or reached from it",
    "the open-loop segment queues tick after tick on the card with no "
    "sync; one sync stalls the CPU on every tick, and a segment that syncs "
    "cannot be captured as one CUDA graph.",
)
def check(ctx: FileCtx, index: ProjectIndex) -> Iterator[Finding]:
    if RULE_ID not in index.memo:
        index.memo[RULE_ID] = _walk(index)
    yield from index.memo[RULE_ID].get(ctx.path, [])


def _walk(index: ProjectIndex) -> dict:
    """Every sync reached from a tagged def, by file: a breadth-first walk
    of the resolved calls, so each finding names the shortest chain."""
    infer = Infer(index)
    seen: set[int] = set()
    queue = deque((fi, (fi.qualname,)) for fi in index.tagged.get(TAG, []))
    out: dict = {}
    reported: set[tuple] = set()
    while queue:
        fi, chain = queue.popleft()
        if id(fi.node) in seen:
            continue
        seen.add(id(fi.node))
        for node, what in _syncs(fi, infer):
            key = (fi.ctx.path, node.lineno, node.col_offset)
            if key in reported:
                continue
            reported.add(key)
            where = (f"inside '{chain[0]}', which is tagged `{TAG}`"
                     if len(chain) == 1 else
                     f"in '{fi.qualname}', reached from `{TAG}` "
                     f"'{chain[0]}' through {' -> '.join(chain)}")
            out.setdefault(fi.ctx.path, []).append(Finding(
                fi.ctx.path, node.lineno, node.col_offset, RULE_ID,
                f"host sync: {what} {where}"))
        for callee in _callees(fi, index, infer):
            if id(callee.node) not in seen:
                queue.append((callee, chain + (callee.qualname,)))
    return out
