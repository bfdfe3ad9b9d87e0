"""Parsed files, the cross-file project index and the type inference the
rules share.

The linter runs in two passes.  Pass one parses every file and builds a
``ProjectIndex``:

* the NamedTuple state types and their lanes.  A field annotated
  ``torch.Tensor`` is a lane; its dtype is int32, the engine's, unless
  its line comment opens with another, after a shape if it has one
  (``alive: torch.Tensor  # bool``, ``qps: torch.Tensor  # [] float32
  ...``).  A dtype word later in a comment, or in the class docstring,
  types nothing.  A field annotated with another state type
  (``SimState.metrics: Metrics``) is kept as that type, so
  ``state.metrics.offered`` has a dtype;
* module-level names bound to Python ints (``OP_WRITE``, ``NOWHERE``) and
  to torch dtypes (``I32 = torch.int32``);
* the docstring tags, ``repro-torch-lint: <tag>``, of every function;
* the call index: each file's functions, classes and methods by name and
  its imports, so that ``f(...)``, ``self.m(...)``, ``alias.f(...)``,
  ``Cls.m(...)`` and ``x.m(...)`` with ``x`` of a known state type
  resolve to the defs they reach.  ``self.attr(...)`` resolves too where
  the class binds ``self.attr`` to an entry of a module-level dict of
  functions (``NODE_STEPS[protocol]``).

Pass two runs each rule over each file with the index in hand.

``Infer`` types an expression as a token: a tensor dtype (``"int32"``,
``"bool"``, ...), ``TENSOR`` (a tensor of a dtype it cannot tell),
``"py:int"``/``"py:float"``/``"py:bool"`` (a Python scalar),
``"obj:<Class>"`` (a state type) or None (it cannot tell).  Its dtype
rules are torch's: a dtype-less integer ``torch.full``/``torch.tensor``/
``torch.arange`` is int64, a dtype-less ``torch.zeros``/``ones``/
``empty`` float32, ``torch.where(c, 1, 0)`` int64, and arithmetic takes
the wider of its tensor operands (a Python scalar widens it only across
kinds: an int tensor times 0.5 is float32).
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
from typing import Iterable, Iterator, Optional

from .pragmas import Pragma, scan_pragmas

TAG_RE = re.compile(r"repro-torch-lint:\s*([a-z][a-z0-9-]*)")

TENSOR = "tensor"
PY_INT, PY_FLOAT, PY_BOOL = "py:int", "py:float", "py:bool"

DTYPES = {
    "int32": "int32", "int": "int32", "int64": "int64", "long": "int64",
    "int16": "int16", "short": "int16", "int8": "int8", "uint8": "uint8",
    "float32": "float32", "float": "float32", "float64": "float64",
    "double": "float64", "float16": "float16", "half": "float16",
    "bfloat16": "bfloat16", "bool": "bool",
}
# a lane's line comment that opens with its dtype, after an optional shape
LANE_DTYPE_RE = re.compile(
    r"^\s*(?:\[[^\]]*\]\s*)?(int32|int64|int16|int8|uint8|float32|"
    r"float64|float16|bfloat16|bool)\b")
_KIND = {"bool": 0, "uint8": 1, "int8": 1, "int16": 1, "int32": 1,
         "int64": 1, "float16": 2, "bfloat16": 2, "float32": 2,
         "float64": 2}
_BITS = {"bool": 1, "uint8": 8, "int8": 8, "int16": 16, "int32": 32,
         "int64": 64, "float16": 16, "bfloat16": 16, "float32": 32,
         "float64": 64}
_PY_KIND = {PY_BOOL: 0, PY_INT: 1, PY_FLOAT: 2}
_KIND_DEFAULT = {0: "bool", 1: "int64", 2: "float32"}
TENSOR_ANNOTATIONS = {"torch.Tensor", "Tensor"}


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` attribute chains to a string; None for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_int_value(node: ast.AST) -> Optional[int]:
    """The value of a Python-int expression of literals (``1 << 20``,
    ``-1``), else None."""
    if isinstance(node, ast.Constant) and type(node.value) is int:
        return node.value
    if isinstance(node, ast.UnaryOp):
        v = const_int_value(node.operand)
        if v is None:
            return None
        if isinstance(node.op, ast.USub):
            return -v
        if isinstance(node.op, ast.Invert):
            return ~v
        return None
    if isinstance(node, ast.BinOp):
        lhs, rhs = const_int_value(node.left), const_int_value(node.right)
        if lhs is None or rhs is None:
            return None
        ops = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
               ast.Mult: lambda a, b: a * b,
               ast.FloorDiv: lambda a, b: a // b,
               ast.Mod: lambda a, b: a % b,
               ast.LShift: lambda a, b: a << b,
               ast.RShift: lambda a, b: a >> b,
               ast.BitOr: lambda a, b: a | b,
               ast.BitAnd: lambda a, b: a & b,
               ast.BitXor: lambda a, b: a ^ b}
        try:
            return ops[type(node.op)](lhs, rhs)
        except (KeyError, ZeroDivisionError, ValueError):
            return None
    return None


def parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, "_rl_parent", None)


def enclosing_function(node: ast.AST):
    """The innermost FunctionDef around ``node``, or None."""
    cur = parent(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = parent(cur)
    return None


def enclosing_class(fn: ast.AST) -> Optional[str]:
    """The class a def is a method of, or None."""
    p = parent(fn)
    return p.name if isinstance(p, ast.ClassDef) else None


def tags_of(fn: ast.AST) -> frozenset[str]:
    """The ``repro-torch-lint: <tag>`` tags of a def's docstring."""
    doc = ast.get_docstring(fn) if isinstance(
        fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) else None
    return frozenset(TAG_RE.findall(doc or ""))


def module_name(path: str) -> str:
    """The dotted module of a file path: the parts after its last ``src``
    directory (``src/repro_torch/core/chain.py`` ->
    ``repro_torch.core.chain``), else the file's stem."""
    parts = list(pathlib.PurePath(path).with_suffix("").parts)
    if "src" in parts[:-1]:
        parts = parts[len(parts) - parts[::-1].index("src"):]
    else:
        parts = parts[-1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def statements(body: list) -> Iterator[ast.stmt]:
    """The statements of ``body`` in source order, nested blocks included
    and nested defs and classes left out."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for field in ("body", "orelse", "finalbody"):
            yield from statements(getattr(stmt, field, []) or [])
        for h in getattr(stmt, "handlers", []) or []:
            yield from statements(h.body)


@dataclasses.dataclass
class FileCtx:
    """One parsed source file with parent links, its pragmas and what the
    call index needs of it."""

    path: str
    source: str
    tree: ast.Module
    pragmas: list[Pragma]
    module: str
    defs: dict            # module-level function name -> FunctionDef
    classes: dict         # class name -> ClassDef
    methods: dict         # (class, name) -> FunctionDef
    module_aliases: dict  # local name -> imported module
    name_imports: dict    # local name -> (module, name)
    dicts: dict           # module-level name -> its dict literal

    @classmethod
    def parse(cls, path: str, source: str) -> "FileCtx":
        tree = ast.parse(source, filename=path)
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                child._rl_parent = node  # type: ignore[attr-defined]
        ctx = cls(path=path, source=source, tree=tree,
                  pragmas=scan_pragmas(path, source),
                  module=module_name(path), defs={}, classes={}, methods={},
                  module_aliases={}, name_imports={}, dicts={})
        ctx._index()
        return ctx

    def _index(self) -> None:
        is_pkg = pathlib.PurePath(self.path).stem == "__init__"
        for stmt in self.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs[stmt.name] = stmt
            elif isinstance(stmt, ast.ClassDef):
                self.classes[stmt.name] = stmt
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self.methods[(stmt.name, sub.name)] = sub
            elif isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                tgts = (stmt.targets if isinstance(stmt, ast.Assign)
                        else [stmt.target])
                if (len(tgts) == 1 and isinstance(tgts[0], ast.Name)
                        and isinstance(stmt.value, ast.Dict)):
                    self.dicts[tgts[0].id] = stmt.value
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.module_aliases[a.asname] = a.name
                    else:
                        top = a.name.split(".")[0]
                        self.module_aliases[top] = top
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    pkg = self.module.split(".")
                    if not is_pkg:
                        pkg = pkg[:-1]
                    pkg = pkg[:len(pkg) - (node.level - 1)]
                    base = ".".join(pkg + ([base] if base else []))
                for a in node.names:
                    self.name_imports[a.asname or a.name] = (base, a.name)


@dataclasses.dataclass(frozen=True)
class FuncInfo:
    """A def the call index reached: its file, node and qualified name."""

    ctx: FileCtx
    node: ast.AST
    qualname: str
    cls: Optional[str]


@dataclasses.dataclass
class LaneClass:
    """A NamedTuple state type: its fields in order, and each field's type
    token (a lane's dtype, ``obj:<Class>``, or None)."""

    order: tuple
    types: dict


def _line_comment(source_lines: list[str], lineno: int) -> str:
    line = source_lines[lineno - 1] if lineno - 1 < len(source_lines) else ""
    return line.split("#", 1)[1] if "#" in line else ""


def _annotation_name(ann: ast.AST) -> Optional[str]:
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value
    return dotted(ann)


@dataclasses.dataclass
class ProjectIndex:
    """Cross-file facts every rule can consult."""

    lane_classes: dict        # class name -> LaneClass
    weak_consts: frozenset    # module-level names bound to Python ints
    dtype_names: dict         # module-level name -> torch dtype
    modules: dict             # dotted module -> FileCtx
    class_home: dict          # class name -> the FileCtx defining it
    tagged: dict              # tag -> [FuncInfo]
    self_callables: dict      # (class, attr) -> [expr] bound to self.attr
    memo: dict = dataclasses.field(default_factory=dict)  # rules' per-run

    @classmethod
    def build(cls, ctxs: Iterable[FileCtx]) -> "ProjectIndex":
        ctxs = list(ctxs)
        idx = cls(lane_classes={}, weak_consts=frozenset(), dtype_names={},
                  modules={}, class_home={}, tagged={}, self_callables={})
        weak: set[str] = set()
        for ctx in ctxs:
            idx.modules.setdefault(ctx.module, ctx)
            for name in ctx.classes:
                idx.class_home.setdefault(name, ctx)
            for stmt in ctx.tree.body:
                if not (isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)):
                    continue
                name = stmt.targets[0].id
                if const_int_value(stmt.value) is not None:
                    weak.add(name)
                dt = _torch_dtype(stmt.value)
                if dt is not None:
                    idx.dtype_names[name] = dt
        idx.weak_consts = frozenset(weak)
        for ctx in ctxs:
            lines = ctx.source.splitlines()
            for node in ctx.classes.values():
                idx._index_namedtuple(node, lines)
            for node in ast.walk(ctx.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    owner = enclosing_class(node)
                    qual = f"{owner}.{node.name}" if owner else node.name
                    for tag in tags_of(node):
                        idx.tagged.setdefault(tag, []).append(
                            FuncInfo(ctx, node, qual, owner))
                    if owner:
                        idx._index_self_callables(ctx, owner, node)
        return idx

    def _index_namedtuple(self, node: ast.ClassDef, lines: list) -> None:
        if not any(dotted(b) in {"NamedTuple", "typing.NamedTuple"}
                   for b in node.bases):
            return
        order, types = [], {}
        for stmt in node.body:
            if not (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)):
                continue
            field = stmt.target.id
            order.append(field)
            ann = _annotation_name(stmt.annotation)
            if ann in TENSOR_ANNOTATIONS:
                m = LANE_DTYPE_RE.match(_line_comment(lines, stmt.lineno))
                types[field] = m.group(1) if m else "int32"
            elif ann in ("int", "float", "bool"):
                types[field] = "py:" + ann
            elif ann is not None:
                types[field] = "obj:" + ann.rpartition(".")[2]
            else:
                types[field] = None
        if any(t is not None and not t.startswith("obj:")
               for t in types.values()):
            self.lane_classes.setdefault(
                node.name, LaneClass(tuple(order), types))

    def _index_self_callables(self, ctx: FileCtx, owner: str, fn) -> None:
        """``self.attr = TABLE[...]`` with ``TABLE`` a module-level dict
        literal: every value of the table is a callable ``self.attr``
        may hold."""
        for stmt in statements(fn.body):
            if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1):
                continue
            tgt, val = stmt.targets[0], stmt.value
            if (isinstance(tgt, ast.Attribute) and dotted(tgt.value) == "self"
                    and isinstance(val, ast.Subscript)
                    and isinstance(val.value, ast.Name)
                    and val.value.id in ctx.dicts):
                self.self_callables.setdefault((owner, tgt.attr), []).extend(
                    ctx.dicts[val.value.id].values)

    # -- the call index ----------------------------------------------------
    def _module_def(self, module: str, name: str) -> Optional[FuncInfo]:
        target = self.modules.get(module)
        if target is None:
            return None
        if name in target.defs:
            return FuncInfo(target, target.defs[name], name, None)
        if name in target.name_imports:       # re-exported by the module
            mod, nm = target.name_imports[name]
            if (mod, nm) != (module, name):
                return self._module_def(mod, nm)
        return None

    def _class_ctx(self, ctx: FileCtx, name: str) -> Optional[FileCtx]:
        if name in ctx.classes:
            return ctx
        if name in ctx.name_imports:
            mod, nm = ctx.name_imports[name]
            target = self.modules.get(mod)
            if target is not None and nm in target.classes:
                return target
        return self.class_home.get(name)

    def _method(self, ctx: FileCtx, cls_name: str,
                name: str) -> Optional[FuncInfo]:
        home = self._class_ctx(ctx, cls_name)
        if home is None or (cls_name, name) not in home.methods:
            return None
        return FuncInfo(home, home.methods[(cls_name, name)],
                        f"{cls_name}.{name}", cls_name)

    def _resolve_expr(self, ctx: FileCtx, f: ast.AST, cls: Optional[str],
                      infer: Optional["Infer"] = None,
                      env: Optional[dict] = None) -> list[FuncInfo]:
        if isinstance(f, ast.Name):
            if f.id in ctx.defs:
                return [FuncInfo(ctx, ctx.defs[f.id], f.id, None)]
            if f.id in ctx.name_imports:
                hit = self._module_def(*ctx.name_imports[f.id])
                return [hit] if hit else []
            return []
        if not isinstance(f, ast.Attribute):
            return []
        recv = f.value
        if isinstance(recv, ast.Name):
            if recv.id == "self" and cls is not None:
                hit = self._method(ctx, cls, f.attr)
                if hit:
                    return [hit]
                out = []
                for expr in self.self_callables.get((cls, f.attr), []):
                    out.extend(self._resolve_expr(ctx, expr, None))
                return out
            if recv.id in ctx.module_aliases:
                hit = self._module_def(ctx.module_aliases[recv.id], f.attr)
                return [hit] if hit else []
            if recv.id in ctx.name_imports:
                mod, nm = ctx.name_imports[recv.id]
                if f"{mod}.{nm}" in self.modules:
                    hit = self._module_def(f"{mod}.{nm}", f.attr)
                    return [hit] if hit else []
            if self._class_ctx(ctx, recv.id) is not None and (
                    recv.id in ctx.classes or recv.id in ctx.name_imports):
                hit = self._method(ctx, recv.id, f.attr)
                return [hit] if hit else []
        if infer is not None:
            tok = infer.infer(recv, env or {})
            if tok is not None and tok.startswith("obj:"):
                hit = self._method(ctx, tok[4:], f.attr)
                return [hit] if hit else []
        return []

    def resolve(self, ctx: FileCtx, call: ast.Call, cls: Optional[str],
                infer: Optional["Infer"] = None,
                env: Optional[dict] = None) -> list[FuncInfo]:
        """The defs a call reaches, as far as the index can tell."""
        return self._resolve_expr(ctx, call.func, cls, infer, env)


def _torch_dtype(node: Optional[ast.AST]) -> Optional[str]:
    name = dotted(node) if node is not None else None
    if name and name.startswith("torch.") and name.count(".") == 1:
        return DTYPES.get(name[6:])
    return None


def is_tensor(tok: Optional[str]) -> bool:
    return tok is not None and not tok.startswith(("py:", "obj:"))


def promote(a: str, b: str) -> str:
    """torch's promotion of two tensor dtypes."""
    if a == b:
        return a
    if TENSOR in (a, b):
        return TENSOR
    ka, kb = _KIND.get(a), _KIND.get(b)
    if ka is None or kb is None:
        return TENSOR
    if ka != kb:
        return a if ka > kb else b
    if _BITS[a] != _BITS[b]:
        return a if _BITS[a] > _BITS[b] else b
    return "float32" if ka == 2 else "int16"   # float16/bfloat16, u8/i8


def _with_scalar(t: str, s: str) -> str:
    """A tensor of dtype ``t`` with a Python scalar: the scalar widens
    only across kinds (bool < int < float)."""
    if t == TENSOR:
        return TENSOR
    if _PY_KIND[s] > _KIND.get(t, 2):
        return _KIND_DEFAULT[_PY_KIND[s]]
    return t


def combine(a: Optional[str], b: Optional[str]) -> Optional[str]:
    """The result type of arithmetic on two operands."""
    if a is None or b is None or a.startswith("obj:") or (
            b.startswith("obj:")):
        return TENSOR if is_tensor(a) or is_tensor(b) else None
    if a.startswith("py:") and b.startswith("py:"):
        return PY_FLOAT if PY_FLOAT in (a, b) else PY_INT
    if a.startswith("py:"):
        return _with_scalar(b, a)
    if b.startswith("py:"):
        return _with_scalar(a, b)
    return promote(a, b)


def _scalars_alone(a: str, b: str) -> str:
    """``torch.where`` of two Python scalars: the default dtype of the
    wider kind."""
    return _KIND_DEFAULT[max(_PY_KIND[a], _PY_KIND[b])]


CAST_METHODS = {"int": "int32", "long": "int64", "float": "float32",
                "double": "float64", "half": "float16",
                "bfloat16": "bfloat16", "bool": "bool", "short": "int16",
                "char": "int8", "byte": "uint8"}
# methods and torch functions that keep their input's dtype
KEEP_DTYPE = {
    "clone", "contiguous", "reshape", "view", "view_as", "expand",
    "expand_as", "flatten", "unflatten", "squeeze", "unsqueeze", "permute",
    "transpose", "t", "clamp", "clamp_", "clamp_min", "clamp_max", "clip",
    "abs", "neg", "flip", "roll", "repeat", "repeat_interleave", "gather",
    "take_along_dim", "masked_fill", "index_select", "narrow", "detach",
    "movedim", "select", "diagonal", "tile", "amax", "amin", "cpu", "cuda",
    "broadcast_to", "reshape_as", "diff", "fill_", "zero_", "requires_grad_",
    "pin_memory", "share_memory_",
}
SUMS = {"sum", "cumsum", "prod", "cumprod", "nansum"}
BOOL_OPS = {"any", "all", "eq", "ne", "lt", "le", "gt", "ge", "logical_and",
            "logical_or", "logical_not", "logical_xor", "isnan", "isinf",
            "isfinite", "isin", "isneginf", "isposinf"}
INDEX_OPS = {"argmax", "argmin", "argsort", "nonzero", "randperm"}
NOT_TENSOR_METHODS = {"item", "tolist", "numel", "dim", "size", "nelement",
                      "element_size", "numpy", "data_ptr", "stride",
                      "get_device", "is_contiguous", "storage_offset",
                      "is_floating_point", "untyped_storage"}
SORTERS = {"sort", "topk", "max", "min", "cummax", "cummin", "kthvalue",
           "median", "mode"}
NOT_TENSOR_FNS = {
    "device", "Size", "Generator", "is_tensor", "is_grad_enabled", "no_grad",
    "enable_grad", "inference_mode", "get_default_dtype", "manual_seed",
    "set_grad_enabled", "is_floating_point", "numel", "promote_types",
    "result_type", "iinfo", "finfo", "compile", "equal", "allclose",
    "use_deterministic_algorithms", "set_printoptions", "chunk", "split",
    "unbind", "broadcast_tensors", "meshgrid", "unique", "unique_consecutive",
} | SORTERS
ARITH_FNS = {"remainder", "fmod", "maximum", "minimum", "bitwise_and",
             "bitwise_or", "bitwise_xor", "add", "sub", "mul",
             "floor_divide", "lerp", "fmax", "fmin"}


class Scope(dict):
    """Names to type tokens, with the file and the class they are in (the
    call index resolves ``self.m(...)`` through the class)."""

    ctx: Optional[FileCtx] = None
    cls: Optional[str] = None

    def child(self) -> "Scope":
        s = Scope(self)
        s.ctx, s.cls = self.ctx, self.cls
        return s


class Infer:
    """Types expressions as tokens (module docstring); one instance lints
    one run, with a cache of the environments of the defs it has seen."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        self._envs: dict = {}
        self._returns: dict = {}

    # -- environments ------------------------------------------------------
    def annotation(self, ann: Optional[ast.AST]) -> Optional[str]:
        name = _annotation_name(ann) if ann is not None else None
        if name is None:
            return None
        if name in TENSOR_ANNOTATIONS:
            return TENSOR
        if name in ("int", "float", "bool"):
            return "py:" + name
        short = name.rpartition(".")[2]
        if short in self.index.lane_classes or short in self.index.class_home:
            return "obj:" + short
        return None

    def module_env(self, ctx: FileCtx) -> Scope:
        key = id(ctx.tree)
        if key not in self._envs:
            scope = Scope()
            scope.ctx = ctx
            self._envs[key] = scope
            self._envs[key] = self._assign_env(ctx.tree.body, scope)
        return self._envs[key]

    def env(self, ctx: FileCtx, node: ast.AST) -> Scope:
        """The environment at ``node``: its innermost def's, or the
        module's."""
        fn = node if isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)) else (
            enclosing_function(node))
        if fn is None:
            return self.module_env(ctx)
        key = id(fn)
        if key not in self._envs:
            outer = self.env(ctx, parent(fn)) if enclosing_function(
                fn) is not None else self.module_env(ctx)
            env = outer.child()
            env.cls = enclosing_class(fn) or outer.cls
            a = fn.args
            for arg in a.posonlyargs + a.args + a.kwonlyargs + [
                    x for x in (a.vararg, a.kwarg) if x is not None]:
                env[arg.arg] = self.annotation(arg.annotation)
            self._envs[key] = env          # guards recursion
            self._envs[key] = self._assign_env(fn.body, env)
        return self._envs[key]

    def _assign_env(self, body: list, env: Scope) -> Scope:
        """``env`` with every name ``body`` assigns: its type where every
        assignment agrees, None where they differ."""
        env = env.child()
        seen: dict = {}

        def bind(name: str, tok: Optional[str]) -> None:
            if name in seen and seen[name] != tok:
                tok = None
            seen[name] = tok
            env[name] = tok

        def unbind(target: ast.AST) -> None:
            for n in ast.walk(target):
                if isinstance(n, ast.Name):
                    bind(n.id, None)

        for stmt in statements(body):
            if isinstance(stmt, ast.Assign):
                tok = self.infer(stmt.value, env)
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        bind(tgt.id, tok)
                    else:
                        unbind(tgt)
            elif isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name):
                tok = self.annotation(stmt.annotation)
                if stmt.value is not None:
                    tok = self.infer(stmt.value, env) or tok
                bind(stmt.target.id, tok)
            elif isinstance(stmt, ast.AugAssign) and isinstance(
                    stmt.target, ast.Name):
                bind(stmt.target.id, combine(env.get(stmt.target.id),
                                             self.infer(stmt.value, env)))
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                unbind(stmt.target)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    if item.optional_vars is not None:
                        unbind(item.optional_vars)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                bind(stmt.name, None)
        for node in ast.walk(ast.Module(body=list(body), type_ignores=[])):
            if isinstance(node, ast.NamedExpr):
                bind(node.target.id, None)
        return env

    def returns(self, fi: FuncInfo) -> Optional[str]:
        """A def's result type: its one ``return``'s inferred dtype where
        the body is that return alone, else its annotation's."""
        key = id(fi.node)
        if key in self._returns:
            return self._returns[key]
        self._returns[key] = None              # guards recursion
        tok = self.annotation(fi.node.returns)
        body = fi.node.body
        if body and isinstance(body[0], ast.Expr) and isinstance(
                getattr(body[0], "value", None), ast.Constant):
            body = body[1:]
        if len(body) == 1 and isinstance(body[0], ast.Return) and (
                body[0].value is not None):
            got = self.infer(body[0].value, self.env(fi.ctx, fi.node))
            if got is not None and (tok in (None, TENSOR) or got == tok):
                tok = got
        self._returns[key] = tok
        return tok

    # -- expressions -------------------------------------------------------
    def dtype_of(self, node: Optional[ast.AST], env: dict) -> Optional[str]:
        """The torch dtype an expression names: ``torch.int32``, a module
        alias of one (``I32``), or ``x.dtype`` of a typed tensor."""
        if node is None:
            return None
        dt = _torch_dtype(node)
        if dt is not None:
            return dt
        if isinstance(node, ast.Name) and env.get(node.id) is None:
            return self.index.dtype_names.get(node.id)
        if isinstance(node, ast.Attribute) and node.attr == "dtype":
            tok = self.infer(node.value, env)
            return tok if is_tensor(tok) and tok != TENSOR else None
        return None

    def infer(self, node: ast.AST, env: dict) -> Optional[str]:
        if isinstance(node, ast.Constant):
            if type(node.value) is bool:
                return PY_BOOL
            if type(node.value) is int:
                return PY_INT
            if type(node.value) is float:
                return PY_FLOAT
            return None
        if isinstance(node, ast.Name):
            if node.id in env:
                return env[node.id]
            if node.id in self.index.weak_consts:
                return PY_INT
            return None
        if isinstance(node, ast.Attribute):
            return self._attribute(node, env)
        if isinstance(node, ast.Subscript):
            tok = self.infer(node.value, env)
            return tok if is_tensor(tok) else None
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return PY_BOOL
            toks = [self.infer(x, env) for x in [node.left] + node.comparators]
            if any(is_tensor(t) for t in toks):
                return "bool"
            return PY_BOOL if all(t and t.startswith("py:")
                                  for t in toks) else None
        if isinstance(node, ast.BoolOp):
            toks = [self.infer(x, env) for x in node.values]
            if any(is_tensor(t) for t in toks):
                return "bool"
            return PY_BOOL if all(t and t.startswith("py:")
                                  for t in toks) else None
        if isinstance(node, ast.UnaryOp):
            tok = self.infer(node.operand, env)
            if isinstance(node.op, ast.Not):
                return "bool" if is_tensor(tok) else (
                    PY_BOOL if tok and tok.startswith("py:") else None)
            if tok == PY_BOOL and not isinstance(node.op, ast.Invert):
                return PY_INT
            return tok
        if isinstance(node, ast.BinOp):
            a, b = self.infer(node.left, env), self.infer(node.right, env)
            if isinstance(node.op, ast.Div):
                out = combine(a, b)
                if out is None or out == TENSOR:
                    return out
                if out.startswith("py:"):
                    return PY_FLOAT
                return out if _KIND.get(out) == 2 else "float32"
            if isinstance(node.op, (ast.LShift, ast.RShift)):
                return a if is_tensor(a) else combine(a, b)
            return combine(a, b)
        if isinstance(node, ast.IfExp):
            a, b = self.infer(node.body, env), self.infer(node.orelse, env)
            if a is None or b is None:
                return None
            if a == b:
                return a
            return b if a == "int32" else a
        if isinstance(node, ast.Call):
            return self._call(node, env)
        return None

    def _attribute(self, node: ast.Attribute, env: dict) -> Optional[str]:
        attr, recv = node.attr, node.value
        if attr in ("T", "mT", "real", "data"):
            tok = self.infer(recv, env)
            return tok if is_tensor(tok) else None
        if isinstance(recv, ast.Call) and isinstance(
                recv.func, ast.Attribute) and recv.func.attr in SORTERS:
            if attr == "indices":
                return "int64"
            if attr == "values":
                src = recv.func.value
                if dotted(src) == "torch" and recv.args:
                    src = recv.args[0]
                tok = self.infer(src, env)
                return tok if is_tensor(tok) else None
        tok = self.infer(recv, env)
        if tok is not None and tok.startswith("obj:"):
            lc = self.index.lane_classes.get(tok[4:])
            if lc is not None:
                return lc.types.get(attr)
        return None

    def _call(self, node: ast.Call, env: dict) -> Optional[str]:
        f = node.func
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        if isinstance(f, ast.Name):
            if f.id in ("int", "len", "round"):
                return PY_INT
            if f.id == "float":
                return PY_FLOAT
            if f.id in ("bool", "isinstance", "callable", "hasattr"):
                return PY_BOOL
            if f.id in self.index.lane_classes:
                return "obj:" + f.id
        if isinstance(f, ast.Attribute):
            if dotted(f.value) == "torch":
                return self._torch_fn(f.attr, node, kw, env)
            out = self._method(f.attr, f.value, node, kw, env)
            if out is not None:
                return out
        return self._resolved(node, env)

    def _resolved(self, node: ast.Call, env: dict) -> Optional[str]:
        """The result type of a call the index resolves: one def, or
        several that agree."""
        if not isinstance(env, Scope) or env.ctx is None:
            return None
        hits = self.index.resolve(env.ctx, node, env.cls, self, env)
        toks = {self.returns(h) for h in hits}
        return toks.pop() if len(toks) == 1 else None

    def _method(self, attr: str, recv_node: ast.AST, node: ast.Call,
                kw: dict, env: dict) -> Optional[str]:
        if attr in ("_replace", "mask"):
            tok = self.infer(recv_node, env)
            return tok if tok and tok.startswith("obj:") else None
        if attr in CAST_METHODS and not node.args and not node.keywords:
            return CAST_METHODS[attr]
        recv = self.infer(recv_node, env)
        if attr in ("to", "type"):
            for arg in list(node.args) + [kw.get("dtype")]:
                dt = self.dtype_of(arg, env)
                if dt is not None:
                    return dt
                if arg is not None:
                    other = self.infer(arg, env)
                    if is_tensor(other):
                        return other
            return recv if is_tensor(recv) else None
        if attr in ("new_zeros", "new_ones", "new_empty", "new_full",
                    "new_tensor"):
            if "dtype" in kw:
                return self.dtype_of(kw["dtype"], env) or TENSOR
            return recv if is_tensor(recv) else None
        if not is_tensor(recv):
            return None
        if attr in SUMS:
            return self._sum(recv, kw, env)
        if attr in BOOL_OPS:
            return "bool"
        if attr in INDEX_OPS:
            return "int64"
        if attr in ("max", "min") and not node.args and not kw:
            return recv                 # the whole-tensor reduction
        if attr in NOT_TENSOR_METHODS or attr in SORTERS:
            return None
        if attr in KEEP_DTYPE and not (attr == "view" and any(
                self.dtype_of(a, env) for a in node.args)):
            return recv
        return TENSOR

    def _sum(self, recv: Optional[str], kw: dict, env: dict) -> Optional[str]:
        if "dtype" in kw:
            return self.dtype_of(kw["dtype"], env) or TENSOR
        if recv == TENSOR or not is_tensor(recv):
            return TENSOR if is_tensor(recv) else None
        return "int64" if _KIND.get(recv, 2) < 2 else recv

    def _torch_fn(self, fn: str, node: ast.Call, kw: dict,
                  env: dict) -> Optional[str]:
        args = node.args
        arg = lambda i, name=None: (args[i] if len(args) > i
                                    else kw.get(name) if name else None)
        tok = lambda x: self.infer(x, env) if x is not None else None
        if "dtype" in kw and fn not in SUMS:
            return self.dtype_of(kw["dtype"], env) or TENSOR
        if fn == "full":
            fill = tok(arg(1, "fill_value"))
            return (_KIND_DEFAULT[_PY_KIND[fill]] if fill in _PY_KIND
                    else TENSOR)
        if fn in ("tensor", "as_tensor", "asarray"):
            data = arg(0, "data")
            if isinstance(data, (ast.List, ast.Tuple)) and data.elts:
                toks = {tok(e) for e in data.elts}
                if toks <= set(_PY_KIND):
                    return _KIND_DEFAULT[max(_PY_KIND[t] for t in toks)]
                return TENSOR
            t = tok(data)
            if t in _PY_KIND:
                return _KIND_DEFAULT[_PY_KIND[t]]
            return t if is_tensor(t) else TENSOR
        if fn == "arange":
            toks = [tok(a) for a in args]
            if PY_FLOAT in toks:
                return "float32"
            if toks and all(t in (PY_INT, PY_BOOL) for t in toks):
                return "int64"
            return TENSOR
        if fn in ("zeros", "ones", "empty", "rand", "randn", "eye",
                  "linspace", "logspace"):
            return "float32"
        if fn == "randint":
            return "int64"
        if fn.endswith("_like"):
            t = tok(arg(0, "input"))
            if fn in ("rand_like", "randn_like") and not is_tensor(t):
                return TENSOR
            return t if is_tensor(t) else TENSOR
        if fn == "where":
            if len(args) != 3:
                return None
            a, b = tok(args[1]), tok(args[2])
            if a in _PY_KIND and b in _PY_KIND:
                return _scalars_alone(a, b)
            return combine(a, b) if is_tensor(a) or is_tensor(b) else TENSOR
        if fn in ("cat", "stack", "concat", "concatenate", "hstack",
                  "vstack"):
            seq = arg(0, "tensors")
            if isinstance(seq, (ast.List, ast.Tuple)) and seq.elts:
                toks = [tok(e) for e in seq.elts]
                if all(is_tensor(t) for t in toks):
                    out = toks[0]
                    for t in toks[1:]:
                        out = promote(out, t)
                    return out
            return TENSOR
        if fn in ("searchsorted", "bucketize"):
            flag = kw.get("out_int32")
            return "int32" if (isinstance(flag, ast.Constant)
                               and flag.value is True) else "int64"
        if fn in SUMS:
            return self._sum(tok(arg(0, "input")), kw, env) or TENSOR
        if fn in INDEX_OPS:
            return "int64"
        if fn in BOOL_OPS:
            return "bool"
        if fn == "div":
            a, b = tok(arg(0, "input")), tok(arg(1, "other"))
            out = combine(a, b)
            if "rounding_mode" in kw or out is None or out == TENSOR:
                return out if is_tensor(out) else TENSOR
            return out if _KIND.get(out) == 2 else "float32"
        if fn in ARITH_FNS:
            out = combine(tok(arg(0, "input")), tok(arg(1, "other")))
            return out if is_tensor(out) else TENSOR
        if fn in KEEP_DTYPE:
            t = tok(arg(0, "input"))
            return t if is_tensor(t) else TENSOR
        if fn in ("max", "min") and len(args) == 1 and not kw:
            t = tok(args[0])
            return t if is_tensor(t) else TENSOR
        if fn in NOT_TENSOR_FNS or fn in DTYPES:
            return None
        return TENSOR
