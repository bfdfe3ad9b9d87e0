"""Logical-axis sharding rules (DP/TP/EP/SP) as DTensor placements (the
port's ``repro/distributed/sharding.py``).

Models annotate activations with *logical* axes via ``shard(x, ...)``;
a context-installed rule set maps logical -> physical mesh axes.  Outside a
rule context the annotations are no-ops, and inside one they act on
DTensors only (a plain tensor comes back as it is), so single-device runs
and the CPU tests run the exact same model code as the emulated-mesh
dry-run.  Inside a rule context a DTensor is ``redistribute``d to the
resolved placements: the counterpart of ``with_sharding_constraint``,
every dim the spec leaves unnamed is replicated.

Physical axes (launch/mesh.py): ``pod`` x ``data`` x ``model``.
  batch   -> (pod, data)   activations' batch dim (DP)
  heads   -> model         attention heads (TP); replicated if indivisible
  kv      -> model         kv heads (GQA); replicated if indivisible
  ff      -> model         MLP inner dim (TP)
  vocab   -> model         embedding/logits vocab dim (TP)
  experts -> model         MoE expert dim (EP)
  seq_kv  -> data          KV-cache length for flash-decoding SP (long ctx)

A spec is a ``P``: one entry per tensor dim, ``None`` (replicated), a
mesh axis name, or a tuple of them; ``specs_to_placements`` turns it into
one DTensor placement per mesh dim.  The port's layers are an
``nn.ModuleList`` (``layers.<i>.<path>``) where the reference stacks them
on a leading ``[L, ...]`` axis, so ``build_param_specs`` gives each
layer's leaf the reference's stacked spec without its leading entry; the
caches keep the stacked layout, so ``cache_specs`` is the reference's.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
from typing import Optional

import torch
from torch import nn
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.kernels.build import is_dtensor


class P(tuple):
    """A partition spec, ``P(None, "model")``: a tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshRules:
    batch: tuple | str | None = None
    heads: str | None = None
    kv: str | None = None
    ff: str | None = None
    vocab: str | None = None
    experts: str | None = None
    seq_kv: str | None = None
    seq_sp: str | None = None     # sequence-parallel residual stream (TP-SP)
    fsdp: str | None = None       # ZeRO-3 param sharding over the data axis

    def axis(self, logical: Optional[str]):
        if logical is None:
            return None
        return getattr(self, logical)


SINGLE_POD = MeshRules(
    batch=("data",), heads="model", kv="model", ff="model",
    vocab="model", experts="model", seq_kv="data", seq_sp="model",
    fsdp="data",
)
MULTI_POD = MeshRules(
    batch=("pod", "data"), heads="model", kv="model", ff="model",
    vocab="model", experts="model", seq_kv="data", seq_sp="model",
    fsdp="data",
)
# Serving rules: no FSDP, so weights stay resident and a decode step
# gathers none (the reference measured the FSDP gathers as the whole
# model's bytes every token).
SINGLE_POD_SERVE = dataclasses.replace(SINGLE_POD, fsdp=None)
MULTI_POD_SERVE = dataclasses.replace(MULTI_POD, fsdp=None)

_RULES: contextvars.ContextVar[Optional[MeshRules]] = contextvars.ContextVar(
    "repro_torch_mesh_rules", default=None
)
# axis sizes of the active mesh, used for divisibility fallbacks
_AXIS_SIZES: contextvars.ContextVar[dict] = contextvars.ContextVar(
    "repro_torch_axis_sizes", default={}
)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or any object with
    ``mesh_dim_names`` and ``shape``); ``{}`` for None."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@contextlib.contextmanager
def use_rules(rules: MeshRules, mesh=None):
    tok = _RULES.set(rules)
    tok2 = _AXIS_SIZES.set(axis_sizes(mesh))
    try:
        yield
    finally:
        _RULES.reset(tok)
        _AXIS_SIZES.reset(tok2)


def active_rules() -> Optional[MeshRules]:
    return _RULES.get()


def _names(phys) -> tuple:
    if phys is None:
        return ()
    return phys if isinstance(phys, tuple) else (phys,)


def _total(phys, sizes: dict) -> int:
    total = 1
    for nm in _names(phys):
        total *= sizes.get(nm, 1)
    return total


def _resolve(dim_size: int, logical: Optional[str]):
    """Map a logical axis to physical axes, dropping indivisible shardings
    (e.g. qwen2.5's 2 kv heads on a 16-way model axis -> replicate)."""
    rules = _RULES.get()
    if rules is None or logical is None:
        return None
    phys = rules.axis(logical)
    if phys is None:
        return None
    total = _total(phys, _AXIS_SIZES.get())
    if total > 1 and dim_size % total != 0:
        return None
    return phys


def specs_to_placements(spec, mesh) -> list:
    """One placement per mesh dim: ``Shard(d)`` on each mesh axis of more
    than one device that entry ``d`` of ``spec`` names (alone or in a
    tuple), ``Replicate()`` on the others (a shard over one device is its
    replica, and DTensor refuses some views of a dim sharded even one
    way)."""
    where = {}
    for d, entry in enumerate(spec):
        for nm in _names(entry):
            where[nm] = d
    return [Shard(where[nm]) if nm in where and size > 1 else Replicate()
            for nm, size in zip(mesh.mesh_dim_names, tuple(mesh.shape))]


def shard(x: torch.Tensor, *logical):
    """Constrain ``x`` to logical axes (None entries = replicated dim):
    ``x`` itself outside a rule context or when it is not a DTensor, else
    ``x`` redistributed to the resolved placements."""
    if _RULES.get() is None or not is_dtensor(x):
        return x
    entries, used = [], set()
    for size, l in zip(x.shape, logical):
        phys = _resolve(size, l)
        if used & set(_names(phys)):
            # a mesh axis shards one dim: the first dim naming it keeps it
            # (seq_parallel_decode's batch and seq_kv are both "data")
            phys = None
        used |= set(_names(phys))
        entries.append(phys)
    placements = specs_to_placements(P(*entries), x.device_mesh)
    if tuple(placements) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


class _GradPlacements(torch.autograd.Function):
    """The identity on a DTensor whose backward redistributes the gradient
    to the value's own placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g
        return g.redistribute(g.device_mesh, ctx.placements)


def shard_with_grad(x: torch.Tensor, *logical):
    """``shard`` of ``x`` and of its gradient: the gradient that reaches
    ``x`` is redistributed to ``x``'s placements, as the transpose of
    ``with_sharding_constraint`` constrains the cotangent.  DTensor's own
    backward leaves a gradient where the backward's ops put it, and a view
    of it back through a reshape may then split a dim unevenly (the MoE
    groups over all three mesh axes viewed as a batch of fewer rows)."""
    x = shard(x, *logical)
    if (_RULES.get() is None or not is_dtensor(x) or not x.requires_grad
            or not torch.is_grad_enabled()):
        return x
    return _GradPlacements.apply(x)


def shard_groups(x: torch.Tensor, groups: int, *logical):
    """``shard`` of ``x`` whose last dim is ``groups`` x width flattened
    (heads x head_dim): the last dim's axis is resolved against the group
    count, so every shard holds whole groups and the flat dim can be
    viewed as ``[groups, width]`` (DTensor cannot split a dim sharded
    across a group)."""
    if _RULES.get() is None or not is_dtensor(x):
        return x
    last = logical[-1] if _resolve(groups, logical[-1]) is not None else None
    return shard(x, *logical[:-1], last)


# ---------------------------------------------------------------------------
# Parameter sharding: tree-path pattern rules
# ---------------------------------------------------------------------------
# Patterns are matched against '/'-joined tree paths.  ``stacked`` subtrees
# (scanned layers) carry a leading layer dim -> specs shifted right by one.
_PARAM_RULES: list[tuple[str, tuple]] = [
    # embed: shard d over model -> the token gather is shard-local (no
    # table all-gather); head: shard vocab over model -> logits come out
    # sharded.  FSDP-sharding either one forces a full-table gather per
    # step.
    (r"embed/table$", (None, "heads")),
    (r"head/w$", (None, "vocab")),
    (r"(wq|wqkv)/w$", ("fsdp", "heads")),
    (r"(wk|wv)/w$", ("fsdp", None)),       # kv dim too small for 16-way TP
    (r"(wq|wqkv)/b$", ("heads",)),
    (r"(wk|wv)/b$", (None,)),
    (r"wo/w$", ("heads", "fsdp")),
    (r"(w_gate|w_up)/w$", ("fsdp", "ff")),
    (r"w_down/w$", ("ff", "fsdp")),
    (r"(w_gate|w_up)/b$", ("ff",)),
    (r"router/w$", (None, None)),
    (r"experts/(w_gate|w_up)$", ("experts", "fsdp", None)),
    (r"experts/w_down$", ("experts", None, "fsdp")),
    (r"mamba/in_proj/w$", ("fsdp", "heads")),
    (r"mamba/out_proj/w$", ("heads", "fsdp")),
    (r"mamba/conv_w$", (None, "heads")),
    (r"mamba/(A_log|D|dt_bias)$", ("heads",)),
    (r"pos_dec$", (None, "fsdp")),
    (r"(scale|bias)$", (None,)),
]

# the reference's layer stacks; only one named "layers" is treated as
# stacked by its ``build_param_specs`` (stacked_marker="layers")
STACKS = ("layers", "enc_layers", "dec_layers")


def param_pspec(path_str: str, ndim: int, shape, rules: MeshRules,
                axis_sizes: dict, stacked: bool) -> P:
    for pat, logical in _PARAM_RULES:
        if re.search(pat, path_str):
            offset = 1 if stacked else 0
            if len(logical) + offset != ndim:
                # rule arity mismatch (e.g. unstacked variant) -> best effort
                if len(logical) == ndim:
                    offset = 0
                else:
                    return P()
            spec = [None] * ndim
            for i, logi in enumerate(logical):
                phys = rules.axis(logi)
                if phys is None:
                    continue
                total = _total(phys, axis_sizes)
                if total > 1 and shape[i + offset] % total == 0:
                    spec[i + offset] = phys
            return P(*spec)
    return P()


def _layer_stack(name: str, params) -> tuple:
    """``(reference path, stack length or 0)`` of a parameter name: a
    layer's ``<stack>.<i>.<path>`` is the reference's ``<stack>/<path>``
    leaf of ``[n_layers, ...]``."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] in STACKS and parts[1].isdigit():
        return "/".join([parts[0]] + parts[2:]), len(params[parts[0]])
    return "/".join(parts), 0


def build_param_specs(params: nn.Module, rules: MeshRules, mesh) -> dict:
    """``{parameter name: P}``.  A layer's leaf gets the spec the
    reference gives its stacked ``[L, ...]`` leaf, leading entry dropped:
    that spec is computed on the stacked shape, so where the reference
    does not treat a stack as stacked (its marker is "layers": Whisper's
    ``enc_layers``/``dec_layers`` fall to its arity fallback and
    replicate) the port does the same."""
    sizes = axis_sizes(mesh)
    out = {}
    for name, p in params.named_parameters():
        path, n = _layer_stack(name, params)
        if not n:
            out[name] = param_pspec(path, p.dim(), tuple(p.shape), rules,
                                    sizes, False)
            continue
        spec = param_pspec(path, p.dim() + 1, (n,) + tuple(p.shape), rules,
                           sizes, path.split("/")[0] == "layers")
        out[name] = P(*spec[1:])
    return out


def _cache_leaf(path: tuple, shape, rules: MeshRules, sizes: dict) -> P:
    """The reference's ``cache_specs`` rule for one leaf (its docstring:
    KV caches [..., B, T, KV, D] batch over data when divisible, else the
    length over data; KV heads over model, else head_dim; SSM states batch
    x heads)."""
    nd = len(shape)
    if nd == 0:
        return P()

    def ax_size(logical):
        return _total(rules.axis(logical), sizes)

    if "kv" in path or "cross" in path:
        lead = nd - 4
        b, t, kvh, dh = shape[lead:]
        spec = [None] * nd
        dsz, msz = ax_size("batch"), ax_size("heads")
        if b % dsz == 0 and dsz > 1:
            spec[lead] = rules.axis("batch")
        elif t % ax_size("seq_kv") == 0:
            spec[lead + 1] = rules.axis("seq_kv")
        if kvh % msz == 0 and msz > 1:
            spec[lead + 2] = rules.axis("kv")
        elif dh % msz == 0 and msz > 1:
            spec[lead + 3] = rules.axis("heads")
        return P(*spec)
    if "conv" in path:  # before "ssm": paths look like ssm/conv
        lead = nd - 3
        b, _, ch = shape[lead:]
        spec = [None] * nd
        if b % ax_size("batch") == 0 and ax_size("batch") > 1:
            spec[lead] = rules.axis("batch")
        if ch % ax_size("heads") == 0 and ax_size("heads") > 1:
            spec[lead + 2] = rules.axis("heads")
        return P(*spec)
    if "ssm" in path:
        lead = nd - 4
        b, h = shape[lead], shape[lead + 1]
        spec = [None] * nd
        if b % ax_size("batch") == 0 and ax_size("batch") > 1:
            spec[lead] = rules.axis("batch")
        if h % ax_size("heads") == 0 and ax_size("heads") > 1:
            spec[lead + 1] = rules.axis("heads")
        return P(*spec)
    return P()


def _map_tree(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def cache_specs(cache: dict, rules: MeshRules, mesh) -> dict:
    """The spec tree of a decode/prefill cache (``{"kv": (k, v), "ssm":
    {"conv", "ssm"}, "cross": (k, v), "t"}``), the reference's rules."""
    sizes = axis_sizes(mesh)
    return _map_tree(cache, lambda path, leaf: _cache_leaf(
        path, _shape(leaf), rules, sizes))


def batch_specs(batch: dict, rules: MeshRules, mesh=None) -> dict:
    """Specs for model input batches (tokens/labels/embeds).  Batch dims
    that don't divide the DP axes (long_500k's B=1) replicate."""
    phys = rules.axis("batch")
    total = _total(phys, axis_sizes(mesh))

    def f(path, leaf):
        shape = _shape(leaf)
        spec = [None] * len(shape)
        if shape and (total <= 1 or shape[0] % total == 0):
            spec[0] = phys
        return P(*spec)

    return _map_tree(batch, f)


# ---------------------------------------------------------------------------
# Placing tensors on the mesh
# ---------------------------------------------------------------------------
def distribute(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """``x`` as a DTensor of ``spec``'s placements; each rank keeps its
    own shard (cut locally, no collective)."""
    return distribute_tensor(x, mesh, specs_to_placements(spec, mesh),
                             src_data_rank=None)


def distribute_params(params: nn.Module, specs: dict, mesh) -> nn.Module:
    """Replace every parameter of ``params`` in place by a DTensor
    ``nn.Parameter`` of its spec (what ``distribute_module`` does), keeping
    ``requires_grad``; returns ``params``."""
    for name, spec in specs.items():
        *mods, leaf = name.split(".")
        owner = params
        for m in mods:
            owner = owner[int(m)] if m.isdigit() else getattr(owner, m)
        p = getattr(owner, leaf)
        owner._parameters[leaf] = nn.Parameter(
            distribute(p.data, spec, mesh), requires_grad=p.requires_grad)
    return params


def distribute_tree(tree, specs, mesh):
    """A cache or batch tree with each tensor leaf distributed by the
    matching leaf of ``specs`` (non-tensor leaves kept)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(distribute_tree(v, s, mesh)
                          for v, s in zip(tree, specs))
    if isinstance(tree, torch.Tensor):
        return distribute(tree, specs, mesh)
    return tree


def local_bytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree`` (a DTensor's
    local tensor, a plain tensor whole), parameters of a module included."""
    if isinstance(tree, nn.Module):
        tree = [p for _, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if is_dtensor(tree) else tree
        return t.numel() * t.element_size()
    return 0
