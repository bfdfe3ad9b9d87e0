"""Shared model layers, functional: ``*_init`` builds parameters, the
apply functions read them.

Parameters are ``nn.ParameterDict``s keyed as the reference's dicts
(``{"w", "b"}``, ``{"scale"}``, ``{"table"}``) and nested in
``nn.ModuleDict``s (a ``ParamTree`` where one dict holds tensors and
sub-dicts side by side, as the Mamba-2 mixer's does), so the two
packages' trees match name for name and ``repro_torch.convert`` moves
weights across by key.  Weights keep the
reference's layouts (``dense`` is ``x @ w`` with ``w [d_in, d_out]``)
and its roundings: ``dense`` casts ``x`` and ``w`` to the compute dtype
before the product, ``rmsnorm`` and ``layernorm`` work in float32 and
cast back, ``rotary`` casts cos/sin to ``x.dtype`` before multiplying,
``gelu_mlp`` takes ``jax.nn.gelu``'s default, the tanh approximation.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core.types import resolve_device
from repro_torch.distributed.sharding import is_dtensor

F32 = torch.float32


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class ParamTree(nn.Module):
    """A parameter dict whose entries are tensors and sub-trees side by
    side (the reference's mamba dict: ``conv_w``, ``A_log``, ... beside
    ``in_proj``, ``norm``), read by key like the other dicts."""

    def __init__(self, entries: dict):
        super().__init__()
        self._order = list(entries)
        for k, v in entries.items():
            if isinstance(v, nn.Module):
                self.add_module(k, v)
            else:
                self.register_parameter(
                    k, v if isinstance(v, nn.Parameter) else _param(v))

    def __getitem__(self, key: str):
        if key not in self._order:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._order

    def __iter__(self):
        return iter(self._order)

    def __len__(self) -> int:
        return len(self._order)

    def keys(self):
        return list(self._order)

    def items(self):
        return [(k, self[k]) for k in self._order]


def _normal(gen: torch.Generator, shape, dtype, device, scale: float):
    """Normal samples times ``scale``, drawn on the generator's device and
    moved to ``device``."""
    x = torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
    return x.mul_(scale).to(device)


def dense_init(gen, d_in: int, d_out: int, *, bias: bool = False,
               dtype=F32, device="cuda", scale: float | None = None):
    device = resolve_device(device)
    scale = (d_in ** -0.5) if scale is None else scale
    p = {"w": _param(_normal(gen, (d_in, d_out), dtype, device, scale))}
    if bias:
        p["b"] = _param(torch.zeros((d_out,), dtype=dtype, device=device))
    return nn.ParameterDict(p)


def dense(p, x: torch.Tensor, *, compute_dtype=torch.bfloat16):
    y = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def rmsnorm_init(d: int, dtype=F32, device="cuda"):
    device = resolve_device(device)
    return nn.ParameterDict(
        {"scale": _param(torch.ones((d,), dtype=dtype, device=device))})


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(F32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(F32)).to(dt)


def layernorm_init(d: int, dtype=F32, device="cuda"):
    device = resolve_device(device)
    return nn.ParameterDict({
        "scale": _param(torch.ones((d,), dtype=dtype, device=device)),
        "bias": _param(torch.zeros((d,), dtype=dtype, device=device))})


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(F32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dt)


def embed_init(gen, vocab: int, d: int, dtype=F32, device="cuda"):
    device = resolve_device(device)
    return nn.ParameterDict(
        {"table": _param(_normal(gen, (vocab, d), dtype, device, 0.02))})


def embed(p, ids: torch.Tensor, *, compute_dtype=torch.bfloat16):
    # gather, then cast: the reference's cast-then-gather gives the same
    # bits without converting the whole table
    return p["table"][ids].to(compute_dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def swiglu_init(gen, d: int, f: int, dtype=F32, device="cuda"):
    device = resolve_device(device)
    return nn.ModuleDict({
        "w_gate": dense_init(gen, d, f, dtype=dtype, device=device),
        "w_up": dense_init(gen, d, f, dtype=dtype, device=device),
        "w_down": dense_init(gen, f, d, dtype=dtype, device=device),
    })


def swiglu(p, x: torch.Tensor, *, compute_dtype=torch.bfloat16):
    g = dense(p["w_gate"], x, compute_dtype=compute_dtype)
    u = dense(p["w_up"], x, compute_dtype=compute_dtype)
    # jax.nn.silu is x * sigmoid(x), rounded op by op
    return dense(p["w_down"], g * torch.sigmoid(g) * u,
                 compute_dtype=compute_dtype)


def gelu_mlp_init(gen, d: int, f: int, dtype=F32, device="cuda"):
    device = resolve_device(device)
    return nn.ModuleDict({
        "w_up": dense_init(gen, d, f, bias=True, dtype=dtype, device=device),
        "w_down": dense_init(gen, f, d, bias=True, dtype=dtype,
                             device=device),
    })


def gelu_mlp(p, x: torch.Tensor, *, compute_dtype=torch.bfloat16):
    h = dense(p["w_up"], x, compute_dtype=compute_dtype)
    return dense(p["w_down"], F.gelu(h, approximate="tanh"),
                 compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard + partial "2d" variant)
# ---------------------------------------------------------------------------
def rotary(x: torch.Tensor, positions: torch.Tensor, *,
           fraction: float = 1.0, base: float = 10000.0) -> torch.Tensor:
    """``x [B, S, H, D]`` rotated at ``positions [B, S]`` (int)."""
    D = x.shape[-1]
    rot_d = int(D * fraction)
    rot_d -= rot_d % 2
    if rot_d == 0:
        return x
    x_rot, x_pass = x[..., :rot_d], x[..., rot_d:]
    half = rot_d // 2
    freqs = base ** (-torch.arange(0, half, dtype=F32, device=x.device)
                     / half)
    angles = positions[..., None].to(F32) * freqs          # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rot_d == D:
        return rotated
    return torch.cat([rotated, x_pass], dim=-1)


def sinusoidal_positions(seq_len: int, d: int,
                         device="cuda") -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings ``[seq_len, d]`` float32
    (the reference's formula: the exponent's step is ``1 / (d // 2 - 1)``)."""
    device = resolve_device(device)
    pos = torch.arange(seq_len, dtype=F32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=F32, device=device)[None, :]
    inv = 10000.0 ** (-dim / max(d // 2 - 1, 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def _rows(x: torch.Tensor) -> list:
    """The placements a vocab-parallel loss runs a DTensor ``x [..., V]``
    at: its sharding of the batch (dim 0) and of the vocabulary (the
    last dim) kept, any other replicated."""
    from torch.distributed.tensor import Replicate, Shard

    last = x.dim() - 1
    return [p if isinstance(p, Shard) and p.dim in (0, last) else Replicate()
            for p in x.placements]


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the last dim.  On a mesh (a DTensor) each device
    takes it over its slice of the vocabulary and the slices' values are
    combined by a ``logsumexp`` over one number a slice: DTensor's own
    ``logsumexp``, and its backward, gather the whole vocabulary."""
    if not is_dtensor(x):
        return torch.logsumexp(x, dim=-1)
    from torch.distributed.tensor.experimental import local_map

    lp = _rows(x)
    part = local_map(lambda t: torch.logsumexp(t, dim=-1, keepdim=True),
                     out_placements=lp, in_placements=(lp,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)
    return torch.logsumexp(part, dim=-1)


def _gold(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``logits`` at the labels ``idx [..., 1]``, the last dim dropped.
    On a mesh (a DTensor) the pick is vocab-parallel, as Megatron's: each
    device picks the labels inside its slice of the vocabulary (0
    elsewhere) and the picks are summed over the vocab's mesh dims.
    DTensor's own ``gather`` differentiates into a zero tensor of the
    global logits' shape on every device."""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, idx.long())[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, last = logits.device_mesh, logits.dim() - 1
    lp = _rows(logits)
    vocab = [d for d, p in enumerate(lp) if p == Shard(last)]

    def pick(lg, ix):
        n = lg.shape[-1]
        slot = 0
        for d in vocab:
            slot = slot * mesh.size(d) + mesh.get_local_rank(d)
        rel = ix.long() - slot * n
        inside = (rel >= 0) & (rel < n)
        g = torch.gather(lg, -1, rel.clamp(0, n - 1))
        return torch.where(inside, g, torch.zeros_like(g))[..., 0]

    return local_map(
        pick, out_placements=[Partial() if d in vocab else p
                              for d, p in enumerate(lp)],
        in_placements=(lp, [Replicate() if d in vocab else p
                            for d, p in enumerate(lp)]),
        device_mesh=mesh, redistribute_inputs=True)(logits, idx)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, mask=None):
    """Token cross-entropy: logits ``[.., V]`` upcast to float32 (the
    ``logsumexp`` runs over every column, the padded vocabulary's too, as
    the reference's), labels ``[..]`` int; with a mask the sum of its
    weighted terms over ``max(sum(mask), 1)``."""
    logits = logits.to(F32)
    logz = _logsumexp(logits)
    gold = _gold(logits, labels[..., None])
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(F32)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def chunked_xent(x: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
                 mask=None, chunk: int = 1024):
    """Cross-entropy of ``x [B, S, d] @ head_w [d, V]`` one sequence chunk
    at a time, never the whole ``[B, S, V]`` logits at once; ``chunk`` is
    rounded down to the largest divisor of S (the reference's scan)."""
    B, S, d = x.shape
    while S % chunk:
        chunk -= 1
    w = head_w.to(x.dtype)
    nll = torch.zeros((), dtype=F32, device=x.device)
    count = torch.zeros((), dtype=F32, device=x.device)
    for i in range(0, S, chunk):
        logits = (x[:, i:i + chunk] @ w).to(F32)
        logz = _logsumexp(logits)
        gold = _gold(logits, labels[:, i:i + chunk, None])
        mi = (torch.ones_like(logz) if mask is None
              else mask[:, i:i + chunk].to(F32))
        nll = nll + ((logz - gold) * mi).sum()
        count = count + mi.sum()
    return nll / count.clamp_min(1.0)
