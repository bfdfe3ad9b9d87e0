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
before the product, ``rmsnorm`` works in float32 and casts back,
``rotary`` casts cos/sin to ``x.dtype`` before multiplying.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.types import resolve_device

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
