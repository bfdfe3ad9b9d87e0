"""Mixture-of-Experts with capacity-based dispatch (the port's copy of
``repro/models/moe.py``).

Tokens are grouped (``x.reshape(G, T, d)``, T the largest divisor of
``B * S`` at or below ``cfg.moe_group_tokens``), each group routes its
tokens top-k, a (token, slot)'s position in its expert is its rank from
a cumsum over the group's ``T * k`` decisions, and dispatch and combine
are products against a ``[G, T, E, C]`` one-hot: static shapes, no
data-dependent scatter.  Capacity ``C = int(T * k * cf / E_real + 1)``
rounded up to 8; a (token, slot) past it is dropped (contributes zero).
Padded experts (granite 40 -> 48) are set to -1e30 in the router, so they
receive no tokens.

The reference's float32 steps are kept: router logits in float32,
softmax, ``top_k`` (on equal probabilities the lower expert index first,
as ``jax.lax.top_k``), renormalisation.  Its three-operand combine einsum
``gtke,gtkc,gtk->gtec`` is one batched product over k of ``oh * topv``
and the slot one-hot: a token's k experts are distinct, so each output
element has at most one non-zero term and both forms give the same bits,
without the ``[G, T, k, E, C]`` intermediate a literal einsum can form.
The stages are separate functions (``moe_route``, ``moe_dispatch``,
``moe_experts``, ``moe_combine``) that ``moe_apply`` chains.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.distributed.sharding import shard, shard_with_grad
from repro_torch.models import layers as L

F32 = torch.float32


def moe_init(gen, cfg: ArchConfig, device="cuda"):
    device = resolve_device(device)
    d, f = cfg.d_model, cfg.d_ff
    E = cfg.n_experts_padded
    dt = cfg.pdtype()
    scale = d ** -0.5
    normal = lambda shape, s: L._param(L._normal(gen, shape, dt, device, s))
    p = {
        "router": nn.ParameterDict({"w": normal((d, E), scale)}),
        "experts": nn.ParameterDict({
            "w_gate": normal((E, d, f), scale),
            "w_up": normal((E, d, f), scale),
            "w_down": normal((E, f, d), f ** -0.5),
        }),
    }
    if cfg.shared_expert:
        p["shared"] = L.swiglu_init(gen, d, f, dt, device)
    return nn.ModuleDict(p)


def n_groups_for(tokens: int, cfg: ArchConfig) -> int:
    """The routing groups of ``tokens`` tokens: groups of the largest
    divisor of ``tokens`` at or below ``cfg.moe_group_tokens``."""
    gs = min(cfg.moe_group_tokens, tokens)
    while tokens % gs:
        gs -= 1
    return tokens // gs


class Routing(NamedTuple):
    """A group batch's routing: ``gate`` the router probabilities ``[G, T,
    E]`` (float32), ``topv``/``topi`` the renormalised top-k weights and
    expert ids ``[G, T, k]``, ``pos`` each (token, slot)'s rank in its
    expert and ``keep`` whether it is inside the capacity ``cap``."""
    gate: torch.Tensor  # [G, T, E] float32
    topv: torch.Tensor  # [G, T, k] float32
    topi: torch.Tensor  # [G, T, k] int64
    pos: torch.Tensor   # [G, T, k] int32
    keep: torch.Tensor  # [G, T, k] bool
    cap: int


def capacity(T: int, cfg: ArchConfig) -> int:
    cap = int((T * cfg.top_k * cfg.capacity_factor) / cfg.n_experts + 1)
    return max(cap - cap % -8, 8)  # round up to 8


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, and on equal
    values the lower index first (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p, xg: torch.Tensor, cfg: ArchConfig) -> Routing:
    """Top-k routing of the groups ``xg [G, T, d]``."""
    G, T, _ = xg.shape
    E_real, E, k = cfg.n_experts, cfg.n_experts_padded, cfg.top_k
    logits = L.dense(p["router"], xg, compute_dtype=F32)        # [G, T, E]
    if E != E_real:
        pad_mask = torch.arange(E, device=xg.device) >= E_real
        logits = torch.where(pad_mask[None, None, :], -1e30, logits)
    gate = torch.softmax(logits, dim=-1)
    topv, topi = top_k(gate, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    cap = capacity(T, cfg)
    # expert one-hot [G, T, k, E]; rank of each (token, slot) in its expert
    oh = nn.functional.one_hot(topi, E).to(torch.int32)
    flat = oh.reshape(G, T * k, E)
    pos = torch.cumsum(flat, dim=1, dtype=torch.int32) - 1
    pos = (pos * flat).sum(-1, dtype=torch.int32).reshape(G, T, k)
    return Routing(gate, topv, topi, pos, pos < cap, cap)


def moe_dispatch(r: Routing, xg: torch.Tensor, cfg: ArchConfig):
    """The experts' inputs ``xe [G, E, C, d]`` and the combine weights
    ``comb [G, T, E, C]`` (float32) of routing ``r``."""
    cd = cfg.cdtype()
    G, T, k = r.topi.shape
    E, C = cfg.n_experts_padded, r.cap
    oh = nn.functional.one_hot(r.topi, E)                       # [G, T, k, E]
    slot = torch.where(r.keep, r.pos, C)
    # a dropped (token, slot) points past the last slot: an all-zero row
    pos_oh = slot[..., None] == torch.arange(C, device=slot.device)
    oh_t = oh.reshape(G * T, k, E).transpose(1, 2)              # [GT, E, k]
    pos_oh = pos_oh.reshape(G * T, k, C)
    disp = torch.bmm(oh_t.to(cd), pos_oh.to(cd))
    comb = torch.bmm((oh_t * r.topv.reshape(G * T, 1, k)).to(F32),
                     pos_oh.to(F32))
    # gtec,gtd->gecd: every (expert, slot) takes at most one token
    xe = torch.bmm(disp.reshape(G, T, E * C).transpose(1, 2),
                   xg.to(cd))                                   # [G, EC, d]
    return xe.reshape(G, E, C, -1), comb.reshape(G, T, E, C)


def moe_experts(p, xe: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The experts' SwiGLU on ``xe [G, E, C, d]`` -> ``[G, E, C, d]``."""
    cd = cfg.cdtype()
    G, E, C, d = xe.shape
    w_g = p["experts"]["w_gate"].to(cd)
    w_u = p["experts"]["w_up"].to(cd)
    w_d = p["experts"]["w_down"].to(cd)
    xs = xe.transpose(0, 1).reshape(E, G * C, d)                # [E, GC, d]
    g = torch.bmm(xs, w_g)
    u = torch.bmm(xs, w_u)
    # jax.nn.silu is x * sigmoid(x), rounded op by op
    ye = torch.bmm(g * torch.sigmoid(g) * u, w_d)               # [E, GC, d]
    return ye.reshape(E, G, C, d).transpose(0, 1)


def moe_combine(comb: torch.Tensor, ye: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """gtec,gecd->gtd: each token's kept slots weighted by ``comb``."""
    G, T, E, C = comb.shape
    return torch.bmm(comb.to(cfg.cdtype()).reshape(G, T, E * C),
                     ye.reshape(G, E * C, -1))


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig, *,
              n_groups: int | None = None) -> torch.Tensor:
    """``x [B, S, d]`` -> ``[B, S, d]``."""
    B, S, d = x.shape
    G = n_groups_for(B * S, cfg) if n_groups is None else n_groups
    # the groups' gradient is held to their placements: left to the
    # backward's ops it can come back split over every mesh axis, which
    # the reshape's backward cannot view as [B, S, d] when B has fewer
    # rows than the mesh has devices
    xg = shard_with_grad(x.reshape(G, (B * S) // G, d), "batch", None, None)
    r = moe_route(p, xg, cfg)
    xe, comb = moe_dispatch(r, xg, cfg)
    xe = shard(xe, "batch", "experts", None, None)
    ye = shard(moe_experts(p, xe, cfg), "batch", "experts", None, None)
    y = moe_combine(comb, ye, cfg).reshape(B, S, d)
    if cfg.shared_expert:
        y = y + L.swiglu(p["shared"], x, compute_dtype=cfg.cdtype())
    return y


def moe_aux_loss(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): E * sum_e f_e * p_e."""
    E_real = cfg.n_experts
    logits = L.dense(p["router"], x, compute_dtype=F32)[..., :E_real]
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    lead = tuple(range(top1.dim()))
    f = nn.functional.one_hot(top1, E_real).to(F32).mean(dim=lead)
    pbar = probs.mean(dim=lead)
    return E_real * torch.sum(f * pbar)
