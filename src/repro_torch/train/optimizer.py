"""AdamW (the port's copy of ``repro/train/optimizer.py``): global-norm
clipping, decoupled weight decay, linear warmup then cosine decay, all
in float32.

The reference is functional over pytrees; here the state is a
``NamedTuple`` of the step and two dicts of float32 tensors keyed by
parameter name (``params.named_parameters()``'s names), and ``update``
writes the parameters and the moments in place under ``torch.no_grad()``.
It returns ``(params, state, stats)`` as the reference does, ``stats``
holding ``grad_norm`` and ``lr`` (0-d tensors).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32, 0-d
    mu: dict               # name -> float32 tensor
    nu: dict


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``cfg.lr`` over ``warmup_steps``, then a cosine
    down to ``min_lr_ratio * lr`` at ``total_steps`` (float32, 0-d)."""
    step = torch.as_tensor(step).to(F32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> AdamWState:
    """Zero moments for every parameter, on its device."""
    named = dict(params.named_parameters())
    mu = {k: torch.zeros_like(p, dtype=F32) for k, p in named.items()}
    nu = {k: torch.zeros_like(p, dtype=F32) for k, p in named.items()}
    dev = next(iter(named.values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=mu, nu=nu)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tensors))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict, state: AdamWState, params):
    """One step from ``grads`` (name -> gradient): the parameters and the
    moments are written in place; returns ``(params, new_state,
    stats)``."""
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(F32)
    b2c = 1 - cfg.b2 ** step.to(F32)
    for name, p in params.named_parameters():
        m, v = state.mu[name], state.nu[name]
        g = grads[name].to(F32) * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        pf = p.to(F32)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + \
            cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), {
        "grad_norm": gnorm, "lr": lr}
