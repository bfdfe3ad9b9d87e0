"""Train-step builders (the port's copy of ``repro/train/train_step.py``):
loss -> gradients -> AdamW, with microbatch accumulation, the int8
gradient round trip and the ``OptFlags`` knobs (remat, chunked
cross-entropy, attention impl, the bf16 parameter cast).

The gradients are ``torch.autograd.grad`` of the loss with respect to
every parameter, returned as a dict keyed by parameter name; attention
with ``attn_impl="chunked"`` runs ``ChunkedAttention`` (on a card the
flash_attention kernel and its backward kernels).  The parameters are
the model's ``nn.Module`` tree, updated in place by ``optimizer.update``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import compression
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models.transformer import BASELINE_FLAGS, OptFlags
from repro_torch.train import optimizer as opt

F32 = torch.float32


# the reference's layer stacks: its leaves there are [L, ...] arrays
STACKS = ("layers", "enc_layers", "dec_layers")


def stacked_groups(names) -> dict:
    """Parameter names grouped as the reference's leaves: the names of
    one path through every block of a layer stack (``layers.<i>.<path>``,
    in layer order) form one group, any other name its own."""
    groups: dict = {}
    for n in names:
        parts = n.split(".")
        key = ((parts[0], ".".join(parts[2:]))
               if parts[0] in STACKS and parts[1].isdigit() else (n,))
        groups.setdefault(key, []).append(n)
    return groups


def compress_stacked(grads: dict) -> dict:
    """``compression.compress_roundtrip`` of each of the reference's
    leaves: a layer stack's gradients stacked on ``[L, ...]`` first, so the
    256-element blocks (and their scales) are the reference's."""
    out = {}
    for names in stacked_groups(grads).values():
        c = compression.compress_roundtrip(
            torch.stack([grads[n] for n in names]))
        out.update(zip(names, c.unbind(0)))
    return out


def cast_view(params, fn):
    """The parameter tree as plain dicts and lists (what the model
    functions read by key and index) with ``fn(tensor)`` in place of every
    leaf, so a leaf may be a tensor autograd differentiates through."""
    if isinstance(params, (nn.ParameterDict, nn.ModuleDict, L.ParamTree)):
        return {k: cast_view(v, fn) for k, v in params.items()}
    if isinstance(params, nn.ModuleList):
        return [cast_view(m, fn) for m in params]
    return fn(params)


def _bf16(p: torch.Tensor) -> torch.Tensor:
    """The reference's step-entry cast: float32 leaves of 2 or more
    dimensions to bf16; norm scales and the other 1-D leaves stay."""
    if p.dtype == F32 and p.dim() >= 2:
        return p.to(torch.bfloat16)
    return p


def build_train_step(cfg: ArchConfig, opt_cfg: opt.AdamWConfig,
                     flags: OptFlags = BASELINE_FLAGS, *,
                     accum_steps: int = 1, compress_grads: bool = False):
    """Returns ``train_step(params, opt_state, batch) -> (params, state,
    stats)``, ``stats`` holding ``loss``, ``grad_norm`` and ``lr`` (0-d
    tensors).  ``accum_steps > 1`` splits the batch on its leading axis
    and accumulates loss and gradients in float32, each divided by
    ``accum_steps``."""
    lf = api.loss_fn(cfg)

    def loss_fn(params, batch):
        if flags.cast_params_bf16:
            # gradients come back float32 through the cast
            params = cast_view(params, _bf16)
        return lf(params, batch, flags)

    def value_and_grad(params, batch):
        named = dict(params.named_parameters())
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        return loss.detach(), {
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(named.items(), grads)}

    def train_step(params, opt_state, batch):
        if accum_steps == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            micro = {k: x.reshape((accum_steps, x.shape[0] // accum_steps)
                                  + tuple(x.shape[1:]))
                     for k, x in batch.items()}
            dev = next(params.parameters()).device
            loss = torch.zeros((), dtype=F32, device=dev)
            grads = {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                     for k, p in params.named_parameters()}
            for i in range(accum_steps):
                l, g = value_and_grad(params,
                                      {k: x[i] for k, x in micro.items()})
                loss = loss + l / accum_steps
                for k in grads:
                    grads[k] = grads[k] + g[k].to(F32) / accum_steps
        if compress_grads:
            # the int8 round trip models the compressed all-reduce payload
            grads = compress_stacked(grads)
        params, state, stats = opt.update(opt_cfg, grads, opt_state, params)
        stats["loss"] = loss
        return params, state, stats

    return train_step


def init_train_state(cfg: ArchConfig, gen: torch.Generator, device="cuda",
                     opt_cfg: Optional[opt.AdamWConfig] = None):
    """Random parameters from ``gen`` on ``device``, every one trainable
    (``requires_grad``), and fresh AdamW state."""
    params = api.init_params(cfg, gen, device)
    for p in params.parameters():
        p.requires_grad_(True)
    return params, opt.init(params)
