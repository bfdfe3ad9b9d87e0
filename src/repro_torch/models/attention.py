"""GQA attention: projections, rotary, full-sequence (causal or not),
prefill and decode paths.

The reference's ``shard(...)`` annotations place tensors on a device
mesh; on one device they are no-ops and are left out.  KV caches keep the
reference's layout, ``(k [B, T, KV, D], v [B, T, KV, D])`` per layer;
``attn_decode`` writes the new token into them in place, as the
reference's donated cache is updated in place.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers as L

F32 = torch.float32


def attn_init(gen, cfg: ArchConfig, device="cuda"):
    device = resolve_device(device)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=cfg.pdtype(), device=device)
    return nn.ModuleDict({
        "wq": L.dense_init(gen, d, h * hd, bias=cfg.qkv_bias, **kw),
        "wk": L.dense_init(gen, d, kv * hd, bias=cfg.qkv_bias, **kw),
        "wv": L.dense_init(gen, d, kv * hd, bias=cfg.qkv_bias, **kw),
        "wo": L.dense_init(gen, h * hd, d, **kw),
    })


def _project_qkv(p, x, cfg: ArchConfig, positions):
    """q, k, v ``[B, S, H, D]``, rotated at ``positions [B, S]`` (None:
    no rotary, as Whisper's learned and sinusoidal positions)."""
    cd = cfg.cdtype()
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.dense(p["wq"], x, compute_dtype=cd).reshape(B, S, h, hd)
    k = L.dense(p["wk"], x, compute_dtype=cd).reshape(B, S, kv, hd)
    v = L.dense(p["wv"], x, compute_dtype=cd).reshape(B, S, kv, hd)
    if positions is not None:
        q = L.rotary(q, positions, fraction=cfg.rotary_fraction,
                     base=cfg.rope_base)
        k = L.rotary(k, positions, fraction=cfg.rotary_fraction,
                     base=cfg.rope_base)
    return q, k, v


def _attend(p, x, cfg: ArchConfig, positions, impl: str, causal: bool):
    """Attention of ``x [B, S, d]`` -> (``[B, S, d]``, k, v)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = flash_ops.mha(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=causal, impl=impl)
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    return L.dense(p["wo"], o, compute_dtype=cfg.cdtype()), k, v


def attn_apply(p, x, cfg: ArchConfig, *, positions=None, causal: bool = True,
               impl: str = "naive"):
    """Full-sequence attention of ``x [B, S, d]`` at rotary ``positions
    [B, S]`` (None: no rotary), causal unless asked otherwise (Whisper's
    encoder). Returns ``[B, S, d]``."""
    return _attend(p, x, cfg, positions, impl, causal)[0]


def attn_prefill(p, x, cfg: ArchConfig, *, positions, cache_len: int,
                 impl: str = "naive"):
    """Prefill: causal attention AND the layer's cache padded to
    ``cache_len``. Returns ``(out, (k_cache, v_cache))``."""
    out, k, v = _attend(p, x, cfg, positions, impl, True)
    pad = (0, 0, 0, 0, 0, cache_len - x.shape[1])
    return out, (nn.functional.pad(k, pad), nn.functional.pad(v, pad))


def attn_decode(p, x, cache, t: int, cfg: ArchConfig, *,
                seq_parallel: bool = False, use_rotary: bool = True):
    """One decode step of ``x [B, 1, d]`` at position ``t`` against the
    layer's cache ``(k [B, T, KV, D], v [B, T, KV, D])``, which is
    updated in place and returned with the output ``[B, 1, d]``;
    ``use_rotary=False`` (Whisper) leaves q and k unrotated.

    Plain torch, as the reference leaves this step to XLA: scores in
    float32 (bf16 products accumulated in float32, as its
    ``preferred_element_type``), the ``-1e30`` mask past ``t``, and the
    exponentials cast to the compute dtype before the product with V.
    """
    if seq_parallel:
        raise NotImplementedError(
            "attn_decode(seq_parallel=True) shards the cache over a device "
            "mesh (the reference's GSPMD sharding); it comes with the port "
            "of distributed/ (ROADMAP queue 1 item 5)")
    h, kv_h, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd = cfg.cdtype()
    B = x.shape[0]
    k_cache, v_cache = cache
    T = k_cache.shape[1]
    pos = (torch.full((B, 1), t, dtype=torch.int32, device=x.device)
           if use_rotary else None)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos)
    # dynamic_update_slice clamps the start so the update fits
    at = min(max(t, 0), T - 1)
    k_cache[:, at] = k_new[:, 0]
    v_cache[:, at] = v_new[:, 0]

    group = h // kv_h
    qg = q.reshape(B, kv_h, group, hd)                      # [B, KV, G, D]
    s = torch.einsum("bkgd,btkd->bkgt", qg.to(F32),
                     k_cache.to(F32)) * (hd ** -0.5)
    valid = (torch.arange(T, device=x.device) <= t)[None, None, None, :]
    s = torch.where(valid, s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    num = torch.einsum("bkgt,btkd->bkgd", e.to(cd).to(F32),
                       v_cache.to(F32))
    den = e.sum(dim=-1)
    o = (num / den[..., None]).reshape(B, 1, h * hd).to(cd)
    out = L.dense(p["wo"], o, compute_dtype=cd)
    return out, (k_cache, v_cache)


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               device="cuda"):
    """An empty ``(k, v)`` cache ``[batch, cache_len, KV, D]`` in the
    compute dtype."""
    device = resolve_device(device)
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return tuple(torch.zeros(shape, dtype=cfg.cdtype(), device=device)
                 for _ in range(2))
