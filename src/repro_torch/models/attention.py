"""GQA attention: projections, rotary, full-sequence (causal or not),
prefill and decode paths.

The reference's ``shard(...)`` annotations stand where it has them; they
act only on DTensors inside a rule context (``distributed/sharding.py``).
KV caches keep the reference's layout, ``(k [B, T, KV, D], v [B, T, KV,
D])`` per layer; ``attn_decode`` writes the new token into them in
place, as the reference's donated cache is updated in place (on a cache
whose length is sharded, the shard that holds the position writes it).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.distributed.sharding import is_dtensor, shard, shard_groups
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

    def heads(w, n: int, logical: str):
        # on a mesh, whole heads per shard before the view splits them
        y = shard_groups(L.dense(p[w], x, compute_dtype=cd), n, "batch",
                         None, logical)
        return y.reshape(B, S, n, hd)

    q, k, v = heads("wq", h, "heads"), heads("wk", kv, "kv"), heads("wv", kv,
                                                                   "kv")
    if positions is not None:
        q = L.rotary(q, positions, fraction=cfg.rotary_fraction,
                     base=cfg.rope_base)
        k = L.rotary(k, positions, fraction=cfg.rotary_fraction,
                     base=cfg.rope_base)
    q = shard(q, "batch", None, "heads", None)
    k = shard(k, "batch", None, "kv", None)
    v = shard(v, "batch", None, "kv", None)
    return q, k, v


def _attend(p, x, cfg: ArchConfig, positions, impl: str, causal: bool,
            shard_out: bool = False):
    """Attention of ``x [B, S, d]`` -> (``[B, S, d]``, k, v);
    ``shard_out``: the heads' output constrained before ``wo``, as the
    reference's ``attn_apply`` (not its prefill) does."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = flash_ops.mha(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=causal, impl=impl)
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    if shard_out:
        o = shard(o, "batch", None, "heads")
    return L.dense(p["wo"], o, compute_dtype=cfg.cdtype()), k, v


def attn_apply(p, x, cfg: ArchConfig, *, positions=None, causal: bool = True,
               impl: str = "naive"):
    """Full-sequence attention of ``x [B, S, d]`` at rotary ``positions
    [B, S]`` (None: no rotary), causal unless asked otherwise (Whisper's
    encoder). Returns ``[B, S, d]``."""
    return _attend(p, x, cfg, positions, impl, causal, shard_out=True)[0]


def attn_prefill(p, x, cfg: ArchConfig, *, positions, cache_len: int,
                 impl: str = "naive"):
    """Prefill: causal attention AND the layer's cache padded to
    ``cache_len``. Returns ``(out, (k_cache, v_cache))``."""
    out, k, v = _attend(p, x, cfg, positions, impl, True)
    B, S, KV, D = k.shape
    # zeros appended by cat, not F.pad: DTensor's pad strategy (torch
    # 2.11) gives a malformed spec on a 2-D mesh
    tail = k.new_zeros((B, cache_len - S, KV, D))
    return out, (torch.cat([k, tail], dim=1), torch.cat([v, tail], dim=1))


def _write_token(cache, at: int, new) -> None:
    """``cache[:, at] = new[:, 0]`` in place.  On a DTensor cache whose
    length (dim 1) is sharded, only the shard that holds position ``at``
    writes it, at its local offset: ``dynamic_update_slice`` on a sharded
    dim, as each GSPMD shard runs it."""
    seq = ([i for i, pl in enumerate(cache.placements) if pl == Shard(1)]
           if is_dtensor(cache) else [])
    if not seq:
        cache[:, at] = new[:, 0]
        return
    mesh = cache.device_mesh
    if is_dtensor(new):
        place = [Replicate() if pl == Shard(1) else pl
                 for pl in cache.placements]
        new = new.redistribute(mesh, place).to_local()
    local = cache.to_local()
    shard_idx = 0
    for d in seq:
        shard_idx = shard_idx * mesh.size(d) + mesh.get_local_rank(d)
    off = shard_idx * local.shape[1]
    if off <= at < off + local.shape[1]:
        local[:, at - off] = new[:, 0]


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

    ``seq_parallel=True`` constrains the cache to its length sharded over
    ``seq_kv`` (flash-decoding SP): each shard's partial products are
    summed by DTensor.  The arithmetic is unchanged, so off a mesh it
    equals ``seq_parallel=False`` exactly.  The query, scores and
    exponentials are held replicated over all but the batch, as the
    reference holds them (a sharded score tensor made GSPMD gather the
    whole V cache).
    """
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
    _write_token(k_cache, at, k_new)
    _write_token(v_cache, at, v_new)
    if seq_parallel:
        k_cache = shard(k_cache, "batch", "seq_kv", None, None)
        v_cache = shard(v_cache, "batch", "seq_kv", None, None)

    group = h // kv_h
    # replicated before the view into groups (the reference constrains
    # the grouped query so; DTensor cannot split a head-sharded dim)
    q = shard(q, "batch", None, None, None)
    qg = q.reshape(B, kv_h, group, hd)                      # [B, KV, G, D]
    qg = shard(qg, "batch", None, None, None)
    s = torch.einsum("bkgd,btkd->bkgt", qg.to(F32),
                     k_cache.to(F32)) * (hd ** -0.5)
    s = shard(s, "batch", None, None, None)
    valid = (torch.arange(T, device=x.device) <= t)[None, None, None, :]
    s = torch.where(valid, s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    e = shard(torch.exp(s - m), "batch", None, None, None)
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
