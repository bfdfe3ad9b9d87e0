"""Whisper-style encoder-decoder backbone (the port's copy of the
reference's ``repro/models/encdec.py``, its serving paths).

The conv audio frontend is a stub, as in the reference: the batch
supplies post-conv frame embeddings ``frames [B, enc_len, d_model]``;
everything from there (sinusoidal positions, the bidirectional encoder,
the causal decoder with cross-attention, the decode caches with the
precomputed cross K/V) is real.  Whisper blocks are pre-LayerNorm with
GELU MLPs.  The layer stacks are ``nn.ModuleList``s (``enc_layers``,
``dec_layers``) of the reference's per-layer dicts, and the top level is
a ``layers.ParamTree`` (the learned decoder positions ``pos_dec`` sit
beside the sub-dicts), so ``repro_torch.convert`` moves the reference's
tree across key by key.

Prefill attention (the encoder's, non-causal; the decoder's causal
self-attention; its cross-attention, non-causal over the encoder's
frames) runs ``flags.attn_impl``: on a card with "pallas" every one of
those calls is a launch of the flash_attention kernel.  Decode is plain
torch, as the reference leaves it to XLA: the self-attention step of
``attention.attn_decode`` without rotary, and the cross-attention of the
one new position through ``mha(impl="naive")``, the reference's default
there.  The cache is ``{"kv": (k, v) [L, B, T, KV, D], "cross": (k, v)
[L, B, enc_len, KV, D], "t": int}``; decode writes ``kv`` in place.
Training: ``decode_train`` is the teacher-forced decoder pass and
``encdec_loss`` its cross-entropy (chunked when ``flags.chunked_ce`` and
the token count is a multiple of ``ce_chunk``, as the reference's); each
encoder and decoder layer runs under ``transformer.remat``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.distributed.sharding import shard
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import (BASELINE_FLAGS, OptFlags, remat,
                                            residual)

F32 = torch.float32
# rows of the learned decoder positions: the reference sizes the table for
# its largest decode shape (real Whisper has 448)
POS_DEC_ROWS = 32_768


def _memory_kv(p, memory, cfg: ArchConfig):
    """The cross-attention's k, v ``[B, T, KV, D]`` of the encoder output
    ``memory [B, T, d]``."""
    cd = cfg.cdtype()
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    B, T, _ = memory.shape
    k = L.dense(p["wk"], memory, compute_dtype=cd).reshape(B, T, kv, hd)
    v = L.dense(p["wv"], memory, compute_dtype=cd).reshape(B, T, kv, hd)
    return k, v


def _cross_apply(p, x, memory_kv, cfg: ArchConfig, impl: str = "naive"):
    """Cross-attention: queries from ``x [B, S, d]``, ``(k, v)``
    precomputed from the encoder; non-causal."""
    cd = cfg.cdtype()
    h, hd = cfg.n_heads, cfg.head_dim
    B, S, _ = x.shape
    q = L.dense(p["wq"], x, compute_dtype=cd).reshape(B, S, h, hd)
    k, v = memory_kv
    o = flash_ops.mha(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=False, impl=impl)
    o = o.transpose(1, 2).reshape(B, S, h * hd)
    return L.dense(p["wo"], o, compute_dtype=cd)


def init_encdec(cfg: ArchConfig, gen: torch.Generator, device="cuda"):
    """Random parameters from ``gen`` (drawn on the generator's device),
    placed on ``device``, in the reference's tree."""
    device = resolve_device(device)
    dt, d = cfg.pdtype(), cfg.d_model

    def enc_block():
        return nn.ModuleDict({
            "ln1": L.layernorm_init(d, dt, device),
            "attn": A.attn_init(gen, cfg, device),
            "ln2": L.layernorm_init(d, dt, device),
            "mlp": L.gelu_mlp_init(gen, d, cfg.d_ff, dt, device),
        })

    def dec_block():
        return nn.ModuleDict({
            "ln1": L.layernorm_init(d, dt, device),
            "self_attn": A.attn_init(gen, cfg, device),
            "ln_x": L.layernorm_init(d, dt, device),
            "cross_attn": A.attn_init(gen, cfg, device),
            "ln2": L.layernorm_init(d, dt, device),
            "mlp": L.gelu_mlp_init(gen, d, cfg.d_ff, dt, device),
        })

    return L.ParamTree({
        "embed": L.embed_init(gen, cfg.vocab_padded, d, dt, device),
        "pos_dec": L._normal(gen, (POS_DEC_ROWS, d), dt, device, 0.01),
        "enc_layers": nn.ModuleList([enc_block()
                                     for _ in range(cfg.enc_layers)]),
        "dec_layers": nn.ModuleList([dec_block()
                                     for _ in range(cfg.dec_layers)]),
        "enc_ln": L.layernorm_init(d, dt, device),
        "dec_ln": L.layernorm_init(d, dt, device),
        "head": L.dense_init(gen, d, cfg.vocab_padded, dtype=dt,
                             device=device),
    })


def _ln(p, x):
    """LayerNorm of the residual stream, which on a mesh is held
    replicated but for its batch first (``transformer.residual``)."""
    return L.layernorm(p, residual(x))


def encode(params, cfg: ArchConfig, frames: torch.Tensor,
           flags: OptFlags = BASELINE_FLAGS) -> torch.Tensor:
    """``frames [B, T, d]`` (the stub conv output) -> memory ``[B, T, d]``
    through the bidirectional encoder."""
    cd = cfg.cdtype()
    B, T, d = frames.shape
    x = frames.to(cd) + L.sinusoidal_positions(T, d, frames.device).to(
        cd)[None]
    x = shard(x, "batch", None, None)

    def block(lp, x):
        h = x + A.attn_apply(lp["attn"], _ln(lp["ln1"], x), cfg,
                             positions=None, causal=False,
                             impl=flags.attn_impl)
        return h + L.gelu_mlp(lp["mlp"], _ln(lp["ln2"], h),
                              compute_dtype=cd)

    for lp in params["enc_layers"]:
        x = remat(block, flags)(lp, x)
    return _ln(params["enc_ln"], x)


def decode_train(params, cfg: ArchConfig, tokens, memory,
                 flags: OptFlags = BASELINE_FLAGS) -> torch.Tensor:
    """Teacher-forced decoder pass over ``tokens [B, S]`` against the
    encoder's ``memory`` -> hidden states ``[B, S, d]`` (after the final
    LayerNorm)."""
    cd = cfg.cdtype()
    S = tokens.shape[1]
    x = L.embed(params["embed"], tokens, compute_dtype=cd)
    x = shard(x + params["pos_dec"][:S].to(cd)[None], "batch", None, None)

    def block(lp, x):
        mem_kv = _memory_kv(lp["cross_attn"], memory, cfg)
        h = x + A.attn_apply(lp["self_attn"], _ln(lp["ln1"], x), cfg,
                             positions=None, causal=True,
                             impl=flags.attn_impl)
        h = h + _cross_apply(lp["cross_attn"], _ln(lp["ln_x"], h),
                             mem_kv, cfg, impl=flags.attn_impl)
        return h + L.gelu_mlp(lp["mlp"], _ln(lp["ln2"], h),
                              compute_dtype=cd)

    for lp in params["dec_layers"]:
        x = remat(block, flags)(lp, x)
    return _ln(params["dec_ln"], x)


def encdec_loss(params, cfg: ArchConfig, batch: dict,
                flags: OptFlags = BASELINE_FLAGS) -> torch.Tensor:
    """Cross-entropy of the decoder's next-token predictions; batch:
    ``frames``, ``tokens``, ``labels``."""
    memory = encode(params, cfg, batch["frames"], flags)
    hidden = decode_train(params, cfg, batch["tokens"], memory, flags)
    hw = params["head"]["w"]
    if flags.chunked_ce and batch["tokens"].shape[1] % flags.ce_chunk == 0:
        return L.chunked_xent(hidden, hw, batch["labels"],
                              chunk=flags.ce_chunk)
    logits = (hidden @ hw.to(hidden.dtype)).to(F32)
    logits = shard(logits, "batch", None, "vocab")
    return L.softmax_xent(logits, batch["labels"])


def _logits(params, x):
    x = _ln(params["dec_ln"], x)
    return (x @ params["head"]["w"].to(x.dtype)).to(F32)


def encdec_prefill(params, cfg: ArchConfig, frames, tokens, *,
                   cache_len: int, flags: OptFlags = BASELINE_FLAGS):
    """Encode the audio ``frames`` and prefill the decoder prompt
    ``tokens [B, S]``. Returns (last-position logits ``[B, 1, V]``
    float32, the cache of the module's docstring with ``t = S``)."""
    cd = cfg.cdtype()
    memory = encode(params, cfg, frames, flags)
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens, compute_dtype=cd)
    x = x + params["pos_dec"][:S].to(cd)[None]
    ks, vs, cks, cvs = [], [], [], []
    for lp in params["dec_layers"]:
        mem_kv = _memory_kv(lp["cross_attn"], memory, cfg)
        # learned positions: no rotary
        a, (k, v) = A.attn_prefill(
            lp["self_attn"], _ln(lp["ln1"], x), cfg, positions=None,
            cache_len=cache_len, impl=flags.attn_impl)
        h = x + a
        h = h + _cross_apply(lp["cross_attn"], _ln(lp["ln_x"], h),
                             mem_kv, cfg, impl=flags.attn_impl)
        x = h + L.gelu_mlp(lp["mlp"], _ln(lp["ln2"], h),
                           compute_dtype=cd)
        ks.append(k)
        vs.append(v)
        cks.append(mem_kv[0])
        cvs.append(mem_kv[1])
    cache = {"kv": (torch.stack(ks), torch.stack(vs)),
             "cross": (torch.stack(cks), torch.stack(cvs)), "t": S}
    return _logits(params, x[:, -1:]), cache


def encdec_decode_step(params, cfg: ArchConfig, cache, token,
                       flags: OptFlags = BASELINE_FLAGS):
    """One decoder token step: ``token [B, 1]`` -> (logits ``[B, 1, V]``
    float32, the cache with ``t + 1``; its self-attention K/V updated in
    place)."""
    cd = cfg.cdtype()
    t = cache["t"]
    x = L.embed(params["embed"], token, compute_dtype=cd)
    pos = params["pos_dec"]
    at = min(max(t, 0), pos.shape[0] - 1)    # dynamic_slice clamps
    x = x + pos[at: at + 1].to(cd)[None]
    (k, v), (ck, cv) = cache["kv"], cache["cross"]
    for i, lp in enumerate(params["dec_layers"]):
        # Whisper: learned positions, no rotary
        a, _ = A.attn_decode(lp["self_attn"], _ln(lp["ln1"], x),
                             (k[i], v[i]), t, cfg, use_rotary=False)
        h = x + a
        h = h + _cross_apply(lp["cross_attn"], _ln(lp["ln_x"], h),
                             (ck[i], cv[i]), cfg)
        x = h + L.gelu_mlp(lp["mlp"], _ln(lp["ln2"], h),
                           compute_dtype=cd)
    return _logits(params, x), {**cache, "t": t + 1}


def init_encdec_cache(cfg: ArchConfig, batch: int, cache_len: int,
                      device="cuda"):
    """A fresh (empty) decode cache, laid out as ``encdec_prefill``'s."""
    dev = resolve_device(device)

    def zeros(T):
        shape = (cfg.dec_layers, batch, T, cfg.n_kv_heads, cfg.head_dim)
        return tuple(torch.zeros(shape, dtype=cfg.cdtype(), device=dev)
                     for _ in range(2))
    return {"kv": zeros(cache_len), "cross": zeros(cfg.enc_len), "t": 0}
