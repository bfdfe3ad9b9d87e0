"""Model API of the port (the reference's ``models/api.py``), every
family the reference serves:

  init_params(cfg, gen, device)                -> params
  prefill_fn(cfg)(params, batch, cache_len)    -> (logits, cache)
  decode_fn(cfg)(params, cache, token)         -> (logits, cache')
  init_decode_cache(cfg, batch, cache_len)     -> cache

The MoE and VLM families' cache is the dense ``{"kv", "t"}`` cache; the
VLM's batch holds ``embeds [B, vis_len, d]`` beside ``tokens``.  For the
SSM family ``cache_len`` is not read: its decode state is O(1) in the
sequence.  The hybrid's cache holds both, the SSM states of every layer
and a KV cache for each application of the shared attention block
(``transformer``'s docstring).  The encoder-decoder family (``encdec``)
reads ``frames [B, enc_len, d]`` beside ``tokens`` and keeps the cross
K/V in its cache.  The training entry points (``loss_fn``) come with the
training slice.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.models.transformer import BASELINE_FLAGS


def init_params(cfg: ArchConfig, gen, device="cuda", *,
                compute_dtype: bool = False):
    """``compute_dtype``: the parameters as ``TF.compute_params`` casts
    them, drawn as the default draws them."""
    if cfg.family == "encdec":
        params = ED.init_encdec(cfg, gen, device)
        return TF.compute_params(params, cfg) if compute_dtype else params
    return TF.init_lm(cfg, gen, device, compute_dtype=compute_dtype)


def prefill_fn(cfg: ArchConfig):
    if cfg.family == "encdec":
        return lambda params, batch, cache_len, flags=BASELINE_FLAGS: (
            ED.encdec_prefill(params, cfg, batch["frames"], batch["tokens"],
                              cache_len=cache_len, flags=flags))
    return lambda params, batch, cache_len, flags=BASELINE_FLAGS: (
        TF.lm_prefill(params, cfg, batch["tokens"], cache_len=cache_len,
                      embeds=batch.get("embeds"), flags=flags))


def decode_fn(cfg: ArchConfig):
    if cfg.family == "encdec":
        return lambda params, cache, token, flags=BASELINE_FLAGS: (
            ED.encdec_decode_step(params, cfg, cache, token, flags))
    return lambda params, cache, token, flags=BASELINE_FLAGS: (
        TF.lm_decode_step(params, cfg, cache, token, flags=flags))


def init_decode_cache(cfg: ArchConfig, batch: int, cache_len: int,
                      device="cuda"):
    if cfg.family == "encdec":
        return ED.init_encdec_cache(cfg, batch, cache_len, device)
    return TF.init_decode_cache(cfg, batch, cache_len, device)
