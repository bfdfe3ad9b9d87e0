"""Model API of the port (the reference's ``models/api.py``), dense, MoE,
SSM and hybrid families:

  init_params(cfg, gen, device)                -> params
  prefill_fn(cfg)(params, batch, cache_len)    -> (logits, cache)
  decode_fn(cfg)(params, cache, token)         -> (logits, cache')
  init_decode_cache(cfg, batch, cache_len)     -> cache

The MoE family's cache is the dense ``{"kv", "t"}`` cache.  For the SSM
family ``cache_len`` is not read: its decode state is O(1) in the
sequence.  The hybrid's cache holds both, the SSM states of every layer
and a KV cache for each application of the shared attention block
(``transformer``'s docstring).  The encoder-decoder family raises
``NotImplementedError`` here.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as TF
from repro_torch.models.transformer import BASELINE_FLAGS


def _no_encdec(cfg: ArchConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family comes with a later "
            "slice of the port")


def init_params(cfg: ArchConfig, gen, device="cuda"):
    _no_encdec(cfg)
    return TF.init_lm(cfg, gen, device)


def prefill_fn(cfg: ArchConfig):
    _no_encdec(cfg)
    return lambda params, batch, cache_len, flags=BASELINE_FLAGS: (
        TF.lm_prefill(params, cfg, batch["tokens"], cache_len=cache_len,
                      embeds=batch.get("embeds"), flags=flags))


def decode_fn(cfg: ArchConfig):
    _no_encdec(cfg)
    return lambda params, cache, token, flags=BASELINE_FLAGS: (
        TF.lm_decode_step(params, cfg, cache, token, flags=flags))


def init_decode_cache(cfg: ArchConfig, batch: int, cache_len: int,
                      device="cuda"):
    _no_encdec(cfg)
    return TF.init_decode_cache(cfg, batch, cache_len, device)
