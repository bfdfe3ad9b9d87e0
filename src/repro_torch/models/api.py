"""Model API of the port (the reference's ``models/api.py``), every
family the reference serves:

  init_params(cfg, gen, device)                -> params
  loss_fn(cfg)(params, batch, flags)           -> scalar loss
  prefill_fn(cfg)(params, batch, cache_len)    -> (logits, cache)
  decode_fn(cfg)(params, cache, token)         -> (logits, cache')
  init_decode_cache(cfg, batch, cache_len)     -> cache
  input_specs(cfg, shape, kind)                -> meta-tensor batch
  make_batch(cfg, shape, kind, key)            -> concrete batch

The MoE and VLM families' cache is the dense ``{"kv", "t"}`` cache; the
VLM's batch holds ``embeds [B, vis_len, d]`` beside ``tokens``.  For the
SSM family ``cache_len`` is not read: its decode state is O(1) in the
sequence.  The hybrid's cache holds both, the SSM states of every layer
and a KV cache for each application of the shared attention block
(``transformer``'s docstring).  The encoder-decoder family (``encdec``)
reads ``frames [B, enc_len, d]`` beside ``tokens`` and keeps the cross
K/V in its cache.  ``make_batch`` draws its integers with the port's
threefry (``core/prng.py``: ``split``, ``randint``), so tokens and labels
equal the reference's bit for bit, and its float inputs with
``prng.normal`` (to 1e-6 of the reference's but in the tails).
``input_specs`` gives the dry-run's stand-ins: tensors on the ``meta``
device, with shape and dtype and no storage.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import prng
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


def loss_fn(cfg: ArchConfig):
    if cfg.family == "encdec":
        return lambda params, batch, flags=BASELINE_FLAGS: ED.encdec_loss(
            params, cfg, batch, flags)
    return lambda params, batch, flags=BASELINE_FLAGS: TF.lm_loss(
        params, cfg, batch, flags=flags)


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


# ---------------------------------------------------------------------------
# Batch construction (concrete, for smoke tests and examples)
# ---------------------------------------------------------------------------
def _batch_shapes(cfg: ArchConfig, shape: ShapeSpec, kind: str) -> dict:
    B, S = shape.global_batch, shape.seq_len
    cd, i32 = cfg.cdtype(), torch.int32
    if kind == "train":
        if cfg.family == "encdec":
            return {"frames": ((B, cfg.enc_len, cfg.d_model), cd),
                    "tokens": ((B, S), i32), "labels": ((B, S), i32)}
        d = {"tokens": ((B, S - cfg.vis_len), i32),
             "labels": ((B, S - cfg.vis_len), i32)}
        if cfg.vis_len:
            d["embeds"] = ((B, cfg.vis_len, cfg.d_model), cd)
        return d
    if kind == "prefill":
        if cfg.family == "encdec":
            return {"frames": ((B, cfg.enc_len, cfg.d_model), cd),
                    "tokens": ((B, S), i32)}
        d = {"tokens": ((B, S - cfg.vis_len), i32)}
        if cfg.vis_len:
            d["embeds"] = ((B, cfg.vis_len, cfg.d_model), cd)
        return d
    if kind == "decode":
        return {"token": ((B, 1), i32)}
    raise ValueError(kind)


def input_specs(cfg: ArchConfig, shape: ShapeSpec, kind: str) -> dict:
    """Stand-ins for every model input (no allocation): ``meta``
    tensors of each input's shape and dtype."""
    return {k: torch.empty(shp, dtype=dt, device="meta")
            for k, (shp, dt) in _batch_shapes(cfg, shape, kind).items()}


def make_batch(cfg: ArchConfig, shape: ShapeSpec, kind: str, key) -> dict:
    """A random batch from the threefry ``key`` (``prng.PRNGKey``), on
    the key's device: integers ``randint(0, vocab)``, floats ``normal x
    0.1`` in the compute dtype, one ``split`` a leaf, as the reference's
    ``make_batch``."""
    out = {}
    for name, (shp, dt) in _batch_shapes(cfg, shape, kind).items():
        key, sub = prng.split(key)
        if dt == torch.int32:
            out[name] = prng.randint(sub, shp, 0, cfg.vocab)
        else:
            out[name] = (prng.normal(sub, shp) * 0.1).to(dt)
    return out
