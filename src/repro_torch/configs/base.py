"""Architecture config schema + registry (the port's copy of
``repro/configs/base.py``).

Every architecture of the port is a ``repro_torch/configs/<id>.py``
exporting ``CONFIG`` with the hyperparameters the reference gives it;
``reduced()`` derives the CPU smoke-test variant (same family and
topology, tiny widths).  ``cdtype()``/``pdtype()`` return torch dtypes.
Every architecture id of the reference resolves: the dense decoders, the
MoE family (granite, llama4 scout), the SSM family (mamba2), the hybrid
(zamba2), the encoder-decoder (whisper) and the VLM (internvl2).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Megatron-style vocab padding for clean TP sharding."""
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention details
    d_head: Optional[int] = None   # default d_model // n_heads
    qkv_bias: bool = False
    rotary_fraction: float = 1.0   # chatglm3 "2d RoPE" rotates half the dims
    rope_base: float = 10000.0
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    expert_pad: int = 0
    moe_group_tokens: int = 2048

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4

    # hybrid (zamba2): shared attention block applied every k mamba layers
    shared_attn_every: int = 0

    # encoder-decoder (whisper)
    enc_layers: int = 0
    dec_layers: int = 0
    enc_len: int = 1500

    # multimodal stubs
    vis_len: int = 0               # VLM: prepended patch-embedding tokens

    # precision
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # provenance
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (SSM/hybrid): long_500k
        eligibility (``shapes.applicable``)."""
        return self.family in ("ssm", "hybrid")

    @property
    def n_experts_padded(self) -> int:
        return self.n_experts + self.expert_pad

    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    # -- parameter counting (excludes embeddings) --------------------------
    def param_count(self, active_only: bool = False) -> int:
        d, f = self.d_model, self.d_ff
        if self.family == "ssm":  # attention-free: no head_dim defined
            return self.n_layers * self._mamba_params()
        hd = self.head_dim
        att = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.family == "hybrid":
            shared = att + 3 * d * f
            return self.n_layers * self._mamba_params() + shared
        mlp3 = 3 * d * f
        if self.family == "moe" and self.n_experts:
            e = self.top_k if active_only else self.n_experts
            moe = e * mlp3 + d * self.n_experts
            if self.shared_expert:
                moe += mlp3
            per_layer = att + moe
        elif self.family == "encdec":
            return (self.enc_layers * (att + 2 * d * f)
                    + self.dec_layers * (2 * att + 2 * d * f))
        else:
            per_layer = att + mlp3
        return self.n_layers * per_layer

    def _mamba_params(self) -> int:
        d, di = self.d_model, self.d_inner
        n, h = self.ssm_state, self.ssm_heads
        in_proj = d * (2 * di + 2 * n + h)
        conv = self.ssm_conv * (di + 2 * n)
        return in_proj + di * d + conv + 3 * h

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family & topology, tiny widths."""
        small_heads = max(2, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, small_heads))
        while small_heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4),
            d_model=128,
            d_head=32,
            n_heads=small_heads,
            n_kv_heads=kv,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            expert_pad=0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=32 if self.ssm_state else 64,
            shared_attn_every=2 if self.shared_attn_every else 0,
            enc_layers=min(self.enc_layers, 2),
            dec_layers=min(self.dec_layers, 2),
            enc_len=32,
            vis_len=8 if self.vis_len else 0,
        )


_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "llama3.2-3b": "llama3_2_3b",
    "mamba2-1.3b": "mamba2_1_3b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "zamba2-2.7b": "zamba2_2_7b",
    "internvl2-26b": "internvl2_26b",
    "whisper-base": "whisper_base",
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
