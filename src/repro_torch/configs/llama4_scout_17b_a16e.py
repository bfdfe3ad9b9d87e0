"""Llama-4-Scout-17B-16E: MoE decoder, 16 routed experts top-1 + shared
expert, early-fusion multimodal (text path only here; the fusion frontend
is out of scope). 17B active / ~109B total.
[hf:meta-llama/Llama-4-Scout-17B-16E (unverified)]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    top_k=1,
    shared_expert=True,
    rope_base=500000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
