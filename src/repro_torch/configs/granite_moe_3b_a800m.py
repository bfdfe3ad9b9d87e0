"""Granite-MoE-3B-A800M: 40 routed experts, top-8, narrow d_ff=512 experts.
Experts padded 40->48 for divisible 16-way EP (the router masks the pads).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    n_experts=40,
    top_k=8,
    expert_pad=8,
    moe_group_tokens=512,  # top-8: dispatch one-hot ~ group*48*cap
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
