"""Zamba2-2.7B: Mamba2 backbone + shared attention block (applied every 6
mamba layers, weights reused - Zamba2's parameter-sharing trick; the
per-invocation LoRA deltas are omitted, as in the reference).
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_headdim=64,
    shared_attn_every=6,
    source="arXiv:2411.15242",
)
