"""Qwen2.5-3B: dense GQA decoder with QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
    source="hf:Qwen/Qwen2.5-0.5B",
)
