"""Llama-3.2-3B: small llama3 dense GQA decoder. [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    rope_base=500000.0,
    source="hf:meta-llama/Llama-3.2-1B (unverified)",
)
