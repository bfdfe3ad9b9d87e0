"""Mamba2-1.3B: attention-free SSD (state-space duality) decoder.
[arXiv:2405.21060 (unverified)]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    source="arXiv:2405.21060",
)
