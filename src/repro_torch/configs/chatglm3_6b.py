"""ChatGLM3-6B: dense GQA decoder, partial ("2d") RoPE. [arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    qkv_bias=True,
    rotary_fraction=0.5,   # ChatGLM rotates half the head dims (2d RoPE)
    source="arXiv:2406.12793",
)
