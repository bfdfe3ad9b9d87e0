"""InternVL2-26B language backbone (InternLM2-20B-like): dense GQA decoder
with prepended InternViT patch embeddings (stub frontend - the batch
supplies precomputed [B, vis_len, d_model] embeddings). [arXiv:2404.16821]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,   # odd vocab -> padded to 92672
    vis_len=256,
    source="arXiv:2404.16821",
)
