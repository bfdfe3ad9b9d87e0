"""Whisper-base: encoder-decoder; conv audio frontend is a STUB
(input_specs supplies post-conv frame embeddings [B, enc_len, d_model]).
[arXiv:2212.04356 (unverified)]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,          # per stack
    enc_layers=6,
    dec_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    enc_len=1500,
    source="arXiv:2212.04356",
)
