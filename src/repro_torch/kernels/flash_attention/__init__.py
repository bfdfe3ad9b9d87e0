"""Causal GQA flash attention: the CUDA kernel (``csrc/``) and its plain
versions."""
