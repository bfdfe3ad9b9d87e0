"""Mamba-2 SSD chunked scan: the CUDA kernel (``csrc/``) and its plain
versions."""
