"""Int8 block quantization of gradients (the port's copy of the part of
``repro/distributed/compression.py`` that ``train_step`` uses).

Each leaf is flattened, padded to blocks of 256 elements and quantized
per block: symmetric, scale ``max|x| / 127``, ``round`` (half to even, as
``jnp.round``) and clipped to [-127, 127]; ``compress_roundtrip`` is the
quantize-dequantize bracket that models the compressed data-parallel
all-reduce's payload on one device.  The collective itself
(``psum_compressed``) and error feedback come with the port of the
multi-device paths.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

BLOCK = 256


def quantize_int8(x: torch.Tensor):
    """x -> (q int8 ``[Nb, BLOCK]``, scale float32 ``[Nb]``, size)."""
    flat = x.to(torch.float32).reshape(-1)
    n = flat.numel()
    blocks = F.pad(flat, (0, -n % BLOCK)).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    safe = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127)
    return q.to(torch.int8), scale, n


def dequantize_int8(q, scale, n: int, shape, dtype) -> torch.Tensor:
    x = (q.to(torch.float32) * scale[:, None]).reshape(-1)[:n]
    return x.reshape(shape).to(dtype)


def compress_roundtrip(x: torch.Tensor) -> torch.Tensor:
    q, s, n = quantize_int8(x)
    return dequantize_int8(q, s, n, x.shape, x.dtype)
