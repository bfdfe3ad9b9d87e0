"""Gradient compression for data parallelism (the port's
``repro/distributed/compression.py``).

Int8 block-quantized gradients: each leaf is flattened, padded to blocks
of 256 elements and quantized per block: symmetric, scale ``max|x| /
127``, ``round`` (half to even, as ``jnp.round``) and clipped to [-127,
127]; ``compress_roundtrip`` is the quantize-dequantize bracket that
models the compressed all-reduce's payload on one device.

``psum_compressed`` is the collective, with the reference's arithmetic:
each rank dequantizes its own blocks and the float32 values are summed
by ``core/collectives.psum``.  The reference's docstring speaks of an
int8 payload, but its function psums the dequantized float32 blocks, so
the wire carries 4 bytes an element, as here (the collective recorder of
``roofline/analysis.py`` shows it).  On the gloo backend ``psum`` stages a
CUDA leaf through pinned host memory, so CUDA ranks sum exactly as CPU
ranks do.

Also here: error feedback (residual carry) - the compression error of
step t is added to step t+1's gradient, restoring convergence for
aggressive quantization.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F

from repro_torch.core import collectives

BLOCK = 256


def quantize_int8(x: torch.Tensor):
    """x -> (q int8 ``[Nb, BLOCK]``, scale float32 ``[Nb]``, size)."""
    flat = x.to(torch.float32).reshape(-1)
    n = flat.numel()
    blocks = F.pad(flat, (0, -n % BLOCK)).reshape(-1, BLOCK)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds unlike the CPU's (and jnp's) division
    scale = blocks.abs().amax(dim=1) / torch.tensor(127.0, device=x.device)
    safe = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127)
    return q.to(torch.int8), scale, n


def dequantize_int8(q, scale, n: int, shape, dtype) -> torch.Tensor:
    x = (q.to(torch.float32) * scale[:, None]).reshape(-1)[:n]
    return x.reshape(shape).to(dtype)


def compress_roundtrip(x: torch.Tensor) -> torch.Tensor:
    q, s, n = quantize_int8(x)
    return dequantize_int8(q, s, n, x.shape, x.dtype)


def psum_compressed(grads: dict, group=None) -> dict:
    """int8-quantize -> dequantize -> sum over ``group``'s ranks (a
    ``collectives.ChainGroup``; default every rank), leaf by leaf
    (``grads``: name -> tensor); each result in its leaf's shape and
    dtype."""
    group = group or collectives.world_group()
    out = {}
    for name, g in grads.items():
        q, s, n = quantize_int8(g)
        total = collectives.psum(q.to(torch.float32) * s[:, None], group)
        out[name] = total.reshape(-1)[:n].reshape(g.shape).to(g.dtype)
    return out


class ErrorFeedback(NamedTuple):
    residual: dict      # name -> float32 tensor

    @staticmethod
    def init(grads: dict) -> "ErrorFeedback":
        return ErrorFeedback(residual={
            k: torch.zeros_like(g, dtype=torch.float32)
            for k, g in grads.items()})


def compress_with_feedback(grads: dict, ef: ErrorFeedback):
    """Returns (compressed_grads, new_error_feedback)."""
    out, residual = {}, {}
    for name, g in grads.items():
        corrected = g.to(torch.float32) + ef.residual[name]
        c = compress_roundtrip(corrected)
        out[name] = c.to(g.dtype)
        residual[name] = corrected - c.to(torch.float32)
    return out, ErrorFeedback(residual=residual)
