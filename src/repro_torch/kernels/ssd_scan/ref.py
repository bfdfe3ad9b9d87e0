"""Plain PyTorch versions of the SSD scan (the reference's
``repro/kernels/ssd_scan/ref.py``).

Per head, with state ``h`` in ``R^{N x P}``:

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t (x) x_t
    y_t = C_t^T h_t + D * x_t

``ssd_scan_with_final_ref`` is the literal per-step recurrence (the
``ssd(impl="recurrent")`` path and the oracle); ``ssd_chunked`` is the
chunked form the ssd_scan kernel computes (``ssd(impl="chunked")``, and
the kernel's plain version): within a chunk of Q steps the masked
``(C B^T * exp(cum_t - cum_s)) * dt_s`` product with ``x``, across chunks
the ``[N, P]`` state.  Both work in float32 and return ``y`` in x's dtype
and the final state ``[BH, N, P]`` in float32.  Inputs are ``x [BH, L,
P]``, ``dt [BH, L]``, ``A``/``D [BH]``, ``B``/``C [BH, L, N]``.
``chunk_cb`` is the plain version of the first kernel, ``C B^T`` per
chunk.

For the tests of the kernel's numerics, ``ssd_chunked`` takes the
product its three per-head matrix products use; ``tf32_product`` and
``split_tf32_product`` emulate the tensor cores' TF32 (operands rounded
to a 10-bit mantissa, products summed in float32) and the kernel's
3xTF32 (``a_hi b_hi + a_hi b_lo + a_lo b_hi``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def flatten_heads(x, dt, A, B, C, D):
    """The model's layout (x ``[B, L, H, P]``, dt ``[B, L, H]``, A/D
    ``[H]``, B/C ``[B, L, N]`` shared by the heads) as the functions here
    take it: (batch, head) flattened batch-major, B/C broadcast per head
    (copies, as the reference's ``ops.ssd`` makes them)."""
    Bsz, L, H, P = x.shape
    N = B.shape[-1]
    return (x.transpose(1, 2).reshape(Bsz * H, L, P),
            dt.transpose(1, 2).reshape(Bsz * H, L), A.repeat(Bsz),
            B[:, None].expand(Bsz, H, L, N).reshape(Bsz * H, L, N),
            C[:, None].expand(Bsz, H, L, N).reshape(Bsz * H, L, N),
            D.repeat(Bsz))


def unflatten_heads(y, h, Bsz: int, H: int):
    """y ``[B*H, L, P]`` -> ``[B, L, H, P]`` (a view) and the final state
    ``[B*H, N, P]`` -> ``[B, H, N, P]``."""
    y = y.reshape(Bsz, H, *y.shape[1:]).transpose(1, 2)
    return y, h.reshape(Bsz, H, *h.shape[1:])


def ssd_scan_with_final_ref(x, dt, A, B, C, D):
    """The per-step recurrence: (y [BH, L, P] in x's dtype, h_final
    [BH, N, P] float32)."""
    BH, L, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = (t.to(F32) for t in (x, dt, B, C))
    Af, Df = A.to(F32), D.to(F32)
    h = torch.zeros((BH, N, P), dtype=F32, device=x.device)
    ys = []
    for t in range(L):
        dtt = dtf[:, t, None, None]
        h = (torch.exp(dtt * Af[:, None, None]) * h
             + dtt * (Bf[:, t, :, None] * xf[:, t, None, :]))
        ys.append(torch.einsum("bn,bnp->bp", Cf[:, t], h)
                  + Df[:, None] * xf[:, t])
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((BH, 0, P))
    return y.to(x.dtype), h


def ssd_scan_ref(x, dt, A, B, C, D):
    """x [BH, L, P], dt [BH, L], A [BH], B/C [BH, L, N], D [BH] -> y."""
    y, _ = ssd_scan_with_final_ref(x, dt, A, B, C, D)
    return y


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` rounded to TF32 (10-bit mantissa), to nearest with
    ties away from zero (``cvt.rna.tf32.f32``), on the int32 view."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(F32)


def tf32_truncate(a: torch.Tensor) -> torch.Tensor:
    """float32 ``a`` with its low 13 mantissa bits cleared: the TF32 part
    the tensor cores read of an operand."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(F32)


def tf32_product(a, b):
    """``a @ b`` with both operands rounded to TF32 (the products of two
    TF32 values are exact in float32)."""
    return torch.matmul(tf32_round(a), tf32_round(b))


def split_tf32_product(a, b):
    """``a @ b`` in 3xTF32, the kernel's products: each operand split
    into ``hi = tf32(v)`` (rounded) and ``lo = v - hi``, of which the
    tensor cores read the TF32 part (truncated), and ``a_lo b_hi + a_hi
    b_lo + a_hi b_hi``."""
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_truncate(a - ah), tf32_truncate(b - bh)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah, bh)


def chunk_cb(B, C, chunk: int = 64):
    """G = C B^T per chunk: B and C ``[Bz, L, N]`` -> ``[Bz, chunks, Q,
    Q]`` float32 (``Q = min(chunk, L)``; a ragged last chunk padded with
    zero rows)."""
    Bz, L, N = B.shape
    chunk = min(chunk, L)
    pad = (-L) % chunk
    Bf = F.pad(B.to(F32), (0, 0, 0, pad)).reshape(Bz, -1, chunk, N)
    Cf = F.pad(C.to(F32), (0, 0, 0, pad)).reshape(Bz, -1, chunk, N)
    return torch.einsum("bctn,bcsn->bcts", Cf, Bf)


def ssd_chunked(x, dt, A, B, C, D, chunk: int = 64, product=torch.matmul):
    """The chunked SSD, one chunk at a time: (y [BH, L, P] in x's dtype,
    h_final [BH, N, P] float32).  A ragged last chunk is padded with
    zero steps (``dt = 0``, ``x = 0``), which leave the state as it is.
    ``product`` computes the three batched per-head matrix products (M x,
    C h and the state update); C B^T is exact float32."""
    BH, L, P = x.shape
    N = B.shape[-1]
    chunk = min(chunk, L)
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        dt = F.pad(dt, (0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (L + pad) // chunk
    xf = x.to(F32).reshape(BH, nc, chunk, P)
    dtf = dt.to(F32).reshape(BH, nc, chunk)
    Bf = B.to(F32).reshape(BH, nc, chunk, N)
    Cf = C.to(F32).reshape(BH, nc, chunk, N)
    Af = A.to(F32)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    h = torch.zeros((BH, N, P), dtype=F32, device=x.device)
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        cum = torch.cumsum(dtc * Af[:, None], dim=1)       # [BH, Q], <= 0
        g = torch.einsum("btn,bsn->bts", Cc, Bc)
        decay = torch.exp(cum[:, :, None] - cum[:, None, :])
        m = torch.where(causal, g * decay, 0.0) * dtc[:, None, :]
        y = product(m, xc)
        y = y + torch.exp(cum)[:, :, None] * product(Cc, h)
        w = Bc * (dtc * torch.exp(cum[:, -1:] - cum))[:, :, None]
        h = torch.exp(cum[:, -1])[:, None, None] * h + product(
            w.transpose(1, 2), xc)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(BH, nc * chunk, P)[:, :L]
    y = y + D.to(F32)[:, None, None] * xf.reshape(BH, nc * chunk, P)[:, :L]
    return y.to(x.dtype), h
