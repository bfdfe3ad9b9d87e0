"""SSD scan entry points of the port (the reference's ``ops.py``): the
model-facing ``[B, L, H, P]`` layout, the dispatch between the kernel
and its plain versions, and the O(1)-state decode step.

  impl="pallas"    - the ssd_scan kernel (``kernel.ssd_scan_heads``; the
                     name is the reference's, whose kernel is Pallas): on
                     CUDA the hand-written kernel, given x, B and C as the
                     model holds them, on the CPU its plain version; with
                     ``return_state`` the kernel emits the final state
  impl="chunked"   - ``ref.ssd_chunked``, the reference's production path
  impl="recurrent" - ``ref.ssd_scan_with_final_ref``, the per-step oracle
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import kernel as _k
from repro_torch.kernels.ssd_scan import ref as _ref


def ssd(x, dt, A, B, C, D, *, impl: str = "chunked",
        chunk: int = _k.DEFAULT_CHUNK, return_state: bool = False):
    """x ``[B, L, H, P]``, dt ``[B, L, H]``, A ``[H]``, B/C ``[B, L, N]``
    (one group, shared by the heads), D ``[H]`` -> y ``[B, L, H, P]`` in
    x's dtype (and h_final ``[B, H, N, P]`` float32 with
    ``return_state``)."""
    if impl == "pallas":
        return _k.ssd_scan_heads(x, dt, A, B, C, D, chunk=chunk,
                                 h_final=return_state)
    flat = _ref.flatten_heads(x, dt, A, B, C, D)
    if impl == "chunked":
        out = _ref.ssd_chunked(*flat, chunk=chunk)
    elif impl == "recurrent":
        out = _ref.ssd_scan_with_final_ref(*flat)
    else:
        raise ValueError(f"unknown ssd impl {impl!r}")
    y, hf = _ref.unflatten_heads(*out, x.shape[0], x.shape[2])
    return (y, hf) if return_state else y


def ssd_decode_step(h, x_t, dt_t, A, B_t, C_t, D):
    """One decode step with O(1) state: h ``[B, H, N, P]``, x_t ``[B, H,
    P]``, dt_t ``[B, H]``, A ``[H]``, B_t/C_t ``[B, N]``, D ``[H]`` ->
    (h', y_t ``[B, H, P]``)."""
    decay = torch.exp(dt_t * A[None, :])[..., None, None]       # [B,H,1,1]
    inject = (dt_t[..., None, None] * B_t[:, None, :, None]
              * x_t[:, :, None, :])                              # [B,H,N,P]
    h_new = decay * h + inject
    y = torch.einsum("bn,bhnp->bhp", C_t, h_new) + D[None, :, None] * x_t
    return h_new, y
