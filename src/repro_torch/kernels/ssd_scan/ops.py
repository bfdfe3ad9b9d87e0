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

On DTensors (a model run on a device mesh) ``ssd`` runs its impl on each
device's local shards (``local_map``), as ``flash_attention/ops.mha``
does: a mesh dim on which x is sharded on its batch keeps that for x,
dt, B, C and the outputs; one on which x is sharded on its heads keeps
it for x, dt, A, D and the outputs, with B and C (shared by the heads)
replicated there and their gradients summed; any other is replicated.
The scan is independent per (batch, head), so each device computes its
own shards as one device would.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import is_dtensor
from repro_torch.kernels.ssd_scan import kernel as _k
from repro_torch.kernels.ssd_scan import ref as _ref


def _ssd_on_mesh(x, dt, A, B, C, D, impl: str, chunk: int,
                 return_state: bool):
    """``ssd`` of DTensors on their local shards (module docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    R = Replicate()
    # per mesh dim: x and dt, A and D, B and C, y, h_final, then the
    # gradients of A and D and of B and C (a replicated input's gradient
    # is summed over the shards that read it)
    cols = []
    for p in x.placements:
        if p == Shard(0):
            cols.append((p, R, p, p, p, Partial(), p))
        elif p == Shard(2):
            cols.append((p, Shard(0), R, p, Shard(1), Shard(0), Partial()))
        else:
            cols.append((R,) * 7)
    px, pa, pb, py, ph, ga, gb = (list(c) for c in zip(*cols))
    outs = (py, ph) if return_state else py
    run = local_map(
        lambda *t: ssd(*t, impl=impl, chunk=chunk, return_state=return_state),
        out_placements=outs, in_placements=(px, px, pa, pb, pb, pa),
        in_grad_placements=(px, px, ga, gb, gb, ga),
        device_mesh=x.device_mesh, redistribute_inputs=True)
    return run(x, dt, A, B, C, D)


def ssd(x, dt, A, B, C, D, *, impl: str = "chunked",
        chunk: int = _k.DEFAULT_CHUNK, return_state: bool = False):
    """x ``[B, L, H, P]``, dt ``[B, L, H]``, A ``[H]``, B/C ``[B, L, N]``
    (one group, shared by the heads), D ``[H]`` -> y ``[B, L, H, P]`` in
    x's dtype (and h_final ``[B, H, N, P]`` float32 with
    ``return_state``)."""
    if is_dtensor(x):
        return _ssd_on_mesh(x, dt, A, B, C, D, impl, chunk, return_state)
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
