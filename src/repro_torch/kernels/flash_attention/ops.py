"""Attention entry point of the port (the reference's ``ops.py::mha``).

  impl="naive"   - dense softmax (``ref.attention_ref``), the oracle
  impl="chunked" - the reference's training attention
                   (``chunked_attention``): an online softmax that keeps
                   each row's log-sum-exp and a backward that recomputes
                   the probabilities from ``(q, k, v, o, lse)``, O(S)
                   residuals; ``ChunkedAttention``, an autograd function,
                   on CUDA the flash_attention kernel with its lse output
                   and the three backward kernels, on the CPU their plain
                   versions (``ref.chunked_fwd``, ``ref.chunked_bwd``)
  impl="pallas"  - the flash_attention kernel (``kernel.flash_attention``;
                   the name is the reference's, whose kernel is Pallas):
                   on CUDA one of the two hand-written kernels (bf16 on
                   the tensor cores, the rest in f32; ``kernel.route``),
                   on the CPU their plain version; it has no backward, and
                   under grad an input that requires grad raises

"naive" and "chunked" align a causal mask bottom-right when ``S != SK``,
"pallas" top-left, as the reference's do.

On DTensors (a model run on a device mesh) attention has no DTensor
strategy, and the kernel wrappers refuse DTensors, so ``mha`` runs its
impl on each device's local shards (``local_map``): a mesh dim on which
q, k and v are all sharded on batch (dim 0) keeps that sharding; one on
which q is sharded on heads (dim 1) keeps it, k and v sharded on heads
too or, where their fewer heads do not divide (GQA), replicated and cut
on each device to the kv heads its q heads read (their gradients then
summed over that dim); any other dim is replicated, DTensor gathering
what it must.  On the card the local shards reach the kernels as on one
device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import is_dtensor
from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref as _ref


class ChunkedAttention(torch.autograd.Function):
    """``chunked_attention``'s core (the reference's ``_chunked_core``
    with its custom VJP): saves ``(q, k, v, o, lse)``, never the S x SK
    scores."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, q_chunk: int,
                k_chunk: int):
        o, lse = _k.flash_attention_lse(q, k, v, causal=causal, scale=scale,
                                        blocks=(q_chunk, k_chunk))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, q_chunk, k_chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, q_chunk, k_chunk = ctx.args
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = _k.flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal, scale=scale,
            blocks=(q_chunk, k_chunk))
        return dq, dk, dv, None, None, None, None


def chunked_attention(q, k, v, *, causal: bool = True, scale=None,
                      q_chunk: int = _ref.Q_CHUNK,
                      k_chunk: int = _ref.K_CHUNK):
    """GQA flash attention with its backward: q ``[B, HQ, S, D]``, k/v
    ``[B, HKV, SK, D]``."""
    D = q.shape[-1]
    scale = (D ** -0.5) if scale is None else scale
    blocks = _ref.default_blocks(q.shape[2], k.shape[2], q_chunk, k_chunk)
    return ChunkedAttention.apply(q, k, v, causal, scale, *blocks)


def _mha_on_mesh(q, k, v, causal: bool, scale, impl: str):
    """``mha`` of DTensors on their local shards (module docstring)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    group = q.shape[1] // k.shape[1]
    qp, kvp, grads, cut = [], [], [], None
    for d, (pq, pk, pv) in enumerate(zip(q.placements, k.placements,
                                         v.placements)):
        n = q.shape[1] // mesh.size(d)     # q heads a device, if sharded
        if pq == pk == pv and pq in (Shard(0), Shard(1)):
            place = (pq, pq, pq)
        elif pq == Shard(1) and cut is None and (n % group == 0
                                                 or group % n == 0):
            place, cut = (pq, Replicate(), Partial()), d
        else:
            place = (Replicate(),) * 3
        qp.append(place[0])
        kvp.append(place[1])
        grads.append(place[2])

    def local(q_, k_, v_):
        if cut is not None:     # the kv heads this device's q heads read
            first = mesh.get_local_rank(cut) * q_.shape[1]
            lo, hi = first // group, (first + q_.shape[1] - 1) // group + 1
            k_, v_ = k_[:, lo:hi], v_[:, lo:hi]
        return mha(q_, k_, v_, causal=causal, scale=scale, impl=impl)

    return local_map(local, out_placements=qp, in_placements=(qp, kvp, kvp),
                     in_grad_placements=(qp, grads, grads), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def mha(q, k, v, *, causal: bool = True, scale=None, impl: str = "naive"):
    if is_dtensor(q):
        return _mha_on_mesh(q, k, v, causal, scale, impl)
    if impl == "pallas":
        return _k.flash_attention(q, k, v, causal=causal, scale=scale)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, scale=scale)
    if impl == "naive":
        return _ref.attention_ref(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")
