"""kv_engine kernels <-> ``repro_torch.core.store`` integration.

The counterparts of the reference's ``ops.py::cluster_read_batch`` and
``cluster_write_batch``: the NetCRAQ read decision on top of the read
kernel, and the within-batch rank plus the write kernel.  The node
steps send their store reads and dirty appends through these, so on
CUDA they run on the hand-written kernels.  ``partitioned_read_batch``
and ``partitioned_write_batch`` are the global-key entry points: they
resolve a flat batch of global keys through a live ``PartitionMap`` and
serve it on the bucketed kernels.

The node steps are held to the reference's jnp store, not to its Pallas
kernels, and the two differ for a key outside ``[0, K)``: the kernels
(here as in the reference) answer zeros and accept nothing there, while
the store clamps a gather and wraps a scatter once, then drops it.  So
these functions resolve the keys first (``store.gather_index``,
``store.scatter_index``) and give the kernels keys they treat as the
store would.
"""
from __future__ import annotations

import torch

from repro_torch.core.store import (
    Store,
    batch_rank,
    gather_index,
    scatter_index,
)
from repro_torch.kernels.kv_engine import kernel as _k

I32 = torch.int32


def cluster_read_batch(store: Store, keys: torch.Tensor, is_tail=False):
    """NetCRAQ read decision for per-node batches in one kernel launch.

    ``store`` leaves carry a leading node axis ``[N, ...]``; ``keys`` is
    ``[N, B]``; ``is_tail`` is a bool or an ``[N]`` bool tensor.  Returns
    (reply_val [N, B, W], reply_seq [N, B], decision [N, B]): 0 answered
    locally (clean), 1 answered by the tail (dirty), 2 forward to the
    tail (dirty at a non-tail node).  A key outside ``[0, K)`` reads the
    register the reference's gather clamps it to.
    """
    cv, cs, lv, ls, pend = _k.cluster_read_engine(
        store.values, store.seqs, store.pending,
        gather_index(keys, store.num_keys).to(I32).contiguous())
    clean = pend == 0
    tail = torch.as_tensor(is_tail, dtype=torch.bool, device=keys.device)
    tail = tail.reshape(-1, 1) if tail.dim() else tail
    dirty_tail = ~clean & tail
    decision = torch.where(clean, 0, torch.where(tail, 1, 2)).to(I32)
    reply_val = torch.where(dirty_tail[..., None], lv, cv)
    reply_seq = torch.where(dirty_tail, ls, cs)
    return reply_val, reply_seq, decision


def cluster_write_batch(store: Store, keys, wvals, wseqs, active,
                        dense_rank: bool = False):
    """Append per-node sequenced write batches in one kernel launch.
    The store's leaves are edited in place.  Returns (store, accepted
    [N, B] bool).

    As in the reference's ``store.append_dirty``, a write whose key the
    scatter drops (outside ``[0, K)`` after one wrap) lands nowhere but
    is accepted if the slot of its clamped register fits.  The kernel
    gets the wrapped keys and rejects such a write, so its verdict is
    taken here, before the launch moves ``pending``.
    """
    K, V = store.num_keys, store.num_versions
    active = active.to(torch.bool)
    rank = batch_rank(keys, active, dense=dense_rank)
    dst = scatter_index(keys, K).to(I32)
    base = store.pending.gather(1, gather_index(keys, K).long())
    lost_ok = active & (dst == K) & (base + rank < V - 1)
    values, seqs, pending, accepted = _k.cluster_write_engine(
        store.values, store.seqs, store.pending, dst.contiguous(),
        wvals.to(I32).contiguous(), wseqs.to(I32).contiguous(),
        active.to(I32), rank,
    )
    return (
        store._replace(values=values, seqs=seqs, pending=pending),
        accepted.to(torch.bool) | lost_ok,
    )


def _resolve(cluster, gkeys, pmap):
    """(in_range, chains, slots) of a flat global-key batch under
    ``pmap``: keys outside the global key space are parked on chain -1
    (their slot is that of key 0, never used)."""
    in_range = (gkeys >= 0) & (gkeys < cluster.num_global_keys)
    safe = torch.where(in_range, gkeys, 0)
    chains = torch.where(in_range, cluster.key_to_chain(safe, pmap),
                         -1).to(I32)
    slots = cluster.key_to_slot(safe, pmap).to(I32)
    return in_range, chains, slots


def partitioned_read_batch(cluster, store: Store, gkeys: torch.Tensor, pmap,
                           is_tail: bool = False):
    """NetCRAQ read decision for a flat batch of global keys under a live
    partition map, in one kernel launch.

    ``store`` leaves are ``[C, K, ...]`` (one replica per chain, such as
    the tail slice ``x[:, -1]`` of the cluster's stores, read in place);
    ``gkeys`` is ``[B]``.  Returns (reply_val [B, W], reply_seq [B],
    decision [B], chains [B], slots [B]) with ``cluster_read_batch``'s
    decision codes; a key outside the global key space is parked (chain
    -1) and answers decision -1 with a zero payload.
    """
    in_range, chains, slots = _resolve(cluster, gkeys, pmap)
    cv, cs, lv, ls, pend = _k.bucketed_read_engine(
        store.values, store.seqs, store.pending, slots, chains)
    clean = pend == 0
    if is_tail:
        decision = torch.where(clean, 0, 1)
        reply_val = torch.where(clean[:, None], cv, lv)
        reply_seq = torch.where(clean, cs, ls)
    else:
        decision = torch.where(clean, 0, 2)
        reply_val, reply_seq = cv, cs
    decision = torch.where(in_range, decision, -1).to(I32)
    return reply_val, reply_seq, decision, chains, slots


def partitioned_write_batch(cluster, store: Store, gkeys, wvals, wseqs,
                            active, pmap):
    """Append a flat global-key write batch under a live partition map in
    one kernel launch.  Two writes to one global key serialize (the rank
    is taken per target ``(chain, slot)``); a write whose key lies outside
    the global key space is dropped, never clamped onto a victim bucket.
    The store's leaves (``[C, K, ...]``, as for the read) are edited in
    place.  Returns (store, accepted [B] bool)."""
    K = store.num_keys
    in_range, chains, slots = _resolve(cluster, gkeys, pmap)
    active = active.to(torch.bool) & in_range
    rank = batch_rank((chains * K + slots)[None], active[None])[0]
    values, seqs, pending, accepted = _k.bucketed_write_engine(
        store.values, store.seqs, store.pending, slots, chains,
        wvals.to(I32).contiguous(), wseqs.to(I32).contiguous(),
        active.to(I32), rank,
    )
    return (
        store._replace(values=values, seqs=seqs, pending=pending),
        accepted.to(torch.bool),
    )
