"""kv_engine kernels <-> ``repro_torch.core.store`` integration.

The counterparts of the reference's ``ops.py``: ``cluster_read_batch``
(the NetCRAQ read decision) and ``cluster_write_batch`` (the dirty
appends with their within-batch rank) for per-node batches, and
``craq_read_batch``/``craq_write_batch``, their one-chain slices.  The
node steps send their store reads and dirty appends through these, and
on CUDA each is one launch of a kernel's ops mode
(``kernel.cluster_read_decide``, ``kernel.cluster_write_append``): the
key resolution, the rank and the read decision run inside the kernel,
on the inbox's tensors as they come.  On the CPU the same wrappers run
the plain composition (``ref.cluster_read_decide_ref``,
``ref.cluster_write_append_ref``).  ``partitioned_read_batch`` and
``partitioned_write_batch`` are the global-key entry points: a flat
batch of global keys under a live ``PartitionMap``, on CUDA one launch
of a bucketed kernel's ops mode each (``kernel.bucketed_read_resolve``,
``kernel.bucketed_write_append``: the map lookup, the read decision and
the rank inside), on the CPU the plain compositions
(``ref.partitioned_read_ref``, ``ref.partitioned_write_ref``).

The node steps are held to the reference's jnp store, not to its Pallas
kernels, and the two differ for a key outside ``[0, K)``: the Pallas
kernels (and the engine mode here) answer zeros and accept nothing
there, while the store clamps a gather and wraps a scatter once, then
drops it.  The per-node batches here follow the store.
"""
from __future__ import annotations

import torch

from repro_torch.core.store import Store
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
    if isinstance(is_tail, torch.Tensor):
        is_tail = is_tail.to(torch.bool).contiguous()
    return _k.cluster_read_decide(store.values, store.seqs, store.pending,
                                  keys.to(I32).contiguous(), is_tail)


def cluster_write_batch(store: Store, keys, wvals, wseqs, active,
                        dense_rank: bool = False):
    """Append per-node sequenced write batches in one kernel launch.
    The store's leaves are edited in place.  Returns (store, accepted
    [N, B] bool).

    As in the reference's ``store.append_dirty``, a write whose key the
    scatter drops (outside ``[0, K)`` after one wrap) lands nowhere but
    is accepted if the slot of its clamped register fits.  The casts are
    no-ops for the inbox's int32 lanes and bool mask.
    """
    values, seqs, pending, accepted = _k.cluster_write_append(
        store.values, store.seqs, store.pending, keys.to(I32).contiguous(),
        wvals.to(I32).contiguous(), wseqs.to(I32).contiguous(),
        active.to(torch.bool).contiguous(), dense_rank=dense_rank)
    return store._replace(values=values, seqs=seqs, pending=pending), accepted


def _one_chain(store: Store) -> Store:
    return Store(*[x[None] for x in store])


def craq_read_batch(store: Store, keys: torch.Tensor, is_tail=False):
    """One chain's read decision: the one-node slice of
    ``cluster_read_batch`` (store leaves ``[K, ...]``, ``keys [B]``).
    Returns (reply_val [B, W], reply_seq [B], decision [B])."""
    outs = cluster_read_batch(_one_chain(store), keys[None], is_tail=is_tail)
    return tuple(o[0] for o in outs)


def craq_write_batch(store: Store, keys, wvals, wseqs, active):
    """One chain's append: the one-node slice of ``cluster_write_batch``.
    The store's ``[K, ...]`` leaves are edited in place.  Returns (store,
    accepted [B] bool)."""
    new, accepted = cluster_write_batch(_one_chain(store), keys[None],
                                        wvals[None], wseqs[None],
                                        active[None])
    return Store(*[x[0] for x in new]), accepted[0]


def partitioned_read_batch(cluster, store: Store, gkeys: torch.Tensor, pmap,
                           is_tail: bool = False):
    """NetCRAQ read decision for a flat batch of global keys under a live
    partition map, in one kernel launch (the map lookup inside).

    ``store`` leaves are ``[C, K, ...]`` (one replica per chain, such as
    the tail slice ``x[:, -1]`` of the cluster's stores, read in place);
    ``gkeys`` is ``[B]``.  Returns (reply_val [B, W], reply_seq [B],
    decision [B], chains [B], slots [B]) with ``cluster_read_batch``'s
    decision codes; a key outside the global key space is parked (chain
    -1) and answers decision -1 with a zero payload.
    """
    return _k.bucketed_read_resolve(store.values, store.seqs, store.pending,
                                    gkeys.to(I32).contiguous(), cluster,
                                    pmap, is_tail=is_tail)


def partitioned_write_batch(cluster, store: Store, gkeys, wvals, wseqs,
                            active, pmap):
    """Append a flat global-key write batch under a live partition map in
    one kernel launch (the map lookup and the rank inside).  Two writes
    to one global key serialize (the rank is taken per target ``(chain,
    slot)``); a write whose key lies outside the global key space is
    dropped, never clamped onto a victim bucket.  ``active`` is bool or
    int32 (nonzero is active).  The store's leaves (``[C, K, ...]``, as
    for the read) are edited in place.  Returns (store, accepted [B]
    bool)."""
    if active.dtype != torch.int32:
        active = active.to(torch.bool)
    values, seqs, pending, accepted = _k.bucketed_write_append(
        store.values, store.seqs, store.pending, gkeys.to(I32).contiguous(),
        wvals.to(I32).contiguous(), wseqs.to(I32).contiguous(),
        active.contiguous(), cluster, pmap)
    return store._replace(values=values, seqs=seqs, pending=pending), accepted
