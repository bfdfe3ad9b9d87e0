"""Plain PyTorch versions of the kv_engine kernels.

The same functions as the CUDA kernels in ``csrc/kv_engine.cu``, written
as direct torch gathers and a masked scatter (the writes are
``store.append_dirty`` with the kernels' contract: a key outside
``[0, K)`` is never accepted).  The two ops-mode versions
(``cluster_read_decide_ref``, ``cluster_write_append_ref``) compose
those with the reference store's index rules, the read decision and the
within-batch rank, as a node step reads and appends.  The kernel
wrappers take these for tensors on the CPU; ``chip_smoke.py`` holds each
kernel against them on the card.  Layouts: ``values [N, K, V, W]``, ``seqs [N, K, V]``,
``pending [N, K]``, per-node batches ``[N, B]`` and flat (bucketed)
batches ``[B]``, all int32.  The bucketed versions take store leaves
whose leading (chain) stride is free, such as one replica's slice of a
``[C, n, ...]`` cluster store, and edit such a slice in place.
"""
from __future__ import annotations

import torch

from repro_torch.core import store as store_lib

I32 = torch.int32


def _lookup(values, seqs, pending, rows, keys, ok):
    """Clean and latest cells of register ``keys`` of node ``rows`` where
    ``ok``, all zeros elsewhere (and a zero latest cell where ``pending``
    lies outside ``[0, V)``)."""
    V = values.shape[2]
    r = torch.where(ok, rows, 0).long()
    k = torch.where(ok, keys, 0).long()
    pend = torch.where(ok, pending[r, k], 0)
    p_ok = ok & (pend >= 0) & (pend < V)
    p = torch.where(p_ok, pend, 0).long()
    zero = torch.zeros((), dtype=I32, device=keys.device)
    clean_val = torch.where(ok[..., None], values[r, k, 0], zero)
    clean_seq = torch.where(ok, seqs[r, k, 0], zero)
    latest_val = torch.where(p_ok[..., None], values[r, k, p], zero)
    latest_seq = torch.where(p_ok, seqs[r, k, p], zero)
    return clean_val, clean_seq, latest_val, latest_seq, pend.to(I32)


def cluster_read_engine_ref(values, seqs, pending, keys):
    """Per query: clean value+seq (cell 0), latest value+seq (cell
    ``pending``) and ``pending``.  A key outside ``[0, K)`` answers all
    zeros, as does the latest cell of a ``pending`` outside ``[0, V)``."""
    N, K = pending.shape
    rows = torch.arange(N, device=keys.device)[:, None].expand_as(keys)
    return _lookup(values, seqs, pending, rows, keys,
                   (keys >= 0) & (keys < K))


def read_engine_ref(values, seqs, pending, keys):
    """One chain's read: the one-node slice of
    ``cluster_read_engine_ref``."""
    outs = cluster_read_engine_ref(values[None], seqs[None], pending[None],
                                   keys[None])
    return tuple(o[0] for o in outs)


def cluster_read_decide_ref(values, seqs, pending, keys, is_tail=False):
    """The node step's read: each key reads the register the reference
    store's gather clamps it to, and the NetCRAQ decision picks the
    reply.  ``is_tail`` is a bool or an ``[N]`` bool tensor.  Returns
    (reply_val, reply_seq, decision) int32, decision 0 clean (cell 0),
    1 dirty at a tail (the latest cell), 2 dirty elsewhere (cell 0)."""
    K = pending.shape[1]
    cv, cs, lv, ls, pend = cluster_read_engine_ref(
        values, seqs, pending, store_lib.gather_index(keys, K).to(I32))
    clean = pend == 0
    tail = torch.as_tensor(is_tail, dtype=torch.bool, device=keys.device)
    tail = tail.reshape(-1, 1) if tail.dim() else tail
    dirty_tail = ~clean & tail
    decision = torch.where(clean, 0, torch.where(tail, 1, 2)).to(I32)
    reply_val = torch.where(dirty_tail[..., None], lv, cv)
    reply_seq = torch.where(dirty_tail, ls, cs)
    return reply_val, reply_seq, decision


def bucketed_read_engine_ref(values, seqs, pending, slots, chains):
    """The flat read: query i looks up register ``slots[i]`` of chain
    ``chains[i]``.  A chain outside ``[0, C)`` (a parked query, chain -1)
    or a slot outside ``[0, K)`` answers all zeros."""
    C, K = pending.shape
    ok = (chains >= 0) & (chains < C) & (slots >= 0) & (slots < K)
    return _lookup(values, seqs, pending, chains, slots, ok)


def _append(values, seqs, pending, rows, keys, wvals, wseqs, live, rank):
    """Append each ``live`` write at cell ``pending + 1 + rank`` of
    register ``keys`` of node ``rows``, drop it if that passes ``V - 1``;
    ``pending`` is read before any write lands, and of two writes to one
    cell the later stays.  Edits in place; returns ``accepted`` int32."""
    N, K, V, W = values.shape
    r = torch.where(live, rows, 0).long()
    k = torch.where(live, keys, 0).long()
    slot = pending[r, k] + 1 + rank
    accepted = live & (slot <= V - 1)
    land = accepted & (slot >= 0)
    n_i, k_i, s_i = r[land], k[land], slot[land].long()
    last = store_lib.last_writes((n_i * K + k_i) * V + s_i)
    n_i, k_i, s_i = n_i[last], k_i[last], s_i[last]
    values[n_i, k_i, s_i] = wvals[land][last]
    seqs[n_i, k_i, s_i] = wseqs[land][last]
    counts = torch.zeros((N, K), dtype=I32, device=keys.device)
    counts.index_put_((r[accepted], k[accepted]),
                      torch.ones((), dtype=I32, device=keys.device),
                      accumulate=True)
    pending.add_(counts)
    return accepted.to(I32)


def cluster_write_engine_ref(values, seqs, pending, keys, wvals, wseqs,
                             active, rank):
    """Append each active write at cell ``pending + 1 + rank`` of its key,
    drop it if that passes ``V - 1``; ``pending`` is read before any
    write lands.  Edits values/seqs/pending in place and returns them
    with ``accepted [N, B]`` int32."""
    N, K = pending.shape
    rows = torch.arange(N, device=keys.device)[:, None].expand_as(keys)
    live = (active > 0) & (keys >= 0) & (keys < K)
    accepted = _append(values, seqs, pending, rows, keys, wvals, wseqs,
                       live, rank)
    return values, seqs, pending, accepted


def write_engine_ref(values, seqs, pending, keys, wvals, wseqs, active,
                     rank):
    """One chain's append: the one-node slice of
    ``cluster_write_engine_ref`` (edits the ``[K, ...]`` leaves in
    place)."""
    outs = cluster_write_engine_ref(values[None], seqs[None], pending[None],
                                    keys[None], wvals[None], wseqs[None],
                                    active[None], rank[None])
    return tuple(o[0] for o in outs)


def cluster_write_append_ref(values, seqs, pending, keys, wvals, wseqs,
                             active, dense_rank: bool = False):
    """The node step's dirty appends, as the reference store's
    ``append_dirty``: ranked by raw key, landed where its scatter puts a
    key (wrapped once, else dropped), and a dropped write accepted when
    the slot of the register its gather clamps the key to fits.  The
    engine gets the wrapped keys and rejects a dropped write, so that
    verdict is taken here from ``pending`` before the append moves it.
    Edits values/seqs/pending in place and returns them with ``accepted
    [N, B]`` bool."""
    K, V = pending.shape[1], values.shape[2]
    active = active.to(torch.bool)
    rank = store_lib.batch_rank(keys, active, dense=dense_rank)
    dst = store_lib.scatter_index(keys, K).to(I32)
    base = pending.gather(1, store_lib.gather_index(keys, K).long())
    lost_ok = active & (dst == K) & (base + rank < V - 1)
    values, seqs, pending, accepted = cluster_write_engine_ref(
        values, seqs, pending, dst, wvals.to(I32), wseqs.to(I32),
        active.to(I32), rank)
    return values, seqs, pending, accepted.to(torch.bool) | lost_ok


def bucketed_write_engine_ref(values, seqs, pending, slots, chains, wvals,
                              wseqs, active, rank):
    """The flat append as the sequential oracle of the reference
    (``write_engine_ref``) defines it: entries apply one at a time in
    batch order, each at the next cell of register ``slots[i]`` of chain
    ``chains[i]``, and are dropped once the window is full.  A write to a
    chain outside ``[0, C)`` or a slot outside ``[0, K)`` is never
    accepted.  ``rank`` is not read: each entry's place in that order
    among earlier live writes to its register is recomputed here.  Edits
    values/seqs/pending in place and returns them with ``accepted [B]``
    int32."""
    C, K = pending.shape
    live = ((active > 0) & (chains >= 0) & (chains < C) & (slots >= 0)
            & (slots < K))
    target = torch.where(live, chains.long() * K + slots.long(), -1)
    order = store_lib.batch_rank(target[None], live[None])[0]
    accepted = _append(values, seqs, pending, chains, slots, wvals, wseqs,
                       live, order)
    return values, seqs, pending, accepted
