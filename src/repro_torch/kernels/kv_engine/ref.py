"""Plain PyTorch versions of the kv_engine kernels.

The same functions as the CUDA kernels in ``csrc/kv_engine.cu``, written
as direct torch gathers and a masked scatter (the writes are
``store.append_dirty`` with the kernels' contract: a key outside
``[0, K)`` is never accepted).  The kernel wrappers take these for
tensors on the CPU; ``chip_smoke.py`` holds each kernel against them on
the card.  Layouts: ``values [N, K, V, W]``, ``seqs [N, K, V]``,
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
    ``pending`` is read before any write lands.  Edits in place; returns
    ``accepted`` int32."""
    N, K, V, W = values.shape
    r = torch.where(live, rows, 0).long()
    k = torch.where(live, keys, 0).long()
    slot = pending[r, k] + 1 + rank
    accepted = live & (slot <= V - 1)
    land = accepted & (slot >= 0)
    n_i, k_i, s_i = r[land], k[land], slot[land].long()
    values[n_i, k_i, s_i] = wvals[land]
    seqs[n_i, k_i, s_i] = wseqs[land]
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
