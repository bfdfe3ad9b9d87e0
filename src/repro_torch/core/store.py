"""Versioned object store - the ``objects_store`` register array.

The port of ``repro/core/store.py``.  Layout per node is the reference's
(``values[K, V, W]``, ``seqs[K, V]``, ``pending[K]``, ``next_seq[K]``;
cell 0 is the clean version, cells ``1..pending`` the dirty ones), with
one leading node axis written out instead of ``vmap``: every leaf is
``[N, ...]`` and every batch of keys ``[N, B]``, so one call serves all
the nodes of a cluster (the engine passes its flattened ``[C * n]`` node
axis).

In place: the reference is functional.  Here ``assign_seqs``,
``append_dirty`` and ``overwrite_clean`` edit the given store's tensors
in place (a tick would otherwise copy every leaf of a full-size store for
a handful of edited cells); ``commit`` rebuilds the whole table out of
place, as the reference does.  Every function returns the store to use
next: callers rebind it and never reuse the store they passed in.

Indices follow the reference's semantics.  A JAX gather wraps a
negative index once and clamps the rest into range (``gather_index``).
A JAX scatter wraps a negative index once and drops what is still out of
range (``scatter_index``): here it writes through a padding column that
is sliced off.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import I32, ChainConfig, resolve_device


class Store(NamedTuple):
    values: torch.Tensor    # [N, K, V, W] int32
    seqs: torch.Tensor      # [N, K, V] int32 (-1 = empty cell)
    pending: torch.Tensor   # [N, K] int32
    next_seq: torch.Tensor  # [N, K] int32

    @property
    def num_keys(self) -> int:
        return self.values.shape[-3]

    @property
    def num_versions(self) -> int:
        return self.values.shape[-2]


def init_store(cfg: ChainConfig, shape=(1,), device="cuda") -> Store:
    """A fresh store per node for a leading ``shape`` of nodes."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dev = resolve_device(device)
    K, V, W = cfg.num_keys, cfg.num_versions, cfg.value_words
    seqs = torch.full(shape + (K, V), -1, dtype=I32, device=dev)
    seqs[..., 0] = 0
    return Store(
        values=torch.zeros(shape + (K, V, W), dtype=I32, device=dev),
        seqs=seqs,
        pending=torch.zeros(shape + (K,), dtype=I32, device=dev),
        next_seq=torch.ones(shape + (K,), dtype=I32, device=dev),
    )


def gather_index(keys: torch.Tensor, size: int) -> torch.Tensor:
    """JAX gather semantics for an index: wrap once if negative, then
    clamp into ``[0, size)``.  Keeps the dtype."""
    return torch.where(keys < 0, keys + size, keys).clamp(0, size - 1)


def scatter_index(keys: torch.Tensor, size: int) -> torch.Tensor:
    """JAX scatter semantics for an index: wrap once if negative; what is
    still outside ``[0, size)`` is dropped, here sent to the padding
    index ``size``.  Keeps the dtype."""
    k = torch.where(keys < 0, keys + size, keys)
    return torch.where((k >= 0) & (k < size), k, size)


def last_writes(target: torch.Tensor) -> torch.Tensor:
    """Mask of the entries of a flat scatter ``target`` (int64) that are
    the last to write their target.  The reference's scatter applies
    its updates in order, so of two writes to one cell the later stays;
    a torch scatter with repeated targets keeps either, from run to run
    once it runs on several threads."""
    order = torch.sort(target, stable=True).indices
    ends = torch.ones_like(target, dtype=torch.bool)
    ends[:-1] = target[order[1:]] != target[order[:-1]]
    last = torch.empty_like(ends)
    last[order] = ends
    return last


def _rows(keys: torch.Tensor) -> torch.Tensor:
    """[N, 1] node index matching a [N, B] key batch."""
    return torch.arange(keys.shape[0], device=keys.device)[:, None]


def take(table: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """``table[n, keys[n, b]]`` for a [N, K, ...] table, JAX-clamped."""
    return table[_rows(keys), gather_index(keys, table.shape[1]).long()]


# ---------------------------------------------------------------------------
# Batch-rank helpers (serialization semantics within a batch)
# ---------------------------------------------------------------------------
def batch_rank(keys: torch.Tensor, active: torch.Tensor,
               dense: bool = False) -> torch.Tensor:
    """rank[n, i] = #{j < i : active[n, j] and keys[n, j] == keys[n, i]}
    for active i (stable order); inactive entries rank 0.  [N, B] -> [N, B].

    Default is the segmented-sort ranking: two stable sorts group entries
    by (active, key) in batch order and the rank is the offset within the
    run.  ``dense=True`` keeps the O(B^2) bitmatrix oracle.
    """
    active = active.to(torch.bool)
    N, b = keys.shape
    if dense:
        same = (
            (keys[:, None, :] == keys[:, :, None])
            & active[:, None, :] & active[:, :, None]
        )
        lower = torch.tril(
            torch.ones((b, b), dtype=torch.bool, device=keys.device),
            diagonal=-1,
        )
        return (same & lower).sum(dim=-1).to(I32)
    o1 = torch.sort(keys, dim=-1, stable=True).indices       # (key, idx)
    inactive = (~active).gather(-1, o1).to(torch.uint8)
    o2 = torch.sort(inactive, dim=-1, stable=True).indices   # active first
    order = o1.gather(-1, o2)                                # (inact, key, idx)
    s_keys = keys.gather(-1, order)
    s_active = active.gather(-1, order)
    boundary = torch.ones((N, b), dtype=torch.bool, device=keys.device)
    boundary[:, 1:] = (s_keys[:, 1:] != s_keys[:, :-1]) | (
        s_active[:, 1:] != s_active[:, :-1]
    )
    j = torch.arange(b, dtype=torch.int64, device=keys.device).expand(N, b)
    run_start = torch.cummax(torch.where(boundary, j, 0), dim=-1).values
    rank_sorted = torch.where(s_active, j - run_start, 0)
    rank = torch.empty((N, b), dtype=torch.int64, device=keys.device)
    rank.scatter_(-1, order, rank_sorted)   # order is a permutation
    return rank.to(I32)


def per_key_count(keys: torch.Tensor, active: torch.Tensor,
                  num_keys: int) -> torch.Tensor:
    """count[n, k] = number of active entries of row n with key k, keys
    placed as the reference's scatter places them."""
    out = torch.zeros((keys.shape[0], num_keys + 1), dtype=I32,
                      device=keys.device)
    out.scatter_add_(-1, scatter_index(keys, num_keys).long(),
                     active.to(I32))
    return out[:, :num_keys]


# ---------------------------------------------------------------------------
# Reads
# ---------------------------------------------------------------------------
def read_clean(store: Store, keys: torch.Tensor):
    """Value + seq of the committed version (cell 0).
    [N, B] -> ([N, B, W], [N, B])."""
    return take(store.values, keys)[:, :, 0], take(store.seqs, keys)[:, :, 0]


def read_latest(store: Store, keys: torch.Tensor):
    """Latest version: the newest dirty cell if any, else cell 0."""
    rows = _rows(keys)
    k = gather_index(keys, store.num_keys).long()
    slot = gather_index(store.pending[rows, k], store.num_versions).long()
    return store.values[rows, k, slot], store.seqs[rows, k, slot]


def is_clean(store: Store, keys: torch.Tensor) -> torch.Tensor:
    return take(store.pending, keys) == 0


# ---------------------------------------------------------------------------
# Writes
# ---------------------------------------------------------------------------
def assign_seqs(store: Store, keys, needs, dense_rank: bool = False):
    """Stamp unsequenced client writes with per-key monotone seqs.

    Returns (store, seqs[N, B]); ``next_seq`` is advanced in place.
    Entries with needs == False get -1.
    """
    needs = needs.to(torch.bool)
    rank = batch_rank(keys, needs, dense=dense_rank)
    seqs = take(store.next_seq, keys) + rank
    store.next_seq.add_(per_key_count(keys, needs, store.num_keys))
    return store, torch.where(needs, seqs, -1).to(I32)


def append_dirty(store: Store, keys, values, seqs, active,
                 dense_rank: bool = False):
    """Append dirty versions at cells ``pending+1+rank``; drop if the
    window is exceeded.  Edits values/seqs/pending in place.

    Returns (store, accepted[N, B] bool).
    """
    active = active.to(torch.bool)
    K, V = store.num_keys, store.num_versions
    rank = batch_rank(keys, active, dense=dense_rank)
    slot = take(store.pending, keys) + 1 + rank
    accepted = active & (slot <= V - 1)
    # an accepted entry lands where the reference's scatter puts its key,
    # if anywhere; (key, slot) pairs are unique among accepted entries of
    # one raw key, but two raw keys of one register (-1 and K - 1) can
    # share a cell, and then the later write stays
    dst = scatter_index(keys, K).long()
    land = accepted & (dst < K)
    rows = _rows(keys).expand_as(keys)
    n_i, k_i, s_i = rows[land], dst[land], slot[land].long()
    last = last_writes((n_i * K + k_i) * V + s_i)
    n_i, k_i, s_i = n_i[last], k_i[last], s_i[last]
    store.values[n_i, k_i, s_i] = values[land][last]
    store.seqs[n_i, k_i, s_i] = seqs[land][last].to(I32)
    store.pending.add_(per_key_count(keys, accepted, K))
    return store, accepted


def commit(store: Store, keys, values, seqs, active):
    """Tail commit / ACK application: install ``value`` as the clean
    version of ``key`` (cell 0) for the largest seq per key in the batch,
    then compact: drop dirty versions with seq <= the committed seq and
    shift the rest down.  Rebuilds the whole table out of place, as the
    reference does.
    """
    N, K, V, W = store.values.shape
    active = active.to(torch.bool)
    dev = keys.device
    rows = _rows(keys)
    k_drop = scatter_index(keys, K).long()
    in_range = k_drop < K

    # Per-key max committed seq in this batch (acks are cumulative).
    # Dropped keys write the neutral -1 into the padding column.
    ack_seq = torch.full((N, K + 1), -1, dtype=I32, device=dev)
    ack_seq.scatter_reduce_(
        -1, k_drop, torch.where(active & in_range, seqs, -1).to(I32),
        reduce="amax",
    )
    ack_seq = ack_seq[:, :K]

    # The entry whose seq equals the per-key max supplies the value;
    # non-winners go to the padding row and are sliced off.
    seq0 = store.seqs[:, :, 0]
    is_winner = (
        active & (seqs == take(ack_seq, keys)) & (seqs > take(seq0, keys))
    )
    safe = torch.where(is_winner & in_range, k_drop, K)
    new_cell0 = torch.cat(
        [store.values[:, :, 0, :],
         torch.zeros((N, 1, W), dtype=I32, device=dev)], dim=1)
    new_cell0[rows, safe] = values.to(I32)
    new_cell0 = new_cell0[:, :K]
    new_seq0 = torch.cat(
        [seq0, torch.zeros((N, 1), dtype=I32, device=dev)], dim=1)
    new_seq0[rows, safe] = seqs.to(I32)
    new_seq0 = new_seq0[:, :K]

    # Monotone guard: never roll the committed seq backwards.
    effective = torch.maximum(ack_seq, seq0)
    touched = ack_seq >= 0

    # Compact dirty region per key: keep dirty cells with seq > effective.
    cell_idx = torch.arange(V, device=dev)
    dirty = (cell_idx >= 1) & (cell_idx <= store.pending[..., None])
    keep = dirty & (store.seqs > effective[..., None]) & touched[..., None]
    keep = torch.where(touched[..., None], keep, dirty)
    # Stable sort: kept dirty cells first, in original (seq) order.
    order = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True).indices
    kept_vals = torch.take_along_dim(store.values, order[..., None], dim=2)
    kept_seqs = torch.take_along_dim(store.seqs, order, dim=2)
    n_keep = keep.sum(dim=-1).to(I32)

    shifted_vals = torch.cat(
        [new_cell0[:, :, None, :], kept_vals[:, :, : V - 1]], dim=2)
    shifted_seqs = torch.cat([new_seq0[..., None], kept_seqs[..., : V - 1]],
                             dim=2)
    valid = cell_idx <= n_keep[..., None]
    shifted_seqs = torch.where(valid, shifted_seqs, -1).to(I32)

    return store._replace(
        values=torch.where(touched[..., None, None], shifted_vals,
                           store.values),
        seqs=torch.where(touched[..., None], shifted_seqs, store.seqs),
        pending=torch.where(touched, n_keep, store.pending),
    )


def overwrite_clean(store: Store, keys, values, seqs, active):
    """NetChain-style single-version write: cell 0 := value iff seq newer.
    Edits cell 0 in place."""
    N, K = store.pending.shape
    active = active.to(torch.bool)
    dev = keys.device
    rows = _rows(keys)
    dst = scatter_index(keys, K).long()
    in_range = dst < K
    newer = active & (seqs > take(store.seqs[:, :, 0], keys))
    # Serialize same-key duplicates: highest seq wins; losers are dropped.
    best = torch.full((N, K + 1), -1, dtype=I32, device=dev)
    best.scatter_reduce_(
        -1, dst, torch.where(newer & in_range, seqs, -1).to(I32),
        reduce="amax",
    )
    win = newer & in_range & (seqs == take(best[:, :K], keys))
    n_i = rows.expand_as(keys)[win]
    k_i = dst[win]
    store.values[n_i, k_i, 0] = values[win].to(I32)
    store.seqs[n_i, k_i, 0] = seqs[win].to(I32)
    return store
