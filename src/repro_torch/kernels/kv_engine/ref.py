"""Plain PyTorch versions of the kv_engine kernels.

The same functions as the CUDA kernels in ``csrc/kv_engine.cu``, written
as direct torch gathers and a masked scatter (the write is
``store.append_dirty`` with the kernel's contract: a key outside
``[0, K)`` is never accepted).  The kernel wrappers take these for
tensors on the CPU; ``chip_smoke.py`` holds each kernel against them on
the card.  Layouts: ``values [N, K, V, W]``, ``seqs [N, K, V]``,
``pending [N, K]``, batches ``[N, B]``, all int32.
"""
from __future__ import annotations

import torch

I32 = torch.int32


def cluster_read_engine_ref(values, seqs, pending, keys):
    """Per query: clean value+seq (cell 0), latest value+seq (cell
    ``pending``) and ``pending``.  A key outside ``[0, K)`` answers all
    zeros, as does the latest cell of a ``pending`` outside ``[0, V)``."""
    N, K, V, W = values.shape
    rows = torch.arange(N, device=keys.device)[:, None]
    ok = (keys >= 0) & (keys < K)
    k = torch.where(ok, keys, 0).long()
    pend = torch.where(ok, pending[rows, k], 0)
    p_ok = ok & (pend >= 0) & (pend < V)
    p = torch.where(p_ok, pend, 0).long()
    zero = torch.zeros((), dtype=I32, device=keys.device)
    clean_val = torch.where(ok[..., None], values[rows, k, 0], zero)
    clean_seq = torch.where(ok, seqs[rows, k, 0], zero)
    latest_val = torch.where(p_ok[..., None], values[rows, k, p], zero)
    latest_seq = torch.where(p_ok, seqs[rows, k, p], zero)
    return clean_val, clean_seq, latest_val, latest_seq, pend.to(I32)


def cluster_write_engine_ref(values, seqs, pending, keys, wvals, wseqs,
                             active, rank):
    """Append each active write at cell ``pending + 1 + rank`` of its key,
    drop it if that passes ``V - 1``; ``pending`` is read before any
    write lands.  Edits values/seqs/pending in place and returns them
    with ``accepted [N, B]`` int32."""
    N, K, V, W = values.shape
    rows = torch.arange(N, device=keys.device)[:, None].expand_as(keys)
    live = (active > 0) & (keys >= 0) & (keys < K)
    k = torch.where(live, keys, 0).long()
    slot = pending[rows, k] + 1 + rank
    accepted = live & (slot <= V - 1)
    land = accepted & (slot >= 0)
    n_i, k_i, s_i = rows[land], k[land], slot[land].long()
    values[n_i, k_i, s_i] = wvals[land]
    seqs[n_i, k_i, s_i] = wseqs[land]
    counts = torch.zeros((N, K), dtype=I32, device=keys.device)
    counts.index_put_((rows[accepted], k[accepted]),
                      torch.ones((), dtype=I32, device=keys.device),
                      accumulate=True)
    pending.add_(counts)
    return values, seqs, pending, accepted.to(I32)
