"""Chain-replicated KV cache: the paper's two protocols applied to a
decode replica's KV page (the port of the reference's
``serve/kv_cache.py``).

Decode replicas form a chain group of ranks (``core/collectives.py``);
each holds a copy of the cache, so any replica can take over a sequence
when a node fails.  The protocols differ as in the paper:

* **NetCRAQ** - a committed page is clean, so every replica serves its
  attention reads locally (no bytes on the read path).  A step's append
  goes one hop down the chain (``ppermute_next``) and the tail's commit
  sequence number reaches everyone (``psum``): one token's K/V per hop.
* **NetChain** - only the tail is authoritative: every step's read
  fetches the tail's page window (a broadcast from the tail, equal to
  the reference's tail-masked ``psum``), and an append travels the
  whole chain, ``n - 1`` hops, before the tail commits it.

A page is a tensor or a tuple/list/dict of tensors (K and V); ``group``
is the ``ChainGroup`` where the reference names a mesh axis.
"""
from __future__ import annotations

import torch

from repro_torch.core.collectives import (
    ChainGroup,
    axis_index,
    broadcast_from,
    ppermute_next,
    psum,
)


def _map(fn, *trees):
    """``fn`` over the tensor leaves of tuples, lists and dicts."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _tail_ack(seq_no: torch.Tensor, group: ChainGroup) -> torch.Tensor:
    """The tail's commit sequence number on every replica."""
    tail = axis_index(group) == group.n - 1
    return psum(seq_no if tail else torch.zeros_like(seq_no), group)


def netcraq_append(kv_new, seq_no, *, group: ChainGroup):
    """CRAQ write path for one decode step's new KV page.  Returns
    ``(kv_own, replica_copy, ack)``: every replica keeps its own page
    (local clean reads); a non-head replica also stores its
    predecessor's page as the replica copy; ``ack`` is the tail's
    ``seq_no``."""
    fwd = _map(lambda x: ppermute_next(x, group), kv_new)
    head = axis_index(group) == 0
    replica = _map(lambda own, prev: own if head else prev, kv_new, fwd)
    return kv_new, replica, _tail_ack(seq_no, group)


def netchain_read(cache_page, *, group: ChainGroup):
    """CR read path: the tail's page window on every replica."""
    return _map(lambda x: broadcast_from(x, group.n - 1, group), cache_page)


def netchain_append(kv_new, seq_no, *, group: ChainGroup):
    """CR write path: the page travels ``n - 1`` hops to the tail, which
    commits it.  Returns ``(committed, ack)``: the tail holds the head's
    page, the others their own."""
    fwd = kv_new
    for _ in range(group.n - 1):
        fwd = _map(lambda x: ppermute_next(x, group), fwd)
    tail = axis_index(group) == group.n - 1
    committed = _map(lambda own, f: f if tail else own, kv_new, fwd)
    return committed, _tail_ack(seq_no, group)


def failover_select(cache_local, cache_replica, failed: torch.Tensor):
    """Phase-1 failover: the replica copy for the failed sequences
    (``failed`` ``[B]`` bool over each leaf's leading axis)."""
    return _map(
        lambda a, b: torch.where(
            failed.reshape((-1,) + (1,) * (a.dim() - 1)), b, a),
        cache_local, cache_replica)
