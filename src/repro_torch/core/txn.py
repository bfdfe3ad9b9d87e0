"""The tick-resident transaction stages of ``repro/core/txn.py``.

What ``_chain_tick`` runs on every tick: the per-chain lock table, lease
expiry and the head's lock stage (PREPARE acquires, COMMIT/ABORT
release, validated COMMITs pass on to the node step as writes); and the
host-side probes the control plane reads between ticks
(``locks_all_free``, ``held_locks``, ``committed_view``).  The wave
coordinator, planners and drivers are not ported yet.

Every function takes a leading chain axis ``[C, ...]`` written out: the
lock table is ``[C, K]`` and the inbox ``[C, n, cap]``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import store as store_lib
from repro_torch.core.store import Store
from repro_torch.core.types import (
    CLIENT_BASE,
    I32,
    LEASE_OFF,
    NOWHERE,
    OP_ABORT,
    OP_COMMIT,
    OP_NOP,
    OP_PREPARE,
    OP_PREPARE_ACK,
    OP_PREPARE_NACK,
    OP_TXN_REPLY,
    TO_CLIENT,
    ChainConfig,
    ClusterConfig,
    Msg,
    Roles,
    resolve_device,
    tree_map,
)


class LockTable(NamedTuple):
    """Per-chain lock/intent registers, keyed by local register index."""

    holder: torch.Tensor       # [C, K] int32 txn id holding the lock (-1 free)
    client: torch.Tensor       # [C, K] int32 client owning the intent
    version: torch.Tensor      # [C, K] int32 committed-txn counter
    lease: torch.Tensor        # [C, K] int32 acquisition tick (-1 free)
    lease_ticks: torch.Tensor  # [C] int32 lease length; LEASE_OFF disables

    @staticmethod
    def empty(num_keys: int, n_chains: int = 1, lease_ticks: int = LEASE_OFF,
              device="cuda") -> "LockTable":
        dev = resolve_device(device)
        neg = lambda: torch.full((n_chains, num_keys), -1, dtype=I32,
                                 device=dev)
        return LockTable(
            holder=neg(), client=neg(),
            version=torch.zeros((n_chains, num_keys), dtype=I32, device=dev),
            lease=neg(),
            lease_ticks=torch.full((n_chains,), lease_ticks, dtype=I32,
                                   device=dev),
        )


def init_locks(cfg: ChainConfig, n_chains: int = 1,
               lease_ticks: int = LEASE_OFF, device="cuda") -> LockTable:
    return LockTable.empty(cfg.num_keys, n_chains, lease_ticks, device)


def locks_all_free(locks: LockTable) -> bool:
    """Host-side check the control plane makes before a recovery copy: no
    transaction holds a lock anywhere (``[K]`` and ``[C, K]`` tables)."""
    return bool((locks.holder == -1).all())


def held_locks(locks: LockTable) -> int:
    """Host-side count of the locks held right now (``[K]`` and ``[C, K]``
    tables): the leaked-lock probe at drain."""
    return int((locks.holder != -1).sum())


def committed_view(cluster: ClusterConfig, state, node: int = -1) -> dict:
    """{global_key: committed value word 0} read from every chain's store
    at physical slot ``node`` (default: the tail slot).  Call after a
    drain, when all replicas agree.  The inverse goes through the state's
    live ``PartitionMap`` (``ClusterConfig.global_key``), so a rebalanced
    bucket reads from wherever it lives now; free regions are skipped."""
    vals = state.stores.values[:, node, :, 0, 0]            # [C, K]
    C, K = vals.shape
    dev = vals.device
    chains = torch.arange(C, device=dev).repeat_interleave(K)
    slots = torch.arange(K, device=dev).repeat(C)
    gks = cluster.global_key(slots, chains, state.pmap)
    keep = gks >= 0
    return dict(zip(gks[keep].tolist(), vals.reshape(-1)[keep].tolist()))


def set_lease(locks: LockTable, lease_ticks) -> LockTable:
    """Swap the lease length on every chain of a live lock table."""
    new = torch.as_tensor(lease_ticks, dtype=I32,
                          device=locks.lease_ticks.device)
    return locks._replace(
        lease_ticks=torch.broadcast_to(new, locks.lease_ticks.shape).clone())


def lease_expiry_stage(locks: LockTable, t):
    """Reclaim locks held past their lease (runs before the lock stage):
    clear holder/client/lease and bump the version counter so a straggler
    COMMIT fails release validation.  Returns ``(locks', n_expired [C])``.
    """
    held = locks.holder != -1
    age = t - locks.lease
    expired = held & (age >= locks.lease_ticks[:, None])
    neg = torch.full_like(locks.holder, -1)
    return LockTable(
        holder=torch.where(expired, neg, locks.holder),
        client=torch.where(expired, neg, locks.client),
        version=locks.version + expired.to(I32),
        lease=torch.where(expired, neg, locks.lease),
        lease_ticks=locks.lease_ticks,
    ), expired.sum(dim=1).to(I32)


def _scatter_drop(buf: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``buf.at[idx].set(val, mode="drop")`` per chain: ``buf`` [C, K],
    ``idx`` [C, M] with K as the drop sentinel (a padding column)."""
    C, K = buf.shape
    out = torch.cat([buf, buf.new_zeros((C, 1))], dim=1)
    val = torch.as_tensor(val, dtype=buf.dtype, device=buf.device)
    out.scatter_(1, idx, torch.broadcast_to(val, idx.shape).contiguous())
    return out[:, :K]


def head_txn_stage(locks: LockTable, roles: Roles, stores: Store,
                   inbox: Msg, t=None, dense_rank: bool = False):
    """Process this tick's client transaction ops at each chain's live
    head.  ``locks`` [C, K], ``roles`` [C, n], ``stores`` [C, n, K, ...]
    (read only), ``inbox`` [C, n, cap].

    Returns ``(locks', inbox', txn_replies [C, n, cap], (commits,
    aborts, conflicts) each [C])`` with the reference's semantics:
    releases first, then acquires (first same-key PREPARE in stable order
    wins), PREPARE_ACK carries the head-latest value overlaid with this
    batch's earlier commits.
    """
    C, n, cap = inbox.op.shape
    K = locks.holder.shape[1]
    W = stores.values.shape[-1]
    dev = inbox.op.device
    t_now = torch.as_tensor(0 if t is None else t, dtype=I32, device=dev)
    flat: Msg = tree_map(
        lambda x: x.reshape((C, n * cap) + x.shape[3:]), inbox)
    node_of = torch.arange(n, dtype=I32, device=dev).repeat_interleave(cap)
    head = roles.head_pos[:, 0]
    frozen = roles.frozen[:, 0]

    from_client = flat.src >= CLIENT_BASE
    live = flat.op != OP_NOP
    is_prep = live & from_client & (flat.op == OP_PREPARE)
    is_com = live & from_client & (flat.op == OP_COMMIT)
    is_abt = live & from_client & (flat.op == OP_ABORT)
    is_txn = is_prep | is_com | is_abt
    at_head = node_of[None, :] == head[:, None]
    txn_id = flat.seq
    key_ok = (flat.key >= 0) & (flat.key < K)
    k = flat.key.long().clamp(0, K - 1)

    # ---- release round: at most one valid release per key per batch
    valid_rel = (
        (is_com | is_abt) & at_head & key_ok & (txn_id >= 0)
        & (locks.holder.gather(1, k) == txn_id)
    )
    com_ok = is_com & valid_rel
    abt_ok = is_abt & valid_rel
    rel_key = torch.where(valid_rel, k, K)
    holder = _scatter_drop(locks.holder, rel_key, -1)
    client = _scatter_drop(locks.client, rel_key, -1)
    lease = _scatter_drop(locks.lease, rel_key, -1)
    com_key = torch.where(com_ok, k, K)
    version = torch.cat([locks.version, locks.version.new_zeros((C, 1))], 1)
    version.scatter_add_(1, com_key, torch.ones_like(com_key, dtype=I32))
    version = version[:, :K]

    # ---- acquire round against the post-release table
    want = is_prep & at_head & key_ok & (txn_id >= 0) & ~frozen[:, None]
    rank = store_lib.batch_rank(flat.key, want, dense=dense_rank)
    grant = want & (holder.gather(1, k) == -1) & (rank == 0)
    g_key = torch.where(grant, k, K)
    holder = _scatter_drop(holder, g_key, txn_id)
    client = _scatter_drop(client, g_key, flat.client)
    lease = _scatter_drop(lease, g_key, t_now)
    nack = is_prep & ~grant

    # ---- snapshot read for PREPARE_ACK (head-latest + this batch's commits)
    cidx = torch.arange(C, device=dev)
    head_store = Store(*[x[cidx, head.long()] for x in stores])
    v_latest, _ = store_lib.read_latest(head_store, k)
    rows = cidx[:, None]
    new_val = torch.zeros((C, K + 1, W), dtype=I32, device=dev)
    new_val[rows, com_key] = flat.value
    has_new = torch.zeros((C, K + 1), dtype=torch.bool, device=dev)
    has_new[rows, com_key] = True
    snap_val = torch.where(has_new[rows, k][..., None], new_val[rows, k],
                           v_latest)

    # ---- replies: ACK/NACK for prepares, TXN_REPLY(-1) for aborts and
    # invalid releases; valid commits reply from the tail instead.
    rel_bad = (is_com | is_abt) & ~valid_rel
    abt_reply = abt_ok | rel_bad
    reply_mask = grant | nack | abt_reply
    reply_op = torch.where(
        grant, OP_PREPARE_ACK,
        torch.where(nack, OP_PREPARE_NACK, OP_TXN_REPLY))
    replies = Msg(
        op=torch.where(reply_mask, reply_op, OP_NOP),
        key=flat.key,
        value=torch.where(grant[..., None], snap_val, 0),
        seq=torch.where(grant, version.gather(1, k), -1),
        src=node_of.expand(C, n * cap),
        dst=torch.where(reply_mask, TO_CLIENT, NOWHERE),
        client=flat.client,
        entry=flat.entry,
        qid=flat.qid,
        t_inject=flat.t_inject,
        extra=flat.extra,
        ver=flat.ver,
    ).mask(reply_mask)

    # ---- inbox edit: non-txn traffic plus validated commits (seq reset
    # to -1 so the node step stamps a fresh write sequence)
    keep = ~is_txn | com_ok
    passed = flat._replace(
        seq=torch.where(com_ok, -1, flat.seq).to(I32)
    ).mask(keep)

    lift = lambda m: tree_map(
        lambda x: x.reshape((C, n, cap) + x.shape[2:]), m)
    counts = (
        com_ok.sum(dim=1).to(I32),
        abt_ok.sum(dim=1).to(I32),
        nack.sum(dim=1).to(I32),
    )
    return (
        LockTable(holder=holder, client=client, version=version,
                  lease=lease, lease_ticks=locks.lease_ticks),
        lift(passed),
        lift(replies),
        counts,
    )
