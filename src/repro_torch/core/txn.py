"""Cross-chain transactions - the port of ``repro/core/txn.py``.

What ``_chain_tick`` runs on every tick: the per-chain lock table, lease
expiry and the head's lock stage (PREPARE acquires, COMMIT/ABORT
release, validated COMMITs pass on to the node step as writes).  What
``ChainSim.tick`` runs before the chains when the engine has a wave
table (``wave_depth > 0``): the in-network 2PC coordinator
(``WaveState``, ``wave_coordinator_step``).  And the host side: the
planner and the two drivers (``TxnPlanner`` with ``TxnDriver``, the
host-driven coordinator; ``TxnWaveDriver``, batched admission into the
wave table), the serial reference executor and the precedence check
(``reference_execute``, ``serial_order``), and the probes the control
plane reads between ticks (``locks_all_free``, ``held_locks``,
``committed_view``).

Every device function takes a leading chain axis ``[C, ...]`` written
out: the lock table is ``[C, K]``, the inbox ``[C, n, cap]`` and the
wave table ``[C, W]`` / ``[C, W, KT]``.  Every wave leaf is int32, as in
the reference: the lease comparison ``t - t_admit >= lease_ticks`` runs
in int32 against ``LEASE_OFF = 2**31 - 1``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
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
    OP_READ,
    OP_READ_REPLY,
    OP_STALE_NACK,
    OP_TXN_REPLY,
    OP_WRITE,
    OP_WRITE_NACK,
    OP_WRITE_REPLY,
    TO_CLIENT,
    WAVE_BASE,
    ChainConfig,
    ClusterConfig,
    Msg,
    Roles,
    as_cluster,
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


def committed_values(cluster: ClusterConfig, state, node: int = -1):
    """``committed_view`` as tensors on the state's device: (global keys,
    committed value word 0) of every occupied slot."""
    vals = state.stores.values[:, node, :, 0, 0]            # [C, K]
    C, K = vals.shape
    dev = vals.device
    chains = torch.arange(C, device=dev).repeat_interleave(K)
    slots = torch.arange(K, device=dev).repeat(C)
    gks = cluster.global_key(slots, chains, state.pmap)
    keep = gks >= 0
    return gks[keep], vals.reshape(-1)[keep]


def committed_view(cluster: ClusterConfig, state, node: int = -1) -> dict:
    """{global_key: committed value word 0} read from every chain's store
    at physical slot ``node`` (default: the tail slot).  Call after a
    drain, when all replicas agree.  The inverse goes through the state's
    live ``PartitionMap`` (``ClusterConfig.global_key``), so a rebalanced
    bucket reads from wherever it lives now; free regions are skipped."""
    gks, vals = committed_values(cluster, state, node)
    return dict(zip(gks.tolist(), vals.tolist()))


def set_lease(locks: LockTable, lease_ticks) -> LockTable:
    """Swap the lease length on every chain of a live lock table: a
    fill on the table's device (an int is not copied in from the host,
    so the edit makes no host sync)."""
    old = locks.lease_ticks
    if isinstance(lease_ticks, torch.Tensor):
        new = torch.broadcast_to(lease_ticks.to(old.device, I32),
                                 old.shape).clone()
    else:
        new = torch.full_like(old, int(lease_ticks))
    return locks._replace(lease_ticks=new)


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
    # a Python scalar is filled on the device: copying it in would sync
    val = (val.to(buf.dtype) if isinstance(val, torch.Tensor)
           else torch.full((), val, dtype=buf.dtype, device=buf.device))
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
    # a device tensor of True: a Python True is copied in from the host
    has_new[rows, com_key] = torch.ones_like(com_key, dtype=torch.bool)
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


# ---------------------------------------------------------------------------
# The in-network 2PC coordinator: a per-chain wave table of W transaction
# slots, stepped inside the tick before the chains
# ---------------------------------------------------------------------------
# Slot phases.  FREE slots are the host's admission surface
# (TxnWaveDriver writes a whole slot between ticks); the rest happens on
# the device until the slot frees itself.
WAVE_FREE = 0       # unoccupied - admissible
WAVE_ADMITTED = 1   # host filled the slot; PREPAREs go out next tick
WAVE_PREP = 2       # phase 1 in flight - awaiting every participant's reply
WAVE_FIN = 3        # phase 2 in flight - awaiting every release's ack

# Completion-log outcome codes (``log_committed``, and ``committing``
# while a slot is in FIN): 0 aborted, 1 committed, 2 lease-expired
# force-abort (decoded as ``mode == "wave_expired"``).
WAVE_EXPIRED = 2


class WaveState(NamedTuple):
    """Every chain's in-flight-transaction wave table and completion log.

    ``[C, W]`` leaves describe coordinator slots, ``[C, W, KT]`` their
    participants (KT = most keys per transaction; ``p_gkey == -1`` marks
    an unused column); the completion log is ``[C, Lg]`` / ``[C, Lg,
    KT]`` with its cursor ``[C]``, decoded by the host after a run.
    ``coord_in`` ``[C, Xr]`` buffers the control replies the cluster
    router delivered to each chain's coordinator at the end of the
    previous tick.
    """

    phase: torch.Tensor       # WAVE_FREE/ADMITTED/PREP/FIN
    txn_id: torch.Tensor      # transaction id (rides PREPARE/COMMIT seq)
    client: torch.Tensor      # external client id for the final TXN_REPLY
    qid: torch.Tensor         # client-facing query id of the final reply
    epoch: torch.Tensor       # partition epoch stamped on every sub-op
    t_admit: torch.Tensor     # tick of admission
    committing: torch.Tensor  # -1 undecided / 0 aborting / 1 committing
    p_gkey: torch.Tensor      # global key (-1 = column unused)
    p_owner: torch.Tensor     # owning chain at admission time
    p_lkey: torch.Tensor      # local register slot on the owner
    p_wval: torch.Tensor      # value word 0 to commit (writes)
    p_write: torch.Tensor     # 1 = write intent, 0 = snapshot read
    p_replied: torch.Tensor   # phase-1 reply (ACK or NACK) received
    p_acked: torch.Tensor     # phase-1 reply was PREPARE_ACK
    p_done: torch.Tensor      # phase-2 release acknowledged
    p_snap: torch.Tensor      # snapshot value from PREPARE_ACK
    p_wseq: torch.Tensor      # stamped write seq from the tail's TXN_REPLY
    log_txn: torch.Tensor
    log_committed: torch.Tensor
    log_t_admit: torch.Tensor
    log_t_done: torch.Tensor
    log_gkey: torch.Tensor
    log_write: torch.Tensor
    log_wseq: torch.Tensor
    log_snap: torch.Tensor
    log_cursor: torch.Tensor  # [C] next free log row (saturates at Lg)
    coord_in: Msg             # [C, Xr] control replies routed back

    @staticmethod
    def empty(wave_depth: int, wave_keys: int, log_capacity: int,
              coord_capacity: int, value_words: int, n_chains: int = 1,
              device="cuda") -> "WaveState":
        dev = resolve_device(device)
        C, W, KT, Lg = n_chains, wave_depth, wave_keys, log_capacity
        z = lambda *s: torch.zeros((C,) + s, dtype=I32, device=dev)
        neg = lambda *s: torch.full((C,) + s, -1, dtype=I32, device=dev)
        return WaveState(
            phase=z(W), txn_id=neg(W), client=neg(W), qid=neg(W),
            epoch=z(W), t_admit=z(W), committing=neg(W),
            p_gkey=neg(W, KT), p_owner=neg(W, KT), p_lkey=z(W, KT),
            p_wval=z(W, KT), p_write=z(W, KT), p_replied=z(W, KT),
            p_acked=z(W, KT), p_done=z(W, KT), p_snap=z(W, KT),
            p_wseq=neg(W, KT),
            log_txn=neg(Lg), log_committed=z(Lg), log_t_admit=z(Lg),
            log_t_done=z(Lg), log_gkey=neg(Lg, KT), log_write=z(Lg, KT),
            log_wseq=neg(Lg, KT), log_snap=z(Lg, KT),
            log_cursor=z(),
            coord_in=Msg.empty((C, coord_capacity), value_words, device=dev),
        )


def _set_cells(buf: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
               val) -> torch.Tensor:
    """``buf.at[row, col].set(val, mode="drop")`` per chain: ``buf``
    [C, W, KT], ``row``/``col`` [C, M] with ``row == W`` dropped.  Of two
    writes to one cell the later in order wins, as in the reference's
    serial scatter (a CPU or CUDA scatter promises no order)."""
    C, W, KT = buf.shape
    M = row.shape[1]
    flat = row.long() * KT + col.long()
    later = torch.ones((M, M), dtype=torch.bool, device=buf.device).triu(1)
    shadowed = ((flat[:, :, None] == flat[:, None, :]) & later).any(2)
    flat = torch.where(shadowed, W * KT, flat)
    out = torch.cat([buf.reshape(C, W * KT), buf.new_zeros((C, KT))], 1)
    val = torch.as_tensor(val, dtype=buf.dtype, device=buf.device)
    out.scatter_(1, flat, torch.broadcast_to(val, flat.shape).contiguous())
    return out[:, :W * KT].reshape(C, W, KT)


def _put_rows(buf: torch.Tensor, rows: torch.Tensor,
              val: torch.Tensor) -> torch.Tensor:
    """``buf.at[rows].set(val, mode="drop")`` per chain: ``buf`` [C, R,
    ...], ``rows`` [C, M] distinct below R, R dropped; ``val`` [C, M,
    ...]."""
    C, R = buf.shape[:2]
    tail = buf.shape[2:]
    out = torch.cat([buf, buf.new_zeros((C, 1) + tail)], 1)
    idx = rows.long().reshape((C, -1) + (1,) * len(tail))
    val = torch.broadcast_to(val.to(buf.dtype), rows.shape + tail)
    out.scatter_(1, idx.expand(rows.shape + tail).contiguous(),
                 val.contiguous())
    return out[:, :R]


def wave_coordinator_step(wave: WaveState, t, lease_ticks=LEASE_OFF):
    """One tick of every chain's device-resident 2PC coordinator (runs in
    ``ChainSim.tick`` before the chains).  ``t`` is the tick, ``lease_ticks``
    the lock lease (an int or the lock table's ``[C]`` leaf).

    Consumes ``wave.coord_in`` (last tick's control replies), advances
    every slot's phase and returns ``(wave', sub_out [C, W*KT] Msg,
    sub_target [C, W*KT], final_out [C, W] Msg, (commits, aborts,
    occupancy) each [C])`` with the reference's semantics: sub-ops carry
    ``src == client == WAVE_BASE + chain * W + slot`` and ``qid == (chain
    * W + slot) * KT + participant``; a slot decides once every
    participant answered (an abort releases every key); a PREP slot with
    ``t - t_admit >= lease_ticks`` is force-aborted (outcome
    ``WAVE_EXPIRED``); completed slots append a log row (rows from a
    cumulative-sum rank, saturating at the log's capacity) and emit the
    client's final ``OP_TXN_REPLY``.
    """
    C, W, KT = wave.p_gkey.shape
    VW = wave.coord_in.value.shape[-1]
    dev = wave.phase.device
    t = torch.as_tensor(t, dtype=I32, device=dev)
    lease = torch.broadcast_to(
        torch.as_tensor(lease_ticks, dtype=I32, device=dev), (C,))
    wave_id0 = torch.arange(C, dtype=I32, device=dev)[:, None] * W  # [C, 1]

    # ---- 1. consume control replies (scatter by slot/participant) --------
    m = wave.coord_in
    live = m.live()
    q = m.qid.clamp(min=0)
    slot = q // KT - wave_id0
    j = q % KT
    in_range = live & (slot >= 0) & (slot < W)
    sl = slot.clamp(0, W - 1)
    ph = wave.phase.gather(1, sl.long())
    # phase-1 replies: grant, deny, or a stale-route redirect of the
    # PREPARE (a NACK by another name)
    p1 = in_range & (ph == WAVE_PREP) & (
        (m.op == OP_PREPARE_ACK) | (m.op == OP_PREPARE_NACK)
        | (m.op == OP_STALE_NACK))
    ack = p1 & (m.op == OP_PREPARE_ACK)
    # phase-2 acks: the tail's or the head's TXN_REPLY, or a stale/write
    # NACK of the release (treated as done: a protocol bug surfaces as an
    # abort, not a wedged slot)
    p2 = in_range & (ph == WAVE_FIN) & (
        (m.op == OP_TXN_REPLY) | (m.op == OP_STALE_NACK)
        | (m.op == OP_WRITE_NACK))
    row = lambda hit: torch.where(hit, sl, W)
    p_replied = _set_cells(wave.p_replied, row(p1), j, 1)
    p_acked = _set_cells(wave.p_acked, row(ack), j, 1)
    p_snap = _set_cells(wave.p_snap, row(ack), j, m.value[..., 0])
    p_done = _set_cells(wave.p_done, row(p2), j, 1)
    p_wseq = _set_cells(wave.p_wseq, row(p2), j, m.seq)

    # ---- 2. slot transitions ---------------------------------------------
    used = wave.p_gkey >= 0                                  # [C, W, KT]
    occupancy = (wave.phase != WAVE_FREE).sum(1).to(I32)
    admitted = wave.phase == WAVE_ADMITTED
    # lease force-abort: a PREP slot past the lease can never hear its
    # missing replies (the heads reclaimed its locks), so they are
    # synthesized and the slot decides now, as an abort
    forced = (wave.phase == WAVE_PREP) & ((t - wave.t_admit)
                                          >= lease[:, None])
    p_replied = torch.where(forced[..., None],
                            torch.maximum(p_replied, used.to(I32)), p_replied)
    prep_all = (wave.phase == WAVE_PREP) & ((p_replied > 0) | ~used).all(2)
    all_ack = ((p_acked > 0) | ~used).all(2)
    enter_fin = prep_all
    decide_commit = enter_fin & all_ack & ~forced
    committing = torch.where(
        enter_fin,
        torch.where(forced, WAVE_EXPIRED, decide_commit.to(I32)).to(I32),
        wave.committing)
    fin_all = (wave.phase == WAVE_FIN) & ((p_done > 0) | ~used).all(2)
    committed = wave.committing == 1                     # valid on FIN slots
    phase = torch.where(
        admitted, WAVE_PREP,
        torch.where(enter_fin, WAVE_FIN,
                    torch.where(fin_all, WAVE_FREE, wave.phase))).to(I32)

    # ---- 3. emit sub-ops (a slot enters phase 1 or phase 2, never both) --
    emit1 = admitted[..., None] & used
    emit2 = enter_fin[..., None] & used
    do_commit = decide_commit[..., None] & (wave.p_write > 0)
    op = torch.where(
        emit1, OP_PREPARE,
        torch.where(emit2, torch.where(do_commit, OP_COMMIT, OP_ABORT),
                    OP_NOP))
    emit = emit1 | emit2
    slot_col = torch.arange(W, dtype=I32, device=dev)[None, :]
    my_id = WAVE_BASE + wave_id0 + slot_col                    # [C, W]
    sub_qid = ((wave_id0 + slot_col)[..., None] * KT
               + torch.arange(KT, dtype=I32, device=dev))      # [C, W, KT]
    value = torch.zeros((C, W, KT, VW), dtype=I32, device=dev)
    value[..., 0] = torch.where(do_commit, wave.p_wval, 0)
    flat2 = lambda x: x.reshape((C, W * KT) + x.shape[3:])
    per_part = lambda x: flat2(x[..., None].expand(C, W, KT))
    zeros = torch.zeros((C, W * KT), dtype=I32, device=dev)
    sub_out = Msg(
        op=flat2(torch.where(emit, op, OP_NOP)),
        key=flat2(wave.p_lkey),
        value=flat2(value),
        seq=per_part(wave.txn_id),
        src=per_part(my_id),
        dst=torch.full_like(zeros, NOWHERE),
        client=per_part(my_id),
        entry=zeros,
        qid=flat2(sub_qid),
        t_inject=(zeros + t),
        extra=zeros,
        ver=per_part(wave.epoch),
    ).mask(flat2(emit))
    sub_target = flat2(torch.where(emit, wave.p_owner, -1)).to(I32)

    # ---- 4. completed slots: final client reply + completion log ---------
    zw = torch.zeros((C, W), dtype=I32, device=dev)
    final_out = Msg(
        op=torch.where(fin_all, OP_TXN_REPLY, OP_NOP),
        key=wave.p_gkey[..., 0],
        value=torch.zeros((C, W, VW), dtype=I32, device=dev),
        seq=torch.where(committed, 0, -1),
        src=zw,  # the tick stamps the head position
        dst=torch.where(fin_all, TO_CLIENT, NOWHERE),
        client=wave.client,
        entry=zw,
        qid=wave.qid,
        t_inject=wave.t_admit,
        extra=zw,
        ver=wave.epoch,
    ).mask(fin_all)

    Lg = wave.log_txn.shape[1]
    n_fin = fin_all.sum(1).to(I32)
    rank = torch.cumsum(fin_all.to(I32), 1) - 1
    log_row = wave.log_cursor[:, None] + rank
    tgt = torch.where(fin_all & (log_row < Lg), log_row, Lg)
    put = lambda buf, val: _put_rows(buf, tgt, val)
    log_cursor = torch.clamp(wave.log_cursor + n_fin, max=Lg).to(I32)
    n_commit = (fin_all & committed).sum(1).to(I32)
    n_abort = (fin_all & ~committed).sum(1).to(I32)

    new_wave = wave._replace(
        phase=phase,
        committing=torch.where(fin_all, -1, committing).to(I32),
        p_replied=p_replied, p_acked=p_acked, p_done=p_done,
        p_snap=p_snap, p_wseq=p_wseq,
        log_txn=put(wave.log_txn, wave.txn_id),
        # the outcome code verbatim (0 abort / 1 commit / 2 lease-expired)
        log_committed=put(wave.log_committed, wave.committing),
        log_t_admit=put(wave.log_t_admit, wave.t_admit),
        log_t_done=put(wave.log_t_done, zw + t),
        log_gkey=put(wave.log_gkey, wave.p_gkey),
        log_write=put(wave.log_write, wave.p_write),
        log_wseq=put(wave.log_wseq, p_wseq),
        log_snap=put(wave.log_snap, p_snap),
        log_cursor=log_cursor,
        # rebuilt by the tick's control-reply router; blanked here so a
        # routing bug cannot re-deliver stale replies
        coord_in=wave.coord_in.mask(torch.zeros_like(live)),
    )
    return new_wave, sub_out, sub_target, final_out, (
        n_commit, n_abort, occupancy)


# ---------------------------------------------------------------------------
# Host-side transaction description + planner (the 2PC coordinator role)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Txn:
    """A multi-key transaction over *global* keys: ``writes`` maps global
    key -> value word 0, ``reads`` are snapshot-read keys; a transaction
    touches a key once."""

    txn_id: int
    writes: tuple[tuple[int, int], ...] = ()
    reads: tuple[int, ...] = ()
    client: int = 0

    @property
    def keys(self) -> tuple[int, ...]:
        return tuple(k for k, _ in self.writes) + tuple(self.reads)


@dataclasses.dataclass
class TxnResult:
    txn_id: int
    committed: bool
    mode: str                      # "direct" | "2pc" | "wave" | "wave_expired"
    nacks: int = 0                 # prepare NACKs observed (2pc only)
    write_seqs: dict = dataclasses.field(default_factory=dict)  # gkey -> seq
    read_values: dict = dataclasses.field(default_factory=dict)  # gkey -> v0


class TxnPlanner:
    """Splits multi-key transactions into per-chain sub-ops through the
    partition map and plans the two phases (host-side metadata work;
    every per-query step stays on the device).  Single-chain transactions
    take the direct path: plain reads and writes in one batch, no PREPARE
    round.

    With the owning ``Coordinator`` the planner splits keys with the
    control plane's current map and stamps its epoch into every sub-op.
    Streams are built as numpy, then one tensor per field on ``device``
    (default: the coordinator's, else CUDA).
    """

    def __init__(self, cfg: ChainConfig | ClusterConfig,
                 qid_base: int = 1 << 24, coordinator=None, device=None):
        self.cluster = as_cluster(cfg)
        self._next_qid = qid_base
        self._coordinator = coordinator
        if device is None:
            device = coordinator.device if coordinator is not None else "cuda"
        self.device = resolve_device(device)

    # -- partition-map splitting -------------------------------------------
    def _key_to_chain(self, key: int) -> int:
        if self._coordinator is not None:
            return self._coordinator.key_to_chain(key)
        return int(self.cluster.key_to_chain(key))

    @property
    def _epoch(self) -> int:
        if self._coordinator is not None:
            return self._coordinator.partition_epoch
        return 0

    def chains_of(self, txn: Txn) -> list[int]:
        return sorted({self._key_to_chain(k) for k in txn.keys})

    def is_single_chain(self, txn: Txn) -> bool:
        return len(self.chains_of(txn)) == 1

    def _qids(self, m: int) -> list[int]:
        out = list(range(self._next_qid, self._next_qid + m))
        self._next_qid += m
        return out

    # -- stream construction ------------------------------------------------
    def _stream(self, subs: list[tuple]) -> Msg:
        """subs: (op, global_key, value0, seq, qid, client) -> [1, Q] Msg."""
        Q = len(subs)
        cols = np.asarray(subs, dtype=np.int64).reshape(Q, 6)
        col = lambda i: cols[:, i].astype(np.int32)
        value = np.zeros((Q, self.cluster.chain.value_words), np.int32)
        value[:, 0] = col(2)
        client = CLIENT_BASE + col(5)
        fields = dict(
            op=col(0), key=col(1), value=value, seq=col(3), src=client,
            dst=np.full(Q, NOWHERE, np.int32), client=client,
            entry=np.zeros(Q, np.int32), qid=col(4),
            t_inject=np.zeros(Q, np.int32), extra=np.zeros(Q, np.int32),
            ver=np.full(Q, self._epoch, np.int32))
        return Msg(**{k: torch.from_numpy(v[None]).to(self.device)
                      for k, v in fields.items()})

    def phase1(self, txns: list[Txn]):
        """Plan phase 1: PREPAREs for cross-chain txns, plain ops for
        single-chain ones.  Returns (stream [1, Q] | None, plan)."""
        subs, plan = [], {}
        for t in txns:
            mode = "direct" if self.is_single_chain(t) else "2pc"
            entry = {"txn": t, "mode": mode, "p1": {}, "p2": {}}
            if mode == "direct":
                it = iter(self._qids(len(t.writes) + len(t.reads)))
                for gk, v in t.writes:
                    q = next(it)
                    subs.append((OP_WRITE, gk, v, -1, q, t.client))
                    entry["p1"][q] = ("w", gk)
                for gk in t.reads:
                    q = next(it)
                    subs.append((OP_READ, gk, 0, -1, q, t.client))
                    entry["p1"][q] = ("r", gk)
            else:
                for gk, q in zip(t.keys, self._qids(len(t.keys))):
                    subs.append((OP_PREPARE, gk, 0, t.txn_id, q, t.client))
                    entry["p1"][q] = ("p", gk)
            plan[t.txn_id] = entry
        return (self._stream(subs) if subs else None), plan

    def phase2(self, plan: dict, seen: dict):
        """Decide commit/abort per 2PC txn from the phase-1 replies
        (``seen``: qid -> (op, seq, value0)) and plan the second round.  A
        missing or NACKed prepare aborts the txn, and an aborting txn
        releases every key (the head refuses a release it does not
        hold)."""
        subs = []
        for entry in plan.values():
            t: Txn = entry["txn"]
            if entry["mode"] != "2pc":
                continue
            nacks = 0
            for q in entry["p1"]:
                r = seen.get(q)
                if r is None or r[0] != OP_PREPARE_ACK:
                    nacks += 1
            entry["nacks"] = nacks
            entry["decision"] = "commit" if nacks == 0 else "abort"
            wkeys = dict(t.writes)
            for gk in t.keys:
                q = self._qids(1)[0]
                if entry["decision"] == "commit" and gk in wkeys:
                    subs.append((OP_COMMIT, gk, wkeys[gk], t.txn_id, q,
                                 t.client))
                    entry["p2"][q] = ("c", gk)
                else:
                    subs.append((OP_ABORT, gk, 0, t.txn_id, q, t.client))
                    entry["p2"][q] = ("a", gk)
        return self._stream(subs) if subs else None

    def results(self, plan: dict, seen: dict) -> list[TxnResult]:
        out = []
        for entry in plan.values():
            t: Txn = entry["txn"]
            res = TxnResult(txn_id=t.txn_id, committed=False,
                            mode=entry["mode"], nacks=entry.get("nacks", 0))
            if entry["mode"] == "direct":
                ok = True
                for q, (kind, gk) in entry["p1"].items():
                    r = seen.get(q)
                    want = OP_WRITE_REPLY if kind == "w" else OP_READ_REPLY
                    if r is None or r[0] != want:
                        ok = False
                    elif kind == "w":
                        res.write_seqs[gk] = r[1]
                    else:
                        res.read_values[gk] = r[2]
                res.committed = ok
            elif entry.get("decision") == "commit":
                ok = True
                for q, (kind, gk) in entry["p2"].items():
                    if kind != "c":
                        continue
                    r = seen.get(q)
                    if r is None or r[0] != OP_TXN_REPLY or r[1] < 0:
                        ok = False
                    else:
                        res.write_seqs[gk] = r[1]
                res.committed = ok
                if ok:
                    for q, (_, gk) in entry["p1"].items():
                        r = seen.get(q)
                        if r is not None and r[0] == OP_PREPARE_ACK \
                                and gk in t.reads:
                            res.read_values[gk] = r[2]
            out.append(res)
        return out


# ---------------------------------------------------------------------------
# Host-side driver: runs the phases against a live ChainSim
# ---------------------------------------------------------------------------
class TxnDriver:
    """Ticks a ``ChainSim`` through a wave of transactions: inject phase
    1, poll the reply log, decide, inject phase 2, poll again.

    Capacity contract: ``inject_capacity`` holds one wave's sub-ops in
    their head lanes (asserted) and the reply log holds every reply.
    """

    def __init__(self, sim, planner: TxnPlanner):
        self.sim = sim
        self.planner = planner

    def _reply_map(self, state) -> dict:
        r = state.replies.merged()
        return {
            int(q): (int(op), int(s), int(v))
            for q, op, s, v in zip(r.qid.tolist(), r.op.tolist(),
                                   r.seq.tolist(), r.value0.tolist())
        }

    def _inject(self, state, stream: Msg):
        from repro_torch.core.workload import route_stream

        co = self.planner._coordinator
        stream = tree_map(lambda x: x.to(self.sim.device), stream)
        routed = route_stream(
            self.planner.cluster, stream, self.sim.c_in,
            pmap=co.partition_map() if co is not None else None)
        dropped = int(routed.dropped)
        if dropped:
            raise AssertionError(
                f"txn stream overflowed injection lanes ({dropped} sub-ops "
                "dropped) - shrink the wave or grow inject_capacity")
        return self.sim.tick(state, tree_map(lambda x: x[0], routed.lanes))

    def _await(self, state, qids: set, max_ticks: int, landed_base: int):
        """Tick until the wave's replies land, then decode the log.  Each
        sub-op yields one logged exit, so polling syncs only the ``[C]``
        cursor leaf per tick (``ReplyLog.total_landed``) and the log body
        moves once; if the count never arrives (a dropped sub-op), the
        body is re-read only on ticks where the cursors grew."""
        empty = self.sim.empty_injection()
        expected = len(qids)
        ticks = 0
        while (ticks < max_ticks
               and state.replies.total_landed() - landed_base < expected):
            state = self.sim.tick(state, empty)
            ticks += 1
        seen = self._reply_map(state)
        landed = state.replies.total_landed()
        while ticks < max_ticks and not qids <= seen.keys():
            state = self.sim.tick(state, empty)
            ticks += 1
            now = state.replies.total_landed()
            if now != landed:
                landed = now
                seen = self._reply_map(state)
        return state, seen

    def run(self, state, txns: list[Txn], max_ticks: Optional[int] = None):
        """Run one wave of transactions to completion.  Returns
        ``(state, [TxnResult])``."""
        max_ticks = max_ticks or (4 * self.sim.n + 8)
        stream1, plan = self.planner.phase1(txns)
        qids1 = {q for e in plan.values() for q in e["p1"]}
        base = state.replies.total_landed()
        if stream1 is not None:
            state = self._inject(state, stream1)
        state, seen = self._await(state, qids1, max_ticks, base)
        stream2 = self.planner.phase2(plan, seen)
        if stream2 is not None:
            base = state.replies.total_landed()
            state = self._inject(state, stream2)
            qids2 = {q for e in plan.values() for q in e["p2"]}
            state, seen = self._await(state, qids2, max_ticks, base)
        return state, self.planner.results(plan, seen)


# ---------------------------------------------------------------------------
# Batched admission for the in-network coordinator (the only host work on
# the wave path: fill FREE slots, drain, decode the completion log)
# ---------------------------------------------------------------------------
_SLOT_LEAVES = ("phase", "txn_id", "client", "qid", "epoch", "t_admit",
                "committing")
_PART_LEAVES = ("p_gkey", "p_owner", "p_lkey", "p_wval", "p_write",
                "p_replied", "p_acked", "p_done", "p_snap", "p_wseq")


class TxnWaveDriver:
    """Admits transactions into a wave-enabled ``ChainSim``'s device-side
    coordinator and decodes the completion log into ``TxnResult``s.

    Per admission round the host syncs one ``[C, W]`` leaf (the slot
    phases), fills every free slot whose coordinator chain has queued
    work with one indexed write per leaf, and hands the engine back to a
    fixed-length ``drain``.

    Capacity contract: ``wave_log_capacity`` holds every admitted
    transaction (asserted), per-key in-flight write depth fits
    ``num_versions``, and transactions wider than ``wave_keys`` are
    refused at admission.
    """

    def __init__(self, sim, planner: TxnPlanner):
        if not getattr(sim, "wave_depth", 0) > 0:
            raise AssertionError(
                "TxnWaveDriver needs a wave-enabled ChainSim (wave_depth > 0)")
        self.sim = sim
        self.planner = planner
        self.last_rounds = 0   # admission-loop iterations of the last run
        self.last_ticks = 0    # device ticks the last run consumed

    # -- planning ----------------------------------------------------------
    def _locate(self, gk: int):
        co = self.planner._coordinator
        if co is not None:
            return co.key_to_chain(gk), co.local_key(gk)
        cl = self.planner.cluster
        return int(cl.key_to_chain(gk)), int(cl.key_to_slot(gk))

    def _plan(self, txn: Txn) -> dict:
        KT = self.sim.wave_keys
        if not 0 < len(txn.keys) <= KT:
            raise AssertionError(
                f"txn {txn.txn_id} has {len(txn.keys)} keys; this engine's "
                f"wave_keys is {KT}")
        wkeys = dict(txn.writes)
        parts = []
        for gk in txn.keys:
            chain, lkey = self._locate(gk)
            parts.append((gk, chain, lkey, wkeys.get(gk, 0),
                          int(gk in wkeys)))
        # the coordinator chain is the first key's owner: admission load
        # follows the workload's key distribution
        return {"txn": txn, "coord": parts[0][1], "parts": parts,
                "qid": self.planner._qids(1)[0]}

    # -- admission ---------------------------------------------------------
    def _admit(self, state, queue: list, phases: np.ndarray, t_now: int):
        """Fill FREE slots from the queue between ticks, writing the
        state's wave leaves in place.  Mutates ``queue``; returns (state,
        n_admitted)."""
        KT = self.sim.wave_keys
        free = {c: list(np.nonzero(phases[c] == WAVE_FREE)[0])
                for c in range(phases.shape[0])}
        picked, rest = [], []
        for plan in queue:
            slots = free[plan["coord"]]
            if slots:
                picked.append((plan, int(slots.pop())))
            else:
                rest.append(plan)
        queue[:] = rest
        if not picked:
            return state, 0
        n = len(picked)
        dev = state.wave.phase.device
        epoch = self.planner._epoch
        slot_vals = np.asarray([
            (WAVE_ADMITTED, p["txn"].txn_id, CLIENT_BASE + p["txn"].client,
             p["qid"], epoch, t_now, -1) for p, _ in picked], np.int32)
        pad = [(-1, -1, 0, 0, 0)]
        parts = np.asarray([p["parts"] + pad * (KT - len(p["parts"]))
                            for p, _ in picked], np.int64)
        part_vals = np.zeros((n, len(_PART_LEAVES), KT), np.int32)
        # a plan's (gkey, owner, lkey, wval, write) are the first five
        # participant leaves; the replies' leaves start blank
        part_vals[:, :5] = parts.transpose(0, 2, 1)
        part_vals[:, _PART_LEAVES.index("p_wseq")] = -1
        at = (torch.as_tensor([p["coord"] for p, _ in picked], device=dev),
              torch.as_tensor([s for _, s in picked], device=dev))
        slot_t = torch.from_numpy(slot_vals).to(dev)
        part_t = torch.from_numpy(part_vals).to(dev)
        w = state.wave
        for i, name in enumerate(_SLOT_LEAVES):
            getattr(w, name).index_put_(at, slot_t[:, i])
        for i, name in enumerate(_PART_LEAVES):
            getattr(w, name).index_put_(at, part_t[:, i])
        return state, n

    # -- the run loop ------------------------------------------------------
    def run(self, state, txns: list[Txn], step_ticks: int = 2,
            max_rounds: Optional[int] = None):
        """Admit ``txns``, drain until every slot frees, decode the log.
        Returns ``(state, [TxnResult])`` in log order, one per txn.
        ``step_ticks`` is the drain length between admission rounds."""
        sim = self.sim
        base = state.wave.log_cursor.cpu().numpy().copy()   # [C] rows so far
        queue = [self._plan(t) for t in txns]
        n_total = len(queue)
        if int(base.sum()) + n_total > sim.C * sim.wave_log_capacity:
            raise AssertionError(
                "completion log too small for this run - grow "
                "wave_log_capacity")
        max_rounds = max_rounds or (
            8 * (n_total // max(sim.C * sim.wave_depth, 1) + 1)
            * (4 * sim.n + 8) // step_ticks)
        t0 = int(state.t)    # synced once; ticks tracked host-side
        rounds = 0
        while True:
            phases = state.wave.phase.cpu().numpy()   # the one synced leaf
            if queue:
                state, _ = self._admit(state, queue, phases,
                                       t0 + rounds * step_ticks)
            elif (phases != WAVE_FREE).sum() == 0:
                break
            state = sim.drain(state, step_ticks)
            rounds += 1
            if rounds > max_rounds:
                raise AssertionError(
                    f"wave run wedged: {len(queue)} queued, "
                    f"{(phases != WAVE_FREE).sum()} slots busy after "
                    f"{rounds} rounds - check the capacity contract")
        self.last_rounds = rounds
        self.last_ticks = rounds * step_ticks
        return state, self._decode(state, base, n_total)

    # -- completion-log decode --------------------------------------------
    def _decode(self, state, base: np.ndarray, n_total: int):
        w = state.wave
        log = {f: getattr(w, f).cpu().numpy() for f in (
            "log_txn", "log_committed", "log_gkey", "log_write",
            "log_wseq", "log_snap", "log_cursor")}
        results = []
        for c in range(log["log_txn"].shape[0]):
            for r in range(int(base[c]), int(log["log_cursor"][c])):
                outcome = int(log["log_committed"][c, r])
                committed = outcome == 1
                res = TxnResult(
                    txn_id=int(log["log_txn"][c, r]), committed=committed,
                    mode="wave_expired" if outcome == WAVE_EXPIRED
                    else "wave")
                if committed:
                    for gk, iw, ws, sn in zip(
                            log["log_gkey"][c, r].tolist(),
                            log["log_write"][c, r].tolist(),
                            log["log_wseq"][c, r].tolist(),
                            log["log_snap"][c, r].tolist()):
                        if gk < 0:
                            continue
                        if iw:
                            res.write_seqs[gk] = ws
                        else:
                            res.read_values[gk] = sn
                results.append(res)
        if len(results) != n_total:
            raise AssertionError(
                f"completion log gained {len(results)} rows, expected "
                f"{n_total} (log overflow or wedged slot)")
        return results


# ---------------------------------------------------------------------------
# Host-side reference executor (the serializability oracle)
# ---------------------------------------------------------------------------
def reference_execute(committed: list[Txn]) -> dict:
    """Apply committed transactions serially in list order: the expected
    {global_key: value} of every touched key (untouched keys stay 0)."""
    kv: dict[int, int] = {}
    for t in committed:
        for k, v in t.writes:
            kv[k] = v
    return kv


def serial_order(results: list[TxnResult]) -> list[int]:
    """Topological serialization order of the committed txns from their
    observed per-key write seqs; raises if the precedence graph has a
    cycle (a serializability violation)."""
    committed = [r for r in results if r.committed and r.write_seqs]
    by_key: dict[int, list[tuple[int, int]]] = {}
    for r in committed:
        for k, s in r.write_seqs.items():
            by_key.setdefault(k, []).append((s, r.txn_id))
    edges: dict[int, set[int]] = {r.txn_id: set() for r in committed}
    indeg = {r.txn_id: 0 for r in committed}
    for pairs in by_key.values():
        pairs.sort()
        for (_, a), (_, b) in zip(pairs, pairs[1:]):
            if b not in edges[a]:
                edges[a].add(b)
                indeg[b] += 1
    order, ready = [], [t for t, d in indeg.items() if d == 0]
    while ready:
        t = ready.pop()
        order.append(t)
        for u in edges[t]:
            indeg[u] -= 1
            if indeg[u] == 0:
                ready.append(u)
    if len(order) != len(committed):
        raise AssertionError(
            "cyclic write-precedence among committed txns: not serializable")
    return order
