"""NetCRAQ node control logic - the paper's Algorithm 1, batched.

The port of ``repro/core/craq.py``.  ``node_step`` processes every node
of a cluster at once: store leaves ``[N, ...]``, role leaves ``[N]`` and
an inbox ``[N, B]`` over the flattened ``[C * n]`` node axis.

    READ  -> clean: reply locally from cell 0 (any node);
             dirty & tail: reply the latest dirty version;
             dirty & not tail: forward to the tail
    WRITE -> append a dirty version (drop on window overflow), forward
             toward the tail; at the tail commit, multicast ACK, reply;
             client writes to a frozen chain are NACKed at entry
    ACK   -> commit: install the clean value, compact versions <= seq
    COMMIT-> a transaction's phase-2 write: a WRITE that keeps its opcode

Batch order within one step: READs see the state at step start, then
ACKs apply, then WRITEs.  The reads of every node are one read-kernel
launch and the dirty appends one write-kernel launch
(``kernels/kv_engine/ops.py``); ACK commits, sequence stamping and the
tail commit stay plain torch, as they stay outside Pallas in the
reference.
"""
from __future__ import annotations

import torch

from repro_torch.core import store as store_lib
from repro_torch.core.store import Store
from repro_torch.core.types import (
    CLIENT_BASE,
    I32,
    MULTICAST,
    NOWHERE,
    OP_ACK,
    OP_COMMIT,
    OP_READ,
    OP_READ_REPLY,
    OP_TXN_REPLY,
    OP_WRITE,
    OP_WRITE_NACK,
    OP_WRITE_REPLY,
    TO_CLIENT,
    ChainConfig,
    Msg,
    Roles,
)
from repro_torch.kernels.kv_engine import ops as kv_ops


def node_step(cfg: ChainConfig, store: Store, roles: Roles, inbox: Msg,
              dense_rank: bool = False):
    """Process one inbox batch on every node. Returns (store', outbox).

    outbox has 4*B slots per node: [replies | forwards | acks |
    write-replies].  The store is edited in place where the write path
    allows (see ``core/store.py``); rebind the returned store.
    """
    del cfg
    B = inbox.batch
    is_read = inbox.op == OP_READ
    is_write = inbox.op == OP_WRITE
    is_ack = inbox.op == OP_ACK
    is_commit = inbox.op == OP_COMMIT
    is_tail = roles.is_tail[:, None]
    me = roles.my_pos[:, None].expand(-1, B)

    # Write freeze: client writes entering a frozen chain are NACKed.
    nacked = is_write & (inbox.seq < 0) & roles.frozen[:, None]
    is_write = (is_write & ~nacked) | is_commit

    # ---------------- READ path (observes pre-step state) ----------------
    reply_val, reply_seq, decision = kv_ops.cluster_read_batch(
        store, inbox.key, is_tail=roles.is_tail)
    clean = decision == 0
    answers = is_read & (clean | is_tail)
    fwd_read = is_read & ~clean & ~is_tail
    replies = Msg(
        op=torch.where(answers, OP_READ_REPLY, 0),
        key=inbox.key,
        value=reply_val,
        seq=reply_seq,
        src=me,
        dst=torch.where(answers, TO_CLIENT, NOWHERE),
        client=inbox.client,
        entry=inbox.entry,
        qid=inbox.qid,
        t_inject=inbox.t_inject,
        extra=inbox.extra,
        ver=inbox.ver,
    ).mask(answers)

    # ---------------- ACK path ----------------
    store = store_lib.commit(store, inbox.key, inbox.value, inbox.seq,
                             is_ack)

    # ---------------- WRITE path ----------------
    needs_seq = is_write & (inbox.seq < 0)
    store, stamped = store_lib.assign_seqs(store, inbox.key, needs_seq,
                                           dense_rank=dense_rank)
    wseq = torch.where(needs_seq, stamped, inbox.seq)

    if_tail_commit = is_write & is_tail
    if_appended = is_write & ~is_tail
    store, accepted = kv_ops.cluster_write_batch(
        store, inbox.key, inbox.value, wseq, if_appended,
        dense_rank=dense_rank)
    store = store_lib.commit(store, inbox.key, inbox.value, wseq,
                             if_tail_commit)

    # Forward accepted writes toward the tail; dirty reads go to the tail.
    fwd_mask = fwd_read | accepted
    fwd_dst = torch.where(fwd_read, roles.tail_pos[:, None],
                          roles.next_pos[:, None])
    forwards = Msg(
        op=torch.where(fwd_read, OP_READ,
                       torch.where(is_commit, OP_COMMIT, OP_WRITE)),
        key=inbox.key,
        value=inbox.value,
        seq=wseq,
        src=me,
        dst=torch.where(fwd_mask, fwd_dst, NOWHERE),
        client=inbox.client,
        entry=inbox.entry,
        qid=inbox.qid,
        t_inject=inbox.t_inject,
        extra=inbox.extra,
        ver=inbox.ver,
    ).mask(fwd_mask)

    # Tail: multicast ACK to the chain + acknowledge the client.
    ack_mask = if_tail_commit
    acks = Msg(
        op=torch.where(ack_mask, OP_ACK, 0),
        key=inbox.key,
        value=inbox.value,
        seq=wseq,
        src=me,
        dst=torch.where(ack_mask, MULTICAST, NOWHERE),
        client=inbox.client,
        entry=inbox.entry,
        qid=inbox.qid,
        t_inject=inbox.t_inject,
        extra=inbox.extra,
        ver=inbox.ver,
    ).mask(ack_mask)
    wr_mask = ack_mask | nacked
    wreplies = Msg(
        op=torch.where(nacked, OP_WRITE_NACK,
                       torch.where(ack_mask,
                                   torch.where(is_commit, OP_TXN_REPLY,
                                               OP_WRITE_REPLY), 0)),
        key=inbox.key,
        value=inbox.value,
        seq=torch.where(nacked, -1, wseq),
        src=me,
        dst=torch.where(wr_mask, TO_CLIENT, NOWHERE),
        client=inbox.client,
        entry=inbox.entry,
        qid=inbox.qid,
        t_inject=inbox.t_inject,
        extra=inbox.extra,
        ver=inbox.ver,
    ).mask(wr_mask)

    outbox = Msg.concat([replies, forwards, acks, wreplies], dim=1)
    return store, outbox


def stamp_entry(inbox: Msg, my_pos) -> Msg:
    """Record the chain position where a client query entered; ``my_pos``
    broadcasts against the inbox's batch shape."""
    from_client = inbox.src >= CLIENT_BASE
    pos = torch.as_tensor(my_pos, dtype=I32, device=inbox.src.device)
    return inbox._replace(
        entry=torch.where(from_client, pos, inbox.entry).to(I32))
