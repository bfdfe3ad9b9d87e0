"""NetChain (chain replication) baseline node logic, batched.

The port of ``repro/core/netchain.py``: only the tail answers reads (a
read entering at distance d from the tail costs 2d+2 packets), writes
enter at the head, overwrite the single version and propagate to the
tail, which acknowledges the client.  Sequence numbers wrap at
``SEQ_BITS`` bits, NetChain's 16-bit SEQ field.  Node axis as in
``craq.node_step``; the clean reads of every node are one read-kernel
launch.
"""
from __future__ import annotations

import torch

from repro_torch.core import store as store_lib
from repro_torch.core.store import Store
from repro_torch.core.types import (
    NOWHERE,
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

SEQ_BITS = 16  # NetChain's default SEQ width


def node_step(cfg: ChainConfig, store: Store, roles: Roles, inbox: Msg,
              dense_rank: bool = False):
    """One CR pipeline pass on every node. Returns (store', outbox).

    outbox has 4*B slots per node: [tail replies | forwards | reply
    relays | write-replies].
    """
    del cfg
    B = inbox.batch
    is_read = inbox.op == OP_READ
    is_write = inbox.op == OP_WRITE
    is_reply = inbox.op == OP_READ_REPLY
    is_commit = inbox.op == OP_COMMIT
    is_tail = roles.is_tail[:, None]
    me = roles.my_pos[:, None].expand(-1, B)

    nacked = is_write & (inbox.seq < 0) & roles.frozen[:, None]
    is_write = (is_write & ~nacked) | is_commit

    # ---------------- READ: only the tail replies ----------------
    # the clean outputs of the read kernel (is_tail=False answers cell 0)
    v0, s0, _ = kv_ops.cluster_read_batch(store, inbox.key, is_tail=False)
    tail_answers = is_read & is_tail
    fwd_read = is_read & ~is_tail
    back_dst = torch.where(inbox.entry == me, TO_CLIENT,
                           roles.prev_pos[:, None])
    replies = Msg(
        op=torch.where(tail_answers, OP_READ_REPLY, 0),
        key=inbox.key,
        value=v0,
        seq=s0,
        src=me,
        dst=torch.where(tail_answers, back_dst, NOWHERE),
        client=inbox.client,
        entry=inbox.entry,
        qid=inbox.qid,
        t_inject=inbox.t_inject,
        extra=inbox.extra,
        ver=inbox.ver,
    ).mask(tail_answers)

    # ---------------- READ_REPLY relay back toward the entry node --------
    relays = Msg(
        op=torch.where(is_reply, OP_READ_REPLY, 0),
        key=inbox.key,
        value=inbox.value,
        seq=inbox.seq,
        src=me,
        dst=torch.where(is_reply, back_dst, NOWHERE),
        client=inbox.client,
        entry=inbox.entry,
        qid=inbox.qid,
        t_inject=inbox.t_inject,
        extra=inbox.extra,
        ver=inbox.ver,
    ).mask(is_reply)

    # ---------------- WRITE: overwrite + propagate ----------------
    needs_seq = is_write & (inbox.seq < 0)
    store, stamped = store_lib.assign_seqs(store, inbox.key, needs_seq,
                                           dense_rank=dense_rank)
    wseq = torch.where(needs_seq, stamped % (1 << SEQ_BITS), inbox.seq)
    store = store_lib.overwrite_clean(store, inbox.key, inbox.value, wseq,
                                      is_write)
    fwd_write = is_write & ~is_tail
    forwards = Msg(
        op=torch.where(fwd_write,
                       torch.where(is_commit, OP_COMMIT, OP_WRITE), 0),
        key=inbox.key,
        value=inbox.value,
        seq=wseq,
        src=me,
        dst=torch.where(fwd_write, roles.next_pos[:, None], NOWHERE),
        client=inbox.client,
        entry=inbox.entry,
        qid=inbox.qid,
        t_inject=inbox.t_inject,
        extra=inbox.extra,
        ver=inbox.ver,
    ).mask(fwd_write | fwd_read)
    # Forwarded reads ride in the same section (op stays READ).
    forwards = forwards._replace(
        op=torch.where(fwd_read, OP_READ, forwards.op).to(torch.int32),
        seq=torch.where(fwd_read, inbox.seq, forwards.seq),
        dst=torch.where(fwd_read, roles.next_pos[:, None], forwards.dst),
    )

    # Tail acknowledges the write straight to the client; freeze NACKs
    # share the section (disjoint masks).
    wack = is_write & is_tail
    wr_mask = wack | nacked
    wreplies = Msg(
        op=torch.where(nacked, OP_WRITE_NACK,
                       torch.where(wack,
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

    outbox = Msg.concat([replies, forwards, relays, wreplies], dim=1)
    return store, outbox
