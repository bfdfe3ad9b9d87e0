"""The device-side telemetry plane - the port of ``repro/core/telemetry.py``.

Three int32 state groups ride ``SimState.telemetry`` and are updated
inside the tick, on the device, with no host round trip:

1. the latency histogram ``lat_hist [C, OPCLASS, BKT]``: the log2 bucket
   of ``ticks_in_flight`` of every reply that exits to a client, split by
   op class (``types.reply_op_class``), over the same exit batch the
   reply log appends.  It never overflows, so its percentiles hold over
   any run length;
2. the flight-recorder ring ``ring [C, W, N_RING_FIELDS]``: one health
   row per tick (``RING_FIELDS``) at a wrapping cursor; ``ring_cursor``
   counts every row ever written (the write index is ``cursor % W``);
3. sampled packet traces ``trace_* [C, S, H]``: a qid-hash sample of
   about 1/64 of the queries records (node, tick, op) per hop.  A slot
   is direct-mapped by the hash and claimed by the first sampled arrival
   while free; it records at most one event a tick, the arrival with the
   lowest flat inbox index, so traces are a function of the schedule.

The reference vmaps each recorder over the chain axis; here every leaf
carries the leading ``[C]`` and each recorder handles all chains in one
set of operations.  ``Telemetry.empty(0, 0, 0, 0, C)`` gives the
zero-size leaves of ``ChainSim(telemetry=False)``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.types import (I32, N_OPCLASS, OP_NOP, reply_op_class,
                                    resolve_device)

# Ring columns, in row order.  Counter fields (drops .. stale_routes) are
# this tick's deltas of the matching Metrics counters; gauge fields
# (inflight, inbox_high_water, wave_occupancy) are end-of-tick readings.
RING_FIELDS = (
    "tick",              # SimState.t the row describes
    "inflight",          # live messages in the chain's inbox after the tick
    "inbox_high_water",  # max live messages at any single node's inbox
    "drops",             # fabric drops this tick
    "lock_conflicts",    # PREPARE_NACKs this tick
    "wave_occupancy",    # active wave-table slots (0 when wave_depth == 0)
    "replies",           # client replies landed this tick
    "stale_routes",      # stale-map NACK redirects this tick
)
N_RING_FIELDS = len(RING_FIELDS)

# A qid is traced iff the low TRACE_SAMPLE_BITS bits of its mixed hash are
# zero (about 1 in 64).  The xor-fold matters: qids are dense sequential
# integers, and a multiply-only hash mod a power of two would be qid % 64.
TRACE_SAMPLE_BITS = 6

# 16 log2 buckets cover latencies up to 2**15 ticks.
DEFAULT_HIST_BUCKETS = 16


class Telemetry(NamedTuple):
    """Per-chain telemetry state; every leaf has a leading ``[C]`` and is
    int32."""

    lat_hist: torch.Tensor     # [C, OPCLASS, BKT] exit-latency histogram
    ring: torch.Tensor         # [C, W, N_RING_FIELDS] flight-recorder rows
    ring_cursor: torch.Tensor  # [C] rows written (write index cursor % W)
    trace_qid: torch.Tensor    # [C, S] qid owning each trace slot (-1 free)
    trace_node: torch.Tensor   # [C, S, H] node of each recorded hop event
    trace_tick: torch.Tensor   # [C, S, H] tick of each recorded hop event
    trace_op: torch.Tensor     # [C, S, H] opcode observed at each hop event
    trace_len: torch.Tensor    # [C, S] hop events recorded (clipped at H)

    @staticmethod
    def empty(hist_buckets: int, ring_window: int, trace_slots: int,
              trace_hops: int, n_chains: int = 1,
              device="cuda") -> "Telemetry":
        """Fresh telemetry for ``n_chains`` chains; zero-size dimensions
        (the plane off) give zero-element leaves."""
        dev = resolve_device(device)
        z = lambda *s: torch.zeros((n_chains,) + s, dtype=I32, device=dev)
        return Telemetry(
            lat_hist=z(N_OPCLASS, hist_buckets),
            ring=z(ring_window, N_RING_FIELDS),
            ring_cursor=z(),
            trace_qid=torch.full((n_chains, trace_slots), -1, dtype=I32,
                                 device=dev),
            trace_node=z(trace_slots, trace_hops),
            trace_tick=z(trace_slots, trace_hops),
            trace_op=z(trace_slots, trace_hops),
            trace_len=z(trace_slots),
        )


def latency_bucket(ticks, n_buckets: int):
    """log2 bucket of a tick count: bucket b covers [2**b, 2**(b+1)), the
    top bucket is open-ended and ticks clamp at 1.  Takes a torch tensor
    (on any device) or anything numpy takes, and returns int32 of the same
    kind: the hub's host-side percentiles use this same function."""
    if isinstance(ticks, torch.Tensor):
        t = ticks.to(I32).clamp(min=1)
        # the edges 2**1 .. 2**(n-1), made on the device (no host copy)
        e = torch.ones(n_buckets - 1, dtype=I32, device=t.device) << \
            torch.arange(1, n_buckets, dtype=I32, device=t.device)
        return (t[..., None] >= e).sum(dim=-1).to(I32)
    t = np.maximum(np.asarray(ticks, np.int32), 1)
    e = np.asarray([1 << j for j in range(1, n_buckets)], np.int32)
    return np.sum(t[..., None] >= e, axis=-1).astype(np.int32)


def record_latency(lat_hist: torch.Tensor, op, seq, ticks) -> torch.Tensor:
    """Add one exit batch (``op``/``seq``/``ticks`` [C, M]) to the
    [C, OPCLASS, BKT] histogram, in place.  An integer histogram: each
    classified exit adds one at ``(chain, class, bucket)``; NOP padding
    and anything ``reply_op_class`` leaves at -1 land in a padding cell
    that is cut off."""
    C, n_cls, n_buckets = lat_hist.shape
    cls = reply_op_class(op, seq)
    b = latency_bucket(ticks, n_buckets)
    size = C * n_cls * n_buckets
    chain = torch.arange(C, dtype=torch.int64, device=op.device)[:, None]
    cell = torch.where(cls >= 0, (chain * n_cls + cls) * n_buckets + b, size)
    counts = torch.zeros(size + 1, dtype=I32, device=op.device)
    counts.scatter_add_(0, cell.reshape(-1).long(),
                        torch.ones_like(cell.reshape(-1), dtype=I32))
    return lat_hist.add_(counts[:size].reshape(C, n_cls, n_buckets))


def trace_hash(qid):
    """Mixed sampling hash (xor-fold; see TRACE_SAMPLE_BITS).  ``>>`` on
    int32 is arithmetic, as in the reference."""
    q = torch.as_tensor(qid, dtype=I32)
    return q ^ (q >> TRACE_SAMPLE_BITS) ^ (q >> (2 * TRACE_SAMPLE_BITS))


def trace_sampled(qid):
    """True for the ~1/64 of qids the trace buffer samples."""
    mask = (1 << TRACE_SAMPLE_BITS) - 1
    return (trace_hash(qid) & mask) == 0


def trace_slot_of(qid, n_slots: int):
    """Direct-mapped trace slot of a sampled qid."""
    return (trace_hash(qid) >> TRACE_SAMPLE_BITS) % n_slots


def record_trace(tel: Telemetry, op, qid, node, t) -> Telemetry:
    """Record this tick's hop events into the trace buffer, in place.

    ``op``/``qid`` [C, M] are each chain's flat arrival batch (every
    message a node observed this tick, before the stale-route admission)
    and ``node`` ([M] or [C, M]) the node of each arrival.  Per slot at
    most one event records a tick, the lowest flat index among the
    arrivals of the slot's owner, found with two dense [C, S, M]
    min-reductions as in the reference."""
    C, n_slots, n_hops = tel.trace_node.shape
    M = op.shape[1]
    dev = op.device
    live = (op != OP_NOP) & (qid >= 0)
    samp = live & trace_sampled(qid)
    slot = torch.where(samp, trace_slot_of(qid, max(n_slots, 1)), n_slots)
    idx = torch.arange(M, dtype=torch.int64, device=dev)
    slot_ids = torch.arange(n_slots, dtype=I32, device=dev)
    in_slot = slot[:, None, :] == slot_ids[None, :, None]        # [C, S, M]

    # free slots claim the tick's first sampled arrival mapping to them
    first = torch.where(in_slot, idx, M).amin(dim=2)             # [C, S]
    claim = (first < M) & (tel.trace_qid < 0)
    first_c = first.clamp(0, max(M - 1, 0))
    owner = torch.where(claim, qid.gather(1, first_c),
                        tel.trace_qid).to(I32)

    # events owned by their slot; the first per slot records this tick
    own_of = owner.gather(1, slot.long().clamp(0, max(n_slots - 1, 0)))
    own = samp & (own_of == qid)
    ev = torch.where(in_slot & own[:, None, :], idx, M).amin(dim=2)
    got = ev < M
    ev_c = ev.clamp(0, max(M - 1, 0))

    pos = tel.trace_len
    write = got & (pos < n_hops)      # hops beyond H drop, len saturates
    cols = pos.long().clamp(0, max(n_hops - 1, 0))[..., None]    # [C, S, 1]
    node = torch.as_tensor(node, dtype=I32, device=dev).expand(C, M)
    tick = torch.as_tensor(t, dtype=I32, device=dev).expand(C, n_slots)

    def put(buf, val):
        old = buf.gather(2, cols)[..., 0]
        buf.scatter_(2, cols, torch.where(write, val.to(I32), old)[..., None])
        return buf

    return tel._replace(
        trace_qid=owner,
        trace_node=put(tel.trace_node, node.gather(1, ev_c)),
        trace_tick=put(tel.trace_tick, tick),
        trace_op=put(tel.trace_op, op.gather(1, ev_c)),
        trace_len=torch.where(got, (pos + 1).clamp(max=n_hops),
                              pos).to(I32),
    )


def record_ring(tel: Telemetry, row: torch.Tensor) -> Telemetry:
    """Write each chain's [N_RING_FIELDS] health row (``row`` [C, F]) at
    its wrapping cursor and advance the cursor, in place.  Only called
    when the ring is live (W >= 1)."""
    C, window, n_fields = tel.ring.shape
    at = (tel.ring_cursor % window).long()[:, None, None].expand(
        C, 1, n_fields)
    tel.ring.scatter_(1, at, row.to(I32)[:, None, :])
    return tel._replace(ring_cursor=(tel.ring_cursor + 1).to(I32))
