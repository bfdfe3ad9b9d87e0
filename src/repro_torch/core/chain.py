"""The cluster engine ``ChainSim`` - the port of ``repro/core/chain.py``'s
main path - and ``ChainDist``, the reference's production engine, with
one chain node per rank on torch.distributed (see its docstring).

A cluster of C chains of n nodes advances one tick at a time.  The
reference vmaps a per-chain tick over C and a per-node step over n; here
both batch axes are written out: state is ``[C, n, ...]``, the per-chain
stages take a leading ``[C]`` axis, and the node step runs once over the
flattened ``[C * n]`` nodes, so its store reads and dirty appends are one
kernel launch each per tick.

The tick's stages, in the reference's order: with a wave table
(``wave_depth > 0``) the in-network 2PC coordinator first, its sub-ops
crossing chains through ``cluster_route``; then per chain entry stamping
and dead-node masking, stale-route admission, lease expiry and the head
lock stage, the node step, the routing fabric (``segmented_route``, with
``dense_route`` kept as its oracle) with exact packet/hop accounting,
and the reply log; control replies addressed to a coordinator ride back
through ``cluster_route`` into the wave table.  The role table and the
partition map are read, never written, by the tick.  With
``wave_depth == 0`` the wave leaves pass through the tick untouched.

With ``telemetry=True`` (the default, as in the reference) the tick also
updates ``SimState.telemetry`` (``core/telemetry.py``): the exit-latency
histogram over the exit batch the reply log appends, the sampled hop
traces over the arrival batch before admission, and one flight-recorder
row per chain per tick.  ``telemetry=False`` keeps those leaves zero-size
and every other leaf bit-identical to the ``True`` run.

``run_openloop`` feeds the tick from the device-side load generator
(``core/loadgen.py``): each tick's arrivals are drawn on the device,
admitted against lane capacity with a backlog, and counted in
``Metrics.offered``/``admission_drops``, with no host sync in the loop.

State is updated in place where the reference donated it: callers follow
``state = sim.tick(state, inj)`` and never reuse the state they passed.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import collectives as coll
from repro_torch.core import craq, netchain
from repro_torch.core import loadgen as loadgen_lib
from repro_torch.core import telemetry as telemetry_lib
from repro_torch.core import store as store_lib
from repro_torch.core import txn as txn_lib
from repro_torch.core.metrics import Metrics, ReplyLog
from repro_torch.core.store import Store
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.txn import LockTable, WaveState
from repro_torch.core.types import (
    CLIENT_BASE,
    I32,
    MULTICAST,
    NOWHERE,
    OP_ACK,
    OP_NOP,
    OP_PREPARE_ACK,
    OP_PREPARE_NACK,
    OP_READ,
    OP_READ_REPLY,
    OP_STALE_NACK,
    OP_TXN_REPLY,
    OP_WRITE,
    OP_WRITE_NACK,
    TO_CLIENT,
    WAVE_BASE,
    ChainConfig,
    ClusterConfig,
    Msg,
    PartitionMap,
    Roles,
    as_cluster,
    is_txn_op,
    resolve_device,
    tree_map,
)

NODE_STEPS: dict[str, Callable] = {
    "netcraq": craq.node_step,
    "netchain": netchain.node_step,
}


class SimState(NamedTuple):
    """The engine's state, field for field the reference's."""

    stores: Store        # [C, n, ...]
    inbox: Msg           # [C, n, c_route]
    locks: LockTable     # [C, K]
    metrics: Metrics     # [C]
    replies: ReplyLog    # [C, R]
    roles: Roles         # [C, n] (written only by the control plane)
    pmap: PartitionMap   # bucket->chain map (written only by the CP)
    wave: WaveState      # [C, W] 2PC coordinator slots (W == 0: untouched)
    telemetry: Telemetry  # [C] telemetry plane (zero-size when off)
    t: torch.Tensor      # [] int32 tick counter


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(I32)


def stale_route_admission(msg: Msg, slot_epoch: torch.Tensor,
                          slot_bucket: torch.Tensor, src_pos):
    """Partition-epoch admission per chain: ``msg`` [C, M] entry-stamped,
    ``slot_epoch``/``slot_bucket`` [C, K], ``src_pos`` the entry node per
    slot ([M] or [C, M]).  A client op whose map stamp predates the last
    move of its slot, or that targets a free or out-of-range slot, is
    consumed and NACK-redirected.  Returns ``(kept, nacks, n_stale [C])``.
    """
    K = slot_epoch.shape[1]
    sk = msg.key.long().clamp(0, K - 1)
    slot_current = (
        (msg.key >= 0) & (msg.key < K)
        & (msg.ver >= slot_epoch.gather(1, sk))
        & (slot_bucket.gather(1, sk) >= 0)
    )
    is_stale = (msg.op != OP_NOP) & (msg.src >= CLIENT_BASE) & ~slot_current
    src = torch.as_tensor(src_pos, dtype=I32, device=msg.op.device)
    nack = msg._replace(
        op=torch.where(is_stale, OP_STALE_NACK, OP_NOP),
        value=torch.zeros_like(msg.value),
        seq=torch.full_like(msg.seq, -1),
        src=torch.broadcast_to(src, msg.src.shape),
        dst=torch.where(is_stale, TO_CLIENT, NOWHERE),
    ).mask(is_stale)
    return msg.mask(~is_stale), nack, _i32(is_stale.sum(dim=1))


def full_roles_table(n_nodes: int, n_chains: int, device="cuda") -> Roles:
    """[C, n] role table with every physical slot live."""
    one = Roles.from_membership(n_nodes, range(n_nodes), device=device)
    return tree_map(lambda x: x[None].repeat((n_chains,) + (1,) * x.dim()),
                    one)


# ---------------------------------------------------------------------------
# Routing fabric
# ---------------------------------------------------------------------------
# Both fabrics deliver a flat per-chain [C, M] outbox: a live unicast
# message lands in its destination's inbox, a MULTICAST message in every
# live node's inbox except its sender's (copies carry their per-recipient
# hop cost in ``extra``), each inbox keeps flat-outbox order truncated to
# ``c_route`` slots, and per-node overflow is counted.  They return
# ``(routed [C, n, c_route], dropped [C, n], mcast_copies [C],
# mcast_hop_sum [C])`` with identical contents.  Sort keys and positions
# are int64 here, so no composite key can overflow.

def fabric_masks(flat: Msg, alive: torch.Tensor):
    """Classify a flat [C, M] outbox against ``alive`` [C, n]:
    (is_unicast, is_mcast, is_exit, dead_letters)."""
    n = alive.shape[1]
    live = flat.op != OP_NOP
    in_range = (flat.dst >= 0) & (flat.dst < n)
    dst_alive = alive.gather(1, flat.dst.long().clamp(0, n - 1))
    is_mcast = live & (flat.dst == MULTICAST)
    is_exit = live & (flat.dst == TO_CLIENT)
    is_unicast = live & in_range & dst_alive
    dead_letters = (live & in_range & ~dst_alive) | (
        live & ~in_range & ~is_mcast & ~is_exit
    )
    return is_unicast, is_mcast, is_exit, dead_letters


def _gather_msg(flat: Msg, idx: torch.Tensor) -> Msg:
    """Per-chain gather of every lane of a [C, M] Msg at ``idx`` [C, X]."""
    def g(x):
        if x.dim() == 2:
            return x.gather(1, idx)
        return x.gather(1, idx[..., None].expand(-1, -1, x.shape[2]))
    return tree_map(g, flat)


def dense_route(flat: Msg, alive: torch.Tensor, chain_pos: torch.Tensor,
                c_route: int):
    """The reference fabric: the full [C, n, M] delivery matrix, then a
    stable per-node compaction.  Kept as the oracle of
    ``segmented_route``."""
    C, M = flat.op.shape
    n = alive.shape[1]
    dev = flat.op.device
    is_unicast, is_mcast, _, _ = fabric_masks(flat, alive)
    node_ids = torch.arange(n, dtype=I32, device=dev)[None, :, None]
    deliver = (
        (is_unicast[:, None, :] & (flat.dst[:, None, :] == node_ids))
        | (is_mcast[:, None, :] & (flat.src[:, None, :] != node_ids))
    ) & alive[:, :, None]
    src_pos = chain_pos.gather(1, flat.src.long().clamp(0, n - 1))
    mcast_hops = (chain_pos[:, :, None] - src_pos[:, None, :]).abs()
    mcast_deliver = deliver & is_mcast[:, None, :]
    mcast_copies = _i32(mcast_deliver.sum(dim=(1, 2)))
    mcast_hop_sum = _i32(torch.where(mcast_deliver, mcast_hops, 0)
                         .sum(dim=(1, 2)))

    hop_add = torch.where(is_mcast[:, None, :], mcast_hops, 0)
    per_node = tree_map(
        lambda x: x[:, None].expand((C, n) + x.shape[1:]), flat)
    per_node = per_node._replace(
        extra=per_node.extra + hop_add).mask(deliver)
    order = torch.sort((~deliver).to(torch.uint8), dim=2,
                       stable=True).indices[:, :, :c_route]

    def take(x):
        if x.dim() == 3:
            return x.gather(2, order)
        return x.gather(2, order[..., None].expand(-1, -1, -1, x.shape[3]))

    routed = tree_map(take, per_node)
    dropped = _i32((deliver.sum(dim=2) - c_route).clamp(min=0))
    return routed, dropped, mcast_copies, mcast_hop_sum


def segmented_route(flat: Msg, alive: torch.Tensor, chain_pos: torch.Tensor,
                    c_route: int, mcast_lane: int | None = None):
    """The production fabric: one sort of the flat [C, M] outbox keyed by
    ``(destination segment, original index)`` puts each destination's
    deliveries contiguous and in flat order; unicast slots also count
    the multicast messages delivered ahead of them (searches against the
    multicast segment), and multicast copies come from a bounded
    ``mcast_lane`` slice of that segment (``c_route + M // n`` is exact
    when every message's ``src`` is its emitting node).  Every inbox slot
    then binary-searches its source.  Drop counts come from segment
    lengths, independent of the lane.
    """
    C, M = flat.op.shape
    n = alive.shape[1]
    L = M if mcast_lane is None else min(M, mcast_lane)
    dev = flat.op.device
    i64 = torch.int64
    is_unicast, is_mcast, _, _ = fabric_masks(flat, alive)
    idx = torch.arange(M, dtype=i64, device=dev)
    src = flat.src.long()
    ss = lambda seq, v: torch.searchsorted(seq, v.contiguous())

    # ---- the one sort: segment = dst | mcast(n) | sink(n+1) -------------
    seg = torch.where(is_unicast, flat.dst.long(),
                      torch.where(is_mcast, n, n + 1))
    skey = torch.sort(seg * M + idx, dim=1).values   # unique keys
    order = skey % M
    bounds = lambda m: (torch.arange(m, dtype=i64, device=dev) * M).expand(
        C, m)
    seg_start = ss(skey, bounds(n + 2))                # [C, n + 2]
    m_mc = seg_start[:, n + 1] - seg_start[:, n]       # [C]

    # ---- per-source multicast index (for the src != node exclusion) -----
    src_ok = (src >= 0) & (src < n)
    src_key = torch.sort(
        torch.where(is_mcast & src_ok, src * M + idx, n * M), dim=1).values
    src_start = ss(src_key, bounds(n + 1))             # [C, n + 1]

    mc_cum = torch.cumsum(is_mcast.long(), dim=1)

    def mc_before(f):
        return mc_cum.gather(1, f) - is_mcast.long().gather(1, f)

    def mc_src_before(i, f):
        return ss(src_key, i * M + f) - src_start.gather(1, i)

    def uni_before(i, f):
        return ss(skey, i * M + f) - seg_start.gather(1, i)

    # ---- unicast placement: slot of sorted entry j in its row ------------
    j = idx.expand(C, M)
    sdst = skey // M
    sidx = skey % M
    is_uni_j = sdst < n
    dc = sdst.clamp(0, n - 1)
    pos_u = (j - seg_start.gather(1, dc)) + mc_before(sidx) \
        - mc_src_before(dc, sidx)
    S = M + 1
    place_u = torch.where(is_uni_j, dc * S + pos_u.clamp(max=M), n * S)

    # ---- multicast placement: bounded lane, one copy per (node, entry) ---
    lane = torch.arange(L, dtype=i64, device=dev)
    p = (seg_start[:, n:n + 1] + lane).clamp(0, max(M - 1, 0))   # [C, L]
    lane_live = lane < m_mc[:, None]
    lane_idx = skey.gather(1, p) % M
    lane_src = src.gather(1, order.gather(1, p))
    rows = torch.arange(n, dtype=i64, device=dev)[None, :, None]  # [1, n, 1]
    deliver_m = (lane_live[:, None, :] & alive[:, :, None]
                 & (lane_src[:, None, :] != rows))                # [C, n, L]
    rows_f = rows.expand(C, n, L).reshape(C, n * L)
    idx_f = lane_idx[:, None, :].expand(C, n, L).reshape(C, n * L)
    pos_m = (uni_before(rows_f, idx_f) - mc_src_before(rows_f, idx_f)
             ).reshape(C, n, L) + lane
    # a suffix-min sweep fills skipped lane entries with the slot of their
    # next delivered successor (a searchable monotone array), remembering
    # which lane entry owns the slot
    big = M
    rev = lambda x: torch.flip(x, dims=(-1,))
    mono_m = rev(torch.cummin(rev(torch.where(
        deliver_m, pos_m.clamp(max=M), big)), dim=-1).values)
    next_del = rev(torch.cummin(rev(torch.where(
        deliver_m, lane, L)), dim=-1).values)
    place_m = (rows * S + mono_m).reshape(C, n * L)

    # ---- materialize: every inbox slot binary-searches its source --------
    slot_key = (torch.arange(n, dtype=i64, device=dev)[:, None] * S
                + torch.arange(c_route, dtype=i64, device=dev)[None, :]
                ).reshape(1, -1).expand(C, n * c_route)
    ju = ss(place_u, slot_key).clamp(0, M - 1)
    jm = ss(place_m, slot_key).clamp(0, n * L - 1)
    hit_u = place_u.gather(1, ju) == slot_key
    hit_m = place_m.gather(1, jm) == slot_key
    lane_of = next_del.reshape(C, n * L).gather(1, jm).clamp(0, L - 1)
    src_sorted_pos = torch.where(hit_u, ju, p.gather(1, lane_of))
    fidx = order.gather(1, src_sorted_pos)
    filled = hit_u | hit_m
    routed = _gather_msg(flat, fidx).mask(filled)
    routed = tree_map(
        lambda x: x.reshape((C, n, c_route) + x.shape[2:]), routed)
    # multicast copies accumulate their per-recipient hop cost
    copy_src_pos = chain_pos.gather(
        1, routed.src.long().clamp(0, n - 1).reshape(C, -1)
    ).reshape(C, n, c_route)
    copy_hop = (chain_pos[:, :, None] - copy_src_pos).abs()
    routed = routed._replace(extra=_i32(
        routed.extra + torch.where(routed.dst == MULTICAST, copy_hop, 0)))

    # ---- exact counters from segment lengths (lane-independent) ----------
    uni_cnt = seg_start[:, 1:n + 1] - seg_start[:, :n]            # [C, n]
    src_cnt = src_start[:, 1:n + 1] - src_start[:, :n]            # [C, n]
    deliver_cnt = uni_cnt + torch.where(alive, m_mc[:, None] - src_cnt, 0)
    dropped = _i32((deliver_cnt - c_route).clamp(min=0))

    n_alive = alive.long().sum(dim=1)
    src_alive = src_ok & alive.gather(1, src.clamp(0, n - 1))
    mcast_copies = _i32(torch.where(
        is_mcast, n_alive[:, None] - src_alive.long(), 0).sum(dim=1))
    # hop total per multicast message: sum over live recipients of
    # |chain_pos[i] - chain_pos[src]|
    hop_to_all = torch.where(
        alive[:, None, :],
        (chain_pos[:, None, :] - chain_pos[:, :, None]).abs(), 0,
    ).sum(dim=2)                                                  # [C, n]
    mcast_hop_sum = _i32(torch.where(
        is_mcast, hop_to_all.gather(1, src.clamp(0, n - 1)), 0).sum(dim=1))
    return routed, dropped, mcast_copies, mcast_hop_sum


def cluster_route(flat: Msg, target: torch.Tensor, n_chains: int,
                  cap: int):
    """Cluster-level router for coordinator traffic: deliver each live
    message of a flat ``[N]`` batch to the chain named by ``target``
    (``[N]``; outside ``[0, n_chains)`` drops it).  One sort of ``(target
    segment, index)`` puts each chain's deliveries contiguous and in flat
    order.  Returns ``(routed [n_chains, cap] Msg, overflow [n_chains])``:
    a chain's messages past ``cap`` are dropped and counted."""
    N = flat.op.shape[0]
    dev = flat.op.device
    i64 = torch.int64
    live = (flat.op != OP_NOP) & (target >= 0) & (target < n_chains)
    seg = torch.where(live, target.long(), n_chains)
    skey = torch.sort(seg * N + torch.arange(N, dtype=i64, device=dev)).values
    order = skey % N
    starts = torch.searchsorted(
        skey, torch.arange(n_chains + 1, dtype=i64, device=dev) * N)
    cnt = starts[1:] - starts[:-1]                               # [C]
    lane = torch.arange(cap, dtype=i64, device=dev)[None, :]
    gidx = order[(starts[:-1, None] + lane).clamp(0, max(N - 1, 0))]
    routed = tree_map(lambda x: x[gidx], flat).mask(lane < cnt[:, None])
    return routed, _i32((cnt - cap).clamp(min=0))


def pack_lanes(msgs: list[Msg]) -> Msg:
    """Concatenate [C, n, w_k] message lanes along the lane axis (the
    fabric's flat-index FIFO order follows this layout)."""
    return Msg.concat(msgs, dim=2)


class ChainSim:
    """Cluster simulator with exact traffic accounting.

    Accepts a ``ClusterConfig`` (C chains) or a bare ``ChainConfig``
    (one chain).  State is ``[C, n, ...]``; injections are ``[C, n,
    c_in]`` per tick and schedules ``[T, C, n, c_in]`` (legacy ``[n, q]``
    and ``[T, n, q]`` forms are lifted when C == 1).
    """

    def __init__(
        self,
        cfg: ChainConfig | ClusterConfig,
        inject_capacity: int = 64,
        route_capacity: int = 256,
        reply_capacity: int = 4096,
        fabric: str = "segmented",
        wave_depth: int = 0,
        wave_keys: int = 4,
        wave_log_capacity: int = 256,
        wave_route_capacity: int | None = None,
        telemetry: bool = True,
        hist_buckets: int = telemetry_lib.DEFAULT_HIST_BUCKETS,
        ring_window: int = 64,
        trace_slots: int = 16,
        trace_hops: int = 32,
        device="cuda",
    ):
        assert fabric in ("segmented", "dense"), fabric
        self.cluster = as_cluster(cfg)
        self.cfg = self.cluster.chain
        self.C = self.cluster.n_chains
        self.n = self.cfg.n_nodes
        self.c_in = inject_capacity
        self.c_route = route_capacity
        self.reply_capacity = reply_capacity
        # the in-network 2PC coordinator: W slots of KT participants per
        # chain; a chain's slots have at most W * KT sub-ops out, one reply
        # each, and the worst case sends every chain's to one chain
        self.wave_depth = wave_depth
        self.wave_keys = wave_keys
        self.wave_log_capacity = wave_log_capacity
        self.coord_capacity = max(wave_depth * wave_keys, 1)
        self.wave_sub_capacity = (
            wave_route_capacity if wave_route_capacity is not None
            else max(self.C * wave_depth * wave_keys, 1))
        # the telemetry plane: off, every leaf is zero-size
        self.telemetry = bool(telemetry)
        if self.telemetry:
            assert hist_buckets >= 2 and ring_window >= 1
            assert trace_slots >= 1 and trace_hops >= 1
        self.hist_buckets = hist_buckets if self.telemetry else 0
        self.ring_window = ring_window if self.telemetry else 0
        self.trace_slots = trace_slots if self.telemetry else 0
        self.trace_hops = trace_hops if self.telemetry else 0
        self.fabric = fabric
        self.device = resolve_device(device)
        self.node_step = NODE_STEPS[self.cfg.protocol]

    # -- state ------------------------------------------------------------
    def init_state(self) -> SimState:
        C, n, dev = self.C, self.n, self.device
        return SimState(
            stores=store_lib.init_store(self.cfg, (C, n), device=dev),
            inbox=Msg.empty((C, n, self.c_route), self.cfg.value_words,
                            device=dev),
            locks=txn_lib.init_locks(self.cfg, C, device=dev),
            metrics=Metrics.zeros(C, self.cluster.num_buckets, device=dev),
            replies=ReplyLog.empty(self.reply_capacity, C, device=dev),
            roles=full_roles_table(n, C, device=dev),
            pmap=self.cluster.default_partition(device=dev),
            wave=WaveState.empty(
                self.wave_depth, self.wave_keys, self.wave_log_capacity,
                self.coord_capacity, self.cfg.value_words, C, device=dev),
            telemetry=Telemetry.empty(
                self.hist_buckets, self.ring_window, self.trace_slots,
                self.trace_hops, C, device=dev),
            t=torch.zeros((), dtype=I32, device=dev),
        )

    def empty_injection(self) -> Msg:
        """All-NOP [C, n, c_in] injection (the canonical drain tick)."""
        return Msg.empty((self.C, self.n, self.c_in), self.cfg.value_words,
                         device=self.device)

    # -- one tick of every chain at once ----------------------------------
    def _chain_tick(self, stores: Store, inbox: Msg, locks: LockTable,
                    metrics: Metrics, replies: ReplyLog, injected: Msg,
                    roles: Roles, pmap: PartitionMap, t: torch.Tensor,
                    sub_in: Msg | None = None,
                    wave_final: Msg | None = None,
                    tel: Telemetry | None = None):
        """The reference's per-chain tick with the chain axis written
        out: stores [C, n, ...], inbox [C, n, c_route], injected
        [C, n, c_in], roles [C, n].  Returns (stores', inbox', locks',
        metrics', replies').

        With a wave table two lanes more ride the tick: ``sub_in`` [C,
        Xs], the coordinator sub-ops the cluster router delivered to each
        chain (they enter at the live head like client transaction
        traffic), and ``wave_final`` [C, W], each coordinator's final
        client replies (they exit from the head).  The return then grows
        ``ctrl_out`` [C, M]: the exits addressed back at a coordinator
        (``client >= WAVE_BASE``), diverted from the reply log.

        With the telemetry plane on, ``tel`` rides the tick and comes
        back last: the latency histogram takes the exit batch the reply
        log appends, the traces the arrival batch before admission (the
        ring row is written in ``tick``)."""
        C, n, cfg = self.C, self.n, self.cfg
        dev = inbox.op.device
        dense = self.fabric == "dense"
        alive = roles.alive                                  # [C, n]
        chain_pos = roles.chain_pos                          # [C, n]
        node_ids = torch.arange(n, dtype=I32, device=dev)

        # Stamp entry position on client queries; black-hole the lanes of
        # dead nodes (counted as drops before any packet accounting).
        injected = craq.stamp_entry(injected, node_ids[None, :, None])
        dead_in = _i32(
            ((injected.op != OP_NOP) & ~alive[..., None]).sum(dim=(1, 2))
            + ((inbox.op != OP_NOP) & ~alive[..., None]).sum(dim=(1, 2)))
        alive_lane = lambda m: alive[..., None].expand_as(m.op)
        injected = injected.mask(alive_lane(injected))
        inbox = inbox.mask(alive_lane(inbox))
        inj_live = injected.op != OP_NOP
        injected = injected._replace(extra=_i32(injected.extra + inj_live))
        n_injected = _i32(inj_live.sum(dim=(1, 2)))
        lanes = [injected, inbox]
        if self.wave_depth:
            # coordinator sub-ops enter at the live head, entry-stamped and
            # leg-accounted like a client query
            head = roles.head_pos[:, 0:1]                        # [C, 1]
            sub_live = sub_in.op != OP_NOP
            n_wave_in = _i32(sub_live.sum(dim=1))
            sub_in = sub_in._replace(
                entry=torch.where(sub_live, head, sub_in.entry),
                extra=_i32(sub_in.extra + sub_live))
            at_head = node_ids[None, :, None] == head[:, :, None]  # [C, n, 1]
            lanes.append(tree_map(
                lambda x: x[:, None].expand((C, n) + x.shape[1:]),
                sub_in).mask(at_head.expand(C, n, sub_in.op.shape[1])))
        full_inbox = pack_lanes(lanes)
        live_in = full_inbox.op != OP_NOP

        # Stale-route admission, before the lock stage or the store.
        cap_total = full_inbox.op.shape[2]
        flat_in = tree_map(
            lambda x: x.reshape((C, n * cap_total) + x.shape[3:]), full_inbox)
        node_of_in = node_ids.repeat_interleave(cap_total)
        kept, stale_out, n_stale = stale_route_admission(
            flat_in, pmap.slot_epoch, pmap.slot_bucket, node_of_in)
        lift_in = lambda m: tree_map(
            lambda x: x.reshape((C, n, cap_total) + x.shape[2:]), m)
        full_inbox = lift_in(kept)
        stale_out = lift_in(stale_out)

        # Lease expiry BEFORE the lock stage, then the head's lock stage.
        locks, n_expired = txn_lib.lease_expiry_stage(locks, t)
        new_locks, full_inbox, txn_out, txn_counts = txn_lib.head_txn_stage(
            locks, roles, stores, full_inbox, t=t, dense_rank=dense)

        # The match-action pass on every node of every chain at once.
        pending_before = stores.pending.sum(dim=(1, 2))
        flat_nodes = lambda x: x.reshape((C * n,) + x.shape[2:])
        node_store, outbox = self.node_step(
            cfg, tree_map(flat_nodes, stores), tree_map(flat_nodes, roles),
            tree_map(flat_nodes, full_inbox), dense_rank=dense)
        new_stores = tree_map(
            lambda x: x.reshape((C, n) + x.shape[1:]), node_store)
        outbox = tree_map(
            lambda x: x.reshape((C, n) + x.shape[1:]), outbox)
        out_lanes = [outbox, txn_out, stale_out]
        if self.wave_depth:
            # the coordinators' final client replies exit from the head
            wf_live = wave_final.op != OP_NOP
            wave_final = wave_final._replace(
                src=torch.where(wf_live, head, wave_final.src))
            out_lanes.append(tree_map(
                lambda x: x[:, None].expand((C, n) + x.shape[1:]),
                wave_final).mask(at_head.expand(C, n,
                                                wave_final.op.shape[1])))
        outbox = pack_lanes(out_lanes)
        # A dead node emits nothing.
        outbox = outbox.mask(alive_lane(outbox))

        # ---------------- routing fabric ----------------
        flat = tree_map(lambda x: x.reshape((C, -1) + x.shape[3:]), outbox)
        is_unicast, is_mcast, is_exit, dead_letters = fabric_masks(
            flat, alive)
        pos_of = lambda i: chain_pos.gather(1, i.long().clamp(0, n - 1))
        uni_hops = (pos_of(flat.dst) - pos_of(flat.src)).abs()
        flat = flat._replace(extra=_i32(
            flat.extra + torch.where(is_unicast, uni_hops, 0) + is_exit))
        M = flat.op.shape[1]
        if dense:
            routed, dropped, mcast_copies, mcast_hop_sum = dense_route(
                flat, alive, chain_pos, self.c_route)
        else:
            routed, dropped, mcast_copies, mcast_hop_sum = segmented_route(
                flat, alive, chain_pos, self.c_route,
                mcast_lane=self.c_route + M // n)

        n_exit = is_exit.sum(dim=1)
        packets = _i32(
            torch.where(is_unicast, uni_hops, 0).sum(dim=1)
            + mcast_hop_sum + n_exit + n_injected)
        msgs = _i32(is_unicast.sum(dim=1) + mcast_copies + n_exit
                    + n_injected)
        if self.wave_depth:
            # the coordinator -> head leg of every wave sub-op
            packets = packets + n_wave_in
            msgs = msgs + n_wave_in
        msg_bytes = cfg.header_bytes + cfg.payload_bytes

        # ---------------- exits -> reply log ----------------
        # exits addressed back at a coordinator are its 2PC control
        # replies: diverted to the cluster control router, never logged
        if self.wave_depth:
            wave_bound = is_exit & (flat.client >= WAVE_BASE)
            ctrl_out = flat.mask(wave_bound)
            is_exit = is_exit & ~wave_bound
        exits = flat.mask(is_exit)
        is_nack = exits.op == OP_WRITE_NACK
        is_ctrl = (
            (exits.op == OP_PREPARE_ACK)
            | (exits.op == OP_PREPARE_NACK)
            | (exits.op == OP_STALE_NACK)
            | ((exits.op == OP_TXN_REPLY) & (exits.seq < 0))
        )
        new_replies = replies.append(exits, t + 1, dense=dense)

        if self.telemetry:
            tel = tel._replace(lat_hist=telemetry_lib.record_latency(
                tel.lat_hist, exits.op, exits.seq, t + 1 - exits.t_inject))
            tel = telemetry_lib.record_trace(tel, flat_in.op, flat_in.qid,
                                             node_of_in, t)

        # Per-bucket conflict heat: every PREPARE the lock stage denied,
        # counted on the bucket owning the contended slot (padding column
        # for denied keys on free slots).
        G = metrics.conflict_heat.shape[1]
        K = pmap.slot_bucket.shape[1]
        tko = txn_out.op.reshape(C, -1)
        tkk = txn_out.key.reshape(C, -1)
        bi = pmap.slot_bucket.gather(1, tkk.long().clamp(0, K - 1))
        is_cnack = (tko == OP_PREPARE_NACK) & (bi >= 0)
        heat = torch.cat([metrics.conflict_heat,
                          metrics.conflict_heat.new_zeros((C, 1))], dim=1)
        heat.scatter_add_(1, torch.where(is_cnack, bi, G).long(),
                          torch.ones_like(tko))
        new_heat = heat[:, :G]

        s = lambda x: x.sum(dim=1)
        new_metrics = Metrics(
            packets=metrics.packets + packets,
            msgs=metrics.msgs + msgs,
            bytes=metrics.bytes + packets * msg_bytes,
            kv_procs=metrics.kv_procs + _i32(live_in.sum(dim=(1, 2))),
            reads_in=metrics.reads_in
            + _i32((injected.op == OP_READ).sum(dim=(1, 2))),
            writes_in=metrics.writes_in
            + _i32((injected.op == OP_WRITE).sum(dim=(1, 2))),
            acks=metrics.acks + _i32(s(flat.op == OP_ACK)),
            replies=metrics.replies
            + _i32(s(exits.live() & ~is_nack & ~is_ctrl)),
            dirty_appends=metrics.dirty_appends + _i32(
                (new_stores.pending.sum(dim=(1, 2)) - pending_before)
                .clamp(min=0)),
            fwd_reads=metrics.fwd_reads
            + _i32(s(is_unicast & (flat.op == OP_READ))),
            drops=metrics.drops + _i32(s(dropped) + dead_in
                                       + s(dead_letters)),
            relay_procs=metrics.relay_procs + _i32(
                (live_in & (full_inbox.op == OP_READ_REPLY)).sum(dim=(1, 2))),
            write_nacks=metrics.write_nacks + _i32(s(is_nack)),
            txn_commits=metrics.txn_commits + txn_counts[0],
            txn_aborts=metrics.txn_aborts + txn_counts[1],
            lock_conflicts=metrics.lock_conflicts + txn_counts[2],
            stale_routes=metrics.stale_routes + n_stale,
            migration_moves=metrics.migration_moves,
            wave_commits=metrics.wave_commits,
            wave_aborts=metrics.wave_aborts,
            wave_occupancy=metrics.wave_occupancy,
            offered=metrics.offered,
            admission_drops=metrics.admission_drops,
            lease_expiries=metrics.lease_expiries + n_expired,
            conflict_heat=new_heat,
        )
        out = (new_stores, routed, new_locks, new_metrics, new_replies)
        if self.wave_depth:
            out += (ctrl_out,)
        return out + (tel,) if self.telemetry else out

    def _lift(self, injected: Msg) -> Msg:
        """Accept legacy single-chain [n, q] injections when C == 1."""
        if injected.op.dim() == 2:
            assert self.C == 1, (
                f"injection lacks the chain axis but cluster has C={self.C}")
            return tree_map(lambda x: x[None], injected)
        return injected

    def tick(self, state: SimState, injected: Msg) -> SimState:
        """Advance every chain one tick.  ``injected``: [C, n, c_in] client
        queries addressed to their entry node.  The input state may be
        updated in place: rebind ``state = sim.tick(state, inj)``."""
        injected = tree_map(lambda x: x.to(self.device), self._lift(injected))
        args = (state.stores, state.inbox, state.locks, state.metrics,
                state.replies, injected, state.roles, state.pmap, state.t)
        tel = state.telemetry if self.telemetry else None
        if not self.wave_depth:
            outs = self._chain_tick(*args, tel=tel)
            stores, inbox, locks, metrics, replies = outs[:5]
            wave = state.wave
        else:
            # ---- the in-network coordinator stage, before the chains:
            # last tick's control replies in, this tick's sub-ops and final
            # client replies out (slots past the lease force-abort)
            C = self.C
            wave, sub_out, sub_target, final_out, wstats = \
                txn_lib.wave_coordinator_step(state.wave, state.t,
                                              state.locks.lease_ticks)
            # sub-ops cross chains to each key's owner
            flat_sub = tree_map(
                lambda x: x.reshape((-1,) + x.shape[2:]), sub_out)
            sub_in, sub_drop = cluster_route(
                flat_sub, sub_target.reshape(-1), C, self.wave_sub_capacity)
            outs = self._chain_tick(*args, sub_in, final_out, tel=tel)
            stores, inbox, locks, metrics, replies, ctrl_out = outs[:6]
            # control replies ride back to their coordinator's chain:
            # client = WAVE_BASE + chain * W + slot
            flat_ctrl = tree_map(
                lambda x: x.reshape((-1,) + x.shape[2:]), ctrl_out)
            ctrl_tgt = torch.where(
                flat_ctrl.op != OP_NOP,
                torch.div(flat_ctrl.client - WAVE_BASE, self.wave_depth,
                          rounding_mode="floor"), -1)
            coord_in, ctrl_drop = cluster_route(
                flat_ctrl, ctrl_tgt, C, self.coord_capacity)
            wave = wave._replace(coord_in=coord_in)
            metrics = metrics._replace(
                drops=metrics.drops + sub_drop + ctrl_drop,
                wave_commits=metrics.wave_commits + wstats[0],
                wave_aborts=metrics.wave_aborts + wstats[1],
                wave_occupancy=metrics.wave_occupancy + wstats[2])
        tel = state.telemetry
        if self.telemetry:
            # one flight-recorder row per chain: this tick's counter deltas
            # and the end-of-tick gauges of the routed inbox
            live = (inbox.op != OP_NOP).sum(dim=2)               # [C, n]
            delta = lambda f: getattr(metrics, f) - getattr(state.metrics, f)
            occupancy = (wstats[2] if self.wave_depth
                         else torch.zeros_like(state.metrics.drops))
            row = torch.stack([_i32(x) for x in (
                state.t.expand(self.C), live.sum(dim=1),
                live.amax(dim=1), delta("drops"), delta("lock_conflicts"),
                occupancy, delta("replies"), delta("stale_routes"),
            )], dim=1)
            tel = telemetry_lib.record_ring(outs[-1], row)
        return SimState(
            stores=stores,
            inbox=inbox,
            locks=locks,
            metrics=metrics,
            replies=replies,
            roles=state.roles,
            pmap=state.pmap,
            wave=wave,
            telemetry=tel,
            t=state.t + 1,
        )

    # -- run a schedule -----------------------------------------------------
    def drain(self, state: SimState, ticks: int) -> SimState:
        """Tick ``ticks`` empty injections."""
        empty = self.empty_injection()
        for _ in range(ticks):
            state = self.tick(state, empty)
        return state

    def run(self, state: SimState, schedule: Msg, extra_ticks: int = 16,
            assert_drained: bool = False) -> SimState:
        """schedule: [T, C, n, c_in] (or legacy [T, n, c_in]) injection
        per tick; then drain ``extra_ticks``.  ``assert_drained=True``
        raises if any op is still in flight afterwards."""
        if schedule.op.dim() == 3:
            assert self.C == 1, (
                f"schedule lacks the chain axis but cluster has C={self.C}")
            schedule = tree_map(lambda x: x[:, None], schedule)
        schedule = tree_map(lambda x: x.to(self.device), schedule)
        for i in range(schedule.op.shape[0]):
            state = self.tick(state, tree_map(lambda x: x[i], schedule))
        return self._drain_after(state, extra_ticks, assert_drained)

    def _drain_after(self, state: SimState, extra_ticks: int,
                     assert_drained: bool) -> SimState:
        """Drain ``extra_ticks``; with ``assert_drained``, raise if any op
        is still in flight afterwards."""
        if extra_ticks:
            state = self.drain(state, extra_ticks)
        if assert_drained:
            left = self.inflight(state)
            assert left == 0, (
                f"{left} ops still in flight after extra_ticks="
                f"{extra_ticks} drain - size the drain window up or the "
                "run's throughput/latency accounting is short")
        return state

    def run_openloop(self, state: SimState, gen, ticks: int,
                     arrival_width: int | None = None,
                     extra_ticks: int = 16,
                     assert_drained: bool = False):
        """Open-loop run: ``ticks`` ticks of device-side arrival
        generation (``loadgen.gen_tick``) and tick, then an
        ``extra_ticks`` drain.  Arrivals beyond lane capacity defer into
        the generator's backlog and are shed, counted in
        ``Metrics.admission_drops``, only past its capacity.  The loop
        reads nothing back to the host.

        ``arrival_width`` is the fresh-candidate lane count per tick
        (default ``C * n * c_in``); the same width again carries the
        follow-up COMMITs.  Returns ``(state, gen)``: rebind both (the
        state is updated in place, as ``tick``'s)."""
        if arrival_width is None:
            arrival_width = self.C * self.n * self.c_in
        gen = tree_map(lambda x: x.to(self.device), gen)
        for _ in range(ticks):
            inj, gen, offered, shed = loadgen_lib.gen_tick(
                gen, self.cluster, arrival_width, self.c_in, state.t)
            state = state._replace(metrics=state.metrics._replace(
                offered=state.metrics.offered + offered,
                admission_drops=state.metrics.admission_drops + shed))
            state = self.tick(state, inj)
        return self._drain_after(state, extra_ticks, assert_drained), gen

    def inflight(self, state: SimState) -> int:
        """Host-side count of ops still inside the engine: live inbox
        slots plus, with a wave table, occupied coordinator slots and
        buffered control replies."""
        n = int((state.inbox.op != OP_NOP).sum())
        if self.wave_depth:
            n += int((state.wave.phase != txn_lib.WAVE_FREE).sum())
            n += int((state.wave.coord_in.op != OP_NOP).sum())
        return n


# ---------------------------------------------------------------------------
# Distributed engine: one chain node per rank (torch.distributed)
# ---------------------------------------------------------------------------
_ROLE_INTS = ("my_pos", "head_pos", "tail_pos", "n_nodes", "next_pos",
              "prev_pos", "chain_pos")


def _pack_roles(roles: Roles, width: int) -> torch.Tensor:
    """A ``[1]``-leaf role row as one int32 ``[1, width]`` row (the
    booleans as 0/1, zero padding on the right)."""
    row = torch.stack([_i32(getattr(roles, f)[0]) for f in Roles._fields])
    return torch.cat([row, row.new_zeros(width - row.shape[0])])[None]


def _unpack_roles(rows: torch.Tensor) -> Roles:
    """``[m, width]`` packed rows back to a ``Roles`` of ``[m]`` leaves."""
    cols = {f: rows[:, i] for i, f in enumerate(Roles._fields)}
    return Roles(**{f: (cols[f] if f in _ROLE_INTS else cols[f] != 0)
                    for f in Roles._fields})


class ChainDist:
    """One chain node per rank: the port of the reference's production
    engine (``ChainDist`` under ``shard_map``), on ``torch.distributed``.

    Rank ``r`` holds node ``r % n`` of chain group ``r // n``
    (``core/collectives.py``).  With ``group_axis=True`` the world is
    one cluster of C chains side by side (``world == C * n``, rank ``r``
    on chain ``r // n``); ungrouped, a single chain (C == 1) of
    ``world == n`` ranks.  The exchanges name only the chain group, so
    chains exchange nothing.

    ``make_step(B)`` returns the step on this rank's local shards with
    the reference's contract: ``step(stores, inbox, roles, pmap, locks[,
    tel]) -> (stores', inbox', replies, locks'[, tel'])``, every per-node
    leaf with a leading ``[1]`` (``[1, 1]`` grouped), the partition map
    with this chain's ``[1, K]`` slot rows and the lock shard ``[1, K]``.
    A step runs the reference's stages in order: mask to the alive set
    and entry stamping; stale-route admission; the head lock stage,
    replicated: every rank re-derives the same lock transition from the
    gathered transaction batch and role row (one ``all_gather``) and
    keeps its own row; the node step (on a card one ``kv_read`` and,
    NetCRAQ, one ``kv_write`` launch); write-forward traffic one hop
    toward the tail (``ppermute_next``); dirty-read fetches and the
    ACK multicast through one masked ``all_gather``; each lane set
    compacted to ``B`` (a stable sort, truncating silently past ``B``,
    as the reference's).  Every exchange moves one packed int32 tensor.
    The stores and the telemetry histogram are edited in place: rebind
    the returned ones.  ``shard``/``local_pmap`` cut a global view to
    this rank's shards; ``gather``/``gather_rows`` put
    the global ``[n, ...]`` (``[C, n, ...]``) or ``[C, ...]`` view
    together on every rank.
    """

    def __init__(self, cfg: ChainConfig | ClusterConfig, *, rank: int,
                 world: int, group_axis: bool = False, device=None):
        self.cluster = as_cluster(cfg)
        self.cfg = self.cluster.chain
        self.n = self.cfg.n_nodes
        self.C = self.cluster.n_chains
        self.grouped = bool(group_axis)
        if self.grouped:
            assert world == self.C * self.n, (
                f"a grouped ChainDist of {self.C} chains of {self.n} nodes "
                f"needs {self.C * self.n} ranks, not {world}")
        else:
            assert self.C == 1, (
                "multi-chain ChainDist needs group_axis=True")
            assert world == self.n, (
                f"an ungrouped ChainDist of {self.n} nodes needs {self.n} "
                f"ranks, not {world}")
        assert 0 <= rank < world
        self.rank, self.world = rank, world
        self.group = coll.chain_group(self.n)
        assert self.group.ranks[self.group.pos] == rank, (
            f"rank {rank} is not this process's rank")
        self.pos = self.group.pos
        self.chain = self.group.index if self.grouped else 0
        self.lead = (1, 1) if self.grouped else (1,)
        self.device = resolve_device(
            device if device is not None
            else coll.rank_device(rank, "cuda"))
        self.node_step = NODE_STEPS[self.cfg.protocol]

    # -- global views <-> this rank's shards ------------------------------
    def shard(self, tree):
        """This rank's shard of a per-node tree (``[n, ...]`` leaves, or
        ``[C, n, ...]`` grouped), on the engine's device."""
        if self.grouped:
            cut = lambda x: x[self.chain:self.chain + 1,
                              self.pos:self.pos + 1]
        else:
            cut = lambda x: x[self.pos:self.pos + 1]
        return tree_map(lambda x: cut(x).to(self.device), tree)

    def local_pmap(self, pmap: PartitionMap) -> PartitionMap:
        """A global partition map with this chain's ``[1, K]`` slot rows."""
        dev = self.device
        row = lambda x: x[self.chain:self.chain + 1].to(dev)
        return PartitionMap(
            owner=pmap.owner.to(dev), base=pmap.base.to(dev),
            epoch=pmap.epoch.to(dev), slot_bucket=row(pmap.slot_bucket),
            slot_epoch=row(pmap.slot_epoch))

    def gather(self, tree):
        """The global per-node view of local shards, on every rank (a
        collective: every rank of the world calls it)."""
        if self.grouped:
            grp = coll.world_group()
            shape = lambda x: (self.C, self.n) + x.shape[2:]
        else:
            grp = self.group
            shape = lambda x: (self.n,) + x.shape[1:]
        return tree_map(
            lambda x: coll.all_gather_tiled(x.reshape(
                (1,) + x.shape[len(self.lead):]), grp).reshape(shape(x)),
            tree)

    def gather_rows(self, tree):
        """The global ``[C, ...]`` view of per-chain rows (the lock shard),
        taken from each chain's position 0, on every rank."""
        if not self.grouped:
            return tree
        grp = coll.world_group()
        return tree_map(
            lambda x: coll.all_gather_tiled(x, grp)[::self.n], tree)

    # -- state ------------------------------------------------------------
    def init_state(self) -> Store:
        """This rank's node store: ``[1, K, ...]`` (``[1, 1, K, ...]``
        grouped)."""
        return store_lib.init_store(self.cfg, self.lead, device=self.device)

    def init_locks(self) -> LockTable:
        """This chain's all-free ``[1, K]`` lock shard."""
        return txn_lib.init_locks(self.cfg, 1, device=self.device)

    def full_roles(self) -> Roles:
        """This rank's row of the all-slots-live role table.  Cut the
        control plane's ``Coordinator.roles_table()`` with ``shard`` to
        run under edited membership."""
        dev = self.device
        if self.grouped:
            return self.shard(full_roles_table(self.n, self.C, device=dev))
        return self.shard(Roles.from_membership(self.n, range(self.n),
                                                device=dev))

    def default_pmap(self) -> PartitionMap:
        """The epoch-0 partition map with this chain's slot rows."""
        return self.local_pmap(self.cluster.default_partition(
            device=self.device))

    def init_telemetry(
        self, hist_buckets: int = telemetry_lib.DEFAULT_HIST_BUCKETS
    ) -> Telemetry:
        """This rank's telemetry shard for ``make_step(...,
        telemetry=True)``: its exit-latency histogram ``[1, OPCLASS,
        BKT]`` and its step clock in the ``ring_cursor`` lane; the ring
        and trace leaves are zero-size, as the reference's."""
        z = lambda *s: torch.zeros(self.lead + s, dtype=I32,
                                   device=self.device)
        return Telemetry(
            lat_hist=z(telemetry_lib.N_OPCLASS, hist_buckets),
            ring=z(0, telemetry_lib.N_RING_FIELDS),
            ring_cursor=z(),
            trace_qid=z(0),
            trace_node=z(0, 0),
            trace_tick=z(0, 0),
            trace_op=z(0, 0),
            trace_len=z(0),
        )

    @staticmethod
    def _compact(msg: Msg, cap: int) -> Msg:
        """Keep live lanes first (stable), truncate to ``cap`` lanes."""
        order = torch.sort((msg.op == OP_NOP).to(torch.uint8), dim=1,
                           stable=True).indices[:, :cap]
        return _gather_msg(msg, order)

    # -- the step ---------------------------------------------------------
    def make_step(self, batch_per_node: int, telemetry: bool = False):
        cfg, n, grp, B = self.cfg, self.n, self.group, batch_per_node
        node_step = self.node_step
        k = len(self.lead)
        unshard = lambda x: x.reshape((1,) + x.shape[k:])
        reshard = lambda x: x.reshape(self.lead + x.shape[1:])

        def step(stores: Store, inbox: Msg, roles: Roles,
                 pmap: PartitionMap, locks: LockTable, tel=None):
            my_roles: Roles = tree_map(unshard, roles)             # [1]
            my_pos = my_roles.my_pos
            local_store: Store = tree_map(unshard, stores)         # [1, K..]
            local_in: Msg = tree_map(unshard, inbox)               # [1, B]
            alive = my_roles.alive[:, None]
            # a dead rank receives nothing and processes nothing
            local_in = local_in.mask(alive.expand_as(local_in.op))
            local_in = craq.stamp_entry(local_in, my_pos[:, None])

            # stale-route admission against this chain's slot rows
            local_in, stale_out, _ = stale_route_admission(
                local_in, pmap.slot_epoch, pmap.slot_bucket, my_pos)

            # ---- head lock stage, replicated: the chain's transaction
            # candidates and role rows gathered in one exchange; every
            # rank derives the same transition and keeps its own row
            cand = (is_txn_op(local_in.op)
                    & (local_in.src >= CLIENT_BASE))               # [1, B]
            feed = coll.pack_msg(local_in.mask(cand))              # [B, w]
            lanes = B + 1
            gathered = coll.all_gather_tiled(
                torch.cat([feed, _pack_roles(my_roles, feed.shape[1])]),
                grp).reshape(n, lanes, -1)
            txn_all = coll.unpack_msg(
                gathered[:, :B].reshape(n * B, -1), (1, n, B))
            roles_all = tree_map(lambda x: x[None],
                                 _unpack_roles(gathered[:, B]))    # [1, n]
            # only the head row's replies read the store: the local
            # store, expanded (not copied) over the chain's n rows
            bstore = tree_map(
                lambda x: x[:, None].expand((1, n) + x.shape[1:]),
                local_store)
            new_locks, passed_all, rep_all, _ = txn_lib.head_txn_stage(
                locks, roles_all, bstore, txn_all)
            mine = my_pos.long()
            passed_me = tree_map(lambda x: x[:, mine][:, 0], passed_all)
            rep_me = tree_map(lambda x: x[:, mine][:, 0], rep_all)
            local_in = tree_map(
                lambda a, b: torch.where(
                    cand.reshape(cand.shape + (1,) * (a.dim() - 2)), b, a),
                local_in, passed_me)

            new_store, outbox = node_step(cfg, local_store, my_roles,
                                          local_in)
            # ... and emits nothing
            outbox = outbox.mask(alive.expand_as(outbox.op))

            # ---- next-hop traffic: one hop toward the tail (only for the
            # physical ring neighbour; a skip over a dead rank rides the
            # fabric below).  Position 0 receives ppermute's zeros.
            M = outbox.op.shape[1]
            to_next = outbox.mask(outbox.dst == my_pos[:, None] + 1)
            from_prev = coll.unpack_msg(
                coll.ppermute_next(coll.pack_msg(to_next), grp), (1, M))

            # ---- fabric traffic: dirty-read fetches + multicast ACKs
            fabric = outbox.mask(
                (outbox.dst == MULTICAST)
                | ((outbox.dst >= 0) & (outbox.dst != my_pos[:, None] + 1)))
            all_fab = coll.unpack_msg(
                coll.all_gather_tiled(coll.pack_msg(fabric), grp),
                (1, n * M))
            take = ((all_fab.dst == my_pos[:, None])
                    | ((all_fab.dst == MULTICAST)
                       & (all_fab.src != my_pos[:, None]))) & alive
            from_fabric = all_fab.mask(take)

            replies = self._compact(Msg.concat([
                outbox.mask(outbox.dst == TO_CLIENT), stale_out, rep_me,
            ], dim=1), B)
            next_inbox = self._compact(
                Msg.concat([from_prev, from_fabric], dim=1), B)
            out = [tree_map(reshard, new_store),
                   tree_map(reshard, next_inbox),
                   tree_map(reshard, replies),
                   new_locks]
            if telemetry:
                # this rank's own reply batch into its histogram; the
                # ring_cursor lane is the rank's step clock, so ticks in
                # flight = clock + 1 - t_inject
                my_tel: Telemetry = tree_map(unshard, tel)
                clock = my_tel.ring_cursor                           # [1]
                my_tel = my_tel._replace(
                    lat_hist=telemetry_lib.record_latency(
                        my_tel.lat_hist, replies.op, replies.seq,
                        clock[:, None] + 1 - replies.t_inject),
                    ring_cursor=_i32(clock + 1))
                out.append(tree_map(reshard, my_tel))
            return tuple(out)

        return step
