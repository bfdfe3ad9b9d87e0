"""Workload generation - the port of ``repro/core/workload.py``.

``make_schedule`` builds ``[T, C, n, q]`` injection lanes of client
queries for keys owned by each lane's chain (writes at the head, reads
spread over the nodes); ``route_stream`` packs a flat global-key stream
into the same lanes through the partition map; ``make_txn_workload``
draws multi-key transactions with numpy's ``default_rng``, as the
reference does, so one configuration gives the reference's transactions
exactly.

Schedules draw with the port's threefry (``core/prng.py``), from
``PRNGKey(WorkloadConfig.seed)`` split into key, op and value keys in the
reference's order, on the target device: threefry is integer arithmetic,
so every device gives the reference's bits.  Uniform schedules equal the
reference's bit for bit.  Zipf keys come from the inverse of a float32
CDF built on the host in the order XLA's CPU backend computes the
reference's (``zipf_cdf_f32``); only its powers are float64 rounded to
float32, where XLA evaluates its own float32 ``pow``.  A zipf key can
differ only where the uniform draw falls between the two CDFs at a key
boundary.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.types import (
    CLIENT_BASE,
    I32,
    NOWHERE,
    OP_NOP,
    OP_READ,
    OP_WRITE,
    ChainConfig,
    ClusterConfig,
    Msg,
    as_cluster,
    is_txn_op,
    resolve_device,
    tree_map,
)


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    ticks: int = 32
    queries_per_tick: int = 32      # per entry node (per chain)
    write_fraction: float = 0.0
    entry_node: int | None = None   # None = spread uniformly over nodes
    key_skew: str = "uniform"       # "uniform" | "zipf"
    zipf_a: float = 1.2
    seed: int = 0


def _prefix_rows(x: np.ndarray) -> np.ndarray:
    """Inclusive float32 prefix sums along the last axis, left to
    right."""
    out = np.empty_like(x)
    acc = np.zeros(x.shape[:-1], np.float32)
    for j in range(x.shape[-1]):
        acc = (acc + x[..., j]).astype(np.float32)
        out[..., j] = acc
    return out


def _xla_sum(x: np.ndarray, window: int = 32) -> np.float32:
    """A float32 sum in XLA's CPU order: windows of 32 summed left to
    right, over zeros padded half before and half after, level by level
    until one window is left."""
    while x.shape[0] > window:
        n = x.shape[0]
        m = -(-n // window)
        pad = m * window - n
        padded = np.zeros(m * window, np.float32)
        padded[pad // 2: pad // 2 + n] = x
        x = _prefix_rows(padded.reshape(m, window))[:, -1].copy()
    return _prefix_rows(x[None])[0, -1]


def _xla_cumsum(x: np.ndarray, base: int = 16) -> np.ndarray:
    """A float32 inclusive cumsum in XLA's CPU order: blocks of 16 summed
    left to right, each block offset by the scan (the same, recursively)
    of the blocks before it."""
    n = x.shape[0]
    if n <= base:
        return _prefix_rows(x[None])[0]
    m = -(-n // base)
    padded = np.zeros(m * base, np.float32)
    padded[:n] = x
    rows = _prefix_rows(padded.reshape(m, base))
    ends = _xla_cumsum(rows[:, -1].copy(), base)
    before = np.concatenate([np.zeros(1, np.float32), ends[:-1]])
    return (rows + before[:, None]).astype(np.float32).reshape(-1)[:n]


def zipf_cdf_f32(num_keys: int, zipf_a: float) -> np.ndarray:
    """The reference's float32 zipf CDF over ``num_keys`` ranks:
    ``ranks ** -a``, divided by their sum, then cumsum, each in float32
    and summed in XLA's CPU order.  The powers are float64 (of the
    float32 exponent) rounded to float32."""
    exponent = np.float64(np.float32(-zipf_a))
    w = (np.arange(1, num_keys + 1, dtype=np.float64) ** exponent).astype(
        np.float32)
    return _xla_cumsum((w / _xla_sum(w)).astype(np.float32))


def _sample_keys(key: torch.Tensor, shape, num_keys: int,
                 cfg: WorkloadConfig) -> torch.Tensor:
    """int32 keys in ``[0, num_keys)`` from a threefry ``key``: uniform
    by ``randint``, zipf by the inverse CDF (left side, clipped)."""
    if cfg.key_skew == "uniform":
        return prng.randint(key, shape, 0, num_keys)
    cdf = torch.from_numpy(zipf_cdf_f32(num_keys, cfg.zipf_a)).to(key.device)
    u = prng.uniform(key, shape)
    return torch.searchsorted(cdf, u.contiguous(), side="left").clamp(
        0, num_keys - 1).to(I32)


def make_schedule(cfg: ChainConfig | ClusterConfig, wl: WorkloadConfig,
                  device="cuda") -> Msg:
    """Build an injection schedule of client queries, drawn as the
    reference draws it, on ``device``.

    ``ClusterConfig`` -> ``[T, C, n, q]`` (lane (c, node, slot) carries a
    key owned by chain c); ``ChainConfig`` -> legacy ``[T, n, q]``.
    """
    dev = resolve_device(device)
    squeeze = not isinstance(cfg, ClusterConfig)
    cluster = as_cluster(cfg)
    chain_cfg = cluster.chain
    T, C, n, q = wl.ticks, cluster.n_chains, chain_cfg.n_nodes, \
        wl.queries_per_tick
    k_key, k_op, k_val = prng.split(prng.PRNGKey(wl.seed, dev), 3)

    shape = (T, C, n, q)
    keys = _sample_keys(k_key, shape, cluster.keys_in_use, wl)
    is_write = prng.uniform(k_op, shape) < torch.full(
        (), wl.write_fraction, dtype=torch.float32, device=dev)
    vals = prng.randint(k_val, shape, 1, 1 << 20)

    node_idx = torch.arange(n, dtype=I32, device=dev)[None, None, :, None]
    if wl.entry_node is None:
        active_reads = ~is_write
    else:
        active_reads = (~is_write) & (node_idx == wl.entry_node)
    active_writes = is_write & (node_idx == 0)   # writes enter at the head
    active = active_reads | active_writes

    op = torch.where(active, torch.where(is_write, OP_WRITE, OP_READ),
                     OP_NOP).to(I32)
    value = torch.zeros(shape + (chain_cfg.value_words,), dtype=I32,
                        device=dev)
    value[..., 0] = torch.where(is_write & active, vals, 0)

    # Query ids unique across the whole cluster.
    tick_idx = torch.arange(T, dtype=I32, device=dev)[:, None, None, None]
    chain_idx = torch.arange(C, dtype=I32, device=dev)[None, :, None, None]
    qid = (
        (tick_idx * C + chain_idx) * (n * q)
        + node_idx * q
        + torch.arange(q, dtype=I32, device=dev)[None, None, None, :]
    )
    z = torch.zeros(shape, dtype=I32, device=dev)
    client = torch.where(active, CLIENT_BASE + qid % 1024, 0).to(I32)
    sched = Msg(
        op=op,
        key=torch.where(active, keys, 0).to(I32),
        value=value,
        seq=z - 1,
        src=client,
        dst=torch.where(active, node_idx.expand(shape), NOWHERE).to(I32),
        client=client.clone(),
        entry=z,
        qid=torch.where(active, qid, -1).to(I32),
        t_inject=tick_idx.expand(shape).clone(),
        extra=z.clone(),
        ver=z.clone(),
    )
    if squeeze:
        sched = tree_map(lambda x: x[:, 0], sched)
    return tree_map(lambda x: x.contiguous(), sched)


class RoutedStream(NamedTuple):
    """``route_stream``'s result: packed lanes plus exact loss counts."""

    lanes: Msg                 # [T, C, n, queries_per_node]
    dropped: torch.Tensor      # [] int32 queries not packed
    out_of_range: torch.Tensor  # [] int32 subset of dropped outside the
                                #    key space
    stale: torch.Tensor        # [] int32 queries the live map will NACK


def localize_stream(cluster: ClusterConfig, stream: Msg, pmap=None):
    """Rewrite a global-key client stream to chain-local routed form.
    Returns ``(localized, owner, live, out_of_range)`` as the reference:
    ``owner`` is ``n_chains`` for parked NOPs and out-of-range keys."""
    offered = stream.op != OP_NOP
    in_range = (stream.key >= 0) & (stream.key < cluster.num_global_keys)
    live = offered & in_range
    gkey = torch.where(live, stream.key, 0)
    owner = torch.where(live, cluster.key_to_chain(gkey, pmap),
                        cluster.n_chains).to(I32)
    local = cluster.key_to_slot(gkey, pmap)
    # made on the device: a host scalar copied in would sync the host
    # (the open-loop generator calls this every tick)
    epoch = (torch.zeros((), dtype=I32, device=stream.op.device)
             if pmap is None else torch.as_tensor(
                 pmap.epoch, dtype=I32, device=stream.op.device))
    localized = stream._replace(
        key=torch.where(live, local, 0).to(I32),
        ver=torch.where(live, epoch, stream.ver).to(I32),
    )
    return localized, owner, live, offered & ~in_range


def pack_tick(cluster: ClusterConfig, queries_per_node: int, msgs: Msg,
              owner_row: torch.Tensor):
    """Pack one tick's flat ``[Q]`` localized queries into ``[C, n, q]``
    lanes: writes and transaction ops fill the head's slots from the top,
    reads round-robin over the chain's nodes from the bottom.  Returns
    ``(lanes, admitted [Q], dropped)``."""
    C, n, q = cluster.n_chains, cluster.n_nodes, queries_per_node
    dev = msgs.op.device
    order = torch.sort(owner_row, stable=True).indices
    m: Msg = tree_map(lambda x: x[order], msgs)
    own = owner_row[order].long()
    is_w = (m.op == OP_WRITE) | is_txn_op(m.op)
    is_r = m.op == OP_READ
    cw = torch.cumsum(is_w.long(), dim=0)
    cr = torch.cumsum(is_r.long(), dim=0)
    starts = torch.searchsorted(
        own, torch.arange(C + 1, dtype=torch.int64, device=dev))
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    pre_w = torch.cat([zero, cw])[starts]
    pre_r = torch.cat([zero, cr])[starts]
    oc = own.clamp(0, C - 1)
    w_rank = cw - 1 - pre_w[oc]
    r_rank = cr - 1 - pre_r[oc]
    n_w = pre_w[oc + 1] - pre_w[oc]
    node = torch.where(is_w, 0, r_rank % n)
    slot = torch.where(is_w, q - 1 - w_rank, r_rank // n)
    node0_cap = (q - n_w).clamp(min=0)
    ok_w = is_w & (own < C) & (w_rank < q)
    ok_r = is_r & (own < C) & (slot < torch.where(node == 0, node0_cap, q))
    ok = ok_w | ok_r
    flat_idx = torch.where(ok, own * (n * q) + node * q + slot, C * n * q)

    lanes = Msg.empty(C * n * q + 1, cluster.chain.value_words, device=dev)
    packed = Msg(*[
        e.index_put((flat_idx,), v.to(e.dtype))[: C * n * q]
        for e, v in zip(lanes, m)
    ])
    lane_node = (torch.arange(C * n * q, dtype=I32, device=dev) // q) % n
    packed = packed._replace(
        dst=torch.where(packed.op != OP_NOP, lane_node, NOWHERE).to(I32),
        qid=torch.where(packed.op != OP_NOP, packed.qid, -1).to(I32),
    )
    dropped_t = (m.op != OP_NOP).sum() - ok.sum()
    admitted = torch.zeros_like(ok)
    admitted[order] = ok
    return tree_map(lambda x: x.reshape((C, n, q) + x.shape[1:]), packed), \
        admitted, dropped_t.to(I32)


def route_stream(cluster: ClusterConfig, stream: Msg, queries_per_node: int,
                 pmap=None, live_pmap=None) -> RoutedStream:
    """Pack a flat ``[T, Q]`` global-key client stream into
    ``[T, C, n, queries_per_node]`` lanes through the partition map
    (``pmap`` is the client's view; ``live_pmap`` the authoritative map
    for counting queries the entry node will NACK as stale)."""
    C = cluster.n_chains
    stream_local, owner, live, out_of_range = localize_stream(
        cluster, stream, pmap)
    local = stream_local.key
    epoch = torch.as_tensor(0 if pmap is None else pmap.epoch, dtype=I32,
                            device=stream.op.device)
    if live_pmap is None:
        n_stale = torch.zeros((), dtype=I32, device=stream.op.device)
    else:
        oc = owner.long().clamp(0, C - 1)
        lc = local.long().clamp(0, cluster.chain.num_keys - 1)
        se = live_pmap.slot_epoch[oc, lc]
        sb = live_pmap.slot_bucket[oc, lc]
        n_stale = (live & ((epoch < se) | (sb < 0))).sum()

    packed, dropped = [], []
    for i in range(stream.op.shape[0]):
        lanes_t, _, drop_t = pack_tick(
            cluster, queries_per_node,
            tree_map(lambda x: x[i], stream_local), owner[i])
        packed.append(lanes_t)
        dropped.append(drop_t)
    lanes = tree_map(lambda *xs: torch.stack(xs), *packed)
    return RoutedStream(
        lanes=lanes,
        dropped=torch.stack(dropped).sum().to(I32),
        out_of_range=out_of_range.sum().to(I32),
        stale=n_stale.to(I32),
    )


# ---------------------------------------------------------------------------
# Multi-key transactional workload (core/txn.py)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TxnWorkloadConfig:
    """Knobs of the multi-key transaction generator: the share of
    transactions whose keys span chains (the 2PC path; the rest keep
    every key on one chain), the share of each transaction's keys it
    writes (the rest are snapshot reads), and uniform or Zipf(``zipf_a``)
    local keys."""

    n_txns: int = 32
    keys_per_txn: int = 2
    cross_chain_fraction: float = 1.0
    write_fraction: float = 1.0
    key_skew: str = "uniform"
    zipf_a: float = 1.2
    seed: int = 0
    txn_id_base: int = 1
    client_base: int = 0


def make_txn_workload(cfg: ChainConfig | ClusterConfig,
                      twl: TxnWorkloadConfig) -> list:
    """Transactions over the cluster's global key space, drawn exactly as
    the reference draws them.  Cross-chain transactions take their keys
    from distinct chains round-robin; single-chain ones pin every key to
    one chain, rotating the chain per transaction.  Keys are distinct
    within a transaction and values unique across the workload, so a
    partly applied transaction shows."""
    from repro_torch.core.txn import Txn

    cluster = as_cluster(cfg)
    # keys come from the in-use key space (spare regions carry none)
    C, K = cluster.n_chains, cluster.keys_in_use
    kpt = min(twl.keys_per_txn, cluster.num_global_keys)
    rng = np.random.default_rng(twl.seed)
    if twl.key_skew == "zipf":
        w = np.arange(1, K + 1, dtype=np.float64) ** (-twl.zipf_a)
        key_probs = w / w.sum()
    elif twl.key_skew == "uniform":
        key_probs = None
    else:
        raise AssertionError(twl.key_skew)
    draw1 = lambda: int(rng.choice(K, p=key_probs))
    draw_distinct = lambda m: rng.choice(K, size=m, replace=False,
                                         p=key_probs)
    txns = []
    for i in range(twl.n_txns):
        cross = (C > 1 and kpt > 1
                 and rng.random() < twl.cross_chain_fraction)
        if cross:
            off = int(rng.integers(0, C))
            chains = [(off + j) % C for j in range(kpt)]
            rng.shuffle(chains)
            gkeys, used = [], set()
            for c in chains:
                lk = draw1()
                while (c, lk) in used:
                    lk = (lk + 1) % K
                used.add((c, lk))
                gkeys.append(int(cluster.global_key(lk, c)))
        else:
            c = (twl.seed + i) % C
            gkeys = [int(cluster.global_key(int(lk), c))
                     for lk in draw_distinct(kpt)]
        n_writes = (max(1, round(kpt * twl.write_fraction))
                    if twl.write_fraction > 0 else 0)
        tid = twl.txn_id_base + i
        writes = tuple((gk, (tid << 8) | (j + 1))
                       for j, gk in enumerate(gkeys[:n_writes]))
        txns.append(Txn(txn_id=tid, writes=writes,
                        reads=tuple(gkeys[n_writes:]),
                        client=twl.client_base + i))
    return txns
