"""Device-side open-loop workload generation - the port of
``repro/core/loadgen.py``.

Each tick's candidate arrivals are a function of ``(seed, tick, lane)``
through the counter-based threefry PRNG (``core/prng.py``, bit-identical
to the reference's ``jax.random`` draws), so ``materialize_stream`` can
replay them on the host side and any tick can be re-derived without
history.  The offered load, op mix, key popularity and burst shape are
tensors of ``LoadGenState``: a load sweep is ``_replace`` on them.
Arrivals that find no injection lane defer into a device-side FIFO
backlog, keeping their ``t_inject`` (queueing delay is measured
latency); only arrivals past the backlog's capacity are shed, counted per
owning chain in ``Metrics.admission_drops``.

Arrival law: each of the ``width`` fresh lanes is live with probability
``rate_t / width``, where ``rate_t = qps * burst_mult`` in the first
``burst_len`` ticks of every ``burst_period`` and ``qps`` otherwise.  Ops
split write/transaction/read by ``write_fraction``/``txn_fraction``; keys
are drawn by inverse CDF from ``key_cdf`` over the in-use global key
space.  A transaction lane issues ``OP_PREPARE`` (txn id = its qid) and
the generator issues the matching ``OP_COMMIT`` one tick later from the
re-derived draws, unless the client abandons it (``abandon_fraction``).

Nothing here reads a tensor back to the host: ``gen_tick`` runs inside
``ChainSim.run_openloop``'s loop.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.types import (
    CLIENT_BASE,
    I32,
    NOWHERE,
    OP_COMMIT,
    OP_PREPARE,
    OP_READ,
    OP_WRITE,
    ClusterConfig,
    Msg,
    as_cluster,
    resolve_device,
    tree_map,
)
from repro_torch.core.workload import localize_stream, pack_tick

F32 = torch.float32
# the key a lane's abandonment draw comes from: fold_in(tick key, ABANDON)
ABANDON = 7919


class LoadGenState(NamedTuple):
    """Knobs and deferred-arrival backlog of the open-loop generator; the
    scalars are 0-dim float32 / int32 tensors on the engine's device."""

    seed: torch.Tensor            # [] int32 PRNG root
    qps: torch.Tensor             # [] float32 mean offered ops/tick
    write_fraction: torch.Tensor  # [] float32 P(op = WRITE)
    txn_fraction: torch.Tensor    # [] float32 P(op = PREPARE->COMMIT pair)
    key_cdf: torch.Tensor         # [G] float32 cumulative key popularity
    burst_period: torch.Tensor    # [] int32 ticks per burst cycle
    burst_len: torch.Tensor       # [] int32 leading ticks that burst
    burst_mult: torch.Tensor      # [] float32 rate multiplier in a burst
    abandon_fraction: torch.Tensor  # [] float32 P(a PREPARE's COMMIT is
                                  #    never issued)
    backlog: Msg                  # [B] deferred arrivals, global keys, FIFO


def _cdf(G: int, key_skew: str, zipf_a: float) -> np.ndarray:
    """The float64 cumulative popularity over ``G`` global keys."""
    if key_skew == "zipf":
        w = np.arange(1, G + 1, dtype=np.float64) ** (-zipf_a)
    else:
        assert key_skew == "uniform", key_skew
        w = np.ones((G,), dtype=np.float64)
    return np.cumsum(w / w.sum())


def make_loadgen(cfg, *, qps: float, write_fraction: float = 0.0,
                 txn_fraction: float = 0.0, key_skew: str = "uniform",
                 zipf_a: float = 1.2, seed: int = 0, burst_period: int = 1,
                 burst_len: int = 0, burst_mult: float = 1.0,
                 abandon_fraction: float = 0.0, backlog_capacity: int = 256,
                 device="cuda") -> LoadGenState:
    """A generator for ``cfg``'s in-use global key space.  The key CDF is
    built once on the host (float64 cumsum, then float32, as in the
    reference); ``key_skew="zipf"`` gives global key g the weight
    ``(g + 1) ** -zipf_a``."""
    cluster = as_cluster(cfg)
    dev = resolve_device(device)
    f32 = lambda x: torch.tensor(x, dtype=F32, device=dev)
    i32 = lambda x: torch.tensor(x, dtype=I32, device=dev)
    cdf = _cdf(cluster.num_global_keys, key_skew, zipf_a)
    return LoadGenState(
        seed=i32(seed),
        qps=f32(qps),
        write_fraction=f32(write_fraction),
        txn_fraction=f32(txn_fraction),
        key_cdf=torch.from_numpy(cdf.astype(np.float32)).to(dev),
        burst_period=i32(burst_period),
        burst_len=i32(burst_len),
        burst_mult=f32(burst_mult),
        abandon_fraction=f32(abandon_fraction),
        backlog=Msg.empty(backlog_capacity, cluster.chain.value_words,
                          device=dev),
    )


def reset(gen: LoadGenState) -> LoadGenState:
    """The same generator with an empty backlog (the next sweep point)."""
    b = gen.backlog
    return gen._replace(backlog=Msg.empty(
        b.op.shape[0], b.value.shape[1], device=b.op.device))


def zipf_cdf(cfg, zipf_a: float = 1.2, device="cuda") -> torch.Tensor:
    """The ``key_skew="zipf"`` popularity leaf alone, to swap into a
    state with ``gen._replace(key_cdf=zipf_cdf(cluster))``."""
    cluster = as_cluster(cfg)
    cdf = _cdf(cluster.num_global_keys, "zipf", zipf_a)
    return torch.from_numpy(cdf.astype(np.float32)).to(resolve_device(device))


def _ticks(gen: LoadGenState, t) -> torch.Tensor:
    """``t`` (an int, a 0-dim or a 1-dim tensor) as a [T] int32 tensor on
    the generator's device."""
    return torch.as_tensor(t, dtype=I32, device=gen.seed.device).reshape(-1)


def _draw(gen: LoadGenState, width: int, value_words: int, ts):
    """The fresh lanes of every tick of ``ts`` ([T] int32), and the
    abandonment draw of each lane: ``(Msg [T, width], abandoned [T,
    width])``.  Every tick's key is ``fold_in(PRNGKey(seed), t)``, split
    into thinning, key, op and value keys (the value key split again for
    randint's two draws); ``fold_in(key, ABANDON)`` draws abandonment.
    All draws of all ticks come from one threefry evaluation."""
    T = ts.shape[0]
    dev = ts.device
    tick_key = prng.fold_in(prng.PRNGKey(gen.seed), ts)            # [T, 2]
    # split(key, 4)[i] is fold_in(key, i): one hash for both
    lo = torch.arange(5, device=dev)
    sub = prng.fold_in(tick_key[:, None], torch.where(lo == 4, ABANDON, lo))
    val_keys = prng.split(sub[:, 3])                                # [T, 2, 2]
    keys = torch.cat([sub[:, :3], val_keys, sub[:, 4:]], dim=1)     # [T, 6, 2]
    bits = prng.random_bits(keys, (width,))                         # [T, 6, W]
    u_thin, u_key, u_op, u_ab = (prng.bits_to_uniform(bits[:, i])
                                 for i in (0, 1, 2, 5))
    vals = prng.bits_to_randint(bits[:, 3], bits[:, 4], 1, 1 << 20)

    in_burst = torch.remainder(ts, gen.burst_period) < gen.burst_len
    rate = gen.qps * torch.where(in_burst, gen.burst_mult,
                                 torch.ones((), dtype=F32, device=dev))
    # a tensor divisor: a host scalar may become a reciprocal multiply
    p = torch.clamp(rate / torch.full((), width, dtype=F32, device=dev),
                    0.0, 1.0)
    live = u_thin < p[:, None]
    G = gen.key_cdf.shape[0]
    gkey = torch.searchsorted(gen.key_cdf, u_key.contiguous(),
                              side="left").clamp(0, G - 1).to(I32)
    is_wr = u_op < gen.write_fraction
    is_tx = ~is_wr & (u_op < gen.write_fraction + gen.txn_fraction)
    lane = torch.arange(width, dtype=I32, device=dev)
    qid = (ts[:, None] * (2 * width) + lane).to(I32)
    value = torch.zeros((T, width, value_words), dtype=I32, device=dev)
    # PREPARE lanes carry the write value too: the COMMIT reuses it
    value[..., 0] = torch.where(is_wr | is_tx, vals, 0)
    client = (CLIENT_BASE + torch.remainder(qid, 1024)).to(I32)
    zero = torch.zeros((T, width), dtype=I32, device=dev)
    msg = Msg(
        op=torch.where(is_wr, OP_WRITE,
                       torch.where(is_tx, OP_PREPARE, OP_READ)).to(I32),
        key=gkey,
        value=value,
        # PREPARE's seq is the transaction id
        seq=torch.where(is_tx, qid, -1).to(I32),
        src=client,
        dst=zero + NOWHERE,
        client=client.clone(),
        entry=zero.clone(),
        qid=qid,
        t_inject=ts[:, None].expand(T, width).contiguous(),
        extra=zero.clone(),
        ver=zero.clone(),
    ).mask(live)
    return msg, u_ab < gen.abandon_fraction


def _commits(prev: Msg, abandoned: torch.Tensor, ts: torch.Tensor,
             width: int) -> Msg:
    """Tick ``t``'s COMMITs for the PREPAREs of tick ``t - 1`` (``prev``
    [T, width]): same key, client and value, seq = the PREPARE's qid (the
    txn id), qid in the upper half of tick ``t - 1``'s qid block."""
    live = (prev.op == OP_PREPARE) & (ts[:, None] > 0) & ~abandoned
    return prev._replace(
        op=torch.full_like(prev.op, OP_COMMIT),
        qid=(prev.qid + width).to(I32),
        t_inject=ts[:, None].expand_as(prev.op).contiguous(),
    ).mask(live)


def _fresh_and_commits(gen: LoadGenState, width: int, value_words: int,
                       ts: torch.Tensor):
    """Fresh lanes and follow-up COMMITs of the ticks ``ts`` ([T]),
    drawing ticks ``ts`` and ``ts - 1`` in one evaluation."""
    T = ts.shape[0]
    msg, abandoned = _draw(gen, width, value_words,
                           torch.cat([ts, ts - 1]))
    fresh = tree_map(lambda x: x[:T], msg)
    prev = tree_map(lambda x: x[T:], msg)
    return fresh, _commits(prev, abandoned[T:], ts, width)


def draw_tick(gen: LoadGenState, width: int, value_words: int, t) -> Msg:
    """Tick ``t``'s fresh candidate lanes: a ``[width]`` Msg with global
    keys, dead lanes NOP.  Lane ``i`` gets qid ``t * 2 * width + i`` (the
    upper half of each tick's qid block is for follow-up COMMITs)."""
    msg, _ = _draw(gen, width, value_words, _ticks(gen, t)[:1])
    return tree_map(lambda x: x[0], msg)


def followup_commits(gen: LoadGenState, width: int, value_words: int,
                     t) -> Msg:
    """Tick ``t``'s OP_COMMITs for tick ``t - 1``'s PREPAREs, re-derived
    from the counters (an abandoned lane issues none)."""
    ts = _ticks(gen, t)[:1]
    prev, abandoned = _draw(gen, width, value_words, ts - 1)
    return tree_map(lambda x: x[0], _commits(prev, abandoned, ts, width))


def _per_chain(owner: torch.Tensor, mask: torch.Tensor, n_chains: int):
    """Count ``mask`` entries per owning chain -> [C] int32."""
    chains = torch.arange(n_chains, dtype=I32, device=owner.device)
    return ((owner[None, :] == chains[:, None]) & mask[None, :]).sum(
        dim=1).to(I32)


def gen_tick(gen: LoadGenState, cluster: ClusterConfig, width: int,
             queries_per_node: int, t):
    """One tick of arrival generation and admission: this tick's fresh
    lanes and follow-up COMMITs behind the backlog (FIFO: the oldest
    arrivals claim lanes first), localized and packed through the same
    helpers as ``route_stream``; what found no lane defers into the next
    backlog in global-key form, and what the backlog cannot hold is shed.

    Returns ``(injection [C, n, q], gen', offered [C], shed [C])``:
    ``offered`` counts this tick's new client ops per owning chain.

    repro-torch-lint: sync-free
    """
    vw = cluster.chain.value_words
    C = cluster.n_chains
    B = gen.backlog.op.shape[0]
    fresh, commits = _fresh_and_commits(gen, width, vw, _ticks(gen, t))
    combined = Msg.concat([gen.backlog] + [tree_map(lambda x: x[0], m)
                                           for m in (fresh, commits)])
    localized, owner, live, _ = localize_stream(cluster, combined)
    injection, admitted, _ = pack_tick(cluster, queries_per_node,
                                       localized, owner)
    offered = _per_chain(owner[B:], live[B:], C)
    leftover = live & ~admitted
    rank = torch.cumsum(leftover.to(I32), dim=0) - 1
    shed = _per_chain(owner, leftover & (rank >= B), C)
    # leftovers first, in FIFO order
    order = torch.sort((~leftover).to(torch.uint8), stable=True).indices
    deferred = tree_map(lambda x: x[order[:B]], combined)
    keep = torch.arange(B, device=order.device) < leftover.sum()
    return injection, gen._replace(backlog=deferred.mask(keep)), offered, shed


def materialize_stream(gen: LoadGenState, cluster: ClusterConfig,
                       width: int, ticks: int) -> Msg:
    """The flat ``[T, 2 * width]`` global-key stream ``run_openloop``
    injects at the same state (fresh lanes then COMMITs per tick), for
    ``route_stream`` + ``ChainSim.run``: equal to the open loop while no
    arrival defers."""
    cluster = as_cluster(cluster)
    ts = torch.arange(ticks, dtype=I32, device=gen.seed.device)
    fresh, commits = _fresh_and_commits(gen, width,
                                        cluster.chain.value_words, ts)
    return Msg.concat([fresh, commits], dim=1)
