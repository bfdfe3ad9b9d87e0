"""Declarative chaos suite - the port of ``repro/core/chaos.py``.

Disturbances are plain host-side values, replayed between open-loop
segments of ``ChainSim.run_openloop``:

* ``ChaosEvent`` - one control-plane action pinned to a tick (fail a
  node, recover it, migrate a bucket, retune the lock lease);
* ``ChaosScenario`` - a named, tick-sorted event table and the segment
  length that discretizes the run; events fire on segment boundaries;
* ``run_scenario`` - the loop: open-loop segments, ``Coordinator``
  surgery at the boundaries, a drain with ``qps`` set to 0, then the
  drain invariants:

      stores == serial reference     (the replies joined by qid to the
                                      re-materialized offered stream)
      leaked locks == 0              (under a finite lease; under
                                      ``LEASE_OFF`` the leak is counted)
      live replicas converged        (every live node agrees on slot 0)
      inflight == 0                  (nothing left in the fabric)

The reference reports its jit cache sizes before and after a run; the
port compiles nothing per shape, and what it builds at run time is the
kernel libraries (``kernels/build.py``), so ``cache_sizes`` counts those
(deltas 0 once a run has loaded them).  A segment makes no host sync:
every sync of a scenario is at a boundary (the control plane's checks,
the samples).

In place, as the port's control plane: ``run_openloop``,
``complete_rebalance`` and ``complete_recovery`` edit the state they are
given, so ``run_scenario`` keeps a deep copy of the generator for the
oracle and a rebalance probe that fails leaves the stores untouched (its
checks all run before its first copy).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import loadgen as loadgen_lib
from repro_torch.core import txn as txn_lib
from repro_torch.core.coordinator import Coordinator
from repro_torch.core.types import (I32, LEASE_OFF, OP_NOP, OP_TXN_REPLY,
                                    OP_WRITE_REPLY, as_cluster, tree_map)
from repro_torch.kernels import build


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One control-plane action at one tick.  ``kind``:

    * ``"fail"``     - drop ``node`` from ``chain`` (phase-1 redirection)
    * ``"recover"``  - freeze ``chain``, drain its locks, copy stores onto
                       ``node`` spliced back at ``position``, unfreeze
    * ``"migrate"``  - move ``bucket`` to ``dst_chain`` (freeze -> drain ->
                       copy -> publish), leaving the open-loop generator a
                       stale client of the moved bucket
    * ``"lease"``    - retune the lock lease to ``lease_ticks`` (a leaf
                       edit; ``LEASE_OFF`` disables expiry)

    ``tick`` must land on a segment boundary: events are applied between
    segments, never inside one.
    """

    tick: int
    kind: str
    chain: int = -1
    node: int = -1
    position: int = -1
    bucket: int = -1
    dst_chain: int = -1
    lease_ticks: int = -1


@dataclasses.dataclass(frozen=True)
class ChaosScenario:
    """A named disturbance schedule: ``events`` over ``total_ticks`` of
    offered load, run as ``segment_ticks``-tick open-loop segments."""

    name: str
    events: tuple = ()
    total_ticks: int = 96
    segment_ticks: int = 8

    def __post_init__(self):
        if self.total_ticks % self.segment_ticks != 0:
            raise AssertionError(
                f"total_ticks={self.total_ticks} must be a whole number of "
                f"{self.segment_ticks}-tick segments")
        for ev in self.events:
            if ev.tick % self.segment_ticks != 0:
                raise AssertionError(
                    f"event {ev} not on a segment boundary "
                    f"(segment_ticks={self.segment_ticks})")
            if not 0 <= ev.tick <= self.total_ticks:
                raise AssertionError(ev)
        ticks = [ev.tick for ev in self.events]
        if ticks != sorted(ticks):
            raise AssertionError("events must be tick-sorted")


# -- scenario builders (the four disturbance axes) ----------------------------
def none_scenario(total_ticks: int = 96, segment_ticks: int = 8):
    """The control cell: no disturbance, same runner, same invariants."""
    return ChaosScenario("none", (), total_ticks, segment_ticks)


def failure_storm(n_chains: int, total_ticks: int = 96,
                  segment_ticks: int = 8, node: int = 1):
    """Every chain loses a middle node early and gets it spliced back at
    its old position mid-run, under load (head and tail stay, so writes
    keep committing)."""
    fail_at = segment_ticks * 2
    recover_at = (total_ticks // segment_ticks // 2) * segment_ticks
    events = tuple(
        ChaosEvent(tick=fail_at, kind="fail", chain=c, node=node)
        for c in range(n_chains)
    ) + tuple(
        ChaosEvent(tick=recover_at, kind="recover", chain=c, node=node,
                   position=node)
        for c in range(n_chains)
    )
    return ChaosScenario("failure_storm", events, total_ticks, segment_ticks)


def migration_wave(moves, total_ticks: int = 96, segment_ticks: int = 8):
    """Bucket moves ``[(bucket, dst_chain), ...]``, one per boundary (one
    migration open at a time; each completes before the next segment)."""
    start = segment_ticks * 2
    events = tuple(
        ChaosEvent(tick=start + i * segment_ticks, kind="migrate",
                   bucket=b, dst_chain=d)
        for i, (b, d) in enumerate(moves)
    )
    return ChaosScenario("migration_wave", events, total_ticks, segment_ticks)


def stale_clients(bucket: int, dst_chain: int, total_ticks: int = 96,
                  segment_ticks: int = 8):
    """One early migration, then a long tail of load still routed under
    the old map: the generator localizes by the home placement, so every
    op it aims at the moved bucket is NACKed at the entry node
    (``stale_routes``)."""
    events = (ChaosEvent(tick=segment_ticks * 2, kind="migrate",
                         bucket=bucket, dst_chain=dst_chain),)
    return ChaosScenario("stale_clients", events, total_ticks, segment_ticks)


# -- the serial-reference oracle over the open-loop stream --------------------
def serial_reference_tensors(sim, state, gen_before, arrival_width: int,
                             total_ticks: int):
    """The serial reference as tensors on the state's device: ``(gkeys,
    values)``, the committed global keys and the value each ends with.

    The offered stream is re-materialized from ``gen_before`` and joined
    by qid to the run's committed replies (``OP_WRITE_REPLY``, or
    ``OP_TXN_REPLY`` for a 2PC COMMIT, with ``seq >= 0``); per key the
    highest seq wins, the first in log order among equal seqs.  A NACKed
    straggler COMMIT (``seq == -1``), a shed op and a stale-routed op
    have no committed reply and drop out."""
    cluster = as_cluster(sim.cluster)
    stream = loadgen_lib.materialize_stream(gen_before, cluster,
                                            arrival_width, total_ticks)
    dev = stream.op.device
    n_qid = stream.qid.numel()
    offered = torch.zeros(n_qid + 1, dtype=torch.bool, device=dev)
    key_of = torch.zeros(n_qid + 1, dtype=torch.int64, device=dev)
    val_of = torch.zeros(n_qid + 1, dtype=I32, device=dev)
    live = stream.op.reshape(-1) != OP_NOP
    qid = stream.qid.reshape(-1).long()
    # qids are unique in the stream: t * 2W + lane, COMMITs + W
    slot = torch.where(live, qid, n_qid)
    offered[slot] = live
    key_of[slot] = stream.key.reshape(-1).long()
    val_of[slot] = stream.value[..., 0].reshape(-1)

    log = state.replies
    if int(log.lost.sum()) != 0:
        raise AssertionError(
            "reply log overflowed - the oracle would miss commit "
            "decisions; size reply_capacity up")
    R = log.qid.shape[1]
    in_log = (torch.arange(R, device=dev)[None, :]
              < log.cursor.to(dev)[:, None]).reshape(-1)
    q, o, s = (x.reshape(-1)[in_log].long() for x in
               (log.qid.to(dev), log.op.to(dev), log.seq.to(dev)))
    committed = (s >= 0) & ((o == OP_WRITE_REPLY) | (o == OP_TXN_REPLY))
    q, s = q[committed], s[committed]
    known = (q >= 0) & (q < n_qid)
    known = known & offered[torch.where(known, q, n_qid)]
    if not bool(known.all()):
        bad = int(q[~known][0])
        raise AssertionError(
            f"committed reply qid={bad} not in the offered stream - the "
            "counter-based replay diverged")
    gk, val = key_of[q], val_of[q]
    # per key the max seq; among equal seqs the first in log order: sort
    # the log reversed by (key, seq), stably, and keep each key's last
    pos = torch.arange(gk.numel() - 1, -1, -1, device=dev)
    order = pos[torch.sort((gk * (1 << 32) + s).flip(0), stable=True).indices]
    gk, val = gk[order], val[order]
    last = torch.ones_like(gk, dtype=torch.bool)
    last[:-1] = gk[1:] != gk[:-1]
    return gk[last], val[last]


def serial_reference(sim, state, gen_before, arrival_width: int,
                     total_ticks: int) -> dict:
    """The expected final ``{global_key: value}`` of the run's committed
    writes (``serial_reference_tensors`` as a dict)."""
    gk, val = serial_reference_tensors(sim, state, gen_before,
                                       arrival_width, total_ticks)
    return dict(zip(gk.tolist(), val.tolist()))


def check_serial_reference(sim, state, gen_before, arrival_width: int,
                           total_ticks: int) -> int:
    """Assert stores == serial reference for every in-use global key;
    returns the number of committed-write keys checked."""
    cluster = as_cluster(sim.cluster)
    gk, val = serial_reference_tensors(sim, state, gen_before,
                                       arrival_width, total_ticks)
    keys, got = txn_lib.committed_values(cluster, state)
    keys = keys.long()
    want = torch.zeros(cluster.num_global_keys, dtype=I32, device=got.device)
    want[gk.to(got.device)] = val.to(got.device)
    bad = (got != want[keys]).nonzero()
    if bad.numel():
        i = int(bad[0, 0])
        raise AssertionError(
            f"global key {int(keys[i])}: store has {int(got[i])}, serial "
            f"reference says {int(want[keys[i]])} - a lost or phantom commit "
            f"({bad.numel()} key(s) differ)")
    return int(gk.numel())


def check_replicas_converged(sim, state, coordinator: Coordinator) -> None:
    """Every live node of every chain agrees on the committed slot (a
    failed-and-not-recovered node is excused)."""
    vals = state.stores.values[:, :, :, 0, 0]               # [C, n, K]
    # every live node's count of slots that differ from its chain's
    # first live node, read back in one copy
    n_bad = torch.cat([
        (vals[c, m.node_ids] != vals[c, m.node_ids[0]]).sum(dim=1)
        for c, m in enumerate(coordinator.chains)]).tolist()
    live = [(c, m.node_ids[0], node) for c, m in enumerate(coordinator.chains)
            for node in m.node_ids]
    for (c, first, node), bad in zip(live, n_bad):
        if bad:
            raise AssertionError(
                f"chain {c}: node {node} diverged from node {first} on "
                f"{bad} slot(s)")


# -- the runner ---------------------------------------------------------------
def _cache_sizes(sim) -> dict:
    return {"kernel_libraries": build.loaded_libraries()}


def _apply_event(sim, co: Coordinator, state, gen, ev: ChaosEvent,
                 arrival_width: int, segment_ticks: int,
                 max_drain_segments: int):
    """Host-side surgery for one event; may tick extra segments (the
    freeze-window drains).  Returns (state, gen, extra_ticks_run)."""
    extra = 0

    def settle(state, gen, done, what):
        """Tick segments under the published freeze until
        ``done(state)``, at most ``max_drain_segments``: under
        ``LEASE_OFF`` an abandoned lock never drains."""
        nonlocal extra
        for _ in range(max_drain_segments):
            if done(state):
                return state, gen
            state, gen = sim.run_openloop(
                state, gen, segment_ticks, arrival_width=arrival_width,
                extra_ticks=0)
            extra += segment_ticks
        raise RuntimeError(
            f"{what} did not quiesce within {max_drain_segments} frozen "
            f"segments - with abandoning clients and lease_ticks == "
            f"LEASE_OFF this is the expected hang the lock lease exists "
            f"to prevent (lock-lease rules, core/chain.py)")

    if ev.kind == "fail":
        co.fail_node(ev.chain, ev.node)
        state = co.install_roles(state)
    elif ev.kind == "recover":
        co.begin_recovery(ev.chain)
        state = co.install_roles(state)
        state, gen = settle(
            state, gen, lambda s: co.locks_drained(s, ev.chain),
            f"chain {ev.chain} lock drain before recovery copy")
        _, stores = co.complete_recovery(
            ev.chain, ev.node, ev.position, state.stores, locks=state.locks)
        state = co.install_roles(state._replace(stores=stores))
    elif ev.kind == "migrate":
        co.begin_rebalance(ev.bucket, ev.dst_chain)
        state = co.install_roles(state)

        def try_complete(s):
            # complete_rebalance checks every quiescence precondition
            # before its first copy, so a failed probe changed nothing
            try:
                return co.complete_rebalance(s)
            except AssertionError:
                return None

        done = try_complete(state)
        while done is None:
            state, gen = sim.run_openloop(
                state, gen, segment_ticks, arrival_width=arrival_width,
                extra_ticks=0)
            extra += segment_ticks
            if extra > max_drain_segments * segment_ticks:
                raise RuntimeError(
                    f"bucket {ev.bucket} migration did not quiesce within "
                    f"{max_drain_segments} frozen segments - under "
                    f"LEASE_OFF an abandoned lock on the source chain "
                    f"blocks the copy forever (lock-lease rules, "
                    f"core/chain.py)")
            done = try_complete(state)
        state = done
    elif ev.kind == "lease":
        state = co.set_lease(state, ev.lease_ticks)
    else:
        raise ValueError(f"unknown chaos event kind {ev.kind!r}")
    return state, gen, extra


def run_scenario(sim, gen, scenario: ChaosScenario, *,
                 coordinator: Optional[Coordinator] = None,
                 lease_ticks=None,
                 arrival_width: Optional[int] = None,
                 drain_segments: int = 24,
                 max_drain_segments: int = 64,
                 check: bool = True):
    """One chaos cell, end to end: open-loop segments with control-plane
    surgery at the boundaries, a drain with ``qps`` set to 0, and the
    drain invariants.

    Returns ``(state, gen, report)``.  ``report`` carries the
    per-boundary ``samples`` (tick, held locks, cumulative replies, lease
    expiries), final ``metrics``, ``leaked_locks`` at drain,
    ``extra_ticks`` (the freeze-window settles), ``drained``, the kernel
    libraries loaded before/after (``cache_sizes``) and ``serial_keys``
    (how many committed keys the oracle checked).  ``check=False`` skips
    the invariants and only measures (the ``LEASE_OFF`` leak arm).
    """
    co = (coordinator if coordinator is not None
          else Coordinator(sim.cluster, device=sim.device))
    if arrival_width is None:
        arrival_width = sim.C * sim.n * sim.c_in
    caches_before = _cache_sizes(sim)

    state = sim.init_state()
    if lease_ticks is not None:
        state = co.set_lease(state, lease_ticks)
    # the oracle re-derives the offered stream after the run has moved
    # the generator on: keep a deep copy of every leaf
    gen = tree_map(lambda x: x.to(sim.device), gen)
    gen_before = tree_map(lambda x: x.clone(), gen)

    samples = []
    events = list(scenario.events)
    n_segments = scenario.total_ticks // scenario.segment_ticks
    extra_run = 0
    for seg in range(n_segments):
        t_now = seg * scenario.segment_ticks
        while events and events[0].tick <= t_now:
            ev = events.pop(0)
            state, gen, extra = _apply_event(
                sim, co, state, gen, ev, arrival_width,
                scenario.segment_ticks, max_drain_segments)
            extra_run += extra
        samples.append({
            "t": int(state.t),
            "held_locks": txn_lib.held_locks(state.locks),
            "replies": int(state.replies.cursor.sum()),
            "lease_expiries": int(state.metrics.lease_expiries.sum()),
        })
        state, gen = sim.run_openloop(
            state, gen, scenario.segment_ticks,
            arrival_width=arrival_width, extra_ticks=0)
    while events:  # boundary events pinned at exactly total_ticks
        ev = events.pop(0)
        state, gen, extra = _apply_event(
            sim, co, state, gen, ev, arrival_width,
            scenario.segment_ticks, max_drain_segments)
        extra_run += extra

    # drain through the same segments with qps 0 (a leaf edit on the
    # generator's device); abandoned locks age out inside the ticks
    gen = gen._replace(qps=torch.zeros((), dtype=torch.float32,
                                       device=gen.qps.device))
    # under a finite lease the drain also outlives the youngest abandoned
    # lock; under LEASE_OFF the leak is the measurement, not a hang
    reclaims = bool((state.locks.lease_ticks != LEASE_OFF).any())
    drained_at = None
    for d in range(drain_segments):
        state, gen = sim.run_openloop(
            state, gen, scenario.segment_ticks,
            arrival_width=arrival_width, extra_ticks=0)
        quiet = (sim.inflight(state) == 0
                 and int(state.stores.pending.sum()) == 0)
        if quiet and (not reclaims or txn_lib.held_locks(state.locks) == 0):
            drained_at = d
            break
    leaked = txn_lib.held_locks(state.locks)
    caches_after = _cache_sizes(sim)

    report = {
        "name": scenario.name,
        "samples": samples,
        "metrics": state.metrics.asdict(),
        "leaked_locks": leaked,
        "extra_ticks": extra_run,
        "drained": drained_at is not None,
        "cache_sizes": {k: (caches_before[k], caches_after[k])
                        for k in caches_before},
        "serial_keys": None,
    }
    if check:
        if drained_at is None:
            raise AssertionError(
                f"{scenario.name}: ops still in flight after "
                f"{drain_segments} drain segments")
        if leaked != 0:
            raise AssertionError(
                f"{scenario.name}: {leaked} lock(s) leaked at drain - "
                f"abandoned transactions outlived the run (lease_ticks="
                f"{lease_ticks}; see the lock-lease rules, core/chain.py)")
        check_replicas_converged(sim, state, co)
        total_ticks = scenario.total_ticks + extra_run
        report["serial_keys"] = check_serial_reference(
            sim, state, gen_before, arrival_width, total_ticks)
    return state, gen, report
