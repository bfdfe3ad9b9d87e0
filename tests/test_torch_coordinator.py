"""The port's control plane against the reference's, and its behaviours.

The parity tests drive the reference ``ChainSim`` + ``Coordinator`` and
the port's with one numpy-made global-key stream, tick by tick, through a
live rebalance (freeze -> drain -> copy -> publish, twice) and a fail ->
redirect -> recover lifecycle, and require exact equality after every
tick: engine state, role table, partition map and the control plane's
host state.  Both lifecycles share one reference engine (one compile).
The other tests are the torch forms of what ``tests/test_partition.py``,
``tests/test_live_membership.py`` and ``tests/test_failure.py`` assert,
run on the port alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ChainConfig as JChain  # noqa: E402
from repro.core import ChainSim as JSim  # noqa: E402
from repro.core import ClusterConfig as JCluster  # noqa: E402
from repro.core import Coordinator as JCoordinator  # noqa: E402
from repro.core import committed_view as j_committed_view  # noqa: E402
from repro.core import route_stream as j_route_stream  # noqa: E402
from repro.core import types as j_types  # noqa: E402
from repro.core.failure import FailureDetector as JDetector  # noqa: E402
from repro.core.failure import HedgedReadPolicy as JHedged  # noqa: E402
from repro.core.store import Store as JStore  # noqa: E402
from repro.core.store import init_store as j_init_store  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import txn as t_txn  # noqa: E402
from repro_torch.core.chain import ChainSim  # noqa: E402
from repro_torch.core.coordinator import Coordinator  # noqa: E402
from repro_torch.core.failure import (  # noqa: E402
    FailureDetector,
    HedgedReadPolicy,
)
from repro_torch.core.store import Store, init_store  # noqa: E402
from repro_torch.core.types import (  # noqa: E402
    CLIENT_BASE,
    OP_READ,
    OP_READ_REPLY,
    OP_STALE_NACK,
    OP_WRITE,
    OP_WRITE_NACK,
    OP_WRITE_REPLY,
    ChainConfig,
    ClusterConfig,
    Msg,
    tree_map,
    value_from_int,
)
from repro_torch.core.workload import route_stream  # noqa: E402
from torch_parity import assert_tree_equal  # noqa: E402

CPU = "cpu"
SIM_KW = dict(inject_capacity=4, route_capacity=64, reply_capacity=1024,
              telemetry=False)
Q, TICKS = 40, 30
# the reference router, compiled once for the test's shapes (its eager
# form dispatches op by op and takes about a second a tick)
j_route = jax.jit(j_route_stream, static_argnums=(0, 2))


# ---------------------------------------------------------------------------
# parity: the reference and the port, tick by tick
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    """fig_rebalance's cluster cut to 3 nodes and a 64-slot fabric: 4
    chains of 24 registers, 4 buckets of 4 per chain, two landing regions
    per chain.  (reference cluster, reference sim, port cluster)."""
    jcl = JCluster(chain=JChain(n_nodes=3, num_keys=24, num_versions=6),
                   n_chains=4, buckets_per_chain=4, spare_keys=8)
    return jcl, JSim(jcl, **SIM_KW), convert.cluster_from(jcl)


def _stream(jcl, seed):
    """A [TICKS, Q] global-key client stream as numpy fields: 70 % of the
    queries hit chain 0's home keys, 15 % writes, the rest uniform."""
    rng = np.random.default_rng(seed)
    C = jcl.n_chains
    hot = rng.integers(0, jcl.keys_in_use, (TICKS, Q)) * C
    bg = rng.integers(0, jcl.num_global_keys, (TICKS, Q))
    keys = np.where(rng.random((TICKS, Q)) < 0.7, hot, bg).astype(np.int32)
    is_w = rng.random((TICKS, Q)) < 0.15
    f = {k: np.broadcast_to(np.asarray(v), (TICKS, Q) + np.shape(v)).copy()
         for k, v in j_types.Msg.empty(1)._asdict().items()}
    f = {k: v[:, :, 0] for k, v in f.items()}
    qid = np.arange(TICKS * Q, dtype=np.int32).reshape(TICKS, Q)
    f["op"] = np.where(is_w, OP_WRITE, OP_READ).astype(np.int32)
    f["key"] = keys
    f["value"][..., 0] = np.where(is_w, 1000 + qid, 0)
    f["src"] = f["client"] = (CLIENT_BASE + qid % 64).astype(np.int32)
    f["qid"] = qid
    f["t_inject"] = np.repeat(np.arange(TICKS, dtype=np.int32)[:, None], Q,
                              axis=1)
    return f


class _Pair:
    """The two control planes and engines, stepped together."""

    def __init__(self, engines):
        self.jcl, self.jsim, self.tcl = engines
        self.tsim = ChainSim(self.tcl, device=CPU, **SIM_KW)
        self.jco = JCoordinator(self.jcl)
        self.tco = convert.coordinator_from(self.jco, CPU)
        self.jstate = self.jsim.init_state()
        self.tstate = self.tsim.init_state()
        self.jclient = self.tclient = None   # the clients' cached maps
        self.nacks = []                      # per-tick write_nacks [C]

    def check(self, where):
        for f in self.tstate._fields:
            assert_tree_equal(getattr(self.jstate, f),
                              getattr(self.tstate, f), f"{where}.{f}")
        assert (convert.coordinator_state(self.tco)
                == convert.coordinator_state(self.jco)), where

    def cp(self, name, *args, **kw):
        """One control-plane call on both sides; a state argument is
        passed as ``state`` and the returned states replace them."""
        jout = getattr(self.jco, name)(*args, **kw)
        tout = getattr(self.tco, name)(*args, **kw)
        return jout, tout

    def publish(self, what="roles"):
        install = f"install_{what}"
        self.jstate = getattr(self.jco, install)(self.jstate)
        self.tstate = getattr(self.tco, install)(self.tstate)

    def advance(self, fields, t, refresh=True):
        """Route tick ``t`` of the stream through each side's client map
        (the live map when ``refresh``) and tick both engines."""
        if refresh or self.jclient is None:
            self.jclient = self.jco.partition_map()
            self.tclient = self.tco.partition_map()
        row = {k: v[t:t + 1] for k, v in fields.items()}
        jr = j_route(self.jcl, j_types.Msg(**{
            k: jnp.asarray(v) for k, v in row.items()}), 4,
            pmap=self.jclient, live_pmap=self.jco.partition_map())
        tr = route_stream(self.tcl, Msg(**{
            k: torch.from_numpy(np.array(v)) for k, v in row.items()}), 4,
            pmap=self.tclient, live_pmap=self.tco.partition_map())
        for f in ("dropped", "out_of_range", "stale"):
            assert int(getattr(tr, f)) == int(getattr(jr, f)), (t, f)
        before = self.tstate.metrics.write_nacks.clone()
        self.jstate = self.jsim.tick(
            self.jstate, jax.tree.map(lambda x: x[0], jr.lanes))
        self.tstate = self.tsim.tick(
            self.tstate, tree_map(lambda x: x[0], tr.lanes))
        self.nacks.append((self.tstate.metrics.write_nacks - before).tolist())
        self.check(f"tick {t}")

    def drain(self, ticks):
        for i in range(ticks):
            self.jstate = self.jsim.tick(self.jstate,
                                         self.jsim.empty_injection())
            self.tstate = self.tsim.tick(self.tstate,
                                         self.tsim.empty_injection())
            self.check(f"drain {i}")


def _hottest(jcl, fields, upto, k=2):
    b = np.asarray(jcl.bucket_of(fields["key"][:upto].ravel()))
    counts = np.bincount(b, minlength=jcl.num_buckets)
    return sorted(range(jcl.buckets_per_chain), key=lambda x: -counts[x])[:k]


def test_live_rebalance_matches_reference_tick_by_tick(engines):
    """Two bucket migrations off the hot chain under live traffic, each
    with six frozen drain ticks and one stale-client tick after publish."""
    p = _Pair(engines)
    fields = _stream(p.jcl, seed=3)
    moves = dict(zip(_hottest(p.jcl, fields, 4), (1, 2)))
    plan = {4: "begin", 10: "complete", 12: "begin", 18: "complete"}
    it = iter(moves.items())
    stale_tick = False
    for t in range(TICKS):
        p.advance(fields, t, refresh=not stale_tick)
        stale_tick = False
        if plan.get(t) == "begin":
            bucket, dst = next(it)
            assert p.cp("begin_rebalance", bucket, dst) == ((0, dst), (0, dst))
            p.publish("roles")
        elif plan.get(t) == "complete":
            p.jstate = p.jco.complete_rebalance(p.jstate)
            p.tstate = p.tco.complete_rebalance(p.tstate)
            stale_tick = True
        p.check(f"after tick {t} control plane")
    p.drain(10)
    pc = p.tstate.metrics.per_chain()
    assert pc == p.jstate.metrics.per_chain()
    assert pc["migration_moves"] == [2, 1, 1, 0]
    assert pc["stale_routes"][0] > 0 and sum(pc["drops"]) == 0
    frozen = {t for a, b in ((4, 10), (12, 18)) for t in range(a + 1, b + 1)}
    nack_ticks = {t for t, row in enumerate(p.nacks) if any(row)}
    assert nack_ticks and nack_ticks <= frozen, nack_ticks
    assert (t_txn.committed_view(p.tcl, p.tstate)
            == j_committed_view(p.jcl, p.jstate))
    for b, dst in moves.items():
        assert p.tco.bucket_placement(b)[0] == dst
    assert p.tco.partition_epoch == 2


def test_fail_and_recover_match_reference_tick_by_tick(engines):
    """A node of the hot chain fails under traffic, the chain is frozen
    for the copy window, then the replacement copies its CRAQ source and
    is spliced back in: both engines and both control planes agree after
    every tick."""
    p = _Pair(engines)
    fields = _stream(p.jcl, seed=4)
    for t in range(TICKS):
        if t == 3:
            p.cp("fail_node", 0, 1)
            p.publish("roles")
        if t == 12:
            p.cp("begin_recovery", 0)
            p.publish("roles")
        if t == 16:
            src = p.tco.recovery_source(0, 1)
            assert src == p.jco.recovery_source(0, 1) == 0
            jm, jst = p.jco.complete_recovery(0, 1, 1, p.jstate.stores,
                                              locks=p.jstate.locks)
            tm, tst = p.tco.complete_recovery(0, 1, 1, p.tstate.stores,
                                              locks=p.tstate.locks)
            assert tm == convert.memberships_from([jm])[0]
            p.jstate = p.jco.install_roles(p.jstate._replace(stores=jst))
            p.tstate = p.tco.install_roles(p.tstate._replace(stores=tst))
            for x in p.tstate.stores:
                assert torch.equal(x[0, 1], x[0, src])
        p.advance(fields, t)
    p.drain(10)
    pc = p.tstate.metrics.per_chain()
    assert pc == p.jstate.metrics.per_chain()
    assert pc["drops"][0] > 0 and pc["write_nacks"][0] > 0
    nack_ticks = {t for t, row in enumerate(p.nacks) if any(row)}
    assert nack_ticks and nack_ticks <= set(range(12, 16)), nack_ticks
    assert [e["event"] for e in p.tco.recovery_log] == ["fail", "recover"]
    vals = p.tstate.stores.values[..., 0, 0]
    assert torch.equal(vals, vals[:, -1:].expand_as(vals))


def test_control_plane_carried_across_mid_lifecycle(engines):
    """A reference control plane with an open migration, a failed node
    and a moved bucket, carried to the port with its running state, goes
    on exactly as the reference does."""
    jcl, jsim, tcl = engines
    jco = JCoordinator(jcl)
    jstate = jsim.init_state()
    jstate = jco.rebalance(jstate, 5, 3)
    jco.fail_node(2, 1)
    jco.begin_rebalance(0, 1)
    jstate = jco.install_roles(jstate)
    tco = convert.coordinator_from(jco, CPU)
    tstate = convert.state_from_arrays(jstate, CPU)
    assert convert.coordinator_state(tco) == convert.coordinator_state(jco)
    assert tco.key_to_chain(20) == jco.key_to_chain(20)
    jstate = jco.complete_rebalance(jstate)
    tstate = tco.complete_rebalance(tstate)
    jm, jst = jco.recover_node(2, 1, 1, jstate.stores)
    tm, tst = tco.recover_node(2, 1, 1, tstate.stores)
    jstate = jco.install_roles(jstate._replace(stores=jst))
    tstate = tco.install_roles(tstate._replace(stores=tst))
    assert convert.coordinator_state(tco) == convert.coordinator_state(jco)
    for f in tstate._fields:
        assert_tree_equal(getattr(jstate, f), getattr(tstate, f), f)
    assert tco.partition_epoch == 2 and tco.bucket_placement(0)[0] == 1


# ---------------------------------------------------------------------------
# behaviours, on the port alone (torch forms of the reference's tests)
# ---------------------------------------------------------------------------
def _cluster(C=2, num_keys=12, spare=4, bpc=2, n_nodes=3):
    return ClusterConfig(
        chain=ChainConfig(n_nodes=n_nodes, num_keys=num_keys,
                          num_versions=4),
        n_chains=C, buckets_per_chain=bpc, spare_keys=spare)


def _sim(cl, reply_capacity=512):
    return ChainSim(cl, inject_capacity=4, route_capacity=64,
                    reply_capacity=reply_capacity, device=CPU)


def _inject_one(sim, op, slot, val, node, chain, qid, ver=0):
    m = sim.empty_injection()
    at = (chain, node, 0)
    m.op[at], m.key[at], m.value[at + (0,)] = op, slot, val
    m.src[at] = m.client[at] = CLIENT_BASE + 1
    m.dst[at], m.qid[at], m.ver[at] = node, qid, ver
    return m


def _drain(sim, state, ticks):
    return sim.drain(state, ticks)


def _replies(state):
    r = state.replies.merged()
    return {int(q): (int(op), int(v), int(s))
            for q, op, v, s in zip(r.qid, r.op, r.value0, r.seq)}


def test_live_migration_moves_bucket_and_redirects_stale_clients():
    cl = _cluster(C=2, num_keys=8, spare=4, bpc=2, n_nodes=3)  # bsz=2
    co, sim = Coordinator(cl, device=CPU), _sim(cl)
    state = sim.init_state()
    state = sim.tick(state, _inject_one(sim, OP_WRITE, 0, 777, 0, 0, qid=1))
    state = sim.tick(state, _inject_one(sim, OP_WRITE, 0, 888, 0, 1, qid=2))
    state = _drain(sim, state, 8)
    assert int(state.stores.pending.sum()) == 0

    assert co.begin_rebalance(0, 1) == (0, 1)
    state = _drain(sim, co.install_roles(state), 2)
    state = co.complete_rebalance(state)
    assert co.partition_epoch == 1
    assert co.bucket_placement(0) == (1, cl.keys_in_use)
    assert co.key_to_chain(0) == 1 and co.local_key(0) == cl.keys_in_use

    # a fresh client reads g=0 at its new home; the unmoved g=1 still
    # serves a stale client; stale or free-slot targets NACK
    state = sim.tick(state, _inject_one(sim, OP_READ, cl.keys_in_use, 0, 2,
                                        1, qid=3, ver=1))
    state = sim.tick(state, _inject_one(sim, OP_READ, 0, 0, 1, 1, qid=4))
    state = _drain(sim, state, 6)
    state = sim.tick(state, _inject_one(sim, OP_READ, 0, 0, 1, 0, qid=5))
    state = sim.tick(state, _inject_one(sim, OP_READ, 0, 0, 1, 0, qid=6,
                                        ver=1))
    state = _drain(sim, state, 6)
    recs = _replies(state)
    assert recs[3][:2] == (OP_READ_REPLY, 777)
    assert recs[4][:2] == (OP_READ_REPLY, 888)
    assert recs[5][0] == OP_STALE_NACK and recs[6][0] == OP_STALE_NACK
    assert state.metrics.asdict()["stale_routes"] == 2
    assert state.metrics.per_chain()["migration_moves"] == [1, 1]
    assert int(cl.global_key(torch.tensor(0), torch.tensor(0),
                             state.pmap)) == -1
    assert int(state.stores.values[0, :, 0:2].abs().sum()) == 0


def test_migration_freeze_nacks_writes_and_preserves_reads():
    cl = _cluster(C=2, num_keys=8, spare=4, bpc=1, n_nodes=3)
    co, sim = Coordinator(cl, device=CPU), _sim(cl)
    state = sim.init_state()
    state = sim.tick(state, _inject_one(sim, OP_WRITE, 2, 111, 0, 0, qid=1))
    state = _drain(sim, state, 8)
    co.begin_rebalance(0, 1)
    state = co.install_roles(state)
    state = sim.tick(state, _inject_one(sim, OP_WRITE, 3, 222, 0, 0, qid=2))
    state = sim.tick(state, _inject_one(sim, OP_READ, 2, 0, 1, 0, qid=3))
    state = _drain(sim, state, 6)
    recs = _replies(state)
    assert recs[2][0] == OP_WRITE_NACK
    assert recs[3][:2] == (OP_READ_REPLY, 111)
    state = co.complete_rebalance(state)
    base = co.bucket_placement(0)[1]
    assert int(state.stores.values[1, -1, base + 2, 0, 0]) == 111
    assert int((state.stores.values[..., 0] == 222).sum()) == 0


def test_rebalance_and_recovery_guard_rails():
    with pytest.raises(AssertionError, match="free landing region"):
        Coordinator(_cluster(spare=0, num_keys=8), device=CPU
                    ).begin_rebalance(0, 1)
    cl = _cluster(C=2, num_keys=8, spare=4, bpc=2, n_nodes=3)
    co, sim = Coordinator(cl, device=CPU), _sim(cl, 128)
    state = sim.init_state()
    with pytest.raises(AssertionError, match="no migration"):
        co.complete_rebalance(state)
    co.begin_rebalance(0, 1)
    with pytest.raises(AssertionError, match="still open"):
        co.begin_rebalance(1, 1)
    # recovery and migration share the freeze flag: no overlap
    with pytest.raises(AssertionError, match="migration"):
        co.begin_recovery(0)
    locked = state._replace(locks=state.locks._replace(
        holder=state.locks.holder.clone()))
    locked.locks.holder[0, 1] = 9
    with pytest.raises(AssertionError, match="locks"):
        co.complete_rebalance(locked)
    dirty = sim.init_state()
    dirty.stores.pending[0, 1, 0] = 1
    with pytest.raises(AssertionError, match="dirty"):
        co.complete_rebalance(dirty)
    state = co.complete_rebalance(state)
    assert co.partition_epoch == 1 and not co.chains[0].writes_frozen
    co.begin_recovery(0)
    assert co.chains[0].writes_frozen
    with pytest.raises(AssertionError, match="frozen"):
        co.begin_rebalance(1, 1)
    with pytest.raises(AssertionError, match="outside the key space"):
        co.key_to_chain(cl.num_global_keys)
    # a recovery copy waits for the lock table to drain
    co.fail_node(1, 1)
    co.begin_recovery(1)
    held = state.locks._replace(holder=state.locks.holder.clone())
    held.holder[1, 3] = 4
    with pytest.raises(AssertionError, match="locks"):
        co.complete_recovery(1, 1, 1, state.stores, locks=held)


def test_migration_carries_lock_version_column():
    cl = _cluster(C=2, num_keys=8, spare=4, bpc=2, n_nodes=3)
    co, sim = Coordinator(cl, device=CPU), _sim(cl, 128)
    state = sim.init_state()
    state.locks.version[0, 0], state.locks.version[0, 1] = 7, 5
    co.begin_rebalance(0, 1)
    state = co.complete_rebalance(co.install_roles(state))
    base = co.bucket_placement(0)[1]
    v = state.locks.version
    assert int(v[1, base]) == 7 and int(v[1, base + 1]) == 5
    assert int(v[0, 0]) == 0 and int(v[0, 1]) == 0


def test_writes_rejected_exactly_while_frozen():
    cl = _cluster(C=1, num_keys=16, spare=0, bpc=1, n_nodes=4)
    co, sim = Coordinator(cl, device=CPU), _sim(cl)
    state = sim.init_state()
    state = sim.tick(state, _inject_one(sim, OP_WRITE, 1, 100, 0, 0, qid=1))
    state = _drain(sim, state, 8)
    co.fail_node(0, 2)
    state = co.install_roles(state)
    co.begin_recovery(0)
    state = co.install_roles(state)
    state = sim.tick(state, _inject_one(sim, OP_WRITE, 1, 200, 0, 0, qid=2))
    state = sim.tick(state, _inject_one(sim, OP_READ, 1, 0, 3, 0, qid=3))
    state = _drain(sim, state, 6)
    recs = _replies(state)
    assert recs[2][0] == OP_WRITE_NACK and recs[2][2] == -1
    assert recs[3][:2] == (OP_READ_REPLY, 100)
    assert state.metrics.asdict()["write_nacks"] == 1
    assert state.stores.values[0, :, 1, 0, 0].tolist() == [100] * 4
    _, stores = co.complete_recovery(0, new_node_id=2, position=2,
                                     stores=state.stores)
    state = co.install_roles(state._replace(stores=stores))
    assert not co.chains[0].writes_frozen
    state = sim.tick(state, _inject_one(sim, OP_WRITE, 1, 300, 0, 0, qid=4))
    state = _drain(sim, state, 8)
    assert _replies(state)[4][0] == OP_WRITE_REPLY
    assert state.metrics.asdict()["write_nacks"] == 1
    assert state.stores.values[0, :, 1, 0, 0].tolist() == [300] * 4


def test_recovered_node_serves_reads_consistent_with_copy_source():
    cl = _cluster(C=1, num_keys=16, spare=0, bpc=1, n_nodes=4)
    co, sim = Coordinator(cl, device=CPU), _sim(cl)
    state = sim.init_state()
    state = sim.tick(state, _inject_one(sim, OP_WRITE, 7, 111, 0, 0, qid=1))
    state = _drain(sim, state, 8)
    co.fail_node(0, 1)
    state = co.install_roles(state)
    state = sim.tick(state, _inject_one(sim, OP_WRITE, 7, 222, 0, 0, qid=2))
    state = _drain(sim, state, 8)
    co.begin_recovery(0)
    state = _drain(sim, co.install_roles(state), 2)
    _, stores = co.complete_recovery(0, new_node_id=1, position=1,
                                     stores=state.stores)
    state = co.install_roles(state._replace(stores=stores))
    assert torch.equal(state.stores.values[0, 1], state.stores.values[0, 0])
    state = sim.tick(state, _inject_one(sim, OP_READ, 7, 0, 1, 0, qid=5))
    state = _drain(sim, state, 6)
    assert _replies(state)[5][:2] == (OP_READ_REPLY, 222)


def test_untouched_chains_bit_identical_to_undisturbed_run():
    """Fail and recover a node of chain 1 mid-schedule: chains 0 and 2
    match a run that never saw it (each run from its own state)."""
    from repro_torch.core.workload import WorkloadConfig, make_schedule
    cl = ClusterConfig(chain=ChainConfig(n_nodes=4, num_keys=8,
                                         num_versions=4), n_chains=3)
    wl = WorkloadConfig(ticks=6, queries_per_tick=4, write_fraction=0.25,
                        seed=7)
    sched = make_schedule(cl, wl, device=CPU)

    def run(disturb):
        co, sim = Coordinator(cl, device=CPU), _sim(cl, 2048)
        state = sim.init_state()
        for t in range(wl.ticks):
            if disturb and t == 2:
                co.fail_node(1, 2)
                state = co.install_roles(state)
            if disturb and t == 4:
                co.begin_recovery(1)
                state = co.install_roles(state)
            if disturb and t == 5:
                _, stores = co.complete_recovery(1, 2, 2, state.stores)
                state = co.install_roles(state._replace(stores=stores))
            state = sim.tick(state, tree_map(lambda x: x[t], sched))
        return _drain(sim, state, 12)

    disturbed, calm = run(True), run(False)
    for c in (0, 2):
        for name in ("replies", "stores", "metrics"):
            for a, b in zip(getattr(disturbed, name), getattr(calm, name)):
                assert torch.equal(a[c], b[c]), (c, name)
    assert disturbed.metrics.per_chain()["drops"][1] > 0


# ---------------------------------------------------------------------------
# failure handling: policy, detector, recovery copy
# ---------------------------------------------------------------------------
def test_redirect_matches_reference_and_spreads():
    jco = JCoordinator(JChain(n_nodes=4, num_keys=16))
    co = Coordinator(ChainConfig(n_nodes=4, num_keys=16), device=CPU)
    jm, m = jco.fail_node(0, 2), co.fail_node(0, 2)
    assert m.node_ids == jm.node_ids == [0, 1, 3] and m.epoch == 1
    hits = {i: 0 for i in m.node_ids}
    for client in range(32):
        for key in range(16):
            got = co.failover.redirect(m, dead=2, client=client, key=key)
            assert got == jco.failover.redirect(jm, 2, client, key)
            hits[got] += 1
    assert all(v > 0 for v in hits.values()), hits
    assert {co.failover.redirect(m, 2, 0, k) for k in range(64)} == {0, 1, 3}


_DETECTOR_SCRIPTS = {
    # (method, args) sequences replayed on both detectors
    "heartbeat": [("tick", ()), ("heard_from", (0,)), ("heard_from", (1,)),
                  ("tick", ()), ("heard_from", (0,)), ("heard_from", (1,)),
                  ("tick", ()), ("heard_from", (0,)), ("heard_from", (1,)),
                  ("calibrate", (5.0, 4.0))],
    "fresh_id": [("untrack", (1,)), ("untrack", (1,))] + [("tick", ())] * 5
    + [("track", (7,))] + [("tick", ())] * 3,
    "reply_timeout": [("tick", ()), ("tick", ()), ("tick", ()),
                      ("heard_from", (0,)), ("note_sent", (1, 42)),
                      ("tick", ()), ("tick", ()), ("tick", ()),
                      ("note_reply", (42,)), ("note_sent", (2, 43)),
                      ("untrack", (2,))],
}


@pytest.mark.parametrize("script", sorted(_DETECTOR_SCRIPTS))
def test_failure_detector_matches_reference(script):
    """Every probe answers as the reference's after every call: the
    heartbeat timeout and calibration, a spliced-in fresh id, and the
    reply-timeout mode with a node never sent to."""
    det = FailureDetector(n_nodes=3, timeout_ticks=2)
    ref = JDetector(n_nodes=3, timeout_ticks=2)
    probes = lambda d: (d.suspected(), d.overdue(), d.timeout_ticks,
                        [d.is_alive(i) for i in (0, 1, 2, 7, 99)])
    seen = []
    for name, args in _DETECTOR_SCRIPTS[script]:
        getattr(det, name)(*args)
        getattr(ref, name)(*args)
        assert probes(det) == probes(ref), (name, args)
        seen.append((det.suspected(), det.overdue()))
    if script == "heartbeat":
        assert ([2], [2]) in seen and det.timeout_ticks == 20
    if script == "fresh_id":
        assert 7 in det.suspected() and 1 not in det.suspected()
    if script == "reply_timeout":
        assert ([0, 1, 2], [1, 2]) in seen and det.overdue() == []


def test_hedged_reads_follow_positions():
    co = Coordinator(ChainConfig(n_nodes=4, num_keys=16), device=CPU)
    co.fail_node(0, 1)
    stores = init_store(co.cfg, (1, 4), device=CPU)
    m, _ = co.recover_node(0, new_node_id=1, position=3, stores=stores)
    assert m.node_ids == [0, 2, 3, 1]
    pol, ref = HedgedReadPolicy(fanout=2), JHedged(fanout=2)
    for entry in range(4):
        assert pol.targets(entry, m) == ref.targets(entry, m)
    assert pol.targets(entry=0, membership=m) == [0, 2]
    assert pol.targets(entry=3, membership=m) == [1, 3]


@pytest.mark.parametrize("form", ["cluster", "chain"])
def test_recovery_copies_from_predecessor(form):
    """Both store forms: the cluster's ``[C, n, ...]`` (only the chain's
    slice changes) and one chain's ``[n, ...]``.  The copy is made in
    place and equals the reference's."""
    cfg = ChainConfig(n_nodes=4, num_keys=16)
    shape = (2, 4) if form == "cluster" else (4,)
    rng = np.random.default_rng(5)
    base = init_store(cfg, shape, device=CPU)
    arrays = [rng.integers(-1, 50, tuple(x.shape)).astype(np.int32)
              for x in base]
    stores = Store(*[torch.from_numpy(a.copy()) for a in arrays])
    jco = JCoordinator(JChain(n_nodes=4, num_keys=16), n_chains=2)
    co = Coordinator(cfg, 2, device=CPU)
    for c in (jco, co):
        c.fail_node(1 if form == "cluster" else 0, 2)
    chain = 1 if form == "cluster" else 0
    jm, jcopied = jco.recover_node(
        chain, 2, 2, JStore(*[jnp.asarray(a) for a in arrays]))
    m, copied = co.recover_node(chain, 2, 2, stores)
    assert copied is stores
    assert m == convert.memberships_from([jm])[0]
    assert m.node_ids == [0, 1, 2, 3] and m.epoch == 2
    assert not m.writes_frozen
    for g, e in zip(copied, jcopied):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    assert co.detectors[chain].is_alive(2)
    assert [e["event"] for e in co.recovery_log] == ["fail", "recover"]


def test_recover_rejects_id_without_store_slot():
    co = Coordinator(ChainConfig(n_nodes=4, num_keys=16), device=CPU)
    stores = init_store(co.cfg, (1, 4), device=CPU)
    co.fail_node(0, 2)
    assert not co.detectors[0].is_alive(2)
    with pytest.raises(AssertionError, match="physical store slot"):
        co.recover_node(0, new_node_id=7, position=2, stores=stores)
    assert not co.chains[0].writes_frozen
    assert co.chains[0].node_ids == [0, 1, 3]


def test_consistency_preserved_across_recovery():
    from repro_torch.core.workload import WorkloadConfig, make_schedule
    cfg = ChainConfig(n_nodes=4, num_keys=8)
    co = Coordinator(cfg, device=CPU)
    sim = ChainSim(cfg, inject_capacity=4, route_capacity=64, device=CPU)
    wl = WorkloadConfig(ticks=2, queries_per_tick=2, write_fraction=1.0,
                        seed=3)
    state = sim.run(sim.init_state(), make_schedule(cfg, wl, device=CPU),
                    extra_ticks=12)
    assert int(state.stores.pending.sum()) == 0
    committed = state.stores.values[0, -1, :, 0, 0].clone()
    co.fail_node(0, 1)
    _, recovered = co.recover_node(0, 1, 1, state.stores)
    assert torch.equal(recovered.values[0, 1, :, 0, 0], committed)


# ---------------------------------------------------------------------------
# host helpers and entry points
# ---------------------------------------------------------------------------
def test_host_put_get_and_lock_probes_match_reference():
    cfg = ChainConfig(n_nodes=4, num_keys=16)
    jstore = j_init_store(JChain(n_nodes=4, num_keys=16))
    tstore = init_store(cfg, (), device=CPU)
    for key, val in ((3, 30), (3, 31), (9, 90)):
        jstore = JCoordinator.put_host(jstore, key, val)
        tstore = Coordinator.put_host(tstore, key, val)
    for f in tstore._fields:
        np.testing.assert_array_equal(getattr(tstore, f).numpy(),
                                      np.asarray(getattr(jstore, f)))
    assert Coordinator.get_host(tstore, 3) == 31
    assert value_from_int(5).tolist() == [5, 0, 0, 0]
    sim = _sim(_cluster())
    state = sim.init_state()
    assert Coordinator.locks_drained(state)
    state.locks.holder[1, 2] = 8
    assert not Coordinator.locks_drained(state)
    assert Coordinator.locks_drained(state, chain_idx=0)
    assert Coordinator.leaked_locks(state) == 1
    assert Coordinator.leaked_locks(state, chain_idx=0) == 0
    state = Coordinator.set_lease(state, 16)
    assert state.locks.lease_ticks.tolist() == [16, 16]


def test_wave_entry_points_and_device_default():
    co = Coordinator(_cluster(), device=CPU)
    planner = co.txn_planner
    assert planner is co.txn_planner and planner.device.type == "cpu"
    state = ChainSim(_cluster(), wave_depth=2, device=CPU).init_state()
    assert Coordinator.waves_drained(state)
    state.wave.phase[1, 0] = t_txn.WAVE_PREP
    assert not Coordinator.waves_drained(state)
    assert Coordinator.waves_drained(state, chain_idx=0)
    assert Coordinator.waves_drained(_sim(_cluster()).init_state())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Coordinator(_cluster())
    assert co.partition_map().owner.device.type == "cpu"
