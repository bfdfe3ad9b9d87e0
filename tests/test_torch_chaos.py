"""The port's declarative chaos suite (``repro_torch.core.chaos``) on the
CPU: torch twins of every test of ``tests/test_chaos.py`` at its tiny
cluster, then parity with ``repro.core.chaos.run_scenario``.

* A scenario with all four event kinds (fail, migrate, lease, recover)
  over 48 ticks runs through both packages with the same seed and knobs:
  final stores, locks, metrics, reply logs, telemetry and the generator
  backlog are equal, and so are the report's samples, leaked locks,
  extra ticks, drain flag and serial keys; the port's oracle dict equals
  the reference's ``serial_reference``.
* The ``LEASE_OFF`` arm (``check=False``) leaks exactly the reference's
  locks.
* A ``complete_rebalance`` probe that fails (a held lock, a dirty
  version, a message in flight on the slice) leaves the stores, locks
  and control plane as they were: ``run_scenario`` probes it every
  frozen segment.

The reference's engine is one module-scoped ``ChainSim``: its open-loop
segment compiles once for the whole file.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import chaos as j_chaos  # noqa: E402
from repro.core import loadgen as j_loadgen  # noqa: E402
from repro.core import types as j_types  # noqa: E402
from repro.core.chain import ChainSim as JSim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import chaos as t_chaos  # noqa: E402
from repro_torch.core import loadgen as t_loadgen  # noqa: E402
from repro_torch.core import types as t_types  # noqa: E402
from repro_torch.core.chain import ChainSim as TSim  # noqa: E402
from repro_torch.core.coordinator import Coordinator  # noqa: E402
from repro_torch.core.types import LEASE_OFF, OP_PREPARE, OP_WRITE  # noqa: E402
from torch_parity import CPU, assert_tree_equal  # noqa: E402

SEG = 8
CLUSTER = dict(n_chains=2, buckets_per_chain=2, spare_keys=2)
CHAIN = dict(n_nodes=3, num_keys=6, num_versions=6)
SIM = dict(inject_capacity=8, route_capacity=128, reply_capacity=8192)
# the parity scenario's knobs
GEN = dict(qps=4.0, seed=3, backlog_capacity=64, write_fraction=0.3,
           txn_fraction=0.2, abandon_fraction=0.25)
LEASE = 8


def _cluster(t=t_types):
    return t.ClusterConfig(chain=t.ChainConfig(**CHAIN), **CLUSTER)


@pytest.fixture(scope="module")
def engine():
    """The port's engine of ``tests/test_chaos.py``'s cluster."""
    cl = _cluster()
    return cl, TSim(cl, device=CPU, **SIM)


@pytest.fixture(scope="module")
def jengine():
    """The reference's engine (telemetry on, as test_chaos.py's)."""
    cl = _cluster(j_types)
    return cl, JSim(cl, **SIM)


def _gen(cluster, **kw):
    kw.setdefault("write_fraction", 0.3)
    kw.setdefault("txn_fraction", 0.2)
    return t_loadgen.make_loadgen(cluster, qps=4.0, seed=3,
                                  backlog_capacity=64, device=CPU, **kw)


# -- twins of tests/test_chaos.py ---------------------------------------------
def test_control_cell_drains_with_abandonment_under_finite_lease(engine):
    cluster, sim = engine
    g = _gen(cluster, abandon_fraction=0.25)
    _, _, rep = t_chaos.run_scenario(sim, g, t_chaos.none_scenario(32, SEG),
                                     lease_ticks=8)
    assert rep["drained"] and rep["leaked_locks"] == 0
    assert rep["serial_keys"] > 0
    assert rep["metrics"]["lease_expiries"] > 0


def test_lease_off_leaks_what_a_finite_lease_reclaims(engine):
    cluster, sim = engine
    off_gen = _gen(cluster, abandon_fraction=0.3)
    _, _, off = t_chaos.run_scenario(sim, off_gen,
                                     t_chaos.none_scenario(32, SEG),
                                     lease_ticks=LEASE_OFF, check=False)
    assert off["leaked_locks"] > 0, "abandonment never stranded a lock"
    assert off["metrics"]["lease_expiries"] == 0
    fin_gen = _gen(cluster, abandon_fraction=0.3)
    _, _, fin = t_chaos.run_scenario(sim, fin_gen,
                                     t_chaos.none_scenario(32, SEG),
                                     lease_ticks=8)
    assert fin["leaked_locks"] == 0
    assert fin["metrics"]["lease_expiries"] >= off["leaked_locks"]


def test_disturbance_cells_share_one_compiled_scan(engine):
    """The port's form of zero recompiles: after a warm cell no scenario
    loads another kernel library; the disturbances drain clean and the
    moves meet the stale-route gate."""
    cluster, sim = engine
    g = _gen(cluster, abandon_fraction=0.1)
    _, g, rep0 = t_chaos.run_scenario(sim, g,
                                      t_chaos.none_scenario(2 * SEG, SEG),
                                      lease_ticks=8)
    for scenario in (
        t_chaos.failure_storm(cluster.n_chains, 48, SEG, node=1),
        t_chaos.migration_wave([(0, 1)], 32, SEG),
        t_chaos.stale_clients(0, 1, 32, SEG),
    ):
        g = t_loadgen.reset(g)._replace(
            qps=torch.tensor(4.0, dtype=torch.float32))
        _, g, rep = t_chaos.run_scenario(sim, g, scenario, lease_ticks=8)
        assert rep["drained"] and rep["leaked_locks"] == 0, scenario.name
        deltas = {k: a - b for k, (b, a) in rep["cache_sizes"].items()}
        assert deltas and all(d == 0 for d in deltas.values()), (
            f"{scenario.name} loaded a library: {rep['cache_sizes']}")
        if scenario.name in ("migration_wave", "stale_clients"):
            assert rep["metrics"]["stale_routes"] > 0, scenario.name


def test_scenarios_are_validated_data():
    mid_fail = t_chaos.ChaosEvent(tick=5, kind="fail", chain=0, node=1)
    with pytest.raises(AssertionError):
        t_chaos.ChaosScenario("off_boundary", (mid_fail,), 32, 8)
    with pytest.raises(AssertionError):
        t_chaos.ChaosScenario("ragged", (), 30, 8)
    with pytest.raises(AssertionError):
        t_chaos.ChaosScenario("unsorted", (
            t_chaos.ChaosEvent(tick=16, kind="fail", chain=0, node=1),
            t_chaos.ChaosEvent(tick=8, kind="fail", chain=1, node=1),
        ), 32, 8)


def test_unknown_event_kind_is_rejected_not_executed(engine):
    cluster, sim = engine
    bad = t_chaos.ChaosScenario("bad_kind", (
        t_chaos.ChaosEvent(tick=0, kind="frobnicate"),), 8, 8)
    with pytest.raises(ValueError, match="frobnicate"):
        t_chaos.run_scenario(sim, _gen(cluster), bad, lease_ticks=8)


# -- parity with the reference --------------------------------------------------
def mixed_scenario(chaos, moved=(2, 0), total_ticks=48):
    """All four event kinds: chain 0 loses node 1, a bucket moves
    (default: bucket 2 from chain 1 onto chain 0, dead node included),
    the lease is retuned, and node 1 is spliced back."""
    E = chaos.ChaosEvent
    return chaos.ChaosScenario("mixed", (
        E(tick=8, kind="fail", chain=0, node=1),
        E(tick=16, kind="migrate", bucket=moved[0], dst_chain=moved[1]),
        E(tick=24, kind="lease", lease_ticks=12),
        E(tick=32, kind="recover", chain=0, node=1, position=1),
    ), total_ticks, SEG)


def _parity_pair(jengine, engine, lease, check, scenario=mixed_scenario,
                 **knobs):
    (jcl, jsim), (tcl, tsim) = jengine, engine
    kw = {**GEN, **knobs}
    scen = (scenario(j_chaos), scenario(t_chaos))
    jstate, jgen, jrep = j_chaos.run_scenario(
        jsim, j_loadgen.make_loadgen(jcl, **kw), scen[0], lease_ticks=lease,
        check=check)
    tstate, tgen, trep = t_chaos.run_scenario(
        tsim, t_loadgen.make_loadgen(tcl, device=CPU, **kw), scen[1],
        lease_ticks=lease, check=check)
    return (jstate, jgen, jrep), (tstate, tgen, trep), kw


def test_mixed_scenario_matches_reference_exactly(jengine, engine):
    (jstate, jgen, jrep), (tstate, tgen, trep), kw = _parity_pair(
        jengine, engine, LEASE, True)
    for f in ("stores", "locks", "metrics", "replies", "telemetry", "inbox",
              "roles", "pmap", "t"):
        assert_tree_equal(getattr(jstate, f), getattr(tstate, f), f)
    assert_tree_equal(jgen.backlog, tgen.backlog, "backlog")
    for k in ("name", "samples", "metrics", "leaked_locks", "extra_ticks",
              "drained", "serial_keys"):
        assert trep[k] == jrep[k], (k, trep[k], jrep[k])
    assert trep["extra_ticks"] > 0 and trep["serial_keys"] > 0
    assert trep["metrics"]["lease_expiries"] > 0
    assert trep["metrics"]["stale_routes"] > 0
    # the oracle dicts over the run's whole offered stream
    (jcl, jsim), (tcl, tsim) = jengine, engine
    ticks = 48 + trep["extra_ticks"]
    width = tsim.C * tsim.n * tsim.c_in
    exp = j_chaos.serial_reference(jsim, jstate,
                                   j_loadgen.make_loadgen(jcl, **kw),
                                   width, ticks)
    got = t_chaos.serial_reference(
        tsim, tstate, t_loadgen.make_loadgen(tcl, device=CPU, **kw), width,
        ticks)
    assert got == exp and len(got) == trep["serial_keys"]


def test_lease_off_arm_leaks_exactly_the_reference_locks(jengine, engine):
    """fig_chaos's lease arm: no disturbance (an abandoned lock would
    block a move or a recovery forever), nothing reclaimed."""
    (jstate, _, jrep), (tstate, _, trep), _ = _parity_pair(
        jengine, engine, LEASE_OFF, False,
        scenario=lambda chaos: chaos.none_scenario(48, SEG))
    assert trep["leaked_locks"] == jrep["leaked_locks"] > 0
    assert trep["metrics"]["lease_expiries"] == 0
    assert trep["samples"] == jrep["samples"]
    assert trep["metrics"] == jrep["metrics"]
    assert_tree_equal(jstate.locks, tstate.locks, "locks")


def test_move_off_a_chain_with_a_failed_node_diverges_as_the_reference(
        jengine, engine):
    """A fault of the reference that the port keeps: ``complete_rebalance``
    copies the bucket's slice of every physical node, a failed one's
    too, so moving a bucket off chain 0 while its node 1 is down lands
    node 1's stale slice on chain 1's live node 1.  Both packages end in
    the same state and both refuse it as unconverged."""
    scen = lambda chaos: mixed_scenario(chaos, moved=(0, 1))
    (jstate, _, jrep), (tstate, _, trep), _ = _parity_pair(
        jengine, engine, LEASE, False, scenario=scen)
    for f in ("stores", "locks", "metrics", "replies"):
        assert_tree_equal(getattr(jstate, f), getattr(tstate, f), f)
    assert trep["samples"] == jrep["samples"] and trep["drained"]
    co = Coordinator(engine[0], device=CPU)   # every node live again
    with pytest.raises(AssertionError, match="chain 1: node 1 diverged"):
        t_chaos.check_replicas_converged(engine[1], tstate, co)


# -- the rebalance probe --------------------------------------------------------
def _ops(sim, *ops):
    """A [C, n, c_in] injection of (chain, op, local key, txn id) client
    ops at the head."""
    inj = sim.empty_injection()
    for i, (c, op, key, txn) in enumerate(ops):
        at = (c, 0, i)
        inj.op[at], inj.key[at], inj.seq[at] = op, key, txn
        inj.value[at + (0,)] = 100 + i
        inj.src[at] = inj.client[at] = t_types.CLIENT_BASE + 1
        inj.dst[at], inj.qid[at] = 0, 50 + i
    return inj


@pytest.mark.parametrize("cause", ["held lock", "dirty version",
                                   "message in flight"])
def test_failed_rebalance_probe_leaves_state_bit_identical(engine, cause):
    cluster, sim = engine
    co = Coordinator(cluster, device=CPU)
    state = sim.init_state()
    src, base = co.bucket_placement(0)
    if cause == "held lock":       # a PREPARE with no COMMIT
        state = sim.tick(state, _ops(sim, (src, OP_PREPARE, base, 7)))
        state = sim.drain(state, 4)
    elif cause == "dirty version":  # one tick: the head holds it dirty
        state = sim.tick(state, _ops(sim, (src, OP_WRITE, base + 1, -1)))
    else:                           # a read forwarded to the slice
        state = sim.tick(state, _ops(sim, (src, OP_WRITE, base + 1, -1)))
        state = sim.drain(state, 8)
        state.inbox.op[src, 1, 0] = t_types.OP_READ
        state.inbox.key[src, 1, 0] = base
        state.inbox.src[src, 1, 0] = 0
    co.begin_rebalance(0, 1)
    state = co.install_roles(state)
    before = convert.to_numpy(state)
    epoch, pending = co.partition_epoch, co._pending_move
    with pytest.raises(AssertionError):
        co.complete_rebalance(state)
    after = convert.to_numpy(state)
    for f in ("stores", "locks", "metrics", "pmap", "roles", "inbox"):
        for a, b in zip(getattr(before, f), getattr(after, f)):
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert co.partition_epoch == epoch and co._pending_move == pending
    assert co.chains[src].writes_frozen


# -- two faults of the reference's failure handling, kept by the port --------
def _fail_pair():
    """The tick-parity engines (2 chains of 4 nodes, 64 keys) and a
    control plane for each."""
    from repro.core.coordinator import Coordinator as JCo
    from torch_parity import make_pair

    jcl, jsim, tsim = make_pair("netcraq", "segmented")
    return (jcl, jsim, tsim, JCo(jcl),
            Coordinator(tsim.cluster, device=CPU))


def _tick_both(jsim, tsim, js, ts, jinj, n=1):
    for _ in range(n):
        ts = tsim.tick(ts, convert.from_arrays(t_types.Msg, jinj, CPU))
        js = jsim.tick(js, jinj)
        jinj = jsim.empty_injection()
    return js, ts


def test_write_in_flight_to_a_failed_node_strands_a_dirty_version():
    """A node fails with a forwarded WRITE in its inbox: the fabric drops
    it, so the head's dirty version is never acknowledged and its key
    stays pending forever (the reference has no predecessor resend).
    Both packages end in the same state; at scale this keeps a failure
    storm from draining (``run_scenario``'s pending check)."""
    from torch_parity import assert_states_equal, injection

    jcl, jsim, tsim, jco, tco = _fail_pair()
    js, ts = jsim.init_state(), tsim.init_state()
    w = injection(jcl, [(0, 0, 0, j_types.OP_WRITE, 5, -1, 777)])
    js, ts = _tick_both(jsim, tsim, js, ts, w)       # head appends, forwards
    assert int(ts.inbox.op[0, 1].ne(0).sum()) == 1
    for co in (jco, tco):
        co.fail_node(0, 1)
    js, ts = jco.install_roles(js), tco.install_roles(ts)
    js, ts = _tick_both(jsim, tsim, js, ts, jsim.empty_injection(), 12)
    assert_states_equal(js, ts, "after the failure")
    assert tsim.inflight(ts) == 0
    assert int(ts.stores.pending[0, 0, 5]) == 1        # stranded at the head
    assert int(ts.stores.pending[0, 2:, 5].abs().sum()) == 0
    assert int(ts.metrics.replies.sum()) == 0 and int(ts.metrics.drops[0]) == 1


def test_recovery_copy_racing_an_ack_leaves_a_diverged_replica():
    """The recovery copy is taken while an ACK addressed to the head is in
    flight (the chaos runner settles on free locks only): the spliced
    node keeps the copied dirty version and its stale slot 0 while the
    rest of the chain commits.  Both packages end in the same state."""
    from torch_parity import assert_states_equal, injection

    jcl, jsim, tsim, jco, tco = _fail_pair()
    js, ts = jsim.init_state(), tsim.init_state()
    for co in (jco, tco):
        co.fail_node(0, 1)
    js, ts = jco.install_roles(js), tco.install_roles(ts)
    w = injection(jcl, [(0, 0, 0, j_types.OP_WRITE, 5, -1, 777)])
    js, ts = _tick_both(jsim, tsim, js, ts, w)
    # tick until the ACK for the head is in flight
    for _ in range(8):
        ack = (ts.inbox.op[0, 0] == t_types.OP_ACK).any()
        if bool(ack):
            break
        js, ts = _tick_both(jsim, tsim, js, ts, jsim.empty_injection())
    assert bool(ack) and int(ts.stores.pending[0, 0, 5]) == 1
    for co in (jco, tco):
        co.begin_recovery(0)
    _, jstores = jco.complete_recovery(0, 1, 1, js.stores, locks=js.locks)
    _, tstores = tco.complete_recovery(0, 1, 1, ts.stores, locks=ts.locks)
    js = jco.install_roles(js._replace(stores=jstores))
    ts = tco.install_roles(ts._replace(stores=tstores))
    js, ts = _tick_both(jsim, tsim, js, ts, jsim.empty_injection(), 12)
    assert_states_equal(js, ts, "after the recovery")
    vals = ts.stores.values[0, :, 5, 0, 0].tolist()
    assert vals[0] == vals[2] == vals[3] == 777 and vals[1] == 0, vals
    assert int(ts.stores.pending[0, 1, 5]) == 1
    with pytest.raises(AssertionError, match="chain 0: node 1 diverged"):
        t_chaos.check_replicas_converged(tsim, ts, tco)
