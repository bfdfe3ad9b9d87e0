"""The port's host-driven transactions against the reference's.

Parity: ``make_txn_workload`` yields the reference's transactions
exactly; ``reference_execute``/``serial_order`` answer alike (a cycle
included); ``cluster_route`` routes seeded batches alike, overflow
counts included; the host ``TxnDriver`` on the same transactions gives
the reference's results and the reference's engine state after every
wave (one reference engine, ``tests/helpers.py``'s ``prop_engine``
shapes); ``Coordinator.txn_planner`` plans the reference's streams
under a live map.  The rest are the torch forms of ``tests/test_txn.py``'s
planner and driver behaviours, run on the port alone.
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
from repro.core import Txn as JTxn  # noqa: E402
from repro.core import TxnDriver as JDriver  # noqa: E402
from repro.core import TxnPlanner as JPlanner  # noqa: E402
from repro.core import TxnResult as JResult  # noqa: E402
from repro.core import TxnWorkloadConfig as JTxnWorkload  # noqa: E402
from repro.core import make_txn_workload as j_make_txn_workload  # noqa: E402
from repro.core import reference_execute as j_reference_execute  # noqa: E402
from repro.core import serial_order as j_serial_order  # noqa: E402
from repro.core import types as j_types  # noqa: E402
from repro.core.chain import cluster_route as j_cluster_route  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.chain import ChainSim, cluster_route  # noqa: E402
from repro_torch.core.coordinator import Coordinator  # noqa: E402
from repro_torch.core.txn import (  # noqa: E402
    Txn,
    TxnDriver,
    TxnPlanner,
    committed_view,
    locks_all_free,
    reference_execute,
    serial_order,
)
from repro_torch.core.types import (  # noqa: E402
    CLIENT_BASE,
    OP_ABORT,
    OP_COMMIT,
    OP_PREPARE,
    OP_PREPARE_ACK,
    OP_PREPARE_NACK,
    OP_TXN_REPLY,
    ChainConfig,
    ClusterConfig,
    Msg,
)
from repro_torch.core.workload import (  # noqa: E402
    TxnWorkloadConfig,
    make_txn_workload,
)
from torch_parity import (  # noqa: E402
    assert_states_equal,
    assert_tree_equal,
    check_serializable,
)

CPU = "cpu"


# ---------------------------------------------------------------------------
# parity: workload, oracles, router
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("skew", ["uniform", "zipf"])
@pytest.mark.parametrize("cross", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("kpt", [1, 2, 4, 8])
def test_make_txn_workload_matches_reference(kpt, cross, skew):
    """numpy's ``default_rng`` draws, the same code path: the identical
    transaction list, on a cluster with buckets and spare registers."""
    jcl = JCluster(chain=JChain(num_keys=64), n_chains=4,
                   buckets_per_chain=4, spare_keys=16)
    kw = dict(n_txns=48, keys_per_txn=kpt, cross_chain_fraction=cross,
              write_fraction=0.5, key_skew=skew, seed=kpt + 3,
              txn_id_base=10, client_base=5)
    exp = j_make_txn_workload(jcl, JTxnWorkload(**kw))
    got = make_txn_workload(convert.cluster_from(jcl),
                            TxnWorkloadConfig(**kw))
    assert got == convert.txns_from(exp)
    assert all(isinstance(t, Txn) for t in got)


def _results(rng, n, keys, seq_hi):
    out = []
    for tid in range(1, n + 1):
        ks = rng.choice(keys, size=rng.integers(1, 4), replace=False)
        out.append(JResult(
            txn_id=tid, committed=bool(rng.random() < 0.8), mode="2pc",
            write_seqs={int(k): int(rng.integers(0, seq_hi)) for k in ks}))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serial_order_and_reference_execute_match_reference(seed):
    rng = np.random.default_rng(seed)
    # each txn's seqs follow one random serial position: acyclic
    results = _results(rng, 24, 10, 1 << 20)
    rank = rng.permutation(len(results))
    for r in results:
        r.write_seqs = {k: int(rank[r.txn_id - 1]) * 64 + k
                        for k in r.write_seqs}
    mine = convert.results_from(results)
    assert serial_order(mine) == j_serial_order(results)
    txns = [JTxn(txn_id=r.txn_id, writes=tuple(
        (k, r.txn_id * 10 + k) for k in r.write_seqs)) for r in results]
    order = j_serial_order(results)
    by_id = {t.txn_id: t for t in txns}
    mine_txns = {t.txn_id: t for t in convert.txns_from(txns)}
    assert reference_execute([mine_txns[t] for t in order]) == \
        j_reference_execute([by_id[t] for t in order])


def test_serial_order_refuses_a_cycle_like_the_reference():
    cyc = [JResult(txn_id=1, committed=True, mode="2pc",
                   write_seqs={0: 1, 1: 2}),
           JResult(txn_id=2, committed=True, mode="2pc",
                   write_seqs={0: 2, 1: 1}),
           JResult(txn_id=3, committed=False, mode="2pc")]
    for fn, res in ((j_serial_order, cyc),
                    (serial_order, convert.results_from(cyc))):
        with pytest.raises(AssertionError, match="cyclic"):
            fn(res)


def _flat_msgs(rng, N):
    f = {k: np.array(v) for k, v in j_types.Msg.empty(N)._asdict().items()}
    live = rng.random(N) < 0.7
    f["op"] = np.where(live, rng.integers(1, 14, N), 0).astype(np.int32)
    for k in ("key", "seq", "src", "client", "entry", "qid", "t_inject",
              "extra", "ver"):
        f[k] = np.where(live, rng.integers(-5, 1 << 20, N), f[k]).astype(
            np.int32)
    f["value"] = np.where(live[:, None], rng.integers(0, 1 << 20, (N, 4)),
                          0).astype(np.int32)
    return f


@pytest.mark.parametrize("seed,C,N,cap", [(0, 3, 40, 6), (1, 4, 64, 3),
                                          (2, 2, 17, 20), (3, 5, 1, 2)])
def test_cluster_route_matches_reference(seed, C, N, cap):
    """Targets in [-1, C] (both ends drop), caps below the worst case:
    identical deliveries, in flat order, and identical overflow counts."""
    rng = np.random.default_rng(seed)
    f = _flat_msgs(rng, N)
    target = rng.integers(-1, C + 1, N).astype(np.int32)
    jr, jo = j_cluster_route(
        j_types.Msg(**{k: jnp.asarray(v) for k, v in f.items()}),
        jnp.asarray(target), C, cap)
    tr, to = cluster_route(
        Msg(**{k: torch.from_numpy(v) for k, v in f.items()}),
        torch.from_numpy(target), C, cap)
    assert_tree_equal(jax.device_get(jr), tr, "routed")
    assert_tree_equal(np.asarray(jo), to, "overflow")
    if seed == 1:
        assert int(to.sum()) > 0   # some chain did overflow


# ---------------------------------------------------------------------------
# parity: the host driver against the reference's, wave by wave
# ---------------------------------------------------------------------------
SIM_KW = dict(inject_capacity=16, route_capacity=96, reply_capacity=512,
              telemetry=False)


@pytest.fixture(scope="module")
def engines():
    """``prop_engine``'s cluster (2 chains of 3 nodes, 4 registers, 8
    versions): (reference cluster, reference sim, port cluster).  The
    reference driver's router runs compiled once per stream shape (its
    eager form dispatches op by op, some 0.6 s a wave)."""
    import repro.core.workload as j_workload

    jcl = JCluster(chain=JChain(n_nodes=3, num_keys=4, num_versions=8),
                   n_chains=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_workload, "route_stream", jax.jit(
            j_workload.route_stream, static_argnums=(0, 2)))
        yield (jcl, JSim(jcl, **SIM_KW),
               convert.cluster_from(jcl))


def _run_both(engines, waves, co_pair=None, jstate=None, tstate=None):
    jcl, jsim, tcl = engines
    tsim = ChainSim(tcl, device=CPU, **SIM_KW)
    jstate = jsim.init_state() if jstate is None else jstate
    tstate = tsim.init_state() if tstate is None else tstate
    jco, tco = co_pair or (None, None)
    jdrv = JDriver(jsim, JPlanner(jcl, coordinator=jco))
    tdrv = TxnDriver(tsim, TxnPlanner(tcl, coordinator=tco, device=CPU))
    results = []
    for i, wave in enumerate(waves):
        jstate, jres = jdrv.run(jstate, wave)
        tstate, tres = tdrv.run(tstate, convert.txns_from(wave))
        assert tres == convert.results_from(jres), f"wave {i}"
        assert_states_equal(jstate, tstate, f"wave {i}")
        results += tres
    return jstate, tstate, results, tsim


@pytest.mark.parametrize("kind", ["mixed", "zipf_reads"])
def test_txn_driver_matches_reference(engines, kind):
    """The same transactions through the reference's ``TxnDriver`` on its
    ``ChainSim(telemetry=False)`` and through the port's: identical
    results and identical engine states after every wave."""
    jcl = engines[0]
    if kind == "mixed":
        txns = j_make_txn_workload(jcl, JTxnWorkload(
            n_txns=12, keys_per_txn=2, cross_chain_fraction=0.5, seed=4))
    else:
        txns = j_make_txn_workload(jcl, JTxnWorkload(
            n_txns=12, keys_per_txn=3, write_fraction=0.5,
            key_skew="zipf", seed=9))
    waves = [txns[i:i + 4] for i in range(0, len(txns), 4)]
    jstate, tstate, results, tsim = _run_both(engines, waves)
    assert {r.mode for r in results} >= {"2pc"}
    for _ in range(2):
        jstate = engines[1].tick(jstate, engines[1].empty_injection())
        tstate = tsim.tick(tstate, tsim.empty_injection())
    assert_states_equal(jstate, tstate, "drained")


def test_txn_planner_under_a_live_map_matches_reference(engines):
    """After a bucket move the coordinator's planner splits keys with the
    live map and stamps its epoch: the reference's streams and results."""
    jcl = JCluster(chain=JChain(n_nodes=3, num_keys=8, num_versions=8),
                   n_chains=2, buckets_per_chain=2, spare_keys=4)
    tcl = convert.cluster_from(jcl)
    jco, tco = JCoordinator(jcl), Coordinator(tcl, device=CPU)
    jsim = JSim(jcl, **SIM_KW)
    tsim = ChainSim(tcl, device=CPU, **SIM_KW)
    # bucket 0 (global keys 0 and 2) moves from chain 0 to chain 1
    jstate = jco.rebalance(jsim.init_state(), 0, 1)
    tstate = tco.rebalance(tsim.init_state(), 0, 1)
    assert tco.partition_epoch == jco.partition_epoch == 1
    txns = [JTxn(txn_id=1, writes=((1, 11), (4, 44))),
            JTxn(txn_id=2, writes=((0, 7),), reads=(2,)),
            JTxn(txn_id=3, writes=((6, 66),), reads=(5,))]
    jstream, jplan = jco.txn_planner.phase1(txns)
    tstream, tplan = tco.txn_planner.phase1(convert.txns_from(txns))
    assert tco.txn_planner is tco.txn_planner
    assert_tree_equal(jax.device_get(jstream), tstream, "phase-1 stream")
    assert tstream.ver.unique().tolist() == [1]
    assert tstream.op.device.type == "cpu"
    jdrv, tdrv = JDriver(jsim, jco.txn_planner), TxnDriver(tsim,
                                                         tco.txn_planner)
    jstate, jres = jdrv.run(jstate, txns)
    tstate, tres = tdrv.run(tstate, convert.txns_from(txns))
    assert tres == convert.results_from(jres)
    assert all(r.committed for r in tres)
    assert [r.mode for r in tres] == ["2pc", "direct", "2pc"]
    assert tstate.metrics.asdict()["stale_routes"] == 0
    assert_states_equal(jstate, tstate, "after the live-map run")


# ---------------------------------------------------------------------------
# behaviours (the torch forms of tests/test_txn.py), on the port alone
# ---------------------------------------------------------------------------
def _cluster(protocol="netcraq"):
    return ClusterConfig(
        chain=ChainConfig(n_nodes=4, num_keys=8, num_versions=6,
                          protocol=protocol), n_chains=2)


def _sim(cl):
    return ChainSim(cl, inject_capacity=16, route_capacity=128,
                    reply_capacity=1024, device=CPU)


def _drain(sim, state, ticks):
    return sim.drain(state, ticks)


def _inject_txn(sim, op, local_key, val, txn_id, chain, qid, node=0):
    m = sim.empty_injection()
    at = (chain, node, 0)
    m.op[at], m.key[at], m.value[at + (0,)] = op, local_key, val
    m.seq[at], m.dst[at], m.qid[at] = txn_id, node, qid
    m.src[at] = m.client[at] = CLIENT_BASE + 1
    return m


def _reply_map(state):
    r = state.replies.merged()
    return {int(q): (int(op), int(s), int(v))
            for q, op, s, v in zip(r.qid, r.op, r.seq, r.value0)}


def test_cross_chain_commit_is_atomic_and_readable():
    cl = _cluster()
    sim = _sim(cl)
    state = sim.init_state()
    drv = TxnDriver(sim, TxnPlanner(cl, device=CPU))
    state, res = drv.run(state, [Txn(txn_id=1, writes=((0, 111), (1, 222)))])
    assert res[0].committed and res[0].mode == "2pc"
    state = _drain(sim, state, 12)
    view = committed_view(cl, state)
    assert view[0] == 111 and view[1] == 222
    assert locks_all_free(state.locks)
    state, res = drv.run(state, [Txn(txn_id=2, reads=(0, 1))])
    assert res[0].committed
    assert res[0].read_values == {0: 111, 1: 222}


def test_nacked_cross_chain_txn_aborts_atomically():
    cl = _cluster()
    sim = _sim(cl)
    drv = TxnDriver(sim, TxnPlanner(cl, device=CPU))
    t1 = Txn(txn_id=1, writes=((2, 100), (5, 101)))
    t2 = Txn(txn_id=2, writes=((2, 200), (3, 201)))   # conflicts on key 2
    state, res = drv.run(sim.init_state(), [t1, t2])
    by_id = {r.txn_id: r for r in res}
    assert by_id[1].mode == by_id[2].mode == "2pc"
    state = _drain(sim, state, 12)
    view = committed_view(cl, state)
    assert by_id[1].committed != by_id[2].committed
    if by_id[1].committed:
        assert (view[2], view[5], view[3]) == (100, 101, 0)
    else:
        assert (view[2], view[3], view[5]) == (200, 201, 0)
    assert locks_all_free(state.locks)
    assert state.metrics.asdict()["lock_conflicts"] >= 1


def test_single_chain_fast_path_packet_parity_with_plain_writes():
    """A k-key transaction on one chain costs exactly k plain writes."""
    cl = _cluster()
    sim = _sim(cl)
    drv = TxnDriver(sim, TxnPlanner(cl, device=CPU))

    def packets_for(txns):
        state, res = drv.run(sim.init_state(), txns)
        assert all(r.committed for r in res)
        return _drain(sim, state, 12).metrics.asdict(), res

    m_txn, res = packets_for([Txn(txn_id=1, writes=((0, 1), (2, 2)))])
    assert res[0].mode == "direct"
    m_w, _ = packets_for([Txn(txn_id=2, writes=((0, 3),)),
                          Txn(txn_id=3, writes=((2, 4),))])
    assert m_txn["packets"] == m_w["packets"]
    assert m_txn["replies"] == m_w["replies"] == 2
    for key in ("txn_commits", "txn_aborts", "lock_conflicts"):
        assert m_txn[key] == 0, key


def test_netchain_commit_path():
    cl = _cluster("netchain")
    sim = _sim(cl)
    drv = TxnDriver(sim, TxnPlanner(cl, device=CPU))
    state, res = drv.run(sim.init_state(),
                         [Txn(txn_id=1, writes=((0, 11), (1, 22)))])
    assert res[0].committed and res[0].mode == "2pc"
    state = _drain(sim, state, 12)
    view = committed_view(cl, state)
    assert view[0] == 11 and view[1] == 22
    assert locks_all_free(state.locks)


def test_frozen_chain_nacks_prepares_but_drains_held_commits():
    cl = _cluster()
    sim = _sim(cl)
    co = Coordinator(cl, device=CPU)
    state = sim.tick(sim.init_state(),
                     _inject_txn(sim, OP_PREPARE, 4, 0, 31, 0, qid=1))
    state = _drain(sim, state, 2)
    assert not co.locks_drained(state, 0)
    co.fail_node(0, 2)
    state = co.install_roles(state)
    co.begin_recovery(0)
    state = co.install_roles(state)
    state = sim.tick(state, _inject_txn(sim, OP_PREPARE, 6, 0, 32, 0, qid=2))
    state = sim.tick(state, _inject_txn(sim, OP_COMMIT, 4, 77, 31, 0, qid=3))
    state = _drain(sim, state, 10)
    recs = _reply_map(state)
    assert recs[2] == (OP_PREPARE_NACK, -1, 0)
    assert recs[3][0] == OP_TXN_REPLY and recs[3][1] >= 0
    assert co.locks_drained(state, 0)
    assert locks_all_free(state.locks)
    assert state.stores.values[0, [0, 1, 3], 4, 0, 0].tolist() == [77] * 3


def test_prepare_abort_lifecycle_replies():
    """PREPARE grants and ACKs the snapshot; a second PREPARE NACKs; ABORT
    releases without applying and answers TXN_REPLY(-1)."""
    cl = _cluster()
    sim = _sim(cl)
    state = sim.init_state()
    for op, txn, qid in ((OP_PREPARE, 7, 1), (OP_PREPARE, 8, 2),
                         (OP_ABORT, 7, 3)):
        state = sim.tick(state, _inject_txn(sim, op, 2, 0, txn, 0, qid=qid))
    state = _drain(sim, state, 4)
    recs = _reply_map(state)
    assert recs[1] == (OP_PREPARE_ACK, 0, 0)
    assert recs[2] == (OP_PREPARE_NACK, -1, 0)
    assert recs[3] == (OP_TXN_REPLY, -1, 0)
    assert locks_all_free(state.locks)
    assert state.replies.total_landed() == 3
    m = state.metrics.asdict()
    assert (m["txn_aborts"], m["lock_conflicts"]) == (1, 1)


# ---------------------------------------------------------------------------
# the seeded fuzzes of tests/test_txn.py, through both host drivers
# ---------------------------------------------------------------------------
def _spec(rng):
    from helpers import (PROP_MAX_KEYS_PER_TXN, PROP_MAX_TXNS_PER_WAVE,
                         PROP_MAX_WAVES, PROP_NUM_GLOBAL_KEYS)
    return [
        [tuple(rng.choice(PROP_NUM_GLOBAL_KEYS,
                          size=rng.integers(1, PROP_MAX_KEYS_PER_TXN + 1),
                          replace=False).tolist())
         for _ in range(rng.integers(1, PROP_MAX_TXNS_PER_WAVE + 1))]
        for _ in range(rng.integers(1, PROP_MAX_WAVES + 1))
    ]


def _abandon(sim, cl, state, abandon, tid_base=9001):
    """The port's form of ``helpers.inject_abandoned_prepares``: phantom
    clients take the head lock of each key with a bare PREPARE and
    vanish (one tick)."""
    from repro_torch.core.types import CLIENT_BASE as CB

    m = sim.empty_injection()
    lanes: dict[int, int] = {}
    for i, gk in enumerate(abandon):
        chain, slot = int(cl.key_to_chain(gk)), int(cl.key_to_slot(gk))
        at = (chain, 0, lanes.get(chain, 0))
        lanes[chain] = at[2] + 1
        m.op[at], m.key[at], m.seq[at] = OP_PREPARE, slot, tid_base + i
        m.src[at] = m.client[at] = CB + 7
        m.dst[at], m.qid[at] = 0, (1 << 20) + i
    return sim.tick(state, m)


def _fuzz_case(engines, spec, abandon=(), lease=None):
    """One spec through both host drivers (results and states equal after
    every wave and after the drain), then the serializability oracle of
    ``tests/helpers.py`` on the port's state."""
    from helpers import inject_abandoned_prepares, txn_waves_from_spec
    from repro.core.txn import set_lease as j_set_lease
    from repro_torch.core.txn import held_locks, set_lease

    jcl, jsim, tcl = engines
    tsim = ChainSim(tcl, device=CPU, **SIM_KW)
    jstate, tstate = jsim.init_state(), tsim.init_state()
    if lease is not None:
        jstate = jstate._replace(locks=j_set_lease(jstate.locks, lease))
        tstate = tstate._replace(locks=set_lease(tstate.locks, lease))
    if abandon:
        jstate = inject_abandoned_prepares(jsim, jcl, jstate, abandon)
        tstate = _abandon(tsim, tcl, tstate, abandon)
    waves = txn_waves_from_spec(spec)
    jstate, tstate, results, _ = _run_both(engines, waves, jstate=jstate,
                                           tstate=tstate)
    ticks = 4 * tsim.n + 4 + (lease if lease and abandon else 0)
    for _ in range(ticks):
        jstate = jsim.tick(jstate, jsim.empty_injection())
    tstate = tsim.drain(tstate, ticks)
    assert_states_equal(jstate, tstate, "drained")
    m = tstate.metrics.asdict()
    if abandon and lease is None:
        assert held_locks(tstate.locks) == len(abandon)
        assert m["lease_expiries"] == 0
    else:
        assert locks_all_free(tstate.locks)
        if abandon:
            assert m["lease_expiries"] >= len(abandon)
    assert int(tstate.stores.pending.sum()) == 0
    check_serializable(tcl, tstate, convert.txns_from(
        [t for w in waves for t in w]), results)
    return results


def test_host_seeded_fuzz_matches_reference(engines):
    """``tests/test_txn.py``'s 30-spec serializability fuzz (rng 0)
    through both host drivers: identical results and states, the port's
    committed subset atomic, acyclic and serially replayable, and both
    outcomes exercised as the reference's fuzz requires."""
    rng = np.random.default_rng(0)
    n_committed = n_aborted = 0
    for _ in range(30):
        results = _fuzz_case(engines, _spec(rng))
        n_committed += sum(r.committed for r in results)
        n_aborted += sum(not r.committed for r in results)
    assert n_committed > 20 and n_aborted > 5, (n_committed, n_aborted)


def test_abandoning_clients_under_lease_match_reference(engines):
    """``tests/test_txn.py``'s lease fuzz (rng 1: phantom clients take
    two locks and vanish, leases of 8, 16 and 32 ticks) and its LEASE_OFF
    control arm, through both host drivers: the abandoned locks are
    reclaimed (or, without a lease, leak exactly), identically."""
    rng = np.random.default_rng(1)
    for lease in (8, 16, 32):
        for _ in range(2):
            spec = _spec(rng)
            abandon = tuple(rng.choice(8, size=2, replace=False).tolist())
            _fuzz_case(engines, spec, abandon=abandon, lease=lease)
    _fuzz_case(engines, [[(0, 3), (5,)], [(1, 4)]], abandon=(2, 6))


def test_fig_txn_packets_per_committed_write():
    """fig_txn's cluster on the port: a local transaction costs exactly
    the plain-write baseline of 11 packets per write, and a 2-key
    cross-chain one 13 per committed write (one prepare round more)."""
    cl = ClusterConfig(chain=ChainConfig(n_nodes=4, num_keys=64,
                                         num_versions=8), n_chains=4)
    sim = ChainSim(cl, inject_capacity=24, route_capacity=256,
                   reply_capacity=8192, device=CPU)

    def run(txns):
        state, results = sim.init_state(), []
        drv = TxnDriver(sim, TxnPlanner(cl, device=CPU))
        for w in range(0, len(txns), 6):
            state, res = drv.run(state, txns[w:w + 6])
            results += res
        m = sim.drain(state, 4 * sim.n).metrics.asdict()
        writes = sum(len(r.write_seqs) for r in results if r.committed)
        return m, writes, results

    base, n, _ = run([Txn(txn_id=1000 + i, writes=((i * 4 % 256,
                                                      70000 + i),))
                      for i in range(24)])
    assert (base["packets"], base["replies"], n) == (11 * 24, 24, 24)
    for cross, per_write in ((0.0, 11), (1.0, 13)):
        txns = make_txn_workload(cl, TxnWorkloadConfig(
            n_txns=24, keys_per_txn=2, cross_chain_fraction=cross,
            seed=20 + int(cross * 2), txn_id_base=1))
        m, writes, results = run(txns)
        assert {r.mode for r in results} == {"direct" if cross == 0
                                             else "2pc"}
        assert m["packets"] == per_write * writes, (cross, m["packets"],
                                                    writes)
