"""The port's in-network wave coordinator against the reference's.

Parity: ``wave_coordinator_step`` on seeded wave tables (every phase,
forced lease aborts, a saturating completion log, every reply op,
out-of-range qids, two replies naming one cell) equals the reference's
vmapped step exactly; a wave engine held tick by tick (state after every
tick, the wave table included) on a hand-admitted wave; ``TxnWaveDriver``
against the reference's on the same transactions (results,
``last_rounds``, ``last_ticks``, final state) and on
``tests/test_txn_pipeline.py``'s 30-spec seeded fuzz, each run through
the shared serializability oracle.  One reference engine
(``tests/helpers.py``'s ``wave_prop_engine`` shapes, ``telemetry=False``):
its ``tick`` and its ``drain(2)`` are the file's two compiles.  The rest
are the torch forms of the wave behaviours of ``tests/test_txn.py`` and
``tests/test_txn_pipeline.py``, run on the port alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ChainConfig as JChain  # noqa: E402
from repro.core import ChainSim as JSim  # noqa: E402
from repro.core import ClusterConfig as JCluster  # noqa: E402
from repro.core import TxnPlanner as JPlanner  # noqa: E402
from repro.core import TxnWaveDriver as JWaveDriver  # noqa: E402
from repro.core import TxnWorkloadConfig as JTxnWorkload  # noqa: E402
from repro.core import make_txn_workload as j_make_txn_workload  # noqa: E402
from repro.core import txn as j_txn  # noqa: E402
from repro.core import types as j_types  # noqa: E402
from helpers import (  # noqa: E402
    PROP_MAX_KEYS_PER_TXN,
    PROP_MAX_TXNS_PER_WAVE,
    PROP_MAX_WAVES,
    PROP_NUM_GLOBAL_KEYS,
    txn_waves_from_spec,
)
from repro_torch import convert  # noqa: E402
from repro_torch.core import txn as t_txn  # noqa: E402
from repro_torch.core.chain import ChainSim  # noqa: E402
from repro_torch.core.coordinator import Coordinator  # noqa: E402
from repro_torch.core.txn import (  # noqa: E402
    Txn,
    TxnDriver,
    TxnPlanner,
    TxnWaveDriver,
    WaveState,
    committed_view,
    locks_all_free,
    set_lease,
)
from repro_torch.core.types import LEASE_OFF, Msg  # noqa: E402
from torch_parity import (  # noqa: E402
    assert_states_equal,
    assert_tree_equal,
    check_serializable,
)

CPU = "cpu"
SIM_KW = dict(inject_capacity=16, route_capacity=96, reply_capacity=512,
              wave_depth=PROP_MAX_TXNS_PER_WAVE,
              wave_keys=PROP_MAX_KEYS_PER_TXN, wave_log_capacity=64,
              telemetry=False)


@pytest.fixture(scope="module")
def engines():
    """``wave_prop_engine``'s shapes: 2 chains of 3 nodes, 4 registers,
    8 versions, 4 slots of 3 participants per chain, a 64-row log.
    (reference cluster, reference sim, port cluster)."""
    jcl = JCluster(chain=JChain(n_nodes=3, num_keys=4, num_versions=8),
                   n_chains=2)
    return jcl, JSim(jcl, **SIM_KW), convert.cluster_from(jcl)


def _tsim(engines, **kw):
    return ChainSim(engines[2], device=CPU, **{**SIM_KW, **kw})


# ---------------------------------------------------------------------------
# the coordinator step on seeded wave tables
# ---------------------------------------------------------------------------
REPLY_OPS = (j_types.OP_NOP, j_types.OP_PREPARE_ACK, j_types.OP_PREPARE_NACK,
             j_types.OP_STALE_NACK, j_types.OP_TXN_REPLY,
             j_types.OP_WRITE_NACK, j_types.OP_READ_REPLY,
             j_types.OP_WRITE_REPLY)


def _seeded_wave(rng, C, W, KT, Lg, VW, t):
    """A wave table in every phase with used and unused participants,
    slots admitted long ago (past a finite lease) and just now, log
    cursors from empty to saturated, and a control-reply buffer of every
    reply op aimed at this chain's slots, other chains' and none (qids
    from -3 to past the last slot), with two replies on one cell."""
    ri = lambda lo, hi, *s: rng.integers(lo, hi, (C,) + s).astype(np.int32)
    Xr = W * KT
    p_gkey = np.where(rng.random((C, W, KT)) < 0.7, ri(0, 64, W, KT), -1)
    p_gkey[:, :, 0] = ri(0, 64, W)                   # every slot uses col 0
    cursor = np.array([0, Lg - 1, Lg, Lg // 2][:C], np.int32)
    qid = ri(-3, (C * W + 2) * KT, Xr)
    own = rng.random((C, Xr)) < 0.6                  # aimed at own slots
    qid = np.where(own, np.arange(C, dtype=np.int32)[:, None] * Xr
                   + ri(0, Xr, Xr), qid).astype(np.int32)
    op = np.asarray(REPLY_OPS, np.int32)[ri(0, len(REPLY_OPS), Xr)]
    qid[:, 1], op[:, 1] = qid[:, 0], op[:, 0]        # one cell twice
    live = op != 0
    m = {k: np.array(v).reshape((C, Xr) + np.shape(v)[1:])
         for k, v in j_types.Msg.empty(C * Xr, VW)._asdict().items()}
    m.update(op=op, qid=np.where(live, qid, -1).astype(np.int32))
    for k in ("seq", "client", "src", "key", "t_inject", "ver"):
        m[k] = np.where(live, ri(-2, 1 << 16, Xr), m[k]).astype(np.int32)
    m["value"] = np.where(live[..., None], ri(0, 1 << 16, Xr, VW),
                          0).astype(np.int32)
    m["dst"] = np.where(live, j_types.TO_CLIENT, m["dst"]).astype(np.int32)
    return dict(
        phase=ri(0, 4, W),
        txn_id=ri(1, 1000, W), client=ri(0, 1 << 20, W), qid=ri(0, 999, W),
        epoch=ri(0, 3, W), t_admit=ri(t - 12, t + 1, W),
        committing=ri(-1, 3, W),
        p_gkey=p_gkey.astype(np.int32), p_owner=ri(0, C, W, KT),
        p_lkey=ri(0, 16, W, KT), p_wval=ri(0, 1 << 20, W, KT),
        p_write=ri(0, 2, W, KT), p_replied=ri(0, 2, W, KT),
        p_acked=ri(0, 2, W, KT), p_done=ri(0, 2, W, KT),
        p_snap=ri(0, 99, W, KT), p_wseq=ri(-1, 9, W, KT),
        log_txn=ri(-1, 99, Lg), log_committed=ri(0, 3, Lg),
        log_t_admit=ri(0, 9, Lg), log_t_done=ri(0, 9, Lg),
        log_gkey=ri(-1, 64, Lg, KT), log_write=ri(0, 2, Lg, KT),
        log_wseq=ri(-1, 9, Lg, KT), log_snap=ri(0, 99, Lg, KT),
        log_cursor=cursor, coord_in=m)


@pytest.mark.parametrize("seed", range(6))
def test_wave_coordinator_step_matches_reference(seed):
    rng = np.random.default_rng(seed)
    C, W, KT, Lg, VW, t = 3, 5, 3, 6, 4, 40
    fields = _seeded_wave(rng, C, W, KT, Lg, VW, t)
    lease = np.array([LEASE_OFF, 4, 0], np.int32)
    jwave = j_txn.WaveState(**{
        k: (j_types.Msg(**{f: jnp.asarray(x) for f, x in v.items()})
            if k == "coord_in" else jnp.asarray(v))
        for k, v in fields.items()})
    exp = jax.vmap(j_txn.wave_coordinator_step, in_axes=(0, 0, None, 0))(
        jwave, jnp.arange(C, dtype=jnp.int32), jnp.int32(t),
        jnp.asarray(lease))
    twave = convert.from_arrays(WaveState, jax.device_get(jwave), CPU)
    got = t_txn.wave_coordinator_step(twave, torch.tensor(t, dtype=torch.int32),
                                      torch.from_numpy(lease))
    names = ("wave", "sub_out", "sub_target", "final_out")
    for name, e, g in zip(names, exp[:4], got[:4]):
        assert_tree_equal(jax.device_get(e), g, name)
    for i, (e, g) in enumerate(zip(exp[4], got[4])):
        assert_tree_equal(np.asarray(e), g, f"stats[{i}]")
    if seed == 0:   # the seed reaches what it is for
        assert int(got[4][0].sum() + got[4][1].sum()) > 0    # slots finished
        assert int((got[0].log_cursor == Lg).sum()) >= 2     # saturated


def test_wave_coordinator_step_forces_an_expired_prep_slot():
    """A PREP slot with ``t - t_admit >= lease_ticks`` decides at once as
    WAVE_EXPIRED and emits an ABORT per participant; at LEASE_OFF it keeps
    waiting; every leaf stays int32."""
    wave = WaveState.empty(2, 2, 4, 4, 4, n_chains=2, device=CPU)
    wave.phase[:, 0] = t_txn.WAVE_PREP
    wave.t_admit[:, 0] = 7
    wave.p_gkey[:, 0] = torch.tensor([5, 6], dtype=torch.int32)
    wave.p_owner[:, 0] = torch.tensor([0, 1], dtype=torch.int32)
    wave.p_write[:, 0] = 1
    lease = torch.tensor([LEASE_OFF, 3], dtype=torch.int32)
    new, sub, tgt, _, _ = t_txn.wave_coordinator_step(
        wave, torch.tensor(10, dtype=torch.int32), lease)
    assert new.phase[:, 0].tolist() == [t_txn.WAVE_PREP, t_txn.WAVE_FIN]
    assert new.committing[1, 0] == t_txn.WAVE_EXPIRED
    assert sub.op[0].tolist() == [0] * 4
    assert sub.op[1, :2].tolist() == [j_types.OP_ABORT] * 2
    assert tgt[1, :2].tolist() == [0, 1]
    assert all(x.dtype == torch.int32 for x in new if torch.is_tensor(x))


# ---------------------------------------------------------------------------
# the wave engine, tick by tick, and the driver
# ---------------------------------------------------------------------------
def test_wave_engine_matches_reference_tick_by_tick(engines):
    """A wave admitted by hand (the reference driver's admission on its
    state, carried across by ``convert.state_from_arrays``): two
    conflicting cross-chain transactions, a read and a 3-key one, with
    plain client traffic beside them; both engines ticked with the same
    injections, states equal after every tick."""
    from torch_parity import injection

    jcl, jsim, tcl = engines
    tsim = _tsim(engines)
    txns = [j_txn.Txn(txn_id=1, writes=((0, 10), (1, 11))),
            j_txn.Txn(txn_id=2, writes=((0, 20), (3, 21))),
            j_txn.Txn(txn_id=3, writes=((2, 30),), reads=(5,)),
            j_txn.Txn(txn_id=4, writes=((4, 40), (5, 41), (7, 42)))]
    jdrv = JWaveDriver(jsim, JPlanner(jcl))
    queue = [jdrv._plan(t) for t in txns]
    jstate, n = jdrv._admit(jsim.init_state(), queue,
                            np.zeros((2, SIM_KW["wave_depth"]), np.int32), 0)
    assert n == 4
    tstate = convert.state_from_arrays(jax.device_get(jstate), CPU)
    assert_states_equal(jstate, tstate, "admitted")
    W, R = j_types.OP_WRITE, j_types.OP_READ
    plain = [injection(jcl, [(0, 0, 0, W, 1, -1, 77), (1, 2, 1, R, 0, 0, 0)],
                       c_in=SIM_KW["inject_capacity"])]
    empty = jsim.empty_injection()
    for i, inj in enumerate(plain + [empty] * 13):
        jstate = jsim.tick(jstate, inj)
        tstate = tsim.tick(tstate, convert.from_arrays(Msg, inj, CPU))
        assert_states_equal(jstate, tstate, f"tick {i}")
    m = tstate.metrics.asdict()
    assert m["wave_commits"] + m["wave_aborts"] == 4
    assert m["wave_aborts"] >= 1 and m["lock_conflicts"] >= 1
    assert Coordinator.waves_drained(tstate)
    assert tsim.inflight(tstate) == 0


def _run_wave_pair(engines, waves, lease=None):
    """Each wave through the reference's ``TxnWaveDriver`` and the
    port's; results, rounds and ticks equal per wave, states equal after
    each and after a drain of ``4n + 4`` ticks."""
    jcl, jsim, tcl = engines
    tsim = _tsim(engines)
    jstate, tstate = jsim.init_state(), tsim.init_state()
    if lease is not None:
        jstate = jstate._replace(locks=j_txn.set_lease(jstate.locks, lease))
        tstate = tstate._replace(locks=set_lease(tstate.locks, lease))
    jdrv = JWaveDriver(jsim, JPlanner(jcl))
    tdrv = TxnWaveDriver(tsim, TxnPlanner(tcl, device=CPU))
    results = []
    for i, wave in enumerate(waves):
        jstate, jres = jdrv.run(jstate, wave)
        tstate, tres = tdrv.run(tstate, convert.txns_from(wave))
        assert tres == convert.results_from(jres), f"wave {i}"
        assert (tdrv.last_rounds, tdrv.last_ticks) == (
            jdrv.last_rounds, jdrv.last_ticks), f"wave {i}"
        assert_states_equal(jstate, tstate, f"wave {i}")
        results += tres
    empty = jsim.empty_injection()
    for _ in range(4 * tsim.n + 4):
        jstate = jsim.tick(jstate, empty)
    tstate = tsim.drain(tstate, 4 * tsim.n + 4)
    assert_states_equal(jstate, tstate, "drained")
    return tsim, tstate, results


def _check_serializable(tcl, state, waves, results):
    assert locks_all_free(state.locks)
    assert int(state.stores.pending.sum()) == 0
    assert Coordinator.waves_drained(state)
    check_serializable(tcl, state, convert.txns_from(
        [t for w in waves for t in w]), results)


@pytest.mark.parametrize("kind", ["zipf", "uniform_reads"])
def test_wave_driver_matches_reference(engines, kind):
    jcl = engines[0]
    kw = (dict(keys_per_txn=2, key_skew="zipf", seed=5) if kind == "zipf"
          else dict(keys_per_txn=3, write_fraction=0.5, seed=6))
    txns = j_make_txn_workload(jcl, JTxnWorkload(n_txns=20, **kw))
    waves = [txns[:12], txns[12:]]
    tsim, tstate, results = _run_wave_pair(engines, waves)
    assert len(results) == 20
    _check_serializable(engines[2], tstate, waves, results)


def test_wave_seeded_fuzz_matches_reference(engines):
    """``tests/test_txn_pipeline.py``'s 30-spec seeded fuzz (rng 0): each
    spec's waves through both drivers with identical results, the port's
    state through the serializability oracle; the totals exercise both
    outcomes, as the reference's fuzz requires."""
    rng = np.random.default_rng(0)
    n_committed = n_aborted = 0
    for _ in range(30):
        spec = [
            [tuple(rng.choice(PROP_NUM_GLOBAL_KEYS,
                              size=rng.integers(1, PROP_MAX_KEYS_PER_TXN + 1),
                              replace=False).tolist())
             for _ in range(rng.integers(1, PROP_MAX_TXNS_PER_WAVE + 1))]
            for _ in range(rng.integers(1, PROP_MAX_WAVES + 1))
        ]
        waves = txn_waves_from_spec(spec)
        tsim, tstate, results = _run_wave_pair(engines, waves)
        _check_serializable(engines[2], tstate, waves, results)
        n_committed += sum(r.committed for r in results)
        n_aborted += sum(not r.committed for r in results)
    assert n_committed > 20 and n_aborted > 5, (n_committed, n_aborted)


def test_wave_slot_outliving_lease_force_aborts_as_wave_expired(engines):
    """Under a 1-tick lease a cross-chain wave txn cannot hear its
    replies in time: the slot is force-aborted (``wave_expired``) and
    recycled, the straggler's release NACKs, nothing is applied."""
    tsim, state, res = _run_wave_pair(
        engines, [[j_txn.Txn(txn_id=5, writes=((0, 55), (1, 66)))]], lease=1)
    assert res[0].mode == "wave_expired" and not res[0].committed
    assert locks_all_free(state.locks)
    assert bool((state.wave.phase == 0).all())
    view = committed_view(engines[2], state)
    assert view[0] == 0 and view[1] == 0
    m = state.metrics.asdict()
    assert m["txn_commits"] == 0 and m["lease_expiries"] >= 1


def test_wave_matches_host_driver_conflict_free(engines):
    """Conflict-free transactions commit alike under both of the port's
    coordinators: same commit set, same acknowledged keys, same view."""
    tcl = engines[2]
    waves = [[Txn(txn_id=1, writes=((0, 5), (2, 6))),
              Txn(txn_id=2, writes=((1, 7), (5, 8)))],
             [Txn(txn_id=3, writes=((3, 9),)),
              Txn(txn_id=4, writes=((4, 1), (6, 2), (7, 3)))]]
    out = {}
    for kind in ("host", "wave"):
        sim = _tsim(engines, wave_depth=0 if kind == "host" else 4)
        drv = (TxnDriver if kind == "host" else TxnWaveDriver)(
            sim, TxnPlanner(tcl, device=CPU))
        state, results = sim.init_state(), []
        for wave in waves:
            state, res = drv.run(state, wave)
            results += res
        state = sim.drain(state, 4 * sim.n + 4)
        assert all(r.committed for r in results), (kind, results)
        out[kind] = ({r.txn_id: set(r.write_seqs) for r in results},
                     committed_view(tcl, state))
    assert out["host"] == out["wave"]


def test_wave_capacity_and_log_contract(engines):
    """Hot-key conflicts: no control message dropped, one log row per
    transaction, occupancy and conflict heat counted; and the driver's
    contract assertions (log too small, txn too wide, wave-less engine)."""
    tcl = engines[2]
    tsim = _tsim(engines)
    drv = TxnWaveDriver(tsim, TxnPlanner(tcl, device=CPU))
    txns = [Txn(txn_id=100 + i, writes=((0, i), ((i % 7) + 1, i)))
            for i in range(10)]
    state, results = drv.run(tsim.init_state(), txns)
    assert len(results) == len(txns)
    assert Coordinator.waves_drained(state)
    md = state.metrics.asdict()
    assert md["drops"] == 0, "wave control traffic was dropped"
    assert md["wave_commits"] + md["wave_aborts"] == len(txns)
    assert md["wave_occupancy"] > 0
    assert int(state.wave.log_cursor.sum()) == len(txns)
    assert md["lock_conflicts"] > 0
    assert int(state.metrics.conflict_heat.sum()) == md["lock_conflicts"]

    small = _tsim(engines, wave_log_capacity=4)
    sdrv = TxnWaveDriver(small, TxnPlanner(tcl, device=CPU))
    with pytest.raises(AssertionError, match="wave_log_capacity"):
        sdrv.run(small.init_state(), txns)
    with pytest.raises(AssertionError, match="wave_keys"):
        drv.run(state, [Txn(txn_id=1, writes=((0, 1), (1, 1), (2, 1),
                                              (3, 1)))])
    with pytest.raises(AssertionError, match="wave_depth"):
        TxnWaveDriver(_tsim(engines, wave_depth=0), drv.planner)


@pytest.mark.parametrize("depth", [0, 4])
def test_init_state_wave_leaves_match_reference(engines, depth):
    """The wave leaves the engine starts from, wave-less or not: the
    reference's shapes and values (a wave-less tick leaves them as
    they are)."""
    jcl = engines[0]
    kw = {**SIM_KW, "wave_depth": depth}
    jstate = JSim(jcl, **kw).init_state()
    tsim = _tsim(engines, wave_depth=depth)
    tstate = tsim.init_state()
    assert_tree_equal(jax.device_get(jstate.wave), tstate.wave, "wave")
    before = [x.clone() for x in tstate.wave if torch.is_tensor(x)]
    after = tsim.drain(tstate, 2).wave
    if depth == 0:
        assert all(a is b or torch.equal(a, b) for a, b in zip(
            [x for x in after if torch.is_tensor(x)], before))
