"""The port's open-loop load generator (``repro_torch.core.loadgen``) and
``ChainSim.run_openloop`` against the reference.

* The draws (``draw_tick``, ``followup_commits``, ``materialize_stream``)
  and one tick of admission (``gen_tick``, with a full backlog) against
  the reference's, exactly.
* Twin open-loop runs on one engine shape (one reference program) below
  saturation (uniform; zipf with transactions and bursts) and overloaded
  until it sheds: stores, metrics, reply logs, every telemetry leaf and
  the generator's backlog are equal, and so are the two hubs' JSONL
  records.
* Torch forms of ``tests/test_loadgen.py``'s seven cases, on the port
  alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import loadgen as j_loadgen  # noqa: E402
from repro.core import types as j_types  # noqa: E402
from repro.core.chain import ChainSim as JSim  # noqa: E402
from repro.obs import TelemetryHub as JHub  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import loadgen as t_loadgen  # noqa: E402
from repro_torch.core import types as t_types  # noqa: E402
from repro_torch.core.chain import ChainSim  # noqa: E402
from repro_torch.core.types import OP_NOP, Msg  # noqa: E402
from repro_torch.core.workload import route_stream  # noqa: E402
from repro_torch.obs import TelemetryHub  # noqa: E402
from torch_parity import CPU, assert_tree_equal  # noqa: E402

CHAIN = dict(n_nodes=3, num_keys=16, num_versions=6)
# lane capacity C * n * q = 24 a tick, 8 of them the heads' write lanes
SHAPE = dict(q=4, width=48, ticks=30, extra=24, backlog=16, reply=8192)
MIXES = {
    "uniform": dict(qps=5.0, write_fraction=0.25, seed=7, burst_period=5,
                    burst_len=2, burst_mult=2.0),
    "zipf_txn": dict(qps=5.0, write_fraction=0.25, txn_fraction=0.2,
                     key_skew="zipf", seed=7, burst_period=5, burst_len=2,
                     burst_mult=2.0),
    "overload": dict(qps=20.0, write_fraction=0.5, txn_fraction=0.25,
                     key_skew="zipf", seed=3),
}


def _jcluster():
    return j_types.ClusterConfig(chain=j_types.ChainConfig(**CHAIN),
                                 n_chains=2)


def _cluster(n_chains=2, n_nodes=3, num_keys=16):
    return t_types.ClusterConfig(
        chain=t_types.ChainConfig(n_nodes=n_nodes, num_keys=num_keys,
                                  num_versions=6), n_chains=n_chains)


def _sim(cl, q=8, reply_capacity=4096):
    return ChainSim(cl, inject_capacity=q, route_capacity=128,
                    reply_capacity=reply_capacity, device=CPU)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the draws and one tick of admission against the reference's
# ---------------------------------------------------------------------------
_JITTED = {}


def _jitted(name, static):
    """The reference's eager helper ``name``, jitted once per module."""
    if name not in _JITTED:
        _JITTED[name] = jax.jit(getattr(j_loadgen, name),
                                static_argnums=static)
    return _JITTED[name]


@pytest.mark.parametrize("mix", ["uniform", "zipf_txn", "overload"])
def test_draws_match_reference(mix):
    jcl = _jcluster()
    jg = j_loadgen.make_loadgen(jcl, **MIXES[mix])
    tg = t_loadgen.make_loadgen(convert.cluster_from(jcl), **MIXES[mix],
                                device=CPU)
    assert_tree_equal(_np(jg), tg, "make_loadgen")
    for t in (0, 1, 7, 1000):
        for name in ("draw_tick", "followup_commits"):
            want = _jitted(name, (1, 2))(jg, 16, 4, jnp.int32(t))
            got = getattr(t_loadgen, name)(tg, 16, 4,
                                           torch.tensor(t, dtype=torch.int32))
            assert_tree_equal(want, got, f"{name}(t={t})")
    want = _jitted("materialize_stream", (1, 2, 3))(jg, jcl, 16, 12)
    got = t_loadgen.materialize_stream(tg, convert.cluster_from(jcl), 16, 12)
    assert_tree_equal(want, got, "materialize_stream")
    assert_tree_equal(j_loadgen.zipf_cdf(jcl, 0.9),
                      t_loadgen.zipf_cdf(convert.cluster_from(jcl), 0.9,
                                         device=CPU), "zipf_cdf")


# ---------------------------------------------------------------------------
# twin open-loop runs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def twins():
    """Every mix through the reference's open loop (one program: the
    shapes are the same) and the port's."""
    jcl = _jcluster()
    kw = dict(inject_capacity=SHAPE["q"], route_capacity=128,
              reply_capacity=SHAPE["reply"])
    jsim = JSim(jcl, **kw)
    tsim = ChainSim(convert.cluster_from(jcl), device=CPU, **kw)
    run = dict(arrival_width=SHAPE["width"], extra_ticks=SHAPE["extra"])
    out = {}
    for mix in MIXES:
        jg = j_loadgen.make_loadgen(jcl, backlog_capacity=SHAPE["backlog"],
                                    **MIXES[mix])
        tg = convert.loadgen_from(_np(jg), CPU)
        jstate, jg = jsim.run_openloop(jsim.init_state(), jg,
                                       SHAPE["ticks"], **run)
        tstate, tg = tsim.run_openloop(tsim.init_state(), tg,
                                       SHAPE["ticks"], **run)
        out[mix] = (jstate, jg, tstate, tg)
    return jcl, out


def _check_twin(jstate, jg, tstate, tg, what):
    for f in tstate._fields:
        assert_tree_equal(getattr(jstate, f), getattr(tstate, f),
                          f"{what}.{f}")
    assert_tree_equal(jg, tg, f"{what}.gen")
    jhub, thub = JHub(), TelemetryHub()
    jhub.snapshot(jstate)
    thub.snapshot(tstate)
    assert thub.jsonl_records() == jhub.jsonl_records(), what


@pytest.mark.parametrize("mix", ["uniform", "zipf_txn"])
def test_openloop_below_saturation_matches_reference(twins, mix):
    jstate, jg, tstate, tg = twins[1][mix]
    _check_twin(jstate, jg, tstate, tg, mix)
    m = tstate.metrics.asdict()
    assert m["offered"] > 0 and m["admission_drops"] == 0
    if mix == "zipf_txn":
        assert m["txn_commits"] > 0


def test_overloaded_openloop_matches_reference(twins):
    jstate, jg, tstate, tg = twins[1]["overload"]
    _check_twin(jstate, jg, tstate, tg, "overload")
    assert tstate.metrics.asdict()["admission_drops"] > 0
    assert int((tg.backlog.op != OP_NOP).sum()) > 0


def test_gen_tick_with_a_full_backlog_matches_reference(twins):
    """One more tick of admission from the overloaded run's backlog."""
    jcl, out = twins
    jstate, jg, tstate, tg = out["overload"]
    step = _jitted("gen_tick", (1, 2, 3))
    t = SHAPE["ticks"] + SHAPE["extra"]
    want = step(jg, jcl, SHAPE["width"], SHAPE["q"], jnp.int32(t))
    got = t_loadgen.gen_tick(tg, convert.cluster_from(jcl), SHAPE["width"],
                             SHAPE["q"], torch.tensor(t, dtype=torch.int32))
    for i, name in enumerate(("injection", "gen", "offered", "shed")):
        assert_tree_equal(want[i], got[i], name)


# ---------------------------------------------------------------------------
# tests/test_loadgen.py's cases on the port
# ---------------------------------------------------------------------------
def _reply_tuples(state):
    log = state.replies.merged()
    n = int(log.cursor)
    cols = [np.asarray(x)[:n] for x in
            (log.qid, log.op, log.seq, log.ticks_in_flight, log.hops)]
    return sorted(zip(*cols))


@pytest.mark.parametrize("key_skew,wf,tf", [
    ("uniform", 0.25, 0.0),
    ("zipf", 0.25, 0.2),
])
def test_openloop_matches_materialized_replay(key_skew, wf, tf):
    cl = _cluster()
    width, ticks, q = 8, 20, 8
    mk = lambda: t_loadgen.make_loadgen(
        cl, qps=5.0, write_fraction=wf, txn_fraction=tf, key_skew=key_skew,
        seed=7, burst_period=5, burst_len=2, burst_mult=2.0,
        backlog_capacity=32, device=CPU)
    sim = _sim(cl, q=q)
    state, g = sim.run_openloop(sim.init_state(), mk(), ticks,
                                arrival_width=width, extra_ticks=16,
                                assert_drained=True)
    assert int(state.metrics.admission_drops.sum()) == 0
    assert int((g.backlog.op != OP_NOP).sum()) == 0
    routed = route_stream(cl, t_loadgen.materialize_stream(mk(), cl, width,
                                                           ticks), q)
    assert int(routed.dropped) == 0, "dense arm clipped - not comparable"
    ref_sim = _sim(cl, q=q)
    ref = ref_sim.run(ref_sim.init_state(), routed.lanes, extra_ticks=16,
                      assert_drained=True)
    for a, b in zip(state.stores, ref.stores):
        assert torch.equal(a, b), "stores diverged"
    a, b = _reply_tuples(state), _reply_tuples(ref)
    assert len(a) > 0 and a == b, (len(a), len(b))


def test_backpressure_defers_then_sheds_with_exact_conservation():
    cl = _cluster()
    sim = _sim(cl, q=4, reply_capacity=8192)
    g = t_loadgen.make_loadgen(cl, qps=20.0, write_fraction=1.0,
                               backlog_capacity=16, device=CPU)
    state, g = sim.run_openloop(sim.init_state(), g, 40, arrival_width=48,
                                extra_ticks=24, assert_drained=True)
    offered = int(state.metrics.offered.sum())
    shed = int(state.metrics.admission_drops.sum())
    deferred = int((g.backlog.op != OP_NOP).sum())
    delivered = int(state.replies.cursor.sum())
    assert not TelemetryHub.log_overflowed(state.replies)
    assert shed > 0, "overload never shed - backpressure untested"
    assert offered == delivered + shed + deferred, (
        offered, delivered, shed, deferred)
    log = state.replies.merged()
    assert np.asarray(log.ticks_in_flight)[:int(log.cursor)].max() > 4


def test_offered_tracks_the_arrival_law():
    cl = _cluster()
    sim = _sim(cl, q=8)
    g = t_loadgen.make_loadgen(cl, qps=8.0, backlog_capacity=32, device=CPU)
    state, g = sim.run_openloop(sim.init_state(), g, 64, arrival_width=16,
                                extra_ticks=16)
    offered = int(state.metrics.offered.sum())
    assert 0.8 * 512 < offered < 1.2 * 512, offered


def test_latency_grows_with_offered_load():
    cl = _cluster()

    def mean_tif(qps, width):
        sim = _sim(cl, q=4, reply_capacity=8192)
        g = t_loadgen.make_loadgen(cl, qps=qps, write_fraction=0.5,
                                   backlog_capacity=64, device=CPU)
        state, g = sim.run_openloop(sim.init_state(), g, 40,
                                    arrival_width=width, extra_ticks=32,
                                    assert_drained=True)
        log = state.replies.merged()
        return float(np.asarray(log.ticks_in_flight)[:int(log.cursor)].mean())

    assert mean_tif(24.0, 48) > mean_tif(2.0, 48) + 1.0


def test_txn_mix_commits_land():
    cl = _cluster()
    sim = _sim(cl, q=8)
    g = t_loadgen.make_loadgen(cl, qps=4.0, txn_fraction=1.0,
                               backlog_capacity=32, device=CPU)
    state, g = sim.run_openloop(sim.init_state(), g, 24, arrival_width=8,
                                extra_ticks=16, assert_drained=True)
    assert int(state.metrics.admission_drops.sum()) == 0
    md = state.metrics.asdict()
    assert md["txn_commits"] > 0, md


def test_replylog_lost_flags_overflow():
    cl = _cluster()
    small = _sim(cl, q=8, reply_capacity=16)
    g = t_loadgen.make_loadgen(cl, qps=8.0, backlog_capacity=32, device=CPU)
    state, g = small.run_openloop(small.init_state(), g, 32,
                                  arrival_width=16, extra_ticks=16)
    assert TelemetryHub.log_overflowed(state.replies)
    delivered = int(state.replies.cursor.sum())
    lost = int(state.replies.lost.sum())
    assert lost > 0
    assert int(state.telemetry.lat_hist.sum()) == delivered + lost
    big = _sim(cl, q=8, reply_capacity=8192)
    g2 = t_loadgen.make_loadgen(cl, qps=8.0, backlog_capacity=32, device=CPU)
    state2, g2 = big.run_openloop(big.init_state(), g2, 32,
                                  arrival_width=16, extra_ticks=16)
    assert not TelemetryHub.log_overflowed(state2.replies)
    assert int(state2.replies.lost.sum()) == 0


def test_run_openloop_donates_both_carries():
    """Rebind both: the returned state and generator carry the run on,
    and two rebound runs equal the reference's two donated runs."""
    cl = _cluster()
    sim = _sim(cl, q=4)
    g = t_loadgen.make_loadgen(cl, qps=2.0, backlog_capacity=16, device=CPU)
    state, g = sim.run_openloop(sim.init_state(), g, 4, arrival_width=8,
                                extra_ticks=4)
    assert int(state.t) == 8
    newer, g = sim.run_openloop(state, g, 4, arrival_width=8, extra_ticks=4)
    assert int(newer.t) == 16
    assert int(newer.metrics.offered.sum()) >= int(
        state.metrics.offered.sum())
    # the second run drew ticks 8..11: its qids sit in those ticks' blocks
    log = newer.replies.merged()
    qid = np.asarray(log.qid)[:int(log.cursor)]
    assert (qid < 12 * 16).all()
    assert isinstance(g.backlog, Msg) and g.backlog.op.shape == (16,)
