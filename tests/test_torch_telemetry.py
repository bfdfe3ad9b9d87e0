"""The port's telemetry plane (``repro_torch.core.telemetry``, the
telemetry wiring of ``ChainSim.tick`` and ``repro_torch.obs``) against
the reference.

* The recorders against the reference functions on seeded inputs
  (vmapped over the chain axis and jitted).
* A twin run: the reference ``ChainSim`` (telemetry on, its defaults)
  and the port's on one JAX-built schedule, snapshotted by both hubs
  before and after the drain: every leaf of the state, the telemetry
  leaves included, and the hubs' JSONL records are equal.
* Torch forms of ``tests/test_telemetry.py``'s eight behaviours and
  ``tests/test_telemetry_properties.py``'s two properties, on the port
  alone.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import telemetry as j_tel  # noqa: E402
from repro.core import types as j_types  # noqa: E402
from repro.core import workload as j_workload  # noqa: E402
from repro.core.chain import ChainSim as JSim  # noqa: E402
from repro.obs import TelemetryHub as JHub  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import telemetry as t_tel  # noqa: E402
from repro_torch.core import types as t_types  # noqa: E402
from repro_torch.core import workload as t_workload  # noqa: E402
from repro_torch.core.chain import ChainSim  # noqa: E402
from repro_torch.core.metrics import Metrics  # noqa: E402
from repro_torch.core.types import OPCLASS_NAMES, Msg  # noqa: E402
from repro_torch.obs import TelemetryHub, tail_percentiles  # noqa: E402
from torch_parity import CPU, assert_tree_equal  # noqa: E402

C, N, Q, TICKS, EXTRA = 2, 4, 4, 6, 16
CHAIN = dict(n_nodes=N, num_keys=16, num_versions=6)
SIM_KW = dict(inject_capacity=Q, route_capacity=64, reply_capacity=2048)


def _cluster():
    return t_types.ClusterConfig(chain=t_types.ChainConfig(**CHAIN),
                                 n_chains=C)


def _engine(telemetry: bool = True, **kw) -> ChainSim:
    return ChainSim(_cluster(), telemetry=telemetry, device=CPU,
                    **SIM_KW, **kw)


def _schedule(sim, seed: int = 11, wf: float = 0.3):
    wl = t_workload.WorkloadConfig(ticks=TICKS, queries_per_tick=Q,
                                   write_fraction=wf, entry_node=None,
                                   seed=seed)
    return t_workload.make_schedule(sim.cluster, wl, device=CPU)


def _run(sim, seed: int = 11, wf: float = 0.3):
    return sim.run(sim.init_state(), _schedule(sim, seed, wf),
                   extra_ticks=EXTRA)


# ---------------------------------------------------------------------------
# the recorders against the reference's
# ---------------------------------------------------------------------------
def _vj(fn, **static):
    return jax.jit(jax.vmap(lambda *a: fn(*a, **static)))


def _exit_batch(rng, M):
    ops = np.array([j_types.OP_NOP, j_types.OP_READ_REPLY,
                    j_types.OP_WRITE_REPLY, j_types.OP_TXN_REPLY,
                    j_types.OP_PREPARE_ACK, j_types.OP_WRITE_NACK,
                    j_types.OP_STALE_NACK, j_types.OP_PREPARE_NACK,
                    j_types.OP_ACK, j_types.OP_WRITE], np.int32)
    op = rng.choice(ops, (C, M)).astype(np.int32)
    seq = rng.integers(-2, 5, (C, M)).astype(np.int32)
    ticks = rng.integers(-1, 70_000, (C, M)).astype(np.int32)
    return op, seq, ticks


@pytest.mark.parametrize("seed", [0, 1])
def test_record_latency_and_op_class_match_reference(seed):
    rng = np.random.default_rng(seed)
    op, seq, ticks = _exit_batch(rng, 300)
    hist = rng.integers(0, 50, (C, 4, 16)).astype(np.int32)
    want = _vj(j_tel.record_latency)(jnp.asarray(hist), jnp.asarray(op),
                                     jnp.asarray(seq), jnp.asarray(ticks))
    got = t_tel.record_latency(torch.from_numpy(hist.copy()),
                               torch.from_numpy(op), torch.from_numpy(seq),
                               torch.from_numpy(ticks))
    assert_tree_equal(want, got, "lat_hist")
    np.testing.assert_array_equal(
        t_types.reply_op_class(torch.from_numpy(op),
                               torch.from_numpy(seq)).numpy(),
        np.asarray(j_types.reply_op_class(jnp.asarray(op),
                                          jnp.asarray(seq))))
    np.testing.assert_array_equal(
        t_types.reply_op_class(op, seq),
        j_types.reply_op_class(op, seq, xp=np))
    for n in (2, 16, 20):
        np.testing.assert_array_equal(
            t_tel.latency_bucket(torch.from_numpy(ticks), n).numpy(),
            np.asarray(j_tel.latency_bucket(jnp.asarray(ticks), n)))


def _tel_pair(rng, S, H, W, free_share):
    """The reference's and the port's Telemetry from one seeded state
    with some slots claimed and some traces full."""
    qid = np.where(rng.random((C, S)) < free_share, -1,
                   rng.integers(0, 5000, (C, S))).astype(np.int32)
    arr = dict(
        lat_hist=np.zeros((C, 4, 16), np.int32),
        ring=rng.integers(0, 9, (C, W, 8)).astype(np.int32),
        ring_cursor=rng.integers(0, 3 * W, (C,)).astype(np.int32),
        trace_qid=qid,
        trace_node=rng.integers(0, 4, (C, S, H)).astype(np.int32),
        trace_tick=rng.integers(0, 9, (C, S, H)).astype(np.int32),
        trace_op=rng.integers(0, 13, (C, S, H)).astype(np.int32),
        trace_len=rng.integers(0, H + 1, (C, S)).astype(np.int32),
    )
    j = j_tel.Telemetry(**{k: jnp.asarray(v) for k, v in arr.items()})
    return j, convert.telemetry_from(j_tel.Telemetry(**arr), CPU)


@pytest.mark.parametrize("seed,S,H,M", [(0, 16, 32, 320), (1, 4, 3, 1500),
                                        (2, 1, 1, 64)])
def test_record_trace_and_ring_match_reference(seed, S, H, M):
    """Dense qids so many arrivals sample and collide in slots; claimed
    and free slots, full traces; the lowest-flat-index tie rule."""
    rng = np.random.default_rng(seed)
    jt, tt = _tel_pair(rng, S, H, 6, 0.5)
    # sampled qids of this tick: multiples of 64 hash to sampled slots
    qid = np.where(rng.random((C, M)) < 0.5,
                   64 * rng.integers(0, 200, (C, M)),
                   rng.integers(-3, 5000, (C, M))).astype(np.int32)
    op = np.where(rng.random((C, M)) < 0.2, 0,
                  rng.integers(1, 13, (C, M))).astype(np.int32)
    node = np.repeat(np.arange(4, dtype=np.int32), M // 4 + 1)[:M]
    for t in (0, 7):
        jt = _vj(j_tel.record_trace)(jt, jnp.asarray(op), jnp.asarray(qid),
                                     jnp.broadcast_to(node, (C, M)),
                                     jnp.full((C,), t, jnp.int32))
        tt = t_tel.record_trace(tt, torch.from_numpy(op),
                                torch.from_numpy(qid),
                                torch.from_numpy(node),
                                torch.tensor(t, dtype=torch.int32))
        assert_tree_equal(jt, tt, f"trace t={t}")
    assert (np.asarray(jt.trace_len) > 0).any()
    for _ in range(8):
        row = rng.integers(0, 100, (C, 8)).astype(np.int32)
        jt = jax.vmap(j_tel.record_ring)(jt, jnp.asarray(row))
        tt = t_tel.record_ring(tt, torch.from_numpy(row))
    assert_tree_equal(jt, tt, "ring")


# ---------------------------------------------------------------------------
# a twin run against the reference engine, and the two hubs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def twin():
    """The reference engine (telemetry on, its defaults) and the port's
    on the reference's mixed schedule: the states and both hubs'
    snapshots before and after a drain."""
    jcl = j_types.ClusterConfig(chain=j_types.ChainConfig(**CHAIN),
                                n_chains=C)
    jsim = JSim(jcl, **SIM_KW)
    wl = j_workload.WorkloadConfig(ticks=TICKS, queries_per_tick=Q,
                                   write_fraction=0.3, entry_node=None,
                                   seed=11)
    jsched = j_workload.make_schedule(jcl, wl)
    tsim = ChainSim(convert.cluster_from(jcl), device=CPU, **SIM_KW)
    tsched = convert.from_arrays(Msg, jax.tree.map(np.asarray, jsched), CPU)
    jhub, thub = JHub(us_per_tick=2.5), TelemetryHub(us_per_tick=2.5)
    # tick by tick: the reference compiles one program (its tick)
    jempty, tempty = jsim.empty_injection(), tsim.empty_injection()
    jstate, tstate = jsim.init_state(), tsim.init_state()
    for t in range(TICKS + EXTRA):
        pick = lambda x, t=t: x[t]
        jinj = jax.tree.map(pick, jsched) if t < TICKS else jempty
        tinj = t_types.tree_map(pick, tsched) if t < TICKS else tempty
        jstate, tstate = jsim.tick(jstate, jinj), tsim.tick(tstate, tinj)
        if t == TICKS - 1:
            # copies: both engines update their state in place
            mid = (jax.tree.map(np.array, jstate),
                   t_types.tree_map(torch.clone, tstate))
            jhub.snapshot(jstate)
            thub.snapshot(tstate)
    jhub.snapshot(jstate)
    thub.snapshot(tstate)
    return dict(jstate=jstate, tstate=tstate, mid=mid, jhub=jhub, thub=thub)


def test_telemetry_run_matches_reference(twin):
    jmid, tmid = twin["mid"]
    for f in tmid._fields:
        assert_tree_equal(getattr(jmid, f), getattr(tmid, f), f"mid.{f}")
    jstate, tstate = twin["jstate"], twin["tstate"]
    for f in tstate._fields:
        assert_tree_equal(getattr(jstate, f), getattr(tstate, f), f)
    tel = tstate.telemetry
    assert int(tel.lat_hist.sum()) == int(tstate.replies.cursor.sum()) > 0
    assert (tel.trace_qid >= 0).any()
    assert (tel.ring_cursor == TICKS + EXTRA).all()


def test_hub_records_match_reference_hub(twin):
    jhub, thub = twin["jhub"], twin["thub"]
    assert thub.jsonl_records() == jhub.jsonl_records()
    assert thub.summary() == jhub.summary()
    assert thub.rates() == jhub.rates()
    assert thub.ring_window()[0].tolist() == jhub.ring_window()[0].tolist()
    jstate, tstate = twin["jstate"], twin["tstate"]
    assert (TelemetryHub.exact_percentiles(tstate.replies, us_per_tick=2.5)
            == JHub.exact_percentiles(jstate.replies, us_per_tick=2.5))
    assert (TelemetryHub.log_overflowed(tstate.replies)
            == JHub.log_overflowed(jstate.replies) is False)
    assert TelemetryHub.lock_health(tstate) == JHub.lock_health(jstate)
    pct, exact, overflowed = tail_percentiles(tstate, 2.5)
    assert not overflowed and pct == thub.percentiles(qs=(50.0, 99.0))
    assert exact == JHub.exact_percentiles(jstate.replies, qs=(50.0, 99.0),
                                           us_per_tick=2.5)


# ---------------------------------------------------------------------------
# tests/test_telemetry.py's behaviours on the port
# ---------------------------------------------------------------------------
def test_histogram_matches_exact_reply_log():
    state = _run(_engine())
    hub = TelemetryHub()
    hub.snapshot(state)
    pct = hub.percentiles(qs=(50.0, 90.0, 99.0))
    exact = TelemetryHub.exact_percentiles(state.replies,
                                           qs=(50.0, 90.0, 99.0))
    hist_total = int(state.telemetry.lat_hist.sum())
    assert hist_total == int(state.replies.cursor.sum()) > 0
    seen = 0
    for cname in OPCLASS_NAMES:
        if pct[cname] is None:
            assert exact[cname] is None
            continue
        seen += 1
        for qn, rec in pct[cname].items():
            assert rec["bucket"] == exact[cname][qn]["bucket"], (cname, qn)
            assert rec["ticks"] == 1 << rec["bucket"]
    assert seen >= 2


def test_latency_bucket_shared_math():
    for ticks, want in ((0, 0), (1, 0), (2, 1), (3, 1), (4, 2), (7, 2),
                        (8, 3), (1 << 14, 14), (1 << 15, 15), (1 << 20, 15)):
        assert int(t_tel.latency_bucket(np.asarray(ticks), 16)) == want
        assert int(t_tel.latency_bucket(torch.tensor(ticks), 16)) == want
    batch = np.asarray([1, 5, 9, 300])
    np.testing.assert_array_equal(t_tel.latency_bucket(batch, 16),
                                  [0, 2, 3, 8])


def test_ring_wraps_and_unwraps_to_last_window():
    state = _run(_engine(ring_window=4))
    total_ticks = int(state.t)
    assert total_ticks == TICKS + EXTRA
    np.testing.assert_array_equal(state.telemetry.ring_cursor.numpy(),
                                  total_ticks)
    hub = TelemetryHub()
    hub.snapshot(state)
    for window in hub.ring_window():
        assert window.shape == (4, len(t_tel.RING_FIELDS))
        np.testing.assert_array_equal(
            window[:, 0], np.arange(total_ticks - 4, total_ticks))


def test_trace_sampling_is_deterministic_and_hash_consistent():
    s1, s2 = _run(_engine()), _run(_engine())
    for a, b in zip(s1.telemetry, s2.telemetry):
        assert torch.equal(a, b)
    tel = s1.telemetry
    qids, lens = tel.trace_qid.numpy(), tel.trace_len.numpy()
    ticks, nodes = tel.trace_tick.numpy(), tel.trace_node.numpy()
    claimed = qids >= 0
    assert claimed.any(), "the seeded schedule samples at least one qid"
    mask = (1 << t_tel.TRACE_SAMPLE_BITS) - 1
    for c, s in zip(*np.nonzero(claimed)):
        q = int(qids[c, s])
        assert int(t_tel.trace_hash(q)) & mask == 0
        assert bool(t_tel.trace_sampled(q))
        h = int(lens[c, s])
        assert h >= 1
        assert np.all(np.diff(ticks[c, s, :h]) >= 1)
        assert np.all((nodes[c, s, :h] >= 0) & (nodes[c, s, :h] < N))


def test_telemetry_off_is_bit_identical_and_zero_size():
    on, off = _run(_engine(True)), _run(_engine(False))
    for f in on._fields:
        if f != "telemetry":
            assert_tree_equal(convert.to_numpy(getattr(on, f)),
                              getattr(off, f), f)
    assert off.telemetry.lat_hist.numel() == 0
    assert off.telemetry.ring.numel() == 0
    assert off.telemetry.trace_qid.numel() == 0
    assert all(x.numel() == 0 or x.dim() == 1 for x in off.telemetry)
    assert int(off.telemetry.ring_cursor.sum()) == 0


def test_heat_ewma_fixpoint_under_constant_load():
    heat = torch.tensor([[2, 4, 6], [1, 0, 3]], dtype=torch.int32)
    interval = Metrics.zeros(2, 3, device=CPU)._replace(conflict_heat=heat)
    total = interval.heat_per_bucket()
    assert total == [3, 4, 9]
    fix = [float(h) for h in total]
    assert interval.heat_ewma(fix, alpha=0.5) == fix
    cur = None
    for _ in range(60):
        cur = interval.heat_ewma(cur, alpha=0.3)
    assert cur == pytest.approx(fix, abs=1e-6)
    assert interval.heat_ewma(None, alpha=0.5) == [h / 2 for h in fix]


def test_hub_rates_jsonl_and_summary(tmp_path):
    sim = _engine()
    hub = TelemetryHub(us_per_tick=2.5)
    state = _run(sim)
    hub.snapshot(state)
    state = sim.drain(state, 4)
    hub.snapshot(state)
    rates = hub.rates()
    assert rates is not None and rates["replies"] >= 0.0
    assert set(rates) == {"replies", "packets", "drops", "lock_conflicts",
                          "stale_routes", "write_nacks", "lease_expiries"}
    path = tmp_path / "telemetry.jsonl"
    hub.write_jsonl(str(path))
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(recs) == 2
    assert all(r["kind"] == "telemetry_snapshot" for r in recs)
    assert recs[0]["rates"] is None and recs[1]["rates"] is not None
    assert recs[1]["percentiles"]["read"]["p50"]["us"] > 0
    assert recs[1]["ring"]["fields"][0] == "tick"
    text = hub.summary()
    assert "read" in text and "p999" in text and "rates/tick" in text


def test_snapshot_reads_returned_state_not_donated_input():
    """Snapshots are copies: a later tick, which updates the telemetry
    leaves in place, leaves an earlier snapshot as it was."""
    sim = _engine()
    hub = TelemetryHub()
    state = sim.init_state()
    sched = _schedule(sim)
    prev_total, kept = 0, []
    for t in range(TICKS):
        state = sim.tick(state, t_types.tree_map(lambda x: x[t], sched))
        snap = hub.snapshot(state)
        kept.append((snap, snap.lat_hist.copy()))
        total = int(snap.lat_hist.sum())
        assert total >= prev_total
        prev_total = total
    state = sim.drain(state, EXTRA)
    assert int(hub.snapshot(state).lat_hist.sum()) >= prev_total
    for snap, hist in kept:
        np.testing.assert_array_equal(snap.lat_hist, hist)


# ---------------------------------------------------------------------------
# tests/test_telemetry_properties.py's properties on the port
# ---------------------------------------------------------------------------
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


def _hist_percentile_bucket(ticks: np.ndarray, q: float) -> int:
    buckets = t_tel.latency_bucket(torch.from_numpy(ticks), 16).numpy()
    counts = np.bincount(buckets, minlength=16)
    rank = max(1, int(np.ceil(q / 100.0 * ticks.size)))
    return int(np.searchsorted(np.cumsum(counts), rank))


@given(st.lists(st.integers(min_value=1, max_value=200_000),
                min_size=1, max_size=400),
       st.sampled_from([50.0, 90.0, 99.0, 99.9]))
@settings(max_examples=25, deadline=None)
def test_histogram_percentile_is_the_exact_elements_bucket(ticks, q):
    arr = np.asarray(ticks, np.int32)
    rank = max(1, int(np.ceil(q / 100.0 * arr.size)))
    exact = int(np.sort(arr)[rank - 1])
    assert _hist_percentile_bucket(arr, q) == int(
        t_tel.latency_bucket(torch.tensor(exact), 16))


@given(st.integers(min_value=1, max_value=1 << 30))
@settings(max_examples=40, deadline=None)
def test_bucket_edges_are_log2(ticks):
    b = int(t_tel.latency_bucket(torch.tensor(ticks), 16))
    assert 0 <= b < 16
    assert (1 << b) <= max(ticks, 1)
    if b < 15:
        assert ticks < (1 << (b + 1))
