"""The port's NetCRAQ cluster tick against the reference ``ChainSim``.

Both engines get the same JAX-built schedule (the port's own
``make_schedule`` draws the same bits: ``tests/test_torch_workload.py``)
and are compared exactly after every tick: stores, inbox, lock table,
metrics and reply log.  Also here: the workload router, the hygiene
rules of the port (no JAX, no ``repro`` imports; CUDA by default).
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import types as j_types  # noqa: E402
from repro.core import workload as j_workload  # noqa: E402
from repro.core.chain import full_roles_table  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import store as t_store  # noqa: E402
from repro_torch.core import types as t_types  # noqa: E402
from repro_torch.core import workload as t_workload  # noqa: E402
from repro_torch.core.chain import ChainSim as TSim  # noqa: E402
from torch_parity import (  # noqa: E402
    CPU,
    assert_states_equal,
    assert_tree_equal,
    injection,
    make_pair,
    out_of_range_ticks,
    run_pair,
    schedule_ticks,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
WL = j_workload.WorkloadConfig(ticks=8, queries_per_tick=8,
                               write_fraction=0.4, seed=3)


@pytest.fixture(scope="module")
def engines():
    """One reference engine per fabric (each compiles its tick once)."""
    return {fabric: make_pair("netcraq", fabric)
            for fabric in ("segmented", "dense")}


def _fresh(jsim):
    jstate = jsim.init_state()
    return jstate, convert.state_from_arrays(jstate, CPU)


@pytest.mark.parametrize("fabric", ["segmented", "dense"])
def test_netcraq_tick_matches_reference(engines, fabric):
    jcl, jsim, tsim = engines[fabric]
    sched = j_workload.make_schedule(jcl, WL)
    jstate, tstate = _fresh(jsim)
    jstate, tstate = run_pair(jsim, tsim, jstate, tstate,
                              schedule_ticks(sched), 8, f"netcraq-{fabric}")
    m = tstate.metrics.asdict()
    assert m == jstate.metrics.asdict()
    assert m["dirty_appends"] > 0 and m["fwd_reads"] > 0 and m["acks"] > 0
    assert tsim.inflight(tstate) == 0


def test_netcraq_run_and_drain_match_reference(engines):
    """``ChainSim.run`` (schedule, then ``drain``) ends where the
    reference's tick-by-tick run ends."""
    jcl, jsim, tsim = engines["segmented"]
    sched = j_workload.make_schedule(jcl, WL)
    jstate, tstate = _fresh(jsim)
    for inj in schedule_ticks(sched):
        jstate = jsim.tick(jstate, inj)
    for _ in range(8):
        jstate = jsim.tick(jstate, jsim.empty_injection())
    tstate = tsim.run(tstate, convert.from_arrays(t_types.Msg, sched, CPU),
                      extra_ticks=8, assert_drained=True)
    assert_states_equal(jstate, tstate, "run")
    with pytest.raises(AssertionError, match="still in flight"):
        tsim.run(tsim.init_state(), convert.from_arrays(t_types.Msg, sched, CPU),
                 extra_ticks=0, assert_drained=True)


def test_dead_node_matches_reference(engines):
    """Chain 0 runs with node 1 spliced out: injections into its lanes
    are black-holed, writes skip it, hop accounting uses live
    positions."""
    jcl, jsim, tsim = engines["segmented"]
    one = j_types.Roles.from_membership(4, [0, 2, 3])
    roles = jax.tree.map(lambda full, r: full.at[0].set(r),
                         full_roles_table(4, 2), one)
    jstate, _ = _fresh(jsim)
    jstate = jstate._replace(roles=roles)
    tstate = convert.state_from_arrays(jstate, CPU)
    sched = j_workload.make_schedule(jcl, WL)
    jstate, tstate = run_pair(jsim, tsim, jstate, tstate,
                              schedule_ticks(sched), 8, "dead-node")
    assert tstate.metrics.asdict()["drops"] > 0


@pytest.mark.parametrize("from_node", [False, True])
def test_out_of_range_keys_match_reference(engines, from_node):
    """READs and WRITEs with keys outside ``[0, K)`` (-1, K, -K - 1,
    K + 6).  From clients the partition-epoch admission NACKs them.
    From a node they reach the store and take the reference's
    clamp-on-gather, wrap-and-drop-on-scatter path through the kv_engine
    ops.  Every op is answered or NACKed."""
    jcl, jsim, tsim = engines["segmented"]
    ticks = out_of_range_ticks(jcl, from_node)
    jstate, tstate = _fresh(jsim)
    jstate, tstate = run_pair(jsim, tsim, jstate, tstate, ticks, 8,
                              f"out-of-range-{from_node}")
    offered = sum(int((np.asarray(t.op) != j_types.OP_NOP).sum())
                  for t in ticks)
    m = tstate.metrics.asdict()
    assert m["replies"] + m["stale_routes"] == offered and m["drops"] == 0
    assert (m["stale_routes"] == 0) == from_node
    if from_node:
        assert m["dirty_appends"] > 0 and m["fwd_reads"] > 0
    assert tsim.inflight(tstate) == 0


def test_lock_stage_traffic_matches_reference(engines):
    """PREPARE/COMMIT/ABORT through the head lock stage: a same-batch
    conflict, a misdirected PREPARE, release-then-acquire in one batch,
    an invalid release, and a lease that expires under a straggler
    COMMIT (chain 1 runs a 2-tick lease)."""
    jcl, jsim, tsim = engines["segmented"]
    P, Cm, A, Wr = (j_types.OP_PREPARE, j_types.OP_COMMIT, j_types.OP_ABORT,
                    j_types.OP_WRITE)
    ticks = [
        injection(jcl, [
            (0, 0, 0, P, 5, 101, 0), (0, 0, 1, P, 5, 102, 0),
            (0, 0, 2, P, 7, 103, 0), (0, 2, 0, P, 9, 104, 0),
            (1, 0, 0, P, 3, 201, 0), (1, 0, 1, Wr, 3, -1, 77),
        ]),
        injection(jcl, [
            (0, 0, 0, Cm, 5, 101, 555), (0, 0, 1, A, 7, 103, 0),
            (0, 0, 2, Cm, 7, 999, 1), (0, 0, 3, P, 5, 105, 0),
        ]),
        jsim.empty_injection(),
        injection(jcl, [(1, 0, 0, Cm, 3, 201, 333)]),
    ]
    jstate, _ = _fresh(jsim)
    lease = jnp.asarray([j_types.LEASE_OFF, 2], jnp.int32)
    jstate = jstate._replace(locks=jstate.locks._replace(lease_ticks=lease))
    tstate = convert.state_from_arrays(jstate, CPU)
    jstate, tstate = run_pair(jsim, tsim, jstate, tstate, ticks, 8, "txn")
    m = tstate.metrics.asdict()
    assert m["txn_commits"] == 1 and m["txn_aborts"] == 1
    assert m["lock_conflicts"] == 2 and m["lease_expiries"] == 1
    assert int((tstate.locks.holder != -1).sum()) == 1   # txn 105 holds k5


@pytest.mark.parametrize("map_kind", ["home", "moved", "stale_client"])
def test_route_stream_matches_reference(map_kind):
    """A global-key stream of reads, writes, transaction ops, NOPs and
    out-of-range keys packs into identical lanes with identical loss
    counts, under the home map, a moved map, and a stale client."""
    rng = np.random.default_rng(4)
    jcl = j_types.ClusterConfig(
        chain=j_types.ChainConfig(n_nodes=3, num_keys=32), n_chains=2,
        buckets_per_chain=2, spare_keys=8)
    tcl = t_types.ClusterConfig(
        chain=t_types.ChainConfig(n_nodes=3, num_keys=32), n_chains=2,
        buckets_per_chain=2, spare_keys=8)
    T, Q = 3, 40
    f = {k: np.array(v) for k, v in j_types.Msg.empty(T * Q)._asdict().items()}
    f = {k: v.reshape((T, Q) + v.shape[1:]) for k, v in f.items()}
    f["op"] = rng.choice([0, 1, 1, 2, 7, 10], (T, Q)).astype(np.int32)
    f["key"] = rng.integers(-2, jcl.num_global_keys + 3, (T, Q)).astype(
        np.int32)
    f["qid"] = np.arange(T * Q, dtype=np.int32).reshape(T, Q)
    stream = j_types.Msg(**{k: jnp.asarray(v) for k, v in f.items()})
    jp = jcl.default_partition()
    owner = np.asarray(jp.owner).copy()
    base = np.asarray(jp.base).copy()
    owner[1], base[1] = 1, jcl.keys_in_use   # bucket 1 moved to chain 1
    epoch = np.zeros((2, 32), np.int32)
    epoch[1, jcl.keys_in_use:] = 1
    epoch[0, jcl.bucket_slots:jcl.keys_in_use] = 1
    moved_j = j_types.PartitionMap.build(
        owner, base, 1, n_chains=2, num_keys=32,
        bucket_slots=jcl.bucket_slots, slot_epoch=epoch)
    moved_t = convert.from_arrays(t_types.PartitionMap, moved_j, CPU)
    tp = convert.from_arrays(t_types.PartitionMap, jp, CPU)
    args = {"home": ((None, None), (None, None)),
            "moved": ((moved_j, None), (moved_t, None)),
            "stale_client": ((jp, moved_j), (tp, moved_t))}[map_kind]
    exp = j_workload.route_stream(jcl, stream, 6, *args[0])
    got = t_workload.route_stream(tcl, convert.from_arrays(t_types.Msg, stream, CPU),
                                  6, *args[1])
    assert_tree_equal(exp.lanes, got.lanes, "lanes")
    for f in ("dropped", "out_of_range", "stale"):
        assert int(getattr(got, f)) == int(getattr(exp, f)), f
    assert int(got.dropped) > 0 and int(got.out_of_range) > 0
    if map_kind == "stale_client":
        assert int(got.stale) > 0


def test_make_schedule_lanes_and_drain():
    """The port's own schedule: same seed, same lanes; writes only on the
    head lane; keys in range; unique query ids; and it drains through
    the port's engine."""
    tcl = t_types.ClusterConfig(
        chain=t_types.ChainConfig(n_nodes=4, num_keys=64, num_versions=6),
        n_chains=2)
    wl = t_workload.WorkloadConfig(ticks=6, queries_per_tick=8,
                                   write_fraction=0.3, seed=5)
    a = t_workload.make_schedule(tcl, wl, device=CPU)
    b = t_workload.make_schedule(tcl, wl, device=CPU)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.op.shape == (6, 2, 4, 8)
    writes = a.op == t_types.OP_WRITE
    assert writes.any() and not writes[:, :, 1:].any()
    live = a.op != t_types.OP_NOP
    assert ((a.key >= 0) & (a.key < 64))[live].all()
    assert a.qid[live].unique().numel() == int(live.sum())
    zipf = t_workload.make_schedule(
        tcl, t_workload.WorkloadConfig(ticks=2, key_skew="zipf"), device=CPU)
    assert zipf.key.max() < 64
    sim = TSim(tcl, inject_capacity=8, route_capacity=32, device=CPU)
    state = sim.run(sim.init_state(), a, extra_ticks=8, assert_drained=True)
    m = state.metrics.asdict()
    assert m["replies"] == int(live.sum()) and m["drops"] == 0


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10 and files[-1].exists()
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = t_types.ChainConfig(num_keys=16)
    cl = t_types.ClusterConfig(chain=cfg, n_chains=2)
    for call in (
        lambda: TSim(cl),
        lambda: t_workload.make_schedule(cl, t_workload.WorkloadConfig()),
        lambda: t_store.init_store(cfg),
        lambda: t_types.Msg.empty(4),
        lambda: cl.default_partition(),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_unported_settings_raise():
    """No setting of the tick is left unported: the telemetry plane is
    accepted, on by default with the reference's sizes, and so is the
    wave table."""
    import inspect

    from repro.core.chain import ChainSim as JSim

    cl = t_types.ClusterConfig(chain=t_types.ChainConfig(num_keys=16))
    names = ("telemetry", "hist_buckets", "ring_window", "trace_slots",
             "trace_hops")
    defaults = lambda cls: {k: v.default for k, v in inspect.signature(
        cls.__init__).parameters.items() if k in names}
    assert defaults(TSim) == defaults(JSim) == {
        "telemetry": True, "hist_buckets": 16, "ring_window": 64,
        "trace_slots": 16, "trace_hops": 32}
    tel = TSim(cl, device=CPU).init_state().telemetry
    assert tel.lat_hist.shape == (1, 4, 16) and tel.ring.shape == (1, 64, 8)
    assert tel.trace_node.shape == (1, 16, 32)
    sim = TSim(cl, telemetry=True, wave_depth=2, device=CPU)
    assert sim.init_state().wave.phase.shape == (1, 2)
