"""The port's NetChain (chain replication) tick and its routing fabrics
against the reference, exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import random_outbox_fields  # noqa: E402
from repro.core import chain as j_chain  # noqa: E402
from repro.core import types as j_types  # noqa: E402
from repro.core import workload as j_workload  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import chain as t_chain  # noqa: E402
from repro_torch.core.types import Msg as TMsg  # noqa: E402
from torch_parity import (  # noqa: E402
    CPU,
    assert_tree_equal,
    make_pair,
    out_of_range_ticks,
    run_pair,
    schedule_ticks,
)

WL = j_workload.WorkloadConfig(ticks=8, queries_per_tick=8,
                               write_fraction=0.3, seed=7)


@pytest.fixture(scope="module")
def engines():
    return {fabric: make_pair("netchain", fabric)
            for fabric in ("segmented", "dense")}


@pytest.mark.parametrize("fabric", ["segmented", "dense"])
def test_netchain_tick_matches_reference(engines, fabric):
    jcl, jsim, tsim = engines[fabric]
    sched = j_workload.make_schedule(jcl, WL)
    jstate = jsim.init_state()
    tstate = convert.state_from_arrays(jstate, CPU)
    jstate, tstate = run_pair(jsim, tsim, jstate, tstate,
                              schedule_ticks(sched), 12,
                              f"netchain-{fabric}")
    m = tstate.metrics.asdict()
    assert m == jstate.metrics.asdict()
    assert m["relay_procs"] > 0 and m["writes_in"] > 0


def test_netchain_dead_tail_and_frozen_chain_match_reference(engines):
    """Chain 0 loses its tail (node 3); chain 1 is frozen, so its client
    writes NACK at the entry node."""
    jcl, jsim, tsim = engines["segmented"]
    dead = j_types.Roles.from_membership(4, [0, 1, 2])
    frozen = j_types.Roles.from_membership(4, [0, 1, 2, 3], frozen=True)
    roles = jax.tree.map(lambda a, b: jnp.stack([a, b]), dead, frozen)
    jstate = jsim.init_state()._replace(roles=roles)
    tstate = convert.state_from_arrays(jstate, CPU)
    sched = j_workload.make_schedule(jcl, WL)
    jstate, tstate = run_pair(jsim, tsim, jstate, tstate,
                              schedule_ticks(sched), 12, "netchain-dead")
    m = tstate.metrics.asdict()
    assert m["write_nacks"] > 0 and m["drops"] > 0


@pytest.mark.parametrize("from_node", [False, True])
def test_netchain_out_of_range_keys_match_reference(engines, from_node):
    """READs and WRITEs with keys outside ``[0, K)``: from clients the
    admission NACKs them; from a node they reach the store, where the
    tail answers the clamped register and overwrites land only at a
    wrapped in-range key.  Every op is answered or NACKed."""
    jcl, jsim, tsim = engines["segmented"]
    ticks = out_of_range_ticks(jcl, from_node)
    jstate = jsim.init_state()
    tstate = convert.state_from_arrays(jstate, CPU)
    jstate, tstate = run_pair(jsim, tsim, jstate, tstate, ticks, 12,
                              f"netchain-out-of-range-{from_node}")
    offered = sum(int((np.asarray(t.op) != j_types.OP_NOP).sum())
                  for t in ticks)
    m = tstate.metrics.asdict()
    assert m["replies"] + m["stale_routes"] == offered and m["drops"] == 0
    assert (m["stale_routes"] == 0) == from_node
    assert tsim.inflight(tstate) == 0


def _outbox(seed, C, n, width, **kw):
    """[C, n * width] reference outbox plus alive/chain_pos tables, one
    chain with a dead node."""
    rng = np.random.default_rng(seed)
    per_chain = [random_outbox_fields(rng, n, width, **kw) for _ in range(C)]
    flat = j_types.Msg(**{k: jnp.asarray(np.stack([p[k] for p in per_chain]))
                          for k in per_chain[0]})
    alive = np.ones((C, n), bool)
    alive[0, 1] = False
    chain_pos = np.tile(np.arange(n, dtype=np.int32), (C, 1))
    chain_pos[0] = [0, -1] + list(range(1, n - 1))
    return flat, jnp.asarray(alive), jnp.asarray(chain_pos)


@pytest.mark.parametrize("fabric,seed,kw", [
    ("segmented", 0, {}),
    ("segmented", 1, {"mcast_heavy": True}),
    ("segmented", 2, {"adversarial_src": True}),
    ("dense", 3, {"mcast_heavy": True}),
])
def test_fabric_matches_reference_on_random_outboxes(fabric, seed, kw):
    """Per-destination FIFO, capacity truncation, multicast fan-out and
    hop accounting, drop counts - the reference's fabric vmapped over
    chains vs the port's chain-batched one."""
    C, n, width, c_route = 2, 4, 12, 10
    flat, alive, chain_pos = _outbox(seed, C, n, width, **kw)
    M = n * width
    lane = M if kw.get("adversarial_src") else c_route + M // n
    if fabric == "dense":
        exp = jax.vmap(lambda f, a, p: j_chain.dense_route(f, a, p, c_route)
                       )(flat, alive, chain_pos)
        got = t_chain.dense_route(
            convert.from_arrays(TMsg, flat, CPU), torch.from_numpy(
                np.array(alive)), torch.from_numpy(np.array(chain_pos)),
            c_route)
    else:
        exp = jax.vmap(lambda f, a, p: j_chain.segmented_route(
            f, a, p, c_route, mcast_lane=lane))(flat, alive, chain_pos)
        got = t_chain.segmented_route(
            convert.from_arrays(TMsg, flat, CPU), torch.from_numpy(
                np.array(alive)), torch.from_numpy(np.array(chain_pos)),
            c_route, mcast_lane=lane)
    assert_tree_equal(exp[0], got[0], "routed")
    for name, e, g in zip(("dropped", "mcast_copies", "mcast_hop_sum"),
                          exp[1:], got[1:]):
        assert_tree_equal(np.asarray(e).astype(np.int32), g, name)
    assert int(got[1].sum()) > 0 or int(got[2].sum()) > 0
