"""Shared harness of the port's tick-parity tests: build the reference
``ChainSim`` and the port's on the same configuration (the telemetry
plane off unless asked for), feed both the same (JAX-built) injections
tick by tick, and compare their states exactly (the wave table and the
telemetry leaves too)."""
import jax
import numpy as np
import torch

from repro.core import types as j_types
from repro.core.chain import ChainSim as JSim
from repro_torch import convert
from repro_torch.core import types as t_types
from repro_torch.core.chain import ChainSim as TSim
from repro_torch.core.types import Msg as TMsg

# One intra-op thread: the suite runs several test workers on one host,
# and the port's many small CPU ops under torch's default OpenMP pool
# oversubscribe its cores (a port test took 65 s so, 8 s with one thread,
# beside a running suite).  Every worker imports this module when it
# collects the port's tests.
torch.set_num_threads(1)

CPU = "cpu"
COMPARED = ("stores", "inbox", "locks", "metrics", "replies", "telemetry",
            "t")


def make_pair(protocol: str, fabric: str, *, C=2, n=4, K=64, V=6, c_in=8,
              c_route=32, reply_capacity=256, telemetry=False):
    """(reference cluster, reference sim, port sim) on one configuration,
    both with ``telemetry`` (off, zero-size leaves, unless asked)."""
    chain = dict(n_nodes=n, num_keys=K, num_versions=V, protocol=protocol)
    jcl = j_types.ClusterConfig(chain=j_types.ChainConfig(**chain),
                                n_chains=C)
    tcl = t_types.ClusterConfig(chain=t_types.ChainConfig(**chain),
                                n_chains=C)
    kw = dict(inject_capacity=c_in, route_capacity=c_route,
              reply_capacity=reply_capacity, fabric=fabric,
              telemetry=telemetry)
    return jcl, JSim(jcl, **kw), TSim(tcl, device=CPU, **kw)


def assert_tree_equal(exp, got, path: str) -> None:
    """Exact equality, dtypes included, of two same-named NamedTuples."""
    if hasattr(got, "_fields"):
        for f in got._fields:
            assert_tree_equal(getattr(exp, f), getattr(got, f),
                              f"{path}.{f}")
        return
    e = np.asarray(exp)
    g = convert.to_numpy(got)
    assert g.dtype == e.dtype, (path, g.dtype, e.dtype)
    assert g.shape == e.shape, (path, g.shape, e.shape)
    if not np.array_equal(g, e):
        bad = np.argwhere(g != e)[:4]
        raise AssertionError(
            f"{path} differs at {bad.tolist()}: port "
            f"{[g[tuple(b)] for b in bad]} reference "
            f"{[e[tuple(b)] for b in bad]}")


def assert_states_equal(jstate, tstate, where: str) -> None:
    wave = ("wave",) if tstate.wave.phase.shape[1] > 0 else ()
    for f in COMPARED + wave:
        assert_tree_equal(getattr(jstate, f), getattr(tstate, f),
                          f"{where}.{f}")


def run_pair(jsim, tsim, jstate, tstate, injections, drain_ticks: int,
             label: str):
    """Tick both engines through ``injections`` (reference ``Msg``s of
    [C, n, c_in]) and ``drain_ticks`` empty ticks, comparing the states
    after every tick.  Returns the final (reference, port) states."""
    empty = jsim.empty_injection()
    steps = list(injections) + [empty] * drain_ticks
    for i, inj in enumerate(steps):
        tinj = convert.from_arrays(TMsg, inj, CPU)
        jstate = jsim.tick(jstate, inj)
        tstate = tsim.tick(tstate, tinj)
        assert_states_equal(jstate, tstate, f"{label}[tick {i}]")
    return jstate, tstate


def check_serializable(cluster, state, txns, results) -> None:
    """The serializability oracle of ``tests/helpers.py`` on a port
    state after a drain: committed transactions applied whole, an acyclic
    observed write order, its serial replay equal to every global key,
    and the replicas converged.  ``txns`` and ``results`` are the port's.
    """
    import torch

    from repro_torch.core.txn import (committed_view, reference_execute,
                                      serial_order)

    by_id = {t.txn_id: t for t in txns}
    committed = {r.txn_id for r in results if r.committed}
    for r in results:
        if r.committed:
            assert set(r.write_seqs) == {k for k, _ in by_id[r.txn_id].writes}
    order = serial_order(results)
    tail = [t for t in sorted(committed) if t not in set(order)]
    expected = reference_execute([by_id[t] for t in order + tail])
    view = committed_view(cluster, state)
    for gk in range(cluster.num_global_keys):
        assert view[gk] == expected.get(gk, 0), (gk, view[gk])
    vals = state.stores.values[..., 0, 0]
    assert torch.equal(vals, vals[:, -1:].expand_as(vals))


def schedule_ticks(schedule):
    """The per-tick injections of a reference [T, C, n, q] schedule."""
    T = schedule.op.shape[0]
    return [jax.tree.map(lambda x, i=i: x[i], schedule) for i in range(T)]


def injection(jcl, ops, c_in=8, from_node=False):
    """A [C, n, c_in] reference injection of hand-placed client ops:
    (chain, node, slot, op, key, seq, value0).  ``from_node`` gives each
    op its node as source, as if a chain node had sent it: such an op
    skips the partition-epoch admission that client ops pass."""
    C, n = jcl.n_chains, jcl.n_nodes
    f = {k: np.array(v) for k, v in
         j_types.Msg.empty(C * n * c_in)._asdict().items()}
    f = {k: v.reshape((C, n, c_in) + v.shape[1:]) for k, v in f.items()}
    for i, (c, node, slot, op, key, seq, val) in enumerate(ops):
        at = (c, node, slot)
        f["op"][at], f["key"][at], f["seq"][at] = op, key, seq
        f["value"][at][0] = val
        f["src"][at] = f["client"][at] = j_types.CLIENT_BASE + 40 + i
        if from_node:
            f["src"][at] = node
        f["dst"][at] = node
        f["qid"][at] = 9000 + i
    return j_types.Msg(**{k: jax.numpy.asarray(v) for k, v in f.items()})


def out_of_range_ticks(jcl, from_node=False):
    """READs and WRITEs whose keys lie outside ``[0, K)``: -1 and -K - 1
    (a negative index the reference wraps once), K and K + 6, mixed with
    reads of keys 0 and K - 1.  From clients, the partition-epoch
    admission NACKs every out-of-range op.  From a node (``from_node``)
    they reach the store, whose reference gathers clamp such a key and
    whose scatters wrap it once and drop it if it is still out of range:
    writes are sequenced, acknowledged and answered, and land only where
    the wrapped key is in range."""
    K = jcl.chain.num_keys
    R, W = j_types.OP_READ, j_types.OP_WRITE
    odd = (-1, K, -K - 1, K + 6)
    first = [(c, 0, s, W, key, -1, 100 + 10 * c + s)
             for c in range(jcl.n_chains) for s, key in enumerate(odd)]
    reads = [(c, node, s, R, key, 0, 0)
             for c in range(jcl.n_chains) for node in range(jcl.n_nodes)
             for s, key in enumerate(odd + (0, K - 1))]
    again = [(0, 0, 0, W, -1, -1, 300), (1, 0, 0, W, K + 6, -1, 301),
             (0, 2, 0, R, -1, 0, 0), (1, 3, 0, R, K - 1, 0, 0)]
    return [injection(jcl, ops, from_node=from_node)
            for ops in (first, reads, again, reads)]
