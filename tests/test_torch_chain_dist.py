"""The port's ``ChainDist`` (one chain node per rank, torch.distributed on
gloo CPU ranks) against the live reference ``ChainDist`` under
``shard_map`` on 8 emulated devices: every output of every step, exact.

Two configurations run on the same numpy-seeded client traffic:

* grouped 2 x 4 NetCRAQ with the telemetry plane, node 1 of chain 1
  failed and bucket 0 moved to chain 1 by each package's own
  ``Coordinator``, transaction ops at the heads, and client keys -1 and
  K among the reads and writes (stale routes and out-of-range keys);
* ungrouped 4-node NetChain, on 4 ranks.

The reference runs in a subprocess (jax pins its device count at
start) with one test-time shim: ``repro.core.chain.shard_map`` passes
its ``check_rep`` on as ``jax.shard_map(..., check_vma=...)``, the
keyword the installed jax takes; the JAX package is unchanged.  Its
sharded outputs become numpy arrays before anything slices them.  The
port's ranks run, in the same two spawns (8 gloo CPU ranks grouped, 4
ungrouped), the torch twins of the five behaviour tests of
``tests/test_chain_dist.py``.
"""
import concurrent.futures

import numpy as np
import pytest

import torch_dist_worker as W
from helpers import run_with_devices
from repro_torch.core import collectives as coll
from repro_torch.core.types import (
    CLIENT_BASE,
    OP_PREPARE_ACK,
    OP_PREPARE_NACK,
    OP_READ_REPLY,
    OP_WRITE_REPLY,
    OPCLASS_READ,
    OPCLASS_WRITE,
)

N = 4
# which spawn runs each behaviour twin: the grouped one on 2 x N ranks,
# the others on N
TWINS = {True: ["multichain"],
         False: ["roundtrip", "dead_node", "lock_stage", "telemetry"]}
TICKS, INJECT_TICKS = 18, 10

SPECS = {
    "craq_grouped": dict(protocol="netcraq", n=N, C=2, K=32, V=4, buckets=3,
                         spare=8, B=32, grouped=True, telemetry=True,
                         fails=[(1, 1)], moves=[(0, 1)], versions=(0, 1),
                         seed=5),
    "chain_ungrouped": dict(protocol="netchain", n=N, C=1, K=32, V=4, B=32,
                            grouped=False, telemetry=False, fails=[],
                            moves=[], versions=(0,), seed=6),
}
# chain 0's unmoved buckets hold slots 8-23 once bucket 0 has moved
TXN = {"craq_grouped": W.txn_script(0, 0, (9, 17), other_node=2) + [
           (0, 1, 0, W.OP_PREPARE, 12, 11, 5, 0),
           (2, 1, 0, W.OP_COMMIT, 12, 11, 5, 555)],
       "chain_ungrouped": W.txn_script(0, 0, (3, 5), other_node=1)}

REFERENCE = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.core import chain as _chain

def _shard_map(f, *, mesh, in_specs, out_specs, check_rep=True):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=check_rep)

_chain.shard_map = _shard_map
from repro.core import ChainConfig, ClusterConfig, ChainDist, ChainSim, Coordinator
from repro.core.types import Msg

data = dict(np.load(%(inp)r))
specs = %(specs)r
out = {}
for name, s in specs.items():
    cl = ClusterConfig(
        chain=ChainConfig(n_nodes=s["n"], num_keys=s["K"],
                          num_versions=s["V"], protocol=s["protocol"]),
        n_chains=s["C"], buckets_per_chain=s.get("buckets", 1),
        spare_keys=s.get("spare", 0))
    if s["grouped"]:
        mesh = jax.make_mesh((s["C"], s["n"]), ("cgroup", "chain"))
        dist = ChainDist(cl, mesh, axis="chain", group_axis="cgroup")
    else:
        mesh = jax.make_mesh((s["n"],), ("chain",))
        dist = ChainDist(cl, mesh, axis="chain")
    co = Coordinator(cl)
    for c, node in s["fails"]:
        co.fail_node(c, node)
    for bucket, dst in s["moves"]:
        co.rebalance(ChainSim(cl).init_state(), bucket, dst)
    roles = co.roles_table()
    if not s["grouped"]:
        roles = jax.tree.map(lambda x: x[0], roles)
    pmap = co.partition_map()
    for grp, tree in (("roles", roles), ("pmap", pmap)):
        for f in tree._fields:
            out[f"{name}/{grp}.{f}"] = np.asarray(getattr(tree, f))
    lead = (s["C"], s["n"]) if s["grouped"] else (s["n"],)
    B = s["B"]
    stores, locks = dist.init_state(), dist.init_locks()
    inbox = jax.tree.map(lambda x: jnp.tile(x[None], lead + (1,) * x.ndim),
                         Msg.empty(B))
    tel = dist.init_telemetry() if s["telemetry"] else None
    step = dist.make_step(B, telemetry=s["telemetry"])
    T = data[f"{name}/inj.op"].shape[0]
    for t in range(T):
        inj = Msg(*[jnp.asarray(data[f"{name}/inj.{f}"][t])
                    for f in Msg._fields])
        live = inj.op != 0
        assert not bool((live & (inbox.op != 0)).any()), (name, t)
        inbox = jax.tree.map(lambda a, b: jnp.where(
            live.reshape(live.shape + (1,) * (a.ndim - live.ndim)), b, a),
            inbox, inj)
        res = step(stores, inbox, roles, pmap, locks,
                   *((tel,) if s["telemetry"] else ()))
        stores, inbox, replies, locks = res[:4]
        trees = [("stores", stores), ("inbox", inbox), ("replies", replies),
                 ("locks", locks)]
        if s["telemetry"]:
            tel = res[4]
            trees.append(("telemetry", tel))
        for grp, tree in trees:
            for f in tree._fields:
                out[f"{name}/{t}/{grp}.{f}"] = np.asarray(getattr(tree, f))
np.savez(%(out)r, **out)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chain_dist")
    inp, out = str(tmp / "inputs.npz"), str(tmp / "reference.npz")
    arrays, port_specs, ref_specs = {}, {}, {}
    for name, s in SPECS.items():
        inj = W.client_injections(
            s["seed"], ticks=TICKS, inject_ticks=INJECT_TICKS,
            C=s["C"], n=s["n"], B=s["B"], q=4, K=s["K"],
            versions=s["versions"], txn=TXN[name])
        if not s["grouped"]:
            inj = {f: v[:, 0] for f, v in inj.items()}
        arrays.update({f"{name}/inj.{f}": v for f, v in inj.items()})
        roles, pmap = W.control_plane_inputs(s)
        port_specs[name] = dict(s, roles=roles, pmap=pmap, inj=inj)
        ref_specs[name] = {k: v for k, v in s.items()
                           if k not in ("versions", "seed")}
    np.savez(inp, **arrays)
    code = REFERENCE % dict(inp=inp, out=out, specs=ref_specs)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref_run = pool.submit(run_with_devices, code, 8, 300)
        port = {grouped: coll.spawn_ranks(
                    W.chain_dist_suite, 2 * N if grouped else N,
                    device="cpu", timeout=120,
                    args=({k: v for k, v in port_specs.items()
                           if v["grouped"] == grouped}, twins))
                for grouped, twins in TWINS.items()}
        assert "REFERENCE_OK" in ref_run.result()
    return dict(np.load(out)), port, port_specs


def _global(ranks, name, t, key, spec):
    """The port's global view of one leaf at step ``t``."""
    if spec["grouped"]:
        rows = [r["runs"][name][t][key][0, 0] for r in ranks]
        return np.stack(rows).reshape((spec["C"], N) + rows[0].shape)
    return np.stack([r["runs"][name][t][key][0] for r in ranks])


def test_control_plane_inputs_equal_the_reference(runs):
    ref, _, specs = runs
    for name, spec in specs.items():
        for grp in ("roles", "pmap"):
            for f, v in spec[grp].items():
                exp = ref[f"{name}/{grp}.{f}"]
                assert v.dtype == exp.dtype and np.array_equal(v, exp), (
                    name, grp, f)
    pm = specs["craq_grouped"]["pmap"]
    assert int(pm["epoch"]) == 1 and (pm["slot_bucket"][0, :8] == -1).all()


@pytest.mark.parametrize("name", list(SPECS))
def test_chain_dist_equals_reference_every_step(runs, name):
    ref, port, specs = runs
    spec = specs[name]
    ranks = port[spec["grouped"]]
    assert len(ranks) == spec["C"] * N
    compared = 0
    for t in range(TICKS):
        keys = [k[len(f"{name}/{t}/"):] for k in ref
                if k.startswith(f"{name}/{t}/")]
        for key in keys:
            exp = ref[f"{name}/{t}/{key}"]
            if key.startswith("locks."):
                for r, rank in enumerate(ranks):
                    got = rank["runs"][name][t][key][0]
                    row = exp[r // N]
                    assert got.dtype == row.dtype
                    assert np.array_equal(got, row), (t, key, r)
                continue
            got = _global(ranks, name, t, key, spec)
            assert got.dtype == exp.dtype and got.shape == exp.shape, (
                t, key, got.shape, exp.shape)
            if not np.array_equal(got, exp):
                bad = np.argwhere(got != exp)[:4].tolist()
                raise AssertionError(f"step {t} {key} differs at {bad}")
            compared += 1
    assert compared >= TICKS * 4
    # the traffic exercised what it was written for
    replies = [ref[f"{name}/{t}/replies.op"] for t in range(TICKS)]
    ops = np.concatenate([r.reshape(-1) for r in replies])
    assert (ops == OP_READ_REPLY).sum() > 0 and (ops == OP_WRITE_REPLY).sum() > 0
    assert (ops == OP_PREPARE_ACK).sum() >= 1
    assert (ops == OP_PREPARE_NACK).sum() >= 1
    last = TICKS - 1
    assert (ref[f"{name}/{last}/inbox.op"] == 0).all(), "did not drain"
    assert (ref[f"{name}/{last}/locks.holder"] == -1).all()


# ---------------------------------------------------------------------------
# torch twins of tests/test_chain_dist.py's behaviours (each chain
# group's position 0 reports)
# ---------------------------------------------------------------------------
def _reports(runs, twin):
    _, port, _ = runs
    ranks = port[twin in TWINS[True]]
    reps = [ranks[r][twin] for r in range(0, len(ranks), N)]
    assert reps and len(reps) == len(ranks) // N, twin
    return reps


def test_chain_dist_write_read_roundtrip(runs):
    for rep in _reports(runs, "roundtrip"):
        assert rep["stores"]["values"][:, 3, 0, 0].tolist() == [99] * 4
        assert rep["stores"]["pending"][:, 3].tolist() == [0] * 4
        r = rep["replies"]
        live = r["op"] != 0
        assert live.sum() == 1 and r["value"][live][0, 0] == 99


def test_chain_dist_serves_with_dead_node(runs):
    for rep in _reports(runs, "dead_node"):
        assert rep["stores"]["values"][:, 3, 0, 0].tolist() == [99, 0, 99, 99]
        assert rep["stores"]["pending"][:, 3].tolist() == [0] * 4
        r = rep["replies"]
        live = r["op"] != 0
        assert live.sum() == 1 and r["value"][live][0, 0] == 99


def test_chain_dist_multichain_groups(runs):
    for rep in _reports(runs, "multichain"):
        v = rep["stores"]["values"]
        assert v[1, :, 5, 0, 0].tolist() == [123] * 4
        assert v[0, :, 5, 0, 0].tolist() == [0] * 4     # chain 0 untouched
        assert int(rep["stores"]["pending"].sum()) == 0
        r = rep["replies"]
        live = r["op"] != 0
        assert live.sum() == 1 and r["value"][live][0, 0] == 123
        assert live[1, 2].sum() == 1
        assert (rep["locks"]["holder"] == -1).all()


def test_chain_dist_lock_stage(runs):
    for rep in _reports(runs, "lock_stage"):
        r = rep["first"]["replies"]
        ops = r["op"][r["op"] != 0].tolist()
        assert sorted(ops) == sorted([OP_PREPARE_ACK, OP_PREPARE_NACK])
        assert rep["first"]["locks"]["holder"][0, 3] == 7
        assert rep["first"]["locks"]["client"][0, 3] == CLIENT_BASE + 1
        assert rep["locks"]["holder"][0, 3] == -1
        assert rep["locks"]["version"][0, 3] == 1
        assert rep["stores"]["values"][:, 3, 0, 0].tolist() == [99] * 4


def test_chain_dist_telemetry_hist(runs):
    for rep in _reports(runs, "telemetry"):
        ops = rep["reply_ops"]
        seen_r = int((ops == OP_READ_REPLY).sum())
        seen_w = int((ops == OP_WRITE_REPLY).sum())
        assert seen_r == 1 and seen_w == 1
        hist = rep["tel"]["lat_hist"]
        flat = hist.reshape((-1,) + hist.shape[-2:]).sum(axis=0)
        assert int(flat[OPCLASS_READ].sum()) == seen_r
        assert int(flat[OPCLASS_WRITE].sum()) == seen_w
        assert int(flat.sum()) == seen_r + seen_w
        assert rep["tel"]["ring_cursor"].tolist() == [9] * 4
        read_b = int(np.nonzero(flat[OPCLASS_READ])[0][0])
        write_b = int(np.nonzero(flat[OPCLASS_WRITE])[0][0])
        assert read_b == 0 and write_b >= read_b


def test_spawned_ranks_import_no_jax():
    """The module the spawned ranks import names neither JAX nor the JAX
    package."""
    import ast
    import pathlib

    tree = ast.parse(pathlib.Path(W.__file__).read_text())
    roots = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_ungrouped_chain_dist_takes_one_rank_a_node():
    """An ungrouped engine is one chain on exactly ``n`` ranks, as the
    reference's is a mesh of ``n`` devices; more chains need
    ``group_axis=True``."""
    from repro_torch.core import ChainDist
    from repro_torch.core.types import ChainConfig

    cfg = ChainConfig(n_nodes=N, num_keys=16, num_versions=4,
                      protocol="netcraq")
    with pytest.raises(AssertionError, match=f"needs {N} ranks, not 8"):
        ChainDist(cfg, rank=0, world=2 * N, device="cpu")
