"""Per-rank workers of the port's multi-rank tests (``ChainDist``, the
collectives, ``serve/kv_cache.py``), run by
``repro_torch.core.collectives.spawn_ranks``.

The spawned processes import this module to find their function, so it
imports torch, numpy and the port only, never JAX.  Inputs arrive as
numpy arrays in the global view (``[C, n, ...]`` or ``[n, ...]``); each
rank cuts its shard and returns its local outputs as numpy arrays, which
the test assembles and holds to the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import collectives as coll
from repro_torch.core.chain import ChainDist, ChainSim
from repro_torch.core.coordinator import Coordinator
from repro_torch.core.types import (
    CLIENT_BASE,
    OP_ABORT,
    OP_COMMIT,
    OP_PREPARE,
    OP_READ,
    OP_WRITE,
    ChainConfig,
    ClusterConfig,
    Msg,
    PartitionMap,
    Roles,
    tree_map,
)
from repro_torch.kernels.kv_engine import kernel as kv_kernel
from repro_torch.serve import kv_cache as KV


# ---------------------------------------------------------------------------
# inputs (numpy, shared by the tests and the reference's run)
# ---------------------------------------------------------------------------
def empty_lanes(shape, W: int = 4) -> dict:
    """Numpy ``Msg.empty`` fields of batch ``shape``."""
    z = lambda: np.zeros(shape, np.int32)
    neg = lambda: np.full(shape, -1, np.int32)
    return dict(op=z(), key=z(), value=np.zeros(shape + (W,), np.int32),
                seq=neg(), src=z(), dst=neg(), client=z(), entry=z(),
                qid=neg(), t_inject=z(), extra=z(), ver=z())


def client_injections(seed: int, *, ticks: int, inject_ticks: int, C: int,
                      n: int, B: int, q: int, K: int, W: int = 4,
                      per_node: int = 2, write_fraction: float = 0.3,
                      versions=(0,), txn=()) -> dict:
    """Seeded client traffic ``[ticks, C, n, B]`` in the last ``q`` lanes
    of each node's batch: up to ``per_node`` reads and writes a node a
    tick for ``inject_ticks`` ticks, keys over ``[-1, K]`` (both ends
    outside the register file), map stamps from ``versions``; ``txn``
    lists ``(tick, chain, node, op, key, txn_id, client, value)``
    transaction ops, placed after the tick's reads and writes."""
    rng = np.random.default_rng(seed)
    f = empty_lanes((ticks, C, n, B), W)
    qid = 0
    fill = np.zeros((ticks, C, n), np.int64)

    def put(t, c, p, op, key, seq, client, value, ver):
        nonlocal qid
        lane = B - q + int(fill[t, c, p])
        assert lane < B, "more client ops than injection lanes"
        fill[t, c, p] += 1
        at = (t, c, p, lane)
        f["op"][at], f["key"][at], f["seq"][at] = op, key, seq
        f["value"][at] = value
        f["src"][at] = f["client"][at] = CLIENT_BASE + client
        f["dst"][at], f["qid"][at], f["t_inject"][at] = p, qid, t
        f["ver"][at] = ver
        qid += 1

    for t in range(inject_ticks):
        for c in range(C):
            for p in range(n):
                for _ in range(int(rng.integers(0, per_node + 1))):
                    op = OP_WRITE if rng.random() < write_fraction else OP_READ
                    put(t, c, p, op, int(rng.integers(-1, K + 1)), -1,
                        int(rng.integers(0, 64)),
                        rng.integers(0, 1 << 30, W), int(rng.choice(versions)))
    for (t, c, p, op, key, txn_id, client, value) in txn:
        put(t, c, p, op, key, txn_id, client, [value] + [0] * (W - 1),
            max(versions))
    return f


def txn_script(chain: int, head: int, keys, *, other_node: int) -> list:
    """PREPARE/COMMIT/ABORT traffic at a chain's head: a conflict (the
    second PREPARE of a key NACKs), a commit, an abort, an invalid
    release and a PREPARE at a node that is not the head."""
    k0, k1 = keys
    return [
        (0, chain, head, OP_PREPARE, k0, 7, 1, 0),
        (0, chain, head, OP_PREPARE, k0, 8, 2, 0),
        (1, chain, head, OP_PREPARE, k1, 9, 3, 0),
        (1, chain, other_node, OP_PREPARE, k1, 10, 4, 0),
        (3, chain, head, OP_COMMIT, k0, 7, 1, 1234),
        (4, chain, head, OP_ABORT, k1, 9, 3, 0),
        (5, chain, head, OP_COMMIT, k1, 9, 3, 77),
    ]


def to_msg(fields: dict, device="cpu") -> Msg:
    return Msg(**{f: torch.from_numpy(np.array(fields[f])).to(device)
                  for f in Msg._fields})


def to_tree(cls, fields: dict, device="cpu"):
    return cls(**{f: torch.from_numpy(np.array(fields[f])).to(device)
                  for f in cls._fields})


def host(tree) -> dict:
    """A NamedTuple of tensors as a dict of numpy copies."""
    return {f: getattr(tree, f).cpu().numpy().copy() for f in tree._fields}


def numpy_tree(tree, prefix: str) -> dict:
    return {f"{prefix}.{f}": x for f, x in host(tree).items()}


def merge(inbox: Msg, inj: Msg) -> Msg:
    """The step's inbox plus this tick's client ops, which take lanes the
    engine left empty (checked)."""
    live = inj.op != 0
    assert not bool((live & (inbox.op != 0)).any()), (
        "client lanes collide with carried traffic: the load is over "
        "the batch")
    return tree_map(
        lambda a, b: torch.where(
            live.reshape(live.shape + (1,) * (a.dim() - live.dim())), b, a),
        inbox, inj)


# ---------------------------------------------------------------------------
# ChainDist runs
# ---------------------------------------------------------------------------
def cluster_of(spec: dict) -> ClusterConfig:
    chain = ChainConfig(n_nodes=spec["n"], num_keys=spec["K"],
                        num_versions=spec["V"], protocol=spec["protocol"])
    return ClusterConfig(chain=chain, n_chains=spec["C"],
                         buckets_per_chain=spec.get("buckets", 1),
                         spare_keys=spec.get("spare", 0))


def control_plane_inputs(spec: dict) -> tuple:
    """The role table and partition map (numpy) from the port's
    ``Coordinator`` after ``spec``'s failures and bucket moves."""
    cl = cluster_of(spec)
    co = Coordinator(cl, device="cpu")
    for c, node in spec["fails"]:
        co.fail_node(c, node)
    for bucket, dst in spec["moves"]:
        co.rebalance(ChainSim(cl, device="cpu").init_state(), bucket, dst)
    roles = co.roles_table()
    if not spec["grouped"]:
        roles = Roles(*[x[0] for x in roles])
    npy = lambda t: {f: getattr(t, f).numpy() for f in t._fields}
    return npy(roles), npy(co.partition_map())


def run_dist(rank: int, world: int, dev, spec: dict) -> list:
    """``spec``'s run on this rank: the global role table, partition map
    and injections in numpy, ``spec["grouped"]`` and ``spec["telemetry"]``.
    Returns each step's local outputs (numpy)."""
    grouped, tel_on, B = spec["grouped"], spec["telemetry"], spec["B"]
    d = ChainDist(cluster_of(spec), rank=rank, world=world,
                  group_axis=grouped, device=dev)
    roles = d.shard(to_tree(Roles, spec["roles"]))
    pmap = d.local_pmap(to_tree(PartitionMap, spec["pmap"]))
    stores, locks = d.init_state(), d.init_locks()
    inbox = Msg.empty(d.lead + (B,), device=dev)
    tel = d.init_telemetry() if tel_on else None
    step = d.make_step(B, telemetry=tel_on)
    inj = spec["inj"]
    out = []
    for t in range(inj["op"].shape[0]):
        inbox = merge(inbox, d.shard(to_msg({f: v[t] for f, v in
                                             inj.items()})))
        res = step(stores, inbox, roles, pmap, locks,
                   *((tel,) if tel_on else ()))
        stores, inbox, replies, locks = res[:4]
        rec = {**numpy_tree(stores, "stores"), **numpy_tree(inbox, "inbox"),
               **numpy_tree(replies, "replies"), **numpy_tree(locks, "locks")}
        if tel_on:
            tel = res[4]
            rec.update(numpy_tree(tel, "telemetry"))
        out.append(rec)
    return out


# the reference tests' client, qid and chain shape (tests/test_chain_dist.py)
def _inject(d: ChainDist, B: int, *entries) -> Msg:
    """A global injection with one client op per entry ``(node, slot, op,
    key, value, seq, client, t)`` (grouped: ``(chain, node, ...)``), cut to
    this rank's shard."""
    shape = (d.C, d.n, B) if d.grouped else (d.n, B)
    f = empty_lanes(shape, d.cfg.value_words)
    for e in entries:
        at, (op, key, value, seq, client, t) = (
            (e[:3], e[3:]) if d.grouped else (e[:2], e[2:]))
        f["op"][at], f["key"][at], f["seq"][at] = op, key, seq
        f["value"][at + (0,)] = value
        f["src"][at] = f["client"][at] = CLIENT_BASE + client
        f["qid"][at] = 40 + at[-1] if op in (OP_PREPARE,) else 42
        f["dst"][at], f["t_inject"][at] = at[-2], t
    return d.shard(to_msg(f, d.device))


def _twin_engine(rank, world, dev, grouped=False, telemetry=False):
    cfg = ChainConfig(n_nodes=4, num_keys=16, num_versions=4,
                      protocol="netcraq")
    cl = ClusterConfig(chain=cfg, n_chains=2) if grouped else cfg
    d = ChainDist(cl, rank=rank, world=world, group_axis=grouped, device=dev)
    return d, d.make_step(8, telemetry=telemetry)


def twin_roundtrip(rank, world, dev) -> dict:
    d, step = _twin_engine(rank, world, dev)
    stores, roles, pmap, locks = (d.init_state(), d.full_roles(),
                                  d.default_pmap(), d.init_locks())
    inbox = _inject(d, 8, (0, 0, OP_WRITE, 3, 99, -1, 7, 0))
    for _ in range(8):
        stores, inbox, replies, locks = step(stores, inbox, roles, pmap,
                                             locks)
    after_write = host(d.gather(stores))
    inbox = _inject(d, 8, (2, 0, OP_READ, 3, 0, -1, 7, 0))
    stores, inbox, replies, locks = step(stores, inbox, roles, pmap, locks)
    return dict(stores=after_write, replies=host(d.gather(replies)))


def twin_dead_node(rank, world, dev) -> dict:
    d, step = _twin_engine(rank, world, dev)
    co = Coordinator(d.cfg, device="cpu")
    co.fail_node(0, 1)
    roles = d.shard(tree_map(lambda x: x[0], co.roles_table()))
    stores, pmap, locks = d.init_state(), d.default_pmap(), d.init_locks()
    inbox = _inject(d, 8, (0, 0, OP_WRITE, 3, 99, -1, 7, 0))
    for _ in range(8):
        stores, inbox, replies, locks = step(stores, inbox, roles, pmap,
                                             locks)
    after_write = host(d.gather(stores))
    inbox = _inject(d, 8, (2, 0, OP_READ, 3, 0, -1, 7, 0))
    stores, inbox, replies, locks = step(stores, inbox, roles, pmap, locks)
    return dict(stores=after_write, replies=host(d.gather(replies)))


def twin_multichain(rank, world, dev) -> dict:
    d, step = _twin_engine(rank, world, dev, grouped=True)
    stores, roles, pmap, locks = (d.init_state(), d.full_roles(),
                                  d.default_pmap(), d.init_locks())
    inbox = _inject(d, 8, (1, 0, 0, OP_WRITE, 5, 123, -1, 7, 0))
    for _ in range(8):
        stores, inbox, replies, locks = step(stores, inbox, roles, pmap,
                                             locks)
    after_write = host(d.gather(stores))
    inbox = _inject(d, 8, (1, 2, 0, OP_READ, 5, 0, -1, 7, 0))
    stores, inbox, replies, locks = step(stores, inbox, roles, pmap, locks)
    return dict(stores=after_write, replies=host(d.gather(replies)),
                locks=host(d.gather_rows(locks)))


def twin_lock_stage(rank, world, dev) -> dict:
    d, step = _twin_engine(rank, world, dev)
    stores, roles, pmap, locks = (d.init_state(), d.full_roles(),
                                  d.default_pmap(), d.init_locks())
    inbox = _inject(d, 8, (0, 0, OP_PREPARE, 3, 0, 7, 1, 0),
                    (0, 1, OP_PREPARE, 3, 0, 8, 2, 0))
    stores, inbox, replies, locks = step(stores, inbox, roles, pmap, locks)
    first = dict(replies=host(d.gather(replies)), locks=host(locks))
    inbox = _inject(d, 8, (0, 0, OP_COMMIT, 3, 99, 7, 1, 0))
    for _ in range(8):
        stores, inbox, replies, locks = step(stores, inbox, roles, pmap,
                                             locks)
    return dict(first=first, locks=host(locks),
                stores=host(d.gather(stores)))


def twin_telemetry(rank, world, dev) -> dict:
    d, step = _twin_engine(rank, world, dev, telemetry=True)
    stores, roles, pmap, locks = (d.init_state(), d.full_roles(),
                                  d.default_pmap(), d.init_locks())
    tel = d.init_telemetry()
    replies_seen = []
    inbox = _inject(d, 8, (0, 0, OP_WRITE, 3, 99, -1, 7, 0))
    for _ in range(8):
        stores, inbox, replies, locks, tel = step(stores, inbox, roles,
                                                  pmap, locks, tel)
        replies_seen.append(host(d.gather(replies))["op"])
    inbox = _inject(d, 8, (2, 0, OP_READ, 3, 0, -1, 7, 8))
    stores, inbox, replies, locks, tel = step(stores, inbox, roles, pmap,
                                              locks, tel)
    replies_seen.append(host(d.gather(replies))["op"])
    return dict(reply_ops=np.stack(replies_seen), tel=host(d.gather(tel)))


TWINS = {"roundtrip": twin_roundtrip, "dead_node": twin_dead_node,
         "multichain": twin_multichain, "lock_stage": twin_lock_stage,
         "telemetry": twin_telemetry}


def chain_dist_suite(rank: int, world: int, dev, specs: dict,
                     twins: list) -> dict:
    """Every parity run of ``specs`` and the behaviour twins named in
    ``twins``, on one world.  Each rank returns its own steps; a twin's
    global views come back from each chain group's position 0."""
    out = {"runs": {name: run_dist(rank, world, dev, spec)
                    for name, spec in specs.items()}}
    for name in twins:
        res = TWINS[name](rank, world, dev)
        if rank % 4 == 0:
            out[name] = res
    return out


def cuda_vs_cpu(rank: int, world: int, dev, spec: dict) -> dict:
    """``spec``'s run on this rank's card and on the CPU (the plain
    versions), every output of every step; the card run's kv launches
    per step.  Returns the first difference, or None."""
    kv_kernel.LAUNCHES.update({k: 0 for k in kv_kernel.LAUNCHES})
    gpu = run_dist(rank, world, dev, spec)
    launches = dict(kv_kernel.LAUNCHES)
    cpu = run_dist(rank, world, torch.device("cpu"), spec)
    for t, (g, c) in enumerate(zip(gpu, cpu)):
        for k in c:
            if not np.array_equal(g[k], c[k]):
                return dict(diff=f"step {t} {k}", launches=launches)
    return dict(diff=None, launches=launches, steps=len(gpu))


def backend_run(rank: int, world: int, dev, spec: dict, data: dict) -> dict:
    """``spec``'s run and each collective on ``data``
    (``collectives_run``) on this rank's device, with the kv launches of
    the run, to hold one backend's ranks to another's."""
    kv_kernel.LAUNCHES.update({k: 0 for k in kv_kernel.LAUNCHES})
    chain = run_dist(rank, world, dev, spec)
    launches = dict(kv_kernel.LAUNCHES)
    return dict(chain=chain, launches=launches,
                coll=collectives_run(rank, world, dev, data))


# ---------------------------------------------------------------------------
# collectives and kv_cache
# ---------------------------------------------------------------------------
def collectives_run(rank: int, world: int, dev, data: dict) -> dict:
    """Each collective on this rank's row of ``data`` (``[world, ...]``
    arrays keyed by dtype name), over chain groups of 4."""
    g = coll.chain_group(4)
    coll.reset_bytes()
    out = {"layout": (g.index, g.pos, g.ranks)}
    for name, arr in data.items():
        x = torch.from_numpy(np.array(arr[rank])).to(dev)
        if name == "bfloat16":
            x = x.view(torch.bfloat16)
        res = {"ppermute": coll.ppermute_next(x, g),
               "all_gather": coll.all_gather_tiled(x, g),
               "broadcast": coll.broadcast_from(x, g.n - 1, g)}
        if name != "bfloat16":
            res["psum"] = coll.psum(x, g)
        out[name] = {k: (v.view(torch.int16) if v.dtype == torch.bfloat16
                         else v).cpu().numpy() for k, v in res.items()}
    out["bytes"] = dict(coll.BYTES_SENT)
    return out


def kv_cache_run(rank: int, world: int, dev, datasets: dict) -> dict:
    """The four kv_cache protocols on this rank's rows of each dataset
    (``k``, ``v`` pages, ``seq``, ``failed``; int16 arrays are bf16 bit
    patterns), one chain group of ``world`` ranks."""
    g = coll.chain_group(world)

    def mine(a):
        x = torch.from_numpy(np.array(a[rank])).to(dev)
        return x.view(torch.bfloat16) if a.dtype == np.int16 else x

    host = lambda x: (x.view(torch.int16) if x.dtype == torch.bfloat16
                      else x).cpu().numpy()
    out = {}
    for name, data in datasets.items():
        page = (mine(data["k"]), mine(data["v"]))
        seq = mine(data["seq"])
        coll.reset_bytes()
        own, replica, ack = KV.netcraq_append(page, seq, group=g)
        craq_bytes = dict(coll.BYTES_SENT)
        coll.reset_bytes()
        fetched = KV.netchain_read(page, group=g)
        read_bytes = dict(coll.BYTES_SENT)
        coll.reset_bytes()
        committed, ack2 = KV.netchain_append(page, seq, group=g)
        chain_bytes = dict(coll.BYTES_SENT)
        chosen = KV.failover_select(page, replica, mine(data["failed"]))
        out[name] = dict(
            own=[host(x) for x in own], replica=[host(x) for x in replica],
            ack=host(ack), fetched=[host(x) for x in fetched],
            committed=[host(x) for x in committed], ack2=host(ack2),
            chosen=[host(x) for x in chosen], craq_bytes=craq_bytes,
            read_bytes=read_bytes, chain_bytes=chain_bytes)
    return out


def kv_cuda_vs_cpu(rank: int, world: int, dev, datasets: dict) -> dict:
    """``kv_cache_run`` on this rank's card and on the CPU; returns the
    first output that differs, or None."""
    gpu = kv_cache_run(rank, world, dev, datasets)
    cpu = kv_cache_run(rank, world, torch.device("cpu"), datasets)
    for name, out in gpu.items():
        for key, got in out.items():
            exp = cpu[name][key]
            if key.endswith("bytes"):
                same = got == exp
            else:
                pairs = zip(got, exp) if isinstance(got, list) else [
                    (got, exp)]
                same = all(np.array_equal(a, b) for a, b in pairs)
            if not same:
                return dict(diff=f"{name} {key}")
    return dict(diff=None)


def raise_on(rank: int, world: int, dev, bad: int, how: str):
    """A rank that fails while the others wait in a collective."""
    import os

    if rank == bad:
        if how == "exit":
            os._exit(3)
        raise ValueError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()
    return rank


# ---------------------------------------------------------------------------
# distributed/: the compressed all-reduce and the sharded model
# ---------------------------------------------------------------------------
def psum_compressed_run(rank: int, world: int, dev, grads: dict) -> dict:
    """``psum_compressed`` of this rank's row of each ``[world, ...]``
    float32 array, under the collective recorder: the sums (numpy) and
    the recorder's report."""
    from repro_torch.distributed import compression as C
    from repro_torch.roofline.analysis import CollectiveRecorder

    mine = {k: torch.from_numpy(np.array(v[rank])).to(dev)
            for k, v in grads.items()}
    with CollectiveRecorder() as rec:
        out = C.psum_compressed(mine)
    return dict(out={k: v.cpu().numpy() for k, v in out.items()},
                coll=rec.report())


def _full(x) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu().numpy()


def sharded_model_run(rank: int, world: int, dev, spec: dict) -> dict:
    """The port's model on a ``spec["mesh"]`` DeviceMesh of the ranks
    under ``SINGLE_POD`` rules, every parameter a DTensor of its spec
    (``tests/test_torch_dryrun.py`` holds the same runs unsharded): the
    prefill's logits, ``spec["decode_steps"]`` decode
    steps with ``seq_parallel_decode`` against a one-sequence cache
    sharded by ``cache_specs`` (its length over ``data``), and one train
    step's loss, gradients and AdamW-updated parameters."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import api
    from repro_torch.models.transformer import OptFlags
    from repro_torch.train import optimizer as opt

    cfg = sharded_model_cfg(get_config, spec["arch"])
    mesh = init_device_mesh("cpu", tuple(spec["mesh"]),
                            mesh_dim_names=("data", "model"))
    rules = sh.SINGLE_POD

    def params(requires_grad=False):
        p = api.init_params(cfg, torch.Generator().manual_seed(spec["seed"]),
                            "cpu")
        for t in p.parameters():
            t.requires_grad_(requires_grad)
        return sh.distribute_params(p, sh.build_param_specs(p, rules, mesh),
                                    mesh)

    def batch(b: dict) -> dict:
        b = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
        return sh.distribute_tree(b, sh.batch_specs(b, rules, mesh), mesh)

    out = {}
    serve = OptFlags(attn_impl="chunked")
    with sh.use_rules(rules, mesh), implicit_replication(), \
            torch.no_grad():
        p = params()
        toks = batch({"tokens": spec["prompt"]})["tokens"]
        logits, _ = api.prefill_fn(cfg)(p, {"tokens": toks},
                                        spec["cache_len"], serve)
        out["prefill"] = _full(logits)
        # decode: the unsharded prefill's cache of one sequence, sharded
        plain = api.init_params(cfg, torch.Generator().manual_seed(
            spec["seed"]), "cpu")
    with torch.no_grad():
        _, cache = api.prefill_fn(cfg)(
            plain, {"tokens": torch.from_numpy(spec["one"])},
            spec["cache_len"], serve)
    sp = dataclasses.replace(serve, seq_parallel_decode=True)
    with sh.use_rules(rules, mesh), implicit_replication(), \
            torch.no_grad():
        specs = sh.cache_specs(cache, rules, mesh)
        cache = sh.distribute_tree(cache, specs, mesh)
        out["cache_local"] = tuple(cache["kv"][0].to_local().shape)
        steps = []
        for tok in spec["decode_tokens"]:
            tok = batch({"token": tok})["token"]
            logits, cache = api.decode_fn(cfg)(p, cache, tok, sp)
            steps.append(_full(logits))
        out["decode"] = np.stack(steps)
    train = OptFlags(remat="full", chunked_ce=True, ce_chunk=8,
                     seq_parallel_acts=True, attn_impl="chunked")
    with sh.use_rules(rules, mesh), implicit_replication():
        p = params(requires_grad=True)
        b = batch(spec["train"])
        loss = api.loss_fn(cfg)(p, b, train)
        named = dict(p.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        out["loss"] = _full(loss)
        out["grads"] = {k: _full(g) for k, g in zip(named, grads)}
        # the train step's update (train_step.py: AdamW on these grads)
        p, _, _ = opt.update(opt.AdamWConfig(), dict(zip(named, grads)),
                             opt.init(p), p)
        out["updated"] = {k: _full(v) for k, v in p.named_parameters()}
    return out if rank == 0 else {}


def sharded_model_cfg(get_config, arch: str):
    """The reduced config of the sharded runs: 2 layers, float32."""
    import dataclasses

    return dataclasses.replace(get_config(arch).reduced(), n_layers=2,
                               param_dtype="float32",
                               compute_dtype="float32")


def sharded_model_spec(arch: str) -> dict:
    """Seeded inputs of ``sharded_model_run`` for ``arch``'s reduced
    config: 4 prompts of 16 tokens, one of 12 for the decode cache, 2
    decode tokens, a train batch of 4 x 16."""
    from repro_torch.configs.base import get_config

    rng = np.random.default_rng(0)
    cfg = sharded_model_cfg(get_config, arch)
    toks = rng.integers(0, cfg.vocab, (4, 17)).astype(np.int32)
    return dict(
        arch=arch, mesh=(2, 2), seed=3, cache_len=24,
        prompt=rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32),
        one=rng.integers(0, cfg.vocab, (1, 12)).astype(np.int32),
        decode_tokens=[rng.integers(0, cfg.vocab, (1, 1)).astype(np.int32)
                       for _ in range(2)],
        train={"tokens": toks[:, :-1], "labels": toks[:, 1:]})


def unsharded_model_run(spec: dict) -> dict:
    """``sharded_model_run``'s outputs from the unsharded port, in this
    process."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.models.transformer import OptFlags
    from repro_torch.train import optimizer as opt

    cfg = sharded_model_cfg(get_config, spec["arch"])

    def params(requires_grad=False):
        p = api.init_params(cfg, torch.Generator().manual_seed(spec["seed"]),
                            "cpu")
        for t in p.parameters():
            t.requires_grad_(requires_grad)
        return p

    out = {}
    serve = OptFlags(attn_impl="chunked")
    with torch.no_grad():
        p = params()
        logits, _ = api.prefill_fn(cfg)(
            p, {"tokens": torch.from_numpy(spec["prompt"])},
            spec["cache_len"], serve)
        out["prefill"] = logits.numpy()
        _, cache = api.prefill_fn(cfg)(
            p, {"tokens": torch.from_numpy(spec["one"])}, spec["cache_len"],
            serve)
        steps = []
        for tok in spec["decode_tokens"]:
            logits, cache = api.decode_fn(cfg)(p, cache, torch.from_numpy(tok),
                                               serve)
            steps.append(logits.numpy())
        out["decode"] = np.stack(steps)
    train = OptFlags(remat="full", chunked_ce=True, ce_chunk=8,
                     seq_parallel_acts=True, attn_impl="chunked")
    p = params(requires_grad=True)
    b = {k: torch.from_numpy(v) for k, v in spec["train"].items()}
    loss = api.loss_fn(cfg)(p, b, train)
    named = dict(p.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    out["loss"] = loss.detach().numpy()
    out["grads"] = {k: g.numpy() for k, g in zip(named, grads)}
    p, _, _ = opt.update(opt.AdamWConfig(), dict(zip(named, grads)),
                         opt.init(p), p)
    out["updated"] = {k: v.detach().numpy() for k, v in p.named_parameters()}
    return out


def _close(got, exp, what, scale=None):
    """Within 1e-5 of the largest magnitude of ``exp`` (of ``scale``: a
    tree's largest, for leaves such as the k bias's gradient, which is 0
    but for rounding, as softmax ignores a shift of every key)."""
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape, what
    big = float(np.abs(exp).max()) if scale is None else scale
    err = float(np.abs(got - exp).max())
    assert err <= 1e-5 * big, (what, err, big)


def check_sharded_run(got: dict, exp: dict, spec: dict) -> None:
    """The sharded run's prefill, decode and loss within 1e-5 of the
    unsharded run's largest magnitude, each gradient and updated
    parameter within 1e-5 of its tree's; the one-sequence cache's length
    sharded over data (2 ways)."""
    assert got["cache_local"][2] == spec["cache_len"] // 2
    for key in ("prefill", "decode", "loss"):
        _close(got[key], exp[key], key)
    assert set(got["grads"]) == set(exp["grads"])
    g_max = max(float(np.abs(v).max()) for v in exp["grads"].values())
    p_max = max(float(np.abs(v).max()) for v in exp["updated"].values())
    for name in exp["grads"]:
        _close(got["grads"][name], exp["grads"][name], name, g_max)
        _close(got["updated"][name], exp["updated"][name], name, p_max)
