"""The port on the card: each CUDA kernel against its plain version, a
small cluster run, a live rebalance, an open-loop run, the threefry
draws, tied store winners, reduced serving runs (dense, SSM, MoE and
hybrid), and
``ChainDist`` and the kv_cache protocols on CUDA ranks, on CUDA against
the same runs on the CPU.  Imports no JAX, so it
runs where only PyTorch is installed; without a card every test skips:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import types as t_types  # noqa: E402
from repro_torch.core import workload as t_workload  # noqa: E402
from repro_torch.core.chain import ChainSim  # noqa: E402
from repro_torch.core.store import batch_rank  # noqa: E402
from repro_torch.core.store import Store  # noqa: E402
from repro_torch.kernels.kv_engine import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.kv_engine import ops as t_ops  # noqa: E402
from repro_torch.kernels.kv_engine import ref as t_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402

pytestmark = pytest.mark.cuda
# the backward kernels' launch counters, and each route's dk/dv and dq
# counters; serving leaves them all at 0
BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")
BWD_ROUTES = {"mma": ("flash_bwd_dkdv_mma", "flash_bwd_dq_mma"),
              "f32": ("flash_bwd_dkdv_f32", "flash_bwd_dq_f32")}
BWD_COUNTERS = BWD_KERNELS + BWD_ROUTES["mma"] + BWD_ROUTES["f32"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _arrays(rng, C, K, V, W, B, max_pending):
    return (rng.integers(0, 1 << 20, (C, K, V, W)).astype(np.int32),
            rng.integers(-1, 100, (C, K, V)).astype(np.int32),
            rng.integers(0, max_pending + 1, (C, K)).astype(np.int32))


def test_cuda_kernels_match_plain_versions(card):
    rng = np.random.default_rng(21)
    C, K, V, W, B = 8, 4096, 4, 4, 320
    values, seqs, pending = _arrays(rng, C, K, V, W, B, V - 1)
    keys = rng.integers(-4, K + 4, (C, B)).astype(np.int32)
    keys[:, :64] = rng.integers(0, 8, (C, 64))
    dev = lambda a: torch.from_numpy(a).to(card)
    got = t_kernel.cluster_read_engine(*map(dev, (values, seqs, pending,
                                                  keys)))
    exp = t_ref.cluster_read_engine_ref(*map(dev, (values, seqs, pending,
                                                   keys)))
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    pending = np.minimum(pending, 1).astype(np.int32)
    wvals = rng.integers(0, 1 << 20, (C, B, W)).astype(np.int32)
    wseqs = rng.integers(0, 1000, (C, B)).astype(np.int32)
    active = rng.integers(0, 2, (C, B)).astype(np.int32)
    rank = batch_rank(dev(keys), dev(active).bool())
    inputs = (values, seqs, pending, keys, wvals, wseqs, active)
    got = t_kernel.cluster_write_engine(*map(dev, inputs), rank)
    exp = t_ref.cluster_write_engine_ref(*map(dev, inputs), rank)
    torch.cuda.synchronize()
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


def test_cuda_ops_match_cpu_on_out_of_range_keys(card):
    """The node steps' read and append on the kernels equal the CPU path
    for keys the reference store clamps, wraps or drops."""
    rng = np.random.default_rng(22)
    C, K, V, W, B = 4, 64, 4, 4, 96
    values, seqs, pending = _arrays(rng, C, K, V, W, B, 1)
    keys = rng.integers(0, 6, (C, B)).astype(np.int32)
    odd = np.array([-1, -2, -K - 1, K, K + 3], np.int32)
    keys = np.where(rng.random((C, B)) < 0.3, rng.choice(odd, (C, B)),
                    keys).astype(np.int32)
    wvals = rng.integers(0, 1 << 20, (C, B, W)).astype(np.int32)
    wseqs = rng.integers(0, 1000, (C, B)).astype(np.int32)
    active = rng.integers(0, 2, (C, B)).astype(bool)
    next_seq = np.ones((C, K), np.int32)
    out = {}
    for d in ("cpu", card):
        # a copy per device: the append edits the store in place
        t = lambda a: torch.tensor(a, device=d)
        store = Store(*map(t, (values, seqs, pending, next_seq)))
        read = t_ops.cluster_read_batch(store, t(keys), is_tail=False)
        store, acc = t_ops.cluster_write_batch(store, t(keys), t(wvals),
                                               t(wseqs), t(active))
        out[str(d)] = (*read, *store, acc)
    for a, b in zip(out["cpu"], out[str(card)]):
        assert torch.equal(a, b.cpu())


def _node_batch(rng, N, K, V, B):
    """A store with dirty versions (pending 0..V-1) and a [N, B] batch
    with duplicates in each row's first quarter and a fifth of the keys
    among -1, K - 1, K and -K - 1."""
    values, seqs, pending = _arrays(rng, N, K, V, 4, B, V - 1)
    keys = rng.integers(0, K, (N, B)).astype(np.int32)
    q = max(B // 4, 1)
    keys[:, :q] = rng.integers(0, 4, (N, q))
    odd = rng.random((N, B)) < 0.2
    keys[odd] = rng.choice(np.array([-1, K - 1, K, -K - 1], np.int32),
                           int(odd.sum()))
    return values, seqs, pending, keys


@pytest.mark.parametrize("N,K,V,B", [(32, 4096, 4, 320), (4, 64, 4, 1),
                                     (3, 256, 5, 2000), (2, 8, 4, 96)])
def test_cuda_kv_read_modes_match_plain_versions(card, N, K, V, B):
    """The read kernel in its engine mode (the Pallas contract) and its
    ops mode (the node step's read, per-node and scalar tail flags)
    equals its plain versions exactly, one launch per call."""
    rng = np.random.default_rng(40 + B)
    values, seqs, pending, keys = _node_batch(rng, N, K, V, B)
    dev = lambda a: torch.from_numpy(a).to(card)
    store = [dev(a) for a in (values, seqs, pending)]
    t_kernel.reset_launches()
    got = t_kernel.cluster_read_engine(*store, dev(keys))
    exp = t_ref.cluster_read_engine_ref(*store, dev(keys))
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    flags = [dev(rng.random(N) < 0.5), True, False]
    for flag in flags:
        got = t_kernel.cluster_read_decide(*store, dev(keys), flag)
        exp = t_ref.cluster_read_decide_ref(*store, dev(keys), flag)
        for g, e in zip(got, exp):
            assert torch.equal(g, e)
    torch.cuda.synchronize()
    assert t_kernel.LAUNCHES["kv_read"] == 1 + len(flags)


@pytest.mark.parametrize("N,K,V,B", [(32, 4096, 4, 320), (4, 64, 4, 1),
                                     (3, 256, 5, 2000), (2, 8, 4, 96)])
def test_cuda_kv_write_modes_match_plain_versions(card, N, K, V, B):
    """The write kernel in its ops mode (raw keys, the rank taken in the
    block, bool flags) and its engine mode (the caller's rank) equals its
    plain versions exactly, one launch per call.  The plain versions run
    on the CPU: when -1 and K - 1 land on one cell, its scatter keeps
    the later write, as the kernel does, where a CUDA scatter promises no
    order."""
    rng = np.random.default_rng(50 + B)
    values, seqs, pending, keys = _node_batch(rng, N, K, V, B)
    pending = np.minimum(pending, 1).astype(np.int32)
    wvals = rng.integers(0, 1 << 20, (N, B, 4)).astype(np.int32)
    wseqs = rng.integers(0, 1000, (N, B)).astype(np.int32)
    active = rng.random((N, B)) < 0.7
    rank = batch_rank(torch.from_numpy(keys), torch.from_numpy(active))
    t_kernel.reset_launches()
    for mode in ("ops", "engine"):
        out = {}
        for d in ("cpu", card):
            t = lambda a: torch.tensor(a, device=d)    # a copy per call
            leaves = [t(a) for a in (values, seqs, pending)]
            batch = [t(a) for a in (keys, wvals, wseqs)]
            if mode == "ops":
                fn = (t_kernel.cluster_write_append if d == card
                      else t_ref.cluster_write_append_ref)
                out[str(d)] = fn(*leaves, *batch, t(active))
            else:
                fn = (t_kernel.cluster_write_engine if d == card
                      else t_ref.cluster_write_engine_ref)
                out[str(d)] = fn(*leaves, *batch,
                                 t(active.astype(np.int32)), rank.to(d))
        for a, b in zip(out["cpu"], out[str(card)]):
            assert a.dtype == b.dtype
            assert torch.equal(a, b.cpu()), mode
        if B > 1:
            acc = out["cpu"][3].bool()
            assert 0 < int(acc.sum()) < int(active.sum())
    assert t_kernel.LAUNCHES["kv_write"] == 2


def test_cuda_kv_write_rejects_a_batch_past_shared_memory(card):
    N, K, V, B = 1, 16, 4, t_kernel.WRITE_MAX_BATCH + 1
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        t_kernel.cluster_write_append(
            z(N, K, V, 4), z(N, K, V), z(N, K), z(N, B), z(N, B, 4),
            z(N, B), torch.ones((N, B), dtype=torch.bool, device=card))


def _device_kernels(fn, calls: int) -> list:
    """Names of the device activities of ``calls`` calls of ``fn``, from
    the profiler (which may drop one record of a window, never add
    one)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def test_cuda_node_step_kv_ops_are_one_launch_each(card):
    """A node step's read and its dirty appends are one kernel each with
    nothing else on the device between the store and the outputs, and a
    NetCRAQ tick launches each once and no snapshot kernel."""
    rng = np.random.default_rng(60)
    N, K, V, B = 8, 256, 4, 80
    values, seqs, pending, keys = _node_batch(rng, N, K, V, B)
    dev = lambda a: torch.tensor(a, device=card)
    store = Store(*map(dev, (values, seqs, np.minimum(pending, 1),
                             np.ones((N, K), np.int32))))
    keys = dev(keys)
    tail = dev(np.arange(N) % 4 == 3)
    wvals = dev(rng.integers(0, 1 << 20, (N, B, 4)).astype(np.int32))
    wseqs = dev(rng.integers(0, 1000, (N, B)).astype(np.int32))
    active = dev(rng.random((N, B)) < 0.5)
    names = _device_kernels(
        lambda: t_ops.cluster_read_batch(store, keys, is_tail=tail), 4)
    assert len(names) in (3, 4), names
    assert all("kv_read_kernel" in n for n in names), names
    names = _device_kernels(
        lambda: t_ops.cluster_write_batch(store, keys, wvals, wseqs, active),
        4)
    assert len(names) in (3, 4), names
    assert all("kv_write_kernel" in n for n in names), names

    cl = t_types.ClusterConfig(
        chain=t_types.ChainConfig(n_nodes=4, num_keys=256, num_versions=4),
        n_chains=2)
    sim = ChainSim(cl, inject_capacity=16, route_capacity=64, device=card)
    sched = t_workload.make_schedule(
        cl, t_workload.WorkloadConfig(ticks=3, queries_per_tick=16,
                                      write_fraction=0.4, seed=2),
        device=card)
    state = [sim.run(sim.init_state(), sched, extra_ticks=0)]
    inj = t_types.tree_map(lambda x: x[0], sched)

    def tick():
        state[0] = sim.tick(state[0], inj)

    names = _device_kernels(tick, 3)
    assert sum("kv_read_kernel" in n for n in names) in (2, 3)
    assert sum("kv_write_kernel" in n for n in names) in (2, 3)
    assert not any("snapshot" in n for n in names), names

@pytest.mark.parametrize("protocol", ["netcraq", "netchain"])
def test_cuda_cluster_run_matches_cpu_run(card, protocol):
    cl = t_types.ClusterConfig(
        chain=t_types.ChainConfig(n_nodes=4, num_keys=256, num_versions=4,
                                  protocol=protocol), n_chains=2)
    wl = t_workload.WorkloadConfig(ticks=6, queries_per_tick=16,
                                   write_fraction=0.4, seed=2)
    states = {}
    for d in ("cpu", card):
        sim = ChainSim(cl, inject_capacity=16, route_capacity=64, device=d)
        sched = t_workload.make_schedule(cl, wl, device=d)
        t_kernel.reset_launches()
        states[str(d)] = sim.run(sim.init_state(), sched, extra_ticks=10,
                                 assert_drained=True)
    assert t_kernel.LAUNCHES["kv_read"] == 16
    cpu, gpu = states["cpu"], states[str(card)]
    for name in ("stores", "metrics", "replies", "locks", "inbox"):
        for a, b in zip(getattr(cpu, name), getattr(gpu, name)):
            assert torch.equal(a, b.cpu()), name


def _assert_same(cpu, gpu, path):
    """Exact equality of two same-structured NamedTuples of tensors."""
    if hasattr(cpu, "_fields"):
        for f in cpu._fields:
            _assert_same(getattr(cpu, f), getattr(gpu, f), f"{path}.{f}")
        return
    assert torch.equal(cpu, gpu.cpu()), path


def _txn_cluster():
    return t_types.ClusterConfig(
        chain=t_types.ChainConfig(n_nodes=4, num_keys=64, num_versions=8),
        n_chains=2)


def test_cuda_wave_run_matches_cpu_run(card):
    """A small wave-table run on CUDA equals the same run on the CPU
    (results, rounds, every state leaf, the wave table included), with
    one kv_read and one kv_write launch per tick."""
    from repro_torch.core.txn import TxnPlanner, TxnWaveDriver

    cl = _txn_cluster()
    txns = t_workload.make_txn_workload(cl, t_workload.TxnWorkloadConfig(
        n_txns=24, keys_per_txn=3, write_fraction=0.7, key_skew="zipf",
        seed=3))
    out = {}
    for d in ("cpu", card):
        sim = ChainSim(cl, inject_capacity=16, route_capacity=96,
                       wave_depth=4, wave_keys=3, wave_log_capacity=32,
                       device=d)
        drv = TxnWaveDriver(sim, TxnPlanner(cl, device=d))
        t_kernel.reset_launches()
        state, res = drv.run(sim.init_state(), txns)
        out[str(d)] = (state, res, drv.last_ticks, dict(t_kernel.LAUNCHES))
    cpu, gpu = out["cpu"], out[str(card)]
    assert cpu[1] == gpu[1] and cpu[2] == gpu[2]
    assert any(r.committed for r in gpu[1])
    _assert_same(cpu[0], gpu[0], "state")
    assert gpu[3]["kv_read"] == gpu[3]["kv_write"] == gpu[2] > 0


def test_cuda_txn_driver_matches_cpu(card):
    """The host-driven 2PC on CUDA equals the CPU's, one kv launch of
    each kind per tick."""
    from repro_torch.core.txn import TxnDriver, TxnPlanner

    cl = _txn_cluster()
    txns = t_workload.make_txn_workload(cl, t_workload.TxnWorkloadConfig(
        n_txns=12, keys_per_txn=2, cross_chain_fraction=0.7, seed=8))
    out = {}
    for d in ("cpu", card):
        sim = ChainSim(cl, inject_capacity=16, route_capacity=96, device=d)
        drv = TxnDriver(sim, TxnPlanner(cl, device=d))
        state, results = sim.init_state(), []
        t_kernel.reset_launches()
        for i in range(0, len(txns), 4):
            state, res = drv.run(state, txns[i:i + 4])
            results += res
        out[str(d)] = (state, results, dict(t_kernel.LAUNCHES))
    cpu, gpu = out["cpu"], out[str(card)]
    assert cpu[1] == gpu[1]
    assert {r.mode for r in gpu[1]} == {"2pc", "direct"}
    _assert_same(cpu[0], gpu[0], "state")
    ticks = int(gpu[0].t)
    assert gpu[2]["kv_read"] == gpu[2]["kv_write"] == ticks > 0


def test_cuda_total_landed_reads_only_the_cursor(card):
    """The driver's per-tick poll touches the [C] cursor leaf and no
    other: every other leaf of this log refuses any use."""
    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"total_landed touched the log body ({name})")

    from repro_torch.core.metrics import ReplyLog

    cursor = torch.tensor([3, 4], dtype=torch.int32, device=card)
    body = [Untouchable() for _ in ReplyLog._fields[:-1]]
    assert ReplyLog(*body, cursor=cursor).total_landed() == 7


def _flat(rng, C, K, B):
    """(slots, chains) with duplicates, parked chain -1 and slots outside
    [0, K)."""
    slots = rng.integers(0, K, B).astype(np.int32)
    chains = rng.integers(0, C, B).astype(np.int32)
    slots[: B // 4] = rng.integers(0, 3, B // 4)
    chains[: B // 4] = 1
    chains[rng.random(B) < 0.1] = -1
    odd = rng.random(B) < 0.1
    slots[odd] = rng.choice([-1, K, K + 9], int(odd.sum()))
    return slots, chains


@pytest.mark.parametrize("replica", [False, True])
def test_cuda_bucketed_kernels_match_plain_versions(card, replica):
    """Both bucketed kernels equal their plain versions, one launch each,
    on a contiguous store and on the tail slice of a [C, n, ...] store
    (read and written in place, the other replicas untouched)."""
    rng = np.random.default_rng(31)
    C, n, K, V, W, B = 6, 3, 2048, 4, 4, 4096
    lead = (C, n) if replica else (C,)
    full = [rng.integers(0, 1 << 20, lead + (K, V, W)).astype(np.int32),
            rng.integers(-1, 100, lead + (K, V)).astype(np.int32),
            rng.integers(0, 2, lead + (K,)).astype(np.int32)]
    slots, chains = _flat(rng, C, K, B)
    wvals = rng.integers(0, 1 << 20, (B, W)).astype(np.int32)
    wseqs = rng.integers(0, 1000, B).astype(np.int32)
    active = rng.integers(0, 2, B).astype(np.int32)
    ok = (chains >= 0) & (slots >= 0) & (slots < K)
    target = np.where(ok, chains.astype(np.int64) * K + slots, -1)
    rank = batch_rank(torch.from_numpy(target)[None].to(card),
                      torch.from_numpy(active & ok)[None].bool().to(card))[0]
    dev = lambda a: torch.tensor(a, device=card)   # a copy per call
    stores = {}
    for side in ("kernel", "plain"):
        x = [dev(a) for a in full]
        stores[side] = (x, [y[:, -1] for y in x] if replica else x)
    t_kernel.reset_launches()
    got = t_kernel.bucketed_read_engine(*stores["kernel"][1], dev(slots),
                                        dev(chains))
    exp = t_ref.bucketed_read_engine_ref(*stores["plain"][1], dev(slots),
                                         dev(chains))
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    batch = [dev(a) for a in (slots, chains, wvals, wseqs, active)]
    got = t_kernel.bucketed_write_engine(*stores["kernel"][1], *batch, rank)
    exp = t_ref.bucketed_write_engine_ref(*stores["plain"][1], *batch, rank)
    torch.cuda.synchronize()
    assert t_kernel.LAUNCHES["kv_bucketed_read"] == 1
    assert t_kernel.LAUNCHES["kv_bucketed_write"] == 1
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    assert 0 < int(got[3].sum()) < int(active.sum())
    for a, b in zip(stores["kernel"][0], stores["plain"][0]):
        assert torch.equal(a, b)
    if replica:
        for a, orig in zip(stores["kernel"][0], full):
            assert torch.equal(a[:, :-1].cpu(), torch.from_numpy(orig[:, :-1]))


def _global_cluster(C=6, K=2048, spare=512, bpc=3, V=4):
    return t_types.ClusterConfig(
        chain=t_types.ChainConfig(n_nodes=3, num_keys=K, num_versions=V),
        n_chains=C, buckets_per_chain=bpc, spare_keys=spare)


def _global_map(cl, device, base0=None):
    """Bucket 0 moved to chain 1's spare region, or (``base0``) left on
    chain 0 at ``base0``, past its end: its last keys' int32 targets then
    name chain 1's first registers."""
    owner = [cl.bucket_home(b)[0] for b in range(cl.num_buckets)]
    base = [cl.bucket_home(b)[1] for b in range(cl.num_buckets)]
    if base0 is None:
        owner[0], base[0] = 1, cl.keys_in_use
    pmap = t_types.PartitionMap.build(
        owner, base, 1, n_chains=cl.n_chains, num_keys=cl.chain.num_keys,
        bucket_slots=cl.bucket_slots, device=device)
    if base0 is not None:   # past the end: no occupancy table to build
        pmap = pmap._replace(base=pmap.base.clone().index_fill_(
            0, torch.tensor([0], device=device), base0))
    return pmap


@pytest.mark.parametrize("case", ["mixed", "resident_plus", "one_register",
                                  "off_store", "negative_pending",
                                  "five_versions"])
def test_cuda_global_key_ops_match_plain_versions(card, case):
    """The ops modes of both bucketed kernels (``partitioned_*_batch`` in
    one launch each) equal their plain versions on the CPU exactly, on
    the tail slice of a [C, n, ...] store written in place (the other
    replicas untouched): duplicates past the window, keys outside the key
    space, inactive lanes; a batch of more lanes than the card holds
    threads at once; every lane on one register; a map that points past
    a chain's end; negative pending counts (the rank's rounds then run
    past V - 1, and cells below 0 are accepted without landing); and a
    store of V = 5 versions."""
    V = 5 if case == "five_versions" else 4
    cl = _global_cluster(V=V)
    G = cl.num_global_keys
    rng = np.random.default_rng(70 + len(case))
    B = {"resident_plus": 300_000, "one_register": 20_000}.get(case, 5000)
    gkeys = rng.integers(0, G, B).astype(np.int32)
    gkeys[: B // 8] = rng.integers(0, 64, B // 8)
    odd = rng.random(B) < 0.02
    gkeys[odd] = rng.choice(np.array([-1, -7, G, G + 5], np.int32),
                            int(odd.sum()))
    if case == "one_register":
        gkeys[:] = 77
    active = rng.random(B) < 0.8
    C, n, K = cl.n_chains, cl.chain.n_nodes, cl.chain.num_keys
    low = -6 if case == "negative_pending" else 0
    full = [rng.integers(0, 1 << 20, (C, n, K, V, 4)).astype(np.int32),
            rng.integers(-1, 100, (C, n, K, V)).astype(np.int32),
            rng.integers(low, 2, (C, n, K)).astype(np.int32)]
    wvals = rng.integers(0, 1 << 20, (B, 4)).astype(np.int32)
    wseqs = rng.integers(0, 1 << 16, B).astype(np.int32)
    out = {}
    t_kernel.reset_launches()
    for d in ("cpu", card):
        t = lambda a: torch.tensor(a, device=d)    # a copy per device
        store = [t(a) for a in full]
        tail = [x[:, -1] for x in store]
        pmap = _global_map(cl, d, cl.chain.num_keys - 100
                           if case == "off_store" else None)
        reads = [t_kernel.bucketed_read_resolve(*tail, t(gkeys), cl, pmap,
                                                flag)
                 for flag in (True, False)]
        acc = t_kernel.bucketed_write_append(*tail, t(gkeys), t(wvals),
                                             t(wseqs), t(active), cl,
                                             pmap)[3]
        after = t_kernel.bucketed_read_resolve(*tail, t(gkeys), cl, pmap,
                                               True)
        out[str(d)] = [*reads[0], *reads[1], acc, *after, *store]
    torch.cuda.synchronize()
    assert t_kernel.LAUNCHES["kv_bucketed_read"] == 3
    assert t_kernel.LAUNCHES["kv_bucketed_write"] == 1
    for a, b in zip(out["cpu"], out[str(card)]):
        assert a.dtype == b.dtype
        assert torch.equal(a, b.cpu())
    acc = out["cpu"][10]
    assert 0 < int(acc.sum()) < int(active.sum())
    for a, orig in zip(out[str(card)][-3:], full):
        assert torch.equal(a[:, :-1].cpu(), torch.from_numpy(orig[:, :-1]))


def test_cuda_global_key_ops_are_one_launch_each(card):
    """``partitioned_read_batch`` and ``partitioned_write_batch`` are one
    device activity a call, the bucketed kernels' own, nothing else
    between the inputs and the outputs."""
    cl = _global_cluster()
    pmap = _global_map(cl, card)
    rng = np.random.default_rng(80)
    B = 4000
    dev = lambda a: torch.tensor(a, device=card)
    gkeys = dev(rng.integers(-2, cl.num_global_keys + 2, B).astype(np.int32))
    wvals = dev(rng.integers(0, 1 << 20, (B, 4)).astype(np.int32))
    wseqs = dev(np.arange(B, dtype=np.int32))
    C, K = cl.n_chains, cl.chain.num_keys
    shapes = ((C, K, 4, 4), (C, K, 4), (C, K), (C, K))
    store = Store(*[torch.zeros(s, dtype=torch.int32, device=card)
                    for s in shapes])
    for active in (dev(np.ones(B, bool)), dev(np.ones(B, np.int32))):
        t_ops.partitioned_write_batch(cl, store, gkeys, wvals, wseqs, active,
                                      pmap)   # the scratch, once
        names = _device_kernels(lambda: t_ops.partitioned_write_batch(
            cl, store, gkeys, wvals, wseqs, active, pmap), 4)
        assert len(names) in (3, 4), names
        assert all("kv_bucketed_write_kernel" in n for n in names), names
    for is_tail in (True, False):
        names = _device_kernels(lambda: t_ops.partitioned_read_batch(
            cl, store, gkeys, pmap, is_tail=is_tail), 4)
        assert len(names) in (3, 4), names
        assert all("kv_bucketed_read_kernel" in n for n in names), names


def test_cuda_global_key_append_rejects_a_batch_past_its_capacity(card):
    """A batch with more lanes than the shared memory of the whole card
    holds at 8 bytes a lane raises before anything launches."""
    cl = _global_cluster()
    pmap = _global_map(cl, card)
    C, K = cl.n_chains, cl.chain.num_keys
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    B = sms * 233472 // 8 + 1   # sm_90: 228 KiB of shared memory an SM
    store = (z(C, K, 4, 4), z(C, K, 4), z(C, K))
    t_kernel.reset_launches()
    with pytest.raises(ValueError, match=f"a batch of {B} lanes"):
        t_kernel.bucketed_write_append(
            *store, z(B), z(B, 4), z(B),
            torch.ones(B, dtype=torch.bool, device=card), cl, pmap)
    assert t_kernel.LAUNCHES["kv_bucketed_write"] == 0
    assert not store[2].any()


def test_cuda_global_key_appends_on_two_streams(card):
    """Appends issued in turns on two streams of one card, without waiting
    for each other, each equal their plain version: each stream has an
    append scratch of its own."""
    cl = _global_cluster()
    pmap = {d: _global_map(cl, d) for d in ("cpu", card)}
    G, C, K = cl.num_global_keys, cl.n_chains, cl.chain.num_keys
    rng = np.random.default_rng(90)
    B, rounds = 20_000, 3
    batches, stores = [], []
    for _ in range(2):
        gkeys = rng.integers(-2, G + 2, B).astype(np.int32)
        gkeys[: B // 4] = rng.integers(0, 64, B // 4)
        batches.append((gkeys, rng.integers(0, 1 << 20, (B, 4)),
                        rng.integers(0, 1 << 16, B), rng.random(B) < 0.8))
        stores.append([np.zeros((C, K, 4, 4), np.int32),
                       np.zeros((C, K, 4), np.int32),
                       rng.integers(0, 2, (C, K)).astype(np.int32)])
    out = {}
    for d in ("cpu", card):
        t = lambda a: torch.tensor(a, device=d)
        st = [[t(a) for a in x] for x in stores]
        bt = [[t(a).to(torch.int32) if a.dtype != bool else t(a)
               for a in x] for x in batches]
        streams = [torch.cuda.Stream(d) for _ in range(2)] if d == card \
            else [None, None]
        for s in streams:
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(d))
        acc = []
        for _ in range(rounds):
            for i, s in enumerate(streams):
                with (contextlib.nullcontext() if s is None
                      else torch.cuda.stream(s)):
                    acc.append(t_kernel.bucketed_write_append(
                        *st[i], *bt[i], cl, pmap[d])[3])
        if d == card:
            torch.cuda.synchronize()
            dev = st[0][0].device
            assert all((dev, s.cuda_stream) in t_kernel._SCRATCH
                       for s in streams)
        out[str(d)] = acc + [x for s in st for x in s]
    for a, b in zip(out["cpu"], out[str(card)]):
        assert torch.equal(a, b.cpu())
    assert 0 < int(out["cpu"][0].sum()) < B


def test_cuda_rebalance_and_partitioned_ops_match_cpu(card):
    """A live bucket migration and a global-key read-back and write on
    CUDA equal the same on the CPU."""
    from repro_torch.core.coordinator import Coordinator

    cl = t_types.ClusterConfig(
        chain=t_types.ChainConfig(n_nodes=4, num_keys=64, num_versions=4),
        n_chains=2, buckets_per_chain=2, spare_keys=32)
    wl = t_workload.WorkloadConfig(ticks=4, queries_per_tick=8,
                                   write_fraction=0.4, seed=5)
    gkeys = torch.arange(-2, cl.num_global_keys + 2, dtype=torch.int32)
    out = {}
    for d in ("cpu", card):
        sim = ChainSim(cl, inject_capacity=8, route_capacity=64, device=d)
        co = Coordinator(cl, device=d)
        state = sim.run(sim.init_state(),
                        t_workload.make_schedule(cl, wl, device=d),
                        extra_ticks=10, assert_drained=True)
        co.begin_rebalance(1, 1)
        state = co.complete_rebalance(sim.drain(co.install_roles(state), 2))
        pmap = co.partition_map()
        tail = Store(*[x[:, -1] for x in state.stores])
        read = t_ops.partitioned_read_batch(cl, tail, gkeys.to(d), pmap,
                                            is_tail=True)
        vals = t_types.value_from_int(gkeys.to(d) + 7)
        tail, acc = t_ops.partitioned_write_batch(
            cl, tail, gkeys.to(d), vals, gkeys.to(d) + 100,
            torch.ones_like(gkeys, device=d), pmap)
        out[str(d)] = (*read, acc, *state.stores, *state.metrics)
    for a, b in zip(out["cpu"], out[str(card)]):
        assert torch.equal(a, b.cpu())


@pytest.mark.parametrize("B,HQ,HKV,S,SK,D,causal,dtype,tol", [
    (2, 16, 2, 256, 256, 128, True, torch.bfloat16, 2e-2),
    (1, 16, 2, 192, 192, 128, True, torch.float32, 2e-5),
    (1, 4, 2, 200, 200, 64, True, torch.bfloat16, 2e-2),
    (1, 4, 1, 100, 224, 32, True, torch.float32, 2e-5),
    (1, 4, 4, 130, 70, 256, False, torch.float32, 2e-5),
    # non-causal at Whisper's cross-attention (128 queries, 1,500 frames:
    # a ragged key edge) and encoder shapes, and S > SK
    (2, 8, 8, 128, 1500, 64, False, torch.float32, 2e-5),
    (1, 8, 8, 1500, 1500, 64, False, torch.float32, 2e-5),
    (1, 4, 2, 300, 130, 128, False, torch.float32, 2e-5),
])
def test_cuda_flash_attention_matches_plain_version(card, B, HQ, HKV, S,
                                                    SK, D, causal, dtype,
                                                    tol):
    """The kernel equals its plain version: GQA, ragged tiles, S != SK,
    head dims 32-256, and the transposed views the model hands over; a
    float32 non-causal case with a ragged key edge fails the same hold
    with the key mask dropped."""
    rng = np.random.default_rng(41)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card, dtype) for shape in
        ((B, S, HQ, D), (B, SK, HKV, D), (B, SK, HKV, D)))
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    fa_kernel.reset_launches()
    got = fa_kernel.flash_attention(q, k, v, causal=causal)
    exp = fa_ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    # float32 takes the f32 kernel; bf16 at D <= 128, a multiple of 8, the
    # tensor cores
    route = ("mma" if dtype == torch.bfloat16 and D <= 128 and D % 8 == 0
             else "f32")
    assert fa_kernel.LAUNCHES["flash_attention"] == 1
    assert fa_kernel.LAUNCHES[f"flash_attention_{route}"] == 1
    assert got.dtype == dtype and got.stride() == q.stride()
    assert float((got.float() - exp.float()).abs().max()) <= tol
    # a non-causal case with a ragged key edge: the same hold fails on the
    # function of a kernel that dropped its key mask past SK
    ctrl = None if causal else _unmasked_tail(q, k, v)
    if ctrl is not None and dtype == torch.float32:
        assert float((ctrl.float() - exp.float()).abs().max()) > tol


# keys per K/V tile of both CUDA kernels; a dropped-mask control is held
# where the padded keys are at least 1% of the tile-rounded ones (fewer
# dilute a row by less than rounding shows, chip_smoke.py's phase 10)
_TILE_KEYS, _MASK_SHARE = 64, 0.01
# the bf16 error's norm over the plain version's: twice the largest
# reading of a sound run (chip_smoke.py's BF16_RMS_TOL)
_BF16_RMS_TOL = 5e-3


def _rms_err(got, exp):
    d = got.float() - exp.float()
    return float(d.norm() / exp.float().norm())


def _unmasked_tail(q, k, v):
    """The plain version with the last tile's zero-filled keys past SK
    left in, non-causal (a kernel that dropped its key mask); None where
    SK fills its tiles or the padded keys are under 1% of them."""
    SK = k.shape[2]
    pad = -SK % _TILE_KEYS
    if pad < _MASK_SHARE * (SK + pad):
        return None

    def zero_fill(x):
        return torch.cat([x, x.new_zeros(x.shape[:2] + (pad, x.shape[3]))],
                         dim=2)
    return fa_ref.flash_attention_ref(q, zero_fill(k), zero_fill(v),
                                      causal=False)


@pytest.mark.parametrize("B,HQ,HKV,S,SK,D,causal,view", [
    # head dims 64 and 128; GQA groups 1, 2 and 8
    (1, 4, 4, 128, 128, 64, True, True),
    (2, 16, 2, 256, 256, 128, True, True),
    (1, 16, 2, 256, 256, 64, True, True),
    (1, 8, 1, 192, 192, 128, True, True),
    (1, 8, 1, 192, 192, 64, True, True),
    # S = SK ragged: no multiple of the 64-row tiles
    (1, 4, 2, 200, 200, 128, True, True),
    (1, 8, 2, 1000, 1000, 128, True, True),
    (1, 4, 1, 1000, 1000, 64, True, True),
    # S != SK both ways (the mask aligned top-left)
    (1, 4, 2, 100, 224, 128, True, True),
    (1, 4, 2, 700, 200, 64, True, True),
    (2, 8, 2, 300, 130, 128, True, True),
    # non-causal, with S != SK
    (1, 4, 4, 130, 70, 128, False, True),
    (1, 8, 2, 70, 300, 64, False, True),
    # contiguous [B, H, S, D] tensors instead of the model's views
    (2, 8, 2, 200, 200, 128, True, False),
    (1, 4, 4, 64, 64, 64, False, False),
    # head dims below the kernel's width (columns past D zero-filled by
    # TMA): Zamba2's 80 (MHA 32/32, at S = SK = 2048 in chip_smoke.py),
    # ragged, S != SK both ways, non-causal, views and contiguous; 32, 72
    (1, 32, 32, 256, 256, 80, True, True),
    (1, 4, 4, 200, 200, 80, True, True),
    (1, 4, 2, 100, 224, 80, True, True),
    (1, 8, 8, 300, 130, 80, True, True),
    (1, 4, 4, 130, 70, 80, False, True),
    (2, 8, 8, 200, 200, 80, True, False),
    (1, 4, 2, 200, 200, 32, True, True),
    (1, 4, 4, 130, 300, 72, False, False),
    # non-causal at Whisper's shapes (the encoder's 1,500 frames, the
    # cross-attention's 128 queries against them: ragged key edges) and
    # S != SK both ways at head dims 128 and 80
    (1, 8, 8, 1500, 1500, 64, False, True),
    (2, 8, 8, 128, 1500, 64, False, True),
    # Whisper's causal decoder self-attention over its 128-token prompt
    (2, 8, 8, 128, 128, 64, True, True),
    (1, 8, 2, 300, 130, 128, False, True),
    (1, 8, 2, 130, 300, 128, False, True),
    (1, 4, 4, 100, 300, 80, False, True),
    (1, 4, 4, 300, 100, 80, False, True),
])
def test_cuda_flash_attention_mma_route_matches_plain_version(
        card, B, HQ, HKV, S, SK, D, causal, view):
    """The tensor-core route equals the plain version (which keeps p in
    f32) at the bf16 tolerance: head dims 64/128 and, below the kernel's
    width, 32/72/80; GQA groups 1/2/8, ragged tiles, S != SK, non-causal,
    transposed views and contiguous tensors; every case is launched on
    that route and writes q's layout.  The error's norm is held too, and
    a non-causal case with a ragged key edge shows that this hold fails
    on a kernel that dropped its key mask."""
    rng = np.random.default_rng(43)
    shapes = ((B, S, HQ, D), (B, SK, HKV, D), (B, SK, HKV, D))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card, torch.bfloat16) for shape in shapes)
    q, k, v = (x.transpose(1, 2) if view else
               x.transpose(1, 2).contiguous() for x in (q, k, v))
    assert fa_kernel.route(q, k, v) == "mma"
    fa_kernel.reset_launches()
    got = fa_kernel.flash_attention(q, k, v, causal=causal)
    exp = fa_ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_kernel.LAUNCHES == {"flash_attention": 1,
                                  "flash_attention_mma": 1,
                                  "flash_attention_f32": 0,
                                  **dict.fromkeys(BWD_COUNTERS, 0)}
    assert got.dtype == torch.bfloat16 and got.stride() == q.stride()
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - exp.float()).abs().max()) <= 2e-2
    # the error's norm, which sees a 1% fault the absolute limit cannot;
    # non-causal with a ragged key edge: a dropped key mask fails it
    assert _rms_err(got, exp) <= _BF16_RMS_TOL
    ctrl = None if causal else _unmasked_tail(q, k, v)
    if ctrl is not None:
        assert _rms_err(ctrl, exp) > _BF16_RMS_TOL


# The f32 route (split TF32 on mma.sync) against its emulation,
# ``ref.flash_attention_ref(..., split_tf32=True)``: float32 GQA at head
# dims 64 and 128, the widest head dim, S != SK both ways, non-causal
# with a ragged key edge, and a bf16 view whose q base is one element past
# alignment (TMA refuses it)
F32_ROUTE_CASES = {
    "f32_gqa_d64": (1, 16, 2, 256, 256, 64, True, torch.float32, 0),
    "f32_gqa_d128": (1, 16, 2, 256, 256, 128, True, torch.float32, 0),
    "f32_d256": (1, 4, 4, 130, 70, 256, False, torch.float32, 0),
    "f32_s_lt_sk": (1, 4, 2, 100, 224, 128, True, torch.float32, 0),
    "f32_s_gt_sk": (1, 8, 2, 300, 130, 64, True, torch.float32, 0),
    "f32_noncausal_ragged": (1, 4, 2, 70, 300, 128, False, torch.float32,
                             0),
    "bf16_view": (1, 8, 2, 200, 200, 128, True, torch.bfloat16, 1),
}
SPLIT_TOL = 1e-5   # of the largest magnitude (PERF.md)


def _f32_route_inputs(card, case):
    B, HQ, HKV, S, SK, D, causal, dtype, shift = F32_ROUTE_CASES[case]
    rng = np.random.default_rng(47)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card, dtype).transpose(1, 2) for shape in
        ((B, S, HQ, D), (B, SK, HKV, D), (B, SK, HKV, D)))
    if shift:   # q's base one element past its allocation's start
        buf = torch.empty(q.numel() + shift, dtype=dtype, device=card)
        q = buf[shift:].view(B, S, HQ, D).transpose(1, 2).copy_(q)
    assert fa_kernel.route(q, k, v) == "f32"
    return q, k, v, causal


def _held_to_split(got, emu):
    """float32: within SPLIT_TOL of the emulation's (float32) largest
    magnitude; bf16: the emulation up to the output's one rounding (half
    a bf16 ulp, at most 2**-8 of the value, plus SPLIT_TOL of the
    largest)."""
    d = (got.float() - emu).abs()
    top = float(emu.abs().max())
    if got.dtype == torch.float32:
        return float(d.max()) <= SPLIT_TOL * top
    return bool((d <= 2.0 ** -8 * emu.abs() + SPLIT_TOL * top).all())


@pytest.mark.parametrize("case", list(F32_ROUTE_CASES))
def test_cuda_f32_route_matches_split_emulation(card, case):
    """The f32 route's kernel against its split TF32 emulation (above)
    and against the plain version at the existing tolerances (2e-5
    absolute in float32, 2e-2 in bf16); with the lse
    (``flash_attention_lse``, bottom-right mask) against
    ``ref.chunked_fwd`` in the same arithmetic (o) and the plain one
    (lse, 5e-5 absolute); two calls equal bit for bit; one launch each,
    on the f32 route."""
    q, k, v, causal = _f32_route_inputs(card, case)
    fa_kernel.reset_launches()
    got = fa_kernel.flash_attention(q, k, v, causal=causal)
    again = fa_kernel.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_kernel.LAUNCHES["flash_attention_f32"] == 2
    assert fa_kernel.LAUNCHES["flash_attention_mma"] == 0
    assert torch.equal(got, again) and got.stride() == q.stride()
    # the emulation's float32 output (bf16 inputs upcast exactly)
    emu = fa_ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                     causal=causal, split_tf32=True)
    exp = fa_ref.flash_attention_ref(q, k, v, causal=causal)
    tol = 2e-5 if q.dtype == torch.float32 else 2e-2
    assert float((got.float() - exp.float()).abs().max()) <= tol
    assert _held_to_split(got, emu)
    S, SK, D = q.shape[2], k.shape[2], q.shape[3]
    if causal and S > SK:
        return   # flash_attention_lse refuses it (tested below)
    o, lse = fa_kernel.flash_attention_lse(q, k, v, causal=causal)
    blocks = dict(zip(("q_chunk", "k_chunk"), fa_ref.default_blocks(S, SK)))
    o_emu = fa_ref.chunked_fwd(q.float(), k.float(), v.float(),
                               causal=causal, scale=D ** -0.5,
                               split_tf32=True, **blocks)[0]
    lse_exp = fa_ref.chunked_fwd(q.float(), k.float(), v.float(),
                                 causal=causal, scale=D ** -0.5,
                                 **blocks)[1]
    assert _held_to_split(o, o_emu)
    assert float((lse - lse_exp).abs().max()) <= 5e-5


def _delta_inputs(card, dtype, D, shift):
    """o and dO as [B, H, S, D] views of [B, S, H, D] tensors, dO's base
    ``shift`` elements past its allocation's start."""
    g = torch.Generator(device=card).manual_seed(D)
    B, H, S = 2, 4, 300

    def one(off):
        x = torch.randn((B, S, H, D), generator=g, device=card).to(dtype)
        buf = torch.empty(x.numel() + off, dtype=dtype, device=card)
        return buf[off:].view(B, S, H, D).copy_(x).transpose(1, 2)
    return one(0), one(shift)


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("D", [64, 80, 66])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_delta_matches_plain_version(card, dtype, D, shift):
    """The delta kernel against ``ref.delta_ref`` (float32 sums in another
    order: 1e-5 of the largest magnitude), at the load width
    ``kernel.delta_width`` gives: 16 bytes aligned (D 64 and 80), 4 bytes
    or one element at D 66 or with dO's base one element off; one
    launch, and a call repeats bit for bit."""
    o, do = _delta_inputs(card, dtype, D, shift)
    e = o.element_size()
    want = 16 if not shift and (D * e) % 16 == 0 else (
        4 if (D * e) % 4 == 0 and (not shift or e == 4) else e)
    assert fa_kernel.delta_width(o, do) == want
    fa_kernel.reset_launches()
    got = fa_kernel.flash_bwd_delta(o, do)
    again = fa_kernel.flash_bwd_delta(o, do)
    torch.cuda.synchronize()
    assert fa_kernel.LAUNCHES["flash_bwd_delta"] == 2
    exp = fa_ref.delta_ref(o, do)
    assert got.dtype == torch.float32 and got.shape == o.shape[:3]
    assert float((got - exp).abs().max()) <= 1e-5 * float(exp.abs().max())
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_delta_launch_refuses_a_width_the_views_forbid(card, dtype,
                                                            monkeypatch):
    """The delta launcher holds the width it is given to the rule itself:
    16-byte loads on a dO one element off its alignment are refused, and
    nothing is counted."""
    o, do = _delta_inputs(card, dtype, 64, 1)
    monkeypatch.setattr(fa_kernel, "delta_width", lambda o, do: 16)
    fa_kernel.reset_launches()
    with pytest.raises(RuntimeError, match="flash_bwd_delta launch failed"):
        fa_kernel.flash_bwd_delta(o, do)
    assert fa_kernel.LAUNCHES["flash_bwd_delta"] == 0


def test_cuda_serving_matches_cpu(card):
    """A reduced Qwen2.5-3B served on CUDA through the kernel gives the
    CPU's tokens and prefill logits (float32 compute, where the two differ
    only in summation order)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.models.transformer import OptFlags
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              n_layers=2, compute_dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, 40) for _ in range(3)]
    out, logits = {}, {}
    for d in ("cpu", card):
        eng = ServingEngine(cfg, params, slots=2, cache_len=64,
                            flags=OptFlags(attn_impl="pallas"), device=d)
        fa_kernel.reset_launches()
        done = eng.run([Request(rid=i, prompt=p, max_new=6)
                        for i, p in enumerate(prompts)], prompt_len=40)
        out[str(d)] = np.stack([r.output for r in done])
        launches = fa_kernel.LAUNCHES["flash_attention"]
        assert launches == (0 if d == "cpu" else 2 * cfg.n_layers)
        # float32 compute: every launch on the f32 route
        assert fa_kernel.LAUNCHES["flash_attention_f32"] == launches
        with torch.inference_mode():
            toks = torch.as_tensor(np.stack(prompts), dtype=torch.int32,
                                   device=d)
            logits[str(d)] = api.prefill_fn(cfg)(
                eng.weights, {"tokens": toks}, 64,
                OptFlags(attn_impl="pallas"))[0].cpu()
    np.testing.assert_array_equal(out["cpu"], out[str(card)])
    exp = logits["cpu"]
    assert float((logits[str(card)] - exp).abs().max()
                 / exp.abs().max()) < 1e-4


@pytest.mark.parametrize("Bz,L,H,P,N,chunk,dtype,tol", [
    (2, 256, 8, 64, 128, 64, torch.bfloat16, 2e-2),
    (2, 256, 8, 64, 128, 64, torch.float32, 1e-4),
    (2, 200, 4, 64, 128, 64, torch.bfloat16, 2e-2),
    (1, 40, 4, 32, 16, 64, torch.float32, 1e-4),
    (1, 130, 3, 32, 64, 16, torch.float32, 1e-4),
    (1, 100, 3, 64, 32, 32, torch.bfloat16, 2e-2),
    # the scoring grid (2 sequences of Mamba2-1.3B's 64 heads)
    (2, 300, 64, 64, 128, 64, torch.bfloat16, 2e-2),
    # P not a multiple of a warp's 16 rows; N < 128 with a ragged chunk
    (2, 150, 4, 48, 96, 64, torch.bfloat16, 2e-2),
    (2, 77, 5, 40, 24, 64, torch.float32, 1e-4),
    (1, 90, 2, 8, 8, 32, torch.float32, 1e-4),
])
def test_cuda_ssd_scan_matches_plain_version(card, Bz, L, H, P, N, chunk,
                                             dtype, tol):
    """The kernel pair equals its plain version (``ssd_chunked`` through
    ``ops.ssd(impl="chunked")``), y and the final state, with one launch
    of each kernel: bf16 and f32 x, ragged and short sequences, chunks of
    16-64, P and N below the tiles, x, B and C as strided views of one
    projection (the model's split) and B/C shared by the heads."""
    rng = np.random.default_rng(42)
    f32 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(card)
    wide = f32(Bz, L, H * P + 2 * N)
    x = wide.to(dtype)[..., : H * P].reshape(Bz, L, H, P)
    wide = wide * 0.3
    Bm, Cm = wide[..., H * P: H * P + N], wide[..., H * P + N:]
    assert not x.is_contiguous() and not Bm.is_contiguous()
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (Bz, L, H)).astype(
        np.float32)).to(card)
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, H).astype(np.float32)).to(
        card)
    D = f32(H)
    ssd_kernel.reset_launches()
    y, h = ssd_kernel.ssd_scan_heads(x, dt, A, Bm, Cm, D, chunk=chunk,
                                     h_final=True)
    torch.cuda.synchronize()
    assert ssd_kernel.LAUNCHES == {"ssd_cb": 1, "ssd_scan": 1}
    ey, eh = ssd_ops.ssd(x, dt, A, Bm, Cm, D, impl="chunked", chunk=chunk,
                         return_state=True)
    assert y.dtype == dtype and y.is_contiguous()
    assert bool(torch.isfinite(y).all())
    assert float((y.float() - ey.float()).abs().max()) <= tol
    assert float((h - eh).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype,x_offset,bc_pad", [
    (torch.bfloat16, 1, 1),    # x 2-byte aligned: staged without cp.async
    (torch.bfloat16, 2, 0),    # x 4-byte aligned: 4-byte cp.async
    (torch.float32, 1, 1),     # f32 x, B/C rows of an odd stride: 4-byte
])
def test_cuda_ssd_scan_misaligned_views(card, dtype, x_offset, bc_pad):
    """Views whose bases or row strides rule out 16-byte copies take the
    narrower staging paths and still equal the plain version."""
    rng = np.random.default_rng(44)
    Bz, L, H, P, N = 2, 150, 4, 32, 40
    width = x_offset + H * P + 2 * N + bc_pad
    wide = torch.from_numpy(rng.standard_normal((Bz, L, width)).astype(
        np.float32)).to(card)
    x = wide.to(dtype)[..., x_offset: x_offset + H * P].reshape(Bz, L, H, P)
    scaled = wide * 0.3
    Bm = scaled[..., x_offset + H * P: x_offset + H * P + N]
    Cm = scaled[..., x_offset + H * P + N: x_offset + H * P + 2 * N]
    assert x.data_ptr() % 16 and Bm.data_ptr() % 16
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (Bz, L, H)).astype(
        np.float32)).to(card)
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, H).astype(np.float32)).to(
        card)
    D = torch.from_numpy(rng.standard_normal(H).astype(np.float32)).to(card)
    y, h = ssd_kernel.ssd_scan_heads(x, dt, A, Bm, Cm, D, h_final=True)
    ey, eh = ssd_ops.ssd(x, dt, A, Bm, Cm, D, impl="chunked",
                         return_state=True)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((y.float() - ey.float()).abs().max()) <= tol
    assert float((h - eh).abs().max()) <= 1e-4


@pytest.mark.parametrize("Bz,L,N,chunk", [(2, 200, 128, 64), (3, 45, 20, 16)])
def test_cuda_chunk_cb_matches_plain_version(card, Bz, L, N, chunk):
    """The first kernel alone: C B^T per chunk of strided B/C views, a
    ragged last chunk zero past L, float32 within 1e-5 of the magnitude
    (the same products summed in another order)."""
    rng = np.random.default_rng(43)
    wide = torch.from_numpy(rng.standard_normal((Bz, L, 2 * N + 3)).astype(
        np.float32)).to(card)
    Bm, Cm = wide[..., :N], wide[..., N: 2 * N]
    ssd_kernel.reset_launches()
    g = ssd_kernel.chunk_cb(Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.LAUNCHES == {"ssd_cb": 1, "ssd_scan": 0}
    exp = ssd_ref.chunk_cb(Bm, Cm, chunk=chunk)
    assert tuple(g.shape) == tuple(exp.shape)
    assert float((g - exp).abs().max() / exp.abs().max()) <= 1e-5


def test_cuda_ssm_serving_matches_cpu(card):
    """A reduced Mamba2-1.3B served on CUDA through the ssd_scan kernel
    gives the CPU's tokens and prefill logits and scoring states (float32
    compute, where the two differ only in summation order)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.models import transformer as TF
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = dataclasses.replace(get_config("mamba2-1.3b").reduced(),
                              n_layers=2, compute_dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, 75) for _ in range(3)]
    out, logits, hidden = {}, {}, {}
    for d in ("cpu", card):
        eng = ServingEngine(cfg, params, slots=2, cache_len=75, device=d)
        ssd_kernel.reset_launches()
        done = eng.run([Request(rid=i, prompt=p, max_new=6)
                        for i, p in enumerate(prompts)], prompt_len=75)
        out[str(d)] = np.stack([r.output for r in done])
        launches = ssd_kernel.LAUNCHES["ssd_scan"]
        assert launches == (0 if d == "cpu" else 2 * cfg.n_layers)
        assert ssd_kernel.LAUNCHES["ssd_cb"] == launches
        with torch.inference_mode():
            toks = torch.as_tensor(np.stack(prompts), dtype=torch.int32,
                                   device=d)
            logits[str(d)] = api.prefill_fn(cfg)(
                eng.weights, {"tokens": toks}, 75)[0].cpu()
            hidden[str(d)] = TF.lm_forward(eng.weights, cfg, toks).cpu()
    np.testing.assert_array_equal(out["cpu"], out[str(card)])
    for got in (logits, hidden):
        exp = got["cpu"]
        assert float((got[str(card)] - exp).abs().max()
                     / exp.abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# the open-loop slice: tied store winners, the threefry draws, run_openloop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn_name", ["commit", "overwrite_clean"])
def test_cuda_tied_store_winners_match_cpu(card, fn_name):
    """Raw keys -1 and K - 1 tie as one register's winners (equal seqs)
    thousands of times a row: CUDA keeps the later write, as the CPU's
    serial scatter and the reference do."""
    from repro_torch.core import store as t_store

    rng = np.random.default_rng(90)
    N, K, V, W, B = 32, 4096, 4, 4, 2000
    seqs0 = np.zeros((N, K, V), np.int32)
    seqs0[..., 1:] = -1
    arrays = (rng.integers(0, 1 << 20, (N, K, V, W)).astype(np.int32), seqs0,
              np.zeros((N, K), np.int32), np.ones((N, K), np.int32))
    keys = rng.choice(np.array([-1, K - 1, 0, 7], np.int32), (N, B))
    seqs = rng.integers(1, 4, (N, B)).astype(np.int32)
    vals = rng.integers(0, 1 << 20, (N, B, W)).astype(np.int32)
    active = rng.random((N, B)) < 0.9
    out = {}
    for d in ("cpu", card):
        t = lambda a: torch.tensor(a, device=d)
        store = Store(*map(t, arrays))
        out[str(d)] = getattr(t_store, fn_name)(
            store, t(keys), t(vals), t(seqs), t(active))
    _assert_same(out["cpu"], out[str(card)], fn_name)


def test_cuda_threefry_draws_match_cpu(card):
    """Keys, folds, splits, uniform floats, integers and one tick's
    generator draws on the card equal the CPU's bit for bit."""
    from repro_torch.core import loadgen, prng

    out = {}
    for d in ("cpu", card):
        key = prng.fold_in(prng.PRNGKey(-7, device=d), 123_456)
        gen = loadgen.make_loadgen(_txn_cluster(), qps=300.0,
                                   write_fraction=0.3, txn_fraction=0.2,
                                   key_skew="zipf", device=d)
        t = torch.tensor(5, dtype=torch.int32, device=d)
        out[str(d)] = (prng.split(key, 5), prng.uniform(key, (4096,)),
                       prng.randint(key, (4096,), 1, 1 << 20),
                       loadgen.draw_tick(gen, 512, 4, t),
                       loadgen.followup_commits(gen, 512, 4, t))
    for i, (a, b) in enumerate(zip(out["cpu"], out[str(card)])):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b.cpu()), i
        else:
            _assert_same(a, b, f"draw {i}")
    assert int((out["cpu"][3].op != 0).sum()) > 0


def test_cuda_openloop_run_matches_cpu(card):
    """An overloaded open-loop run (zipf with transactions) on CUDA
    equals the CPU's: every state leaf, the telemetry plane included, and
    the backlog; one kv_read and one kv_write launch a tick."""
    from repro_torch.core import loadgen

    cl = _txn_cluster()
    out = {}
    for d in ("cpu", card):
        sim = ChainSim(cl, inject_capacity=4, route_capacity=96,
                       reply_capacity=2048, device=d)
        gen = loadgen.make_loadgen(cl, qps=48.0, write_fraction=0.25,
                                   txn_fraction=0.25, key_skew="zipf",
                                   backlog_capacity=64, device=d)
        t_kernel.reset_launches()
        state, gen = sim.run_openloop(sim.init_state(), gen, 24,
                                      arrival_width=64, extra_ticks=8)
        out[str(d)] = (state, gen, dict(t_kernel.LAUNCHES))
    cpu, gpu = out["cpu"], out[str(card)]
    _assert_same(cpu[0], gpu[0], "state")
    _assert_same(cpu[1], gpu[1], "gen")
    assert int(gpu[0].metrics.admission_drops.sum()) > 0
    assert int(gpu[0].telemetry.lat_hist.sum()) > 0
    assert gpu[2]["kv_read"] == gpu[2]["kv_write"] == 32


def test_cuda_zipf_schedule_matches_cpu(card):
    """A zipf ``make_schedule`` drawn on the card (threefry and the
    searchsorted there, the CDF from the host) equals the CPU's."""
    cl = t_types.ClusterConfig(
        chain=t_types.ChainConfig(n_nodes=4, num_keys=65536, num_versions=4),
        n_chains=8, buckets_per_chain=14, spare_keys=8192)
    wl = t_workload.WorkloadConfig(ticks=4, queries_per_tick=32,
                                   write_fraction=0.25, key_skew="zipf",
                                   seed=5)
    cpu = t_workload.make_schedule(cl, wl, device="cpu")
    gpu = t_workload.make_schedule(cl, wl, device=card)
    assert gpu.op.device.type == "cuda"
    _assert_same(cpu, gpu, "schedule")
    assert int(cpu.key.max()) > 0


def _chaos_cluster():
    return t_types.ClusterConfig(
        chain=t_types.ChainConfig(n_nodes=3, num_keys=6, num_versions=6),
        n_chains=2, buckets_per_chain=2, spare_keys=2)


def test_cuda_chaos_scenario_matches_cpu(card):
    """``tests/test_torch_chaos.py``'s four-kind scenario (fail, migrate,
    lease, recover) on CUDA and on the CPU: identical state, backlog and
    report, every drain invariant held on both; one kv_read and one
    kv_write launch a tick on the card."""
    from repro_torch.core import chaos, loadgen

    E = chaos.ChaosEvent
    scen = chaos.ChaosScenario("mixed", (
        E(tick=8, kind="fail", chain=0, node=1),
        E(tick=16, kind="migrate", bucket=2, dst_chain=0),
        E(tick=24, kind="lease", lease_ticks=12),
        E(tick=32, kind="recover", chain=0, node=1, position=1)), 48, 8)
    cl = _chaos_cluster()
    out = {}
    for d in ("cpu", card):
        sim = ChainSim(cl, inject_capacity=8, route_capacity=128,
                       reply_capacity=8192, device=d)
        gen = loadgen.make_loadgen(cl, qps=4.0, seed=3, backlog_capacity=64,
                                   write_fraction=0.3, txn_fraction=0.2,
                                   abandon_fraction=0.25, device=d)
        t_kernel.reset_launches()
        state, gen, rep = chaos.run_scenario(sim, gen, scen, lease_ticks=8)
        out[str(d)] = (state, gen, rep, dict(t_kernel.LAUNCHES))
    cpu, gpu = out["cpu"], out[str(card)]
    _assert_same(cpu[0], gpu[0], "state")
    _assert_same(cpu[1].backlog, gpu[1].backlog, "backlog")
    for k in ("samples", "metrics", "leaked_locks", "extra_ticks", "drained",
              "serial_keys"):
        assert cpu[2][k] == gpu[2][k], k
    ticks = int(gpu[0].t)
    assert gpu[3]["kv_read"] == gpu[3]["kv_write"] == ticks
    assert gpu[2]["metrics"]["stale_routes"] > 0


def test_cuda_set_lease_and_a_segment_make_no_host_sync(card):
    """``set_lease`` is a fill on the card, and an open-loop segment with
    transactions, a lease and abandoning clients syncs the host nowhere
    (the sync debug mode raises at any synchronizing call)."""
    from repro_torch.core import loadgen, txn

    cl = _chaos_cluster()
    sim = ChainSim(cl, inject_capacity=8, route_capacity=128,
                   reply_capacity=8192, device=card)
    gen = loadgen.make_loadgen(cl, qps=4.0, seed=3, backlog_capacity=64,
                               write_fraction=0.3, txn_fraction=0.2,
                               abandon_fraction=0.25, device=card)
    state, gen = sim.run_openloop(sim.init_state(), gen, 2, arrival_width=48,
                                  extra_ticks=0)         # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = state._replace(locks=txn.set_lease(state.locks, 7))
        state, gen = sim.run_openloop(state, gen, 8, arrival_width=48,
                                      extra_ticks=0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(state.locks.lease_ticks[0]) == 7
    assert int(state.t) == 10


def test_cuda_netchain_segment_makes_no_host_sync(card):
    """NetChain's tick writes cell 0 through ``store.overwrite_clean``: an
    open-loop NetChain segment with writes syncs the host nowhere, tied
    winners and all (the sync debug mode raises at any synchronizing
    call)."""
    from repro_torch.core import loadgen

    cl = t_types.ClusterConfig(
        chain=t_types.ChainConfig(n_nodes=3, num_keys=64, num_versions=4,
                                  protocol="netchain"), n_chains=2)
    sim = ChainSim(cl, inject_capacity=8, route_capacity=128,
                   reply_capacity=8192, device=card)
    gen = loadgen.make_loadgen(cl, qps=6.0, seed=3, backlog_capacity=64,
                               write_fraction=0.5, device=card)
    state, gen = sim.run_openloop(sim.init_state(), gen, 2, arrival_width=48,
                                  extra_ticks=0)         # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, gen = sim.run_openloop(state, gen, 8, arrival_width=48,
                                      extra_ticks=0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(state.t) == 10
    assert int(state.metrics.writes_in.sum()) > 0


# ---------------------------------------------------------------------------
# ChainDist and the kv_cache protocols on CUDA ranks (torch.distributed
# over gloo, every rank on this card; the workers import no JAX)
# ---------------------------------------------------------------------------
def _dist_spec():
    """A small grouped NetCRAQ run: 2 x 4 ranks, telemetry on, a failed
    node, a moved bucket, transactions and keys -1 and K."""
    import torch_dist_worker as W

    spec = dict(protocol="netcraq", n=4, C=2, K=32, V=4, buckets=3, spare=8,
                B=32, grouped=True, telemetry=True, fails=[(1, 1)],
                moves=[(0, 1)])
    roles, pmap = W.control_plane_inputs(spec)
    inj = W.client_injections(
        5, ticks=18, inject_ticks=10, C=2, n=4, B=32, q=4, K=32,
        versions=(0, 1), txn=W.txn_script(0, 0, (9, 17), other_node=2))
    return dict(spec, roles=roles, pmap=pmap, inj=inj)


def test_cuda_chain_dist_ranks_equal_cpu_ranks(card):
    """Every output of every step of a grouped ChainDist run on 8 CUDA
    ranks equals the same run on the CPU (plain versions), and each rank
    launches one kv_read and one kv_write a step."""
    import torch_dist_worker as W
    from repro_torch.core import collectives as coll

    res = coll.spawn_ranks(W.cuda_vs_cpu, 8, device="cuda", timeout=120,
                           args=(_dist_spec(),))
    for r, out in enumerate(res):
        assert out["diff"] is None, (r, out["diff"])
        steps = out["steps"]
        assert out["launches"]["kv_read"] == out["launches"]["kv_write"] \
            == steps, (r, out["launches"])


def test_cuda_kv_cache_ranks_equal_cpu_ranks(card):
    """The kv_cache protocols on 4 CUDA ranks give the CPU ranks' pages,
    acks and byte counts, bf16 and float32."""
    import torch_dist_worker as W
    from repro_torch.core import collectives as coll

    rng = np.random.default_rng(2)
    bf16 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16).view(torch.int16).numpy()
    data = {"bf16": dict(k=bf16(4, 3, 4, 1, 2, 16), v=bf16(4, 3, 4, 1, 2, 16),
                         seq=np.arange(4, dtype=np.int32).reshape(4, 1) + 5,
                         failed=rng.integers(0, 2, (4, 3)).astype(bool)),
            "f32": dict(k=rng.standard_normal((4, 8)).astype(np.float32),
                        v=rng.standard_normal((4, 8)).astype(np.float32),
                        seq=np.arange(4, dtype=np.int32).reshape(4, 1),
                        failed=np.zeros((4, 8), bool))}
    res = coll.spawn_ranks(W.kv_cuda_vs_cpu, 4, device="cuda", args=(data,))
    for r, out in enumerate(res):
        assert out["diff"] is None, (r, out["diff"])


def test_nccl_ranks_one_card_each_equal_gloo_cpu_ranks(card):
    """The NCCL path of ``core/collectives.py`` (CUDA tensors handed to
    the backend as they are, no host staging): an ungrouped NetCRAQ
    ``ChainDist`` with the telemetry plane, a dead node and transactions,
    and each collective, on 4 ranks, one card each, over NCCL, equal to
    the same on 4 gloo CPU ranks (a float32 sum within 4 eps of the sum
    of magnitudes: the backends add in their own orders); each NCCL rank
    launches one kv_read and one kv_write a step.  NCCL refuses two
    ranks on one card, so this needs 4 cards."""
    import torch_dist_worker as W
    from repro_torch.core import collectives as coll

    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards: NCCL takes one card a rank")
    spec = dict(protocol="netcraq", n=4, C=1, K=32, V=4, B=32,
                grouped=False, telemetry=True, fails=[(0, 1)], moves=[])
    roles, pmap = W.control_plane_inputs(spec)
    inj = W.client_injections(
        7, ticks=18, inject_ticks=10, C=1, n=4, B=32, q=4, K=32,
        versions=(0, 1), txn=W.txn_script(0, 0, (3, 5), other_node=2))
    spec = dict(spec, roles=roles, pmap=pmap,
                inj={f: v[:, 0] for f, v in inj.items()})
    rng = np.random.default_rng(4)
    data = {"int32": rng.integers(-(1 << 30), 1 << 30, (4, 3, 5)).astype(
                np.int32),
            "float32": rng.standard_normal((4, 4, 2)).astype(np.float32),
            "bfloat16": torch.from_numpy(rng.standard_normal((4, 6)).astype(
                np.float32)).to(torch.bfloat16).view(torch.int16).numpy()}
    nccl = coll.spawn_ranks(W.backend_run, 4, backend="nccl", device="cuda",
                            timeout=120, args=(spec, data))
    gloo = coll.spawn_ranks(W.backend_run, 4, backend="gloo", device="cpu",
                            timeout=120, args=(spec, data))
    exact = np.abs(data["float32"]).sum(axis=0)
    for r, (got, exp) in enumerate(zip(nccl, gloo)):
        steps = len(exp["chain"])
        assert got["launches"]["kv_read"] == got["launches"]["kv_write"] \
            == steps, (r, got["launches"])
        for t, (g, e) in enumerate(zip(got["chain"], exp["chain"])):
            for k in e:
                assert np.array_equal(g[k], e[k]), (r, t, k)
        assert got["coll"]["layout"] == exp["coll"]["layout"]
        assert got["coll"]["bytes"] == exp["coll"]["bytes"]
        for dtype in data:
            for op, e in exp["coll"][dtype].items():
                g = got["coll"][dtype][op]
                if op == "psum" and dtype == "float32":
                    bound = 4 * np.finfo(np.float32).eps * exact
                    assert (np.abs(g - data[dtype].sum(axis=0,
                            dtype=np.float64)) <= bound).all(), r
                    continue
                assert np.array_equal(g, e), (r, dtype, op)


# ---------------------------------------------------------------------------
# the MoE slice: the layer at Granite's full width, reduced serving, the
# examples' twins and the CUDA default
# ---------------------------------------------------------------------------
def test_cuda_moe_layer_matches_cpu_at_full_width(card):
    """One routing group of 512 tokens through Granite-MoE's full-width
    MoE layer (d 1536, 40 experts padded to 48, top-8) in float32 compute:
    the card's routing decisions equal the CPU's and its output is within
    1e-5 of the largest magnitude.  The tokens share a direction, as a
    model's hidden states do, so the router favours some experts and the
    capacity drops (token, slot)s."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              compute_dtype="float32")
    gen = torch.Generator().manual_seed(3)
    p = moe.moe_init(gen, cfg, "cpu")
    x = (torch.randn((1, 512, cfg.d_model), generator=gen)
         + torch.randn((cfg.d_model,), generator=gen))
    routes, outs = {}, {}
    for d in ("cpu", card):
        pd = p.to(d)
        with torch.inference_mode():
            routes[str(d)] = moe.moe_route(pd, x.to(d), cfg)
            outs[str(d)] = moe.moe_apply(pd, x.to(d), cfg).cpu()
    exp, got = routes["cpu"], routes[str(card)]
    assert exp.cap == got.cap
    for f in ("topi", "pos", "keep"):
        assert torch.equal(getattr(exp, f), getattr(got, f).cpu()), f
    assert 0 < int((~exp.keep).sum())          # the capacity drops some
    assert float((outs[str(card)] - outs["cpu"]).abs().max()
                 / outs["cpu"].abs().max()) < 1e-5


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "llama4-scout-17b-a16e"])
def test_cuda_moe_serving_matches_cpu(card, arch):
    """A reduced MoE model served on CUDA through the kernel gives the
    CPU's tokens and prefill logits (float32 compute, where the two differ
    only in summation order)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.models.transformer import OptFlags
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=2,
                              compute_dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, 40) for _ in range(3)]
    out, logits = {}, {}
    for d in ("cpu", card):
        eng = ServingEngine(cfg, params, slots=2, cache_len=64,
                            flags=OptFlags(attn_impl="pallas"), device=d)
        fa_kernel.reset_launches()
        done = eng.run([Request(rid=i, prompt=p, max_new=6)
                        for i, p in enumerate(prompts)], prompt_len=40)
        out[str(d)] = np.stack([r.output for r in done])
        launches = fa_kernel.LAUNCHES["flash_attention"]
        assert launches == (0 if d == "cpu" else 2 * cfg.n_layers)
        with torch.inference_mode():
            toks = torch.as_tensor(np.stack(prompts), dtype=torch.int32,
                                   device=d)
            logits[str(d)] = api.prefill_fn(cfg)(
                eng.weights, {"tokens": toks}, 64,
                OptFlags(attn_impl="pallas"))[0].cpu()
    np.testing.assert_array_equal(out["cpu"], out[str(card)])
    exp = logits["cpu"]
    assert float((logits[str(card)] - exp).abs().max()
                 / exp.abs().max()) < 1e-4


def test_cuda_hybrid_serving_matches_cpu(card):
    """A reduced Zamba2-2.7B (2 groups of 2 SSM layers and the shared
    attention block) served on CUDA through both kernels gives the CPU's
    tokens, prefill logits and scoring states (float32 compute, where the
    two differ only in summation order)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.models import transformer as TF
    from repro_torch.models.transformer import OptFlags
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(),
                              compute_dtype="float32")
    groups = cfg.n_layers // cfg.shared_attn_every
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, 75) for _ in range(3)]
    flags = OptFlags(attn_impl="pallas")
    out, logits, hidden = {}, {}, {}
    for d in ("cpu", card):
        eng = ServingEngine(cfg, params, slots=2, cache_len=96, flags=flags,
                            device=d)
        fa_kernel.reset_launches()
        ssd_kernel.reset_launches()
        done = eng.run([Request(rid=i, prompt=p, max_new=6)
                        for i, p in enumerate(prompts)], prompt_len=75)
        out[str(d)] = np.stack([r.output for r in done])
        on_card = d != "cpu"
        # two waves: each prefill runs every SSD core and every group's
        # shared attention on the kernels (float32: the f32 route)
        assert fa_kernel.LAUNCHES["flash_attention"] == 2 * groups * on_card
        assert fa_kernel.LAUNCHES["flash_attention_f32"] == \
            fa_kernel.LAUNCHES["flash_attention"]
        assert ssd_kernel.LAUNCHES["ssd_scan"] == 2 * cfg.n_layers * on_card
        assert ssd_kernel.LAUNCHES["ssd_cb"] == \
            ssd_kernel.LAUNCHES["ssd_scan"]
        with torch.inference_mode():
            toks = torch.as_tensor(np.stack(prompts), dtype=torch.int32,
                                   device=d)
            logits[str(d)] = api.prefill_fn(cfg)(
                eng.weights, {"tokens": toks}, 96, flags)[0].cpu()
            hidden[str(d)] = TF.lm_forward(
                eng.weights, cfg, toks,
                flags=OptFlags(flash_kernel=True)).cpu()
    np.testing.assert_array_equal(out["cpu"], out[str(card)])
    for got in (logits, hidden):
        exp = got["cpu"]
        assert float((got[str(card)] - exp).abs().max()
                     / exp.abs().max()) < 1e-4


def _stub_serving(card, arch, prompt_len, flags_for):
    """A reduced ``arch`` served on the CPU and on CUDA in float32
    compute from the same weights, its stub frontend's inputs zeros (the
    engine's) in the serving run and seeded in the prefill compared after
    it.  Returns the tokens, the prefill logits and the launch counters
    of each device's serving run."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.serve.engine import Request, ServingEngine, stub_inputs

    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, prompt_len) for _ in range(3)]
    stub = {name: torch.from_numpy((rng.standard_normal(tuple(x.shape))
                                    * 0.1).astype(np.float32))
            for name, x in stub_inputs(cfg, 3, "cpu").items()}
    cache_len = cfg.vis_len + prompt_len + 8
    flags = flags_for()
    out = {}
    for d in ("cpu", card):
        eng = ServingEngine(cfg, params, slots=2, cache_len=cache_len,
                            flags=flags, device=d)
        fa_kernel.reset_launches()
        done = eng.run([Request(rid=i, prompt=p, max_new=6)
                        for i, p in enumerate(prompts)],
                       prompt_len=prompt_len)
        launches = dict(fa_kernel.LAUNCHES)
        with torch.inference_mode():
            batch = {"tokens": torch.as_tensor(np.stack(prompts),
                                               dtype=torch.int32, device=d),
                     **{name: x.to(d) for name, x in stub.items()}}
            logits = api.prefill_fn(cfg)(eng.weights, batch, cache_len,
                                         flags)[0].cpu()
        out[str(d)] = (np.stack([r.output for r in done]), logits, launches)
    return cfg, out


@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-26b"])
def test_cuda_stub_frontend_serving_matches_cpu(card, arch):
    """A reduced Whisper-base (2 + 2 layers: the encoder's non-causal
    attention, the decoder's causal self- and non-causal cross-attention
    on the kernel) and a reduced InternVL2-26B (vision embeddings ahead
    of the prompt) served on CUDA give the CPU's tokens and prefill
    logits (float32 compute, where the two differ only in summation
    order), with every prefill attention one launch on the f32 route."""
    from repro_torch.models.transformer import OptFlags

    cfg, out = _stub_serving(card, arch, 24,
                             lambda: OptFlags(attn_impl="pallas"))
    per_prefill = (cfg.enc_layers + 2 * cfg.dec_layers
                   if cfg.family == "encdec" else cfg.n_layers)
    cpu, gpu = out["cpu"], out[str(card)]
    assert cpu[2]["flash_attention"] == 0
    # two waves (3 requests in slots of 2)
    assert gpu[2] == {"flash_attention": 2 * per_prefill,
                      "flash_attention_mma": 0,
                      "flash_attention_f32": 2 * per_prefill,
                      **dict.fromkeys(BWD_COUNTERS, 0)}
    np.testing.assert_array_equal(cpu[0], gpu[0])
    exp = cpu[1]
    assert float((gpu[1] - exp).abs().max() / exp.abs().max()) < 1e-4


def _example(name):
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parent.parent / "examples"
            / f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["quickstart", "fault_tolerance",
                                  "kv_serving"])
def test_cuda_examples_match_cpu(card, name, capsys):
    """Each twin prints the same lines on the card (``--device cuda``)
    and on the CPU, wall-clock numbers aside; on the card the chain
    examples tick through the kv kernels."""
    import re

    wall = re.compile(r"[\d,]+(\.\d+)?(?=(s|ms| tok/s)\b)")
    lines = {}
    for d in ("cuda", "cpu"):
        t_kernel.reset_launches()
        capsys.readouterr()
        _example(name).main(["--device", d])
        lines[d] = [wall.sub("<wall>", x)
                    for x in capsys.readouterr().out.splitlines()]
        if d == "cuda" and name != "kv_serving":
            assert t_kernel.LAUNCHES["kv_read"] > 0
            assert t_kernel.LAUNCHES["kv_write"] > 0
    assert lines["cuda"] == lines["cpu"] and len(lines["cpu"]) > 3


def test_cuda_is_the_default_device(card, capsys):
    """With a card, the entry points and the twins run on it unless asked
    for the CPU."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import api

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              n_layers=1)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    assert {p.device.type for p in params.parameters()} == {"cuda"}
    cache = api.init_decode_cache(cfg, 2, 8)
    assert cache["kv"][0].device.type == "cuda"
    t_kernel.reset_launches()
    _example("quickstart").main([])
    assert t_kernel.LAUNCHES["kv_read"] > 0
    assert "LEADER={7}" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# training: the forward with lse and the backward kernels
# ---------------------------------------------------------------------------
def _bwd_inputs(card, B, HQ, HKV, S, SK, D, dtype, seed=0):
    """q, k, v and dO as the model hands them over: [B, H, S, D] views of
    [B, S, H, D] tensors."""
    g = torch.Generator(device=card).manual_seed(seed)

    def one(H, T):
        return torch.randn((B, T, H, D), generator=g, device=card).to(
            dtype).transpose(1, 2)
    return one(HQ, S), one(HKV, SK), one(HKV, SK), one(HQ, S)


def _shifted(x, off: int):
    """x again as a [B, H, S, D] view of a [B, S, H, D] tensor whose base
    lies ``off`` elements past its allocation's start (off = 1: a base
    that is not 16-byte aligned, nor 4-byte for bf16)."""
    B, H, S, D = x.shape
    buf = torch.empty(B * S * H * D + off, dtype=x.dtype, device=x.device)
    y = buf[off:].view(B, S, H, D).transpose(1, 2)
    y.copy_(x)
    return y


def _bwd_launched(path: str) -> bool:
    """One launch of each backward kernel, the dk/dv and dq ones on the
    ``path`` route."""
    return all(fa_kernel.LAUNCHES[k] == (k in BWD_KERNELS + BWD_ROUTES[path])
               for k in BWD_COUNTERS)


def _bwd_plain(q, k, v, o, lse, do, causal, round_bf16=False,
               split_tf32=False):
    S, SK, D = q.shape[2], k.shape[2], q.shape[3]
    return fa_ref.chunked_bwd(
        q, k, v, o, lse, do, causal=causal, scale=D ** -0.5,
        round_bf16=round_bf16, split_tf32=split_tf32,
        **dict(zip(("q_chunk", "k_chunk"), fa_ref.default_blocks(S, SK))))


def _norm_err(got, exp) -> float:
    return float((got.float() - exp.float()).norm() / exp.float().norm())


# The tensor-core backward's gradients against the plain version that
# makes its two roundings (p and dS as bf16 operands): 2.9x the largest
# sound reading, 3.48e-4 (PERF.md); the rest is summation order,
# ex2.approx and a p or dS rounded the other way near a tie
BWD_EMU_TOL = 1e-3
# ... and against the unrounded plain version: the forward's bf16 limit
# (the roundings alone read 2.5e-3 to 2.7e-3)
BF16_NORM_TOL = 5e-3


@pytest.mark.parametrize("B,HQ,HKV,S,SK,D,dtype,causal,shift", [
    (2, 4, 2, 200, 200, 64, torch.bfloat16, True, 0),
    (2, 4, 4, 200, 700, 128, torch.bfloat16, True, 0),
    (1, 4, 4, 130, 260, 80, torch.bfloat16, False, 0),
    (2, 4, 1, 300, 300, 128, torch.float32, True, 0),
    (1, 2, 2, 64, 1500, 64, torch.float32, False, 0),
    (1, 16, 2, 256, 256, 128, torch.float32, True, 0),
    (2, 4, 2, 200, 200, 72, torch.float32, True, 0),
    (2, 4, 2, 200, 200, 64, torch.float32, True, 1),
])
def test_cuda_flash_backward_matches_plain_version(card, B, HQ, HKV, S, SK,
                                                   D, dtype, causal, shift):
    """o, lse and the backward kernels against ``ref.chunked_fwd`` and
    ``ref.chunked_bwd`` (the backward from the kernel's own o and lse),
    the gradients in their inputs' layouts.  bf16 takes the tensor-core
    pair: o to its error norm 5e-3, the gradients by their error norm to
    ``BWD_EMU_TOL`` against the plain version with the pair's roundings
    and to 5e-3 against the unrounded one, and two controls (delta
    dropped; causal, the mask dropped) read past both.  float32 takes the
    f32 pair (GQA at head dim 128, the ragged head dim 72, and q and dO
    views whose bases are ``shift`` elements past 16-byte alignment among
    its cases), to 1e-4 of the largest magnitude against the plain
    version and to 1e-5 against the plain version in the pair's split
    TF32 arithmetic (``ref.chunked_bwd(..., split_tf32=True)``).  One
    launch of each kernel, on its route.  The backward's plain version
    reads the kernel's lse, so the lse is held on its own to 5e-5
    against the plain forward on the inputs upcast to float32, which
    scales the float32 score as the kernels do (the reference's forward
    rounds q * scale to bf16 first)."""
    q, k, v, do = _bwd_inputs(card, B, HQ, HKV, S, SK, D, dtype)
    if shift:
        q, do = _shifted(q, shift), _shifted(do, shift)
        assert q.data_ptr() % 16 and do.data_ptr() % 16
    half = dtype == torch.bfloat16
    path = "mma" if half else "f32"
    assert fa_kernel.route_bwd(q, k, v, do) == path
    fa_kernel.reset_launches()
    o, lse = fa_kernel.flash_attention_lse(q, k, v, causal=causal)
    grads = fa_kernel.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert fa_kernel.LAUNCHES["flash_attention"] == 1
    assert _bwd_launched(path), fa_kernel.LAUNCHES
    blocks = dict(zip(("q_chunk", "k_chunk"), fa_ref.default_blocks(S, SK)))
    o_ref = fa_ref.chunked_fwd(q, k, v, causal=causal, scale=D ** -0.5,
                               **blocks)[0]
    lse_ref = fa_ref.chunked_fwd(q.float(), k.float(), v.float(),
                                 causal=causal, scale=D ** -0.5, **blocks)[1]
    plain = _bwd_plain(q, k, v, o, lse, do, causal)
    for g, x in zip(grads, (q, k, v)):
        assert g.stride() == x.stride() and g.dtype == x.dtype
    assert float((lse - lse_ref).abs().max()) <= 5e-5
    if not half:
        assert float((o - o_ref).abs().max() / o_ref.abs().max()) <= 1e-4
        split = _bwd_plain(q, k, v, o, lse, do, causal, split_tf32=True)
        for g, r, e in zip(grads, plain, split):
            assert float((g - r).abs().max() / r.abs().max()) <= 1e-4
            assert float((g - e).abs().max() / e.abs().max()) <= 1e-5
        return
    assert _norm_err(o, o_ref) <= 5e-3
    holds = ((_bwd_plain(q, k, v, o, lse, do, causal, True), BWD_EMU_TOL),
             (plain, BF16_NORM_TOL))
    for refs, limit in holds:
        for g, r in zip(grads, refs):
            assert _norm_err(g, r) <= limit
    controls = [_bwd_plain(q, k, v, torch.zeros_like(o), lse, do, causal,
                           True)]
    if causal:
        controls.append(_bwd_plain(q, k, v, o, lse, do, False, True))
    for ctrl in controls:
        for refs, limit in holds:
            assert max(_norm_err(c, r) for c, r in zip(ctrl, refs)) > limit


def test_cuda_flash_backward_f32_route_on_misaligned_bf16(card):
    """bf16 whose dO rows are not 16-byte aligned takes the f32 pair: one
    launch of each of its kernels, the gradients within 2.5e-4 of the
    unrounded plain version's norm (its f32 math rounds only the
    outputs)."""
    q, k, v, do = _bwd_inputs(card, 2, 4, 2, 200, 200, 64, torch.bfloat16)
    do_view = torch.empty((2, 200, 4, 66), dtype=torch.bfloat16,
                          device=card)[..., :64].transpose(1, 2)
    do_view.copy_(do)
    assert fa_kernel.route(q, k, v) == "mma"
    assert fa_kernel.route_bwd(q, k, v, do_view) == "f32"
    o, lse = fa_kernel.flash_attention_lse(q, k, v)
    fa_kernel.reset_launches()
    grads = fa_kernel.flash_attention_bwd(q, k, v, o, lse, do_view)
    torch.cuda.synchronize()
    assert _bwd_launched("f32"), fa_kernel.LAUNCHES
    for g, r in zip(grads, _bwd_plain(q, k, v, o, lse, do, True)):
        assert _norm_err(g, r) <= 2.5e-4


def test_cuda_chunked_attention_trains_through_the_kernels(card):
    """``mha(impl="chunked")`` under autograd on a card: the forward with
    lse and the backward kernels, nothing else, and the gradients of
    autograd through ``attention_ref`` (float32, 1e-4)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q, k, v, do = _bwd_inputs(card, 2, 8, 2, 333, 333, 64, torch.float32)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    fa_kernel.reset_launches()
    o = fa_ops.mha(*leaves, impl="chunked")
    grads = torch.autograd.grad(o, leaves, do)
    counts = dict(fa_kernel.LAUNCHES)
    assert counts["flash_attention"] == counts["flash_bwd_dq"] == 1
    o_ref = fa_ref.attention_ref(*leaves)
    ref_grads = torch.autograd.grad(o_ref, leaves, do)
    o, o_ref = o.detach(), o_ref.detach()
    assert float((o - o_ref).abs().max()) <= 1e-4 * float(o_ref.abs().max())
    for g, r in zip(grads, ref_grads):
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max())


@pytest.mark.parametrize("case", ["bf16", "float32", "bf16_misaligned"])
@pytest.mark.parametrize("D", [64, 128])
def test_cuda_backward_is_deterministic(card, D, case):
    """No atomics: two runs of the backward are equal bit for bit, at both
    widths of each pair: bf16 on the tensor-core pair; float32, and a bf16
    view whose q and dO bases are one element past alignment, on the f32
    pair."""
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    q, k, v, do = _bwd_inputs(card, 2, 4, 2, 500, 500, D, dtype)
    if case == "bf16_misaligned":
        q, do = _shifted(q, 1), _shifted(do, 1)
    path = "mma" if case == "bf16" else "f32"
    assert fa_kernel.route_bwd(q, k, v, do) == path
    o, lse = fa_kernel.flash_attention_lse(q, k, v)
    fa_kernel.reset_launches()
    a = fa_kernel.flash_attention_bwd(q, k, v, o, lse, do)
    b = fa_kernel.flash_attention_bwd(q, k, v, o, lse, do)
    assert fa_kernel.LAUNCHES[f"flash_bwd_dkdv_{path}"] == 2
    assert fa_kernel.LAUNCHES[f"flash_bwd_dq_{path}"] == 2
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_cuda_causal_s_gt_sk_chunked_raises(card):
    """Causal with S > SK leaves the first rows no key, which the kernel
    does not compute as the reference does: the chunked path raises."""
    q, k, v, do = _bwd_inputs(card, 1, 2, 2, 300, 100, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="S = 300 > SK = 100"):
        fa_kernel.flash_attention_lse(q, k, v, causal=True)
    o, lse = fa_kernel.flash_attention_lse(q, k, v, causal=False)
    assert o.shape == q.shape and lse.shape == q.shape[:3]


def test_cuda_kernel_wrappers_refuse_grad(card):
    """On a card, every kernel wrapper handed an input that requires grad
    under grad mode raises, and a model run on the forward kernel
    (``impl="pallas"``) under grad too; under ``no_grad`` both run."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    from repro_torch.models.transformer import OptFlags

    q, k, v, do = _bwd_inputs(card, 1, 2, 2, 64, 64, 64, torch.bfloat16)
    qg = q.detach().requires_grad_()
    for fn in (lambda: fa_kernel.flash_attention(qg, k, v),
               lambda: fa_kernel.flash_attention_lse(qg, k, v)):
        with pytest.raises(RuntimeError, match="requires grad"):
            fn()
    x = torch.randn(1, 64, 2, 32, device=card, requires_grad=True)
    dt = torch.rand(1, 64, 2, device=card)
    A, D = -torch.rand(2, device=card), torch.ones(2, device=card)
    Bm, Cm = (torch.randn(1, 64, 16, device=card) for _ in range(2))
    with pytest.raises(RuntimeError, match="requires grad"):
        ssd_kernel.ssd_scan_heads(x, dt, A, Bm, Cm, D)
    with pytest.raises(RuntimeError, match="requires grad"):
        ssd_kernel.chunk_cb(Bm.requires_grad_(), Cm)
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              n_layers=1)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), card)
    for p in params.parameters():
        p.requires_grad_(True)
    tok = torch.zeros((1, 64), dtype=torch.int32, device=card)
    batch = {"tokens": tok, "labels": tok}
    with pytest.raises(RuntimeError, match="requires grad"):
        api.loss_fn(cfg)(params, batch, OptFlags(attn_impl="pallas"))
    with torch.no_grad():
        api.loss_fn(cfg)(params, batch, OptFlags(attn_impl="pallas"))
    fa_kernel.reset_launches()
    api.loss_fn(cfg)(params, batch, OptFlags(attn_impl="chunked")).backward()
    assert fa_kernel.LAUNCHES["flash_bwd_dkdv"] == 1


def test_cuda_train_step_matches_cpu(card):
    """One float32 train step of the reduced Qwen1.5 (2 layers) with the
    training flags on the card (the kernels) and on the CPU (their plain
    versions), from the same weights: loss and gradient norm within 1e-4,
    the first moment within 1e-4 of its largest leaf, and every parameter
    within 1e-4 of its leaf plus lr times the difference of the two
    sides' normalised updates (each from its own moments) and 1e-3."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import OptFlags
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (build_train_step,
                                              init_train_state)

    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              n_layers=2, compute_dtype="float32")
    flags = OptFlags(attn_impl="chunked", remat="full", chunked_ce=True,
                     ce_chunk=32)
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 129), dtype=np.int32))
    out = {}
    for dev in (card, "cpu"):
        params, state = init_train_state(
            cfg, torch.Generator().manual_seed(0), dev)
        step = build_train_step(cfg, ocfg, flags)
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        params, state, stats = step(params, state, batch)
        # AdamW's normalised update after the first step, from this side's
        # own moments
        update = {k: (m.cpu() / (1 - ocfg.b1)) / (
            torch.sqrt(state.nu[k].cpu() / (1 - ocfg.b2)) + ocfg.eps)
            for k, m in state.mu.items()}
        out[str(dev)] = (stats, {k: p.detach().cpu() for k, p in
                                 params.named_parameters()},
                         {k: m.cpu() for k, m in state.mu.items()}, update)
    (sc, pc, mc, uc), (sp, pp, mp, up) = out[str(card)], out["cpu"]
    for k in ("loss", "grad_norm"):
        assert abs(float(sc[k]) - float(sp[k])) <= 1e-4 * abs(float(sp[k]))
    # the first moment is the gradient times (1 - b1): each leaf within
    # 1e-4 of the largest, over all leaves (a near-zero gradient, the key
    # bias's, carries the float32 noise of the whole loss)
    floor = max(float(m.abs().max()) for m in mp.values())
    for k, e in mp.items():
        assert float((mc[k] - e).abs().max()) <= 1e-4 * floor, k
    # both sides start from the same weights, so the parameters differ by
    # lr times the difference of their updates, which a gradient at that
    # noise may turn; an update skipped or of the wrong sign reads lr
    lr = float(sp["lr"])
    assert float(sc["lr"]) == lr
    for k, e in pp.items():
        slack = lr * ((uc[k] - up[k]).abs() + 1e-3)
        assert bool(((pc[k] - e).abs()
                     <= 1e-4 * float(e.abs().max()) + slack).all()), k
