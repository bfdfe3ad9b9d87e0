"""The port on the card: each CUDA kernel against its plain version, and a
small cluster run on CUDA against the same run on the CPU.  Imports no
JAX, so it runs where only PyTorch is installed; without a card every
test skips:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
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

pytestmark = pytest.mark.cuda


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
