"""The port's replicated KV-cache protocols (``serve/kv_cache.py``) on 4
gloo CPU ranks against ``repro.serve.kv_cache`` under ``shard_map`` on
4 emulated devices, exact (every output is a copy of an input or a sum
with zeros): seeded bf16 K/V pages at a decode step's layout and int32
commit sequence numbers.  ``netchain_read``'s broadcast from the tail is
held to the reference's tail-masked ``psum``.  Plus the torch twins of
``test_replicated_kv_cache_protocols`` and ``test_failover_select``
(``tests/test_chain_dist.py``), and the bytes each protocol sends.
"""
import concurrent.futures

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from helpers import run_with_devices
from repro_torch.core import collectives as coll
from repro_torch.serve import kv_cache as KV

N = 4
REFERENCE = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.serve import kv_cache as KV

data = dict(np.load(%(inp)r))
n = 4
mesh = jax.make_mesh((n,), ("chain",))
k = jnp.asarray(data["k"]).view(jnp.bfloat16)
v = jnp.asarray(data["v"]).view(jnp.bfloat16)
seq = jnp.asarray(data["seq"])

def body(k, v, seq):
    own, replica, ack = KV.netcraq_append((k, v), seq, axis="chain", n=n)
    fetched = KV.netchain_read((k, v), axis="chain", n=n)
    committed, ack2 = KV.netchain_append((k, v), seq, axis="chain", n=n)
    return own, replica, ack, fetched, committed, ack2

spec = P("chain")
f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec, spec),
                          out_specs=spec, check_vma=False))
own, replica, ack, fetched, committed, ack2 = f(k, v, seq)
host = lambda tree: tuple(jnp.asarray(np.asarray(x)) for x in tree)
chosen = jax.vmap(KV.failover_select)(host((k, v)), host(replica),
                                      jnp.asarray(data["failed"]))
bits = lambda x: np.asarray(x).view(np.int16)
out = {"ack": np.asarray(ack), "ack2": np.asarray(ack2)}
for name, tree in (("own", own), ("replica", replica), ("fetched", fetched),
                   ("committed", committed), ("chosen", chosen)):
    out[name + "/k"], out[name + "/v"] = bits(tree[0]), bits(tree[1])
np.savez(%(out)r, **out)
print("KV_OK")
"""


def _seeded():
    """Per-replica decode pages ``[n, L, B, page, KV, D]`` in bf16 (as
    int16 bit patterns), seqs and a failed mask per replica's batch."""
    rng = np.random.default_rng(11)
    bf16 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16).view(torch.int16).numpy()
    L, B, P, KVH, D = 3, 4, 1, 2, 16
    return dict(k=bf16(N, L, B, P, KVH, D), v=bf16(N, L, B, P, KVH, D),
                seq=rng.integers(0, 1 << 20, (N, 1)).astype(np.int32),
                failed=rng.integers(0, 2, (N, L)).astype(bool))


def _twin():
    """The reference test's data: distinct float32 pages per node."""
    kv = np.arange(N * 8, dtype=np.float32).reshape(N, 8)
    return dict(k=kv, v=kv + 100, seq=(np.arange(N, dtype=np.int32) + 10
                                       ).reshape(N, 1),
                failed=np.zeros((N, 8), bool))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kv_cache")
    inp, out = str(tmp / "inputs.npz"), str(tmp / "reference.npz")
    seeded = _seeded()
    np.savez(inp, **seeded)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref_run = pool.submit(run_with_devices,
                              REFERENCE % dict(inp=inp, out=out), N, 300)
        port = coll.spawn_ranks(W.kv_cache_run, N, device="cpu", args=(
            {"seeded": seeded, "twin": _twin()},))
        assert "KV_OK" in ref_run.result()
    return dict(np.load(out)), port, seeded


@pytest.mark.parametrize("what", ["own", "replica", "fetched", "committed",
                                  "chosen"])
def test_kv_cache_pages_equal_reference(runs, what):
    ref, port, _ = runs
    for i, leaf in enumerate(("k", "v")):
        exp = ref[f"{what}/{leaf}"]
        got = np.stack([port[r]["seeded"][what][i] for r in range(N)])
        assert got.dtype == exp.dtype and got.shape == exp.shape
        assert np.array_equal(got, exp), (what, leaf)


def test_kv_cache_acks_equal_reference(runs):
    ref, port, seeded = runs
    for key in ("ack", "ack2"):
        got = np.stack([port[r]["seeded"][key] for r in range(N)])
        assert got.dtype == ref[key].dtype
        assert np.array_equal(got, ref[key])
    assert (ref["ack"] == seeded["seq"][-1]).all()


def test_replicated_kv_cache_protocols(runs):
    """Torch twin: node i > 0 stores node i - 1's page, the tail's seq
    reaches everyone, CR reads fetch the tail's page and the tail ends
    holding the head's page after n - 1 hops."""
    _, port, _ = runs
    kv = _twin()["k"]
    rep = [port[r]["twin"] for r in range(N)]
    replica = np.stack([x["replica"][0] for x in rep])
    assert np.allclose(replica[1:], kv[:-1]) and np.allclose(replica[0], kv[0])
    assert np.concatenate([x["ack"] for x in rep]).tolist() == [13] * N
    fetched = np.stack([x["fetched"][0] for x in rep])
    assert np.allclose(fetched, np.tile(kv[-1], (N, 1)))
    assert np.allclose(rep[-1]["committed"][0], kv[0])
    assert np.allclose(rep[0]["committed"][0], kv[0])


def test_kv_cache_bytes_per_protocol(runs):
    """NetCRAQ sends one page a hop and a 4-byte ack; NetChain's read
    sends the tail's window to n - 1 replicas and its append n - 1
    hops."""
    _, port, seeded = runs
    page = seeded["k"][0].nbytes + seeded["v"][0].nbytes
    for r in range(N):
        res = port[r]["seeded"]
        tail = r == N - 1
        assert res["craq_bytes"]["ppermute"] == (0 if tail else page)
        assert res["craq_bytes"]["psum"] == 4 * (N - 1)
        assert res["read_bytes"]["broadcast"] == ((N - 1) * page if tail
                                                  else 0)
        assert res["chain_bytes"]["ppermute"] == (0 if tail
                                                  else (N - 1) * page)


def test_failover_select():
    local = torch.zeros((4, 3))
    replica = torch.ones((4, 3))
    failed = torch.tensor([True, False, True, False])
    out = KV.failover_select(local, replica, failed)
    assert out[:, 0].tolist() == [1., 0., 1., 0.]
    both = KV.failover_select({"k": local, "v": local[:, :1]},
                              {"k": replica, "v": replica[:, :1]}, failed)
    assert both["v"][:, 0].tolist() == [1., 0., 1., 0.]
