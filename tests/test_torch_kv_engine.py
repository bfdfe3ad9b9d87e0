"""The port's kv_engine kernels against the reference's Pallas kernels.

On the CPU the wrappers run their plain versions (``ref.py``); these are
held, exactly, against ``repro.kernels.kv_engine.kernel`` in interpret
mode (as ``tests/test_kernels.py`` runs it) and against the reference's
sequential oracle.  The CUDA kernels themselves are held against the
plain versions on the card by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.store import Store as JStore  # noqa: E402
from repro.core.store import batch_rank as j_batch_rank  # noqa: E402
from repro.kernels.kv_engine import kernel as j_kernel  # noqa: E402
from repro.kernels.kv_engine import ops as j_ops  # noqa: E402
from repro.kernels.kv_engine import ref as j_ref  # noqa: E402
from repro_torch.core.store import Store as TStore  # noqa: E402
from repro_torch.core.store import batch_rank  # noqa: E402
from repro_torch.kernels.kv_engine import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.kv_engine import ops as t_ops  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, exp):
    got = got.cpu().numpy()
    exp = np.asarray(exp)
    assert got.dtype == exp.dtype, (got.dtype, exp.dtype)
    np.testing.assert_array_equal(got, exp)


def _store_arrays(rng, C, K, V, W, max_pending):
    values = rng.integers(0, 1 << 20, (C, K, V, W)).astype(np.int32)
    seqs = rng.integers(-1, 100, (C, K, V)).astype(np.int32)
    pending = rng.integers(0, max_pending + 1, (C, K)).astype(np.int32)
    return values, seqs, pending


@pytest.mark.parametrize("C,K,V,W,B,oob", [
    (2, 64, 4, 4, 32, False),
    (3, 32, 6, 4, 16, True),    # keys outside [0, K) answer zeros
    (2, 16, 3, 2, 8, True),
])
def test_read_engine_plain_matches_pallas(C, K, V, W, B, oob):
    rng = np.random.default_rng(C * K + B)
    values, seqs, pending = _store_arrays(rng, C, K, V, W, V - 1)
    lo, hi = (-3, K + 3) if oob else (0, K)
    keys = rng.integers(lo, hi, (C, B)).astype(np.int32)
    exp = j_kernel.cluster_read_engine(
        jnp.asarray(values), jnp.asarray(seqs), jnp.asarray(pending),
        jnp.asarray(keys), tk=min(K, 32), tb=B, interpret=True)
    before = dict(t_kernel.LAUNCHES)
    got = t_kernel.cluster_read_engine(_t(values), _t(seqs), _t(pending),
                                       _t(keys))
    for g, e in zip(got, exp):
        _eq(g, e)
    assert t_kernel.LAUNCHES == before  # the CPU path launches nothing
    if not oob:
        for g, e in zip(got, j_ref.cluster_read_engine_ref(
                jnp.asarray(values), jnp.asarray(seqs),
                jnp.asarray(pending), jnp.asarray(keys))):
            _eq(g, e)


@pytest.mark.parametrize("C,K,V,W,B,key_space,oob", [
    (2, 64, 4, 4, 32, 8, False),   # heavy same-key collisions
    (3, 32, 3, 4, 16, 3, False),   # window overflow
    (2, 16, 4, 2, 24, 16, True),   # out-of-range keys are dropped
])
def test_write_engine_plain_matches_pallas_and_oracle(C, K, V, W, B,
                                                      key_space, oob):
    rng = np.random.default_rng(C * K + B + key_space)
    values, seqs, pending = _store_arrays(rng, C, K, V, W, 1)
    lo = -2 if oob else 0
    hi = K + 2 if oob else key_space
    keys = rng.integers(lo, hi, (C, B)).astype(np.int32)
    wvals = rng.integers(0, 1 << 20, (C, B, W)).astype(np.int32)
    wseqs = rng.integers(0, 1000, (C, B)).astype(np.int32)
    active = rng.integers(0, 2, (C, B)).astype(np.int32)
    rank = np.asarray(jax.vmap(j_batch_rank)(jnp.asarray(keys),
                                             jnp.asarray(active, bool)))
    t_rank = batch_rank(_t(keys), _t(active).bool())
    _eq(t_rank, rank)
    exp = j_kernel.cluster_write_engine(
        *[jnp.asarray(a) for a in (values, seqs, pending, keys, wvals, wseqs,
                                   active, rank)],
        tk=min(K, 32), interpret=True)
    got = t_kernel.cluster_write_engine(
        *[_t(a) for a in (values, seqs, pending, keys, wvals, wseqs, active,
                          rank)])
    for g, e in zip(got, exp):
        _eq(g, e)
    assert int(got[3].sum()) < int(active.sum())
    if not oob:
        oracle = j_ref.cluster_write_engine_ref(
            *[jnp.asarray(a) for a in (values, seqs, pending, keys, wvals,
                                       wseqs, active, rank)])
        for g, e in zip(got, oracle):
            _eq(g, e)


@pytest.mark.parametrize("is_tail", [False, True])
def test_cluster_read_batch_matches_reference_ops(is_tail):
    rng = np.random.default_rng(11)
    C, K, V, W, B = 2, 32, 4, 4, 16
    values, seqs, pending = _store_arrays(rng, C, K, V, W, V - 1)
    next_seq = np.ones((C, K), np.int32)
    keys = rng.integers(0, K, (C, B)).astype(np.int32)
    js = JStore(*[jnp.asarray(a) for a in (values, seqs, pending, next_seq)])
    ts = TStore(*[_t(a) for a in (values, seqs, pending, next_seq)])
    exp = j_ops.cluster_read_batch(js, jnp.asarray(keys), is_tail=is_tail)
    got = t_ops.cluster_read_batch(ts, _t(keys), is_tail=is_tail)
    for g, e in zip(got, exp):
        _eq(g, e)
    # a per-node tail flag answers each row as its scalar twin would
    per_row = t_ops.cluster_read_batch(
        ts, _t(keys), is_tail=torch.tensor([is_tail, not is_tail]))
    other = t_ops.cluster_read_batch(ts, _t(keys), is_tail=not is_tail)
    for a, b, c in zip(per_row, got, other):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], c[1])


def test_cluster_write_batch_matches_reference_ops():
    rng = np.random.default_rng(12)
    C, K, V, W, B = 2, 32, 5, 4, 24
    values, seqs, pending = _store_arrays(rng, C, K, V, W, 1)
    next_seq = np.ones((C, K), np.int32)
    keys = rng.integers(0, 6, (C, B)).astype(np.int32)
    wvals = rng.integers(0, 1 << 20, (C, B, W)).astype(np.int32)
    wseqs = rng.integers(0, 1000, (C, B)).astype(np.int32)
    active = rng.integers(0, 2, (C, B)).astype(bool)
    js = JStore(*[jnp.asarray(a) for a in (values, seqs, pending, next_seq)])
    ts = TStore(*[_t(a) for a in (values, seqs, pending, next_seq)])
    jnew, jacc = j_ops.cluster_write_batch(
        js, jnp.asarray(keys), jnp.asarray(wvals), jnp.asarray(wseqs),
        jnp.asarray(active))
    tnew, tacc = t_ops.cluster_write_batch(ts, _t(keys), _t(wvals),
                                           _t(wseqs), _t(active))
    _eq(tacc, jacc)
    for f in JStore._fields:
        _eq(getattr(tnew, f), getattr(jnew, f))


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous"])
def test_wrappers_reject_bad_inputs(bad):
    C, K, V, W, B = 2, 8, 3, 4, 4
    values = torch.zeros((C, K, V, W), dtype=torch.int32)
    seqs = torch.zeros((C, K, V), dtype=torch.int32)
    pending = torch.zeros((C, K), dtype=torch.int32)
    keys = torch.zeros((C, B), dtype=torch.int32)
    if bad == "dtype":
        keys = keys.long()
    elif bad == "shape":
        pending = torch.zeros((C, K + 1), dtype=torch.int32)
    else:
        keys = torch.zeros((B, C), dtype=torch.int32).t()
    with pytest.raises((TypeError, ValueError)):
        t_kernel.cluster_read_engine(values, seqs, pending, keys)
    with pytest.raises((TypeError, ValueError)):
        t_kernel.cluster_write_engine(
            values, seqs, pending, keys,
            torch.zeros((C, B, W), dtype=torch.int32), keys, keys, keys)

