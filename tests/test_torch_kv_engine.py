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

from repro.core import store as j_store  # noqa: E402
from repro.core.store import Store as JStore  # noqa: E402
from repro.core.store import batch_rank as j_batch_rank  # noqa: E402
from repro.kernels.kv_engine import kernel as j_kernel  # noqa: E402
from repro.kernels.kv_engine import ops as j_ops  # noqa: E402
from repro.kernels.kv_engine import ref as j_ref  # noqa: E402
from repro_torch.core.store import Store as TStore  # noqa: E402
from repro_torch.core.store import batch_rank  # noqa: E402
from repro_torch.kernels.kv_engine import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.kv_engine import ops as t_ops  # noqa: E402
from repro_torch.kernels.kv_engine import ref as t_ref  # noqa: E402


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



# ---------------------------------------------------------------------------
# the node step's read and append (the kernels' ops mode) against the
# reference store, and the one-chain views
# ---------------------------------------------------------------------------
def _node_batch(rng, N, K, V, B):
    """A store with every pending count in [0, V - 1] (full version
    windows included) and a [N, B] batch with duplicates in each row's
    first quarter and a fifth of the keys among -1, K - 1, K, -K - 1."""
    values, seqs, pending = _store_arrays(rng, N, K, V, 4, V - 1)
    keys = rng.integers(0, K, (N, B)).astype(np.int32)
    keys[:, : B // 4] = rng.integers(0, 3, (N, B // 4))
    odd = rng.random((N, B)) < 0.2
    keys[odd] = rng.choice(np.array([-1, K - 1, K, -K - 1], np.int32),
                           int(odd.sum()))
    return values, seqs, pending, keys


def _j_node_read(store, keys, tail):
    """The reference store's read on one node, as its node step decides."""
    cv, cs = j_store.read_clean(store, keys)
    lv, ls = j_store.read_latest(store, keys)
    clean = j_store.is_clean(store, keys)
    dirty_tail = ~clean & tail
    return (jnp.where(dirty_tail[:, None], lv, cv),
            jnp.where(dirty_tail, ls, cs),
            jnp.where(clean, 0, jnp.where(tail, 1, 2)).astype(jnp.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tail", ["mixed", "all", "none"])
def test_cluster_read_batch_matches_reference_store(seed, tail):
    N, K, V, B = 4, 16, 4, 48
    rng = np.random.default_rng(500 + seed)
    values, seqs, pending, keys = _node_batch(rng, N, K, V, B)
    per_node = {"mixed": np.array([False, True, False, True]),
                "all": np.ones(N, bool), "none": np.zeros(N, bool)}[tail]
    js = JStore(*[jnp.asarray(a) for a in (values, seqs, pending,
                                           np.ones((N, K), np.int32))])
    exp = jax.vmap(_j_node_read)(js, jnp.asarray(keys),
                                 jnp.asarray(per_node))
    ts = TStore(*[_t(a) for a in (values, seqs, pending,
                                  np.ones((N, K), np.int32))])
    before = dict(t_kernel.LAUNCHES)
    flags = [torch.from_numpy(per_node)]
    if tail != "mixed":
        flags.append(tail == "all")       # the scalar flag answers the same
    for flag in flags:
        got = t_ops.cluster_read_batch(ts, _t(keys), is_tail=flag)
        for g, e in zip(got, exp):
            _eq(g, e)
    assert t_kernel.LAUNCHES == before  # the CPU path launches nothing
    decisions = {"mixed": {0, 1, 2}, "all": {0, 1}, "none": {0, 2}}[tail]
    assert set(np.unique(got[2].numpy()).tolist()) == decisions


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cluster_write_batch_matches_reference_store(seed):
    N, K, V, B = 4, 16, 4, 48
    rng = np.random.default_rng(600 + seed)
    values, seqs, pending, keys = _node_batch(rng, N, K, V, B)
    pending = np.minimum(pending, 1).astype(np.int32)
    pending[:, :2] = V - 1                 # full windows: every write drops
    wvals = rng.integers(0, 1 << 20, (N, B, 4)).astype(np.int32)
    wseqs = rng.integers(0, 1000, (N, B)).astype(np.int32)
    active = rng.random((N, B)) < 0.7
    next_seq = np.ones((N, K), np.int32)
    js = JStore(*[jnp.asarray(a) for a in (values, seqs, pending, next_seq)])
    jnew, jacc = jax.vmap(j_store.append_dirty)(
        js, jnp.asarray(keys), jnp.asarray(wvals), jnp.asarray(wseqs),
        jnp.asarray(active))
    ts = TStore(*[_t(a) for a in (values, seqs, pending, next_seq)])
    before = dict(t_kernel.LAUNCHES)
    tnew, tacc = t_ops.cluster_write_batch(ts, _t(keys), _t(wvals),
                                           _t(wseqs), _t(active))
    assert t_kernel.LAUNCHES == before
    _eq(tacc, jacc)
    for f in JStore._fields:
        _eq(getattr(tnew, f), getattr(jnew, f))
    acc = tacc.numpy()
    assert 0 < acc.sum() < active.sum()
    # a dropped key (K, -K - 1) is accepted where its clamped slot fits
    assert acc[active & ((keys == K) | (keys == -K - 1))].any()


def test_two_raw_keys_of_one_cell_keep_the_later_write():
    """-1 and K - 1 resolve to one register and rank apart, so their
    writes can share a cell; the reference's scatter keeps the later one.
    At this size torch's own scatter runs on several threads and kept
    either; the plain append and ``store.append_dirty`` keep the later,
    run after run."""
    from repro_torch.core import store as t_store

    N, K, V, B = 3, 256, 5, 2000
    rng = np.random.default_rng(2050)
    values, seqs, pending, keys = _node_batch(rng, N, K, V, B)
    pending = np.minimum(pending, 1).astype(np.int32)
    wvals = rng.integers(0, 1 << 20, (N, B, 4)).astype(np.int32)
    wseqs = rng.integers(0, 1 << 20, (N, B)).astype(np.int32)
    active = rng.random((N, B)) < 0.7
    leaves = (values, seqs, pending, np.ones((N, K), np.int32))
    jnew, jacc = jax.vmap(j_store.append_dirty)(
        JStore(*map(jnp.asarray, leaves)),
        *map(jnp.asarray, (keys, wvals, wseqs, active)))
    for _ in range(3):
        for fn in (t_ops.cluster_write_batch, t_store.append_dirty):
            tnew, tacc = fn(TStore(*[_t(a.copy()) for a in leaves]),
                            *map(_t, (keys, wvals, wseqs, active)))
            _eq(tacc, jacc)
            for f in JStore._fields:
                _eq(getattr(tnew, f), getattr(jnew, f))
    # the case is there: a -1 and a K - 1 write accepted into one slot
    rank = np.asarray(jax.vmap(j_batch_rank)(jnp.asarray(keys),
                                             jnp.asarray(active)))
    acc = np.asarray(jacc)
    shared = [(n, r) for n in range(N) for r in range(V)
              if ((keys[n] == -1) & acc[n] & (rank[n] == r)).any()
              and ((keys[n] == K - 1) & acc[n] & (rank[n] == r)).any()]
    assert shared

@pytest.mark.parametrize("K,V,W,B", [(256, 4, 4, 128), (1024, 4, 4, 512),
                                     (512, 8, 2, 256), (2048, 2, 8, 64)])
def test_read_engine_one_chain_matches_pallas(K, V, W, B):
    rng = np.random.default_rng(K + B)
    values = rng.integers(0, 1 << 20, (K, V, W)).astype(np.int32)
    seqs = rng.integers(-1, 100, (K, V)).astype(np.int32)
    pending = rng.integers(0, V - 1, (K,)).astype(np.int32)
    keys = rng.integers(0, K, (B,)).astype(np.int32)
    args = (values, seqs, pending, keys)
    exp = j_kernel.read_engine(*[jnp.asarray(a) for a in args])
    for e, r in zip(exp, j_ref.read_engine_ref(*[jnp.asarray(a)
                                                for a in args])):
        np.testing.assert_array_equal(np.asarray(e), np.asarray(r))
    for fn in (t_kernel.read_engine, t_ref.read_engine_ref):
        for g, e in zip(fn(*[_t(a) for a in args]), exp):
            _eq(g, e)


@pytest.mark.parametrize("K,V,W,B,key_space", [
    (256, 4, 4, 128, 16),   # heavy collisions
    (1024, 6, 4, 256, 1024),
    (512, 3, 2, 64, 4),     # overflow-heavy
])
def test_write_engine_one_chain_matches_sequential_oracle(K, V, W, B,
                                                          key_space):
    rng = np.random.default_rng(K + B + key_space)
    values = np.zeros((K, V, W), np.int32)
    seqs = np.full((K, V), -1, np.int32)
    seqs[:, 0] = 0
    pending = np.zeros((K,), np.int32)
    keys = rng.integers(0, key_space, (B,)).astype(np.int32)
    wvals = rng.integers(0, 1 << 20, (B, W)).astype(np.int32)
    wseqs = rng.integers(0, 1000, (B,)).astype(np.int32)
    active = rng.integers(0, 2, (B,)).astype(np.int32)
    rank = np.asarray(j_batch_rank(jnp.asarray(keys),
                                   jnp.asarray(active, bool)))
    _eq(batch_rank(_t(keys)[None], _t(active)[None].bool())[0], rank)
    args = (values, seqs, pending, keys, wvals, wseqs, active, rank)
    exp = j_kernel.write_engine(*[jnp.asarray(a) for a in args])
    oracle = j_ref.write_engine_ref(*[jnp.asarray(a) for a in args])
    for e, o in zip(exp, oracle):
        np.testing.assert_array_equal(np.asarray(e), np.asarray(o))
    for fn in (t_kernel.write_engine, t_ref.write_engine_ref):
        leaves = [_t(a.copy()) for a in args[:3]]
        got = fn(*leaves, *[_t(a) for a in args[3:]])
        for g, e in zip(got, exp):
            _eq(g, e)
        for g, leaf in zip(got, leaves):   # edited in place
            assert g.data_ptr() == leaf.data_ptr()


def test_craq_ops_one_chain_match_reference():
    """``tests/test_kernels.py::test_kv_ops_integration_with_store`` in
    torch form: a write batch, then reads at a non-tail node (clean or
    forward) and at the tail (clean or answered dirty), equal to the
    reference's one-chain ops."""
    from repro.core.store import init_store as j_init
    from repro.core.types import ChainConfig as JChain
    from repro_torch.core.store import init_store as t_init
    from repro_torch.core.types import ChainConfig as TChain

    rng = np.random.default_rng(13)
    B = 64
    keys = rng.integers(0, 256, (B,)).astype(np.int32)
    vals = rng.integers(0, 100, (B, 4)).astype(np.int32)
    seqs = np.arange(1, B + 1, dtype=np.int32)
    active = np.ones((B,), bool)
    jstore2, jacc = j_ops.craq_write_batch(
        j_init(JChain(n_nodes=4, num_keys=256, num_versions=4)),
        *map(jnp.asarray, (keys, vals, seqs, active)))
    store = t_init(TChain(n_nodes=4, num_keys=256, num_versions=4),
                   shape=(), device="cpu")
    store2, acc = t_ops.craq_write_batch(store, *map(_t, (keys, vals, seqs,
                                                          active)))
    assert store2.values.data_ptr() == store.values.data_ptr()
    _eq(acc, jacc)
    assert bool(acc.any())
    for f in JStore._fields:
        _eq(getattr(store2, f), getattr(jstore2, f))
    for is_tail, allowed in ((False, {0, 2}), (True, {0, 1})):
        got = t_ops.craq_read_batch(store2, _t(keys), is_tail=is_tail)
        exp = j_ops.craq_read_batch(jstore2, jnp.asarray(keys),
                                    is_tail=is_tail)
        for g, e in zip(got, exp):
            _eq(g, e)
        assert set(np.unique(got[2].numpy()).tolist()) <= allowed


@pytest.mark.parametrize("bad", ["active", "is_tail", "keys"])
def test_ops_mode_wrappers_reject_bad_inputs(bad):
    """The ops-mode wrappers take the inbox's dtypes as they come (int32
    lanes, bool masks) and cast nothing; the ops functions cast."""
    N, K, V, W, B = 2, 8, 3, 4, 4
    values = torch.zeros((N, K, V, W), dtype=torch.int32)
    seqs = torch.zeros((N, K, V), dtype=torch.int32)
    pending = torch.zeros((N, K), dtype=torch.int32)
    keys = torch.zeros((N, B), dtype=torch.int32)
    active = torch.ones((N, B), dtype=torch.bool)
    tail = torch.zeros(N, dtype=torch.bool)
    if bad == "active":
        active = active.int()
    elif bad == "is_tail":
        tail = torch.zeros(N + 1, dtype=torch.bool)
    else:
        keys = keys.long()
    with pytest.raises((TypeError, ValueError)):
        if bad == "active":
            t_kernel.cluster_write_append(
                values, seqs, pending, keys,
                torch.zeros((N, B, W), dtype=torch.int32), keys, active)
        else:
            t_kernel.cluster_read_decide(values, seqs, pending, keys, tail)
    if bad != "is_tail":   # the ops functions cast to the kernels' dtypes
        store = TStore(values, seqs, pending, pending.clone())
        t_ops.cluster_read_batch(store, keys, is_tail=tail)
        t_ops.cluster_write_batch(store, keys,
                                  torch.zeros((N, B, W), dtype=torch.int32),
                                  keys, active)

# ---------------------------------------------------------------------------
# bucketed (partition-map) kernels and the global-key ops
# ---------------------------------------------------------------------------
def _flat_batch(rng, C, K, B, parked):
    """(slots, chains) of a flat batch: duplicates in the first quarter,
    and with ``parked`` chain -1 entries and slots outside ``[0, K)``."""
    slots = rng.integers(0, K, B).astype(np.int32)
    chains = rng.integers(0, C, B).astype(np.int32)
    slots[: B // 4] = rng.integers(0, 3, B // 4)
    chains[: B // 4] = 0
    if parked:
        chains[rng.random(B) < 0.15] = -1
        odd = rng.random(B) < 0.1
        slots[odd] = rng.choice([-2, -1, K, K + 5], int(odd.sum()))
    return slots, chains


@pytest.mark.parametrize("C,K,V,B,parked", [
    (3, 64, 4, 48, False),
    (2, 32, 6, 32, True),      # parked chains and slots outside [0, K)
])
def test_bucketed_read_plain_matches_pallas(C, K, V, B, parked):
    rng = np.random.default_rng(100 + C * K + B)
    values, seqs, pending = _store_arrays(rng, C, K, V, 4, V - 1)
    slots, chains = _flat_batch(rng, C, K, B, parked)
    exp = j_kernel.bucketed_read_engine(
        *[jnp.asarray(a) for a in (values, seqs, pending, slots, chains)],
        tk=min(K, 32), tb=16, interpret=True)
    before = dict(t_kernel.LAUNCHES)
    got = t_kernel.bucketed_read_engine(
        *[_t(a) for a in (values, seqs, pending, slots, chains)])
    for g, e in zip(got, exp):
        _eq(g, e)
    assert t_kernel.LAUNCHES == before  # the CPU path launches nothing


@pytest.mark.parametrize("C,K,V,B,parked", [
    (3, 32, 4, 48, False),     # same-register collisions, window overflow
    (2, 32, 3, 32, True),
])
def test_bucketed_write_plain_matches_pallas(C, K, V, B, parked):
    rng = np.random.default_rng(200 + C * K + B)
    values, seqs, pending = _store_arrays(rng, C, K, V, 4, 1)
    slots, chains = _flat_batch(rng, C, K, B, parked)
    wvals = rng.integers(0, 1 << 20, (B, 4)).astype(np.int32)
    wseqs = rng.integers(0, 1000, B).astype(np.int32)
    active = rng.integers(0, 2, B).astype(np.int32)
    ok = (chains >= 0) & (chains < C) & (slots >= 0) & (slots < K)
    target = np.where(ok, chains * K + slots, -1).astype(np.int32)
    rank = np.asarray(j_batch_rank(jnp.asarray(target),
                                   jnp.asarray(active.astype(bool) & ok)))
    args = (values, seqs, pending, slots, chains, wvals, wseqs, active,
            rank)
    exp = j_kernel.bucketed_write_engine(
        *[jnp.asarray(a) for a in args], tk=min(K, 32), interpret=True)
    got = t_kernel.bucketed_write_engine(*[_t(a) for a in args])
    for g, e in zip(got, exp):
        _eq(g, e)
    assert 0 < int(got[3].sum()) < int(active.sum())
    # the plain version derives the batch order itself: a wrong rank
    # changes nothing
    again = t_kernel.bucketed_write_engine(
        *[_t(a) for a in args[:-1]], torch.zeros(B, dtype=torch.int32))
    for g, e in zip(again, exp):
        _eq(g, e)


def test_bucketed_engines_write_a_replica_slice_in_place():
    """A ``[:, node]`` slice of a ``[C, n, ...]`` store is read and
    written where it lies; the other replicas are untouched."""
    rng = np.random.default_rng(301)
    C, n, K, V, B = 3, 4, 32, 4, 40
    full = [rng.integers(0, 1 << 20, (C, n, K, V, 4)).astype(np.int32),
            rng.integers(-1, 100, (C, n, K, V)).astype(np.int32),
            rng.integers(0, 2, (C, n, K)).astype(np.int32)]
    slots, chains = _flat_batch(rng, C, K, B, True)
    wvals = rng.integers(0, 1 << 20, (B, 4)).astype(np.int32)
    wseqs = rng.integers(0, 1000, B).astype(np.int32)
    active = np.ones(B, np.int32)
    rank = np.zeros(B, np.int32)
    store = [_t(x) for x in full]
    tail = [x[:, -1] for x in store]
    assert not tail[0].is_contiguous()
    got = t_kernel.bucketed_read_engine(*tail, _t(slots), _t(chains))
    exp = t_kernel.bucketed_read_engine(*[x.contiguous() for x in tail],
                                        _t(slots), _t(chains))
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    copy = [x.contiguous() for x in tail]
    t_kernel.bucketed_write_engine(*tail, *map(_t, (slots, chains, wvals,
                                                    wseqs, active, rank)))
    t_kernel.bucketed_write_engine(*copy, *map(_t, (slots, chains, wvals,
                                                    wseqs, active, rank)))
    for x, c, orig in zip(store, copy, full):
        assert torch.equal(x[:, -1], c)
        np.testing.assert_array_equal(x[:, :-1].numpy(), orig[:, :-1])


@pytest.mark.parametrize("bad", ["inner", "overlap", "dtype"])
def test_bucketed_wrappers_reject_bad_layouts(bad):
    """A free chain stride is taken, a non-contiguous row or rows that
    overlap (a broadcast store) are not."""
    C, K, V, W, B = 3, 8, 3, 4, 5
    values = torch.zeros((C, K, V, 2 * W), dtype=torch.int32)[..., :W]
    seqs = torch.zeros((C, K, V), dtype=torch.int32)
    pending = torch.zeros((C, K), dtype=torch.int32)
    if bad != "inner":
        values = values.contiguous()
    if bad == "overlap":
        seqs = torch.zeros((1, K, V), dtype=torch.int32).expand(C, K, V)
    flat = torch.zeros(B, dtype=torch.int32)
    slots = flat.long() if bad == "dtype" else flat
    with pytest.raises((TypeError, ValueError)):
        t_kernel.bucketed_read_engine(values, seqs, pending, slots, flat)
    with pytest.raises((TypeError, ValueError)):
        t_kernel.bucketed_write_engine(
            values, seqs, pending, slots, flat,
            torch.zeros((B, W), dtype=torch.int32), flat, flat, flat)


def _cluster_pair(C=2, K=16, spare=8, bpc=2):
    from repro.core import ChainConfig as JChain
    from repro.core import ClusterConfig as JCluster
    from repro_torch import convert
    jcl = JCluster(chain=JChain(n_nodes=4, num_keys=K, num_versions=4),
                   n_chains=C, buckets_per_chain=bpc, spare_keys=spare)
    return jcl, convert.cluster_from(jcl)


def _maps(jcl):
    """(name, reference map) pairs: the home map, one with bucket 0 moved
    to chain 1's landing region."""
    from repro.core import PartitionMap as JMap
    return [("home", jcl.default_partition()),
            ("migrated", JMap.build([1, 0, 1, 1], [8, 4, 0, 4], 1,
                                    n_chains=2, num_keys=16, bucket_slots=4))]


@pytest.mark.parametrize("which", ["home", "migrated"])
@pytest.mark.parametrize("is_tail", [False, True])
def test_partitioned_ops_match_reference(which, is_tail):
    """The global-key ops equal the reference's on the home map and on a
    migrated one, with duplicates and keys outside the key space (parked
    on chain -1: writes dropped, reads decision -1 with zero payload)."""
    from repro.core.store import init_store as j_init
    from repro.core.types import PartitionMap as JMap
    from repro_torch import convert
    from repro_torch.core.types import PartitionMap as TMap

    jcl, tcl = _cluster_pair()
    jpm = dict(_maps(jcl))[which]
    tpm = convert.from_arrays(TMap, jpm, "cpu")
    assert isinstance(jpm, JMap)
    js = jax.vmap(lambda _: j_init(jcl.chain))(jnp.arange(2))
    ts = TStore(*[_t(x) for x in js])
    gkeys = np.array([0, 0, 2, 3, 5, 7, 9, 15, 16, -1, 1 << 20, 0, 9],
                     np.int32)
    B = gkeys.size
    wvals = np.zeros((B, 4), np.int32)
    wvals[:, 0] = np.arange(1, B + 1) * 10
    wseqs = np.arange(1, B + 1, dtype=np.int32)
    active = np.ones(B, np.int32)
    jnew, jacc = j_ops.partitioned_write_batch(
        jcl, js, jnp.asarray(gkeys), jnp.asarray(wvals), jnp.asarray(wseqs),
        jnp.asarray(active), jpm)
    tnew, tacc = t_ops.partitioned_write_batch(
        tcl, ts, _t(gkeys), _t(wvals), _t(wseqs), _t(active), tpm)
    _eq(tacc, jacc)
    for f in JStore._fields:
        _eq(getattr(tnew, f), getattr(jnew, f))
    exp = j_ops.partitioned_read_batch(jcl, jnew, jnp.asarray(gkeys), jpm,
                                       is_tail=is_tail)
    got = t_ops.partitioned_read_batch(tcl, tnew, _t(gkeys), tpm,
                                       is_tail=is_tail)
    for g, e in zip(got, exp):
        _eq(g, e)
    dec = got[2].numpy()
    assert (dec[8:11] == -1).all() and int(got[0][8:11].abs().sum()) == 0
    assert not tacc[8:11].any()


def test_key_to_chain_answers_keys_outside_the_space_as_reference():
    """With a map, ``key_to_chain``/``key_to_slot`` gather a bucket table:
    for a key whose bucket lies outside it the reference's gather wraps a
    negative index once and clamps the rest, and so does the port."""
    from repro_torch import convert
    from repro_torch.core.types import PartitionMap as TMap

    jcl, tcl = _cluster_pair()
    keys = np.array([-40, -17, -1, 0, 15, 16, 17, 40, 1 << 20], np.int32)
    for _, jpm in _maps(jcl):
        tpm = convert.from_arrays(TMap, jpm, "cpu")
        for jf, tf in ((jcl.key_to_chain, tcl.key_to_chain),
                       (jcl.key_to_slot, tcl.key_to_slot),
                       (jcl.local_key, tcl.local_key)):
            _eq(tf(_t(keys), tpm), jf(jnp.asarray(keys), jpm))
    for b in range(jcl.num_buckets):
        assert tcl.bucket_home(b) == jcl.bucket_home(b)
