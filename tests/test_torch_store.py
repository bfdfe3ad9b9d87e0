"""Parity of the PyTorch port's types, store and reply log with the JAX
package, on seeded numpy inputs.  Every leaf is int32 (bool for flags),
so every comparison is exact equality."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import metrics as j_metrics  # noqa: E402
from repro.core import store as j_store  # noqa: E402
from repro.core import types as j_types  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import metrics as t_metrics  # noqa: E402
from repro_torch.core import store as t_store  # noqa: E402
from repro_torch.core import types as t_types  # noqa: E402

CPU = "cpu"


def _eq(got, exp):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    exp = np.asarray(exp)
    assert got.dtype == exp.dtype, (got.dtype, exp.dtype)
    np.testing.assert_array_equal(got, exp)


def _t(x):
    return torch.from_numpy(np.array(x))


def _random_store(rng, N, K, V, W, max_pending=None):
    """A store with dirty versions in increasing seq order per key."""
    max_pending = V - 1 if max_pending is None else max_pending
    pending = rng.integers(0, max_pending + 1, (N, K)).astype(np.int32)
    seqs = np.full((N, K, V), -1, np.int32)
    base = rng.integers(0, 20, (N, K)).astype(np.int32)
    seqs[:, :, 0] = base
    for c in range(1, V):
        seqs[:, :, c] = np.where(c <= pending, base + 2 * c, -1)
    values = rng.integers(0, 1 << 20, (N, K, V, W)).astype(np.int32)
    next_seq = (base + 2 * V + 1).astype(np.int32)
    return values, seqs, pending, next_seq


def _keys(rng, shape, hi, K, oob=False):
    """Keys in ``[0, hi)``; with ``oob`` about a quarter are replaced by
    keys outside ``[0, K)``: -1 and -2 (the reference wraps them once),
    -K - 1 (still negative after the wrap), K and K + 3."""
    keys = rng.integers(0, hi, shape).astype(np.int32)
    if oob:
        odd = np.array([-1, -2, -K - 1, K, K + 3], np.int32)
        swap = rng.random(shape) < 0.25
        keys = np.where(swap, rng.choice(odd, shape), keys).astype(np.int32)
    return keys


def _clamped(keys, K):
    """The reference gather's index: wrap once, then clamp."""
    return np.clip(np.where(keys < 0, keys + K, keys), 0, K - 1)


def _stores(arrs):
    j = j_store.Store(*[jnp.asarray(a) for a in arrs])
    t = t_store.Store(*[_t(a) for a in arrs])
    return j, t


def _vj(fn, *args):
    """The reference's per-node store function vmapped over the node axis."""
    return jax.vmap(fn)(*args)


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------
def test_constants_match_reference():
    names = [n for n in dir(j_types)
             if n.isupper() and isinstance(getattr(j_types, n), int)]
    ported = [n for n in names if hasattr(t_types, n)]
    for name in ported:
        assert getattr(t_types, name) == getattr(j_types, name), name
    assert {n for n in names if n.startswith("OP_")} <= set(ported)
    for name in ("VALUE_WORDS", "CLIENT_BASE", "WAVE_BASE", "LEASE_OFF",
                 "NOWHERE", "MULTICAST", "TO_CLIENT",
                 "NETCRAQ_HEADER_BYTES"):
        assert name in ported, name
    assert t_types.OP_NAMES == j_types.OP_NAMES
    assert list(t_types.Msg._fields) == list(j_types.Msg._fields)
    assert list(t_types.Roles._fields) == list(j_types.Roles._fields)
    assert list(t_types.PartitionMap._fields) == list(
        j_types.PartitionMap._fields)
    for n in (2, 4, 7):
        assert (t_types.netchain_header_bytes(n)
                == j_types.netchain_header_bytes(n))


def test_msg_empty_mask_concat_match_reference():
    rng = np.random.default_rng(1)
    j_msg = j_types.Msg.empty(12, 4)
    t_msg = t_types.Msg.empty(12, 4, device=CPU)
    for f in j_types.Msg._fields:
        _eq(getattr(t_msg, f), getattr(j_msg, f))
    fields = {f: rng.integers(-3, 50, (12,) + ((4,) if f == "value" else ()))
              .astype(np.int32) for f in j_types.Msg._fields}
    keep = rng.integers(0, 2, 12).astype(bool)
    j_m = j_types.Msg(**{k: jnp.asarray(v) for k, v in fields.items()})
    t_m = convert.from_arrays(t_types.Msg, j_m, CPU)
    jm, tm = j_m.mask(jnp.asarray(keep)), t_m.mask(torch.from_numpy(keep))
    for f in j_types.Msg._fields:
        _eq(getattr(tm, f), getattr(jm, f))
    _eq(tm.live(), jm.live())
    jc = j_types.Msg.concat([jm, j_m])
    tc = t_types.Msg.concat([tm, t_m])
    for f in j_types.Msg._fields:
        _eq(getattr(tc, f), getattr(jc, f))


@pytest.mark.parametrize("C,K,bpc,spare", [(2, 64, 1, 0), (3, 32, 4, 8)])
def test_cluster_config_and_partition_map_match_reference(C, K, bpc, spare):
    jc = j_types.ClusterConfig(chain=j_types.ChainConfig(num_keys=K),
                               n_chains=C, buckets_per_chain=bpc,
                               spare_keys=spare)
    tc = t_types.ClusterConfig(chain=t_types.ChainConfig(num_keys=K),
                               n_chains=C, buckets_per_chain=bpc,
                               spare_keys=spare)
    jp, tp = jc.default_partition(), tc.default_partition(device=CPU)
    for f in j_types.PartitionMap._fields:
        _eq(getattr(tp, f), getattr(jp, f))
    g = np.arange(jc.num_global_keys, dtype=np.int32)
    for pmap_j, pmap_t in ((None, None), (jp, tp)):
        _eq(tc.key_to_chain(_t(g), pmap_t).to(torch.int32),
            jc.key_to_chain(jnp.asarray(g), pmap_j))
        _eq(tc.key_to_slot(_t(g), pmap_t).to(torch.int32),
            jc.key_to_slot(jnp.asarray(g), pmap_j))
    loc = np.repeat(np.arange(K, dtype=np.int32), C)
    ch = np.tile(np.arange(C, dtype=np.int32), K)
    _eq(tc.global_key(_t(loc), _t(ch), tp).to(torch.int32),
        jc.global_key(jnp.asarray(loc), jnp.asarray(ch), jp))
    # a moved bucket: rebuild both maps from the same primary columns
    owner = np.roll(np.asarray(jp.owner), 1)
    base = np.asarray(jp.base)
    jm = j_types.PartitionMap.build(owner, base, 3, n_chains=C, num_keys=K,
                                    bucket_slots=jc.bucket_slots)
    tm = t_types.PartitionMap.build(owner, base, 3, n_chains=C, num_keys=K,
                                    bucket_slots=tc.bucket_slots, device=CPU)
    for f in j_types.PartitionMap._fields:
        _eq(getattr(tm, f), getattr(jm, f))


@pytest.mark.parametrize("n,ids,frozen", [
    (4, [0, 1, 2, 3], False), (4, [0, 2, 3], False), (5, [4, 1, 0], True)])
def test_roles_from_membership_match_reference(n, ids, frozen):
    jr = j_types.Roles.from_membership(n, ids, frozen=frozen)
    tr = t_types.Roles.from_membership(n, ids, frozen=frozen, device=CPU)
    for f in j_types.Roles._fields:
        _eq(getattr(tr, f), getattr(jr, f))
    _eq(tr.is_tail, jr.is_tail)
    _eq(tr.is_head, jr.is_head)


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,B,key_space", [(0, 16, 4), (1, 64, 64),
                                              (2, 128, 3)])
def test_batch_rank_sort_and_dense_match_reference(seed, B, key_space):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-2, key_space, (3, B)).astype(np.int32)
    active = rng.integers(0, 2, (3, B)).astype(bool)
    exp = _vj(j_store.batch_rank, jnp.asarray(keys), jnp.asarray(active))
    sort = t_store.batch_rank(_t(keys), _t(active))
    dense = t_store.batch_rank(_t(keys), _t(active), dense=True)
    _eq(sort, exp)
    _eq(dense, exp)


def test_init_store_matches_reference():
    cfg_j = j_types.ChainConfig(num_keys=32, num_versions=5)
    cfg_t = t_types.ChainConfig(num_keys=32, num_versions=5)
    js = j_store.init_store(cfg_j)
    ts = t_store.init_store(cfg_t, (2, 3), device=CPU)
    for f in j_store.Store._fields:
        got = getattr(ts, f)
        assert got.shape[:2] == (2, 3)
        _eq(got[1, 2], getattr(js, f))


@pytest.mark.parametrize("seed,oob", [(0, False), (1, False), (2, True)])
def test_reads_and_counts_match_reference(seed, oob):
    rng = np.random.default_rng(seed)
    N, K, V, W, B = 3, 32, 5, 4, 40
    js, ts = _stores(_random_store(rng, N, K, V, W))
    keys = _keys(rng, (N, B), K, K, oob)
    jk, tk = jnp.asarray(keys), _t(keys)
    for fn in ("read_clean", "read_latest"):
        for g, e in zip(getattr(t_store, fn)(ts, tk),
                        _vj(getattr(j_store, fn), js, jk)):
            _eq(g, e)
    _eq(t_store.is_clean(ts, tk), _vj(j_store.is_clean, js, jk))
    active = rng.integers(0, 2, (N, B)).astype(bool)
    _eq(t_store.per_key_count(tk, _t(active), K),
        jax.vmap(lambda k, a: j_store.per_key_count(k, a, K))(
            jk, jnp.asarray(active)))


@pytest.mark.parametrize("seed,key_space,dense,oob", [
    (0, 4, False, False),   # duplicate keys in a batch, window overflow
    (1, 32, False, False),
    (2, 3, True, False),
    (3, 4, False, True),    # keys the reference wraps, clamps or drops
])
def test_assign_seqs_and_append_dirty_match_reference(seed, key_space,
                                                      dense, oob):
    rng = np.random.default_rng(seed)
    N, K, V, W, B = 3, 32, 4, 4, 24
    arrs = _random_store(rng, N, K, V, W, max_pending=1)
    js, ts = _stores(arrs)
    keys = _keys(rng, (N, B), key_space, K, oob)
    needs = rng.integers(0, 2, (N, B)).astype(bool)
    jk, tk = jnp.asarray(keys), _t(keys)
    js2, jseq = jax.vmap(
        lambda s, k, a: j_store.assign_seqs(s, k, a, dense_rank=dense)
    )(js, jk, jnp.asarray(needs))
    ts2, tseq = t_store.assign_seqs(ts, tk, _t(needs), dense_rank=dense)
    _eq(tseq, jseq)
    _eq(ts2.next_seq, js2.next_seq)

    vals = rng.integers(0, 1 << 20, (N, B, W)).astype(np.int32)
    active = rng.integers(0, 2, (N, B)).astype(bool)
    js3, jacc = jax.vmap(
        lambda s, k, v, q, a: j_store.append_dirty(s, k, v, q, a,
                                                   dense_rank=dense)
    )(js2, jk, jnp.asarray(vals), jseq, jnp.asarray(active))
    ts3, tacc = t_store.append_dirty(ts2, tk, _t(vals), tseq, _t(active),
                                     dense_rank=dense)
    _eq(tacc, jacc)
    assert int(tacc.sum()) < int(active.sum())  # the window overflowed
    for f in j_store.Store._fields:
        _eq(getattr(ts3, f), getattr(js3, f))


@pytest.mark.parametrize("seed,mode,oob", [
    (0, "in_order", False), (1, "out_of_order", False),
    (2, "cumulative", False), (3, "stale", False), (4, "out_of_order", True),
])
def test_commit_matches_reference(seed, mode, oob):
    """ACKs applied in order, out of order, several per key in one batch
    (only the largest seq commits), stale ACKs below cell 0, and ACKs of
    keys outside ``[0, K)``."""
    rng = np.random.default_rng(seed)
    N, K, V, W, B = 2, 16, 5, 4, 20
    arrs = _random_store(rng, N, K, V, W)
    js, ts = _stores(arrs)
    values, seqs, pending, _ = arrs
    keys = _keys(rng, (N, B), K, K, oob)
    kc = _clamped(keys, K)
    cell = rng.integers(1, V, (N, B))
    if mode == "in_order":
        cell = np.ones_like(cell)
    ack = np.take_along_axis(
        seqs.reshape(N, K * V), kc * V + cell, axis=1).astype(np.int32)
    if mode == "cumulative":
        ack = ack + rng.integers(0, 3, (N, B)).astype(np.int32)
    if mode == "stale":
        ack = (seqs[np.arange(N)[:, None], kc, 0]
               - rng.integers(0, 3, (N, B))).astype(np.int32)
    active = rng.integers(0, 2, (N, B)).astype(bool)
    wvals = rng.integers(0, 1 << 20, (N, B, W)).astype(np.int32)
    jout = jax.vmap(j_store.commit)(js, jnp.asarray(keys),
                                    jnp.asarray(wvals), jnp.asarray(ack),
                                    jnp.asarray(active))
    tout = t_store.commit(ts, _t(keys), _t(wvals), _t(ack), _t(active))
    for f in j_store.Store._fields:
        _eq(getattr(tout, f), getattr(jout, f))


@pytest.mark.parametrize("seed,oob", [(0, False), (1, False), (2, True)])
def test_overwrite_clean_matches_reference(seed, oob):
    rng = np.random.default_rng(seed)
    N, K, V, W, B = 2, 8, 2, 4, 24
    js, ts = _stores(_random_store(rng, N, K, V, W, max_pending=0))
    keys = _keys(rng, (N, B), K, K, oob)
    seqs = rng.integers(0, 40, (N, B)).astype(np.int32)
    vals = rng.integers(0, 1 << 20, (N, B, W)).astype(np.int32)
    active = rng.integers(0, 2, (N, B)).astype(bool)
    jout = jax.vmap(j_store.overwrite_clean)(
        js, jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(seqs),
        jnp.asarray(active))
    tout = t_store.overwrite_clean(ts, _t(keys), _t(vals), _t(seqs),
                                   _t(active))
    for f in j_store.Store._fields:
        _eq(getattr(tout, f), getattr(jout, f))


# ---------------------------------------------------------------------------
# reply log
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dense", [False, True])
def test_reply_log_append_matches_reference(dense):
    """Two appends per chain, the second overflowing the log."""
    rng = np.random.default_rng(5)
    C, M, R = 2, 24, 30
    jlog = jax.vmap(lambda _: j_metrics.ReplyLog.empty(R))(jnp.arange(C))
    tlog = t_metrics.ReplyLog.empty(R, C, device=CPU)
    for step in range(2):
        fields = {f: rng.integers(0, 50, (C, M) + ((4,) if f == "value"
                                                   else ()))
                  .astype(np.int32) for f in j_types.Msg._fields}
        live = rng.random((C, M)) < 0.7
        jm = jax.vmap(j_types.Msg.mask)(
            j_types.Msg(**{k: jnp.asarray(v) for k, v in fields.items()}),
            jnp.asarray(live))
        tm = convert.from_arrays(t_types.Msg, jm, CPU)
        jlog = jax.vmap(lambda lg, m: lg.append(m, 7 + step, dense=dense))(
            jlog, jm)
        tlog = tlog.append(tm, 7 + step, dense=dense)
        for f in j_metrics.ReplyLog._fields:
            _eq(getattr(tlog, f), getattr(jlog, f))
    assert int(tlog.lost.sum()) > 0
    jmerged, tmerged = jlog.merged(), tlog.merged()
    for f in j_metrics.ReplyLog._fields:
        np.testing.assert_array_equal(getattr(tmerged, f),
                                      getattr(jmerged, f))


def test_metrics_total_and_asdict_match_reference():
    rng = np.random.default_rng(3)
    C, G = 3, 5
    vals = [rng.integers(0, 100, C).astype(np.int32) for _ in range(24)]
    heat = rng.integers(0, 9, (C, G)).astype(np.int32)
    jm = j_metrics.Metrics(*[jnp.asarray(v) for v in vals],
                           conflict_heat=jnp.asarray(heat))
    tm = convert.from_arrays(t_metrics.Metrics, jm, CPU)
    assert tm.asdict() == jm.asdict()
    for g, e in zip(tm.total(), jm.total()):
        _eq(g, e)
    z = t_metrics.Metrics.zeros(C, G, device=CPU)
    assert all(int(v.sum()) == 0 for v in z)
    assert z.conflict_heat.shape == (C, G)


@contextlib.contextmanager
def _first_write_wins():
    """Make ``tensor[i, j, ...] = v`` with repeated index tuples keep the
    FIRST write, one of the orders a CUDA scatter may pick (the CPU's
    serial one keeps the last): the port must not lean on either."""
    orig = torch.Tensor.__setitem__

    def setitem(self, idx, val):
        if (isinstance(idx, tuple) and isinstance(val, torch.Tensor)
                and any(isinstance(i, torch.Tensor) for i in idx)
                and all(isinstance(i, (int, torch.Tensor)) for i in idx)):
            parts = torch.broadcast_tensors(*[torch.as_tensor(i)
                                              for i in idx])
            tail = self.shape[len(idx):]
            vals = val.expand(parts[0].shape + tail).reshape((-1,) + tail)
            rev = torch.arange(vals.shape[0] - 1, -1, -1)
            return orig(self, tuple(p.reshape(-1)[rev] for p in parts),
                        vals[rev])
        return orig(self, idx, val)

    torch.Tensor.__setitem__ = setitem
    try:
        yield
    finally:
        torch.Tensor.__setitem__ = orig


_TIED = {}


def _tied_reference(fn_name):
    if fn_name not in _TIED:
        _TIED[fn_name] = jax.jit(jax.vmap(getattr(j_store, fn_name)))
    return _TIED[fn_name]


@pytest.mark.parametrize("fn_name", ["commit", "overwrite_clean"])
@pytest.mark.parametrize("order", ["serial", "first_write_wins"])
@pytest.mark.parametrize("seed", [0, 1])
def test_tied_winners_keep_the_later_write(fn_name, order, seed):
    """Raw keys -1 and K - 1 name one register, so two writes of one batch
    can tie as its winners (equal seqs): the later stays, as in the
    reference's serial scatter, whatever order the scatter applies."""
    rng = np.random.default_rng(40 + seed)
    N, K, V, W, B = 3, 8, 4, 4, 24
    arrs = list(_random_store(rng, N, K, V, W, max_pending=0))
    arrs[1][:, :, 0] = 0                      # every seq below is newer
    js, ts = _stores(arrs)
    keys = rng.choice(np.array([-1, K - 1, 0, 2], np.int32), (N, B))
    keys[:, :2] = [-1, K - 1]                 # at least one tie a row
    seqs = rng.integers(1, 3, (N, B)).astype(np.int32)
    seqs[:, :2] = 9
    vals = rng.integers(0, 1 << 20, (N, B, W)).astype(np.int32)
    active = rng.random((N, B)) < 0.8
    active[:, :2] = True
    jout = _tied_reference(fn_name)(
        js, jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(seqs),
        jnp.asarray(active))
    assert int(jout.values[0, K - 1, 0, 0]) == vals[0, 1, 0]
    ctx = (_first_write_wins() if order == "first_write_wins"
           else contextlib.nullcontext())
    with ctx:
        tout = getattr(t_store, fn_name)(ts, _t(keys), _t(vals), _t(seqs),
                                         _t(active))
    for f in j_store.Store._fields:
        _eq(getattr(tout, f), getattr(jout, f))
