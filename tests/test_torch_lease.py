"""Lock leases on the port (``txn.lease_expiry_stage``, the lock table's
lease leaves), in the torch form of ``tests/test_lease.py``'s five
behaviours.  Each drives the port's engine and the reference's with the
same hand-placed injections and holds the final states equal, every
leaf (stores, inbox, locks, metrics, reply log, telemetry, tick):

* a grant stamps the lease with its tick and a release clears it;
* expiry reclaims the lock (version bumped, ``lease_expiries`` counted)
  and the key can be granted again;
* a COMMIT arriving after its lock expired is NACKed and never applied;
* ``LEASE_OFF`` is bit-identical to a lease that never fires;
* ``set_lease`` is a leaf edit: no new kernel library, and no host read
  (it runs on meta tensors, which have no data to read).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import types as j_types  # noqa: E402
from repro.core.chain import ChainSim as JSim  # noqa: E402
from repro.core.txn import set_lease as j_set_lease  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import txn as t_txn  # noqa: E402
from repro_torch.core import types as t_types  # noqa: E402
from repro_torch.core.chain import ChainSim as TSim  # noqa: E402
from repro_torch.core.types import (  # noqa: E402
    CLIENT_BASE, LEASE_OFF, OP_ABORT, OP_COMMIT, OP_PREPARE, OP_PREPARE_ACK,
    OP_TXN_REPLY, Msg)
from repro_torch.kernels import build  # noqa: E402
from torch_parity import CPU, assert_states_equal  # noqa: E402

# tests/helpers.py's prop_engine: 2 chains of 3 nodes, 4 keys, 8 versions
CHAIN = dict(n_nodes=3, num_keys=4, num_versions=8)
SIM = dict(inject_capacity=16, route_capacity=96, reply_capacity=512)


@pytest.fixture(scope="module")
def engines():
    jcl = j_types.ClusterConfig(chain=j_types.ChainConfig(**CHAIN),
                                n_chains=2)
    tcl = t_types.ClusterConfig(chain=t_types.ChainConfig(**CHAIN),
                                n_chains=2)
    return JSim(jcl, **SIM), TSim(tcl, device=CPU, **SIM)


class Twin:
    """The two engines driven side by side through the same ops."""

    def __init__(self, engines, lease=None):
        self.jsim, self.tsim = engines
        self.j, self.t = self.jsim.init_state(), self.tsim.init_state()
        if lease is not None:
            self.set_lease(lease)

    def set_lease(self, lease):
        self.j = self.j._replace(locks=j_set_lease(self.j.locks, lease))
        self.t = self.t._replace(locks=t_txn.set_lease(self.t.locks, lease))

    def inject(self, op, local_key, val, txn_id, chain, qid):
        """One client op at chain ``chain``'s head lane 0, then a tick."""
        m = Msg.empty(self.jsim.empty_injection().op.shape,
                      self.tsim.cfg.value_words, device=CPU)
        at = (chain, 0, 0)
        m.op[at], m.key[at], m.seq[at], m.qid[at] = op, local_key, txn_id, qid
        m.value[at + (0,)] = val
        m.src[at] = m.client[at] = CLIENT_BASE + 1
        m.dst[at] = 0
        jm = j_types.Msg(*[jax.numpy.asarray(x.numpy()) for x in m])
        self.j = self.jsim.tick(self.j, jm)
        self.t = self.tsim.tick(self.t, m)

    def drain(self, ticks):
        for _ in range(ticks):
            self.j = self.jsim.tick(self.j, self.jsim.empty_injection())
        self.t = self.tsim.drain(self.t, ticks)

    def check(self, where):
        assert_states_equal(self.j, self.t, where)
        return self.t


def _replies(state):
    r = state.replies.merged()
    return {int(q): (int(op), int(s), int(v))
            for q, op, s, v in zip(r.qid, r.op, r.seq, r.value0)}


def test_grant_stamps_lease_and_release_clears_it(engines):
    tw = Twin(engines)
    t0 = int(tw.t.t)
    tw.inject(OP_PREPARE, 2, 0, 7, 0, qid=1)
    s = tw.check("grant")
    assert int(s.locks.holder[0, 2]) == 7
    assert int(s.locks.lease[0, 2]) == t0
    assert int(s.locks.lease_ticks[0]) == LEASE_OFF
    tw.inject(OP_ABORT, 2, 0, 7, 0, qid=2)
    s = tw.check("release")
    assert int(s.locks.holder[0, 2]) == -1
    assert int(s.locks.lease[0, 2]) == -1


def test_expiry_reclaims_counts_and_key_is_regrantable(engines):
    tw = Twin(engines, lease=3)
    tw.inject(OP_PREPARE, 1, 0, 7, 0, qid=1)
    assert int(tw.t.locks.holder[0, 1]) == 7
    tw.drain(6)
    s = tw.check("expired")
    assert t_txn.locks_all_free(s.locks)
    assert int(s.locks.version[0, 1]) == 1
    assert s.metrics.asdict()["lease_expiries"] == 1
    tw.inject(OP_PREPARE, 1, 0, 8, 0, qid=2)
    tw.drain(2)
    recs = _replies(tw.check("regranted"))
    assert recs[2][0] == OP_PREPARE_ACK and recs[2][1] == 1


def test_straggler_commit_after_expiry_is_nacked_never_applied(engines):
    tw = Twin(engines, lease=3)
    tw.inject(OP_PREPARE, 0, 0, 9, 1, qid=1)
    tw.drain(6)
    tw.inject(OP_COMMIT, 0, 42, 9, 1, qid=2)
    tw.drain(6)
    s = tw.check("straggler")
    assert _replies(s)[2] == (OP_TXN_REPLY, -1, 0)
    assert int(s.stores.values[1, :, 0].sum()) == 0
    m = s.metrics.asdict()
    assert m["txn_commits"] == 0 and m["lease_expiries"] == 1


def test_lease_off_bit_identical_to_finite_lease_that_never_fires(engines):
    def run(lease):
        tw = Twin(engines, lease=lease)
        tw.inject(OP_PREPARE, 3, 0, 5, 0, qid=1)
        tw.inject(OP_PREPARE, 2, 0, 6, 0, qid=2)
        tw.inject(OP_COMMIT, 2, 17, 6, 0, qid=3)
        tw.drain(10)                     # txn 5 stays abandoned
        return tw.check(f"lease {lease}")

    off, finite = run(None), run(1000)
    assert int(off.locks.holder[0, 3]) == 5
    assert off.metrics.asdict()["lease_expiries"] == 0
    assert finite.metrics.asdict()["lease_expiries"] == 0
    norm = lambda s: convert.to_numpy(s._replace(
        locks=t_txn.set_lease(s.locks, 0)))
    a, b = norm(off), norm(finite)
    for f in a._fields:
        for x, y in zip(jax.tree.leaves(getattr(a, f)),
                        jax.tree.leaves(getattr(b, f))):
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_set_lease_is_a_leaf_edit(engines):
    tw = Twin(engines)
    tw.drain(1)                          # warm-up
    libs = build.loaded_libraries()
    tw.set_lease(7)
    tw.inject(OP_PREPARE, 0, 0, 3, 0, qid=1)
    tw.drain(9)                          # grant, then expire
    s = tw.check("leaf edit")
    assert t_txn.locks_all_free(s.locks)
    assert s.metrics.asdict()["lease_expiries"] == 1
    assert build.loaded_libraries() == libs
    # no host read: meta tensors carry no data, and a read of one raises
    meta = t_txn.LockTable(*[torch.empty_like(x, device="meta")
                             for x in s.locks])
    out = t_txn.set_lease(meta, torch.full((), 5, dtype=torch.int32,
                                           device="meta"))
    assert out.lease_ticks.device.type == "meta"
    assert out.lease_ticks.shape == s.locks.lease_ticks.shape
    with pytest.raises(Exception):
        int(meta.holder.sum())
