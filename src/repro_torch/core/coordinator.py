"""Control plane (CP) - the port of ``repro/core/coordinator.py``.

Host-side Python that owns chain membership, the role table, the
versioned partition map and the two-phase failure recovery (paper
§III.B-C).  Per-query work never runs here: the CP edits the small
role/map tables the data plane reads, and between ticks copies register
slices for a recovery or a bucket migration.

In place: the reference's ``complete_rebalance`` and
``complete_recovery`` return new stores and leave the caller's alone.
Here they copy the register slices inside the given state's tensors (a
migration or a recovery moves a few slices of a store that may hold
hundreds of MiB), and say so: the state passed in is the state to use
next, so a twin run must start from its own ``init_state()``, never from
an alias of another run's state.  Every copy reads its source region
before that region is reset.

Guard rails raise ``AssertionError`` with the reference's messages, also
under ``python -O``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import store as store_lib
from repro_torch.core import txn as txn_lib
from repro_torch.core.failure import FailureDetector
from repro_torch.core.store import Store
from repro_torch.core.types import (
    I32,
    ChainConfig,
    ClusterConfig,
    PartitionMap,
    Roles,
    resolve_device,
    tree_map,
)


@dataclasses.dataclass
class ChainMembership:
    """CP's view of one chain: an ordered list of live node ids."""

    node_ids: list[int]                  # chain order: head .. tail
    epoch: int = 0                       # bumped on every reconfiguration
    writes_frozen: bool = False          # recovery phase 2 freezes writes

    @property
    def head(self) -> int:
        return self.node_ids[0]

    @property
    def tail(self) -> int:
        return self.node_ids[-1]

    @property
    def length(self) -> int:
        return len(self.node_ids)

    def position_of(self, node_id: int) -> int:
        return self.node_ids.index(node_id)


@dataclasses.dataclass
class FailoverPolicy:
    """Client-side immediate redirection (recovery phase 1, paper §III.C):
    after ``timeout_ticks`` unanswered ticks a client re-targets another
    live node."""

    timeout_ticks: int = 8

    def redirect(self, membership: ChainMembership, dead: int,
                 client: int = 0, key: int = 0) -> int:
        """The live node a client re-targets after ``dead`` times out: a
        deterministic hash of (client, key) over the live set, so one
        client re-targets stably while the population spreads."""
        live = [i for i in membership.node_ids if i != dead]
        # mix both words and fold the high bits down: a linear combination
        # alone leaks divisibility onto small live sets
        h = (client * 2654435761 + key * 2246822519 + 0x9E3779B9) & 0xFFFFFFFF
        h ^= h >> 16
        return live[h % len(live)]


class Coordinator:
    """Owns membership, roles, the partition map and recovery for a set of
    chains.  Tables it publishes (``roles_table``, ``partition_map``) are
    built on ``device``."""

    def __init__(self, cfg: ChainConfig | ClusterConfig,
                 n_chains: int | None = None, device="cuda"):
        if isinstance(cfg, ClusterConfig):
            if n_chains is not None and n_chains != cfg.n_chains:
                raise AssertionError(
                    f"n_chains={n_chains} disagrees with the cluster's "
                    f"{cfg.n_chains}")
            self.cluster = cfg
        else:
            self.cluster = ClusterConfig(chain=cfg, n_chains=n_chains or 1)
        self.cfg = self.cluster.chain
        self.device = resolve_device(device)
        self.chains = [
            ChainMembership(node_ids=list(range(self.cfg.n_nodes)))
            for _ in range(self.cluster.n_chains)
        ]
        self.failover = FailoverPolicy()
        # one responsiveness tracker per chain, kept in sync with the
        # membership by fail/recover
        self.detectors = [
            FailureDetector(n_nodes=self.cfg.n_nodes)
            for _ in range(self.cluster.n_chains)
        ]
        self._recovery_log: list[dict] = []
        self._txn_planner: Optional[txn_lib.TxnPlanner] = None
        # the authoritative partition state the published map comes from
        cl = self.cluster
        homes = [cl.bucket_home(b) for b in range(cl.num_buckets)]
        self._p_owner = [c for c, _ in homes]
        self._p_base = [s for _, s in homes]
        self._p_epoch = 0
        self._p_slot_epoch = np.zeros((cl.n_chains, self.cfg.num_keys),
                                      np.int32)
        # free bucket-sized landing regions per chain, in the spare tail
        n_spare = cl.spare_keys // cl.bucket_slots
        self._p_free = {
            c: [cl.keys_in_use + i * cl.bucket_slots for i in range(n_spare)]
            for c in range(cl.n_chains)
        }
        self._pending_move: Optional[tuple] = None

    # -- key partitioning ---------------------------------------------------
    def key_to_chain(self, key: int) -> int:
        self._check_key(key)
        return self._p_owner[int(self.cluster.bucket_of(key))]

    def local_key(self, key: int) -> int:
        self._check_key(key)
        cl = self.cluster
        b = int(cl.bucket_of(key))
        return self._p_base[b] + (int(key) // cl.n_chains) % cl.bucket_slots

    def _check_key(self, key: int) -> None:
        # with spare registers the bucket arithmetic is not total: a key
        # outside the space would alias onto a real bucket
        if not 0 <= int(key) < self.cluster.num_global_keys:
            raise AssertionError(
                f"global key {key} outside the key space "
                f"0..{self.cluster.num_global_keys - 1}")

    @property
    def partition_epoch(self) -> int:
        return self._p_epoch

    def bucket_placement(self, bucket: int) -> tuple:
        """(owning chain, base register slot) of a bucket right now."""
        return self._p_owner[bucket], self._p_base[bucket]

    # -- transactions ---------------------------------------------------------
    @property
    def txn_planner(self) -> txn_lib.TxnPlanner:
        """The multi-key transaction planner over this control plane's
        live map: it splits keys with the current placement and stamps
        the current epoch into every sub-op (built once, on ``device``)."""
        if self._txn_planner is None:
            self._txn_planner = txn_lib.TxnPlanner(self.cluster,
                                                   coordinator=self)
        return self._txn_planner

    @staticmethod
    def waves_drained(state, chain_idx: Optional[int] = None) -> bool:
        """True when every wave-table coordinator slot (on ``chain_idx``
        or anywhere) is FREE; a wave-less engine is trivially drained."""
        ph = state.wave.phase
        if chain_idx is not None:
            ph = ph[chain_idx]
        return bool((ph == txn_lib.WAVE_FREE).all())

    @staticmethod
    def locks_drained(state, chain_idx: Optional[int] = None) -> bool:
        """True when no transaction holds a lock (on ``chain_idx`` or
        anywhere): the recovery copy waits for this."""
        locks = state.locks
        if chain_idx is not None:
            locks = tree_map(lambda x: x[chain_idx], locks)
        return txn_lib.locks_all_free(locks)

    @staticmethod
    def leaked_locks(state, chain_idx: Optional[int] = None) -> int:
        """How many locks are held right now (on ``chain_idx`` or
        anywhere)."""
        locks = state.locks
        if chain_idx is not None:
            locks = tree_map(lambda x: x[chain_idx], locks)
        return txn_lib.held_locks(locks)

    @staticmethod
    def set_lease(state, lease_ticks):
        """Publish a new lock-lease bound into a running state."""
        return state._replace(locks=txn_lib.set_lease(state.locks,
                                                      lease_ticks))

    # -- data-plane role table ------------------------------------------------
    def roles_table(self) -> Roles:
        """[C, n] live role table reflecting the current membership (same
        shapes and dtypes whatever the membership)."""
        tables = [
            Roles.from_membership(self.cfg.n_nodes, m.node_ids,
                                  frozen=m.writes_frozen, device=self.device)
            for m in self.chains
        ]
        return tree_map(lambda *xs: torch.stack(xs), *tables)

    def install_roles(self, state):
        """Publish the current membership into a running state."""
        return state._replace(roles=self.roles_table())

    # -- data-plane partition map ---------------------------------------------
    def partition_map(self) -> PartitionMap:
        """The published ``PartitionMap`` of the current bucket placement."""
        cl = self.cluster
        return PartitionMap.build(
            owner=self._p_owner,
            base=self._p_base,
            epoch=self._p_epoch,
            n_chains=cl.n_chains,
            num_keys=self.cfg.num_keys,
            bucket_slots=cl.bucket_slots,
            slot_epoch=self._p_slot_epoch,
            device=self.device,
        )

    def install_partition(self, state):
        """Publish the current partition map into a running state."""
        return state._replace(pmap=self.partition_map())

    # -- live key-range rebalancing (freeze -> drain -> copy -> publish) ------
    def begin_rebalance(self, bucket: int, dst_chain: int):
        """Open a bucket migration: freeze the source chain's writes and
        reserve a landing region on the destination.  Publish the freeze
        with ``install_roles(state)``, then tick until the source chain
        drains before ``complete_rebalance``.  One migration at a time.
        Returns ``(src_chain, dst_chain)``."""
        cl = self.cluster
        if self._pending_move is not None:
            raise AssertionError(
                f"migration of bucket {self._pending_move[0]} still open - "
                "complete_rebalance it first")
        if not 0 <= bucket < cl.num_buckets:
            raise AssertionError(f"no bucket {bucket}")
        src = self._p_owner[bucket]
        if dst_chain == src:
            raise AssertionError(
                f"bucket {bucket} already lives on chain {dst_chain}")
        if not 0 <= dst_chain < cl.n_chains:
            raise AssertionError(f"no chain {dst_chain}")
        if not self._p_free[dst_chain]:
            raise AssertionError(
                f"chain {dst_chain} has no free landing region (size the "
                "cluster with spare_keys >= bucket_slots per expected "
                "in-migration)")
        # recovery and migration share the chain-wide freeze flag: the
        # first to complete would unfreeze the other's open window
        if self.chains[src].writes_frozen:
            raise AssertionError(
                f"chain {src} is already frozen by another recovery/"
                "migration window - complete it before opening a new one")
        self.chains[src].writes_frozen = True
        self._pending_move = (bucket, src, dst_chain,
                              self._p_free[dst_chain][0])
        self._recovery_log.append(
            {"event": "rebalance_begin", "bucket": bucket, "src": src,
             "dst": dst_chain, "epoch": self._p_epoch, "t": time.time()})
        return src, dst_chain

    def complete_rebalance(self, state):
        """Close the migration opened by ``begin_rebalance``: copy the
        bucket's register slice (every store leaf, on every node, and the
        lock table's commit-version column) to the landing region, reset
        the freed source region, publish the epoch-bumped map and the
        unfrozen roles, and count the move in ``Metrics.migration_moves``
        of both chains.

        ``state`` must have drained: no dirty version in the slice, no
        lock held on the source chain and no message in its fabric
        addressing the slice (all three checked).  The stores and the
        lock version column are edited in place; returns the state to
        use next.
        """
        cl = self.cluster
        if self._pending_move is None:
            raise AssertionError("no migration in flight")
        bucket, src, dst, dst_base = self._pending_move
        src_base = self._p_base[bucket]
        bsz = cl.bucket_slots
        s_sl = slice(src_base, src_base + bsz)
        d_sl = slice(dst_base, dst_base + bsz)

        holder = state.locks.holder
        if not bool((holder[src] == -1).all()):
            held = holder[src][holder[src] != -1].tolist()
            raise AssertionError(
                f"chain {src} still holds txn locks {held}; tick the engine "
                "until locks_drained before copying")
        if not bool((holder[dst, d_sl] == -1).all()):
            raise AssertionError(
                f"destination region {dst}:{dst_base}..{dst_base + bsz} "
                "holds locks - a free region can never be lock-granted")
        pending = state.stores.pending[src, :, s_sl]
        if bool((pending != 0).any()):
            raise AssertionError(
                f"bucket {bucket} still has {int(pending.sum())} dirty "
                f"version(s) in flight on chain {src}; tick the frozen "
                "engine until the pre-freeze writes commit before copying")
        # a forwarded read or a late ACK still addressing the slot range
        # skips stale-route admission (its src is a node): served after
        # the copy it would read the reset region
        keys = state.inbox.key[src]
        in_region = (state.inbox.op[src] != 0) & (keys >= src_base) & (
            keys < src_base + bsz)
        if bool(in_region.any()):
            raise AssertionError(
                f"{int(in_region.sum())} in-flight message(s) on chain "
                f"{src} still address bucket {bucket}'s slots; tick the "
                "frozen engine until the fabric drains before copying")

        st = state.stores
        for x, reset in ((st.values, 0), (st.seqs, -1), (st.pending, 0),
                         (st.next_seq, 1)):
            x[dst, :, d_sl] = x[src, :, s_sl]
            x[src, :, s_sl] = reset
        st.seqs[src, :, s_sl, 0] = 0
        # the commit-version column moves with its bucket; holder/client
        # are free on both regions (checked above)
        lver = state.locks.version
        lver[dst, d_sl] = lver[src, s_sl]
        lver[src, s_sl] = 0
        moves = state.metrics.migration_moves.clone()
        moves[src] += 1
        moves[dst] += 1

        # host map and epoch; only the two touched regions take the new
        # slot epoch (unmoved buckets keep serving stale clients)
        self._p_free[dst].remove(dst_base)
        self._p_free[src].append(src_base)
        self._p_owner[bucket] = dst
        self._p_base[bucket] = dst_base
        self._p_epoch += 1
        self._p_slot_epoch[src, s_sl] = self._p_epoch
        self._p_slot_epoch[dst, d_sl] = self._p_epoch
        self.chains[src].writes_frozen = False
        self._pending_move = None
        self._recovery_log.append(
            {"event": "rebalance", "bucket": bucket, "src": src, "dst": dst,
             "base": dst_base, "epoch": self._p_epoch, "t": time.time()})

        state = state._replace(
            metrics=state.metrics._replace(migration_moves=moves))
        return self.install_roles(self.install_partition(state))

    def rebalance(self, state, bucket: int, dst_chain: int):
        """Freeze + copy + publish in one shot, for host-level surgery
        where no ticks elapse during the window."""
        self.begin_rebalance(bucket, dst_chain)
        return self.complete_rebalance(self.install_roles(state))

    # -- failure recovery (two phases, paper §III.C) --------------------------
    def fail_node(self, chain_idx: int, node_id: int) -> ChainMembership:
        """Phase 1: drop the node from the forwarding tables and the
        multicast group; publish with ``install_roles(state)``."""
        m = self.chains[chain_idx]
        if node_id not in m.node_ids:
            raise AssertionError(f"node {node_id} not in chain {chain_idx}")
        if m.length <= 2:
            raise AssertionError("cannot drop below head+tail")
        m.node_ids = [i for i in m.node_ids if i != node_id]
        m.epoch += 1
        self.detectors[chain_idx].untrack(node_id)
        self._recovery_log.append(
            {"event": "fail", "chain": chain_idx, "node": node_id,
             "epoch": m.epoch, "t": time.time()})
        return m

    def recovery_source(self, chain_idx: int, position: int) -> int:
        """The live node a replacement copies from (CRAQ: the predecessor
        if one exists, else the new head)."""
        m = self.chains[chain_idx]
        if position == 0:
            return m.node_ids[0]
        return m.node_ids[min(position, m.length) - 1]

    def begin_recovery(self, chain_idx: int) -> ChainMembership:
        """Open the phase-2 copy window: freeze the chain's writes (publish
        with ``install_roles``; client writes and new PREPAREs NACK while
        reads keep serving).  One freeze lifecycle per chain at a time."""
        m = self.chains[chain_idx]
        if (self._pending_move is not None
                and self._pending_move[1] == chain_idx):
            raise AssertionError(
                f"chain {chain_idx} is frozen by an open bucket migration - "
                "complete_rebalance it before starting a recovery window")
        m.writes_frozen = True
        return m

    def complete_recovery(
        self,
        chain_idx: int,
        new_node_id: int,
        position: int,
        stores: Store,
        source_store_index: Optional[int] = None,
        locks=None,
    ) -> tuple[ChainMembership, Store]:
        """Close the copy window: copy the source's registers onto the
        replacement, splice it into the membership and unfreeze writes.

        ``stores`` is one chain's ``[n, ...]`` stores or the cluster's
        ``[C, n, ...]`` (then only ``chain_idx``'s slice changes); the copy
        is made in place and ``stores`` is returned.  With ``locks`` (the
        running ``state.locks``) the copy is refused while the chain holds
        a lock.
        """
        m = self.chains[chain_idx]
        if locks is not None:
            holder = locks.holder[chain_idx]
            if not bool((holder == -1).all()):
                held = holder[holder != -1].tolist()
                raise AssertionError(
                    f"chain {chain_idx} still holds txn locks {held}; tick "
                    "the engine until locks_drained before copying")
        try:
            src = (source_store_index if source_store_index is not None
                   else self.recovery_source(chain_idx, position))
            chain_stacked = stores.values.dim() == 5
            n_slots = stores.values.shape[1 if chain_stacked else 0]
            if not 0 <= new_node_id < n_slots:
                raise AssertionError(
                    f"replacement id {new_node_id} has no physical store "
                    f"slot (0..{n_slots - 1}); an out-of-range scatter "
                    "would silently drop the copy")
            for x in stores:
                if chain_stacked:
                    x[chain_idx, new_node_id] = x[chain_idx, src]
                else:
                    x[new_node_id] = x[src]
            m.node_ids = (m.node_ids[:position] + [new_node_id]
                          + m.node_ids[position:])
            m.epoch += 1
            self.detectors[chain_idx].track(new_node_id)
            self._recovery_log.append(
                {"event": "recover", "chain": chain_idx,
                 "node": new_node_id, "from": src, "epoch": m.epoch,
                 "t": time.time()})
        finally:
            m.writes_frozen = False
        return m, stores

    def recover_node(
        self,
        chain_idx: int,
        new_node_id: int,
        position: int,
        stores: Store,
        source_store_index: Optional[int] = None,
    ) -> tuple[ChainMembership, Store]:
        """Phase 2 in one shot: ``begin_recovery`` + ``complete_recovery``
        (host-level surgery with no ticks in the window)."""
        self.begin_recovery(chain_idx)
        return self.complete_recovery(chain_idx, new_node_id, position,
                                      stores, source_store_index)

    # -- coordination-service API -----------------------------------------------
    @staticmethod
    def put_host(store: Store, key: int, value: int) -> Store:
        """Host-side committed put into one node's store (leaves
        ``[K, ...]``): ``next_seq`` is advanced in place, the committed
        table comes back as ``commit`` rebuilds it."""
        dev = store.values.device
        node = Store(*[x[None] for x in store])
        keys = torch.tensor([[key]], dtype=I32, device=dev)
        active = torch.ones((1, 1), dtype=torch.bool, device=dev)
        vals = torch.zeros((1, 1, store.values.shape[-1]), dtype=I32,
                           device=dev)
        vals[..., 0] = value
        seq = store_lib.take(node.next_seq, keys)
        node.next_seq.add_(store_lib.per_key_count(keys, active,
                                                   node.num_keys))
        out = store_lib.commit(node, keys, vals, seq, active)
        return Store(*[x[0] for x in out])

    @staticmethod
    def get_host(store: Store, key: int) -> int:
        return int(store.values[key, 0, 0])

    @property
    def recovery_log(self) -> list[dict]:
        return list(self._recovery_log)
