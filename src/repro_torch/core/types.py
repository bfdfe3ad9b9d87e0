"""Wire-level and state types of the PyTorch port.

A copy of the JAX package's ``core/types.py`` constants (opcodes, the
VALUE width, the id bases and the destination sentinels) and its state
types, with torch tensors in every lane.  Field order and semantics are
the reference's, so ``repro_torch.convert`` can carry a state across
field by field.  Every lane is int32 (bool for the role flags): torch
promotes int32 reductions to int64, so every function here pins its
results back to int32 explicitly.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Operation codes (KV_OP field).  NOP marks an empty slot in a padded batch.
# ---------------------------------------------------------------------------
OP_NOP = 0
OP_READ = 1
OP_WRITE = 2
OP_ACK = 3
OP_READ_REPLY = 4
OP_WRITE_REPLY = 5
OP_WRITE_NACK = 6
OP_PREPARE = 7
OP_PREPARE_ACK = 8
OP_PREPARE_NACK = 9
OP_COMMIT = 10
OP_ABORT = 11
OP_TXN_REPLY = 12
OP_STALE_NACK = 13

OP_NAMES = {
    OP_NOP: "NOP",
    OP_READ: "READ",
    OP_WRITE: "WRITE",
    OP_ACK: "ACK",
    OP_READ_REPLY: "READ_REPLY",
    OP_WRITE_REPLY: "WRITE_REPLY",
    OP_WRITE_NACK: "WRITE_NACK",
    OP_PREPARE: "PREPARE",
    OP_PREPARE_ACK: "PREPARE_ACK",
    OP_PREPARE_NACK: "PREPARE_NACK",
    OP_COMMIT: "COMMIT",
    OP_ABORT: "ABORT",
    OP_TXN_REPLY: "TXN_REPLY",
    OP_STALE_NACK: "STALE_NACK",
}


def is_txn_op(op):
    """Client-facing transaction opcodes (tensor- and int-friendly)."""
    return (op == OP_PREPARE) | (op == OP_COMMIT) | (op == OP_ABORT)


# Latency op classes of the telemetry plane (``core/telemetry.py``): each
# reply that exits to a client lands in one row of the latency histogram.
# The device (the histogram inside the tick) and the host (``obs.hub``'s
# exact reply-log cross-check) classify through the same function.
OPCLASS_READ = 0   # OP_READ_REPLY
OPCLASS_WRITE = 1  # OP_WRITE_REPLY
OPCLASS_TXN = 2    # OP_TXN_REPLY with seq >= 0, OP_PREPARE_ACK
OPCLASS_NACK = 3   # WRITE/STALE/PREPARE NACKs, OP_TXN_REPLY with seq < 0
N_OPCLASS = 4
OPCLASS_NAMES = ("read", "write", "txn", "nack")


def reply_op_class(op, seq):
    """Latency class of an exiting reply, -1 for anything else (NOP
    padding, chain-internal ops).  Takes torch tensors or numpy arrays
    and returns int32 of the same kind.  ``OP_TXN_REPLY`` splits on its
    seq: a commit carries the write seq (>= 0), an abort -1."""
    xp = torch if isinstance(op, torch.Tensor) else np
    is_txn_reply = op == OP_TXN_REPLY
    cls = xp.where(op == OP_READ_REPLY, OPCLASS_READ, -1)
    cls = xp.where(op == OP_WRITE_REPLY, OPCLASS_WRITE, cls)
    cls = xp.where((is_txn_reply & (seq >= 0)) | (op == OP_PREPARE_ACK),
                   OPCLASS_TXN, cls)
    cls = xp.where((op == OP_WRITE_NACK) | (op == OP_STALE_NACK)
                   | (op == OP_PREPARE_NACK) | (is_txn_reply & (seq < 0)),
                   OPCLASS_NACK, cls)
    return cls.to(I32) if xp is torch else np.asarray(cls, np.int32)


# Value payload width: 128-bit VALUE field == 4 x 32-bit words.
VALUE_WORDS = 4
# src ids >= CLIENT_BASE denote clients; below are chain node positions.
CLIENT_BASE = 1 << 20
# src/client ids >= WAVE_BASE denote device-resident 2PC coordinators.
WAVE_BASE = 1 << 22
# Lock-lease "disabled" sentinel: int32 max never expires a lock.
LEASE_OFF = (1 << 31) - 1
# dst sentinels: exits / empty slot, tail-ACK fan-out, reply to the client.
NOWHERE = -1
MULTICAST = -2
TO_CLIENT = -3

# Wire-format byte accounting (overhead bytes layered over UDP).
NETCRAQ_HEADER_BYTES = 20

I32 = torch.int32


def netchain_header_bytes(chain_len: int) -> int:
    """58 bytes at 4 nodes, +4 bytes (one IPv4) per extra node."""
    return 58 + 4 * (chain_len - 4)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device without a card
    is an error, never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on CUDA by default and no CUDA "
            "device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def as_i32(x, device) -> torch.Tensor:
    """An int32 tensor on ``device`` from a tensor or an array-like
    (array-likes are copied: they may be read-only buffers)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=I32)
    return torch.tensor(np.array(x), dtype=I32, device=device)


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of NamedTuples of tensors (nested
    NamedTuples recurse, ``None`` leaves stay ``None``)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[tree_map(fn, *xs) for xs in zip(*trees)])
    return fn(*trees)


class Msg(NamedTuple):
    """A batch of messages, structure-of-arrays, any leading batch shape.

    Every lane has the batch shape; ``value`` adds a trailing
    ``VALUE_WORDS`` axis.  Empty slots have op == OP_NOP, dst == NOWHERE.
    """

    op: torch.Tensor
    key: torch.Tensor
    value: torch.Tensor
    seq: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    client: torch.Tensor
    entry: torch.Tensor
    qid: torch.Tensor
    t_inject: torch.Tensor
    extra: torch.Tensor
    ver: torch.Tensor

    @property
    def batch(self) -> int:
        return self.op.shape[-1]

    @staticmethod
    def empty(shape, value_words: int = VALUE_WORDS,
              device="cuda") -> "Msg":
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        dev = resolve_device(device)
        z = lambda: torch.zeros(shape, dtype=I32, device=dev)
        neg = lambda: torch.full(shape, -1, dtype=I32, device=dev)
        return Msg(
            op=z(),
            key=z(),
            value=torch.zeros(shape + (value_words,), dtype=I32, device=dev),
            seq=neg(),
            src=z(),
            dst=torch.full(shape, NOWHERE, dtype=I32, device=dev),
            client=z(),
            entry=z(),
            qid=neg(),
            t_inject=z(),
            extra=z(),
            ver=z(),
        )

    def mask(self, keep: torch.Tensor) -> "Msg":
        """Blank out slots where ``keep`` is False (turn them into NOPs);
        every lane comes back int32."""
        keep = keep.to(torch.bool)
        zero = torch.zeros((), dtype=I32, device=keep.device)

        def w(x, fill):
            return torch.where(keep, x, zero + fill).to(I32)

        return Msg(
            op=w(self.op, OP_NOP),
            key=w(self.key, 0),
            value=torch.where(keep[..., None], self.value, zero).to(I32),
            seq=w(self.seq, -1),
            src=w(self.src, 0),
            dst=w(self.dst, NOWHERE),
            client=w(self.client, 0),
            entry=w(self.entry, 0),
            qid=w(self.qid, -1),
            t_inject=w(self.t_inject, 0),
            extra=w(self.extra, 0),
            ver=w(self.ver, 0),
        )

    def live(self) -> torch.Tensor:
        return self.op != OP_NOP

    @staticmethod
    def concat(msgs: list["Msg"], dim: int = 0) -> "Msg":
        return tree_map(lambda *xs: torch.cat(xs, dim=dim), *msgs)


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    """Static configuration of one replication chain."""

    n_nodes: int = 4
    num_keys: int = 256
    num_versions: int = 4        # version window per object (cell 0 = clean)
    value_words: int = VALUE_WORDS
    protocol: str = "netcraq"    # "netcraq" | "netchain"

    def __post_init__(self):
        assert self.n_nodes >= 2, "chain needs at least head and tail"
        assert self.num_versions >= 2, "need >=1 dirty slot besides cell 0"
        assert self.protocol in ("netcraq", "netchain")

    @property
    def header_bytes(self) -> int:
        if self.protocol == "netcraq":
            return NETCRAQ_HEADER_BYTES
        return netchain_header_bytes(self.n_nodes)

    @property
    def payload_bytes(self) -> int:
        return 4 * self.value_words


class PartitionMap(NamedTuple):
    """Versioned bucket->chain partition table (see the reference's
    ``PartitionMap``): ``owner``/``base`` per bucket, the map ``epoch``
    and the ``[C, K]`` reverse occupancy and move-epoch tables."""

    owner: torch.Tensor        # [G] int32
    base: torch.Tensor         # [G] int32
    epoch: torch.Tensor        # [] int32
    slot_bucket: torch.Tensor  # [C, K] int32, -1 = free region
    slot_epoch: torch.Tensor   # [C, K] int32

    @staticmethod
    def build(owner, base, epoch, *, n_chains: int, num_keys: int,
              bucket_slots: int, slot_epoch=None,
              device="cuda") -> "PartitionMap":
        """Assemble a map from its primary columns, deriving the [C, K]
        occupancy table by writing each bucket's slot range into its
        owner chain's row."""
        dev = resolve_device(device)
        owner = as_i32(owner, dev)
        base = as_i32(base, dev)
        G = owner.shape[0]
        j = torch.arange(bucket_slots, dtype=I32, device=dev)
        rows = owner.repeat_interleave(bucket_slots)
        cols = (base[:, None] + j[None, :]).reshape(-1)
        ids = torch.arange(G, dtype=I32, device=dev).repeat_interleave(
            bucket_slots)
        flat = torch.full((n_chains * num_keys,), -1, dtype=I32, device=dev)
        flat[(rows * num_keys + cols).long()] = ids
        if slot_epoch is None:
            slot_epoch = torch.zeros((n_chains, num_keys), dtype=I32,
                                     device=dev)
        return PartitionMap(
            owner=owner,
            base=base,
            epoch=as_i32(epoch, dev),
            slot_bucket=flat.reshape(n_chains, num_keys),
            slot_epoch=as_i32(slot_epoch, dev),
        )


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Static configuration of a multi-chain cluster: ``n_chains`` chains
    partition ``n_chains * keys_in_use`` global keys; the home of global
    key ``g`` is chain ``g % n_chains``, register ``g // n_chains``."""

    chain: ChainConfig = dataclasses.field(default_factory=ChainConfig)
    n_chains: int = 1
    buckets_per_chain: int = 1
    spare_keys: int = 0

    def __post_init__(self):
        assert self.n_chains >= 1, "cluster needs at least one chain"
        assert 0 <= self.spare_keys < self.chain.num_keys, (
            "spare_keys must leave at least one in-use register"
        )
        assert self.buckets_per_chain >= 1
        assert self.keys_in_use % self.buckets_per_chain == 0, (
            f"{self.keys_in_use} in-use registers do not divide into "
            f"{self.buckets_per_chain} equal buckets"
        )

    @property
    def keys_in_use(self) -> int:
        return self.chain.num_keys - self.spare_keys

    @property
    def bucket_slots(self) -> int:
        return self.keys_in_use // self.buckets_per_chain

    @property
    def num_buckets(self) -> int:
        return self.n_chains * self.buckets_per_chain

    @property
    def num_global_keys(self) -> int:
        return self.n_chains * self.keys_in_use

    def bucket_of(self, key):
        """Bucket id of a global key (tensor- and int-friendly)."""
        return (key % self.n_chains) * self.buckets_per_chain + (
            key // self.n_chains
        ) // self.bucket_slots

    def bucket_home(self, bucket):
        """(home chain, home base slot) of a bucket: its epoch-0 spot."""
        return (
            bucket // self.buckets_per_chain,
            (bucket % self.buckets_per_chain) * self.bucket_slots,
        )

    def _bucket_index(self, key) -> torch.Tensor:
        """``bucket_of(key)`` as a gather index with the reference's
        clamping (a JAX gather wraps a negative index once and clamps the
        rest), so any key answers where the reference's answers."""
        b = self.bucket_of(key)
        G = self.num_buckets
        return torch.where(b < 0, b + G, b).clamp(0, G - 1).long()

    def default_partition(self, device="cuda") -> PartitionMap:
        """The epoch-0 map: every bucket at home."""
        dev = resolve_device(device)
        b = torch.arange(self.num_buckets, dtype=I32, device=dev)
        return PartitionMap.build(
            owner=b // self.buckets_per_chain,
            base=(b % self.buckets_per_chain) * self.bucket_slots,
            epoch=0,
            n_chains=self.n_chains,
            num_keys=self.chain.num_keys,
            bucket_slots=self.bucket_slots,
            device=dev,
        )

    def key_to_chain(self, key, pmap: PartitionMap | None = None):
        """Owning chain of a global key; with a ``pmap`` a bucket-table
        gather (``key`` a tensor)."""
        if pmap is None:
            return key % self.n_chains
        return pmap.owner[self._bucket_index(key)]

    def key_to_slot(self, key, pmap: PartitionMap | None = None):
        """Register index of a global key within its owning chain."""
        if pmap is None:
            return key // self.n_chains
        return pmap.base[self._bucket_index(key)] + (
            key // self.n_chains
        ) % self.bucket_slots

    def local_key(self, key, pmap: PartitionMap | None = None):
        """Alias of ``key_to_slot`` (the pre-rebalancing name)."""
        return self.key_to_slot(key, pmap)

    def global_key(self, local, chain, pmap: PartitionMap | None = None):
        """Inverse of (key_to_chain, key_to_slot); -1 for free slots when
        resolved through a ``pmap``."""
        if pmap is None:
            return local * self.n_chains + chain
        b = pmap.slot_bucket[chain, local]
        bc = b.clamp(0, self.num_buckets - 1)
        within = local - pmap.base[bc.long()]
        g = (
            (bc % self.buckets_per_chain) * self.bucket_slots + within
        ) * self.n_chains + bc // self.buckets_per_chain
        return torch.where(b < 0, torch.full_like(g, -1), g)

    @property
    def n_nodes(self) -> int:
        return self.chain.n_nodes

    @property
    def header_bytes(self) -> int:
        return self.chain.header_bytes

    @property
    def payload_bytes(self) -> int:
        return self.chain.payload_bytes


def as_cluster(cfg) -> ClusterConfig:
    """Normalize: a bare ChainConfig is a single-chain cluster."""
    if isinstance(cfg, ClusterConfig):
        return cfg
    return ClusterConfig(chain=cfg, n_chains=1)


class Roles(NamedTuple):
    """Per-node role table installed by the control plane; positions are
    physical slot ids, ``chain_pos`` the live-chain coordinate."""

    my_pos: torch.Tensor     # int32 physical slot id of this node
    head_pos: torch.Tensor   # int32 physical id of the live head
    tail_pos: torch.Tensor   # int32 physical id of the live tail
    n_nodes: torch.Tensor    # int32 live chain length
    next_pos: torch.Tensor   # int32 live successor (NOWHERE at tail/dead)
    prev_pos: torch.Tensor   # int32 live predecessor (NOWHERE at head/dead)
    chain_pos: torch.Tensor  # int32 live-chain position (NOWHERE if dead)
    alive: torch.Tensor      # bool
    frozen: torch.Tensor     # bool chain-wide write freeze

    @property
    def is_tail(self) -> torch.Tensor:
        return self.my_pos == self.tail_pos

    @property
    def is_head(self) -> torch.Tensor:
        return self.my_pos == self.head_pos

    @staticmethod
    def from_membership(n_physical: int, node_ids, frozen: bool = False,
                        device="cuda") -> "Roles":
        """Role table of one chain with [n_physical] leaves; ``node_ids``
        is the ordered live membership (head .. tail)."""
        node_ids = [int(i) for i in node_ids]
        assert len(node_ids) >= 2, "chain needs at least head and tail"
        assert all(0 <= i < n_physical for i in node_ids), (
            f"node ids {node_ids} outside physical slot range "
            f"0..{n_physical - 1}"
        )
        assert len(set(node_ids)) == len(node_ids), "duplicate node ids"
        dev = resolve_device(device)
        alive = [False] * n_physical
        chain_pos = [NOWHERE] * n_physical
        nxt = [NOWHERE] * n_physical
        prv = [NOWHERE] * n_physical
        for pos, nid in enumerate(node_ids):
            alive[nid] = True
            chain_pos[nid] = pos
            if pos + 1 < len(node_ids):
                nxt[nid] = node_ids[pos + 1]
            if pos > 0:
                prv[nid] = node_ids[pos - 1]
        full = lambda v: torch.full((n_physical,), v, dtype=I32, device=dev)
        ints = lambda xs: torch.tensor(xs, dtype=I32, device=dev)
        return Roles(
            my_pos=torch.arange(n_physical, dtype=I32, device=dev),
            head_pos=full(node_ids[0]),
            tail_pos=full(node_ids[-1]),
            n_nodes=full(len(node_ids)),
            next_pos=ints(nxt),
            prev_pos=ints(prv),
            chain_pos=ints(chain_pos),
            alive=torch.tensor(alive, dtype=torch.bool, device=dev),
            frozen=torch.full((n_physical,), bool(frozen), dtype=torch.bool,
                              device=dev),
        )


def value_from_int(x, value_words: int = VALUE_WORDS,
                   device=None) -> torch.Tensor:
    """Pack a scalar int (or int tensor) into a VALUE payload: word 0 is
    ``x``, the rest 0."""
    x = torch.as_tensor(x, dtype=I32, device=device)
    pads = [torch.zeros_like(x)] * (value_words - 1)
    return torch.stack([x, *pads], dim=-1)
