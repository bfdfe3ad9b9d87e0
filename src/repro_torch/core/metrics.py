"""Traffic accounting and the reply log - the port of ``repro/core/metrics.py``.

``Metrics`` holds per-chain int32 counters (``[C]`` leaves, the
per-bucket conflict heat ``[C, G]``) and ``ReplyLog`` the per-chain
``[C, R]`` record of replies that exited to clients, with the
reference's field order and counting rules.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.types import I32, resolve_device


class Metrics(NamedTuple):
    packets: torch.Tensor
    msgs: torch.Tensor
    bytes: torch.Tensor
    kv_procs: torch.Tensor
    reads_in: torch.Tensor
    writes_in: torch.Tensor
    acks: torch.Tensor
    replies: torch.Tensor
    dirty_appends: torch.Tensor
    fwd_reads: torch.Tensor
    drops: torch.Tensor
    relay_procs: torch.Tensor
    write_nacks: torch.Tensor
    txn_commits: torch.Tensor
    txn_aborts: torch.Tensor
    lock_conflicts: torch.Tensor
    stale_routes: torch.Tensor
    migration_moves: torch.Tensor
    wave_commits: torch.Tensor
    wave_aborts: torch.Tensor
    wave_occupancy: torch.Tensor
    offered: torch.Tensor
    admission_drops: torch.Tensor
    lease_expiries: torch.Tensor
    conflict_heat: torch.Tensor  # [C, G] per-bucket PREPARE-NACK counts

    @staticmethod
    def zeros(n_chains: int = 1, num_buckets: int = 1,
              device="cuda") -> "Metrics":
        dev = resolve_device(device)
        z = lambda: torch.zeros((n_chains,), dtype=I32, device=dev)
        return Metrics(
            *[z() for _ in range(24)],
            conflict_heat=torch.zeros((n_chains, num_buckets), dtype=I32,
                                      device=dev),
        )

    def total(self) -> "Metrics":
        """Reduce per-chain counters to cluster-wide int32 scalars."""
        return Metrics(*[v.sum().to(I32) for v in self])

    def asdict(self) -> dict:
        """Cluster totals (per-chain leaves are summed)."""
        return {k: int(v) for k, v in self.total()._asdict().items()}

    def per_chain(self) -> dict:
        """Per-chain counters as host lists (scalars become length-1;
        the per-bucket conflict heat is summed over its buckets)."""
        out = {}
        for k, v in self._asdict().items():
            a = torch.atleast_1d(v)
            if a.dim() > 1:
                a = a.sum(dim=tuple(range(1, a.dim())))
            out[k] = [int(x) for x in a.tolist()]
        return out

    def heat_per_bucket(self) -> list:
        """Cluster-wide per-bucket conflict heat (a [G] host list): the
        [C, G] leaf summed over chains, each chain counting NACKs only on
        the buckets it owns.  The leaves may be tensors or numpy arrays
        (``obs.TelemetryHub`` keeps numpy copies)."""
        heat = self.conflict_heat
        if isinstance(heat, torch.Tensor):
            heat = heat.cpu().numpy()
        return [int(x) for x in np.atleast_2d(heat).sum(axis=0)]

    def heat_ewma(self, prev: "list | None", alpha: float) -> list:
        """One EWMA step over ``heat_per_bucket()``: ``new[b] = (1 -
        alpha) * prev[b] + alpha * heat[b]``, from zeros when ``prev`` is
        None.  Call it on interval metrics (the difference of two
        snapshots), as ``obs.TelemetryHub`` does; under constant interval
        heat ``h`` the fixpoint is ``h``."""
        cur = self.heat_per_bucket()
        if prev is None:
            prev = [0.0] * len(cur)
        assert len(prev) == len(cur), (len(prev), len(cur))
        return [(1.0 - alpha) * p + alpha * c for p, c in zip(prev, cur)]


class ReplyLog(NamedTuple):
    """Fixed-capacity per-chain record of replies that exited to clients."""

    qid: torch.Tensor       # [C, R] int32 (-1 = empty)
    op: torch.Tensor        # [C, R]
    key: torch.Tensor       # [C, R]
    seq: torch.Tensor       # [C, R]
    value0: torch.Tensor    # [C, R] first value word
    t_inject: torch.Tensor  # [C, R]
    t_done: torch.Tensor    # [C, R]
    hops: torch.Tensor      # [C, R] link traversals along the query's path
    ticks_in_flight: torch.Tensor  # [C, R] t_done - t_inject
    lost: torch.Tensor      # [C] replies that found the log full
    cursor: torch.Tensor    # [C] next free slot

    @staticmethod
    def empty(capacity: int, n_chains: int = 1, device="cuda") -> "ReplyLog":
        dev = resolve_device(device)
        neg = torch.full((n_chains, capacity), -1, dtype=I32, device=dev)
        z = lambda: torch.zeros((n_chains, capacity), dtype=I32, device=dev)
        zc = lambda: torch.zeros((n_chains,), dtype=I32, device=dev)
        return ReplyLog(neg, z(), z(), z(), z(), z(), z(), z(), z(), zc(),
                        zc())

    def merged(self) -> "ReplyLog":
        """Flatten the per-chain log into one host-side (numpy) log of
        each chain's live prefix, in chain order."""
        n_rows = len(self._fields) - 2
        cur = self.cursor.cpu().numpy()

        def cat(field):
            f = field.cpu().numpy()
            return np.concatenate([f[c, : cur[c]] for c in range(len(cur))])

        return ReplyLog(
            *[cat(f) for f in self[:n_rows]],
            lost=np.int32(self.lost.sum().item()),
            cursor=np.int32(cur.sum()),
        )

    def total_landed(self) -> int:
        """Host-side count of the replies logged so far: transfers only
        the ``[C]`` cursor leaf, never the log body (the transaction
        driver polls it every tick)."""
        return sum(self.cursor.tolist())

    def append(self, exits, t_done, dense: bool = False) -> "ReplyLog":
        """Record exiting replies (a masked ``[C, M]`` Msg) into the log.

        Default path writes ONE pointer per landing slot and gathers every
        field through it; ``dense=True`` writes every field through its
        own scatter.  Both produce identical logs.
        """
        C, cap = self.qid.shape
        dev = self.qid.device
        live = exits.live()
        rank = torch.cumsum(live.to(I32), dim=1) - 1
        slot = self.cursor[:, None] + rank
        ok = live & (slot < cap)
        tgt = torch.where(ok, slot, cap).long()  # overflow -> padding column
        n_live = live.sum(dim=1).to(I32)
        new_cursor = torch.clamp(self.cursor + n_live, max=cap)
        new_lost = self.lost + (n_live - ok.sum(dim=1)).to(I32)
        t_done = torch.as_tensor(t_done, dtype=I32, device=dev)
        fill = t_done.expand_as(exits.qid)

        if dense:
            def put(buf, val):
                out = torch.cat([buf, buf.new_zeros((C, 1))], dim=1)
                out.scatter_(1, tgt, val.to(I32))
                return out[:, :cap]

            return ReplyLog(
                qid=put(self.qid, exits.qid),
                op=put(self.op, exits.op),
                key=put(self.key, exits.key),
                seq=put(self.seq, exits.seq),
                value0=put(self.value0, exits.value[..., 0]),
                t_inject=put(self.t_inject, exits.t_inject),
                t_done=put(self.t_done, fill),
                hops=put(self.hops, exits.extra),
                ticks_in_flight=put(self.ticks_in_flight,
                                    fill - exits.t_inject),
                lost=new_lost,
                cursor=new_cursor,
            )

        M = live.shape[1]
        ptr = torch.full((C, cap + 1), M, dtype=torch.int64, device=dev)
        ptr.scatter_(1, tgt, torch.arange(M, device=dev).expand(C, M))
        ptr = ptr[:, :cap]
        fresh = ptr < M
        pc = ptr.clamp(0, M - 1)

        def sel(buf, val):
            return torch.where(fresh, val.gather(1, pc), buf)

        return ReplyLog(
            qid=sel(self.qid, exits.qid),
            op=sel(self.op, exits.op),
            key=sel(self.key, exits.key),
            seq=sel(self.seq, exits.seq),
            value0=sel(self.value0, exits.value[..., 0]),
            t_inject=sel(self.t_inject, exits.t_inject),
            t_done=torch.where(fresh, t_done, self.t_done),
            hops=sel(self.hops, exits.extra),
            ticks_in_flight=torch.where(
                fresh, t_done - exits.t_inject.gather(1, pc),
                self.ticks_in_flight),
            lost=new_lost,
            cursor=new_cursor,
        )
