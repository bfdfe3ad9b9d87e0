"""TelemetryHub - the host-side reader of the port's telemetry plane, the
port of ``repro/obs/hub.py``.

``snapshot(state)`` copies only the telemetry leaves, the metrics
counters and the tick counter off a port ``SimState`` (``.cpu()`` then
numpy, a copy that later in-place ticks cannot touch), never the reply-log
body.  ``exact_percentiles`` is the one deliberate exception: a
cross-check that pays the ``ReplyLog.merged()`` transfer to validate the
histogram math, after a timed run, never during one.

Percentiles are nearest-rank (rank = ceil(q/100 * total)) over the log2
histogram; a reported latency is its bucket's lower edge ``2**b`` ticks,
in microseconds through a caller-supplied ``us_per_tick``.  The device and
the host share ``reply_op_class`` and ``latency_bucket``, so a histogram
percentile and the exact-log percentile of one run land in the same bucket
while the log did not overflow.  ``tail_percentiles`` picks the source
honestly: the histogram, held to the exact log bucket for bucket unless
the log overflowed.

The JSONL records and the summary table are the reference hub's, key for
key (one object per snapshot, ``kind: "telemetry_snapshot"``).
"""
from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

from repro_torch.core.metrics import Metrics, ReplyLog
from repro_torch.core.telemetry import RING_FIELDS, Telemetry, latency_bucket
from repro_torch.core.types import OP_NAMES, OPCLASS_NAMES, reply_op_class


def _host(x) -> np.ndarray:
    """A numpy copy of a tensor (any device) or an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


DEFAULT_QS = (50.0, 90.0, 99.0, 99.9)


def _qname(q: float) -> str:
    """50 -> 'p50', 99.9 -> 'p999'."""
    return "p" + f"{float(q):g}".replace(".", "")


def _nearest_rank(q: float, total: int) -> int:
    return max(1, int(math.ceil(q / 100.0 * total)))


@dataclasses.dataclass(frozen=True)
class TelemetrySnapshot:
    """One host-side copy of the telemetry leaves (numpy, detached from
    the device state - safe to hold across later in-place ticks)."""

    index: int               # snapshot ordinal within the hub
    t: int                   # SimState.t at snapshot time
    lat_hist: np.ndarray     # [C, OPCLASS, BKT]
    ring: np.ndarray         # [C, W, N_RING_FIELDS]
    ring_cursor: np.ndarray  # [C]
    trace_qid: np.ndarray    # [C, S]
    trace_node: np.ndarray   # [C, S, H]
    trace_tick: np.ndarray   # [C, S, H]
    trace_op: np.ndarray     # [C, S, H]
    trace_len: np.ndarray    # [C, S]
    metrics: Metrics         # numpy-leaf per-chain counters


class TelemetryHub:
    """Snapshot/diff/export pipeline over a running engine's telemetry.

    ``us_per_tick`` converts bucket edges to microseconds (the caller's
    latency model of a tick); ``None`` reports ticks only.  ``heat_alpha`` drives
    the ``Metrics.heat_ewma`` decay the hub maintains over snapshot
    *intervals*.
    """

    def __init__(self, us_per_tick: float | None = None,
                 heat_alpha: float = 0.3):
        self.us_per_tick = us_per_tick
        self.heat_alpha = heat_alpha
        self.snapshots: list[TelemetrySnapshot] = []
        self.heat: list | None = None
        self._heat_history: list[list] = []

    # -- capture ----------------------------------------------------------
    def snapshot(self, state) -> TelemetrySnapshot:
        """Copy the telemetry leaves (+ metrics + t) off ``state`` - the
        *returned* state of a tick (the input may have been updated in
        place).  No
        reply-log body is touched."""
        tel = state.telemetry
        snap = TelemetrySnapshot(
            index=len(self.snapshots),
            t=int(state.t),
            **{f: _host(getattr(tel, f)) for f in Telemetry._fields},
            metrics=Metrics(*[_host(v) for v in state.metrics]),
        )
        # decay the conflict heat over this snapshot's interval delta
        # (counters are monotone, so the delta is the interval's heat)
        if self.snapshots:
            prev = self.snapshots[-1].metrics
            interval = Metrics(*[a - b for a, b in zip(snap.metrics, prev)])
        else:
            interval = snap.metrics
        self.heat = interval.heat_ewma(self.heat, self.heat_alpha)
        self._heat_history.append(self.heat)
        self.snapshots.append(snap)
        return snap

    def _latest(self, snap: TelemetrySnapshot | None) -> TelemetrySnapshot:
        if snap is None:
            assert self.snapshots, "no snapshot taken yet"
            return self.snapshots[-1]
        return snap

    # -- percentiles ------------------------------------------------------
    def percentiles(self, snap: TelemetrySnapshot | None = None,
                    qs=DEFAULT_QS) -> dict:
        """Nearest-rank percentiles per op class from the histogram,
        cluster-wide (chains summed).  A class with no recorded exits maps
        to None."""
        snap = self._latest(snap)
        hist = snap.lat_hist.reshape((-1,) + snap.lat_hist.shape[-2:])
        hist = hist.sum(axis=0)  # [OPCLASS, BKT] over chains
        out = {}
        for ci, cname in enumerate(OPCLASS_NAMES):
            counts = hist[ci]
            total = int(counts.sum())
            if total == 0:
                out[cname] = None
                continue
            cum = np.cumsum(counts)
            entry = {}
            for q in qs:
                bucket = int(np.searchsorted(cum, _nearest_rank(q, total)))
                ticks = 1 << bucket
                rec = {"bucket": bucket, "ticks": ticks}
                if self.us_per_tick is not None:
                    rec["us"] = ticks * self.us_per_tick
                entry[_qname(q)] = rec
            out[cname] = entry
        return out

    @staticmethod
    def log_overflowed(replies: ReplyLog) -> bool:
        """True when the reply log dropped at least one exiting reply
        (``ReplyLog.lost`` - the cursor alone saturates at capacity and
        cannot tell "exactly full" from "overflowed").  When True,
        ``exact_percentiles`` is computed over a TRUNCATED sample whose
        missing tail is exactly the late (slow) exits - callers must
        fall back to the device histograms (``percentiles``), whose
        counts never overflow.  Transfers only the [C] ``lost`` leaf."""
        return int(_host(replies.lost).sum()) > 0

    @staticmethod
    def exact_percentiles(replies: ReplyLog, qs=DEFAULT_QS,
                          us_per_tick: float | None = None,
                          n_buckets: int = 16) -> dict:
        """Cross-check mode: exact nearest-rank percentiles per op class
        from the reply log - the ONE deliberate log-body transfer
        (``merged()``).  Reports the exact tick value plus the log2 bucket
        it falls in (same ``latency_bucket`` as the device), so parity
        asserts compare buckets, not float luck."""
        log = replies.merged()
        op = np.asarray(log.op)
        seq = np.asarray(log.seq)
        tif = np.asarray(log.ticks_in_flight)
        cls = reply_op_class(op, seq)
        out = {}
        for ci, cname in enumerate(OPCLASS_NAMES):
            vals = np.sort(tif[cls == ci])
            if vals.size == 0:
                out[cname] = None
                continue
            entry = {}
            for q in qs:
                ticks = int(vals[_nearest_rank(q, vals.size) - 1])
                rec = {
                    "ticks": ticks,
                    "bucket": int(latency_bucket(np.asarray(ticks),
                                                 n_buckets)),
                }
                if us_per_tick is not None:
                    rec["us"] = ticks * us_per_tick
                entry[_qname(q)] = rec
            out[cname] = entry
        return out

    # -- rates ------------------------------------------------------------
    def rates(self, newer: TelemetrySnapshot | None = None,
              older: TelemetrySnapshot | None = None) -> dict | None:
        """Per-tick rates of the headline counters between two snapshots
        (defaults: the last pair).  None until two snapshots exist."""
        if newer is None or older is None:
            if len(self.snapshots) < 2:
                return None
            older, newer = self.snapshots[-2], self.snapshots[-1]
        dt = max(newer.t - older.t, 1)
        keys = ("replies", "packets", "drops", "lock_conflicts",
                "stale_routes", "write_nacks", "lease_expiries")
        return {
            k: float(
                (getattr(newer.metrics, k).sum()
                 - getattr(older.metrics, k).sum()) / dt
            )
            for k in keys
        }

    # -- locks ------------------------------------------------------------
    @staticmethod
    def lock_health(state) -> dict:
        """Cheap host probe of lock-table abandonment health: how many
        locks are held right now, the age of the oldest (the distance to
        its lease expiry), and the cumulative reclaim count.  Transfers
        only the [C, K] holder/lease leaves and one counter - never the
        reply log - so a chaos runner and an operator
        dashboard can poll it every segment.  An ``oldest_lock_age`` that
        keeps growing while ``lease_expiries`` stays flat is the
        LEASE_OFF leak signature."""
        holder = _host(state.locks.holder)
        lease = _host(state.locks.lease)
        held = holder != -1
        t = int(state.t)
        ages = (t - lease)[held]
        return {
            "t": t,
            "held_locks": int(held.sum()),
            "oldest_lock_age": int(ages.max()) if ages.size else 0,
            "lease_expiries": int(
                _host(state.metrics.lease_expiries).sum()),
        }

    # -- ring -------------------------------------------------------------
    def ring_window(self, snap: TelemetrySnapshot | None = None) -> list:
        """Unwrap each chain's flight-recorder ring oldest -> newest.
        Returns a [C] list of [rows, N_RING_FIELDS] arrays (rows <= W;
        fewer when the engine ran fewer ticks than the window)."""
        snap = self._latest(snap)
        rows = []
        window = snap.ring.shape[1]
        for c in range(snap.ring.shape[0]):
            cur = int(np.asarray(snap.ring_cursor)[c])
            if window == 0 or cur == 0:
                rows.append(np.zeros((0, len(RING_FIELDS)), np.int32))
            elif cur <= window:
                rows.append(snap.ring[c, :cur])
            else:
                start = cur % window
                rows.append(np.concatenate(
                    [snap.ring[c, start:], snap.ring[c, :start]], axis=0
                ))
        return rows

    # -- traces -----------------------------------------------------------
    def traces(self, snap: TelemetrySnapshot | None = None) -> list:
        """Decode the sampled per-hop traces into host records."""
        snap = self._latest(snap)
        out = []
        n_chains, n_slots = snap.trace_qid.shape
        n_hops = snap.trace_node.shape[2] if snap.trace_node.ndim == 3 else 0
        for c in range(n_chains):
            for s in range(n_slots):
                qid = int(snap.trace_qid[c, s])
                if qid < 0:
                    continue
                length = int(snap.trace_len[c, s])
                out.append({
                    "chain": c,
                    "slot": s,
                    "qid": qid,
                    "truncated": length >= n_hops,
                    "hops": [
                        {
                            "node": int(snap.trace_node[c, s, h]),
                            "tick": int(snap.trace_tick[c, s, h]),
                            "op": OP_NAMES.get(
                                int(snap.trace_op[c, s, h]),
                                str(int(snap.trace_op[c, s, h])),
                            ),
                        }
                        for h in range(length)
                    ],
                })
        return out

    # -- export -----------------------------------------------------------
    def jsonl_records(self, qs=DEFAULT_QS) -> list:
        """One record per snapshot (schema in the module docstring)."""
        records = []
        for i, snap in enumerate(self.snapshots):
            older = self.snapshots[i - 1] if i > 0 else None
            records.append({
                "kind": "telemetry_snapshot",
                "snapshot": snap.index,
                "t": snap.t,
                "percentiles": self.percentiles(snap, qs),
                "rates": self.rates(snap, older) if older else None,
                "heat_ewma": self._heat_history[i],
                "ring": {
                    "fields": list(RING_FIELDS),
                    "chains": [w.tolist() for w in self.ring_window(snap)],
                },
                "traces": self.traces(snap),
            })
        return records

    def write_jsonl(self, path: str, qs=DEFAULT_QS) -> None:
        with open(path, "w") as fh:
            for rec in self.jsonl_records(qs):
                fh.write(json.dumps(rec) + "\n")

    def summary(self, qs=DEFAULT_QS) -> str:
        """Human table of the latest snapshot's percentiles and rates."""
        snap = self._latest(None)
        pct = self.percentiles(snap, qs)
        names = [_qname(q) for q in qs]
        unit = "us" if self.us_per_tick is not None else "ticks"
        lines = [
            f"telemetry @ t={snap.t} ({len(self.snapshots)} snapshots)",
            "  class " + "".join(f"{n:>10}" for n in names) + f"   [{unit}]",
        ]
        for cname in OPCLASS_NAMES:
            entry = pct[cname]
            if entry is None:
                lines.append(f"  {cname:<6}" + f"{'-':>10}" * len(names))
                continue
            cells = []
            for n in names:
                val = entry[n].get("us", entry[n]["ticks"])
                cells.append(f"{val:>10.1f}" if isinstance(val, float)
                             else f"{val:>10d}")
            lines.append(f"  {cname:<6}" + "".join(cells))
        rates = self.rates()
        if rates:
            lines.append("  rates/tick: " + "  ".join(
                f"{k}={v:.2f}" for k, v in rates.items()
            ))
        return "\n".join(lines)


def tail_percentiles(state, us_per_tick: float | None = None,
                     qs=(50.0, 99.0)):
    """Latency percentiles with an overflow-honest source.

    The device histogram is the primary source: it never overflows.  The
    exact reply-log percentile is the cross-check: when the log did not
    overflow both views see the same exit multiset and their buckets must
    agree for every class and quantile (raises otherwise); when it did
    (``TelemetryHub.log_overflowed``: the log's missing tail is the late,
    slow exits) the exact view is withheld.

    Returns ``(pct, exact, overflowed)``; ``exact`` is None when the log
    overflowed."""
    hub = TelemetryHub(us_per_tick=us_per_tick)
    hub.snapshot(state)
    pct = hub.percentiles(qs=qs)
    if TelemetryHub.log_overflowed(state.replies):
        return pct, None, True
    exact = TelemetryHub.exact_percentiles(
        state.replies, qs=qs, us_per_tick=us_per_tick,
        n_buckets=state.telemetry.lat_hist.shape[-1])
    for cname, entry in pct.items():
        if entry is None or exact.get(cname) is None:
            continue
        for qn, rec in entry.items():
            if rec["bucket"] != exact[cname][qn]["bucket"]:
                raise AssertionError(
                    f"histogram and reply log disagree: {cname} {qn} "
                    f"{rec} vs {exact[cname][qn]}")
    return pct, exact, False
