"""Failure detection and mitigation (paper §III.C) - the port's copy of
``repro/core/failure.py``, plain Python with no array library.

Phase 1 - *immediate redirection*: clients track per-node responsiveness;
after ``timeout_ticks`` without a response the node is presumed failed and
traffic is redirected to a live node (cheap under CRAQ: any node serves
clean reads).  Phase 2 - *complete recovery*: the control plane
(``repro_torch.core.coordinator``) removes the node from forwarding tables
and the multicast group, copies KV pairs from the CRAQ-prescribed source
onto a replacement with writes frozen, and splices it back in.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FailureDetector:
    """Tick-based responsiveness tracker for a set of nodes.

    'When a node remains unresponsive for a certain amount of time, the
    client can automatically direct requests to a different chain node.
    This time can be adjusted based on ... the average response rate of the
    network.' (paper §III.C) - ``timeout_ticks`` is that knob, and
    ``calibrate`` sets it from an observed response-rate average.
    """

    n_nodes: int
    timeout_ticks: int = 8
    _last_seen: dict[int, int] = dataclasses.field(default_factory=dict)
    # reply-timeout mode: outstanding queries the client has sent and not
    # yet seen answered, qid -> (target node, tick sent)
    _outstanding: dict[int, tuple[int, int]] = dataclasses.field(
        default_factory=dict
    )
    # nodes ever addressed / ever heard from: a tracked node with NEITHER
    # is invisible to the per-query loop in ``overdue`` (nothing was ever
    # outstanding against it), so it needs its own silence check
    _ever_sent: set[int] = dataclasses.field(default_factory=set)
    _ever_heard: set[int] = dataclasses.field(default_factory=set)
    _now: int = 0

    def __post_init__(self):
        for i in range(self.n_nodes):
            self._last_seen[i] = 0

    def tick(self) -> None:
        self._now += 1

    def heard_from(self, node_id: int) -> None:
        self._last_seen[node_id] = self._now
        self._ever_heard.add(node_id)

    # -- reply-timeout mode --------------------------------------------------
    # Instead of emulated heartbeats, the client derives liveness from its
    # own traffic: every query it issues is noted against its target node
    # (the ReplyLog's t_inject side), every reply observed clears it (the
    # t_done side) and refreshes the node's responsiveness.  ``overdue``
    # then names nodes that sat on a query past the timeout while staying
    # otherwise silent - exactly 'unresponsive for a certain amount of
    # time' (paper §III.C), measured on real queries.
    def note_sent(self, node_id: int, qid: int) -> None:
        """Record a query issued to ``node_id`` (its ReplyLog t_inject)."""
        self._outstanding[qid] = (node_id, self._now)
        self._ever_sent.add(node_id)

    def note_reply(self, qid: int) -> None:
        """A reply for ``qid`` appeared in the log (its t_done): the target
        answered - clear the query and refresh the node."""
        ent = self._outstanding.pop(qid, None)
        if ent is not None:
            self.heard_from(ent[0])

    def overdue(self) -> list[int]:
        """Nodes with a query unanswered past ``timeout_ticks`` and no
        reply to *any* query within the window (a single dropped query on
        an otherwise-responsive node is not a failure).

        A tracked node that was never sent to AND never heard from is
        overdue too, once its grace window (from ``track``/init) lapses:
        with no query ever outstanding against it the per-query loop
        cannot see it, and a node the client's routing has black-holed
        since birth is exactly as unresponsive as one sitting on a
        query - the old implementation reported it healthy forever."""
        out = set()
        for node, t0 in self._outstanding.values():
            if self._now - t0 <= self.timeout_ticks:
                continue
            last = self._last_seen.get(node)
            if last is None or self._now - last > self.timeout_ticks:
                out.add(node)
        for node, last in self._last_seen.items():
            if node in self._ever_sent or node in self._ever_heard:
                continue
            if self._now - last > self.timeout_ticks:
                out.add(node)
        return sorted(out)

    def track(self, node_id: int) -> None:
        """Start watching a node (a replacement spliced in by recovery may
        carry a fresh id never seen before); it gets a full timeout grace."""
        self._last_seen[node_id] = self._now

    def untrack(self, node_id: int) -> None:
        """Stop watching a node the CP removed - it must neither linger in
        ``suspected()``/``overdue()`` nor KeyError later probes."""
        self._last_seen.pop(node_id, None)
        self._ever_sent.discard(node_id)
        self._ever_heard.discard(node_id)
        self._outstanding = {
            q: e for q, e in self._outstanding.items() if e[0] != node_id
        }

    def calibrate(self, avg_response_ticks: float, slack: float = 4.0) -> None:
        self.timeout_ticks = max(1, int(avg_response_ticks * slack))

    def suspected(self) -> list[int]:
        return [
            i
            for i, t in self._last_seen.items()
            if self._now - t > self.timeout_ticks
        ]

    def is_alive(self, node_id: int) -> bool:
        last = self._last_seen.get(node_id)
        return last is not None and self._now - last <= self.timeout_ticks


@dataclasses.dataclass
class HedgedReadPolicy:
    """Straggler mitigation for reads: issue the same read to ``fanout``
    chain nodes and keep the first reply.  Under CR this multiplies tail
    load by ``fanout``; under CRAQ it costs one extra *local* read at
    another replica - the asymmetry is itself a scalability argument for
    apportioned queries (beyond-paper addition, used by the serving
    engine for straggler mitigation at scale)."""

    fanout: int = 2

    def targets(self, entry: int, membership) -> list[int]:
        """``entry`` is a chain *position*; distance is measured between
        positions within the live membership (after a failure reorders
        ``node_ids``, node ids and positions diverge - sorting by id
        distance would hedge onto far-away replicas)."""
        nodes = list(membership.node_ids)
        order = sorted(range(len(nodes)), key=lambda p: (abs(p - entry), p))
        return [nodes[p] for p in order[: self.fanout]]
