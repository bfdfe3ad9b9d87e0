"""Fault-tolerance walkthrough on the PyTorch port: kill a chain node
mid-workload, watch phase-1 failover (client redirection) keep serving,
then phase-2 recovery (CP copy with writes frozen) restore full
redundancy - the paper's §Handling-Failures protocol end to end.  The
same flow as ``fault_tolerance.py``, on ``repro_torch`` (its schedules
are the reference's draws, bit for bit): it runs on a CUDA card unless
``--device cpu`` is given (with no card, the default is an error).

    PYTHONPATH=src python examples/fault_tolerance_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core.chain import ChainSim
from repro_torch.core.coordinator import Coordinator
from repro_torch.core.failure import FailureDetector
from repro_torch.core.types import ChainConfig
from repro_torch.core.workload import WorkloadConfig, make_schedule


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    cfg = ChainConfig(n_nodes=4, num_keys=32, num_versions=4)
    coord = Coordinator(cfg, device=dev)
    sim = ChainSim(cfg, inject_capacity=8, route_capacity=128, device=dev)
    state = sim.init_state()

    # 1. steady state: mixed workload commits cleanly
    wl = WorkloadConfig(ticks=4, queries_per_tick=4, write_fraction=0.3,
                        seed=1)
    state = sim.run(state, make_schedule(cfg, wl, device=dev),
                    extra_ticks=12)
    print(f"steady state: {int(state.replies.cursor.sum())} replies, "
          f"pending={int(state.stores.pending.sum())} (all committed)")

    # 2. node 2 dies; detector notices; clients redirect
    det = FailureDetector(n_nodes=4, timeout_ticks=3)
    for _ in range(5):
        det.tick()
        for alive in (0, 1, 3):
            det.heard_from(alive)
    assert det.suspected() == [2]
    print(f"\nfailure detector: node 2 unresponsive for "
          f">{det.timeout_ticks} ticks -> suspected={det.suspected()}")

    membership = coord.fail_node(0, 2)
    redirect = coord.failover.redirect(membership, dead=2)
    print(f"phase 1: node 2 removed from forwarding tables + multicast "
          f"group (epoch {membership.epoch}); clients redirect to node "
          f"{redirect}. CRAQ keeps serving reads from every live replica.")

    # 3. the SAME running sim keeps serving degraded: the CP publishes the
    # new role table onto the live state - no new engine, no state reset
    # (the paper's availability claim)
    state = coord.install_roles(state)
    replies_before = int(state.replies.cursor.sum())
    wl3 = WorkloadConfig(ticks=3, queries_per_tick=4, write_fraction=0.2,
                         seed=2)
    state = sim.run(state, make_schedule(cfg, wl3, device=dev),
                    extra_ticks=10)
    m = state.metrics.asdict()
    print(f"degraded chain: {int(state.replies.cursor.sum()) - replies_before} "
          f"replies served live with 3/4 nodes, "
          f"pending={int(state.stores.pending.sum())}, "
          f"dead-lane drops={m['drops']}")

    # 4. phase 2: freeze writes, copy from the CRAQ-prescribed source,
    # splice the replacement back in, unfreeze
    coord.begin_recovery(0)
    state = coord.install_roles(state)  # writes now NACK at the entry node
    membership, stores = coord.complete_recovery(
        0, new_node_id=2, position=2, stores=state.stores)
    state = coord.install_roles(state._replace(stores=stores))
    src = coord.recovery_log[-1]["from"]
    same = bool(torch.equal(state.stores.values[0, 2],
                            state.stores.values[0, src]))
    print(f"\nphase 2: node 2 re-enters at position 2, KV pairs copied "
          f"from node {src} (writes frozen during copy). "
          f"copy exact: {same}. epoch now {membership.epoch}.")
    print(f"recovery log: {[e['event'] for e in coord.recovery_log]}")


if __name__ == "__main__":
    main()
