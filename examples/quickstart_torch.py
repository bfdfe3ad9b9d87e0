"""Quickstart on the PyTorch port: a NetCRAQ coordination chain in 60
seconds.

Spins up a 4-node chain (simulation engine), writes configuration keys,
reads them back from different nodes (the CRAQ fast path), and shows the
exact packet accounting that gives the paper its scalability headline.
The same flow as ``quickstart.py``, on ``repro_torch``: it runs on a
CUDA card unless ``--device cpu`` is given (with no card, the default is
an error).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch.core.chain import ChainSim
from repro_torch.core.types import (CLIENT_BASE, OP_READ, OP_WRITE,
                                    ChainConfig, Msg)


def inject(sim, op, key, val, node, qid):
    m = Msg.empty((sim.n, sim.c_in), device=sim.device)
    m.op[node, 0] = op
    m.key[node, 0] = key
    m.value[node, 0, 0] = val
    m.src[node, 0] = CLIENT_BASE + 1
    m.client[node, 0] = CLIENT_BASE + 1
    m.dst[node, 0] = node
    m.qid[node, 0] = qid
    return m


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = ChainConfig(n_nodes=4, num_keys=64, num_versions=4,
                      protocol="netcraq")
    sim = ChainSim(cfg, inject_capacity=4, route_capacity=64,
                   device=args.device)
    state = sim.init_state()
    print(f"chain: {cfg.n_nodes} nodes, {cfg.num_keys} keys, "
          f"{cfg.header_bytes}B headers ({cfg.protocol})")

    # write LEADER=7 via the head
    state = sim.tick(state, inject(sim, OP_WRITE, key=0, val=7, node=0, qid=1))
    state = sim.drain(state, 10)
    print(f"\nwrite committed; packets so far: {int(state.metrics.packets.sum())} "
          f"(client leg + {cfg.n_nodes - 1} chain hops + ACK multicast + reply)")

    # read it back from EVERY node - each is a local 2-packet round trip
    before = int(state.metrics.packets.sum())
    for node in range(4):
        state = sim.tick(state, inject(sim, OP_READ, 0, 0, node, 10 + node))
    state = sim.drain(state, 4)
    reads = int(state.metrics.packets.sum()) - before
    replies = state.replies.merged()
    n = int(replies.cursor)
    print(f"4 reads (one per node) cost {reads} packets total "
          f"({reads // 4} per read - distance-independent, paper Fig 3)")
    vals = [int(replies.value0[i]) for i in range(n)
            if int(replies.op[i]) == 4]
    print(f"every node answered LEADER={set(vals)} locally")

    # the same reads on NetChain would cost 2+4+6+8 = 20 packets
    print("\n(the CR/NetChain equivalent: 2(d+1) packets per read ->",
          sum(2 * (d + 1) for d in range(4)), "packets for the same reads)")


if __name__ == "__main__":
    main()
