"""Clean twin of rl003_bad.py: every int32 lane pinned, or untyped."""
from typing import NamedTuple

import torch

I32 = torch.int32
OP_READ = 1


class Msg(NamedTuple):
    op: torch.Tensor
    key: torch.Tensor
    seq: torch.Tensor

    def mask(self, keep: torch.Tensor) -> "Msg":
        zero = torch.zeros((), dtype=I32, device=keep.device)
        return Msg(*[torch.where(keep, x, zero).to(I32) for x in self])


class Knobs(NamedTuple):
    """Open-loop knobs."""

    seed: torch.Tensor   # [] int32 PRNG root
    qps: torch.Tensor    # [] float32 offered ops a tick


def make(n: int):
    keys = torch.arange(n, dtype=I32)
    return Msg(
        op=torch.full((n,), OP_READ, dtype=torch.int32),
        key=keys,
        seq=torch.zeros(n).int(),
    )


def update(msg: Msg, hit: torch.Tensor):
    return msg._replace(op=torch.where(hit, 1, 0).to(I32))


def keep_dtype(msg: Msg, hit: torch.Tensor):
    # a Python scalar does not widen an int32 tensor
    return msg._replace(key=torch.where(hit, msg.key, 0) + 1,
                        seq=torch.full_like(msg.seq, -1))


def count(msg: Msg):
    return msg._replace(key=msg.key.sum(dim=0, dtype=I32))


def knobs(seed: int):
    return Knobs(seed=torch.tensor(7, dtype=torch.int32),
                 qps=torch.tensor(1.5))


def pinned(n: int, live: torch.Tensor):
    # Msg.mask pins every lane of the construction it closes
    return Msg(op=torch.full((n,), OP_READ), key=torch.arange(n),
               seq=torch.zeros(n)).mask(live)


def untyped(msg: Msg, lanes):
    # what the inference cannot type is not flagged
    return msg._replace(op=lanes.op, key=lanes[1])
