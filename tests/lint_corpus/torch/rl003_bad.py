"""Known-bad exemplar for RL003: values that are not int32 entering int32
lanes."""
from typing import NamedTuple

import torch

OP_READ = 1


class Msg(NamedTuple):
    op: torch.Tensor
    key: torch.Tensor
    seq: torch.Tensor


class Knobs(NamedTuple):
    """Open-loop knobs."""

    seed: torch.Tensor   # [] int32 PRNG root
    qps: torch.Tensor    # [] float32 offered ops a tick


def make(n: int):
    keys = torch.arange(n)                       # int64: no dtype
    return Msg(
        op=torch.full((n,), OP_READ),            # BAD: an int fill is int64
        key=keys,                                # BAD: the int64 arange
        seq=torch.zeros(n),                      # BAD: float32
    )


def update(msg: Msg, hit: torch.Tensor):
    return msg._replace(op=torch.where(hit, 1, 0))  # BAD: int64


def count(msg: Msg):
    return msg._replace(key=msg.key.sum(dim=0))  # BAD: an int32 sum is int64


def knobs():
    return Knobs(seed=torch.tensor(7),           # BAD: int64
                 qps=torch.tensor(1.5))          # float32 lane: fine


def blank(msg: Msg):
    return msg._replace(seq=-1)                  # BAD: a Python int
