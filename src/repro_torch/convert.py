"""Carry state between the JAX package and the port.

The engine has no weights; what crosses over is state: a ``SimState``,
message schedules, partition maps and role tables.  These functions take
any NamedTuple-like object whose fields hold array-likes (the JAX
package's pytrees after ``np.asarray``, or numpy arrays) and build the
port's structure on a given device, field by field by name; ``to_numpy``
turns the port's structures back into numpy for comparison.  Nothing
here imports JAX: the caller hands over array-likes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.chain import SimState
from repro_torch.core.metrics import Metrics, ReplyLog
from repro_torch.core.store import Store
from repro_torch.core.txn import LockTable
from repro_torch.core.types import Msg, PartitionMap, Roles, resolve_device

_NESTED = {
    "stores": Store,
    "inbox": Msg,
    "locks": LockTable,
    "metrics": Metrics,
    "replies": ReplyLog,
    "roles": Roles,
    "pmap": PartitionMap,
}


def _tensor(x, device) -> torch.Tensor:
    # np.array copies: JAX hands out read-only buffers
    return torch.from_numpy(np.array(x)).to(device)


def from_arrays(cls, obj, device="cuda"):
    """Build the port's NamedTuple ``cls`` from ``obj``'s same-named
    fields (array-likes), on ``device``."""
    dev = resolve_device(device)
    return cls(**{f: _tensor(getattr(obj, f), dev) for f in cls._fields})


def state_from_arrays(state, device="cuda") -> SimState:
    """A port ``SimState`` from the reference's ``SimState`` (its
    ``wave``/``telemetry`` leaves, zero-size in the supported setting,
    have no counterpart and are not read)."""
    dev = resolve_device(device)
    parts = {f: from_arrays(cls, getattr(state, f), dev)
             for f, cls in _NESTED.items()}
    return SimState(**parts, t=_tensor(state.t, dev))


def to_numpy(tree):
    """The same NamedTuple structure with numpy leaves."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[to_numpy(x) for x in tree])
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
