"""Collectives over a chain group of ranks, and the launcher that starts
the ranks: the torch counterparts of the JAX collectives that
``ChainDist`` and ``serve/kv_cache.py`` run under ``shard_map``.

Rank layout: rank ``r`` is chain group ``r // n``, position ``r % n``.
``chain_group(n)`` makes one ``dist.new_group`` per chain group (every
rank creates all of them, in the same order) and returns this rank's as
a ``ChainGroup``; the collectives below take it where the reference
names a mesh axis:

* ``ppermute_next(x, group)`` - ``jax.lax.ppermute`` with the chain
  permutation ``[(i, i + 1)]``: position ``p`` sends to ``p + 1`` and
  receives from ``p - 1``; position 0, with no sender, gets zeros;
* ``all_gather_tiled(x, group)`` - ``all_gather(..., tiled=True)``:
  the positions' tensors concatenated along dim 0, in position order;
* ``psum(x, group)`` and ``broadcast_from(x, src, group)``;
* ``axis_index(group)`` - this rank's position.

On the gloo backend a CUDA tensor is staged through a pinned host copy
before the exchange and copied back after it (gloo's point-to-point
calls take host memory only), so on one card the ranks exchange through
host memory.  Byte payloads travel as ``uint8`` views, so any dtype
crosses.  ``pack_msg``/``unpack_msg`` turn a ``Msg`` into one int32
``[lanes, 11 + W]`` tensor and back, so a step costs one collective per
exchange, not one per leaf.  ``BYTES_SENT`` counts, per collective, the
bytes this rank hands to a direct exchange: a tensor sent to one peer
counts once, to ``n - 1`` peers ``n - 1`` times (a sum is counted as
every rank sending its tensor to every other).

``spawn_ranks(fn, world, ...)`` runs ``fn(rank, world, device, *args)``
in ``world`` processes (``torch.multiprocessing.spawn``) over a
``FileStore`` in a temporary directory, so no port is needed, each rank
on a card (``cuda:(rank % device_count)``) unless the caller passes
``device="cpu"``, with an
explicit process-group ``timeout``: a rank that raises or dies fails the
run, and a rank left waiting on it gives up after the timeout.  Each
rank's return value comes back to the caller, in rank order.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pathlib
import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch.core.types import I32, Msg, resolve_device

BYTES_SENT = {"ppermute": 0, "all_gather": 0, "psum": 0, "broadcast": 0}


def reset_bytes() -> None:
    for k in BYTES_SENT:
        BYTES_SENT[k] = 0


@dataclasses.dataclass(frozen=True)
class ChainGroup:
    """One chain group of ``n`` ranks: its process group, its members'
    global ranks in position order, and this rank's place in it."""

    pg: object
    ranks: tuple
    index: int       # chain group (rank // n)
    pos: int         # this rank's position (rank % n)
    stage: bool      # stage CUDA tensors through host memory (gloo)

    @property
    def n(self) -> int:
        return len(self.ranks)


_GROUPS: dict = {}


def chain_group(n: int) -> ChainGroup:
    """This rank's chain group of ``n`` ranks (``world`` a multiple of
    ``n``).  Every rank must call it with the same ``n`` at the same
    point: it creates every group's ``dist.new_group`` once, in order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    assert world % n == 0, f"world of {world} ranks is no multiple of {n}"
    if n not in _GROUPS:
        _GROUPS[n] = [dist.new_group(list(range(g * n, (g + 1) * n)))
                      for g in range(world // n)]
    g = rank // n
    return ChainGroup(
        pg=_GROUPS[n][g], ranks=tuple(range(g * n, (g + 1) * n)), index=g,
        pos=rank % n, stage=dist.get_backend() == "gloo")


def world_group() -> ChainGroup:
    """Every rank as one group (the default process group)."""
    world = dist.get_world_size()
    return ChainGroup(pg=dist.group.WORLD, ranks=tuple(range(world)),
                      index=0, pos=dist.get_rank(),
                      stage=dist.get_backend() == "gloo")


def axis_index(group: ChainGroup) -> int:
    return group.pos


# ---------------------------------------------------------------------------
# staging and byte views
# ---------------------------------------------------------------------------
def _wire(x: torch.Tensor, group: ChainGroup) -> torch.Tensor:
    """The tensor the backend exchanges: contiguous, and a pinned host
    copy of a CUDA tensor on gloo."""
    x = x.contiguous()
    if group.stage and x.is_cuda:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        return buf
    return x


def _back(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return buf.to(like.device) if buf.device != like.device else buf


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """A flat uint8 view of a contiguous tensor."""
    return x.reshape(-1).view(torch.uint8)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------
def ppermute_next(x: torch.Tensor, group: ChainGroup) -> torch.Tensor:
    """Shift ``x`` one position toward the chain's end: position ``p``
    returns what ``p - 1`` sent; position 0 returns zeros."""
    p, n = group.pos, group.n
    src = _wire(x, group)
    out = torch.zeros_like(src)
    ops = []
    if p + 1 < n:
        ops.append(dist.P2POp(dist.isend, _bytes(src), group.ranks[p + 1],
                              group.pg))
        BYTES_SENT["ppermute"] += _nbytes(x)
    if p > 0:
        ops.append(dist.P2POp(dist.irecv, _bytes(out), group.ranks[p - 1],
                              group.pg))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return _back(out, x)


def all_gather_tiled(x: torch.Tensor, group: ChainGroup) -> torch.Tensor:
    """Every position's ``x`` concatenated along dim 0, in position
    order (``jax.lax.all_gather(x, axis, axis=0, tiled=True)``)."""
    src = _wire(x, group)
    parts = [torch.empty_like(src) for _ in range(group.n)]
    dist.all_gather([_bytes(t) for t in parts], _bytes(src), group=group.pg)
    BYTES_SENT["all_gather"] += _nbytes(x) * (group.n - 1)
    return _back(torch.cat(parts, dim=0), x)


def psum(x: torch.Tensor, group: ChainGroup) -> torch.Tensor:
    """The sum of every position's ``x`` (``jax.lax.psum``)."""
    buf = _wire(x, group).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group.pg)
    BYTES_SENT["psum"] += _nbytes(x) * (group.n - 1)
    return _back(buf, x)


def broadcast_from(x: torch.Tensor, src: int,
                   group: ChainGroup) -> torch.Tensor:
    """Position ``src``'s ``x`` on every position."""
    buf = _wire(x, group)
    if group.pos != src:
        buf = torch.empty_like(buf)
    else:
        BYTES_SENT["broadcast"] += _nbytes(x) * (group.n - 1)
    dist.broadcast(_bytes(buf), group.ranks[src], group=group.pg)
    return _back(buf, x)


# ---------------------------------------------------------------------------
# Msg packing: 11 scalar lanes + value[W] as one int32 [lanes, 11 + W]
# ---------------------------------------------------------------------------
def pack_msg(msg: Msg) -> torch.Tensor:
    """``msg`` (any batch shape) as int32 ``[lanes, 11 + W]``, columns in
    field order with ``value``'s words in place."""
    cols = []
    for f in Msg._fields:
        x = getattr(msg, f).to(I32)
        cols.append(x.reshape(-1, x.shape[-1]) if f == "value"
                    else x.reshape(-1, 1))
    return torch.cat(cols, dim=1)


def unpack_msg(packed: torch.Tensor, shape) -> Msg:
    """The inverse of ``pack_msg``: a ``Msg`` of batch ``shape``."""
    shape = tuple(shape)
    W = packed.shape[1] - (len(Msg._fields) - 1)
    out, c = {}, 0
    for f in Msg._fields:
        if f == "value":
            out[f] = packed[:, c:c + W].reshape(shape + (W,))
            c += W
        else:
            out[f] = packed[:, c].reshape(shape)
            c += 1
    return Msg(**out)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def rank_device(rank: int, device) -> torch.device:
    """A rank's device: ``cuda:(rank % device_count)`` for a CUDA
    ``device``, else ``device`` itself."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("spawn_ranks: device='cuda' and no CUDA device "
                           "is available")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank, fn, world, backend, device, root, timeout, args):
    torch.set_num_threads(1)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{root}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    result = fn(rank, world, dev, *args)
    dist.barrier()
    dist.destroy_process_group()
    _GROUPS.clear()
    torch.save(result, pathlib.Path(root) / f"rank{rank}.pt")


def spawn_ranks(fn, world: int, *, backend: str = "gloo", device="cuda",
                timeout: float = 60.0, args: tuple = ()) -> list:
    """Run ``fn(rank, world, device, *args)`` on ``world`` ranks and
    return their results in rank order.  ``fn`` must be importable by
    the spawned processes (a module-level function).  The ranks run on
    CUDA unless ``device="cpu"``; with no card that is an error here,
    before any rank starts.  A rank's exception is raised here
    (``torch.multiprocessing.ProcessRaisedException``); the other ranks
    are stopped."""
    import torch.multiprocessing as mp

    resolve_device(device)
    root = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        mp.spawn(_rank_main, args=(fn, world, backend, str(device), root,
                                   timeout, args),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(root, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
