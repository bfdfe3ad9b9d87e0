"""Wrappers of the hand-written CUDA kv_engine kernels.

``cluster_read_engine`` and ``cluster_write_engine`` have the signatures
of the reference's Pallas kernels (``repro/kernels/kv_engine/kernel.py``)
with the leading "chain" axis read as any node axis ``N`` (the engine
passes its flattened ``[C * n]`` nodes); ``read_engine`` and
``write_engine`` are their one-chain slices.  ``cluster_read_decide``
and ``cluster_write_append`` launch the same two kernels in their ops
mode: a node step's whole read (the key resolution and the NetCRAQ
decision) or its whole dirty append (the key resolution and the
within-batch rank), one launch each, on the inbox's tensors as they
come.  ``bucketed_read_engine`` and ``bucketed_write_engine`` serve a
flat batch resolved through the partition map (query i on chain
``chains[i]`` at register ``slots[i]``); their store leaves need
contiguous inner dimensions only, so one replica of a ``[C, n, ...]``
cluster store (``x[:, -1]``) is read and written in place.  For tensors
on the CPU the wrappers run the plain versions in ``ref.py``; for CUDA
tensors they launch the kernels in ``csrc/kv_engine.cu`` or raise -
there is no fallback.

The CUDA source is compiled at first use into a shared library with a
plain C interface, loaded with ``ctypes`` (``repro_torch.kernels.build``:
``build/libkv_engine_<hash>.so`` beside this file).  The kernels move a
value cell as one 16-byte word, so on CUDA they take ``W = 4`` (the
paper's 128-bit value) and 16-byte aligned value leaves only.  An append
stages its batch in one block's shared memory, so on CUDA a batch holds
at most ``WRITE_MAX_BATCH`` lanes per node.

``LAUNCHES`` counts kernel launches per kernel name (both modes of a
kernel under its name); only a launch of a CUDA kernel adds to it.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.kv_engine import ref

LAUNCHES = {"kv_read": 0, "kv_write": 0, "kv_bucketed_read": 0,
            "kv_bucketed_write": 0}


# An append block's shared memory: 17 bytes a lane (kv_engine.cu,
# kWriteSmemPerLane) and 128 of its own within the 232,448 bytes a block
# may take on sm_90.
WRITE_MAX_BATCH = (232448 - 128) // 17


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kv_read_launch.argtypes = [p] * 4 + [i] * 4 + [p] * 6
    lib.kv_read_launch.restype = i
    lib.kv_read_decide_launch.argtypes = [p] * 5 + [i] * 5 + [p] * 4
    lib.kv_read_decide_launch.restype = i
    lib.kv_write_launch.argtypes = [p] * 8 + [i] * 4 + [p] * 2
    lib.kv_write_launch.restype = i
    lib.kv_append_launch.argtypes = [p] * 7 + [i] * 4 + [p] * 2
    lib.kv_append_launch.restype = i
    lib.kv_empty_launch.argtypes = [i, i, p]
    lib.kv_empty_launch.restype = i
    lib.kv_bucketed_read_launch.argtypes = (
        [p] * 5 + [i] * 4 + [ll] * 3 + [p] * 6)
    lib.kv_bucketed_read_launch.restype = i
    lib.kv_bucketed_write_launch.argtypes = (
        [p] * 9 + [i] * 4 + [ll] * 3 + [p] * 3)
    lib.kv_bucketed_write_launch.restype = i


_LIBRARY = CudaLibrary(
    pathlib.Path(__file__).resolve().parent / "csrc" / "kv_engine.cu",
    "kv_engine", _declare)
build = _LIBRARY.build
_lib = _LIBRARY.lib


def _check(name: str, x: torch.Tensor, shape: tuple, device,
           free_lead: bool = False, dtype=torch.int32) -> None:
    """dtype, shape, device and layout of one argument: contiguous, or
    with ``free_lead`` contiguous in every dimension but the first."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not free_lead:
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        return
    inner = x[0]
    if not inner.is_contiguous() or (
            x.shape[0] > 1 and x.stride(0) < inner.numel()):
        raise ValueError(f"{name}: must be contiguous past its first "
                         "dimension, with rows that do not overlap")


def _check_cells(name: str, W: int, cells) -> None:
    """The CUDA kernels' cell moves: W = 4 words, 16-byte aligned (every
    row of a strided leaf too)."""
    if W != 4:
        raise ValueError(f"{name}: the CUDA kernel moves W = 4 word cells, "
                         f"got W = {W}")
    for x in cells:
        if x.data_ptr() % 16 or x.stride(0) % 4:
            raise ValueError(f"{name}: value cells must be 16-byte aligned")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_batch(name: str, B: int) -> None:
    if B > WRITE_MAX_BATCH:
        raise ValueError(f"{name}: a batch of {B} lanes per node does not "
                         f"fit one block's shared memory (at most "
                         f"{WRITE_MAX_BATCH})")


def _node_checks(values, seqs, pending, keys, batch=()):
    """Checks of a per-node call: contiguous store leaves, ``keys
    [N, B]`` and batch leaves ``(name, tensor, trailing shape, dtype)``
    of ``[N, B, ...]``."""
    N, K, V, W = values.shape
    B = keys.shape[1]
    dev = values.device
    for name, x, shape in (("values", values, (N, K, V, W)),
                           ("seqs", seqs, (N, K, V)),
                           ("pending", pending, (N, K)),
                           ("keys", keys, (N, B))):
        _check(name, x, shape, dev)
    for name, x, tail, dtype in batch:
        _check(name, x, (N, B) + tail, dev, dtype=dtype)
    return N, K, V, W, B, dev


def cluster_read_engine(values, seqs, pending, keys):
    """Batched read lookup for every node in one launch.

    ``values [N, K, V, W]``, ``seqs [N, K, V]``, ``pending [N, K]``,
    ``keys [N, B]`` (int32).  Returns (clean_val [N, B, W], clean_seq
    [N, B], latest_val [N, B, W], latest_seq [N, B], pending_of_key
    [N, B]); a key outside ``[0, K)`` answers zeros.
    """
    N, K, V, W, B, dev = _node_checks(values, seqs, pending, keys)
    if dev.type == "cpu":
        return ref.cluster_read_engine_ref(values, seqs, pending, keys)
    if dev.type != "cuda":
        raise ValueError(f"kv_read: unsupported device {dev}")
    cv = torch.empty((N, B, W), dtype=torch.int32, device=dev)
    lv = torch.empty((N, B, W), dtype=torch.int32, device=dev)
    _check_cells("kv_read", W, (values, cv, lv))
    cs, ls, pb = (torch.empty((N, B), dtype=torch.int32, device=dev)
                  for _ in range(3))
    with torch.cuda.device(dev):
        rc = _lib().kv_read_launch(
            values.data_ptr(), seqs.data_ptr(), pending.data_ptr(),
            keys.data_ptr(), N, K, V, B, cv.data_ptr(), cs.data_ptr(),
            lv.data_ptr(), ls.data_ptr(), pb.data_ptr(), _stream(dev))
    _raise_on(rc, "kv_read")
    LAUNCHES["kv_read"] += 1
    return cv, cs, lv, ls, pb


def cluster_read_decide(values, seqs, pending, keys, is_tail=False):
    """A node step's read for every node in one launch (the read kernel's
    ops mode).

    Store leaves as for ``cluster_read_engine``; ``keys [N, B]`` int32 as
    the inbox carries them; ``is_tail`` a bool or an ``[N]`` bool tensor.
    A key reads the register the reference store's gather clamps it to
    (wrapped once if negative, then clamped into ``[0, K)``).  Returns
    (reply_val [N, B, W], reply_seq [N, B], decision [N, B]) int32:
    decision 0 for a clean register (reply: cell 0), 1 for a dirty one
    at a tail node (reply: the latest cell), 2 for a dirty one elsewhere
    (reply: cell 0; the read goes on to the tail).
    """
    N, K, V, W, B, dev = _node_checks(values, seqs, pending, keys)
    per_node = isinstance(is_tail, torch.Tensor)
    if per_node:
        _check("is_tail", is_tail, (N,), dev, dtype=torch.bool)
    if dev.type == "cpu":
        return ref.cluster_read_decide_ref(values, seqs, pending, keys,
                                           is_tail)
    if dev.type != "cuda":
        raise ValueError(f"kv_read: unsupported device {dev}")
    rv = torch.empty((N, B, W), dtype=torch.int32, device=dev)
    _check_cells("kv_read", W, (values, rv))
    rs, dec = (torch.empty((N, B), dtype=torch.int32, device=dev)
               for _ in range(2))
    with torch.cuda.device(dev):
        rc = _lib().kv_read_decide_launch(
            values.data_ptr(), seqs.data_ptr(), pending.data_ptr(),
            keys.data_ptr(), is_tail.data_ptr() if per_node else None,
            0 if per_node else int(bool(is_tail)), N, K, V, B,
            rv.data_ptr(), rs.data_ptr(), dec.data_ptr(), _stream(dev))
    _raise_on(rc, "kv_read")
    LAUNCHES["kv_read"] += 1
    return rv, rs, dec


def read_engine(values, seqs, pending, keys):
    """One chain's read lookup: the one-node slice of
    ``cluster_read_engine`` (``values [K, V, W]``, ``seqs [K, V]``,
    ``pending [K]``, ``keys [B]``)."""
    outs = cluster_read_engine(values[None], seqs[None], pending[None],
                               keys[None])
    return tuple(o[0] for o in outs)


def cluster_write_engine(values, seqs, pending, keys, wvals, wseqs, active,
                         rank):
    """Append sequenced dirty versions for every node in one launch.

    Store leaves as for the read; ``keys``/``wseqs``/``active``/``rank``
    ``[N, B]`` and ``wvals [N, B, W]`` (int32).  The store leaves are
    updated in place (the reference kernel aliases them to its outputs)
    and returned with ``accepted [N, B]`` int32.
    """
    W = values.shape[3]
    N, K, V, W, B, dev = _node_checks(
        values, seqs, pending, keys,
        (("wvals", wvals, (W,), torch.int32),
         ("wseqs", wseqs, (), torch.int32),
         ("active", active, (), torch.int32),
         ("rank", rank, (), torch.int32)))
    if dev.type == "cpu":
        return ref.cluster_write_engine_ref(values, seqs, pending, keys,
                                            wvals, wseqs, active, rank)
    if dev.type != "cuda":
        raise ValueError(f"kv_write: unsupported device {dev}")
    _check_cells("kv_write", W, (values, wvals))
    _check_batch("kv_write", B)
    accepted = torch.empty((N, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().kv_write_launch(
            values.data_ptr(), seqs.data_ptr(), pending.data_ptr(),
            keys.data_ptr(), wvals.data_ptr(), wseqs.data_ptr(),
            active.data_ptr(), rank.data_ptr(), N, K, V, B,
            accepted.data_ptr(), _stream(dev))
    _raise_on(rc, "kv_write")
    LAUNCHES["kv_write"] += 1
    return values, seqs, pending, accepted


def cluster_write_append(values, seqs, pending, keys, wvals, wseqs, active,
                         dense_rank: bool = False):
    """A node step's dirty appends for every node in one launch (the
    write kernel's ops mode, which ranks the batch itself).

    Store leaves as for the read; ``keys``/``wseqs [N, B]`` and ``wvals
    [N, B, W]`` int32 and ``active [N, B]`` bool, as the inbox carries
    them.  As the reference store's ``append_dirty``: an active write
    ranks among the earlier active writes of its row with the same key,
    takes cell ``pending + 1 + rank`` with ``pending`` read before any
    write lands at the register the gather clamps its key to, and is
    accepted iff that cell is at most ``V - 1``; it lands where the
    scatter puts its key (wrapped once if negative, else nowhere).  The
    store leaves are edited in place and returned with ``accepted
    [N, B]`` bool.  ``dense_rank`` picks the plain version's rank
    algorithm; both give the rank the kernel takes in its block.
    """
    W = values.shape[3]
    N, K, V, W, B, dev = _node_checks(
        values, seqs, pending, keys,
        (("wvals", wvals, (W,), torch.int32),
         ("wseqs", wseqs, (), torch.int32),
         ("active", active, (), torch.bool)))
    if dev.type == "cpu":
        return ref.cluster_write_append_ref(values, seqs, pending, keys,
                                            wvals, wseqs, active,
                                            dense_rank=dense_rank)
    if dev.type != "cuda":
        raise ValueError(f"kv_write: unsupported device {dev}")
    _check_cells("kv_write", W, (values, wvals))
    _check_batch("kv_write", B)
    accepted = torch.empty((N, B), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().kv_append_launch(
            values.data_ptr(), seqs.data_ptr(), pending.data_ptr(),
            keys.data_ptr(), wvals.data_ptr(), wseqs.data_ptr(),
            active.data_ptr(), N, K, V, B, accepted.data_ptr(),
            _stream(dev))
    _raise_on(rc, "kv_write")
    LAUNCHES["kv_write"] += 1
    return values, seqs, pending, accepted


def write_engine(values, seqs, pending, keys, wvals, wseqs, active, rank):
    """One chain's append: the one-node slice of ``cluster_write_engine``
    (store leaves ``[K, ...]``, edited in place; batch leaves ``[B]`` and
    ``wvals [B, W]``)."""
    outs = cluster_write_engine(values[None], seqs[None], pending[None],
                                keys[None], wvals[None], wseqs[None],
                                active[None], rank[None])
    return tuple(o[0] for o in outs)


def empty_kernel(blocks: int, threads: int, device="cuda") -> None:
    """Launch an empty kernel of ``blocks`` x ``threads`` on ``device``'s
    current stream: the device time of a launch that does nothing, the
    floor under the per-node kernels.  Counted nowhere."""
    dev = torch.device(device)
    with torch.cuda.device(dev):
        _raise_on(_lib().kv_empty_launch(blocks, threads, _stream(dev)),
                  "kv_empty")


def _store_checks(values, seqs, pending, batch):
    """Checks of a bucketed call: store leaves with a free chain stride,
    flat batch leaves ``(name, tensor, trailing shape)``."""
    C, K, V, W = values.shape
    B = batch[0][1].shape[0]
    dev = values.device
    for name, x, shape in (("values", values, (C, K, V, W)),
                           ("seqs", seqs, (C, K, V)),
                           ("pending", pending, (C, K))):
        _check(name, x, shape, dev, free_lead=True)
    for name, x, tail in batch:
        _check(name, x, (B,) + tail, dev)
    return C, K, V, W, B, dev


def bucketed_read_engine(values, seqs, pending, slots, chains):
    """Flat read lookup through the partition map in one launch.

    ``values [C, K, V, W]``, ``seqs [C, K, V]``, ``pending [C, K]`` (inner
    dimensions contiguous, any chain stride); ``slots``/``chains [B]``
    (int32).  Returns (clean_val [B, W], clean_seq [B], latest_val
    [B, W], latest_seq [B], pending_of_key [B]); a query whose chain lies
    outside ``[0, C)`` (parked, -1) or whose slot lies outside ``[0, K)``
    answers zeros.
    """
    C, K, V, W, B, dev = _store_checks(
        values, seqs, pending, (("slots", slots, ()),
                                ("chains", chains, ())))
    if dev.type == "cpu":
        return ref.bucketed_read_engine_ref(values, seqs, pending, slots,
                                            chains)
    if dev.type != "cuda":
        raise ValueError(f"kv_bucketed_read: unsupported device {dev}")
    cv = torch.empty((B, W), dtype=torch.int32, device=dev)
    lv = torch.empty((B, W), dtype=torch.int32, device=dev)
    _check_cells("kv_bucketed_read", W, (values, cv, lv))
    cs, ls, pb = (torch.empty((B,), dtype=torch.int32, device=dev)
                  for _ in range(3))
    with torch.cuda.device(dev):
        rc = _lib().kv_bucketed_read_launch(
            values.data_ptr(), seqs.data_ptr(), pending.data_ptr(),
            slots.data_ptr(), chains.data_ptr(), C, K, V, B,
            values.stride(0), seqs.stride(0), pending.stride(0),
            cv.data_ptr(), cs.data_ptr(), lv.data_ptr(), ls.data_ptr(),
            pb.data_ptr(), _stream(dev))
    _raise_on(rc, "kv_bucketed_read")
    LAUNCHES["kv_bucketed_read"] += 1
    return cv, cs, lv, ls, pb


def bucketed_write_engine(values, seqs, pending, slots, chains, wvals,
                          wseqs, active, rank):
    """Flat append through the partition map in one launch: entry i lands
    at cell ``pending + 1 + rank[i]`` of register ``slots[i]`` of chain
    ``chains[i]``, accepted iff ``active``, the chain lies in ``[0, C)``,
    the slot in ``[0, K)`` and the cell at most ``V - 1``; ``pending`` is
    read before any write lands.

    Store leaves as for the read (edited in place, as the reference
    kernel aliases them to its outputs); ``slots``/``chains``/``wseqs``/
    ``active``/``rank [B]`` and ``wvals [B, W]`` (int32).  Returns the
    store leaves and ``accepted [B]`` int32.
    """
    W = values.shape[3]
    C, K, V, W, B, dev = _store_checks(
        values, seqs, pending, (("slots", slots, ()), ("chains", chains, ()),
                                ("wvals", wvals, (W,)), ("wseqs", wseqs, ()),
                                ("active", active, ()), ("rank", rank, ())))
    if dev.type == "cpu":
        return ref.bucketed_write_engine_ref(values, seqs, pending, slots,
                                             chains, wvals, wseqs, active,
                                             rank)
    if dev.type != "cuda":
        raise ValueError(f"kv_bucketed_write: unsupported device {dev}")
    _check_cells("kv_bucketed_write", W, (values, wvals))
    # the first pass copies each write's pending count here, the second
    # reads slots from it and counts into `pending`
    snap = torch.empty((B,), dtype=torch.int32, device=dev)
    accepted = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().kv_bucketed_write_launch(
            values.data_ptr(), seqs.data_ptr(), pending.data_ptr(),
            slots.data_ptr(), chains.data_ptr(), wvals.data_ptr(),
            wseqs.data_ptr(), active.data_ptr(), rank.data_ptr(), C, K, V, B,
            values.stride(0), seqs.stride(0), pending.stride(0),
            snap.data_ptr(), accepted.data_ptr(), _stream(dev))
    _raise_on(rc, "kv_bucketed_write")
    LAUNCHES["kv_bucketed_write"] += 1
    return values, seqs, pending, accepted
