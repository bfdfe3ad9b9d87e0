"""Wrappers of the hand-written CUDA kv_engine kernels.

``cluster_read_engine`` and ``cluster_write_engine`` have the signatures
of the reference's Pallas kernels (``repro/kernels/kv_engine/kernel.py``)
with the leading "chain" axis read as any node axis ``N`` (the engine
passes its flattened ``[C * n]`` nodes).  ``bucketed_read_engine`` and
``bucketed_write_engine`` serve a flat batch resolved through the
partition map (query i on chain ``chains[i]`` at register ``slots[i]``);
their store leaves need contiguous inner dimensions only, so one replica
of a ``[C, n, ...]`` cluster store (``x[:, -1]``) is read and written in
place.  For tensors on the CPU the wrappers run the plain versions in
``ref.py``; for CUDA tensors they launch the kernels in
``csrc/kv_engine.cu`` or raise - there is no fallback.

The CUDA source is compiled at first use into a shared library with a
plain C interface, loaded with ``ctypes`` (``repro_torch.kernels.build``:
``build/libkv_engine_<hash>.so`` beside this file).  The kernels move a
value cell as one 16-byte word, so on CUDA they take ``W = 4`` (the
paper's 128-bit value) and 16-byte aligned value leaves only.

``LAUNCHES`` counts kernel launches per kernel name; only a launch of a
CUDA kernel adds to it.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.kv_engine import ref

LAUNCHES = {"kv_read": 0, "kv_write": 0, "kv_bucketed_read": 0,
            "kv_bucketed_write": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kv_read_launch.argtypes = [p] * 4 + [i] * 4 + [p] * 6
    lib.kv_read_launch.restype = i
    lib.kv_write_launch.argtypes = [p] * 8 + [i] * 4 + [p] * 3
    lib.kv_write_launch.restype = i
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
           free_lead: bool = False) -> None:
    """dtype, shape, device and layout of one argument: contiguous, or
    with ``free_lead`` contiguous in every dimension but the first."""
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {x.dtype}")
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


def cluster_read_engine(values, seqs, pending, keys):
    """Batched read lookup for every node in one launch.

    ``values [N, K, V, W]``, ``seqs [N, K, V]``, ``pending [N, K]``,
    ``keys [N, B]`` (int32).  Returns (clean_val [N, B, W], clean_seq
    [N, B], latest_val [N, B, W], latest_seq [N, B], pending_of_key
    [N, B]); a key outside ``[0, K)`` answers zeros.
    """
    N, K, V, W = values.shape
    B = keys.shape[1]
    dev = values.device
    for name, x, shape in (("values", values, (N, K, V, W)),
                           ("seqs", seqs, (N, K, V)),
                           ("pending", pending, (N, K)),
                           ("keys", keys, (N, B))):
        _check(name, x, shape, dev)
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
            lv.data_ptr(), ls.data_ptr(), pb.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "kv_read")
    LAUNCHES["kv_read"] += 1
    return cv, cs, lv, ls, pb


def cluster_write_engine(values, seqs, pending, keys, wvals, wseqs, active,
                         rank):
    """Append sequenced dirty versions for every node in one launch.

    Store leaves as for the read; ``keys``/``wseqs``/``active``/``rank``
    ``[N, B]`` and ``wvals [N, B, W]`` (int32).  The store leaves are
    updated in place (the reference kernel aliases them to its outputs)
    and returned with ``accepted [N, B]`` int32.
    """
    N, K, V, W = values.shape
    B = keys.shape[1]
    dev = values.device
    for name, x, shape in (("values", values, (N, K, V, W)),
                           ("seqs", seqs, (N, K, V)),
                           ("pending", pending, (N, K)),
                           ("keys", keys, (N, B)),
                           ("wvals", wvals, (N, B, W)),
                           ("wseqs", wseqs, (N, B)),
                           ("active", active, (N, B)),
                           ("rank", rank, (N, B))):
        _check(name, x, shape, dev)
    if dev.type == "cpu":
        return ref.cluster_write_engine_ref(values, seqs, pending, keys,
                                            wvals, wseqs, active, rank)
    if dev.type != "cuda":
        raise ValueError(f"kv_write: unsupported device {dev}")
    _check_cells("kv_write", W, (values, wvals))
    # the kernel's first pass copies each write's pending count here, its
    # second reads slots from it and counts into `pending`
    snap = torch.empty((N, B), dtype=torch.int32, device=dev)
    accepted = torch.empty((N, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().kv_write_launch(
            values.data_ptr(), seqs.data_ptr(), pending.data_ptr(),
            keys.data_ptr(), wvals.data_ptr(), wseqs.data_ptr(),
            active.data_ptr(), rank.data_ptr(), N, K, V, B,
            snap.data_ptr(), accepted.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "kv_write")
    LAUNCHES["kv_write"] += 1
    return values, seqs, pending, accepted


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
            pb.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
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
            snap.data_ptr(), accepted.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "kv_bucketed_write")
    LAUNCHES["kv_bucketed_write"] += 1
    return values, seqs, pending, accepted
