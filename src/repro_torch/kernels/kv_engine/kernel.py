"""Wrappers of the hand-written CUDA kv_engine kernels.

``cluster_read_engine`` and ``cluster_write_engine`` have the signatures
of the reference's Pallas kernels (``repro/kernels/kv_engine/kernel.py``)
with the leading "chain" axis read as any node axis ``N`` (the engine
passes its flattened ``[C * n]`` nodes).  For tensors on the CPU they
run the plain versions in ``ref.py``; for CUDA tensors they launch the
kernels in ``csrc/kv_engine.cu`` or raise - there is no fallback.

The CUDA source is compiled at first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into a shared library with a plain C
interface, loaded with ``ctypes``.  The library lands in ``build/``
beside this file, named by a hash of the source, so an edited source is
rebuilt.  The kernels move a value cell as one 16-byte word, so on CUDA
they take ``W = 4`` (the paper's 128-bit value) and 16-byte aligned
value leaves only.

``LAUNCHES`` counts kernel launches per kernel name; only a launch of a
CUDA kernel adds to it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

from repro_torch.kernels.kv_engine import ref

HERE = pathlib.Path(__file__).resolve().parent
CSRC = HERE / "csrc" / "kv_engine.cu"
BUILD_DIR = HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {"kv_read": 0, "kv_write": 0}

_LIB = None
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the kv_engine kernels need the "
                       "CUDA toolkit to build")


def build() -> pathlib.Path:
    """Compile ``csrc/kv_engine.cu`` (if not built yet) and return the
    library's path."""
    src = CSRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libkv_engine_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.kv_read_launch.argtypes = [p] * 4 + [i] * 4 + [p] * 6
            lib.kv_read_launch.restype = i
            lib.kv_write_launch.argtypes = [p] * 8 + [i] * 4 + [p] * 3
            lib.kv_write_launch.restype = i
            _LIB = lib
    return _LIB


def _check(name: str, x: torch.Tensor, shape: tuple, device) -> None:
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_cells(name: str, W: int, cells) -> None:
    """The CUDA kernels' cell moves: W = 4 words, 16-byte aligned."""
    if W != 4:
        raise ValueError(f"{name}: the CUDA kernel moves W = 4 word cells, "
                         f"got W = {W}")
    for x in cells:
        if x.data_ptr() % 16:
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
