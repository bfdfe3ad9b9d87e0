"""Wrappers of the hand-written CUDA ssd_scan kernels.

``ssd_scan`` has the signature of the reference's Pallas kernel
(``repro/kernels/ssd_scan/kernel.py``) without its interpret flag, and
takes ``h_final=True`` to return the final state as well: x ``[BH, L,
P]`` (bf16 or float32), dt ``[BH, L]``, A and D ``[BH]``, B and C ``[BH,
L, N]``.  ``ssd_scan_heads`` is the same scan on the model's layout
(the reference's ``ops.ssd`` arguments): x ``[B, L, H, P]``, dt ``[B, L,
H]``, A and D ``[H]``, B and C ``[B, L, N]`` shared by the heads.  It
hands the kernels x as it is (any strides, the last dimension
contiguous), B and C with a head stride of 0, and writes y ``[B, L, H,
P]`` directly, so none of the reference's transposes or broadcasts is
made.  dt, A, B, C and D are read as float32 (a float32 input is used as
it is); y has x's dtype, the final state is float32 ``[.., N, P]``.

On a card a scan is two launches (``csrc/ssd_scan.cu``'s header note has
the design): ``ssd_cb_kernel`` writes G = C B^T once per (batch, chunk)
into a float32 workspace this wrapper allocates (``[B, chunks, 64,
64]``, 4.2 MB at one Mamba2-1.3B layer's prefill), then
``ssd_scan_kernel``, one block of 4 warps per (batch, head) with the
state in registers, runs the scan with its products on the tensor cores
(``mma.sync`` TF32) in 3xTF32: each float32 operand split into a TF32
``hi`` and the rest ``lo``, and ``a_hi b_hi + a_hi b_lo + a_lo b_hi``.
Plain TF32 products would leave the final state about 3e-4 of its
magnitude off (the checks hold it to 1e-5); the split keeps it near
2e-7, about as accurate as float32 (``ref.split_tf32_product`` emulates
it).  ``chunk_cb`` is the first kernel alone: B and C ``[B, L, N]`` -> G
``[B, chunks, Q, Q]``.

The kernels take any ``L >= 1``: a ragged last chunk is handled inside
them, as the reference's ``ssd_chunked`` pads.  ``chunk`` (at most 64),
``P`` (at most 64) and ``N`` (at most 128) outside the kernels' tiles
raise.

Under grad mode an input that requires grad raises a ``RuntimeError``
(``build.refuse_grad``): the kernels have no backward, as the reference's
Pallas kernel has none; the model trains through ``impl="chunked"``.
For tensors on the CPU each wrapper runs its plain version
(``ref.ssd_chunked``, ``ref.chunk_cb``); for CUDA tensors it launches the
kernels or raises - there is no fallback.  The CUDA source is compiled at
first use into a shared library with a plain C interface, loaded with
``ctypes`` (``repro_torch.kernels.build``: ``build/libssd_scan_<hash>.so``
beside this file).

``LAUNCHES`` counts kernel launches by kernel (``ssd_cb``, ``ssd_scan``);
only a launch of a CUDA kernel adds to it.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.build import CudaLibrary, refuse_dtensor, refuse_grad
from repro_torch.kernels.ssd_scan import ref

DEFAULT_CHUNK = 64
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 64, 64, 128
LAUNCHES = {"ssd_cb": 0, "ssd_scan": 0}
TILE = 64                          # the kernels' chunk tile (G is TILE x TILE)
_DTYPES = (torch.bfloat16, torch.float32)
F32 = torch.float32


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_cb_launch.argtypes = [p] * 3 + [i] * 4 + [ll] * 4 + [p]
    lib.ssd_cb_launch.restype = i
    lib.ssd_scan_launch.argtypes = [p] * 9 + [i] * 7 + [ll] * 19 + [p]
    lib.ssd_scan_launch.restype = i


_LIBRARY = CudaLibrary(
    pathlib.Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu",
    "ssd_scan", _declare)
build = _LIBRARY.build


def _check(x, dt, A, B, C, D, chunk: int, shapes: dict) -> None:
    """Shapes (``shapes``: each argument's expected shape), types,
    devices and the sizes the kernel's tiles take."""
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C),
                    ("D", D)):
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: expected shape {shapes[name]}, got "
                             f"{tuple(t.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x: expected bf16 or float32, got {x.dtype}")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D)):
        if t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, x on {x.device}")
        if not t.is_floating_point():
            raise TypeError(f"{name}: expected a floating dtype, got "
                            f"{t.dtype}")
    L, P, N = x.shape[1], x.shape[-1], B.shape[-1]
    if L < 1:
        raise ValueError("empty sequence (L = 0)")
    if not 1 <= min(chunk, L) <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside [1, {MAX_CHUNK}]")
    if not 1 <= P <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {P} outside [1, {MAX_HEAD_DIM}]")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"state size {N} outside [1, {MAX_STATE}]")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"{name}: the last dimension must be "
                             "contiguous")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_cb(b3, c3, chunk: int):
    """G = C B^T per chunk of ``[Bz, L, N]`` views (the last dimension
    contiguous) -> the workspace ``[Bz, chunks, TILE, TILE]``."""
    Bz, L, N = b3.shape
    g = torch.empty((Bz, -(-L // chunk), TILE, TILE), dtype=F32,
                    device=b3.device)
    with torch.cuda.device(b3.device):
        rc = _LIBRARY.lib().ssd_cb_launch(
            b3.data_ptr(), c3.data_ptr(), g.data_ptr(), Bz, L, N, chunk,
            *b3.stride()[:2], *c3.stride()[:2], _stream(b3.device))
    if rc != 0:
        raise RuntimeError(f"ssd_cb launch failed: cudaError {rc}")
    LAUNCHES["ssd_cb"] += 1
    return g


def _launch(x4, dt3, a2, b4, c4, d2, y4, h, chunk: int) -> None:
    """Launch both kernels on ``[Bz, H, L, *]`` views (``dt3 [Bz, H, L]``,
    ``a2``/``d2 [Bz, H]``), any strides with the last dimension of x, B,
    C and y contiguous, B and C the same for every head (a head stride of
    0, or one head); ``h`` is None or a contiguous float32 ``[Bz, H, N,
    P]``."""
    Bz, H, L, P = x4.shape
    N = b4.shape[-1]
    chunk = min(chunk, L)
    assert H == 1 or b4.stride(1) == c4.stride(1) == 0
    g = _launch_cb(b4[:, 0], c4[:, 0], chunk)
    strides = [*x4.stride()[:3], *dt3.stride(), *a2.stride(),
               *b4.stride()[:3], *c4.stride()[:3], *d2.stride(),
               *y4.stride()[:3]]
    dev = x4.device
    with torch.cuda.device(dev):
        rc = _LIBRARY.lib().ssd_scan_launch(
            x4.data_ptr(), dt3.data_ptr(), a2.data_ptr(), b4.data_ptr(),
            c4.data_ptr(), d2.data_ptr(), g.data_ptr(), y4.data_ptr(),
            None if h is None else h.data_ptr(),
            int(x4.dtype == torch.bfloat16), Bz, H, L, P, N, chunk,
            *strides, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {rc}")
    LAUNCHES["ssd_scan"] += 1


def _device(x) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    return x.device.type


def ssd_scan(x, dt, A, B, C, D, *, chunk: int = DEFAULT_CHUNK,
             h_final: bool = False):
    """The reference kernel's signature: x ``[BH, L, P]``, dt ``[BH, L]``,
    A/D ``[BH]``, B/C ``[BH, L, N]`` -> y ``[BH, L, P]`` in x's dtype (and
    the final state ``[BH, N, P]`` float32 with ``h_final``)."""
    refuse_dtensor("ssd_scan", x, dt, A, B, C, D)
    refuse_grad("ssd_scan", x, dt, A, B, C, D)
    BH, L, P = x.shape
    N = B.shape[-1]
    _check(x, dt, A, B, C, D, chunk, {
        "x": (BH, L, P), "dt": (BH, L), "A": (BH,), "B": (BH, L, N),
        "C": (BH, L, N), "D": (BH,)})
    if _device(x) == "cpu":
        y, h = ref.ssd_chunked(x, dt, A, B, C, D, chunk=chunk)
        return (y, h) if h_final else y
    y = torch.empty((BH, L, P), dtype=x.dtype, device=x.device)
    h = (torch.empty((BH, N, P), dtype=F32, device=x.device)
         if h_final else None)
    Bf, Cf = B.to(F32), C.to(F32)
    _launch(x[:, None], dt.to(F32)[:, None], A.to(F32)[:, None],
            Bf[:, None], Cf[:, None], D.to(F32)[:, None], y[:, None],
            None if h is None else h[:, None], chunk)
    return (y, h) if h_final else y


def ssd_scan_heads(x, dt, A, B, C, D, *, chunk: int = DEFAULT_CHUNK,
                   h_final: bool = False):
    """The model's layout: x ``[B, L, H, P]``, dt ``[B, L, H]``, A/D
    ``[H]``, B/C ``[B, L, N]`` -> y ``[B, L, H, P]`` in x's dtype (and the
    final state ``[B, H, N, P]`` float32 with ``h_final``)."""
    refuse_dtensor("ssd_scan_heads", x, dt, A, B, C, D)
    refuse_grad("ssd_scan_heads", x, dt, A, B, C, D)
    Bz, L, H, P = x.shape
    N = B.shape[-1]
    _check(x, dt, A, B, C, D, chunk, {
        "x": (Bz, L, H, P), "dt": (Bz, L, H), "A": (H,), "B": (Bz, L, N),
        "C": (Bz, L, N), "D": (H,)})
    if _device(x) == "cpu":
        y, h = ref.unflatten_heads(*ref.ssd_chunked(
            *ref.flatten_heads(x, dt, A, B, C, D), chunk=chunk), Bz, H)
        return (y, h) if h_final else y
    y = torch.empty((Bz, L, H, P), dtype=x.dtype, device=x.device)
    h = (torch.empty((Bz, H, N, P), dtype=F32, device=x.device)
         if h_final else None)
    Bf, Cf = B.to(F32), C.to(F32)
    _launch(x.transpose(1, 2), dt.to(F32).transpose(1, 2),
            A.to(F32)[None].expand(Bz, H), Bf[:, None].expand(Bz, H, L, N),
            Cf[:, None].expand(Bz, H, L, N), D.to(F32)[None].expand(Bz, H),
            y.transpose(1, 2), h, chunk)
    return (y, h) if h_final else y


def chunk_cb(B, C, *, chunk: int = DEFAULT_CHUNK):
    """The first kernel alone: B and C ``[Bz, L, N]`` -> G ``[Bz, chunks,
    Q, Q]`` float32 with ``G[b, c, t, s] = C[b, cQ + t] . B[b, cQ + s]``,
    ``Q = min(chunk, L)``, rows past L zero."""
    refuse_dtensor("chunk_cb", B, C)
    refuse_grad("chunk_cb", B, C)
    Bz, L, N = B.shape
    if tuple(C.shape) != (Bz, L, N):
        raise ValueError(f"C: expected shape {(Bz, L, N)}, got "
                         f"{tuple(C.shape)}")
    if C.device != B.device:
        raise ValueError(f"C: on {C.device}, B on {B.device}")
    if L < 1 or not 1 <= min(chunk, L) <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside [1, {MAX_CHUNK}] or L = 0")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"state size {N} outside [1, {MAX_STATE}]")
    if _device(B) == "cpu":
        return ref.chunk_cb(B, C, chunk=chunk)
    Bf, Cf = B.to(F32), C.to(F32)
    for name, t in (("B", Bf), ("C", Cf)):
        if t.stride(-1) != 1 and N > 1:
            raise ValueError(f"{name}: the last dimension must be "
                             "contiguous")
    q = min(chunk, L)
    return _launch_cb(Bf, Cf, q)[..., :q, :q]
