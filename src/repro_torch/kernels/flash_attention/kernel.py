"""Wrapper of the hand-written CUDA flash_attention kernel.

``flash_attention`` has the signature of the reference's Pallas kernel
(``repro/kernels/flash_attention/kernel.py``) without its tile sizes and
interpret flag: q ``[B, HQ, S, D]`` and k/v ``[B, HKV, SK, D]``, bf16 or
float32, ``HQ`` a multiple of ``HKV``, ``D <= 256``.  Any strides are
taken as long as the last dimension is contiguous, so the transposed
``[B, S, H, D] -> [B, H, S, D]`` views of the model are read in place;
the output has q's layout.  For tensors on the CPU it runs the plain
version (``ref.flash_attention_ref``); for CUDA tensors it launches one
of the two kernels in ``csrc/flash_attention.cu`` or raises - there is no
fallback from one kernel to the other, nor to the plain version.

``route(q, k, v)`` picks the kernel: ``"mma"``, the tensor-core kernel
(bf16 products with f32 accumulation, p rounded to bf16 for p.v), for
bf16 inputs with ``D <= 128`` a multiple of 8 whose bases are 16-byte
aligned and whose batch, head and row strides are positive multiples of 8
elements (what its TMA tensor maps take); ``"f32"``, the f32-math kernel,
for everything else: float32 inputs (held to 2e-5, which bf16 products
cannot meet), wider or ragged head dims and unaligned views.  The
tensor-core kernel is built at widths 64 and 128; a head dim below its
width (Zamba2's 80) is read with no copy, the columns past ``D`` arriving
as the tensor maps' zero fill (``csrc/flash_attention.cu``).  The scale
is ``D ** -0.5`` of the real ``D`` unless the caller gives one.

The CUDA source is compiled at first use into a shared library with a
plain C interface, loaded with ``ctypes`` (``repro_torch.kernels.build``:
``build/libflash_attention_<hash>.so`` beside this file).

``LAUNCHES`` counts kernel launches: ``"flash_attention"`` every launch,
``"flash_attention_mma"`` and ``"flash_attention_f32"`` those of each
route; only a launch of a CUDA kernel adds to them.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.flash_attention import ref

LAUNCHES = {"flash_attention": 0, "flash_attention_mma": 0,
            "flash_attention_f32": 0}
MAX_HEAD_DIM = 256
MMA_MAX_HEAD_DIM = 128       # the tensor-core kernel's widest build
_DTYPES = (torch.bfloat16, torch.float32)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = (
        [p] * 4 + [i] * 7 + [ll] * 12 + [ctypes.c_float, i, p])
    lib.flash_attention_launch.restype = i
    lib.flash_attention_mma_launch.argtypes = (
        [p] * 4 + [i] * 6 + [ll] * 12 + [ctypes.c_float, i, p])
    lib.flash_attention_mma_launch.restype = i


_LIBRARY = CudaLibrary(
    pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    "flash_attention", _declare)
build = _LIBRARY.build


def _check(q, k, v) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dim() != 4:
            raise ValueError(f"{name}: expected [B, H, S, D], got "
                             f"{tuple(x.shape)}")
        if x.dtype != q.dtype or x.dtype not in _DTYPES:
            raise TypeError(f"{name}: expected bf16 or float32 like q, got "
                            f"{x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name}: on {x.device}, q on {q.device}")
        if x.stride(3) != 1 and x.shape[3] > 1:
            raise ValueError(f"{name}: the last dimension must be "
                             "contiguous")
    B, HQ, S, D = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != B or \
            k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    HKV, SK = k.shape[1], k.shape[2]
    if HKV < 1 or HQ % HKV:
        raise ValueError(f"HQ={HQ} is not a multiple of HKV={HKV}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside [1, {MAX_HEAD_DIM}]")
    if SK < 1:
        raise ValueError("no keys (SK = 0)")


def route(q, k, v) -> str:
    """The kernel a CUDA launch of these (checked) inputs takes: "mma" or
    "f32" (see the module's docstring)."""
    D = q.shape[3]
    if q.dtype != torch.bfloat16 or D > MMA_MAX_HEAD_DIM or D % 8:
        return "f32"
    for x in (q, k, v):
        if x.data_ptr() % 16 or any(st <= 0 or st % 8
                                    for st in x.stride()[:3]):
            return "f32"
    return "mma"


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """GQA attention, forward, causal (aligned top-left) unless
    ``causal=False``; see ``ref.py`` for the function.  Returns ``[B, HQ, S, D]`` in q's dtype."""
    _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    B, HQ, S, D = q.shape
    HKV, SK = k.shape[1], k.shape[2]
    scale = (D ** -0.5) if scale is None else scale
    o = torch.empty_like(q)
    strides = [s for x in (q, k, v, o) for s in x.stride()[:3]]
    path = route(q, k, v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = _LIBRARY.lib()
        if path == "mma":
            rc = lib.flash_attention_mma_launch(
                *ptrs, B, HQ, HKV, S, SK, D, *strides, float(scale),
                int(causal), stream)
        else:
            rc = lib.flash_attention_launch(
                *ptrs, int(q.dtype == torch.bfloat16), B, HQ, HKV, S, SK, D,
                *strides, float(scale), int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention ({path} route) launch failed: "
                           f"error {rc}")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention_{path}"] += 1
    return o
