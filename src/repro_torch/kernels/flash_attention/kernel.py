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
elements (what its TMA tensor maps take); ``"f32"``, the f32-route kernel,
for everything else: float32 inputs (held to 2e-5, which bf16 products
cannot meet), wider or ragged head dims and unaligned views.  Its products
run on the tensor cores in split TF32 (``mma.sync``; each float32 operand
split into a TF32 hi and a lo, three products ``a_lo b_hi + a_hi b_lo +
a_hi b_hi`` with f32 sums, about float32's accuracy; a bf16 operand is
exact in TF32 and drops its lo term), which ``ref.flash_attention_ref(...,
split_tf32=True)`` and ``ref.chunked_fwd(..., split_tf32=True)`` emulate;
its tiles arrive by ``cp.async`` as the backward's f32 pair's do (below),
so it takes any base and any strides with the last dimension contiguous.
The tensor-core kernel is built at widths 64 and 128; a head dim below its
width (Zamba2's 80) is read with no copy, the columns past ``D`` arriving
as the tensor maps' zero fill (``csrc/flash_attention.cu``).  The scale
is ``D ** -0.5`` of the real ``D`` unless the caller gives one.

The CUDA source is compiled at first use into a shared library with a
plain C interface, loaded with ``ctypes`` (``repro_torch.kernels.build``:
``build/libflash_attention_<hash>.so`` beside this file).

``flash_attention_lse`` is the same forward on the same two routes with
two additions the training path needs: each row's log-sum-exp of its
scaled scores, float32 ``[B, HQ, S]``, and a causal mask ``k_pos <= q_pos
+ SK - S`` (aligned bottom-right as in the reference's
``chunked_attention``; the kernels take the diagonal offset, which
``flash_attention`` sets to 0).  On the CPU it runs ``ref.chunked_fwd``,
the reference's blockwise forward.  On a card a
causal call with ``S > SK`` raises: its first rows see no key, where the
reference's finite ``-1e30`` gives them the mean of V over a padded block.
``flash_attention_bwd`` is its backward, dq, dk, dv from ``(q, k, v, o,
lse, dO)``: three launches of ``csrc/flash_attention_bwd.cu`` (delta =
rowsum(dO o), then dk/dv, then dq; no atomics, ``D <= 128``) on a card,
``ref.chunked_bwd`` on the CPU.  Delta is a kernel of its own,
``flash_bwd_delta(o, do)`` (``ref.delta_ref`` on the CPU), whose loads
are as wide as ``delta_width`` finds both tensors allow.
``route_bwd(q, k, v, do)`` picks the
dk/dv and dq kernels as ``route`` picks the forward's: ``"mma"``, the
tensor-core pair (bf16 products with f32 sums, p rounded to bf16 for the
dv product and dS for the dk and dq products, which ``ref.chunked_bwd(...,
round_bf16=True)`` repeats), where ``route`` takes q, k and v and dO is
aligned as they are; ``"f32"``, the f32 pair, for everything else
(float32, ragged head dims, views TMA refuses): its products run on the
tensor cores in split TF32 (``mma.sync``; each float32 operand split
once, when its tile is staged, into a TF32 hi and a lo, three products
``a_lo b_hi + a_hi b_lo + a_hi b_hi`` with f32 sums, about float32's
accuracy; a bf16 operand is exact in TF32 and drops its lo term), which
``ref.chunked_bwd(..., split_tf32=True)`` emulates.  Its tiles arrive by
``cp.async`` (16-byte copies where a tensor's base and strides allow,
else 4-byte, else plain loads), so it takes any base and any strides
with the last dimension contiguous.  ``ops.ChunkedAttention`` ties the
forward and the backward into an autograd function.

Every wrapper raises a ``RuntimeError`` when grad mode is on and an input
requires grad (``build.refuse_grad``): the kernels write outputs with no
``grad_fn``, so the only way into them under grad is
``ops.ChunkedAttention``, whose backward is the backward kernels.  A
DTensor raises a ``TypeError`` (``build.refuse_dtensor``).  On the
``meta`` device (the dry-run's stand-ins: shapes, no data) a wrapper
returns its outputs' shapes and dtypes, as a custom op's fake kernel
does, and reports the kernel's work, its matrix FLOPs over the unmasked
(query, key) pairs and the bytes it reads and writes once each, to the
active step counter (``build.note_kernel``).

``LAUNCHES`` counts kernel launches: ``"flash_attention"`` every forward
launch, ``"flash_attention_mma"`` and ``"flash_attention_f32"`` those of
each route, ``"flash_bwd_delta"``, ``"flash_bwd_dkdv"`` and
``"flash_bwd_dq"`` each backward kernel's, ``"flash_bwd_dkdv_mma"``,
``"flash_bwd_dq_mma"``, ``"flash_bwd_dkdv_f32"`` and ``"flash_bwd_dq_f32"``
those of each backward route; only a launch of a CUDA kernel adds to
them.
"""
from __future__ import annotations

import ctypes
import pathlib

import numpy as np
import torch

from repro_torch.kernels.build import (
    CudaLibrary, note_kernel, refuse_dtensor, refuse_grad)
from repro_torch.kernels.flash_attention import ref

LAUNCHES = {"flash_attention": 0, "flash_attention_mma": 0,
            "flash_attention_f32": 0, "flash_bwd_delta": 0,
            "flash_bwd_dkdv": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkdv_mma": 0, "flash_bwd_dq_mma": 0,
            "flash_bwd_dkdv_f32": 0, "flash_bwd_dq_f32": 0}
MAX_HEAD_DIM = 256
MMA_MAX_HEAD_DIM = 128       # the tensor-core kernel's widest build
BWD_MAX_HEAD_DIM = 128       # the backward kernels' widest build
_DTYPES = (torch.bfloat16, torch.float32)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _declare(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = (
        [p] * 4 + [i] * 7 + [ll] * 12 + [ctypes.c_float, i, i, p, p])
    lib.flash_attention_launch.restype = i
    lib.flash_attention_mma_launch.argtypes = (
        [p] * 4 + [i] * 6 + [ll] * 12 + [ctypes.c_float, i, i, p, p])
    lib.flash_attention_mma_launch.restype = i


def _declare_bwd(lib) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_bwd_delta_launch.argtypes = (
        [p] * 3 + [i] * 5 + [ll] * 6 + [i, p])
    lib.flash_bwd_delta_launch.restype = i
    lib.flash_bwd_dkdv_launch.argtypes = (
        [p] * 8 + [i] * 7 + [p, ctypes.c_float, i, i, p])
    lib.flash_bwd_dkdv_launch.restype = i
    lib.flash_bwd_dq_launch.argtypes = (
        [p] * 7 + [i] * 7 + [p, ctypes.c_float, i, i, p])
    lib.flash_bwd_dq_launch.restype = i
    lib.flash_bwd_dkdv_mma_launch.argtypes = (
        [p] * 8 + [i] * 6 + [p, ctypes.c_float, i, i, p])
    lib.flash_bwd_dkdv_mma_launch.restype = i
    lib.flash_bwd_dq_mma_launch.argtypes = (
        [p] * 7 + [i] * 6 + [p, ctypes.c_float, i, i, p])
    lib.flash_bwd_dq_mma_launch.restype = i


_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_LIBRARY = CudaLibrary(_CSRC / "flash_attention.cu", "flash_attention",
                       _declare)
_BWD_LIBRARY = CudaLibrary(_CSRC / "flash_attention_bwd.cu",
                           "flash_attention_bwd", _declare_bwd)
build = _LIBRARY.build
build_bwd = _BWD_LIBRARY.build


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


def _tma_aligned(x) -> bool:
    """A 16-byte-aligned base and batch, head and row strides that are
    positive multiples of 8 elements: what a TMA tensor map takes."""
    return x.data_ptr() % 16 == 0 and all(st > 0 and st % 8 == 0
                                          for st in x.stride()[:3])


def route(q, k, v) -> str:
    """The kernel a CUDA launch of these (checked) inputs takes: "mma" or
    "f32" (see the module's docstring)."""
    D = q.shape[3]
    if q.dtype != torch.bfloat16 or D > MMA_MAX_HEAD_DIM or D % 8:
        return "f32"
    return "mma" if all(_tma_aligned(x) for x in (q, k, v)) else "f32"


def route_bwd(q, k, v, do) -> str:
    """The dk/dv and dq kernels a CUDA launch of the backward takes: "mma"
    where ``route`` takes q, k and v and dO is aligned as they are, else
    "f32"."""
    return "mma" if route(q, k, v) == "mma" and _tma_aligned(do) else "f32"


def _scale(D: int, scale) -> float:
    return (D ** -0.5) if scale is None else scale


def _forward(q, k, v, causal: bool, scale: float, offset: int, lse):
    """One launch of the route ``route`` picks; ``lse``: None, or the
    float32 ``[B, HQ, S]`` tensor the kernel writes."""
    dev = q.device
    B, HQ, S, D = q.shape
    HKV, SK = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    strides = [s for x in (q, k, v, o) for s in x.stride()[:3]]
    path = route(q, k, v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    tail = (float(scale), int(causal), int(offset),
            None if lse is None else lse.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = _LIBRARY.lib()
        if path == "mma":
            rc = lib.flash_attention_mma_launch(
                *ptrs, B, HQ, HKV, S, SK, D, *strides, *tail, stream)
        else:
            rc = lib.flash_attention_launch(
                *ptrs, int(q.dtype == torch.bfloat16), B, HQ, HKV, S, SK, D,
                *strides, *tail, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention ({path} route) launch failed: "
                           f"error {rc}")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention_{path}"] += 1
    return o


def _pairs(S: int, SK: int, causal: bool, offset: int) -> int:
    """The (query, key) pairs a mask leaves, per batch and head: row i
    sees the keys up to ``i + offset``."""
    if not causal:
        return S * SK
    return int(np.clip(np.arange(S) + offset + 1, 0, SK).sum())


def _nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def _meta_forward(name, q, k, v, causal: bool, offset: int, lse: bool):
    """The forward on meta tensors (module docstring): QK^T and PV over
    the visible pairs."""
    B, HQ, S, D = q.shape
    o = torch.empty_like(q)
    outs = (o,) + ((torch.empty((B, HQ, S), dtype=torch.float32,
                                device=q.device),) if lse else ())
    flops = 4.0 * B * HQ * D * _pairs(S, k.shape[2], causal, offset)
    note_kernel(name, flops, _nbytes(q, k, v, *outs))
    return outs if lse else o


def _cuda(name: str, dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """GQA attention, forward, causal (aligned top-left) unless
    ``causal=False``; see ``ref.py`` for the function.  Returns ``[B, HQ, S, D]`` in q's dtype."""
    refuse_dtensor("flash_attention", q, k, v)
    refuse_grad("flash_attention", q, k, v)
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type == "meta":
        return _meta_forward("flash_attention", q, k, v, causal, 0, False)
    _cuda("flash_attention", q.device)
    return _forward(q, k, v, causal, _scale(q.shape[3], scale), 0, None)


def flash_attention_lse(q, k, v, *, causal: bool = True, scale=None,
                        blocks=None):
    """The forward with each row's log-sum-exp: ``(o [B, HQ, S, D]`` in
    q's dtype, ``lse [B, HQ, S]`` float32), causal as ``k_pos <= q_pos +
    SK - S``.  ``blocks``: the ``(q, k)`` blocks of the CPU's plain
    version (default ``ref.default_blocks``)."""
    refuse_dtensor("flash_attention_lse", q, k, v)
    refuse_grad("flash_attention_lse", q, k, v)
    _check(q, k, v)
    B, HQ, S, D = q.shape
    SK = k.shape[2]
    scale = _scale(D, scale)
    if q.device.type == "cpu":
        qc, kc = blocks or ref.default_blocks(S, SK)
        return ref.chunked_fwd(q, k, v, causal=causal, scale=scale,
                               q_chunk=qc, k_chunk=kc)
    if q.device.type == "meta":
        return _meta_forward("flash_attention_lse", q, k, v, causal, SK - S,
                             True)
    _cuda("flash_attention_lse", q.device)
    if causal and S > SK:
        raise ValueError(
            f"flash_attention_lse: causal with S = {S} > SK = {SK} leaves "
            "the first rows no key; the reference's finite -1e30 gives "
            "them the mean of V over a padded block, which the kernel does "
            "not compute")
    lse = torch.empty((B, HQ, S), dtype=torch.float32, device=q.device)
    return _forward(q, k, v, causal, scale, SK - S, lse), lse


def delta_width(o, do) -> int:
    """The bytes a load of ``flash_bwd_delta``'s kernel reads: 16 (8 bf16
    or 4 float32) where the head dim and both tensors' bases and batch,
    head and row strides are multiples of 16 bytes, else 4 where they are
    multiples of 4, else one element."""
    e = o.element_size()
    for width in (16, 4):
        n = width // e
        if o.shape[3] % n == 0 and all(
                x.data_ptr() % width == 0 and all(
                    st % n == 0 for st in x.stride()[:3]) for x in (o, do)):
            return width
    return e


def flash_bwd_delta(o, do):
    """delta = rowsum(dO o) in float32, ``[B, HQ, S]`` contiguous, from o
    and dO ``[B, HQ, S, D]`` (one dtype, bf16 or float32, the last
    dimension contiguous): ``ref.delta_ref`` on the CPU, one launch of
    ``csrc/flash_attention_bwd.cu::flash_bwd_delta_kernel`` on a card,
    loads ``delta_width`` bytes wide."""
    refuse_dtensor("flash_bwd_delta", o, do)
    refuse_grad("flash_bwd_delta", o, do)
    if o.dim() != 4 or tuple(do.shape) != tuple(o.shape) or \
            do.dtype != o.dtype or o.dtype not in _DTYPES or \
            do.device != o.device:
        raise ValueError(f"flash_bwd_delta: o {tuple(o.shape)} {o.dtype} "
                         f"on {o.device} and do {tuple(do.shape)} "
                         f"{do.dtype} on {do.device} must be one [B, H, S, "
                         "D] bf16 or float32 shape on one device")
    B, HQ, S, D = o.shape
    if D > 1 and (o.stride(3) != 1 or do.stride(3) != 1):
        raise ValueError("flash_bwd_delta: the last dimension must be "
                         "contiguous")
    if o.device.type == "cpu":
        return ref.delta_ref(o, do)
    _cuda("flash_bwd_delta", o.device)
    delta = torch.empty((B, HQ, S), dtype=torch.float32, device=o.device)
    vec = delta_width(o, do) // o.element_size()
    with torch.cuda.device(o.device):
        rc = _BWD_LIBRARY.lib().flash_bwd_delta_launch(
            o.data_ptr(), do.data_ptr(), delta.data_ptr(),
            int(o.dtype == torch.bfloat16), B, HQ, S, D, *o.stride()[:3],
            *do.stride()[:3], vec,
            torch.cuda.current_stream(o.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_delta launch failed: error {rc}")
    LAUNCHES["flash_bwd_delta"] += 1
    return delta


def _check_bwd(q, k, v, o, lse, do) -> None:
    _check(q, k, v)
    B, HQ, S, D = q.shape
    for name, x in (("o", o), ("do", do)):
        if tuple(x.shape) != tuple(q.shape) or x.dtype != q.dtype or \
                x.device != q.device:
            raise ValueError(f"{name}: expected {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
        if x.stride(3) != 1 and D > 1:
            raise ValueError(f"{name}: the last dimension must be "
                             "contiguous")
    if tuple(lse.shape) != (B, HQ, S) or lse.dtype != torch.float32 or \
            lse.device != q.device:
        raise ValueError(f"lse: expected float32 {(B, HQ, S)} on "
                         f"{q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        scale=None, blocks=None):
    """The backward of ``flash_attention_lse``: ``(dq, dk, dv)`` in the
    inputs' dtypes and layouts from q, k, v, the forward's ``o`` and
    ``lse`` and the output's gradient ``do`` (q's shape, the last
    dimension contiguous); ``blocks`` as the forward's."""
    refuse_dtensor("flash_attention_bwd", q, k, v, o, lse, do)
    refuse_grad("flash_attention_bwd", q, k, v, o, lse, do)
    _check_bwd(q, k, v, o, lse, do)
    B, HQ, S, D = q.shape
    HKV, SK = k.shape[1], k.shape[2]
    scale = _scale(D, scale)
    if q.device.type == "cpu":
        qc, kc = blocks or ref.default_blocks(S, SK)
        return ref.chunked_bwd(q, k, v, o, lse, do, causal=causal,
                               scale=scale, q_chunk=qc, k_chunk=kc)
    if q.device.type == "meta":
        # seven products over the pairs, as both routes' kernels do: S
        # and dP in the dk/dv kernel and again in the dq kernel (no
        # atomics), then dV, dK and dQ
        grads = tuple(torch.empty_like(x) for x in (q, k, v))
        flops = 14.0 * B * HQ * D * _pairs(S, SK, causal, SK - S)
        note_kernel("flash_attention_bwd", flops,
                    _nbytes(q, k, v, o, lse, do, *grads))
        return grads
    _cuda("flash_attention_bwd", q.device)
    if D > BWD_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd: head dim {D} > "
                         f"{BWD_MAX_HEAD_DIM}")
    if causal and S > SK:
        raise ValueError(f"flash_attention_bwd: causal with S = {S} > SK = "
                         f"{SK}, as flash_attention_lse")
    lse = lse.contiguous()
    delta = flash_bwd_delta(o, do)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    path = route_bwd(q, k, v, do)
    is_bf16 = int(q.dtype == torch.bfloat16)
    strides = (ctypes.c_longlong * 21)(*[
        s for x in (q, k, v, do, dq, dk, dv) for s in x.stride()[:3]])
    tail = (ctypes.cast(strides, ctypes.c_void_p), float(scale), int(causal),
            SK - S)
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        lib = _BWD_LIBRARY.lib()
        # the f32 entry points take the dtype; the tensor-core ones are bf16
        if path == "mma":
            dkdv, dq_launch, dtype = (lib.flash_bwd_dkdv_mma_launch,
                                      lib.flash_bwd_dq_mma_launch, ())
        else:
            dkdv, dq_launch, dtype = (lib.flash_bwd_dkdv_launch,
                                      lib.flash_bwd_dq_launch, (is_bf16,))
        for name, launch in (
                ("flash_bwd_dkdv", lambda: dkdv(
                    *inputs, dk.data_ptr(), dv.data_ptr(), *dtype, B, HQ,
                    HKV, S, SK, D, *tail, stream)),
                ("flash_bwd_dq", lambda: dq_launch(
                    *inputs, dq.data_ptr(), *dtype, B, HQ, HKV, S, SK, D,
                    *tail, stream))):
            rc = launch()
            if rc != 0:
                raise RuntimeError(f"{name} launch failed ({path} route): "
                                   f"error {rc}")
            LAUNCHES[name] += 1
            LAUNCHES[f"{name}_{path}"] += 1
    return dq, dk, dv
