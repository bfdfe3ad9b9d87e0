"""Plain PyTorch versions of GQA attention, causal or not.

``attention_ref`` is the reference's ``ref.py::attention_ref``, the
``mha(impl="naive")`` path: dense softmax, GQA by repeating KV heads, the
causal mask ``tril(k=SK - S)`` (aligned bottom-right), float32 math, the
output cast to ``q.dtype``.

``flash_attention_ref`` is the plain version of the flash_attention
kernel: the function the reference's Pallas kernel computes
(``repro/kernels/flash_attention/kernel.py``).  Its causal mask is
``k_pos <= q_pos`` (aligned top-left) and keys at or past ``SK`` are
masked, with the finite ``-1e30``; scores, softmax statistics and the
weighted sum are float32 from the loaded inputs, and the output is
``acc / (l == 0 ? 1 : l)`` cast to ``q.dtype``.  Causal, the two agree
when ``S == SK``, which is all the decoders' prefill produces; non-causal
(the encoder-decoder's encoder and cross-attention, ``S != SK``) they
differ only in rounding.

``chunked_fwd`` and ``chunked_bwd`` are the reference's training
attention (``ops.py::_chunked_fwd_impl`` and ``_chunked_core_bwd``),
step for step: q and k/v padded to blocks of ``q_chunk`` x ``k_chunk``
(``default_blocks``: the reference's 512 x 1024, each cut to its
sequence); the mask ``k_pos < SK`` and, causal, ``k_pos <= q_pos + SK -
S`` (aligned bottom-right) with the finite ``-1e30``;
the forward scales q in its own dtype before the float32 upcast and
returns each row's log-sum-exp ``m + log(max(l, 1e-37))``; the backward
scales q after the upcast, gives padded q rows ``lse = +1e30`` (p = 0),
takes ``delta = rowsum(dO o)`` in float32 (``delta_ref``, the plain
version of ``kernel.flash_bwd_delta``), sums dk and dv over each KV
head's query heads in float32 and casts each gradient to its input's
dtype.  They are the CPU's plain versions of ``kernel.flash_attention_lse``
and ``kernel.flash_attention_bwd``.  ``chunked_bwd(..., round_bf16=True)``
makes the backward's tensor-core route's two roundings, and no other: p
rounded to bf16 as the dv product's operand, dS (formed from the float32
p) as the dk and dq products' operand; off, the default and the CPU's
route, it is the reference's step for step.  ``chunked_bwd(...,
split_tf32=True)`` forms every product as the f32 route's kernels do, in
split TF32 (``ssd_scan.ref.split_tf32_product``: each operand split into
a TF32-rounded hi and a lo read as TF32, ``a_lo b_hi + a_hi b_lo + a_hi
b_hi``), with q unscaled in its products and the scale applied to s and
dk after them, as the kernels apply it.  ``flash_attention_ref(...,
split_tf32=True)`` and ``chunked_fwd(..., split_tf32=True)`` form S and
P V as the forward's f32 route forms them, in the same split TF32, q
unscaled in S and the scale applied to S after it (an operand that is
exact in TF32, a bf16 input, has lo = 0: its term adds nothing).
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch.kernels.ssd_scan.ref import split_tf32_product

F32 = torch.float32
NEG_INF = -1e30
# the reference's chunked_attention blocks
Q_CHUNK, K_CHUNK = 512, 1024


def default_blocks(S: int, SK: int, q_chunk: int = Q_CHUNK,
                   k_chunk: int = K_CHUNK) -> tuple:
    """The ``(q, k)`` blocks of ``chunked_fwd``/``chunked_bwd`` for ``S``
    queries and ``SK`` keys: each chunk cut to its sequence."""
    return min(q_chunk, S), min(k_chunk, SK)


def _scale(D: int, scale):
    return (D ** -0.5) if scale is None else scale


def attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """q ``[B, HQ, S, D]``, k/v ``[B, HKV, SK, D]`` -> ``[B, HQ, S, D]``."""
    B, HQ, S, D = q.shape
    SK = k.shape[2]
    group = HQ // k.shape[1]
    kr = k.repeat_interleave(group, dim=1).to(F32)
    vr = v.repeat_interleave(group, dim=1).to(F32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), kr) * _scale(D, scale)
    if causal:
        mask = torch.ones((S, SK), dtype=torch.bool,
                          device=q.device).tril(diagonal=SK - S)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, scale=None,
                        split_tf32: bool = False):
    """The flash_attention kernel's function, computed densely: q
    ``[B, HQ, S, D]``, k/v ``[B, HKV, SK, D]`` (query head ``h`` reads KV
    head ``h // (HQ // HKV)``) -> ``[B, HQ, S, D]`` in ``q.dtype``;
    ``split_tf32``: both products in split TF32 (the module's
    docstring)."""
    B, HQ, S, D = q.shape
    HKV, SK = k.shape[1], k.shape[2]
    G = HQ // HKV
    qg = q.to(F32).reshape(B, HKV, G, S, D)
    if split_tf32:
        s = split_tf32_product(qg, k.to(F32)[:, :, None].transpose(-1, -2))
        s = s * _scale(D, scale)
    else:
        s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.to(F32)) * _scale(
            D, scale)
    if causal:
        q_pos = torch.arange(S, device=q.device)[:, None]
        k_pos = torch.arange(SK, device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if split_tf32:
        acc = split_tf32_product(p, v.to(F32)[:, :, None])
    else:
        acc = torch.einsum("bkgqt,bktd->bkgqd", p, v.to(F32))
    o = acc / torch.where(l == 0, 1.0, l)
    return o.reshape(B, HQ, S, D).to(q.dtype)


def _pad_blocks(q, k, v, qc: int, kc: int):
    S, SK = q.shape[2], k.shape[2]
    pad_q, pad_k = -S % qc, -SK % kc
    if pad_q:
        q = F.pad(q, (0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, pad_k))
    return q, k, v, S + pad_q, SK + pad_k


def _block_mask(qi, ki, qc, kc, S, SK, causal, device):
    q_pos = qi * qc + torch.arange(qc, device=device)[:, None]
    k_pos = ki * kc + torch.arange(kc, device=device)[None, :]
    m = k_pos < SK
    if causal:
        m = m & (k_pos <= q_pos + SK - S)
    return m


def chunked_fwd(q, k, v, *, causal: bool, scale: float, q_chunk: int,
                k_chunk: int, split_tf32: bool = False):
    """q ``[B, HQ, S, D]``, k/v ``[B, HKV, SK, D]`` -> (o ``[B, HQ, S,
    D]`` in q's dtype, lse ``[B, HQ, S]`` float32); ``split_tf32``: S and
    P V in split TF32, q unscaled in S (the module's docstring)."""
    B, HQ, S, D = q.shape
    HKV, SK = k.shape[1], k.shape[2]
    G = HQ // HKV
    qc, kc = q_chunk, k_chunk
    qp, kp, vp, Sp, SKp = _pad_blocks(q, k, v, qc, kc)
    qb = qp.reshape(B, HKV, G, Sp, D)
    if not split_tf32:
        qb = qb * scale                                # in q's dtype
    outs, lses = [], []
    for qi in range(Sp // qc):
        q32 = qb[:, :, :, qi * qc:(qi + 1) * qc].to(F32)
        m = torch.full((B, HKV, G, qc), NEG_INF, dtype=F32, device=q.device)
        l = torch.zeros((B, HKV, G, qc), dtype=F32, device=q.device)
        acc = torch.zeros((B, HKV, G, qc, D), dtype=F32, device=q.device)
        for ki in range(SKp // kc):
            k_blk = kp[:, :, ki * kc:(ki + 1) * kc].to(F32)
            v_blk = vp[:, :, ki * kc:(ki + 1) * kc].to(F32)
            if split_tf32:
                s = split_tf32_product(
                    q32, k_blk[:, :, None].transpose(-1, -2)) * scale
            else:
                s = torch.einsum("bhgqd,bhkd->bhgqk", q32, k_blk)
            msk = _block_mask(qi, ki, qc, kc, S, SK, causal, q.device)
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = (split_tf32_product(p, v_blk[:, :, None]) if split_tf32
                  else torch.einsum("bhgqk,bhkd->bhgqd", p, v_blk))
            acc = acc * alpha[..., None] + pv
            m = m_new
        outs.append((acc / l.clamp_min(1e-37)[..., None]).to(q.dtype))
        lses.append(m + torch.log(l.clamp_min(1e-37)))
    o = torch.cat(outs, dim=3).reshape(B, HQ, Sp, D)[:, :, :S]
    lse = torch.cat(lses, dim=3).reshape(B, HQ, Sp)[:, :, :S]
    return o, lse


def _window_sums(x, width: int = 32):
    """Sums over the last axis as the reference's XLA CPU program forms
    them: an axis longer than ``width`` is cut into windows of ``width``
    (zero padding split low and high, the low half the smaller), each
    summed in order, and the window sums summed the same way."""
    n = x.shape[-1]
    if n > width:
        pad = -n % width
        x = F.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(*x.shape[:-1], -1, width)
    acc = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return _window_sums(acc, width) if n > width else acc


def delta_ref(o, do):
    """delta = rowsum(dO o) in float32, ``[B, H, S]`` from o and dO ``[B,
    H, S, D]``: the reference's ``(do.astype(f32) * o.astype(f32)).sum(-1)``
    (``_chunked_core_bwd``), summed in its order (``_window_sums``), so
    the two agree bit for bit."""
    return _window_sums(do.to(F32) * o.to(F32))


def _bf16(x):
    return x.to(torch.bfloat16).to(F32)


def chunked_bwd(q, k, v, o, lse, do, *, causal: bool, scale: float,
                q_chunk: int, k_chunk: int, round_bf16: bool = False,
                split_tf32: bool = False):
    """The gradients ``(dq, dk, dv)`` of ``chunked_fwd``'s o, recomputed
    blockwise from ``(q, k, v, o, lse)`` and the output's gradient
    ``do``; ``round_bf16``: p and dS rounded to bf16 as product operands;
    ``split_tf32``: the products in split TF32 (see the module's
    docstring)."""
    if round_bf16 and split_tf32:
        raise ValueError("round_bf16 and split_tf32 are two routes' "
                         "arithmetic; pick one")
    rnd = _bf16 if round_bf16 else (lambda x: x)
    B, HQ, S, D = q.shape
    HKV, SK = k.shape[1], k.shape[2]
    G = HQ // HKV
    qc, kc = q_chunk, k_chunk
    qp, kp, vp, Sp, SKp = _pad_blocks(q, k, v, qc, kc)
    dop = F.pad(do, (0, 0, 0, Sp - S))
    op = F.pad(o, (0, 0, 0, Sp - S))
    # padded q rows get lse = +1e30, so p = exp(s - lse) == 0
    lsep = F.pad(lse.reshape(B, HKV, G, S), (0, Sp - S), value=-NEG_INF)
    # split: q unscaled in the products (the kernels scale s and dk)
    qs = qp.reshape(B, HKV, G, Sp, D).to(F32) * (1.0 if split_tf32
                                                  else scale)
    kb, vb = kp.to(F32), vp.to(F32)
    dob = dop.reshape(B, HKV, G, Sp, D).to(F32)
    delta = delta_ref(op, dop).reshape(B, HKV, G, Sp)
    dk = torch.zeros((B, HKV, SKp, D), dtype=F32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    for qi in range(Sp // qc):
        rows = slice(qi * qc, (qi + 1) * qc)
        q_i, do_i = qs[:, :, :, rows], dob[:, :, :, rows]
        lse_i, d_i = lsep[..., rows], delta[..., rows]
        dq_i = torch.zeros((B, HKV, G, qc, D), dtype=F32, device=q.device)
        for ki in range(SKp // kc):
            keys = slice(ki * kc, (ki + 1) * kc)
            k_j, v_j = kb[:, :, keys], vb[:, :, keys]
            msk = _block_mask(qi, ki, qc, kc, S, SK, causal, q.device)
            if split_tf32:
                dq_c, dk_c, dv_c = _split_block(q_i, k_j, v_j, do_i, lse_i,
                                                d_i, msk, scale)
                dq_i = dq_i + dq_c
                dk[:, :, keys] += dk_c
                dv[:, :, keys] += dv_c
                continue
            s = torch.einsum("bhgqd,bhkd->bhgqk", q_i, k_j)
            s = torch.where(msk, s, NEG_INF)
            p = torch.exp(s - lse_i[..., None])
            dv[:, :, keys] += torch.einsum("bhgqk,bhgqd->bhkd", rnd(p), do_i)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", do_i, v_j)
            ds = rnd(p * (dp - d_i[..., None]))
            dq_i = dq_i + torch.einsum("bhgqk,bhkd->bhgqd", ds, k_j)
            dk[:, :, keys] += torch.einsum("bhgqk,bhgqd->bhkd", ds, q_i)
        dqs.append(dq_i * scale)
    if split_tf32:
        dk = dk * scale
    dq = torch.cat(dqs, dim=3).reshape(B, HQ, Sp, D)[:, :, :S]
    return (dq.to(q.dtype), dk[:, :, :SK].to(k.dtype),
            dv[:, :, :SK].to(v.dtype))


def _split_block(q_i, k_j, v_j, do_i, lse_i, d_i, msk, scale: float):
    """One (q block, k block) of ``chunked_bwd(..., split_tf32=True)``:
    its dq, dk and dv terms, every product in split TF32, q unscaled
    (dk's term is scaled by the caller)."""
    prod = split_tf32_product
    kt, vt = k_j[:, :, None], v_j[:, :, None]           # [B, HKV, 1, k, D]
    s = prod(q_i, kt.transpose(-1, -2)) * scale
    s = torch.where(msk, s, NEG_INF)
    p = torch.exp(s - lse_i[..., None])
    dv = prod(p.transpose(-1, -2), do_i).sum(2)
    dp = prod(do_i, vt.transpose(-1, -2))
    ds = p * (dp - d_i[..., None])
    dq = prod(ds, kt)
    dk = prod(ds.transpose(-1, -2), q_i).sum(2)
    return dq, dk, dv
