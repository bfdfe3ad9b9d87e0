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
"""
from __future__ import annotations

import torch

F32 = torch.float32
NEG_INF = -1e30


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


def flash_attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """The flash_attention kernel's function, computed densely: q
    ``[B, HQ, S, D]``, k/v ``[B, HKV, SK, D]`` (query head ``h`` reads KV
    head ``h // (HQ // HKV)``) -> ``[B, HQ, S, D]`` in ``q.dtype``."""
    B, HQ, S, D = q.shape
    HKV, SK = k.shape[1], k.shape[2]
    G = HQ // HKV
    qg = q.to(F32).reshape(B, HKV, G, S, D)
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.to(F32)) * _scale(D, scale)
    if causal:
        q_pos = torch.arange(S, device=q.device)[:, None]
        k_pos = torch.arange(SK, device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgqt,bktd->bkgqd", p, v.to(F32))
    o = acc / torch.where(l == 0, 1.0, l)
    return o.reshape(B, HQ, S, D).to(q.dtype)
