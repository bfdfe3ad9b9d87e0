"""Mamba-2 mixer (SSD): full-sequence scan and O(1)-state decode (the
port's copy of ``repro/models/mamba2.py``).

Layout follows the Mamba-2 block: in_proj -> (z | x | B | C | dt), a
short depthwise causal conv over (x, B, C), SiLU, the SSD core, a gated
RMSNorm, out_proj.  Decode state: ``{"conv": [B, K-1, conv_ch],
"ssm": [B, H, N, P]}``; ``mamba_decode_step`` updates it in place.

Routing of the SSD core, and how it differs from the reference.  The
reference's ``mamba_apply`` takes ``impl="pallas"`` only when
``use_kernel=True``, which no caller passes, and its prefill branch
(``return_state=True``) always takes ``impl="chunked"``; so no model
path of the JAX package reaches its ssd_scan kernel.  Here
``use_kernel=True`` takes ``impl="pallas"`` in both branches, with the
final state emitted by the kernel (``ssd(impl="pallas",
return_state=True)`` is the reference's own combination: the kernel's y
and ``ssd_chunked``'s final state, the same function).  The model passes
``use_kernel = (x.device.type == "cuda")``, so on a card the SSD core
runs on the hand-written kernel and on the CPU it takes the reference's
choice, ``impl="chunked"``.  This is a difference of route, not of
function.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.distributed.sharding import shard
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import layers as L

F32 = torch.float32


def _dims(cfg: ArchConfig):
    di = cfg.d_inner
    H = cfg.ssm_heads
    N = cfg.ssm_state
    P = cfg.ssm_headdim
    conv_ch = di + 2 * N          # the conv runs over (x, B, C)
    return di, H, N, P, conv_ch


def mamba_init(gen: torch.Generator, cfg: ArchConfig, device):
    """Random parameters from ``gen`` (drawn on the generator's device),
    with the reference's names, shapes and distributions."""
    d = cfg.d_model
    di, H, N, P, conv_ch = _dims(cfg)
    dt = cfg.pdtype()
    d_in_proj = 2 * di + 2 * N + H          # z, x, B, C, dt
    lo, hi = math.log(0.001), math.log(0.1)
    conv_w = torch.randn((cfg.ssm_conv, conv_ch), generator=gen, dtype=dt,
                         device=gen.device)
    dt_bias = torch.rand((H,), generator=gen, dtype=dt, device=gen.device)
    return L.ParamTree({
        "in_proj": L.dense_init(gen, d, d_in_proj, dtype=dt, device=device),
        "out_proj": L.dense_init(gen, di, d, dtype=dt, device=device),
        "conv_w": (conv_w * 0.2).to(device),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=F32,
                                          device=device)).to(dt),
        "D": torch.ones((H,), dtype=dt, device=device),
        "dt_bias": (dt_bias * (hi - lo) + lo).to(device),
        "norm": L.rmsnorm_init(di, dt, device),
    })


def _split_proj(zxbcdt: torch.Tensor, cfg: ArchConfig):
    di, H, N, P, _ = _dims(cfg)
    return torch.split(zxbcdt, [di, di, N, N, H], dim=-1)


def _silu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.silu: x * sigmoid(x), rounded op by op
    return x * torch.sigmoid(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0); torch's softplus turns into the
    # identity above its threshold
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv over ``[B, S, Ch]`` with kernel ``[K, Ch]``,
    accumulated tap by tap in ``seq``'s dtype as the reference does."""
    K, S = w.shape[0], seq.shape[1]
    pad = F.pad(seq, (0, 0, K - 1, 0))
    out = torch.zeros_like(seq)
    for i in range(K):
        out = out + pad[:, i: i + S, :] * w[i][None, None, :]
    return out + b[None, None, :]


def _ssd_inputs(p, dtp: torch.Tensor):
    """dt (softplus of dt + bias) and A = -exp(A_log), in float32."""
    dt_s = _softplus(dtp.to(F32) + p["dt_bias"].to(F32))
    return dt_s, -torch.exp(p["A_log"].to(F32))


def mamba_apply(p, hidden: torch.Tensor, cfg: ArchConfig, *,
                use_kernel: bool = False, return_state: bool = False):
    """Full-sequence mixer: ``[B, S, d] -> [B, S, d]`` (with the final
    decode state ``{"conv", "ssm"}`` under ``return_state``, for the
    prefill cache).  ``use_kernel`` routes the SSD core to the ssd_scan
    kernel (module docstring)."""
    Bsz, S, _ = hidden.shape
    di, H, N, P, conv_ch = _dims(cfg)
    cd = cfg.cdtype()

    zxbcdt = L.dense(p["in_proj"], hidden, compute_dtype=cd)
    z, _, _, _, dtp = _split_proj(zxbcdt, cfg)
    xbc_raw = zxbcdt[..., di: di + conv_ch]   # (x | B | C), adjacent
    xbc = _silu(_causal_conv(xbc_raw, p["conv_w"].to(cd),
                             p["conv_b"].to(cd)))
    x, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    x = shard(x, "batch", None, "heads")

    dt_s, A = _ssd_inputs(p, dtp)                   # [B, S, H], [H]
    xh = x.reshape(Bsz, S, H, P)                    # a view of xbc
    impl = "pallas" if use_kernel else "chunked"
    out = ssd_ops.ssd(xh, dt_s, A, Bm.to(F32), Cm.to(F32),
                      p["D"].to(F32), impl=impl, return_state=return_state)
    y, final_ssm = out if return_state else (out, None)
    y = y.reshape(Bsz, S, di).to(cd)
    y = shard(L.rmsnorm(p["norm"], y * _silu(z)), "batch", None, "heads")
    out = L.dense(p["out_proj"], y, compute_dtype=cd)
    if return_state:
        # a copy: a view would keep the whole in_proj output alive
        conv = xbc_raw[:, -(cfg.ssm_conv - 1):, :].contiguous()
        return out, {"conv": conv, "ssm": final_ssm}
    return out


# ---------------------------------------------------------------------------
# Decode path (O(1) state)
# ---------------------------------------------------------------------------
def mamba_init_state(cfg: ArchConfig, batch: int, dtype=None,
                     device="cuda"):
    device = resolve_device(device)
    di, H, N, P, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                            dtype=dtype or cfg.cdtype(), device=device),
        "ssm": torch.zeros((batch, H, N, P), dtype=F32, device=device),
    }


def mamba_decode_step(p, hidden_t: torch.Tensor, state, cfg: ArchConfig):
    """``hidden_t [B, 1, d]`` -> (``[B, 1, d]``, state).  The state's
    tensors are updated in place (the reference returns new ones) and the
    same dict is returned."""
    Bsz = hidden_t.shape[0]
    di, H, N, P, conv_ch = _dims(cfg)
    cd = cfg.cdtype()

    zxbcdt = L.dense(p["in_proj"], hidden_t, compute_dtype=cd)[:, 0]
    z, _, _, _, dtp = _split_proj(zxbcdt, cfg)
    xbc = zxbcdt[:, di: di + conv_ch]               # [B, conv_ch]
    window = torch.cat([state["conv"], xbc[:, None, :]], dim=1)
    conv_out = (torch.einsum("bkc,kc->bc", window, p["conv_w"].to(cd))
                + p["conv_b"].to(cd))
    x, Bm, Cm = torch.split(_silu(conv_out), [di, N, N], dim=-1)

    dt_s, A = _ssd_inputs(p, dtp)                   # [B, H], [H]
    h_new, y = ssd_ops.ssd_decode_step(
        state["ssm"], x.reshape(Bsz, H, P).to(F32), dt_s, A, Bm.to(F32),
        Cm.to(F32), p["D"].to(F32))
    y = y.reshape(Bsz, 1, di).to(cd)
    y = L.rmsnorm(p["norm"], y * _silu(z[:, None, :]))
    out = L.dense(p["out_proj"], y, compute_dtype=cd)
    state["conv"].copy_(window[:, 1:])
    state["ssm"].copy_(h_new)
    return out, state
