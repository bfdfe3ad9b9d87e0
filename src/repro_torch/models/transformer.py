"""Decoder-only LM assembly, dense, MoE, SSM, hybrid and VLM families (the
port's copy of those paths of ``repro/models/transformer.py``).

The reference stacks its layer parameters on a leading ``[L, ...]`` axis
and scans over them; here the layers are an ``nn.ModuleList`` of
``nn.ModuleDict`` blocks and the scan is a Python loop.  Parameter names
and layouts are the reference's, so ``repro_torch.convert`` moves a
parameter tree across key by key.  The caches keep the reference's
stacked layouts: dense ``{"kv": (k [L, B, T, KV, D], v [L, B, T, KV,
D]), "t": int}`` (the MoE family's too), SSM ``{"ssm": {"conv": [L, B,
K-1, Ch], "ssm": [L, B, H, N, P]}, "t": int}``, hybrid ``{"ssm": {"conv":
[G, k, B, K-1, Ch], "ssm": [G, k, B, H, N, P]}, "kv": (k [G, B, T, KV,
D], v [G, B, T, KV, D]), "t": int}``; decode updates them in place.  A
MoE block is the dense block with ``moe.moe_apply`` in place of the
SwiGLU MLP.  The hybrid (Zamba2) runs ``G = n_layers / k`` groups of
``k = shared_attn_every`` SSM blocks, each group followed by the one
shared attention block (a dense block whose weights every group reuses,
``params["shared_attn"]``) with a KV cache per group.  The SSM mixer runs
its SSD core on the ssd_scan kernel when the activations are on a card
(``mamba2.py``'s docstring).  The VLM is the dense decoder with a stub
frontend: precomputed embeddings ``embeds [B, vis_len, d]`` arrive with
the batch and are concatenated ahead of the token embeddings, so the
rotary positions run over the whole sequence and decode starts at
``t = vis_len + S``.  The encoder-decoder family is ``encdec.py``.

Training: ``lm_loss`` is the reference's next-token cross-entropy on the
text positions (the VLM's embedding positions carry no label), with the
optional ``loss_mask`` and the chunked cross-entropy of ``flags``.
``flags.remat`` checkpoints each block (each group of the hybrid, its
shared block included) with ``torch.utils.checkpoint``: "full" keeps only
its input, "dots" also the matrix products' outputs (the reference's
``checkpoint_dots``); neither changes the loss.  Under grad the SSM
mixer's SSD core takes ``impl="chunked"``, the reference's own route (its
model never reaches the Pallas kernel, which has no backward).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.distributed.sharding import shard
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE

# the leaves whose every use casts them to the compute dtype first
# (dense weights and biases, the embedding table, and every leaf under
# "experts"); norm scales, and the MoE router's "w" (its logits are
# float32), are read in float32 and are not among them
_COMPUTE_LEAVES = ("w", "b", "table")


@dataclasses.dataclass(frozen=True)
class OptFlags:
    """Performance knobs, with the reference's fields and defaults.  The
    serving path reads ``attn_impl`` (prefill attention: "naive",
    "chunked" or "pallas") and ``seq_parallel_decode`` (the decode cache
    constrained to its length over ``seq_kv``); training reads
    ``attn_impl`` ("chunked" is the one with a backward),
    ``flash_kernel``, ``remat`` ("none", "full", "dots"), ``chunked_ce``
    with ``ce_chunk``, ``cast_params_bf16`` and ``seq_parallel_acts``
    (the residual stream after each block constrained to its sequence
    over ``seq_sp``).  ``donate_cache`` (decode always updates the cache
    in place), ``kv_cache_dtype`` and ``unroll_layers`` (the layers are a
    Python loop) are the reference's and read by nothing here."""

    remat: str = "none"
    chunked_ce: bool = False
    ce_chunk: int = 1024
    seq_parallel_decode: bool = False
    seq_parallel_acts: bool = False
    donate_cache: bool = True
    flash_kernel: bool = False
    attn_impl: str = "naive"
    kv_cache_dtype: str = ""
    unroll_layers: bool = False
    cast_params_bf16: bool = False


BASELINE_FLAGS = OptFlags()


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not a decoder family of "
            f"the port {PORTED_FAMILIES}; the encoder-decoder is "
            "models/encdec.py (api dispatches to it)")
    if cfg.family == "hybrid":
        _groups(cfg)


def _groups(cfg: ArchConfig):
    """The hybrid's ``(G, k)``: G groups of k = ``shared_attn_every`` SSM
    blocks (the reference reshapes its layer stack to ``[G, k, ...]``,
    which needs k to divide the depth)."""
    k = cfg.shared_attn_every
    if k < 1 or cfg.n_layers % k:
        raise ValueError(
            f"{cfg.name}: n_layers={cfg.n_layers} is not a multiple of "
            f"shared_attn_every={k}")
    return cfg.n_layers // k, k


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _block_init(gen, cfg: ArchConfig, device):
    dt = cfg.pdtype()
    if cfg.family in ("ssm", "hybrid"):
        return nn.ModuleDict({
            "ln": L.rmsnorm_init(cfg.d_model, dt, device),
            "mamba": M.mamba_init(gen, cfg, device),
        })
    block = {
        "ln1": L.rmsnorm_init(cfg.d_model, dt, device),
        "attn": A.attn_init(gen, cfg, device),
        "ln2": L.rmsnorm_init(cfg.d_model, dt, device),
    }
    if cfg.family == "moe":
        block["moe"] = MOE.moe_init(gen, cfg, device)
    else:
        block["mlp"] = L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dt, device)
    return nn.ModuleDict(block)


def init_lm(cfg: ArchConfig, gen: torch.Generator, device="cuda", *,
            compute_dtype: bool = False):
    """Random parameters from ``gen`` (drawn on the generator's device),
    placed on ``device``.  ``compute_dtype``: ``compute_params`` of them,
    each part cast as soon as it is drawn, so only one block is ever held
    in float32 (a model whose float32 parameters would not fit a card
    builds all the same); bit for bit ``compute_params(init_lm(...))``."""
    _check_ported(cfg)
    device = resolve_device(device)
    dt = cfg.pdtype()

    def keep(part):
        return compute_params(part, cfg) if compute_dtype else part

    params = nn.ModuleDict({
        "embed": keep(L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dt,
                                   device)),
        "layers": nn.ModuleList([keep(_block_init(gen, cfg, device))
                                 for _ in range(cfg.n_layers)]),
        "final_norm": L.rmsnorm_init(cfg.d_model, dt, device),
    })
    if not cfg.tie_embeddings:
        params["head"] = keep(L.dense_init(gen, cfg.d_model,
                                           cfg.vocab_padded, dtype=dt,
                                           device=device))
    if cfg.family == "hybrid":
        params["shared_attn"] = keep(_shared_attn_init(gen, cfg, device))
    return params


def _shared_attn_init(gen, cfg: ArchConfig, device):
    """The hybrid's shared attention block: a dense block's leaves."""
    dt = cfg.pdtype()
    return nn.ModuleDict({
        "ln1": L.rmsnorm_init(cfg.d_model, dt, device),
        "attn": A.attn_init(gen, cfg, device),
        "ln2": L.rmsnorm_init(cfg.d_model, dt, device),
        "mlp": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dt, device),
    })


def _map_params(params, fn, path=()):
    """A new parameter tree of the same structure with ``fn(path,
    tensor)`` in place of every leaf (``path`` is the tuple of keys down
    to the leaf, the layer index left out)."""
    if isinstance(params, nn.ParameterDict):
        return nn.ParameterDict({
            k: nn.Parameter(fn(path + (k,), p.data), requires_grad=False)
            for k, p in params.items()})
    if isinstance(params, L.ParamTree):
        return L.ParamTree({
            k: (_map_params(v, fn, path + (k,)) if isinstance(v, nn.Module)
                else fn(path + (k,), v.data))
            for k, v in params.items()})
    if isinstance(params, nn.ModuleList):
        return nn.ModuleList([_map_params(m, fn, path) for m in params])
    return nn.ModuleDict({k: _map_params(m, fn, path + (k,))
                          for k, m in params.items()})


def compute_params(params, cfg: ArchConfig, device=None):
    """The parameters as the forward pass reads them: the dense weights
    (the hybrid's shared block's among them), biases, the embedding table
    and the expert weights cast once to the compute dtype, norm scales,
    the MoE router and the mixer's conv, decay, skip and dt-bias leaves
    as they are (the reference casts them at each use), all on ``device``
    (default: where they are).  Every use of a cast leaf casts it first
    anyway, and a cast is deterministic, so the outputs are bit for bit
    those of ``params``; what changes is that a step reads bf16 weights
    instead of converting float32 ones on every call."""
    cd = cfg.cdtype()

    def cast(path, x):
        low = "router" not in path and (path[-1] in _COMPUTE_LEAVES
                                        or "experts" in path)
        return x.to(device=device or x.device, dtype=cd if low else x.dtype)

    return _map_params(params, cast)


def head_weight(params, cfg: ArchConfig):
    """The head ``[d, V]``, on a mesh constrained to its vocab over
    ``vocab``: a tied table is sharded on d (its rule), and a product
    contracting over a sharded d leaves DTensor a partial sum of the
    whole vocabulary's logits on every device; resharding the table to
    vocab instead keeps the logits vocab-sharded, as the untied head's
    rule does (PERF.md, PR 30)."""
    if cfg.tie_embeddings:
        return shard(params["embed"]["table"].T, None, "vocab")
    return params["head"]["w"]


def _logits(params, cfg: ArchConfig, x):
    """Final norm and head: float32 logits of the compute-dtype product."""
    x = L.rmsnorm(params["final_norm"], x)
    return (x @ head_weight(params, cfg).to(x.dtype)).to(torch.float32)


# ---------------------------------------------------------------------------
# Forward (scoring)
# ---------------------------------------------------------------------------
def _embed_inputs(params, cfg: ArchConfig, tokens, embeds):
    cd = cfg.cdtype()
    x = L.embed(params["embed"], tokens, compute_dtype=cd)
    if embeds is not None:  # VLM stub frontend: precomputed embeddings
        x = torch.cat([embeds.to(cd), x], dim=1)
    return shard(x, "batch", None, None)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


def residual(x):
    """The residual stream after a sub-layer, on a mesh held replicated
    but for its batch: the row-parallel output's partial sum is reduced
    there, as Megatron's tensor parallelism does.  The reference leaves
    this to GSPMD; DTensor, op by op, keeps the sum partial or shards d
    and then gathers the next column-parallel weights and inputs whole
    (the MLP's gate and up products 16 times over on a 16-way model
    axis; PERF.md, PR 30)."""
    return shard(x, "batch", *[None] * (x.dim() - 1))


def _mlp(layer_p, h, cfg: ArchConfig):
    """The block's second half: the SwiGLU MLP, or for the MoE family the
    experts, on ``rmsnorm(h)``, added to ``h``."""
    h = residual(h)
    inner = L.rmsnorm(layer_p["ln2"], h)
    if cfg.family == "moe":
        return residual(h + MOE.moe_apply(layer_p["moe"], inner, cfg))
    return residual(h + L.swiglu(layer_p["mlp"], inner,
                                 compute_dtype=cfg.cdtype()))


def _blocks(params, cfg: ArchConfig):
    """The model's blocks in order, as ``(kind, at, block)``: ``kind`` is
    "ssm" or "attn", ``at`` the block's index into its cache leaves (the
    hybrid's SSM states are ``[G, k, ...]``, so ``(g, i)``; its KV cache
    has one entry per group, after which the shared block runs)."""
    if cfg.family == "hybrid":
        G, k = _groups(cfg)
        for g in range(G):
            for i in range(k):
                yield "ssm", (g, i), params["layers"][g * k + i]
            yield "attn", g, params["shared_attn"]
        return
    kind = "ssm" if cfg.family == "ssm" else "attn"
    for i, layer_p in enumerate(params["layers"]):
        yield kind, i, layer_p


def requires_grad(tree) -> bool:
    """Whether any tensor of a parameter tree (modules, or the plain
    dicts and lists of a cast view) requires grad."""
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    if isinstance(tree, nn.Module):
        return any(p.requires_grad for p in tree.parameters())
    values = tree.values() if isinstance(tree, dict) else tree
    return any(requires_grad(v) for v in values)


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def ssd_on_kernel(layer_p, x) -> bool:
    """Whether the SSM block's SSD core runs the ssd_scan kernel: for
    activations on a card when no gradient is taken.  Under grad it takes
    the plain ``impl="chunked"``, which autograd differentiates (the
    kernel has no backward)."""
    if torch.is_grad_enabled() and (x.requires_grad
                                    or requires_grad(layer_p)):
        return False
    return _on_card(x)


def _mixer(layer_p, x, cfg: ArchConfig, *, return_state: bool = False):
    """The SSM block's mixer on ``rmsnorm(x)`` (``ssd_on_kernel`` picks
    its SSD core's route)."""
    return M.mamba_apply(layer_p["mamba"], L.rmsnorm(layer_p["ln"], x), cfg,
                         use_kernel=ssd_on_kernel(layer_p, x),
                         return_state=return_state)


# the matrix products whose outputs remat="dots" keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, flags: OptFlags):
    """``fn`` under ``flags.remat``: as it is ("none"), or checkpointed,
    keeping its inputs ("full") and its matrix products' outputs too
    ("dots", the reference's ``checkpoint_dots``)."""
    if flags.remat == "none":
        return fn
    if flags.remat == "full":
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False)
    if flags.remat == "dots":
        return functools.partial(
            _ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat policy {flags.remat!r}")


def _ssm_block(block, x, cfg: ArchConfig):
    return residual(x + _mixer(block, x, cfg))


def _attn_block(block, x, cfg: ArchConfig, positions, impl: str):
    h = x + A.attn_apply(block["attn"], L.rmsnorm(block["ln1"], x), cfg,
                         positions=positions, impl=impl)
    return _mlp(block, h, cfg)


def lm_forward(params, cfg: ArchConfig, tokens, *,
               embeds: Optional[torch.Tensor] = None,
               flags: OptFlags = BASELINE_FLAGS) -> torch.Tensor:
    """Final hidden states ``[B, S, d]`` (after the final norm); each
    block (each group of the hybrid) under ``remat(..., flags)``, each
    layer's output under ``flags.seq_parallel_acts``'s constraint (the
    hybrid's shared block's is not, as in the reference)."""
    _check_ported(cfg)
    x = _embed_inputs(params, cfg, tokens, embeds)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    impl = "pallas" if flags.flash_kernel else flags.attn_impl

    def sp(x):
        # TP sequence parallelism: the residual kept seq-sharded
        return (shard(x, "batch", "seq_sp", None) if flags.seq_parallel_acts
                else x)

    def ssm(block, x):
        return sp(_ssm_block(block, x, cfg))

    def attn(block, x):
        return sp(_attn_block(block, x, cfg, positions, impl))

    if cfg.family == "hybrid":
        G, k = _groups(cfg)

        def group(x, g: int):
            for i in range(k):
                x = ssm(params["layers"][g * k + i], x)
            return _attn_block(params["shared_attn"], x, cfg, positions,
                               impl)

        for g in range(G):
            x = remat(group, flags)(x, g)
    else:
        blocks = {"ssm": remat(ssm, flags), "attn": remat(attn, flags)}
        for kind, _, block in _blocks(params, cfg):
            x = blocks[kind](block, x)
    return L.rmsnorm(params["final_norm"], x)


def lm_loss(params, cfg: ArchConfig, batch: dict, *,
            flags: OptFlags = BASELINE_FLAGS) -> torch.Tensor:
    """Next-token cross-entropy (float32 scalar).  batch: ``tokens``,
    ``labels``, the VLM's ``embeds``, optionally ``loss_mask``; only the
    last ``tokens.shape[1]`` positions (the text) are scored."""
    hidden = lm_forward(params, cfg, batch["tokens"],
                        embeds=batch.get("embeds"), flags=flags)
    n_text = batch["tokens"].shape[1]
    # the port's one constraint the reference lacks: on a mesh the
    # sequence-parallel residual is gathered over seq_sp before the head,
    # since DTensor has no strategy for the head's product on the
    # flattened (batch, seq-shard) layout (PERF.md, PR 30)
    hidden = shard(hidden, "batch", None, None)[:, -n_text:]
    labels, mask = batch["labels"], batch.get("loss_mask")
    hw = head_weight(params, cfg)
    if flags.chunked_ce:
        return L.chunked_xent(hidden, hw, labels, mask, chunk=flags.ce_chunk)
    logits = (hidden @ hw.to(hidden.dtype)).to(torch.float32)
    logits = shard(logits, "batch", None, "vocab")
    return L.softmax_xent(logits, labels, mask)


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------
def lm_prefill(params, cfg: ArchConfig, tokens, *, cache_len: int,
               embeds=None, flags: OptFlags = BASELINE_FLAGS):
    """Run the prompt ``tokens [B, S]``; return (last-position logits
    ``[B, 1, V]`` float32, cache ``{"kv": (k, v) [L, B, T, KV, D], "t":
    S}``, for the SSM family ``{"ssm": {"conv", "ssm"}, "t": S}``, for the
    hybrid both, grouped as the module's docstring gives).  Prefill
    attention runs ``flags.attn_impl``; the SSM family has no
    ``cache_len`` (its state is O(1) in the sequence)."""
    _check_ported(cfg)
    x = _embed_inputs(params, cfg, tokens, embeds)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    convs, ssms, ks, vs = [], [], [], []
    for kind, _, block in _blocks(params, cfg):
        if kind == "ssm":
            out, st = _mixer(block, x, cfg, return_state=True)
            convs.append(st["conv"])
            ssms.append(st["ssm"])
            x = residual(x + out)
        else:
            a, (k, v) = A.attn_prefill(
                block["attn"], L.rmsnorm(block["ln1"], x), cfg,
                positions=positions, cache_len=cache_len,
                impl=flags.attn_impl)
            ks.append(k)
            vs.append(v)
            x = _mlp(block, x + a, cfg)
    cache = {}
    if ssms:
        lead = _groups(cfg) if cfg.family == "hybrid" else (cfg.n_layers,)
        cache["ssm"] = {
            "conv": torch.stack(convs).reshape(*lead, *convs[0].shape),
            "ssm": torch.stack(ssms).reshape(*lead, *ssms[0].shape)}
    if ks:
        cache["kv"] = (torch.stack(ks), torch.stack(vs))
    cache["t"] = S
    return _logits(params, cfg, x[:, -1:]), cache


def lm_decode_step(params, cfg: ArchConfig, cache, token, *,
                   flags: OptFlags = BASELINE_FLAGS):
    """One token step: ``token [B, 1]`` -> (logits ``[B, 1, V]`` float32,
    cache with ``t + 1``).  The cache's KV (or SSM state) tensors are
    updated in place (the reference donates them) and returned in the new
    cache."""
    _check_ported(cfg)
    cd = cfg.cdtype()
    x = shard(L.embed(params["embed"], token, compute_dtype=cd), "batch",
              None, None)
    t = cache["t"]
    st, kv = cache.get("ssm"), cache.get("kv")
    for kind, at, block in _blocks(params, cfg):
        if kind == "ssm":
            out, _ = M.mamba_decode_step(
                block["mamba"], L.rmsnorm(block["ln"], x),
                {"conv": st["conv"][at], "ssm": st["ssm"][at]}, cfg)
            x = residual(x + out)
        else:
            a, _ = A.attn_decode(
                block["attn"], L.rmsnorm(block["ln1"], x),
                (kv[0][at], kv[1][at]), t, cfg,
                seq_parallel=flags.seq_parallel_decode)
            x = _mlp(block, x + a, cfg)
    return _logits(params, cfg, x), {**cache, "t": t + 1}


def init_decode_cache(cfg: ArchConfig, batch: int, cache_len: int,
                      device="cuda"):
    """A fresh (empty) decode cache, laid out as ``lm_prefill``'s."""
    _check_ported(cfg)
    dev = resolve_device(device)
    cache = {}
    n_attn = cfg.n_layers
    if cfg.family in ("ssm", "hybrid"):
        lead = (cfg.n_layers,)
        if cfg.family == "hybrid":
            lead = _groups(cfg)
            n_attn = lead[0]
        st = M.mamba_init_state(cfg, batch, device=dev)
        cache["ssm"] = {k: torch.zeros((*lead, *v.shape), dtype=v.dtype,
                                       device=dev) for k, v in st.items()}
    if cfg.family != "ssm":
        shape = (n_attn, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
        cache["kv"] = tuple(torch.zeros(shape, dtype=cfg.cdtype(),
                                        device=dev) for _ in range(2))
    cache["t"] = 0
    return cache
