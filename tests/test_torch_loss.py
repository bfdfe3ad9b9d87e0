"""The port's training losses against the reference's, on the CPU.

``softmax_xent`` and ``chunked_xent`` with and without a mask (1e-6
relative); then the loss and every gradient of each decoder family's
reduced config at 2 layers (dense, MoE, SSM, hybrid, VLM) and of
Whisper's encoder-decoder, in float32 compute, against
``jax.value_and_grad`` of the reference's ``loss_fn`` on the same
weights (``convert``) and batch: the loss to 1e-5 relative, each
gradient leaf to 1e-4 of its largest magnitude (only the summation order
differs).  Attention runs ``impl="chunked"`` on both sides, so the port's
``ChunkedAttention`` (its plain versions here) carries every attention
gradient.  Then the torch twin of ``test_archs_smoke.py``'s
remat/chunked-CE equivalence, for the loss and its gradients, and the
port's copy of the shape suites.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (one intra-op thread a worker)
from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.configs import shapes as j_shapes  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.transformer import OptFlags as JFlags  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.transformer import OptFlags  # noqa: E402

CPU = "cpu"
FAMILIES = {"dense": "qwen1.5-0.5b", "moe": "granite-moe-3b-a800m",
            "ssm": "mamba2-1.3b", "hybrid": "zamba2-2.7b",
            "vlm": "internvl2-26b", "encdec": "whisper-base"}
S_TEXT, BATCH = 16, 2
LOSS_TOL, LEAF_TOL = 1e-5, 1e-4
# a leaf whose largest gradient is below this is held to LEAF_TOL of it
# (1e-8 absolute) instead of its own magnitude: Scout's top-1 router is one
# (the renormalised weight is 1 whatever the logits, so its gradient is 0
# but for float32 rounding, some 3e-9 here)
NOISE_FLOOR = 1e-4


def _cfgs(arch, n_layers=2, compute_dtype="float32"):
    out = []
    for get in (j_get_config, get_config):
        c = dataclasses.replace(get(arch).reduced(),
                                compute_dtype=compute_dtype)
        if c.family != "encdec":
            c = dataclasses.replace(c, n_layers=n_layers)
        out.append(c)
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


def _batch(cfg, seed=0):
    """numpy inputs: tokens and labels, the VLM's embeds, Whisper's
    frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (BATCH, S_TEXT + 1), dtype=np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.vis_len:
        b["embeds"] = (rng.standard_normal(
            (BATCH, cfg.vis_len, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "encdec":
        b["frames"] = (rng.standard_normal(
            (BATCH, cfg.enc_len, cfg.d_model)) * 0.1).astype(np.float32)
    return b


def _tree_from(cfg):
    return (convert.encdec_params_from if cfg.family == "encdec"
            else convert.lm_params_from)


def _port_params(jparams, cfg):
    params = _tree_from(cfg)(jax.tree.map(np.asarray, jparams), cfg, CPU)
    for p in params.parameters():
        p.requires_grad_(True)
    return params


def _port_grads(cfg, params, batch, flags):
    named = dict(params.named_parameters())
    loss = api.loss_fn(cfg)(params, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, flags)
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    return loss.detach(), {k: (torch.zeros_like(p) if g is None else g)
                  for (k, p), g in zip(named.items(), grads)}


def _hold_leaves(exp: dict, got: dict, what: str, tol=LEAF_TOL) -> None:
    assert exp.keys() == got.keys(), what
    for k, e in exp.items():
        e = e.detach().float().numpy()
        g = got[k].detach().float().numpy()
        scale = float(np.abs(e).max())
        err = float(np.abs(g - e).max())
        assert err <= tol * max(scale, NOISE_FLOOR), (what, k, err, scale)


# ---------------------------------------------------------------------------
# cross-entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_and_chunked_xent_match_reference(masked):
    rng = np.random.default_rng(1)
    B, S, d, V = 2, 12, 16, 40
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (B, S), dtype=np.int32)
    mask = (rng.random((B, S)) < 0.6).astype(np.float32) if masked else None
    logits = x @ w
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    exp = float(JL.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                jm))
    got = float(TL.softmax_xent(torch.from_numpy(logits),
                                torch.from_numpy(labels), tm))
    assert abs(got - exp) <= 1e-6 * abs(exp)
    # chunk 5 rounds down to 4, a divisor of S = 12
    for chunk in (4, 5, 12, 1024):
        exp_c = float(JL.chunked_xent(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(labels), jm, chunk=chunk))
        got_c = float(TL.chunked_xent(torch.from_numpy(x),
                                      torch.from_numpy(w),
                                      torch.from_numpy(labels), tm,
                                      chunk=chunk))
        assert abs(got_c - exp_c) <= 1e-6 * abs(exp_c), chunk
        assert abs(got_c - got) <= 1e-6 * abs(got), chunk


def test_xent_mask_of_zeros_divides_by_one():
    logits = torch.randn(2, 3, 7)
    labels = torch.zeros(2, 3, dtype=torch.int32)
    mask = torch.zeros(2, 3)
    assert float(TL.softmax_xent(logits, labels, mask)) == 0.0
    x, w = torch.randn(2, 3, 4), torch.randn(4, 7)
    assert float(TL.chunked_xent(x, w, labels, mask, chunk=3)) == 0.0


# ---------------------------------------------------------------------------
# every family's loss and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_reference(family):
    jcfg, cfg = _cfgs(FAMILIES[family])
    assert cfg.family == family
    batch = _batch(cfg)
    jparams = j_api.init_params(jcfg, jax.random.PRNGKey(0))
    kw = dict(attn_impl="chunked", chunked_ce=True, ce_chunk=8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: j_api.loss_fn(jcfg)(p, jb, JFlags(**kw))))(jparams)
    params = _port_params(jparams, cfg)
    loss, grads = _port_grads(cfg, params, batch, OptFlags(**kw))
    assert abs(float(loss) - float(loss_j)) <= LOSS_TOL * abs(float(loss_j))
    exp = {k: p for k, p in _tree_from(cfg)(
        jax.tree.map(np.asarray, grads_j), cfg, CPU).named_parameters()}
    _hold_leaves(exp, grads, family)


def test_vlm_embedding_positions_carry_no_label():
    """Only the last tokens.shape[1] positions are scored: the loss moves
    with the embeddings (through attention) but has no term of its own at
    their positions."""
    _, cfg = _cfgs(FAMILIES["vlm"])
    params = api.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    base = float(api.loss_fn(cfg)(params, b))
    moved = float(api.loss_fn(cfg)(params, {**b, "embeds": b["embeds"] * 5}))
    assert np.isfinite(base) and base != moved
    hidden = api.TF.lm_forward(params, cfg, b["tokens"], embeds=b["embeds"])
    assert hidden.shape[1] == cfg.vis_len + S_TEXT


# ---------------------------------------------------------------------------
# torch twin of test_archs_smoke.py::test_remat_and_chunked_ce_equivalence
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_remat_and_chunked_ce_equivalence(arch_id):
    """The flags change no loss and no gradient (the reference holds the
    loss to 1e-4; the gradients here to 1e-4 of each leaf's largest
    magnitude)."""
    cfg = dataclasses.replace(get_config(arch_id).reduced(),
                              compute_dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    for p in params.parameters():
        p.requires_grad_(True)
    batch = {k: v.numpy() for k, v in api.make_batch(
        cfg, shapes.ShapeSpec("smoke", "train", 32, 2), "train",
        api.prng.PRNGKey(0, device=CPU)).items()}
    base, base_g = _port_grads(cfg, params, batch, OptFlags())
    for flags in [
        OptFlags(remat="full"),
        OptFlags(chunked_ce=True, ce_chunk=16),
        OptFlags(remat="dots", chunked_ce=True, ce_chunk=8,
                 attn_impl="chunked"),
        OptFlags(cast_params_bf16=False, attn_impl="chunked"),
    ]:
        alt, alt_g = _port_grads(cfg, params, batch, flags)
        assert abs(float(base - alt)) < 1e-4, (arch_id, flags)
        _hold_leaves(base_g, alt_g, f"{arch_id} {flags}")


# ---------------------------------------------------------------------------
# the shape suites
# ---------------------------------------------------------------------------
def test_shape_suites_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in j_shapes.SHAPES.items()}
    assert sorted(shapes.cells()) == sorted(j_shapes.cells())
    for arch in ARCH_IDS:
        for sid in shapes.SHAPE_IDS:
            assert shapes.applicable(get_config(arch), sid) == \
                j_shapes.applicable(j_get_config(arch), sid)
