"""The port's training attention against the reference's, on the CPU.

``kernel.flash_attention_lse`` (here its plain version, ``ref.chunked_fwd``)
against the reference's ``_chunked_fwd_impl``, output and log-sum-exp;
the gradients of ``ops.chunked_attention`` (``ChunkedAttention``, whose
backward is ``kernel.flash_attention_bwd``, here ``ref.chunked_bwd``)
against ``jax.vjp`` of the reference's ``chunked_attention`` and, as an
independent oracle, against autograd through ``attention_ref``.  The
cases: causal and not, ``S == SK``, ``S < SK`` (bottom-right mask),
``S > SK``, ragged blocks and GQA; float32 to 1e-5 and bf16 to 2e-2 of
the largest magnitude.  Then the autograd guard: every kernel wrapper
raises when grad mode is on and an input requires grad (a model run with
``impl="pallas"`` or ``flash_kernel`` among them), and the SSM mixer
takes the plain SSD route under grad.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (one intra-op thread a worker)
from repro.kernels.flash_attention import ops as j_ops  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.transformer import OptFlags  # noqa: E402

CPU = "cpu"
# (B, HQ, HKV, S, SK, D, causal, q_chunk, k_chunk)
CASES = {
    "gqa_ragged": (2, 4, 2, 40, 40, 16, True, 16, 16),
    "s_lt_sk": (2, 4, 4, 24, 56, 16, True, 8, 16),
    "s_gt_sk_noncausal": (1, 2, 1, 56, 24, 8, False, 16, 8),
    "s_gt_sk_causal": (1, 2, 1, 30, 20, 8, True, 16, 8),
    "one_block_noncausal": (2, 2, 2, 32, 32, 16, False, 512, 1024),
}
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(case, dtype):
    B, HQ, HKV, S, SK, D = CASES[case][:6]
    rng = np.random.default_rng(len(case))
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, HQ, S, D), (B, HKV, SK, D), (B, HKV, SK, D)))
    do = rng.standard_normal((B, HQ, S, D)).astype(np.float32)
    jd, td, _ = DTYPES[dtype]
    return ([jnp.asarray(x).astype(jd) for x in (q, k, v, do)],
            [torch.from_numpy(x).to(td) for x in (q, k, v, do)])


def _rel(got, exp) -> float:
    exp = np.asarray(jnp.asarray(exp).astype(jnp.float32))
    got = got.detach().float().numpy()
    return float(np.abs(got - exp).max() / max(np.abs(exp).max(), 1e-30))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_lse_match_reference(case, dtype):
    B, HQ, HKV, S, SK, D, causal, qc, kc = CASES[case]
    (jq, jk, jv, _), (q, k, v, _) = _inputs(case, dtype)
    tol = DTYPES[dtype][2]
    blocks = ref.default_blocks(S, SK, qc, kc)
    o_j, lse_j = j_ops._chunked_fwd_impl(jq, jk, jv, causal, D ** -0.5,
                                         *blocks)
    o, lse = fa_kernel.flash_attention_lse(q, k, v, causal=causal,
                                           blocks=blocks)
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert _rel(o, o_j) <= tol
    assert _rel(lse, lse_j.reshape(B, HQ, S)) <= tol


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_reference_vjp(case, dtype):
    B, HQ, HKV, S, SK, D, causal, qc, kc = CASES[case]
    (jq, jk, jv, jdo), (q, k, v, do) = _inputs(case, dtype)
    tol = DTYPES[dtype][2]
    o_j, vjp = jax.vjp(lambda a, b, c: j_ops.chunked_attention(
        a, b, c, causal=causal, q_chunk=qc, k_chunk=kc), jq, jk, jv)
    grads_j = vjp(jdo)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    o = ops.chunked_attention(*leaves, causal=causal, q_chunk=qc,
                              k_chunk=kc)
    grads = torch.autograd.grad(o, leaves, do)
    assert _rel(o, o_j) <= tol
    for name, g, e in zip("qkv", grads, grads_j):
        assert str(g.dtype) == f"torch.{e.dtype}", name
        assert g.shape == tuple(e.shape), name
        assert _rel(g, e) <= tol, (name, _rel(g, e))


@pytest.mark.parametrize("case", [c for c in CASES if c != "s_gt_sk_causal"])
def test_gradients_match_autograd_through_attention_ref(case):
    """An independent oracle: autograd through the dense softmax.  (The
    causal S > SK case is left out: its first rows see no key, which the
    two define differently.)"""
    causal, qc, kc = CASES[case][6:]
    _, (q, k, v, do) = _inputs(case, "float32")
    leaves = [x.requires_grad_() for x in (q, k, v)]
    o = ops.chunked_attention(*leaves, causal=causal, q_chunk=qc,
                              k_chunk=kc)
    grads = torch.autograd.grad(o, leaves, do)
    o_ref = ref.attention_ref(*leaves, causal=causal)
    grads_ref = torch.autograd.grad(o_ref, leaves, do)
    o, o_ref = o.detach(), o_ref.detach()
    assert float((o - o_ref).abs().max()) <= 1e-5 * float(o_ref.abs().max())
    for g, e in zip(grads, grads_ref):
        assert float((g - e).abs().max()) <= 1e-5 * float(e.abs().max())


def test_mha_chunked_saves_no_scores():
    """What ChunkedAttention keeps for its backward is (q, k, v, o, lse):
    O(S), never the S x SK scores."""
    _, (q, k, v, _) = _inputs("gqa_ragged", "float32")
    leaves = [x.requires_grad_() for x in (q, k, v)]
    o = ops.mha(*leaves, impl="chunked")
    saved = o.grad_fn.saved_tensors
    assert len(saved) == 5
    assert [tuple(x.shape) for x in saved[:4]] == [
        tuple(x.shape) for x in (q, k, v, o)]
    assert tuple(saved[4].shape) == tuple(q.shape[:3])


# ---------------------------------------------------------------------------
# the autograd guard and the route under grad
# ---------------------------------------------------------------------------
def test_kernel_wrappers_refuse_inputs_that_require_grad():
    _, (q, k, v, do) = _inputs("gqa_ragged", "float32")
    qg = q.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="requires grad"):
        fa_kernel.flash_attention(qg, k, v)
    with pytest.raises(RuntimeError, match="requires grad"):
        fa_kernel.flash_attention_lse(qg, k, v)
    o, lse = fa_kernel.flash_attention_lse(q, k, v)
    with pytest.raises(RuntimeError, match="requires grad"):
        fa_kernel.flash_attention_bwd(qg, k, v, o, lse, do)
    with torch.no_grad():     # no gradient taken: the kernel path is open
        fa_kernel.flash_attention(qg, k, v)
    Bz, L, H, P, N = 1, 16, 2, 8, 4
    x = torch.randn(Bz, L, H, P, requires_grad=True)
    dt, A, D = torch.rand(Bz, L, H), -torch.rand(H), torch.ones(H)
    Bm, Cm = torch.randn(Bz, L, N), torch.randn(Bz, L, N)
    with pytest.raises(RuntimeError, match="requires grad"):
        ssd_kernel.ssd_scan_heads(x, dt, A, Bm, Cm, D, chunk=8)
    with pytest.raises(RuntimeError, match="requires grad"):
        ssd_kernel.ssd_scan(x[:, :, 0].transpose(0, 1).reshape(L, -1)[None],
                            dt[..., 0], A[:1], Bm, Cm, D[:1], chunk=8)
    with pytest.raises(RuntimeError, match="requires grad"):
        ssd_kernel.chunk_cb(Bm.requires_grad_(), Cm, chunk=8)


@pytest.mark.parametrize("flags", [OptFlags(attn_impl="pallas"),
                                   OptFlags(flash_kernel=True)])
def test_model_on_the_forward_kernel_under_grad_raises(flags):
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              n_layers=1, compute_dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    for p in params.parameters():
        p.requires_grad_(True)
    tok = torch.zeros((1, 8), dtype=torch.int32)
    batch = {"tokens": tok, "labels": tok}
    with pytest.raises(RuntimeError, match="requires grad"):
        api.loss_fn(cfg)(params, batch, flags)
    with torch.no_grad():
        api.loss_fn(cfg)(params, batch, flags)
    api.loss_fn(cfg)(params, batch, OptFlags(attn_impl="chunked")).backward()


def test_mixer_takes_the_plain_ssd_route_under_grad(monkeypatch):
    """On a card the SSD core runs the kernel only when no gradient is
    taken (the card stood in for by ``_on_card``)."""
    cfg = dataclasses.replace(get_config("mamba2-1.3b").reduced(),
                              n_layers=1, compute_dtype="float32")
    params = api.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    block = params["layers"][0]
    x = torch.randn(1, 8, cfg.d_model)
    monkeypatch.setattr(TF, "_on_card", lambda t: True)
    assert TF.ssd_on_kernel(block, x)
    assert not TF.ssd_on_kernel(block, x.clone().requires_grad_())
    for p in block.parameters():
        p.requires_grad_(True)
    assert not TF.ssd_on_kernel(block, x)
    with torch.no_grad():
        assert TF.ssd_on_kernel(block, x)
    monkeypatch.setattr(TF, "_on_card", lambda t: False)
    assert not TF.ssd_on_kernel(block, x)
    seen = []
    monkeypatch.setattr(TF.M, "mamba_apply", lambda *a, **kw: seen.append(
        kw["use_kernel"]) or a[1])
    monkeypatch.setattr(TF, "_on_card", lambda t: True)
    TF._mixer(block, x, cfg)
    with torch.no_grad():
        TF._mixer(block, x, cfg)
    assert seen == [False, True]
