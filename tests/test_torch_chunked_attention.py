"""The port's training attention against the reference's, on the CPU.

``kernel.flash_attention_lse`` (here its plain version, ``ref.chunked_fwd``)
against the reference's ``_chunked_fwd_impl``, output and log-sum-exp;
the gradients of ``ops.chunked_attention`` (``ChunkedAttention``, whose
backward is ``kernel.flash_attention_bwd``, here ``ref.chunked_bwd``)
against ``jax.vjp`` of the reference's ``chunked_attention`` and, as an
independent oracle, against autograd through ``attention_ref``.  The
cases: causal and not, ``S == SK``, ``S < SK`` (bottom-right mask),
``S > SK``, ragged blocks and GQA; float32 to 1e-5 and bf16 to 2e-2 of
the largest magnitude.  The plain backward with the tensor-core route's
roundings (``ref.chunked_bwd(..., round_bf16=True)``) against ``jax.vjp``
at bf16 shapes of that route, to an error norm of 5e-3, and against its
unrounded self (the option acts); the plain backward with the f32 route's
split TF32 products (``ref.chunked_bwd(..., split_tf32=True)``) against
``jax.vjp`` in float32 to 1e-5, with the one-term TF32 control past it,
and the forward's (``ref.chunked_fwd(..., split_tf32=True)``) against
``_chunked_fwd_impl`` likewise;
the backward's route rule on CPU tensors; the build tag's hash of a source's local headers and the
build's ptxas report.  Then the
autograd guard: every kernel wrapper raises when grad mode is on and an
input requires grad (a model run with ``impl="pallas"`` or
``flash_kernel`` among them), and the SSM mixer takes the plain SSD route
under grad.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (one intra-op thread a worker)
from repro.kernels.flash_attention import ops as j_ops  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import build as t_build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
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
# the tensor-core route's roundings, emulated, and the backward's route
# ---------------------------------------------------------------------------
# (B, HQ, HKV, S, SK, D, causal, q_chunk, k_chunk), bf16: the head dims the
# tensor-core backward takes (64 and Zamba2's 80), GQA, ragged edges, the
# bottom-right causal mask at S < SK, and non-causal
EMULATED = {
    "gqa_d64_ragged": (2, 4, 2, 72, 72, 64, True, 32, 32),
    "d80_s_lt_sk": (1, 4, 2, 24, 88, 80, True, 16, 32),
    "d80_noncausal": (1, 2, 2, 40, 56, 80, False, 16, 32),
    "d64_noncausal_gqa": (2, 4, 1, 33, 48, 64, False, 16, 16),
}
EMULATED_TOL = 5e-3   # error norm; 2.4e-3-2.9e-3 read here


def _emulated_inputs(case):
    B, HQ, HKV, S, SK, D, causal, qc, kc = EMULATED[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, HQ, S, D), (B, HKV, SK, D), (B, HKV, SK, D), (B, HQ, S, D)))
    return ([jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, do)],
            [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)])


def _norm_err(got, exp) -> float:
    got = got.detach().float().numpy()
    exp = np.asarray(jnp.asarray(exp).astype(jnp.float32))
    return float(np.linalg.norm(got - exp) / np.linalg.norm(exp))


def _plain_backward(case, q, k, v, do, round_bf16):
    B, HQ, HKV, S, SK, D, causal, qc, kc = EMULATED[case]
    o, lse = ref.chunked_fwd(q, k, v, causal=causal, scale=D ** -0.5,
                             q_chunk=qc, k_chunk=kc)
    return ref.chunked_bwd(q, k, v, o, lse, do, causal=causal,
                           scale=D ** -0.5, q_chunk=qc, k_chunk=kc,
                           round_bf16=round_bf16)


@pytest.mark.parametrize("case", list(EMULATED))
def test_rounded_plain_backward_matches_reference_vjp(case):
    """p rounded to bf16 for the dv product and dS for the dk and dq
    products, as the tensor-core kernels do: the reference's
    ``_chunked_core_bwd`` through ``jax.vjp`` to an error norm of 5e-3."""
    B, HQ, HKV, S, SK, D, causal, qc, kc = EMULATED[case]
    (jq, jk, jv, jdo), (q, k, v, do) = _emulated_inputs(case)
    _, vjp = jax.vjp(lambda a, b, c: j_ops.chunked_attention(
        a, b, c, causal=causal, q_chunk=qc, k_chunk=kc), jq, jk, jv)
    grads = _plain_backward(case, q, k, v, do, round_bf16=True)
    for name, g, e in zip("qkv", grads, vjp(jdo)):
        assert g.dtype == torch.bfloat16 and g.shape == tuple(e.shape)
        assert _norm_err(g, e) <= EMULATED_TOL, (name, _norm_err(g, e))


@pytest.mark.parametrize("case", list(EMULATED))
def test_rounding_option_changes_the_plain_backward(case):
    """The option acts: every gradient moves, by more than 1e-3 of its
    norm (p's rounding moves dv, dS's dq and dk; 2.4e-3-2.8e-3 here), and
    off it is the default step for step."""
    _, (q, k, v, do) = _emulated_inputs(case)
    rounded = _plain_backward(case, q, k, v, do, round_bf16=True)
    plain = _plain_backward(case, q, k, v, do, round_bf16=False)
    B, HQ, HKV, S, SK, D, causal, qc, kc = EMULATED[case]
    o, lse = ref.chunked_fwd(q, k, v, causal=causal, scale=D ** -0.5,
                             q_chunk=qc, k_chunk=kc)
    default = ref.chunked_bwd(q, k, v, o, lse, do, causal=causal,
                              scale=D ** -0.5, q_chunk=qc, k_chunk=kc)
    for name, a, b, c in zip("qkv", rounded, plain, default):
        assert torch.equal(b, c), name
        moved = float((a.float() - b.float()).norm() / b.float().norm())
        assert moved > 1e-3, (name, moved)


# ---------------------------------------------------------------------------
# the f32 route's split TF32 products, emulated
# ---------------------------------------------------------------------------
def _split_backward(case, q, k, v, do):
    B, HQ, HKV, S, SK, D, causal, qc, kc = CASES[case]
    o, lse = ref.chunked_fwd(q, k, v, causal=causal, scale=D ** -0.5,
                             q_chunk=qc, k_chunk=kc)
    return ref.chunked_bwd(q, k, v, o, lse, do, causal=causal,
                           scale=D ** -0.5, q_chunk=qc, k_chunk=kc,
                           split_tf32=True)


def _reference_grads(case):
    causal, qc, kc = CASES[case][6:]
    (jq, jk, jv, jdo), torch_inputs = _inputs(case, "float32")
    _, vjp = jax.vjp(lambda a, b, c: j_ops.chunked_attention(
        a, b, c, causal=causal, q_chunk=qc, k_chunk=kc), jq, jk, jv)
    return vjp(jdo), torch_inputs


@pytest.mark.parametrize("case", list(CASES))
def test_split_tf32_backward_matches_reference_vjp(case):
    """Every product as the f32 route's kernels form it (each operand
    split into a TF32-rounded hi and a lo read as TF32, lo times lo
    dropped): the reference's float32 ``_chunked_core_bwd`` through
    ``jax.vjp`` within the 1e-5 of the largest magnitude that the plain
    version meets, and not the plain version bit for bit."""
    grads_j, (q, k, v, do) = _reference_grads(case)
    split = _split_backward(case, q, k, v, do)
    B, HQ, HKV, S, SK, D, causal, qc, kc = CASES[case]
    o, lse = ref.chunked_fwd(q, k, v, causal=causal, scale=D ** -0.5,
                             q_chunk=qc, k_chunk=kc)
    plain = ref.chunked_bwd(q, k, v, o, lse, do, causal=causal,
                            scale=D ** -0.5, q_chunk=qc, k_chunk=kc)
    for name, g, e, p in zip("qkv", split, grads_j, plain):
        assert g.dtype == torch.float32 and g.shape == tuple(e.shape)
        assert _rel(g, e) <= 1e-5, (name, _rel(g, e))
        assert not torch.equal(g, p), name
    with pytest.raises(ValueError, match="pick one"):
        ref.chunked_bwd(q, k, v, o, lse, do, causal=causal, scale=1.0,
                        q_chunk=qc, k_chunk=kc, round_bf16=True,
                        split_tf32=True)


@pytest.mark.parametrize("case", list(CASES))
def test_one_term_tf32_backward_reads_past_the_limit(case, monkeypatch):
    """The control: the same emulation with one TF32 product a pair of
    operands (``tf32_product``, both rounded to TF32) reads past 1e-5 of
    the reference's VJP, so the hold above sees a dropped split."""
    grads_j, (q, k, v, do) = _reference_grads(case)
    monkeypatch.setattr(ref, "split_tf32_product", ssd_ref.tf32_product)
    errs = [_rel(g, e) for g, e in zip(_split_backward(case, q, k, v, do),
                                       grads_j)]
    assert max(errs) > 1e-5, errs


def _split_forward_errs(case):
    """The split TF32 forward (``ref.chunked_fwd(..., split_tf32=True)``)
    against the reference's float32 ``_chunked_fwd_impl``: o's and lse's
    largest error of their largest magnitudes."""
    B, HQ, HKV, S, SK, D, causal, qc, kc = CASES[case]
    (jq, jk, jv, _), (q, k, v, _) = _inputs(case, "float32")
    blocks = ref.default_blocks(S, SK, qc, kc)
    o_j, lse_j = j_ops._chunked_fwd_impl(jq, jk, jv, causal, D ** -0.5,
                                         *blocks)
    o, lse = ref.chunked_fwd(q, k, v, causal=causal, scale=D ** -0.5,
                             q_chunk=blocks[0], k_chunk=blocks[1],
                             split_tf32=True)
    assert o.dtype == lse.dtype == torch.float32
    return _rel(o, o_j), _rel(lse, lse_j.reshape(B, HQ, S))


@pytest.mark.parametrize("case", list(CASES))
def test_split_tf32_forward_matches_reference(case):
    """S and P V as the forward's f32 route forms them (q unscaled in S,
    the scale applied after it): the reference's blockwise forward within
    1e-5 of the largest magnitude for o and lse."""
    errs = _split_forward_errs(case)
    assert max(errs) <= 1e-5, errs


@pytest.mark.parametrize("case", list(CASES))
def test_one_term_tf32_forward_reads_past_the_limit(case, monkeypatch):
    """The control: one TF32 product a pair of operands
    (``tf32_product``) reads past 1e-5 of the reference's forward."""
    monkeypatch.setattr(ref, "split_tf32_product", ssd_ref.tf32_product)
    errs = _split_forward_errs(case)
    assert max(errs) > 1e-5, errs


def _bwd_route_inputs(case):
    """q, k, v, dO on the CPU for each case of the backward's route rule:
    views as the model hands them over, [B, S, H, D] transposed."""
    bf16 = torch.bfloat16
    view = lambda H, D, dt=bf16: torch.zeros(2, 40, H, D,
                                             dtype=dt).transpose(1, 2)
    D = int(case[6:]) if case.startswith("bf16_d") else 64
    q, k, v, do = view(4, D), view(2, D), view(2, D), view(4, D)
    if case == "f32":
        q, k, v, do = (x.float() for x in (q, k, v, do))
    elif case == "do_base":        # dO 2 bytes past a 16-byte boundary
        do = torch.zeros(1 + 2 * 40 * 4 * 64, dtype=bf16)[1:].view(
            2, 40, 4, 64).transpose(1, 2)
    elif case == "do_row_stride":  # dO rows of 66 elements
        do = torch.zeros(2, 40, 4, 66, dtype=bf16)[..., :64].transpose(1, 2)
    elif case == "k_row_stride":
        k = torch.zeros(2, 40, 2, 66, dtype=bf16)[..., :64].transpose(1, 2)
    elif case == "do_contiguous":  # contiguous [B, H, S, D], q a view
        do = torch.zeros(2, 4, 40, 64, dtype=bf16)
    return q, k, v, do


@pytest.mark.parametrize("case,want", [
    ("bf16_d64", "mma"), ("bf16_d128", "mma"), ("bf16_d80", "mma"),
    ("bf16_d32", "mma"), ("do_contiguous", "mma"), ("f32", "f32"),
    ("bf16_d84", "f32"), ("bf16_d256", "f32"), ("do_base", "f32"),
    ("do_row_stride", "f32"), ("k_row_stride", "f32"),
])
def test_backward_route_rule(case, want):
    """The rule that picks the CUDA backward's dk/dv and dq kernels, on CPU
    tensors: the forward's tensor-core rule for q, k and v plus dO's
    alignment takes the tensor-core pair, anything else the f32 pair.  On
    the CPU the wrapper still runs the plain version and launches
    nothing."""
    q, k, v, do = _bwd_route_inputs(case)
    assert fa_kernel.route_bwd(q, k, v, do) == want
    assert fa_kernel.route(q, k, v) == (
        "f32" if case in ("f32", "bf16_d84", "bf16_d256", "k_row_stride")
        else "mma")
    fa_kernel.reset_launches()
    o, lse = fa_kernel.flash_attention_lse(q, k, v)
    grads = fa_kernel.flash_attention_bwd(q, k, v, o, lse, do)
    assert [g.shape for g in grads] == [x.shape for x in (q, k, v)]
    assert all(n == 0 for n in fa_kernel.LAUNCHES.values())


def test_build_tag_hashes_the_local_headers(tmp_path):
    """A kernel library's build path changes with the source and with a
    header it includes (``#include "..."``, recursively), not with
    another file beside them; the port's two attention sources include
    ``hopper.cuh``."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "h.cuh"\nint a;\n')
    (csrc / "h.cuh").write_text('#include "g.cuh"\nint h;\n')
    (csrc / "g.cuh").write_text("int g;\n")
    (csrc / "other.cuh").write_text("int o;\n")
    lib = t_build.CudaLibrary(csrc / "a.cu", "a", lambda _: None)
    t_build._LIBRARIES.remove(lib)
    seen = [lib.path()]
    for name, text in (("other.cuh", "int o2;\n"), ("g.cuh", "int g2;\n"),
                       ("h.cuh", '#include "g.cuh"\nint h2;\n'),
                       ("a.cu", '#include "h.cuh"\nint a2;\n')):
        (csrc / name).write_text(text)
        seen.append(lib.path())
    assert seen[1] == seen[0] and len(set(seen)) == 4
    assert seen[0].parent == tmp_path / "build"
    fa_csrc = pathlib.Path(fa_kernel.__file__).parent / "csrc"
    header = (fa_csrc / "hopper.cuh").read_bytes()
    for src in ("flash_attention.cu", "flash_attention_bwd.cu"):
        assert header in t_build.source_bytes(fa_csrc / src)
    assert (fa_csrc / "tf32.cuh").read_bytes() in t_build.source_bytes(
        fa_csrc / "flash_attention_bwd.cu")


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the function '_ZN7bwd_mma25flash_bwd_dkdv_mma_kernelILi64ELi3ELi2EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiiiiiNS_10OutStridesES6_ffii'
ptxas info    : Compiling entry function '_ZN7bwd_mma25flash_bwd_dkdv_mma_kernelILi64ELi3ELi2EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiiiiiNS_10OutStridesES6_ffii' for 'sm_90a'
ptxas info    : Function properties for _ZN7bwd_mma25flash_bwd_dkdv_mma_kernelILi64ELi3ELi2EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiiiiiNS_10OutStridesES6_ffii
    16 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 166 registers, used 1 barriers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_bwd_dkdv_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_S4_PKfS6_PS2_S7_iiiiiiNS_7StridesES8_S8_S8_S8_S8_fii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_bwd_dkdv_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_S4_PKfS6_PS2_S7_iiiiiiNS_7StridesES8_S8_S8_S8_S8_fii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z14kv_read_kernelILb1EEvPKi' for 'sm_90a'
ptxas info    : Used 40 registers
"""


def test_ptxas_report_reads_registers_and_spills():
    """The build keeps what ``-Xptxas -v`` prints: each kernel by its
    demangled name and template arguments, its registers, its spilled
    bytes and whether ptxas serialized its wgmma products (C7512)."""
    assert t_build.ptxas_usage(PTXAS_LOG) == {
        "flash_bwd_dkdv_mma_kernel<64, 3, 2>": {
            "registers": 166, "spill_stores": 16, "spill_loads": 12,
            "wgmma_serialized": True},
        "flash_bwd_dkdv_kernel<__nv_bfloat16, 128>": {
            "registers": 128, "spill_stores": 0, "spill_loads": 0,
            "wgmma_serialized": False},
        "kv_read_kernel<1>": {
            "registers": 40, "spill_stores": 0, "spill_loads": 0,
            "wgmma_serialized": False}}
    assert "-v" in t_build.NVCC_FLAGS


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
