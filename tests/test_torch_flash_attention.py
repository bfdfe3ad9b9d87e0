"""The port's attention against the reference's.

On the CPU ``mha(impl="pallas")`` runs the flash_attention kernel's plain
version (``ref.flash_attention_ref``); it is held against the reference's
Pallas kernel in interpret mode (as ``tests/test_kernels.py`` runs it) on
that test's cases, a GQA group of 8, a causal ``S != SK`` case and the
non-causal cases of the encoder-decoder (``S == SK``, ``S < SK`` with a
ragged key edge, ``S > SK``).
``mha(impl="naive")`` is held against the reference's ``attention_ref``.
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  Tolerances are the
reference kernel test's: 2e-5 in float32 (summation order), 2e-2 in bf16
(one rounding of the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import kernel as j_kernel  # noqa: E402
from repro.kernels.flash_attention import ref as j_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as t_ref  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, B, HQ, HKV, S, SK, D, dtype):
    """The same q, k, v for both packages (float32 numpy, then each
    package's cast)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32) for shape in
              ((B, HQ, S, D), (B, HKV, SK, D), (B, HKV, SK, D))]
    jdt, tdt, tol = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays], tol)


def _err(got, exp) -> float:
    return float(np.abs(got.float().numpy()
                        - np.asarray(exp.astype(jnp.float32))).max())


@pytest.mark.parametrize("B,HQ,HKV,S,SK,D,causal,dtype", [
    # tests/test_kernels.py::test_flash_pallas_matches_ref
    (2, 4, 2, 256, 256, 64, True, "f32"),
    (1, 8, 8, 128, 128, 128, True, "bf16"),
    (1, 4, 1, 200, 200, 64, False, "f32"),
    (2, 2, 2, 128, 128, 32, True, "bf16"),
    # a GQA group of 8 (Qwen2.5-3B's 16 / 2 heads), both types
    (1, 8, 1, 128, 128, 128, True, "bf16"),
    (1, 8, 1, 96, 96, 64, True, "f32"),
    # causal with S != SK: the kernel's top-left alignment
    (1, 4, 2, 100, 224, 32, True, "f32"),
    (1, 4, 2, 160, 96, 32, True, "bf16"),
    # non-causal (Whisper's encoder and cross-attention): S == SK, S < SK
    # with a ragged k edge (300 keys: no multiple of the 128-key tiles,
    # as Whisper's 1,500 frames are none of the kernel's 64), S > SK
    (1, 4, 4, 256, 256, 64, False, "f32"),
    (2, 4, 4, 64, 300, 64, False, "f32"),
    (1, 4, 2, 300, 96, 32, False, "f32"),
    (1, 4, 4, 64, 300, 64, False, "bf16"),
])
def test_flash_plain_matches_pallas_kernel(B, HQ, HKV, S, SK, D, causal,
                                           dtype):
    (jq, jk, jv), (tq, tk, tv), tol = _inputs(1, B, HQ, HKV, S, SK, D,
                                              dtype)
    exp = j_kernel.flash_attention(jq, jk, jv, causal=causal)
    t_kernel.reset_launches()
    got = t_ops.mha(tq, tk, tv, causal=causal, impl="pallas")
    assert got.dtype == tq.dtype and got.shape == (B, HQ, S, D)
    assert _err(got, exp) < tol
    # on the CPU the wrapper runs the plain version: no launch
    assert t_kernel.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("B,HQ,HKV,S,SK,D,causal,dtype", [
    (2, 4, 2, 64, 64, 32, True, "f32"),
    (1, 8, 1, 48, 48, 64, True, "bf16"),
    (1, 4, 2, 40, 72, 32, True, "f32"),
    (1, 4, 4, 72, 40, 16, False, "bf16"),
    (2, 4, 4, 24, 100, 32, False, "f32"),
])
def test_naive_matches_attention_ref(B, HQ, HKV, S, SK, D, causal, dtype):
    (jq, jk, jv), (tq, tk, tv), tol = _inputs(2, B, HQ, HKV, S, SK, D,
                                              dtype)
    exp = j_ref.attention_ref(jq, jk, jv, causal=causal)
    got = t_ops.mha(tq, tk, tv, causal=causal, impl="naive")
    assert got.dtype == tq.dtype and got.shape == (B, HQ, S, D)
    assert _err(got, exp) < tol


def test_causal_alignment_differs_when_s_ne_sk():
    """The reference's two causal masks disagree when S != SK (the Pallas
    kernel aligns top-left, attention_ref bottom-right); the port follows
    each, so each side matches its counterpart and not the other."""
    (jq, jk, jv), (tq, tk, tv), tol = _inputs(3, 1, 4, 2, 64, 160, 32,
                                              "f32")
    j_flash = j_kernel.flash_attention(jq, jk, jv, causal=True)
    j_naive = j_ref.attention_ref(jq, jk, jv, causal=True)
    t_flash = t_ops.mha(tq, tk, tv, causal=True, impl="pallas")
    t_naive = t_ops.mha(tq, tk, tv, causal=True, impl="naive")
    assert _err(t_flash, j_flash) < tol and _err(t_naive, j_naive) < tol
    assert _err(t_flash, j_naive) > 0.1 and _err(t_naive, j_flash) > 0.1
    # at S == SK the two agree
    (jq, jk, jv), (tq, tk, tv), tol = _inputs(3, 1, 4, 2, 96, 96, 32, "f32")
    assert float((t_ops.mha(tq, tk, tv, impl="pallas")
                  - t_ops.mha(tq, tk, tv, impl="naive")).abs().max()) < tol


def test_flash_reads_strided_views_in_place():
    """The model hands the kernel transposed [B, S, H, D] views: the
    result equals that of contiguous copies, in q's layout."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((2, 40, 8, 32),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 40, 2, 32),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 40, 2, 32),
                                             dtype=np.float32))
    views = [x.transpose(1, 2) for x in (q, k, v)]
    got = t_kernel.flash_attention(*views)
    exp = t_kernel.flash_attention(*[x.contiguous() for x in views])
    assert torch.equal(got, exp)


@pytest.mark.parametrize("case", ["heads", "head_dim", "dtype", "rank",
                                  "last_dim", "no_keys"])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(case):
    q = torch.zeros(1, 4, 8, 32)
    k = v = torch.zeros(1, 2, 8, 32)
    if case == "heads":
        k = v = torch.zeros(1, 3, 8, 32)
    elif case == "head_dim":
        q, k, v = (torch.zeros(x.shape[:3] + (288,)) for x in (q, k, v))
    elif case == "dtype":
        k = k.half()
    elif case == "rank":
        q = q[0]
    elif case == "last_dim":
        q = torch.zeros(1, 4, 32, 8).transpose(2, 3)
    else:
        k = v = torch.zeros(1, 2, 0, 32)
    with pytest.raises((ValueError, TypeError)):
        t_kernel.flash_attention(q, k, v)


def _route_inputs(case):
    """q, k, v on the CPU for each case of the route rule."""
    bf16 = torch.bfloat16
    view = lambda H, D, dt=bf16: torch.zeros(2, 40, H, D,
                                             dtype=dt).transpose(1, 2)
    if case.startswith("bf16_d"):   # head dims 32-256
        D = int(case[6:])
        return view(8, D), view(2, D), view(2, D)
    if case == "bf16_contiguous":
        return (torch.zeros(1, 8, 40, 128, dtype=bf16),
                torch.zeros(1, 2, 40, 128, dtype=bf16),
                torch.zeros(1, 2, 40, 128, dtype=bf16))
    if case == "f32":
        return view(8, 128, torch.float32), view(2, 128, torch.float32), \
            view(2, 128, torch.float32)
    if case == "bf16_row_stride":   # rows of 130 elements: not 16-byte
        k = torch.zeros(2, 40, 2, 130, dtype=bf16)[..., :128]
        return view(8, 128), k.transpose(1, 2), view(2, 128)
    # case == "bf16_base": a base 2 bytes past a 16-byte boundary
    flat = torch.zeros(1 + 2 * 40 * 2 * 128, dtype=bf16)[1:]
    v = flat.view(2, 40, 2, 128).transpose(1, 2)
    return view(8, 128), view(2, 128), v


@pytest.mark.parametrize("case,want", [
    ("bf16_d64", "mma"), ("bf16_d128", "mma"), ("bf16_contiguous", "mma"),
    ("f32", "f32"), ("bf16_d32", "mma"), ("bf16_d80", "mma"),
    ("bf16_d256", "f32"), ("bf16_d84", "f32"),
    ("bf16_row_stride", "f32"), ("bf16_base", "f32"),
])
def test_flash_route_rule(case, want):
    """The rule that picks a CUDA kernel, on CPU tensors: bf16 with a head
    dim of at most 128, a multiple of 8 (Zamba2's 80 among them), and
    16-byte-aligned bases and strides takes the tensor-core kernel;
    float32, wider or ragged head dims and misaligned views the f32 one.
    On the CPU the wrapper still runs the plain version."""
    q, k, v = _route_inputs(case)
    assert t_kernel.route(q, k, v) == want
    t_kernel.reset_launches()
    got = t_kernel.flash_attention(q, k, v)
    assert got.shape == q.shape and got.dtype == q.dtype
    assert all(n == 0 for n in t_kernel.LAUNCHES.values())


def test_mha_chunked_waits_for_the_training_slice():
    """The training slice has come: ``impl="chunked"`` no longer raises
    but is the reference's ``chunked_attention`` (``ChunkedAttention``,
    on the CPU its plain versions), equal to the oracle here; an unknown
    impl still raises."""
    x = torch.randn(1, 2, 4, 8, generator=torch.Generator().manual_seed(0))
    got = t_ops.mha(x, x, x, impl="chunked")
    assert float((got - t_ref.attention_ref(x, x, x)).abs().max()) < 1e-6
    with pytest.raises(ValueError):
        t_ops.mha(x, x, x, impl="fused")


def test_plain_versions_agree_at_s_eq_sk_with_the_reference_oracle():
    """The kernel's plain version equals the reference's oracle (the
    target of the reference kernel test) at the serving path's S == SK."""
    (jq, jk, jv), (tq, tk, tv), tol = _inputs(5, 2, 8, 1, 80, 80, 64,
                                              "bf16")
    exp = j_ref.attention_ref(jq, jk, jv, causal=True)
    assert _err(t_ref.flash_attention_ref(tq, tk, tv), exp) < tol


@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_at_head_dim_80_matches_the_reference_oracle(causal):
    """Zamba2's head dim (2560 / 32 = 80) in the plain version the CPU
    runs: equal to the reference's oracle at S == SK, with the scale
    ``80 ** -0.5`` taken from the real head dim, in both types."""
    for dtype in ("f32", "bf16"):
        (jq, jk, jv), (tq, tk, tv), tol = _inputs(6, 2, 4, 4, 72, 72, 80,
                                                  dtype)
        exp = j_ref.attention_ref(jq, jk, jv, causal=causal)
        assert _err(t_ref.flash_attention_ref(tq, tk, tv, causal=causal),
                    exp) < tol
        assert _err(t_kernel.flash_attention(tq, tk, tv, causal=causal),
                    exp) < tol
        given = t_kernel.flash_attention(tq, tk, tv, causal=causal,
                                         scale=80 ** -0.5)
        assert torch.equal(given, t_kernel.flash_attention(
            tq, tk, tv, causal=causal))


# ---------------------------------------------------------------------------
# the f32 route's split TF32 products, emulated; delta and its width rule
# ---------------------------------------------------------------------------
# (B, HQ, HKV, S, SK, D, causal), float32: GQA at head dims 64 and 128,
# S != SK both ways (the kernel's top-left mask), non-causal with a ragged
# key edge, and the widest head dim the route takes
SPLIT_CASES = {
    "gqa_d64": (2, 4, 2, 128, 128, 64, True),
    "gqa_d128_s_lt_sk": (1, 4, 2, 64, 200, 128, True),
    "noncausal_ragged": (1, 4, 1, 96, 160, 32, False),
    "d256_s_gt_sk": (1, 2, 2, 130, 70, 256, False),
}
SPLIT_TOL = 1e-5   # of the largest magnitude; 2e-7-1e-6 read here


def _split_err(case):
    B, HQ, HKV, S, SK, D, causal = SPLIT_CASES[case]
    (jq, jk, jv), (tq, tk, tv), _ = _inputs(7, B, HQ, HKV, S, SK, D, "f32")
    exp = np.asarray(j_kernel.flash_attention(jq, jk, jv, causal=causal))
    got = t_ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                    split_tf32=True)
    assert got.dtype == torch.float32 and got.shape == (B, HQ, S, D)
    return float(np.abs(got.numpy() - exp).max() / np.abs(exp).max())


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_tf32_plain_matches_pallas_kernel(case):
    """Both products as the f32 route's kernel forms them (each operand
    split into a TF32-rounded hi and a lo read as TF32, lo times lo
    dropped): the reference's Pallas kernel in interpret mode within 1e-5
    of the largest magnitude, and not the plain version bit for bit."""
    assert _split_err(case) <= SPLIT_TOL
    B, HQ, HKV, S, SK, D, causal = SPLIT_CASES[case]
    _, (tq, tk, tv), _ = _inputs(7, B, HQ, HKV, S, SK, D, "f32")
    assert not torch.equal(
        t_ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                  split_tf32=True),
        t_ref.flash_attention_ref(tq, tk, tv, causal=causal))


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_one_term_tf32_plain_reads_past_the_limit(case, monkeypatch):
    """The control: the same emulation with one TF32 product a pair of
    operands (``tf32_product``, both rounded to TF32) reads past 1e-5 of
    the Pallas kernel, so the hold above sees a dropped split."""
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    monkeypatch.setattr(t_ref, "split_tf32_product", ssd_ref.tf32_product)
    assert _split_err(case) > SPLIT_TOL


@pytest.mark.parametrize("D", [1, 33, 64, 66, 80, 128, 256])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_delta_ref_equals_the_reference_expression(D, dtype):
    """``ref.delta_ref`` (the plain version of ``kernel.flash_bwd_delta``)
    equals the reference's ``(do.astype(f32) * o.astype(f32)).sum(-1)``
    (``ops.py::_chunked_core_bwd``) bit for bit in float32, through
    XLA's windows of 32 (``ref._window_sums``), at head dims below, at
    and past one window, ragged or not; on the CPU the wrapper runs it
    and launches nothing."""
    (jo, jdo, _), (to, tdo, _), _ = _inputs(8, 2, 3, 3, 37, 37, D, dtype)
    exp = np.asarray((jdo.astype(jnp.float32) * jo.astype(jnp.float32))
                     .sum(-1))
    got = t_ref.delta_ref(to, tdo)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), exp)
    t_kernel.reset_launches()
    assert torch.equal(t_kernel.flash_bwd_delta(to, tdo), got)
    assert t_kernel.LAUNCHES["flash_bwd_delta"] == 0


def _delta_views(case, dtype):
    """o and dO as [B, H, S, D] views of [B, S, H, D] tensors: aligned;
    dO's base one element past its allocation's start; rows of D + 1
    elements; an odd head dim."""
    D = 63 if case == "odd_d" else 64
    pad = 1 if case == "row_pad" else 0

    def view(off=0):
        flat = torch.zeros(off + 2 * 5 * 3 * (D + pad), dtype=dtype)[off:]
        return flat.view(2, 5, 3, D + pad)[..., :D].transpose(1, 2)
    return view(), view(1 if case == "do_base" else 0)


@pytest.mark.parametrize("case,f32_width,bf16_width", [
    ("aligned", 16, 16), ("do_base", 4, 2), ("row_pad", 4, 2),
    ("odd_d", 4, 2),
])
def test_delta_load_width_rule(case, f32_width, bf16_width):
    """The rule that sets the delta kernel's loads: 16 bytes where the
    head dim and both tensors' bases and strides allow, else 4, else one
    element; each case still runs the plain version on the CPU."""
    for dtype, want in ((torch.float32, f32_width),
                        (torch.bfloat16, bf16_width)):
        o, do = _delta_views(case, dtype)
        if case == "do_base":
            assert do.data_ptr() % 4 == (0 if dtype == torch.float32
                                         else 2)
        assert t_kernel.delta_width(o, do) == want, dtype
        assert torch.equal(t_kernel.flash_bwd_delta(o, do),
                           t_ref.delta_ref(o, do))
