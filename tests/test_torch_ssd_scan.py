"""The port's SSD scan against the reference's, on the CPU.

``kernel.ssd_scan`` (on the CPU its plain version, ``ref.ssd_chunked``)
is held against the reference's Pallas kernel in interpret mode at the
shapes and tolerances of ``tests/test_kernels.py``, and its final state
against the reference's ``ssd_chunked``; ``ops.ssd`` for every ``impl``
and ``return_state`` against the reference's ``ops.ssd``; ragged
sequences, ``ssd_decode_step``, and the strided and stride-0 views the
model hands the kernel.  Inputs are made with numpy from a seed.  The
CUDA kernel itself runs only on a card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd_scan import kernel as j_kernel  # noqa: E402
from repro.kernels.ssd_scan import ops as j_ops  # noqa: E402
from repro.kernels.ssd_scan import ref as j_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as t_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as t_ref  # noqa: E402

F32_TOL, BF16_TOL = 1e-4, 5e-2


def _flat_inputs(rng, BH, L, P, N, dtype=np.float32):
    """The inputs of tests/test_kernels.py's SSD case, as numpy."""
    return dict(
        x=rng.standard_normal((BH, L, P)).astype(dtype),
        dt=rng.uniform(0.01, 0.2, (BH, L)).astype(dtype),
        A=-rng.uniform(0.5, 2.0, (BH,)).astype(np.float32),
        B=(rng.standard_normal((BH, L, N)) * 0.3).astype(dtype),
        C=(rng.standard_normal((BH, L, N)) * 0.3).astype(dtype),
        D=rng.standard_normal((BH,)).astype(np.float32))


def _model_inputs(rng, Bsz, L, H, P, N):
    """ops.ssd's arguments, as numpy float32."""
    return dict(
        x=rng.standard_normal((Bsz, L, H, P)).astype(np.float32),
        dt=rng.uniform(0.01, 0.2, (Bsz, L, H)).astype(np.float32),
        A=-rng.uniform(0.5, 2.0, (H,)).astype(np.float32),
        B=(rng.standard_normal((Bsz, L, N)) * 0.3).astype(np.float32),
        C=(rng.standard_normal((Bsz, L, N)) * 0.3).astype(np.float32),
        D=rng.standard_normal((H,)).astype(np.float32))


def _jax(inputs, dtype=None):
    return {k: jnp.asarray(v) if dtype is None or k in ("A", "D")
            else jnp.asarray(v, dtype) for k, v in inputs.items()}


def _torch(inputs, dtype=None):
    return {k: torch.from_numpy(v) if dtype is None or k in ("A", "D")
            else torch.from_numpy(v).to(dtype) for k, v in inputs.items()}


def _err(got, exp) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - np.asarray(jnp.asarray(exp, jnp.float32)))
                 .max())


@pytest.mark.parametrize("BH,L,P,N,chunk,dtype", [
    (4, 128, 64, 32, 64, "float32"),
    (2, 256, 32, 64, 64, "float32"),
    (2, 128, 64, 128, 32, "bfloat16"),
    (1, 64, 32, 16, 16, "float32"),
])
def test_ssd_scan_matches_reference_kernel(BH, L, P, N, chunk, dtype):
    rng = np.random.default_rng(3)
    inputs = _flat_inputs(rng, BH, L, P, N)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
                else (jnp.float32, torch.float32))
    j, t = _jax(inputs, jdt), _torch(inputs, tdt)
    exp = j_kernel.ssd_scan(j["x"], j["dt"], j["A"], j["B"], j["C"],
                            j["D"], chunk=chunk)
    t_kernel.reset_launches()
    got, h = t_kernel.ssd_scan(t["x"], t["dt"], t["A"], t["B"], t["C"],
                               t["D"], chunk=chunk, h_final=True)
    assert t_kernel.LAUNCHES["ssd_scan"] == 0     # the CPU runs the plain
    assert got.dtype == tdt and tuple(got.shape) == exp.shape
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    assert _err(got, exp) < tol
    # the final state, which the kernel emits, against ssd_chunked's
    _, h_exp = j_ref.ssd_chunked(j["x"], j["dt"], j["A"], j["B"], j["C"],
                                 j["D"], chunk=chunk)
    assert h.dtype == torch.float32 and tuple(h.shape) == (BH, N, P)
    assert _err(h, h_exp) < tol
    # and the per-step recurrence, the reference's oracle
    assert _err(got, j_ref.ssd_scan_ref(j["x"], j["dt"], j["A"], j["B"],
                                        j["C"], j["D"])) < tol


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("impl", ["pallas", "chunked", "recurrent"])
def test_ssd_ops_match_reference(impl, return_state):
    rng = np.random.default_rng(4)
    inputs = _model_inputs(rng, 2, 96, 3, 16, 8)
    j, t = _jax(inputs), _torch(inputs)
    args = ("x", "dt", "A", "B", "C", "D")
    exp = j_ops.ssd(*(j[k] for k in args), impl=impl, chunk=32,
                    return_state=return_state)
    got = t_ops.ssd(*(t[k] for k in args), impl=impl, chunk=32,
                    return_state=return_state)
    if not return_state:
        exp, got = (exp,), (got,)
    for g, e in zip(got, exp):
        assert g.dtype == torch.float32 and tuple(g.shape) == e.shape
        assert _err(g, e) < F32_TOL


@pytest.mark.parametrize("L,chunk", [(200, 64), (40, 64), (75, 16)])
def test_ragged_sequences_match_reference_chunked(L, chunk):
    """The port's kernel path (plain version here) on a sequence that is
    not a multiple of the chunk, or shorter than it, against the
    reference's ``chunked``, which pads."""
    rng = np.random.default_rng(5)
    inputs = _model_inputs(rng, 2, L, 4, 32, 16)
    j, t = _jax(inputs), _torch(inputs)
    args = ("x", "dt", "A", "B", "C", "D")
    ey, eh = j_ops.ssd(*(j[k] for k in args), impl="chunked", chunk=chunk,
                       return_state=True)
    gy, gh = t_ops.ssd(*(t[k] for k in args), impl="pallas", chunk=chunk,
                       return_state=True)
    assert tuple(gy.shape) == ey.shape and tuple(gh.shape) == eh.shape
    assert _err(gy, ey) < F32_TOL and _err(gh, eh) < F32_TOL


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(6)
    Bsz, H, P, N = 2, 3, 16, 8
    h = rng.standard_normal((Bsz, H, N, P)).astype(np.float32)
    x = rng.standard_normal((Bsz, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (Bsz, H)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bt, Ct = (rng.standard_normal((Bsz, N)).astype(np.float32)
              for _ in range(2))
    D = rng.standard_normal((H,)).astype(np.float32)
    args = (h, x, dt, A, Bt, Ct, D)
    eh, ey = j_ops.ssd_decode_step(*map(jnp.asarray, args))
    gh, gy = t_ops.ssd_decode_step(*map(torch.from_numpy, args))
    assert _err(gh, eh) < 1e-6 and _err(gy, ey) < 1e-6


def test_ssd_decode_steps_continue_the_scan():
    """Prefill's final state, stepped on, equals the scan of the longer
    sequence (the port alone: its own decode against its own scan)."""
    rng = np.random.default_rng(7)
    t = _torch(_model_inputs(rng, 2, 40, 3, 16, 8))
    y_all = t_ops.ssd(t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"],
                      impl="recurrent")
    _, h = t_ops.ssd(t["x"][:, :36], t["dt"][:, :36], t["A"],
                     t["B"][:, :36], t["C"][:, :36], t["D"], impl="pallas",
                     chunk=16, return_state=True)
    for i in range(36, 40):
        h, y = t_ops.ssd_decode_step(h, t["x"][:, i], t["dt"][:, i],
                                     t["A"], t["B"][:, i], t["C"][:, i],
                                     t["D"])
        assert float((y - y_all[:, i]).abs().max()) < F32_TOL


def test_strided_and_broadcast_views_equal_contiguous_inputs():
    """x as a strided view of a wider tensor (the model's split of the
    conv output) and B/C broadcast over heads give what contiguous
    copies give, bit for bit."""
    rng = np.random.default_rng(8)
    Bsz, L, H, P, N = 2, 70, 4, 16, 8
    wide = torch.from_numpy(rng.standard_normal(
        (Bsz, L, H * P + 2 * N)).astype(np.float32))
    x_view = wide[..., : H * P].reshape(Bsz, L, H, P)
    assert not x_view.is_contiguous() and x_view.stride(-1) == 1
    t = _torch(_model_inputs(rng, Bsz, L, H, P, N))
    B_view, C_view = wide[..., H * P: H * P + N], wide[..., H * P + N:]
    view = t_kernel.ssd_scan_heads(x_view, t["dt"], t["A"], B_view, C_view,
                                   t["D"], chunk=32, h_final=True)
    copy = t_kernel.ssd_scan_heads(x_view.contiguous(), t["dt"], t["A"],
                                   B_view.contiguous(), C_view.contiguous(),
                                   t["D"], chunk=32, h_final=True)
    for a, b in zip(view, copy):
        assert torch.equal(a, b)
    # the flat signature on per-head copies gives the same numbers
    flat = t_kernel.ssd_scan(
        *t_ref.flatten_heads(x_view, t["dt"], t["A"], B_view, C_view,
                             t["D"]), chunk=32, h_final=True)
    for a, b in zip(t_ref.unflatten_heads(*flat, Bsz, H), view):
        assert torch.equal(a, b)


@pytest.mark.parametrize("what", ["chunk", "head_dim", "state", "dtype",
                                  "last_dim_stride", "shape"])
def test_wrapper_refuses_what_the_kernel_does_not_take(what):
    rng = np.random.default_rng(9)
    P = 65 if what == "head_dim" else 16
    N = 129 if what == "state" else 8
    t = _torch(_flat_inputs(rng, 2, 80, P, N))
    x = t["x"].to(torch.float16) if what == "dtype" else t["x"]
    if what == "last_dim_stride":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    dt = t["dt"][:, :79] if what == "shape" else t["dt"]
    chunk = 65 if what == "chunk" else 64
    with pytest.raises((ValueError, TypeError)):
        t_kernel.ssd_scan(x, dt, t["A"], t["B"], t["C"], t["D"],
                          chunk=chunk)


def test_plain_versions_agree():
    """The chunked form and the per-step recurrence of the port agree
    (float32), with a chunk that does not divide L."""
    rng = np.random.default_rng(10)
    t = _torch(_flat_inputs(rng, 3, 90, 16, 8))
    args = (t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"])
    y1, h1 = t_ref.ssd_chunked(*args, chunk=32)
    y2, h2 = t_ref.ssd_scan_with_final_ref(*args)
    assert float((y1 - y2).abs().max()) < F32_TOL
    assert float((h1 - h2).abs().max()) < F32_TOL


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_split_tf32_products_keep_the_final_state_within_1e5(dtype):
    """The kernel's product arithmetic on the CPU: ``ssd_chunked`` with its
    three per-head products (M x, C h, the state update) in 3xTF32 keeps
    the final state within 1e-5 of its magnitude of the reference's
    ``ssd_chunked`` (the limit ``chip_smoke.py`` holds the kernel to),
    and with plain TF32 products misses that limit at the same inputs,
    which is why the kernel splits its operands.  Inputs are drawn as
    phase 12 draws them (N = 128, P = 64, a ragged last chunk)."""
    rng = np.random.default_rng(17)
    BH, L, P, N = 2, 200, 64, 128
    wide = rng.standard_normal((BH, L, P + 2 * N)).astype(np.float32)
    inputs = dict(
        x=wide[..., :P], dt=rng.uniform(0.01, 0.2, (BH, L)).astype(
            np.float32),
        A=-rng.uniform(0.5, 2.0, BH).astype(np.float32),
        B=wide[..., P: P + N] * 0.3, C=wide[..., P + N:] * 0.3,
        D=rng.standard_normal(BH).astype(np.float32))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         inputs.items()}
    t["x"] = t["x"].to(tdt)
    j = {k: jnp.asarray(v.float().numpy()) for k, v in t.items()}
    _, h_ref = j_ref.ssd_chunked(j["x"], j["dt"], j["A"], j["B"], j["C"],
                                 j["D"], chunk=64)
    h_ref = np.asarray(h_ref)
    args = (t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"])

    def rel(product):
        _, h = t_ref.ssd_chunked(*args, chunk=64, product=product)
        return float(np.abs(h.numpy() - h_ref).max() / np.abs(h_ref).max())
    assert rel(t_ref.split_tf32_product) <= 1e-5
    assert rel(t_ref.tf32_product) > 1e-5


def test_tf32_rounding_is_to_nearest_ties_away():
    """``tf32_round`` rounds as ``cvt.rna.tf32.f32`` (to nearest, ties
    away from zero, on a 10-bit mantissa); ``tf32_truncate`` keeps the
    TF32 part the tensor cores read; hi + lo recovers the value to 2^-21
    of its magnitude."""
    ulp = 2.0 ** -10
    v = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, -(1 + ulp / 2),
                      1 + 1.5 * ulp, 3.0, 1 + ulp - 2 ** -23],
                     dtype=torch.float32)
    assert t_ref.tf32_round(v).tolist() == [
        1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp, 3.0, 1 + ulp]
    assert t_ref.tf32_truncate(v).tolist() == [1.0, 1.0, -1.0, 1 + ulp, 3.0,
                                               1.0]
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        1000).astype(np.float32))
    hi = t_ref.tf32_round(x)
    lo = t_ref.tf32_truncate(x - hi)
    assert float(((hi + lo) - x).abs().max() / x.abs().max()) <= 2.0 ** -21


@pytest.mark.parametrize("L,chunk", [(200, 64), (40, 64), (75, 16)])
def test_chunk_cb_plain_version(L, chunk):
    """``chunk_cb`` (on the CPU its plain version): C B^T within each
    chunk, a ragged last chunk zero past L, against numpy."""
    rng = np.random.default_rng(12)
    B, C = (rng.standard_normal((2, L, 24)).astype(np.float32)
            for _ in range(2))
    t_kernel.reset_launches()
    g = t_kernel.chunk_cb(torch.from_numpy(B), torch.from_numpy(C),
                          chunk=chunk)
    assert t_kernel.LAUNCHES == {"ssd_cb": 0, "ssd_scan": 0}
    q = min(chunk, L)
    nc = -(-L // q)
    pad = ((0, 0), (0, nc * q - L), (0, 0))
    Bp = np.pad(B, pad).reshape(2, nc, q, 24)
    Cp = np.pad(C, pad).reshape(2, nc, q, 24)
    exp = np.einsum("bctn,bcsn->bcts", Cp, Bp)
    assert tuple(g.shape) == exp.shape
    np.testing.assert_allclose(g.numpy(), exp, rtol=1e-5, atol=1e-5)
