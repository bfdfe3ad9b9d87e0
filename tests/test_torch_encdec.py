"""The port's encoder-decoder (Whisper) against the reference's, on the CPU.

The reduced Whisper-base (2 encoder and 2 decoder layers, d 128, 4 heads
of 32, ``enc_len`` 32): the layers it adds (``layernorm``, ``gelu_mlp``
with jax's tanh GELU, ``sinusoidal_positions``) within 1e-6 in float32;
then ``encode``, ``encdec_prefill`` (every leaf of its cache, the
per-layer cross K/V among them) and three teacher-forced
``encdec_decode_step``s, with the naive attention and with
``impl="pallas"`` (the kernel's plain version on the CPU, non-causal in
the encoder and the cross-attention), held against the JAX package on
the same weights (``convert.encdec_params_from`` of the reference's
``init_encdec``) and frames made with numpy (normal x 0.1, as
``make_batch`` draws them).  In a float32-compute variant of the config
the memory, the logits and the cache agree within 1e-4 of their largest
magnitude and the greedy tokens exactly; in the configured bf16 compute
the memory and the logits agree within 3e-2 of the reference run op by
op (``jax.disable_jit``).  Then the torch forms of
``tests/test_models.py::test_decode_matches_prefill_f32[whisper-base]``
and ``tests/test_archs_smoke.py``'s full-config and reduced
prefill/decode tests, the empty cache's layout, the engine against the
reference's tokens (zero frames, as both engines give them) and a
manual greedy loop, the converter's round trip and the weights the
engine reads.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import encdec as TED  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TTF  # noqa: E402
from repro_torch.serve.engine import Request, ServingEngine  # noqa: E402

CPU = "cpu"
ARCH = "whisper-base"
PROMPT, CACHE, STEPS = 13, 24, 3
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _cfgs(compute_dtype="bfloat16"):
    """The reference's and the port's reduced config, equal field by
    field."""
    out = [dataclasses.replace(get(ARCH).reduced(),
                               compute_dtype=compute_dtype)
           for get in (j_get_config, get_config)]
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


def _rel(got, exp) -> float:
    got = got.float().numpy()
    exp = np.asarray(exp, np.float32)
    return float(np.abs(got - exp).max() / np.abs(exp).max())


def _leaves(cache):
    """A cache's tensor leaves by name, ``t`` left out."""
    return {"k": cache["kv"][0], "v": cache["kv"][1],
            "cross_k": cache["cross"][0], "cross_v": cache["cross"][1]}


_REFERENCE = {}


def _reference():
    """The reference's reduced model: numpy params, the frames (seeded and
    zeros) and prompts, and per compute dtype the encoder's memory, the
    prefill (logits, cache) and STEPS greedy decode steps (logits per
    step, the greedy tokens, the last cache): float32 in one jit (the
    file's one model compile, called for both frames), bf16 op by op."""
    if not _REFERENCE:
        cfgs = {cd: _cfgs(cd) for cd in TOL}
        jcfgs = {cd: c[0] for cd, c in cfgs.items()}
        jcfg = jcfgs["float32"]
        params = JED.init_encdec(jcfg, jax.random.PRNGKey(0))
        rng = np.random.default_rng(9)
        frames = (rng.standard_normal((2, jcfg.enc_len, jcfg.d_model))
                  * 0.1).astype(np.float32)
        toks = rng.integers(0, jcfg.vocab, (2, PROMPT)).astype(np.int32)

        def serve(p, frames, toks, jcfg):
            memory = JED.encode(p, jcfg, frames).astype(jnp.float32)
            lg, cache = JED.encdec_prefill(p, jcfg, frames, toks,
                                           cache_len=CACHE)
            first = cache
            logits, out = [lg], []
            for _ in range(STEPS):
                tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
                out.append(tok)
                lg, cache = JED.encdec_decode_step(p, jcfg, cache, tok)
                logits.append(lg)
            out.append(jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32))
            return (memory, logits, jnp.concatenate(out, axis=1), first,
                    cache)

        t, f = jnp.asarray(toks), jnp.asarray(frames)
        f32 = jax.jit(lambda p, f, t: serve(p, f, t, jcfg))
        outs = {"float32": f32(params, f, t)}
        zero = f32(params, jnp.zeros_like(f), t)
        with jax.disable_jit():
            outs["bfloat16"] = serve(params, f, t, jcfgs["bfloat16"])
        to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
        _REFERENCE.update(
            params=to_np(params), frames=frames, toks=toks,
            zero_frame_tokens=np.asarray(zero[2]),
            **{cd: dict(tcfg=cfgs[cd][1], memory=np.asarray(outs[cd][0]),
                        logits=[np.asarray(x) for x in outs[cd][1]],
                        tokens=np.asarray(outs[cd][2]),
                        first=to_np(outs[cd][3]), last=to_np(outs[cd][4]))
               for cd in TOL})
    return _REFERENCE


def _params(cd):
    ref = _reference()
    return convert.encdec_params_from(ref["params"], ref[cd]["tcfg"], CPU)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_layernorm_and_gelu_mlp_match_reference():
    rng = np.random.default_rng(1)
    d, f = 96, 160
    x = rng.standard_normal((3, 7, d)).astype(np.float32) * 2 + 0.5
    ln = {"scale": rng.standard_normal(d).astype(np.float32),
          "bias": rng.standard_normal(d).astype(np.float32)}
    mlp = {"w_up": {"w": rng.standard_normal((d, f)).astype(np.float32)
                    * d ** -0.5,
                    "b": rng.standard_normal(f).astype(np.float32)},
           "w_down": {"w": rng.standard_normal((f, d)).astype(np.float32)
                      * f ** -0.5,
                      "b": rng.standard_normal(d).astype(np.float32)}}
    jx = jnp.asarray(x)
    exp_ln = JL.layernorm(jax.tree.map(jnp.asarray, ln), jx)
    exp_mlp = JL.gelu_mlp(jax.tree.map(jnp.asarray, mlp), jx,
                          compute_dtype=jnp.float32)
    tx = torch.from_numpy(x)
    got_ln = TL.layernorm(convert.params_from(ln, CPU), tx)
    got_mlp = TL.gelu_mlp(convert.params_from(mlp, CPU), tx,
                          compute_dtype=torch.float32)
    assert got_ln.dtype == torch.float32 and got_mlp.dtype == torch.float32
    assert _rel(got_ln, exp_ln) < 1e-6
    assert _rel(got_mlp, exp_mlp) < 1e-6
    # bf16 in, bf16 out: the norm works in float32 and casts back
    xb = tx.to(torch.bfloat16)
    got = TL.layernorm(convert.params_from(ln, CPU), xb)
    exp = JL.layernorm(jax.tree.map(jnp.asarray, ln),
                       jx.astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and _rel(got, exp) < 1e-2
    # the tanh approximation (jax.nn.gelu's default), not the exact erf
    h = torch.linspace(-4, 4, 101)
    exact = torch.nn.functional.gelu(h)
    tanh = torch.nn.functional.gelu(h, approximate="tanh")
    assert float((tanh - exact).abs().max()) > 1e-4
    np.testing.assert_allclose(
        tanh.numpy(), np.asarray(jax.nn.gelu(jnp.asarray(h.numpy()))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("S,d", [(1500, 512), (32, 128), (5, 2), (9, 7)])
def test_sinusoidal_positions_match_reference(S, d):
    """The reference's formula, its ``max(d // 2 - 1, 1)`` step included
    (``d = 2``: one frequency; odd ``d``: ``2 * (d // 2)`` columns)."""
    got = TL.sinusoidal_positions(S, d, device="cpu")
    exp = np.asarray(JL.sinusoidal_positions(S, d))
    assert tuple(got.shape) == exp.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["naive", "pallas"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_encode_prefill_and_decode_match_reference(cd, impl, monkeypatch):
    ref = _reference()
    run = ref[cd]
    tcfg = run["tcfg"]
    params = _params(cd)
    flags = TTF.OptFlags(attn_impl=impl)
    frames, toks = (torch.from_numpy(ref[k]) for k in ("frames", "toks"))
    plain = []
    real = fa_ref.flash_attention_ref
    monkeypatch.setattr(fa_ref, "flash_attention_ref",
                        lambda *a, **k: plain.append(k["causal"])
                        or real(*a, **k))
    fa_kernel.reset_launches()
    with torch.inference_mode():
        memory = TED.encode(params, tcfg, frames, flags)
        lg, cache = TED.encdec_prefill(params, tcfg, frames, toks,
                                       cache_len=CACHE, flags=flags)
        first = {k: v.clone() for k, v in _leaves(cache).items()}
        logits, ours = [lg], []
        for i in range(STEPS):
            ours.append(torch.argmax(lg[:, -1], -1))
            # teacher-forced with the reference's token
            tok = torch.from_numpy(run["tokens"][:, i: i + 1].copy())
            lg, cache = TED.encdec_decode_step(params, tcfg, cache, tok,
                                               flags)
            logits.append(lg)
        ours.append(torch.argmax(lg[:, -1], -1))
    # no kernel launch on the CPU; with "pallas" the plain version answers
    # every prefill attention: the encoder's (non-causal) twice, then the
    # encoder again, each decoder layer's causal self and non-causal cross
    assert sum(fa_kernel.LAUNCHES.values()) == 0
    enc = [False] * tcfg.enc_layers
    assert plain == ([] if impl == "naive" else
                     enc + enc + [True, False] * tcfg.dec_layers)
    assert set(cache) == {"kv", "cross", "t"}
    assert cache["t"] == PROMPT + STEPS
    assert _rel(memory, run["memory"]) < TOL[cd]
    for got, exp in zip(logits, run["logits"]):
        assert got.dtype == torch.float32 and tuple(got.shape) == exp.shape
        assert _rel(got, exp) < TOL[cd]
    for when, ours_c in (("first", first), ("last", _leaves(cache))):
        for name, exp in _leaves(run[when]).items():
            got = ours_c[name]
            assert tuple(got.shape) == exp.shape, (when, name)
            assert str(got.dtype)[6:] == str(exp.dtype), (when, name)
            assert _rel(got, exp) < TOL[cd], (when, name)
    if cd == "float32":
        np.testing.assert_array_equal(torch.stack(ours, 1).numpy(),
                                      run["tokens"])


def test_decode_matches_prefill_f32():
    """``tests/test_models.py::test_decode_matches_prefill_f32`` for
    whisper-base on the port: the prefill's last logits equal a prefill of
    all but the last token and one decode step of it."""
    _, tcfg = _cfgs("float32")
    params = api.init_params(tcfg, torch.Generator().manual_seed(1), CPU)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, tcfg.vocab, (2, 16), dtype=torch.int32,
                         generator=g)
    frames = torch.randn((2, tcfg.enc_len, tcfg.d_model), generator=g) * 0.1
    with torch.inference_mode():
        batch = {"tokens": toks, "frames": frames}
        logits, _ = api.prefill_fn(tcfg)(params, batch, 32)
        _, cache = api.prefill_fn(tcfg)(
            params, {**batch, "tokens": toks[:, :-1]}, 32)
        logits2, _ = api.decode_fn(tcfg)(params, cache, toks[:, -1:])
    assert float((logits - logits2).abs().max()) < 1e-3


def test_full_config_matches_assignment():
    """``tests/test_archs_smoke.py::test_full_config_matches_assignment``
    for whisper-base."""
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab) == (6, 512, 8, 8, 2048, 51865)
    assert (cfg.family, cfg.enc_layers, cfg.dec_layers, cfg.enc_len,
            cfg.head_dim) == ("encdec", 6, 6, 1500, 64)
    assert cfg.vocab_padded % 256 == 0 and cfg.vocab_padded >= cfg.vocab


def test_reduced_prefill_decode_shapes():
    """``tests/test_archs_smoke.py::test_reduced_prefill_decode_shapes``
    for whisper-base (its SMOKE batch: 2 x 32 tokens, cache 64)."""
    cfg = get_config(ARCH).reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    g = torch.Generator().manual_seed(0)
    B = 2
    batch = {"frames": (torch.randn((B, cfg.enc_len, cfg.d_model),
                                    generator=g) * 0.1).to(cfg.cdtype()),
             "tokens": torch.randint(0, cfg.vocab, (B, 32),
                                     dtype=torch.int32, generator=g)}
    with torch.inference_mode():
        logits, cache = api.prefill_fn(cfg)(params, batch, 64)
        assert tuple(logits.shape) == (B, 1, cfg.vocab_padded)
        assert bool(torch.isfinite(logits).all())
        tok = torch.zeros((B, 1), dtype=torch.int32)
        logits2, cache2 = api.decode_fn(cfg)(params, cache, tok)
    assert tuple(logits2.shape) == (B, 1, cfg.vocab_padded)
    assert bool(torch.isfinite(logits2).all())
    assert cache2["t"] == cache["t"] + 1


def test_init_decode_cache_is_laid_out_as_the_prefill_cache():
    _, tcfg = _cfgs()
    params = api.init_params(tcfg, torch.Generator().manual_seed(2), CPU)
    batch = {"tokens": torch.randint(0, tcfg.vocab, (3, 8),
                                     dtype=torch.int32),
             "frames": torch.zeros((3, tcfg.enc_len, tcfg.d_model))}
    with torch.inference_mode():
        _, cache = api.prefill_fn(tcfg)(params, batch, 16)
    empty = api.init_decode_cache(tcfg, 3, 16, CPU)
    assert list(empty) == list(cache) == ["kv", "cross", "t"]
    assert empty["t"] == 0 and cache["t"] == 8
    for name, a in _leaves(empty).items():
        b = _leaves(cache)[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert not bool(a.any()), name
    assert tuple(empty["kv"][0].shape) == (tcfg.dec_layers, 3, 16,
                                           tcfg.n_kv_heads, tcfg.head_dim)
    assert tuple(empty["cross"][0].shape) == (
        tcfg.dec_layers, 3, tcfg.enc_len, tcfg.n_kv_heads, tcfg.head_dim)


def test_engine_serves_the_reference_tokens_and_a_greedy_loop():
    """The slice as a whole: the port's engine, from the reference's
    weights, serves exactly the reference's greedy tokens on zero frames
    (float32 compute, the kernel's path), and a manual greedy loop on
    the parameters gives the same."""
    ref = _reference()
    tcfg = ref["float32"]["tcfg"]
    params = _params("float32")
    flags = TTF.OptFlags(attn_impl="pallas")
    eng = ServingEngine(tcfg, params, slots=2, cache_len=CACHE, flags=flags,
                        device=CPU)
    reqs = [Request(rid=i, prompt=ref["toks"][i], max_new=STEPS + 1)
            for i in range(2)]
    done = eng.run(reqs, prompt_len=PROMPT)
    np.testing.assert_array_equal(np.stack([r.output for r in done]),
                                  ref["zero_frame_tokens"])
    assert eng.waves[0]["requests"] == 2
    with torch.inference_mode():
        batch = {"tokens": torch.from_numpy(ref["toks"][:1]),
                 "frames": torch.zeros((1, tcfg.enc_len, tcfg.d_model))}
        logits, cache = api.prefill_fn(tcfg)(params, batch, CACHE, flags)
        toks = [int(torch.argmax(logits[:, -1], -1)[0])]
        for _ in range(STEPS):
            tok = torch.tensor([[toks[-1]]], dtype=torch.int32)
            logits, cache = api.decode_fn(tcfg)(params, cache, tok, flags)
            toks.append(int(torch.argmax(logits[:, -1], -1)[0]))
    np.testing.assert_array_equal(done[0].output, np.asarray(toks))
    # the decoder cache must hold the prompt and the decode steps
    with pytest.raises(ValueError, match="cache_len"):
        ServingEngine(tcfg, params, slots=2, cache_len=PROMPT, flags=flags,
                      device=CPU).run(reqs, prompt_len=PROMPT)


def test_encdec_params_round_trip():
    """Both layer stacks split into blocks and ``pos_dec`` crosses as a
    tensor beside the sub-dicts; everything comes back bit for bit."""
    ref = _reference()
    tcfg = ref["bfloat16"]["tcfg"]
    params = _params("bfloat16")
    assert len(params["enc_layers"]) == tcfg.enc_layers
    assert len(params["dec_layers"]) == tcfg.dec_layers
    assert set(params["enc_layers"][0]) == {"ln1", "attn", "ln2", "mlp"}
    assert set(params["dec_layers"][0]) == {"ln1", "self_attn", "ln_x",
                                            "cross_attn", "ln2", "mlp"}
    assert tuple(params["pos_dec"].shape) == (TED.POS_DEC_ROWS,
                                              tcfg.d_model)
    back = convert.encdec_params_to_numpy(params)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref["params"])
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_back]
    for (path, a), (_, b) in zip(flat_ref, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)
    # the port's own init builds the same tree
    own = convert.encdec_params_to_numpy(
        api.init_params(tcfg, torch.Generator().manual_seed(0), CPU))
    assert jax.tree.structure(own) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_compute_params_change_no_bit():
    """The weights the engine reads: dense weights and biases and the
    embedding cast once to the compute dtype, the layernorm leaves and
    the learned positions left float32; the outputs are those of casting
    at every use, bit for bit."""
    _, tcfg = _cfgs()
    params = api.init_params(tcfg, torch.Generator().manual_seed(3), CPU)
    weights = TTF.compute_params(params, tcfg)
    dec = weights["dec_layers"][0]
    assert dec["cross_attn"]["wq"]["w"].dtype == torch.bfloat16
    assert dec["mlp"]["w_up"]["b"].dtype == torch.bfloat16
    assert weights["head"]["w"].dtype == torch.bfloat16
    assert dec["ln_x"]["scale"].dtype == torch.float32
    assert dec["ln_x"]["bias"].dtype == torch.float32
    assert weights["pos_dec"].dtype == torch.float32
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, tcfg.vocab, (2, 8), generator=g),
             "frames": torch.randn((2, tcfg.enc_len, tcfg.d_model),
                                   generator=g) * 0.1}
    with torch.inference_mode():
        a, ca = api.prefill_fn(tcfg)(params, batch, 12)
        b, cb = api.prefill_fn(tcfg)(weights, batch, 12)
        assert torch.equal(a, b)
        for name, x in _leaves(ca).items():
            assert torch.equal(x, _leaves(cb)[name]), name
        tok = torch.argmax(a[:, -1], -1)[:, None].int()
        a, _ = api.decode_fn(tcfg)(params, ca, tok)
        b, _ = api.decode_fn(tcfg)(weights, cb, tok)
    assert torch.equal(a, b)
