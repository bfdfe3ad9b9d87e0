"""The port's VLM (InternVL2's language backbone with its stub frontend)
against the reference's, on the CPU.

The reduced InternVL2-26B (4 layers, d 128, 4 heads of 32, ``vis_len`` 8):
seeded vision embeddings (numpy, normal x 0.1) go ahead of a 21-token
prompt, so rotary positions run over all 29 and decode starts at ``t =
29``.  Prefill, its cache, three teacher-forced decode steps and the
scoring forward (with the embeddings), with the naive attention and with
``impl="pallas"`` (the kernel's plain version on the CPU), held against
the JAX package on the same weights (``convert.lm_params_from`` of the
reference's ``init_lm``): in a float32-compute variant within 1e-4 of
their largest magnitude and equal greedy tokens, in the configured bf16
compute within 3e-2 of the reference run op by op (``jax.disable_jit``).
Then the torch forms of ``tests/test_models.py``'s
``test_decode_matches_prefill_f32[internvl2-26b]`` and
``test_vlm_embeds_change_text_logits`` and of ``tests/test_archs_smoke.py``'s
full-config and reduced prefill/decode tests, the empty cache's layout,
and the engine (zero embeddings, as both engines give them) against the
reference's tokens and a manual greedy loop.  Last, parameters drawn
straight in the compute dtype (how the full-depth InternVL2-26B fits one
card) against ``compute_params`` of the default draw, and the engine's
per-wave callback.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import transformer as TTF  # noqa: E402
from repro_torch.serve.engine import Request, ServingEngine  # noqa: E402

CPU = "cpu"
ARCH = "internvl2-26b"
PROMPT, CACHE, STEPS = 21, 40, 3
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


_REFERENCE = {}


def _reference():
    """The reference's reduced VLM: numpy params, the embeddings (seeded
    and zeros) and prompts, and per compute dtype its prefill (logits,
    cache), STEPS greedy decode steps (logits per step, the greedy tokens,
    the last cache) and the scoring forward: float32 in one jit (the
    file's one model compile, called for both embeddings), bf16 op by
    op."""
    if not _REFERENCE:
        cfgs = {cd: _cfgs(cd) for cd in TOL}
        jcfgs = {cd: c[0] for cd, c in cfgs.items()}
        jcfg = jcfgs["float32"]
        params = JTF.init_lm(jcfg, jax.random.PRNGKey(0))
        rng = np.random.default_rng(9)
        embeds = (rng.standard_normal((2, jcfg.vis_len, jcfg.d_model))
                  * 0.1).astype(np.float32)
        toks = rng.integers(0, jcfg.vocab, (2, PROMPT)).astype(np.int32)

        def serve(p, embeds, toks, jcfg):
            lg, cache = JTF.lm_prefill(p, jcfg, toks, cache_len=CACHE,
                                       embeds=embeds)
            first = cache
            logits, out = [lg], []
            for _ in range(STEPS):
                tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
                out.append(tok)
                lg, cache = JTF.lm_decode_step(p, jcfg, cache, tok)
                logits.append(lg)
            out.append(jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32))
            return (logits, jnp.concatenate(out, axis=1), first, cache,
                    JTF.lm_forward(p, jcfg, toks, embeds=embeds).astype(
                        jnp.float32))

        t, e = jnp.asarray(toks), jnp.asarray(embeds)
        f32 = jax.jit(lambda p, e, t: serve(p, e, t, jcfg))
        outs = {"float32": f32(params, e, t)}
        zero = f32(params, jnp.zeros_like(e), t)
        with jax.disable_jit():
            outs["bfloat16"] = serve(params, e, t, jcfgs["bfloat16"])
        to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
        _REFERENCE.update(
            params=to_np(params), embeds=embeds, toks=toks,
            zero_embed_tokens=np.asarray(zero[1]),
            **{cd: dict(tcfg=cfgs[cd][1],
                        logits=[np.asarray(x) for x in outs[cd][0]],
                        tokens=np.asarray(outs[cd][1]),
                        first=to_np(outs[cd][2]), last=to_np(outs[cd][3]),
                        hidden=np.asarray(outs[cd][4])) for cd in TOL})
    return _REFERENCE


def _params(cd):
    ref = _reference()
    return convert.lm_params_from(ref["params"], ref[cd]["tcfg"], CPU)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_vlm_prefill_and_decode_match_reference(cd, impl):
    ref = _reference()
    run = ref[cd]
    tcfg = run["tcfg"]
    params = _params(cd)
    flags = TTF.OptFlags(attn_impl=impl)
    embeds, toks = (torch.from_numpy(ref[k]) for k in ("embeds", "toks"))
    fa_kernel.reset_launches()
    with torch.inference_mode():
        lg, cache = api.prefill_fn(tcfg)(
            params, {"tokens": toks, "embeds": embeds}, CACHE, flags)
        first = [x.clone() for x in cache["kv"]]
        logits, ours = [lg], []
        for i in range(STEPS):
            ours.append(torch.argmax(lg[:, -1], -1))
            tok = torch.from_numpy(run["tokens"][:, i: i + 1].copy())
            lg, cache = api.decode_fn(tcfg)(params, cache, tok, flags)
            logits.append(lg)
        ours.append(torch.argmax(lg[:, -1], -1))
        hidden = TTF.lm_forward(params, tcfg, toks, embeds=embeds,
                                flags=TTF.OptFlags(
                                    flash_kernel=impl == "pallas"))
    assert sum(fa_kernel.LAUNCHES.values()) == 0
    assert set(cache) == {"kv", "t"}
    assert cache["t"] == tcfg.vis_len + PROMPT + STEPS
    for got, exp in zip(logits, run["logits"]):
        assert got.dtype == torch.float32 and tuple(got.shape) == exp.shape
        assert _rel(got, exp) < TOL[cd]
    for when, ours_c in (("first", first), ("last", cache["kv"])):
        for got, exp in zip(ours_c, run[when]["kv"]):
            assert tuple(got.shape) == exp.shape, when
            assert str(got.dtype)[6:] == str(exp.dtype), when
            assert _rel(got, exp) < TOL[cd], when
    assert tuple(hidden.shape) == run["hidden"].shape
    assert _rel(hidden, run["hidden"]) < TOL[cd]
    if cd == "float32":
        np.testing.assert_array_equal(torch.stack(ours, 1).numpy(),
                                      run["tokens"])


def test_vlm_embeds_change_text_logits():
    """``tests/test_models.py::test_vlm_embeds_change_text_logits`` on the
    port: the visual embeddings reach the text positions (they are
    prepended, and attention is causal)."""
    _, tcfg = _cfgs("float32")
    params = api.init_params(tcfg, torch.Generator().manual_seed(1), CPU)
    toks = torch.randint(0, tcfg.vocab, (1, 8), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    e1 = torch.zeros((1, tcfg.vis_len, tcfg.d_model))
    e2 = torch.ones((1, tcfg.vis_len, tcfg.d_model)) * 0.3
    with torch.inference_mode():
        l1, _ = api.prefill_fn(tcfg)(params, {"tokens": toks, "embeds": e1},
                                     32)
        l2, _ = api.prefill_fn(tcfg)(params, {"tokens": toks, "embeds": e2},
                                     32)
    assert float((l1 - l2).abs().max()) > 1e-4


def test_decode_matches_prefill_f32():
    """``tests/test_models.py::test_decode_matches_prefill_f32`` for
    internvl2-26b on the port."""
    _, tcfg = _cfgs("float32")
    params = api.init_params(tcfg, torch.Generator().manual_seed(1), CPU)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, tcfg.vocab, (2, 16), dtype=torch.int32,
                         generator=g)
    embeds = torch.randn((2, tcfg.vis_len, tcfg.d_model), generator=g) * 0.1
    with torch.inference_mode():
        batch = {"tokens": toks, "embeds": embeds}
        logits, _ = api.prefill_fn(tcfg)(params, batch, 32)
        _, cache = api.prefill_fn(tcfg)(
            params, {**batch, "tokens": toks[:, :-1]}, 32)
        logits2, _ = api.decode_fn(tcfg)(params, cache, toks[:, -1:])
    assert float((logits - logits2).abs().max()) < 1e-3


def test_full_config_matches_assignment():
    """``tests/test_archs_smoke.py::test_full_config_matches_assignment``
    for internvl2-26b."""
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab) == (48, 6144, 48, 8, 16384, 92553)
    assert (cfg.family, cfg.vis_len, cfg.head_dim, cfg.vocab_padded) == (
        "vlm", 256, 128, 92672)


def test_reduced_prefill_decode_shapes():
    """``tests/test_archs_smoke.py::test_reduced_prefill_decode_shapes``
    for internvl2-26b (its SMOKE batch: 2 x 32 positions, ``vis_len`` of
    them the embeddings; cache 64)."""
    cfg = get_config(ARCH).reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    g = torch.Generator().manual_seed(0)
    B = 2
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, 32 - cfg.vis_len),
                                     dtype=torch.int32, generator=g),
             "embeds": (torch.randn((B, cfg.vis_len, cfg.d_model),
                                    generator=g) * 0.1).to(cfg.cdtype())}
    with torch.inference_mode():
        logits, cache = api.prefill_fn(cfg)(params, batch, 64)
        assert tuple(logits.shape) == (B, 1, cfg.vocab_padded)
        assert bool(torch.isfinite(logits).all())
        tok = torch.zeros((B, 1), dtype=torch.int32)
        logits2, cache2 = api.decode_fn(cfg)(params, cache, tok)
    assert tuple(logits2.shape) == (B, 1, cfg.vocab_padded)
    assert bool(torch.isfinite(logits2).all())
    assert cache["t"] == 32 and cache2["t"] == 33


def test_init_decode_cache_is_laid_out_as_the_prefill_cache():
    _, tcfg = _cfgs()
    params = api.init_params(tcfg, torch.Generator().manual_seed(2), CPU)
    batch = {"tokens": torch.randint(0, tcfg.vocab, (3, 8),
                                     dtype=torch.int32),
             "embeds": torch.zeros((3, tcfg.vis_len, tcfg.d_model))}
    with torch.inference_mode():
        _, cache = api.prefill_fn(tcfg)(params, batch, 24)
    empty = api.init_decode_cache(tcfg, 3, 24, CPU)
    assert list(empty) == list(cache) == ["kv", "t"]
    assert empty["t"] == 0 and cache["t"] == tcfg.vis_len + 8
    for a, b in zip(empty["kv"], cache["kv"]):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert not bool(a.any())


def test_engine_serves_the_reference_tokens_and_a_greedy_loop():
    """The slice as a whole: the port's engine, from the reference's
    weights, serves exactly the reference's greedy tokens on zero
    embeddings (float32 compute, the kernel's path), and a manual greedy
    loop on the parameters gives the same; a cache that cannot hold the
    embeddings, the prompt and the decode steps is refused."""
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
                                  ref["zero_embed_tokens"])
    with torch.inference_mode():
        batch = {"tokens": torch.from_numpy(ref["toks"][:1]),
                 "embeds": torch.zeros((1, tcfg.vis_len, tcfg.d_model))}
        logits, cache = api.prefill_fn(tcfg)(params, batch, CACHE, flags)
        toks = [int(torch.argmax(logits[:, -1], -1)[0])]
        for _ in range(STEPS):
            tok = torch.tensor([[toks[-1]]], dtype=torch.int32)
            logits, cache = api.decode_fn(tcfg)(params, cache, tok, flags)
            toks.append(int(torch.argmax(logits[:, -1], -1)[0]))
    np.testing.assert_array_equal(done[0].output, np.asarray(toks))
    short = tcfg.vis_len + PROMPT + STEPS - 1
    with pytest.raises(ValueError, match="cache_len"):
        ServingEngine(tcfg, params, slots=2, cache_len=short, flags=flags,
                      device=CPU).run(reqs, prompt_len=PROMPT)


@pytest.mark.parametrize("arch", ["internvl2-26b", "qwen2.5-3b",
                                  "granite-moe-3b-a800m", "zamba2-2.7b",
                                  "whisper-base"])
def test_init_in_compute_dtype_is_compute_params_of_the_default(arch):
    """``init_params(compute_dtype=True)``, which casts each part as soon
    as it is drawn (how a full-depth InternVL2-26B fits one card), gives
    bit for bit ``compute_params`` of the default draw from the same
    seed, leaf for leaf and dtype for dtype."""
    tcfg = get_config(arch).reduced()
    want = TTF.compute_params(
        api.init_params(tcfg, torch.Generator().manual_seed(3), CPU), tcfg)
    got = api.init_params(tcfg, torch.Generator().manual_seed(3), CPU,
                          compute_dtype=True)
    want, got = dict(want.named_parameters()), dict(got.named_parameters())
    assert want.keys() == got.keys()
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        assert torch.equal(got[name], w), name


def test_engine_reports_each_wave_as_it_ends():
    """``run(on_wave=...)`` is called once per wave, after it, with that
    wave's record: the engine keeps the one wave loop."""
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=1)
    params = api.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    eng = ServingEngine(tcfg, params, slots=2, cache_len=CACHE, device=CPU)
    rng = np.random.default_rng(1)
    seen = []
    done = eng.run([Request(rid=i, prompt=rng.integers(0, tcfg.vocab, 6),
                            max_new=2) for i in range(5)], prompt_len=6,
                   on_wave=lambda w: seen.append((w, len(eng.waves))))
    assert len(done) == 5
    assert [w["requests"] for w, _ in seen] == [2, 2, 1]
    assert [n for _, n in seen] == [1, 2, 3]
    assert all(w is eng.waves[i] for i, (w, _) in enumerate(seen))
