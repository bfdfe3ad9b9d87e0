"""The port's SSM family against the reference's, on the CPU.

The Mamba-2 mixer (full sequence, both routes of its SSD core, with and
without the prefill state; one decode step) and the whole reduced
Mamba2-1.3B (``n_layers=2``) are held against the JAX package on the
same weights (``convert.lm_params_from`` of the reference's ``init_lm``)
and inputs made with numpy.  The prompt (75 tokens) is not a multiple of
the SSD chunk (64), so the last chunk of every sequence is ragged.
Whole-model parity is exact in tokens in a float32-compute variant of
the config (logits within 1e-4 of their largest magnitude); in the
configured bf16 compute the two frameworks round at different places,
so it is held to 3e-2.  The torch forms of ``tests/test_serve.py``'s
behaviours, which the reference runs on mamba2, run the port's engine
on the same family.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mamba2 as TM  # noqa: E402
from repro_torch.models import transformer as TTF  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Request, ServingEngine, build_decode_step, build_prefill_step)

CPU = "cpu"
ARCH = "mamba2-1.3b"
PROMPT, STEPS = 75, 4
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _cfgs(compute_dtype="bfloat16", n_layers=2):
    """The reference's and the port's reduced config, equal field by
    field."""
    out = [dataclasses.replace(get(ARCH).reduced(), n_layers=n_layers,
                               compute_dtype=compute_dtype)
           for get in (j_get_config, get_config)]
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


def _rel(got, exp) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    exp = np.asarray(jnp.asarray(exp).astype(jnp.float32))
    return float(np.abs(got - exp).max() / np.abs(exp).max())


def _mixer_params(jcfg):
    """The reference mixer's parameters (numpy), with a non-trivial
    conv bias, skip and norm so every leaf matters."""
    p = jax.tree.map(np.asarray, JM.mamba_init(jax.random.PRNGKey(3),
                                               jcfg))
    rng = np.random.default_rng(11)
    for k in ("conv_b", "D"):
        p[k] = rng.uniform(-0.5, 0.5, p[k].shape).astype(np.float32)
    p["norm"]["scale"] = rng.uniform(0.5, 1.5, p["norm"]["scale"].shape
                                     ).astype(np.float32)
    return p


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [PROMPT, 128])
@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba_apply_matches_reference(use_kernel, return_state, S):
    """Both routes of the SSD core.  The reference's Pallas kernel takes
    only whole chunks (``L % chunk == 0``): on the ragged prompt the
    port's kernel route is held to the reference's chunked route, as the
    reference's own prefill would run it."""
    jcfg, tcfg = _cfgs("float32")
    np_p = _mixer_params(jcfg)
    tp = convert.params_from(np_p, CPU)
    assert isinstance(tp, TL.ParamTree)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    exp = JM.mamba_apply(jax.tree.map(jnp.asarray, np_p), jnp.asarray(x),
                         jcfg, use_kernel=use_kernel and S % 64 == 0,
                         return_state=return_state)
    ssd_kernel.reset_launches()
    got = TM.mamba_apply(tp, torch.from_numpy(x), tcfg,
                         use_kernel=use_kernel, return_state=return_state)
    assert ssd_kernel.LAUNCHES["ssd_scan"] == 0   # the CPU: plain version
    if return_state:
        (got, gst), (exp, est) = got, exp
        for k in ("conv", "ssm"):
            assert tuple(gst[k].shape) == est[k].shape
            assert _rel(gst[k], est[k]) < TOL["float32"]
            # the prefill state owns its memory (a view would pin the
            # layer's whole in_proj output in the cache)
            assert (gst[k].untyped_storage().nbytes()
                    == gst[k].numel() * gst[k].element_size())
    assert tuple(got.shape) == exp.shape
    assert _rel(got, exp) < TOL["float32"]


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_mamba_decode_step_matches_reference(cd):
    jcfg, tcfg = _cfgs(cd)
    np_p = _mixer_params(jcfg)
    jp, tp = jax.tree.map(jnp.asarray, np_p), convert.params_from(np_p, CPU)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 10, jcfg.d_model)).astype(np.float32)
    xd = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jdt = jnp.float32 if cd == "float32" else jnp.bfloat16
    tdt = tcfg.cdtype()
    _, jst = JM.mamba_apply(jp, jnp.asarray(x).astype(jdt), jcfg,
                            return_state=True)
    # both sides step from the same (the reference's) state
    tst = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        tdt if k == "conv" else torch.float32) for k, v in jst.items()}
    ssm_before = tst["ssm"]
    exp, jst2 = JM.mamba_decode_step(jp, jnp.asarray(xd).astype(jdt), jst,
                                     jcfg)
    got, tst2 = TM.mamba_decode_step(tp, torch.from_numpy(xd).to(tdt), tst,
                                     tcfg)
    assert tst2 is tst and tst2["ssm"] is ssm_before      # in place
    assert got.dtype == tdt and tuple(got.shape) == exp.shape
    assert _rel(got, exp) < TOL[cd]
    for k in ("conv", "ssm"):
        assert _rel(tst2[k], jst2[k]) < TOL[cd]


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
_REFERENCE = {}


def _reference(cd):
    """The reference's reduced Mamba2 on cd compute: numpy params, the
    prompts, and its prefill + STEPS greedy decode steps in one jit
    (logits per step, the greedy tokens, the final cache)."""
    if cd not in _REFERENCE:
        jcfg, tcfg = _cfgs(cd)
        params = JTF.init_lm(jcfg, jax.random.PRNGKey(0))
        rng = np.random.default_rng(14)
        toks = rng.integers(0, jcfg.vocab, (2, PROMPT)).astype(np.int32)

        @jax.jit
        def run(p, toks):
            lg, cache = JTF.lm_prefill(p, jcfg, toks, cache_len=PROMPT)
            logits, out, caches = [lg], [], [cache]
            for _ in range(STEPS):
                tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
                out.append(tok)
                lg, cache = JTF.lm_decode_step(p, jcfg, cache, tok)
                logits.append(lg)
            out.append(jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32))
            return logits, jnp.concatenate(out, axis=1), caches[0], cache

        logits, tokens, first, last = run(params, jnp.asarray(toks))
        _REFERENCE[cd] = dict(
            jcfg=jcfg, tcfg=tcfg, params=jax.tree.map(np.asarray, params),
            toks=toks, logits=[np.asarray(x) for x in logits],
            tokens=np.asarray(tokens),
            prefill_cache=jax.tree.map(np.asarray, first),
            cache=jax.tree.map(np.asarray, last))
    return _REFERENCE[cd]


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_lm_prefill_and_decode_match_reference(cd):
    ref = _reference(cd)
    tcfg, tol = ref["tcfg"], TOL[cd]
    params = convert.lm_params_from(ref["params"], tcfg, CPU)
    with torch.inference_mode():
        lg, cache = TTF.lm_prefill(params, tcfg,
                                   torch.from_numpy(ref["toks"]),
                                   cache_len=PROMPT)
        for k in ("conv", "ssm"):
            exp = ref["prefill_cache"]["ssm"][k]
            assert tuple(cache["ssm"][k].shape) == exp.shape
            assert cache["ssm"][k].dtype == (tcfg.cdtype() if k == "conv"
                                             else torch.float32)
            assert _rel(cache["ssm"][k], exp) < tol
        held = {k: v for k, v in cache["ssm"].items()}
        logits, ours = [lg], []
        for i in range(STEPS):
            ours.append(torch.argmax(lg[:, -1], -1))
            # teacher-forced with the reference's token, so each step's
            # logits compare on the same input
            tok = torch.from_numpy(ref["tokens"][:, i: i + 1].copy())
            lg, cache = TTF.lm_decode_step(params, tcfg, cache, tok)
            logits.append(lg)
        ours.append(torch.argmax(lg[:, -1], -1))
    assert all(cache["ssm"][k] is held[k] for k in held)   # in place
    assert cache["t"] == PROMPT + STEPS
    for got, exp in zip(logits, ref["logits"]):
        assert got.dtype == torch.float32 and tuple(got.shape) == exp.shape
        assert _rel(got, exp) < tol
    for k in ("conv", "ssm"):
        assert _rel(cache["ssm"][k], ref["cache"]["ssm"][k]) < tol
    if cd == "float32":
        np.testing.assert_array_equal(torch.stack(ours, 1).numpy(),
                                      ref["tokens"])


def test_lm_forward_matches_reference():
    """The scoring forward (final hidden states) over the ragged prompt."""
    ref = _reference("float32")
    exp = JTF.lm_forward(jax.tree.map(jnp.asarray, ref["params"]),
                         ref["jcfg"], jnp.asarray(ref["toks"]))
    params = convert.lm_params_from(ref["params"], ref["tcfg"], CPU)
    with torch.inference_mode():
        got = TTF.lm_forward(params, ref["tcfg"],
                             torch.from_numpy(ref["toks"]))
    assert tuple(got.shape) == exp.shape and _rel(got, exp) < TOL["float32"]


def test_engine_serves_the_reference_tokens():
    """The slice as a whole: the port's engine, from the reference's
    weights, serves exactly the reference's greedy tokens (float32
    compute)."""
    ref = _reference("float32")
    tcfg = ref["tcfg"]
    params = convert.lm_params_from(ref["params"], tcfg, CPU)
    eng = ServingEngine(tcfg, params, slots=2, cache_len=PROMPT, device=CPU)
    reqs = [Request(rid=i, prompt=ref["toks"][i], max_new=STEPS + 1)
            for i in range(2)]
    done = eng.run(reqs, prompt_len=PROMPT)
    np.testing.assert_array_equal(np.stack([r.output for r in done]),
                                  ref["tokens"])


def test_lm_params_round_trip():
    ref = _reference("bfloat16")
    params = convert.lm_params_from(ref["params"], ref["tcfg"], CPU)
    assert len(params["layers"]) == ref["tcfg"].n_layers
    assert isinstance(params["layers"][0]["mamba"], TL.ParamTree)
    back = convert.lm_params_to_numpy(params)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref["params"])
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_back]
    for (path, a), (_, b) in zip(flat_ref, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


def test_init_matches_reference_structure():
    """``init_lm`` on the port gives the reference's tree: the same
    names, shapes and dtypes, and the deterministic leaves equal."""
    jcfg, tcfg = _cfgs()
    exp = jax.tree.map(np.asarray, JTF.init_lm(jcfg, jax.random.PRNGKey(1)))
    got = convert.lm_params_to_numpy(
        api.init_params(tcfg, torch.Generator().manual_seed(1), CPU))
    flat_exp = jax.tree_util.tree_leaves_with_path(exp)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_exp] == [p for p, _ in flat_got]
    for (path, a), (_, b) in zip(flat_exp, flat_got):
        assert a.dtype == b.dtype and a.shape == b.shape, path
    for k in ("A_log", "D", "conv_b"):
        np.testing.assert_allclose(got["layers"]["mamba"][k],
                                   exp["layers"]["mamba"][k], rtol=1e-6)
    lo, hi = np.log(0.001), np.log(0.1)
    dt_bias = got["layers"]["mamba"]["dt_bias"]
    assert ((dt_bias >= lo) & (dt_bias <= hi)).all()


def test_compute_params_change_no_bit():
    """Casting the weights once (what the engine steps read) gives the
    outputs of casting them at every use, bit for bit; the mixer's
    conv, decay, skip and dt-bias leaves stay float32."""
    _, tcfg = _cfgs()
    params = api.init_params(tcfg, torch.Generator().manual_seed(1), CPU)
    weights = TTF.compute_params(params, tcfg)
    mix = weights["layers"][0]["mamba"]
    assert isinstance(mix, TL.ParamTree)
    assert mix["in_proj"]["w"].dtype == torch.bfloat16
    for k in ("conv_w", "conv_b", "A_log", "D", "dt_bias"):
        assert mix[k].dtype == torch.float32
    toks = torch.randint(0, tcfg.vocab, (2, 9),
                         generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        a, ca = TTF.lm_prefill(params, tcfg, toks, cache_len=12)
        b, cb = TTF.lm_prefill(weights, tcfg, toks, cache_len=12)
        assert torch.equal(a, b)
        assert torch.equal(ca["ssm"]["ssm"], cb["ssm"]["ssm"])
        tok = torch.argmax(a[:, -1], -1)[:, None].int()
        a, _ = TTF.lm_decode_step(params, tcfg, ca, tok)
        b, _ = TTF.lm_decode_step(weights, tcfg, cb, tok)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the engine (torch forms of tests/test_serve.py, on the SSM family)
# ---------------------------------------------------------------------------
def engine_for(slots=4):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=2)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    return cfg, ServingEngine(cfg, params, slots=slots, cache_len=64,
                              device=CPU)


def test_serving_engine_completes_requests():
    rng = np.random.default_rng(0)
    cfg, eng = engine_for()
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 16), max_new=6)
            for i in range(10)]
    ssd_kernel.reset_launches()
    done = eng.run(reqs, prompt_len=8)
    assert len(done) == 10
    for r in done:
        assert r.output is not None and len(r.output) == 6
        assert (r.output >= 0).all() and (r.output < cfg.vocab_padded).all()
    assert len(eng.latencies_ms) == 10
    assert all(lat > 0 for lat in eng.latencies_ms)
    assert [w["requests"] for w in eng.waves] == [4, 4, 2]
    # on the CPU the kernel wrapper is never reached by the model
    assert ssd_kernel.LAUNCHES["ssd_scan"] == 0


def test_decode_steps_are_deterministic():
    cfg, eng = engine_for()
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, 16)
    r1 = eng.run([Request(rid=0, prompt=prompt, max_new=8)], prompt_len=8)[0]
    r2 = eng.run([Request(rid=1, prompt=prompt, max_new=8)], prompt_len=8)[0]
    np.testing.assert_array_equal(r1.output, r2.output)


def test_prefill_and_decode_step_builders():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=2)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    pf = build_prefill_step(cfg, cache_len=32)
    df = build_decode_step(cfg)
    toks = torch.randint(0, cfg.vocab, (2, 8), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    empty = api.init_decode_cache(cfg, 2, 32, CPU)
    with torch.inference_mode():
        tok, cache = pf(params, {"tokens": toks})
        assert tok.shape == (2, 1) and tok.dtype == torch.int32
        for k in ("conv", "ssm"):
            a, b = empty["ssm"][k], cache["ssm"][k]
            assert a.shape == b.shape and a.dtype == b.dtype
        assert empty["t"] == 0 and cache["t"] == 8
        for _ in range(4):
            tok, cache = df(params, cache, tok)
    assert tok.shape == (2, 1)
    assert cache["t"] == 8 + 4


def test_greedy_decode_reproduces_forced_sequence():
    """Feed the argmax back manually; the engine must match step by
    step (it reads weights cast once; the manual loop the float32
    parameters)."""
    cfg, eng = engine_for()
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab, 8)
    out = eng.run([Request(rid=0, prompt=prompt, max_new=4)], prompt_len=8)[0]
    params = eng.params
    batch = {"tokens": torch.as_tensor(prompt[None, :8], dtype=torch.int32)}
    with torch.inference_mode():
        logits, cache = api.prefill_fn(cfg)(params, batch, 64)
        toks = [int(torch.argmax(logits[:, -1], -1)[0])]
        tok = torch.tensor([[toks[0]]], dtype=torch.int32)
        for _ in range(3):
            logits, cache = api.decode_fn(cfg)(params, cache, tok)
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            toks.append(int(tok[0, 0]))
    np.testing.assert_array_equal(out.output, np.asarray(toks))


def test_unported_families_still_raise():
    _, tcfg = _cfgs()
    for family in ("audio",):
        with pytest.raises(NotImplementedError):
            api.init_params(dataclasses.replace(tcfg, family=family),
                            torch.Generator(), CPU)
