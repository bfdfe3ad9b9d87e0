"""The port's serving path against the reference's, on the CPU.

Layers, attention prefill/decode and the whole reduced Qwen2.5-3B
(``n_layers=2``) prefill + decode are held against the JAX package on
the same weights (``convert.lm_params_from`` of the reference's
``init_lm``) and inputs made with numpy.  Whole-model parity is exact in
tokens in a float32-compute variant of the config, where only the
summation order differs (logits within 1e-4 of their largest
magnitude); in the configured bf16 compute the two frameworks round at
different places, so it is held to 3e-2.  The torch forms of
``tests/test_serve.py``'s behaviours run the port's engine alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ARCH_IDS  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TTF  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Request, ServingEngine, build_decode_step, build_prefill_step)

CPU = "cpu"
ARCH = "qwen2.5-3b"
PROMPT, CACHE, STEPS = 12, 24, 4
# per compute dtype: (jax dtype, torch dtype, tolerance relative to the
# largest magnitude)
DT = {"float32": (jnp.float32, torch.float32, 1e-4),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _cfgs(compute_dtype="bfloat16", arch=ARCH, n_layers=2):
    """The reference's and the port's reduced config, equal field by
    field."""
    out = [dataclasses.replace(get(arch).reduced(), n_layers=n_layers,
                               compute_dtype=compute_dtype)
           for get in (j_get_config, get_config)]
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


def _rel(got, exp) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    exp = np.asarray(jnp.asarray(exp).astype(jnp.float32))
    return float(np.abs(got - exp).max() / np.abs(exp).max())


def _pair(tree):
    """A reference parameter dict (jnp) and the port's (CPU)."""
    return (jax.tree.map(jnp.asarray, tree),
            convert.params_from(tree, CPU))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference(arch):
    jcfg = j_get_config(arch)
    tcfg = get_config(arch)    # every architecture id is ported
    for j, t in ((jcfg, tcfg), (jcfg.reduced(), tcfg.reduced())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        if t.family != "ssm":    # attention-free: no head_dim at full size
            assert t.head_dim == j.head_dim
        if t.family in ("ssm", "hybrid"):
            assert (t.d_inner, t.ssm_heads, t.shared_attn_every) == (
                j.d_inner, j.ssm_heads, j.shared_attn_every)
        assert t.vocab_padded == j.vocab_padded
        assert t.n_experts_padded == j.n_experts_padded
        for active in (False, True):
            assert t.param_count(active) == j.param_count(active)
    assert tcfg.cdtype() == torch.bfloat16
    assert tcfg.pdtype() == torch.float32


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layer", ["dense", "rmsnorm", "rotary",
                                   "rotary_half", "swiglu", "embed"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_layers_match_reference(layer, cd):
    jdt, tdt, tol = DT[cd]
    rng = np.random.default_rng(7)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f32(2, 5, 32)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    if layer == "dense":
        jp, tp = _pair({"w": f32(32, 24), "b": f32(24)})
        exp = JL.dense(jp, jx, compute_dtype=jdt)
        got = TL.dense(tp, tx, compute_dtype=tdt)
    elif layer == "rmsnorm":
        jp, tp = _pair({"scale": f32(32)})
        exp, got = JL.rmsnorm(jp, jx), TL.rmsnorm(tp, tx)
    elif layer.startswith("rotary"):
        frac = 0.5 if layer == "rotary_half" else 1.0
        x4 = f32(2, 7, 3, 16)
        pos = (np.arange(7)[None] + np.array([[0], [60]])).astype(np.int32)
        exp = JL.rotary(jnp.asarray(x4).astype(jdt), jnp.asarray(pos),
                        fraction=frac)
        got = TL.rotary(torch.from_numpy(x4).to(tdt),
                        torch.from_numpy(pos), fraction=frac)
    elif layer == "swiglu":
        jp, tp = _pair({"w_gate": {"w": f32(32, 48)},
                        "w_up": {"w": f32(32, 48)},
                        "w_down": {"w": f32(48, 32)}})
        exp = JL.swiglu(jp, jx, compute_dtype=jdt)
        got = TL.swiglu(tp, tx, compute_dtype=tdt)
    else:
        jp, tp = _pair({"table": f32(40, 32)})
        ids = rng.integers(0, 40, (3, 9)).astype(np.int32)
        exp = JL.embed(jp, jnp.asarray(ids), compute_dtype=jdt)
        got = TL.embed(tp, torch.from_numpy(ids), compute_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == exp.shape
    assert _rel(got, exp) < (tol if cd == "bfloat16" else 1e-6)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["naive", "pallas"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_attention_prefill_and_decode_match_reference(impl, cd):
    jcfg, tcfg = _cfgs(cd)
    jdt, tdt, tol = DT[cd]
    jp = JA.attn_init(jax.random.PRNGKey(3), jcfg)
    np_p = jax.tree.map(np.asarray, jp)
    np_p["wq"]["b"] = np.linspace(-1, 1, np_p["wq"]["b"].size,
                                  dtype=np.float32)
    jp, tp = _pair(np_p)
    rng = np.random.default_rng(8)
    B, S = 2, PROMPT
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    j_out, (jk, jv) = JA.attn_prefill(
        jp, jnp.asarray(x).astype(jdt), jcfg, positions=jnp.asarray(pos),
        cache_len=CACHE, impl=impl)
    t_out, (tk, tv) = TA.attn_prefill(
        tp, torch.from_numpy(x).to(tdt), tcfg,
        positions=torch.from_numpy(pos.copy()), cache_len=CACHE, impl=impl)
    assert tuple(tk.shape) == jk.shape == (B, CACHE, jcfg.n_kv_heads,
                                           jcfg.head_dim)
    for got, exp in ((t_out, j_out), (tk, jk), (tv, jv)):
        assert got.dtype == tdt and _rel(got, exp) < tol
    # decode one token at t = S against each side's own cache
    xd = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    j_out, (jk, jv) = JA.attn_decode(jp, jnp.asarray(xd).astype(jdt),
                                     (jk, jv), jnp.int32(S), jcfg)
    t_out, (tk2, tv2) = TA.attn_decode(tp, torch.from_numpy(xd).to(tdt),
                                       (tk, tv), S, tcfg)
    assert tk2 is tk and tv2 is tv        # written in place
    for got, exp in ((t_out, j_out), (tk, jk), (tv, jv)):
        assert _rel(got, exp) < tol


def test_attn_decode_seq_parallel_waits_for_the_distributed_slice():
    """Off a mesh ``seq_parallel=True`` (the distributed slice's cache
    constraint) computes what ``seq_parallel=False`` does, bit for bit."""
    _, tcfg = _cfgs()
    p = TA.attn_init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    rng = np.random.default_rng(3)
    full = torch.from_numpy(rng.standard_normal(
        (2, 8, tcfg.n_kv_heads, tcfg.head_dim)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(
        (2, 1, tcfg.d_model)).astype(np.float32))
    outs = []
    for sp in (False, True):
        cache = tuple(full.clone().to(tcfg.cdtype()) for _ in range(2))
        outs.append(TA.attn_decode(p, x, cache, 5, tcfg, seq_parallel=sp))
    (o0, (k0, v0)), (o1, (k1, v1)) = outs
    for a, b in ((o0, o1), (k0, k1), (v0, v1)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
_REFERENCE = {}


def _reference(cd):
    """The reference's reduced model on cd compute: numpy params, the
    prompts, and its prefill + STEPS greedy decode steps in one jit
    (logits per step and the greedy tokens)."""
    if cd not in _REFERENCE:
        jcfg, tcfg = _cfgs(cd)
        params = JTF.init_lm(jcfg, jax.random.PRNGKey(0))
        rng = np.random.default_rng(9)
        toks = rng.integers(0, jcfg.vocab, (2, PROMPT)).astype(np.int32)

        @jax.jit
        def run(p, toks):
            lg, cache = JTF.lm_prefill(p, jcfg, toks, cache_len=CACHE)
            logits, out = [lg], []
            for _ in range(STEPS):
                tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
                out.append(tok)
                lg, cache = JTF.lm_decode_step(p, jcfg, cache, tok)
                logits.append(lg)
            out.append(jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32))
            return logits, jnp.concatenate(out, axis=1), cache["t"]

        logits, tokens, t = run(params, jnp.asarray(toks))
        _REFERENCE[cd] = dict(
            tcfg=tcfg, params=jax.tree.map(np.asarray, params), toks=toks,
            logits=[np.asarray(x) for x in logits],
            tokens=np.asarray(tokens), t=int(t))
    return _REFERENCE[cd]


@pytest.mark.parametrize("impl", ["naive", "pallas"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_lm_prefill_and_decode_match_reference(cd, impl):
    ref = _reference(cd)
    tcfg, tol = ref["tcfg"], DT[cd][2]
    params = convert.lm_params_from(ref["params"], tcfg, CPU)
    flags = TTF.OptFlags(attn_impl=impl)
    with torch.inference_mode():
        lg, cache = TTF.lm_prefill(params, tcfg,
                                   torch.from_numpy(ref["toks"]),
                                   cache_len=CACHE, flags=flags)
        logits, ours = [lg], []
        for i in range(STEPS):
            ours.append(torch.argmax(lg[:, -1], -1))
            # teacher-forced with the reference's token, so each step's
            # logits compare on the same input
            tok = torch.from_numpy(ref["tokens"][:, i: i + 1].copy())
            lg, cache = TTF.lm_decode_step(params, tcfg, cache, tok,
                                           flags=flags)
            logits.append(lg)
        ours.append(torch.argmax(lg[:, -1], -1))
    assert cache["t"] == ref["t"] == PROMPT + STEPS
    for got, exp in zip(logits, ref["logits"]):
        assert got.dtype == torch.float32 and tuple(got.shape) == exp.shape
        assert _rel(got, exp) < tol
    if cd == "float32":
        np.testing.assert_array_equal(torch.stack(ours, 1).numpy(),
                                      ref["tokens"])


@pytest.mark.parametrize("flash_kernel", [False, True])
def test_lm_forward_matches_reference(flash_kernel):
    """The scoring forward (final hidden states), with the naive
    attention and with the kernel (``flags.flash_kernel``)."""
    ref = _reference("float32")
    jcfg, tcfg = _cfgs("float32")
    exp = JTF.lm_forward(jax.tree.map(jnp.asarray, ref["params"]), jcfg,
                         jnp.asarray(ref["toks"]),
                         flags=JTF.OptFlags(flash_kernel=flash_kernel))
    params = convert.lm_params_from(ref["params"], tcfg, CPU)
    with torch.inference_mode():
        got = TTF.lm_forward(params, tcfg, torch.from_numpy(ref["toks"]),
                             flags=TTF.OptFlags(flash_kernel=flash_kernel))
    assert tuple(got.shape) == exp.shape and _rel(got, exp) < DT["float32"][2]


def test_engine_serves_the_reference_tokens():
    """The slice as a whole: the port's engine, from the reference's
    weights, serves exactly the reference's greedy tokens (float32
    compute), through the kernel's path."""
    ref = _reference("float32")
    tcfg = ref["tcfg"]
    params = convert.lm_params_from(ref["params"], tcfg, CPU)
    eng = ServingEngine(tcfg, params, slots=2, cache_len=CACHE,
                        flags=TTF.OptFlags(attn_impl="pallas"), device=CPU)
    reqs = [Request(rid=i, prompt=ref["toks"][i], max_new=STEPS + 1)
            for i in range(2)]
    done = eng.run(reqs, prompt_len=PROMPT)
    np.testing.assert_array_equal(np.stack([r.output for r in done]),
                                  ref["tokens"])


def test_lm_params_round_trip():
    ref = _reference("bfloat16")
    params = convert.lm_params_from(ref["params"], ref["tcfg"], CPU)
    assert len(params["layers"]) == ref["tcfg"].n_layers
    back = convert.lm_params_to_numpy(params)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref["params"])
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_back]
    for (path, a), (_, b) in zip(flat_ref, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


def test_compute_params_change_no_bit():
    """Casting the weights once (what the engine steps read) gives the
    outputs of casting them at every use, bit for bit."""
    _, tcfg = _cfgs()
    params = api.init_params(tcfg, torch.Generator().manual_seed(1), CPU)
    weights = TTF.compute_params(params, tcfg)
    assert weights["layers"][0]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert weights["layers"][0]["ln1"]["scale"].dtype == torch.float32
    toks = torch.randint(0, tcfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        a, ca = TTF.lm_prefill(params, tcfg, toks, cache_len=12)
        b, cb = TTF.lm_prefill(weights, tcfg, toks, cache_len=12)
        assert torch.equal(a, b) and torch.equal(ca["kv"][0], cb["kv"][0])
        tok = torch.argmax(a[:, -1], -1)[:, None].int()
        a, _ = TTF.lm_decode_step(params, tcfg, ca, tok)
        b, _ = TTF.lm_decode_step(weights, tcfg, cb, tok)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the engine (torch forms of tests/test_serve.py)
# ---------------------------------------------------------------------------
def engine_for(arch_id="qwen1.5-0.5b", slots=4, impl="naive"):
    cfg = dataclasses.replace(get_config(arch_id).reduced(), n_layers=2)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    return cfg, ServingEngine(cfg, params, slots=slots, cache_len=64,
                              flags=TTF.OptFlags(attn_impl=impl),
                              device=CPU)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_serving_engine_completes_requests(impl):
    rng = np.random.default_rng(0)
    cfg, eng = engine_for(impl=impl)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 16), max_new=6)
            for i in range(10)]
    fa_kernel.reset_launches()
    done = eng.run(reqs, prompt_len=8)
    assert len(done) == 10
    for r in done:
        assert r.output is not None and len(r.output) == 6
        assert (r.output >= 0).all() and (r.output < cfg.vocab_padded).all()
    assert len(eng.latencies_ms) == 10
    assert all(lat > 0 for lat in eng.latencies_ms)
    assert [w["requests"] for w in eng.waves] == [4, 4, 2]
    assert all(w["decode_steps"] == 5 for w in eng.waves)
    # on the CPU the kernel wrapper runs its plain version
    assert fa_kernel.LAUNCHES["flash_attention"] == 0


def test_decode_steps_are_deterministic():
    cfg, eng = engine_for()
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, 16)
    r1 = eng.run([Request(rid=0, prompt=prompt, max_new=8)], prompt_len=8)[0]
    r2 = eng.run([Request(rid=1, prompt=prompt, max_new=8)], prompt_len=8)[0]
    np.testing.assert_array_equal(r1.output, r2.output)


def test_prefill_and_decode_step_builders():
    # the reference runs this on mamba2 (tests/test_torch_mamba.py holds
    # the SSM family's steps); the dense family's are held to the same
    # contract
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
        for a, b in zip(empty["kv"], cache["kv"]):
            assert a.shape == b.shape and a.dtype == b.dtype
        assert empty["t"] == 0 and cache["t"] == 8
        for _ in range(4):
            tok, cache = df(params, cache, tok)
    assert tok.shape == (2, 1)
    assert cache["t"] == 8 + 4
    # "audio" is a family of the config schema that no architecture has
    # and the port does not serve
    with pytest.raises(NotImplementedError):
        api.init_params(dataclasses.replace(cfg, family="audio"),
                        torch.Generator(), CPU)


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


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default does not raise")
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=1)
    with pytest.raises(RuntimeError):
        api.init_params(cfg, torch.Generator())
    params = api.init_params(cfg, torch.Generator(), CPU)
    with pytest.raises(RuntimeError):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError):
        api.init_decode_cache(cfg, 1, 8)
