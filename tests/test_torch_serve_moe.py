"""The port's MoE decoders against the reference's, on the CPU.

The whole reduced Granite-MoE-3B-A800M and Llama-4-Scout-17B-16E
(``n_layers=2``): prefill, teacher-forced decode steps and the scoring
forward, with the naive attention and with ``impl="pallas"`` (the
kernel's plain version on the CPU), held against the JAX package on the
same weights (``convert.lm_params_from`` of the reference's ``init_lm``)
and inputs made with numpy.  In a float32-compute variant of the config
the logits agree within 1e-4 of their largest magnitude and the greedy
tokens exactly; in the configured bf16 compute within 3e-2 of the
reference run op by op (``jax.disable_jit``), whose bf16 roundings are
the ones the port makes.  Under ``jax.jit`` XLA's fused bf16 elementwise
chains round elsewhere, and the reduced Scout's top-1 router then flips
one decision whose top-two probabilities lie 0.0012 apart (token 3 of
the first prompt, layer 0); with the capacity ranks that follow it, that
moves the later tokens of the routing group.  Top-k routing is
discontinuous: the float32 runs hold the whole model.  Then the
engine, which serves the reference's greedy tokens, the converter's
round trip of the stacked expert leaves, and the weights the engine
reads (the router stays float32).
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
ARCHS = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e"]
PROMPT, CACHE, STEPS = 12, 24, 4
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _cfgs(arch, compute_dtype, n_layers=2):
    """The reference's and the port's reduced config, equal field by
    field."""
    out = [dataclasses.replace(get(arch).reduced(), n_layers=n_layers,
                               compute_dtype=compute_dtype)
           for get in (j_get_config, get_config)]
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


def _rel(got, exp) -> float:
    got = got.float().numpy()
    exp = np.asarray(exp, np.float32)
    return float(np.abs(got - exp).max() / np.abs(exp).max())


_REFERENCE = {}


def _reference(arch):
    """The reference's reduced model: numpy params, the prompts, and per
    compute dtype its prefill + STEPS greedy decode steps (logits per
    step, the greedy tokens) and the scoring forward: float32 in one jit
    (the file's one model compile per id), bf16 op by op."""
    if arch not in _REFERENCE:
        cfgs = {cd: _cfgs(arch, cd) for cd in TOL}
        jcfgs = {cd: c[0] for cd, c in cfgs.items()}
        params = JTF.init_lm(jcfgs["float32"], jax.random.PRNGKey(0))
        rng = np.random.default_rng(9)
        toks = rng.integers(0, jcfgs["float32"].vocab, (2, PROMPT)).astype(
            np.int32)

        def serve(p, toks, jcfg):
            lg, cache = JTF.lm_prefill(p, jcfg, toks, cache_len=CACHE)
            logits, out = [lg], []
            for _ in range(STEPS):
                tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
                out.append(tok)
                lg, cache = JTF.lm_decode_step(p, jcfg, cache, tok)
                logits.append(lg)
            out.append(jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32))
            return (logits, jnp.concatenate(out, axis=1),
                    JTF.lm_forward(p, jcfg, toks).astype(jnp.float32))

        t = jnp.asarray(toks)
        outs = {"float32": jax.jit(lambda p, t: serve(
            p, t, jcfgs["float32"]))(params, t)}
        with jax.disable_jit():
            outs["bfloat16"] = serve(params, t, jcfgs["bfloat16"])
        _REFERENCE[arch] = dict(
            params=jax.tree.map(np.asarray, params), toks=toks,
            **{cd: dict(tcfg=cfgs[cd][1],
                        logits=[np.asarray(x) for x in outs[cd][0]],
                        tokens=np.asarray(outs[cd][1]),
                        hidden=np.asarray(outs[cd][2])) for cd in TOL})
    return _REFERENCE[arch]


@pytest.mark.parametrize("impl", ["naive", "pallas"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_and_decode_match_reference(arch, cd, impl):
    ref = _reference(arch)
    run = ref[cd]
    tcfg = run["tcfg"]
    params = convert.lm_params_from(ref["params"], tcfg, CPU)
    flags = TTF.OptFlags(attn_impl=impl)
    fa_kernel.reset_launches()
    with torch.inference_mode():
        lg, cache = TTF.lm_prefill(params, tcfg,
                                   torch.from_numpy(ref["toks"]),
                                   cache_len=CACHE, flags=flags)
        logits, ours = [lg], []
        for i in range(STEPS):
            ours.append(torch.argmax(lg[:, -1], -1))
            # teacher-forced with the reference's token, so each step's
            # logits compare on the same input
            tok = torch.from_numpy(run["tokens"][:, i: i + 1].copy())
            lg, cache = TTF.lm_decode_step(params, tcfg, cache, tok,
                                           flags=flags)
            logits.append(lg)
        ours.append(torch.argmax(lg[:, -1], -1))
    assert sum(fa_kernel.LAUNCHES.values()) == 0     # plain version here
    assert set(cache) == {"kv", "t"} and cache["t"] == PROMPT + STEPS
    for got, exp in zip(logits, run["logits"]):
        assert got.dtype == torch.float32 and tuple(got.shape) == exp.shape
        assert _rel(got, exp) < TOL[cd]
    if cd == "float32":
        np.testing.assert_array_equal(torch.stack(ours, 1).numpy(),
                                      run["tokens"])


@pytest.mark.parametrize("flash_kernel", [False, True])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_reference(arch, cd, flash_kernel):
    """The scoring forward (final hidden states), with the naive
    attention and with the kernel's flag (its plain version here)."""
    ref = _reference(arch)
    tcfg = ref[cd]["tcfg"]
    params = convert.lm_params_from(ref["params"], tcfg, CPU)
    with torch.inference_mode():
        got = TTF.lm_forward(params, tcfg, torch.from_numpy(ref["toks"]),
                             flags=TTF.OptFlags(flash_kernel=flash_kernel))
    exp = ref[cd]["hidden"]
    assert tuple(got.shape) == exp.shape and _rel(got, exp) < TOL[cd]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_the_reference_tokens(arch):
    """The slice as a whole: the port's engine, from the reference's
    weights, serves exactly the reference's greedy tokens (float32
    compute), through the kernel's path."""
    ref = _reference(arch)
    tcfg = ref["float32"]["tcfg"]
    params = convert.lm_params_from(ref["params"], tcfg, CPU)
    eng = ServingEngine(tcfg, params, slots=2, cache_len=CACHE,
                        flags=TTF.OptFlags(attn_impl="pallas"), device=CPU)
    reqs = [Request(rid=i, prompt=ref["toks"][i], max_new=STEPS + 1)
            for i in range(2)]
    done = eng.run(reqs, prompt_len=PROMPT)
    np.testing.assert_array_equal(np.stack([r.output for r in done]),
                                  ref["float32"]["tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_round_trip(arch):
    """The stacked expert leaves (router ``[L, d, E]``, experts ``[L, E,
    d, f]`` / ``[L, E, f, d]``, Scout's shared expert) cross by key, split
    by layer, and come back bit for bit."""
    ref = _reference(arch)
    tcfg = ref["bfloat16"]["tcfg"]
    params = convert.lm_params_from(ref["params"], tcfg, CPU)
    moe = params["layers"][1]["moe"]
    E, d, f = tcfg.n_experts_padded, tcfg.d_model, tcfg.d_ff
    assert tuple(moe["router"]["w"].shape) == (d, E)
    assert tuple(moe["experts"]["w_gate"].shape) == (E, d, f)
    assert tuple(moe["experts"]["w_down"].shape) == (E, f, d)
    assert ("shared" in moe) == tcfg.shared_expert
    np.testing.assert_array_equal(
        moe["experts"]["w_up"].numpy(),
        ref["params"]["layers"]["moe"]["experts"]["w_up"][1])
    back = convert.lm_params_to_numpy(params)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref["params"])
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_back]
    for (path, a), (_, b) in zip(flat_ref, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_compute_params_change_no_bit(arch):
    """The weights the engine reads: expert weights cast once to the
    compute dtype, the router left in float32 (its logits are float32);
    the outputs are those of casting at every use, bit for bit."""
    _, tcfg = _cfgs(arch, "bfloat16")
    params = api.init_params(tcfg, torch.Generator().manual_seed(1), CPU)
    weights = TTF.compute_params(params, tcfg)
    moe = weights["layers"][0]["moe"]
    assert moe["experts"]["w_gate"].dtype == torch.bfloat16
    assert moe["router"]["w"].dtype == torch.float32
    if tcfg.shared_expert:
        assert moe["shared"]["w_up"]["w"].dtype == torch.bfloat16
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


def test_moe_cache_is_the_dense_cache():
    _, tcfg = _cfgs("granite-moe-3b-a800m", "bfloat16")
    cache = api.init_decode_cache(tcfg, 3, 16, CPU)
    assert set(cache) == {"kv", "t"} and cache["t"] == 0
    assert all(tuple(x.shape) == (2, 3, 16, tcfg.n_kv_heads, tcfg.head_dim)
               for x in cache["kv"])
