"""The port's hybrid decoder (Zamba2) against the reference's, on the CPU.

The reduced Zamba2-2.7B (4 SSM layers in 2 groups of
``shared_attn_every=2``, each group followed by the one shared attention
block; d 128, 4 heads of 32, SSD heads of 32, state 16): prefill, every
leaf of its cache, teacher-forced decode steps and the scoring forward,
with the naive attention and with ``impl="pallas"`` (the kernel's plain
version on the CPU), held against the JAX package on the same weights
(``convert.lm_params_from`` of the reference's ``init_lm``) and a prompt
made with numpy.  The prompt (75 tokens) is not a multiple of the SSD
chunk (64).  In a float32-compute variant of the config the logits, every
leaf of the cache and the hidden states agree within 1e-4 of their
largest magnitude and the greedy tokens exactly; in the configured bf16
compute the logits and hidden states agree within 3e-2 of the reference
run op by op (``jax.disable_jit``), whose bf16 roundings are the ones the
port makes, and the cache keeps the reference's shapes and dtypes (its
values are held in float32: a bf16 product summed in another order
rounds one unit apart, about 4e-3, at the first layer already, and the
second group's float32 SSM state, which sums such products over the
prompt, differs by 0.033 of its largest magnitude).  Then the torch form of
``tests/test_models.py::test_decode_matches_prefill_f32[zamba2-2.7b]``,
the empty decode cache against the prefill's, the engine against the
reference's tokens and a manual greedy loop, the converter's round trip
of the shared block, the weights the engine reads, and a depth that the
groups do not divide.
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
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import transformer as TTF  # noqa: E402
from repro_torch.serve.engine import Request, ServingEngine  # noqa: E402

CPU = "cpu"
ARCH = "zamba2-2.7b"
PROMPT, CACHE, STEPS = 75, 80, 4
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
    return {"conv": cache["ssm"]["conv"], "ssm": cache["ssm"]["ssm"],
            "k": cache["kv"][0], "v": cache["kv"][1]}


_REFERENCE = {}


def _reference():
    """The reference's reduced model: numpy params, the prompts, and per
    compute dtype its prefill (logits, cache) + STEPS greedy decode steps
    (logits per step, the greedy tokens, the last cache) and the scoring
    forward: float32 in one jit (the file's one model compile), bf16 op by
    op."""
    if not _REFERENCE:
        cfgs = {cd: _cfgs(cd) for cd in TOL}
        jcfgs = {cd: c[0] for cd, c in cfgs.items()}
        params = JTF.init_lm(jcfgs["float32"], jax.random.PRNGKey(0))
        rng = np.random.default_rng(9)
        toks = rng.integers(0, jcfgs["float32"].vocab, (2, PROMPT)).astype(
            np.int32)

        def serve(p, toks, jcfg):
            lg, cache = JTF.lm_prefill(p, jcfg, toks, cache_len=CACHE)
            first = cache
            logits, out = [lg], []
            for _ in range(STEPS):
                tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
                out.append(tok)
                lg, cache = JTF.lm_decode_step(p, jcfg, cache, tok)
                logits.append(lg)
            out.append(jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32))
            return (logits, jnp.concatenate(out, axis=1), first, cache,
                    JTF.lm_forward(p, jcfg, toks).astype(jnp.float32))

        t = jnp.asarray(toks)
        outs = {"float32": jax.jit(lambda p, t: serve(
            p, t, jcfgs["float32"]))(params, t)}
        with jax.disable_jit():
            outs["bfloat16"] = serve(params, t, jcfgs["bfloat16"])
        to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
        _REFERENCE.update(
            params=to_np(params), toks=toks,
            **{cd: dict(tcfg=cfgs[cd][1],
                        logits=[np.asarray(x) for x in outs[cd][0]],
                        tokens=np.asarray(outs[cd][1]),
                        first=to_np(outs[cd][2]), last=to_np(outs[cd][3]),
                        hidden=np.asarray(outs[cd][4])) for cd in TOL})
    return _REFERENCE


@pytest.mark.parametrize("impl", ["naive", "pallas"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_lm_prefill_and_decode_match_reference(cd, impl):
    ref = _reference()
    run = ref[cd]
    tcfg = run["tcfg"]
    params = convert.lm_params_from(ref["params"], tcfg, CPU)
    flags = TTF.OptFlags(attn_impl=impl)
    fa_kernel.reset_launches()
    ssd_kernel.reset_launches()
    with torch.inference_mode():
        lg, cache = TTF.lm_prefill(params, tcfg,
                                   torch.from_numpy(ref["toks"]),
                                   cache_len=CACHE, flags=flags)
        first = {k: v.clone() for k, v in _leaves(cache).items()}
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
    # the plain versions here: no kernel launches on the CPU
    assert sum(fa_kernel.LAUNCHES.values()) == 0
    assert sum(ssd_kernel.LAUNCHES.values()) == 0
    assert set(cache) == {"ssm", "kv", "t"} and cache["t"] == PROMPT + STEPS
    for got, exp in zip(logits, run["logits"]):
        assert got.dtype == torch.float32 and tuple(got.shape) == exp.shape
        assert _rel(got, exp) < TOL[cd]
    for when, ours_c in (("first", first), ("last", _leaves(cache))):
        for name, exp in _leaves(run[when]).items():
            got = ours_c[name]
            assert tuple(got.shape) == exp.shape, (when, name)
            assert str(got.dtype)[6:] == str(exp.dtype), (when, name)
            if cd == "float32":
                assert _rel(got, exp) < TOL[cd], (when, name)
    if cd == "float32":
        np.testing.assert_array_equal(torch.stack(ours, 1).numpy(),
                                      run["tokens"])


@pytest.mark.parametrize("flash_kernel", [False, True])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_lm_forward_matches_reference(cd, flash_kernel):
    """The scoring forward (final hidden states), with the naive
    attention and with the kernel's flag (its plain version here)."""
    ref = _reference()
    tcfg = ref[cd]["tcfg"]
    params = convert.lm_params_from(ref["params"], tcfg, CPU)
    with torch.inference_mode():
        got = TTF.lm_forward(params, tcfg, torch.from_numpy(ref["toks"]),
                             flags=TTF.OptFlags(flash_kernel=flash_kernel))
    exp = ref[cd]["hidden"]
    assert tuple(got.shape) == exp.shape and _rel(got, exp) < TOL[cd]


def test_decode_matches_prefill_f32():
    """``tests/test_models.py::test_decode_matches_prefill_f32`` for
    zamba2-2.7b on the port: the prefill's last logits equal a prefill of
    all but the last token and one decode step of it."""
    _, tcfg = _cfgs("float32")
    params = api.init_params(tcfg, torch.Generator().manual_seed(1), CPU)
    toks = torch.randint(0, tcfg.vocab, (2, 16), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        logits, _ = api.prefill_fn(tcfg)(params, {"tokens": toks}, 32)
        _, cache = api.prefill_fn(tcfg)(params, {"tokens": toks[:, :-1]}, 32)
        logits2, _ = api.decode_fn(tcfg)(params, cache, toks[:, -1:])
    assert float((logits - logits2).abs().max()) < 1e-3


def test_init_decode_cache_is_laid_out_as_the_prefill_cache():
    _, tcfg = _cfgs()
    params = api.init_params(tcfg, torch.Generator().manual_seed(2), CPU)
    toks = torch.randint(0, tcfg.vocab, (3, 8), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        _, cache = api.prefill_fn(tcfg)(params, {"tokens": toks}, 16)
    empty = api.init_decode_cache(tcfg, 3, 16, CPU)
    assert list(empty) == list(cache) == ["ssm", "kv", "t"]
    assert empty["t"] == 0 and cache["t"] == 8
    G, k = tcfg.n_layers // tcfg.shared_attn_every, tcfg.shared_attn_every
    for name, a in _leaves(empty).items():
        b = _leaves(cache)[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert not bool(a.any()), name
    assert tuple(empty["ssm"]["ssm"].shape[:3]) == (G, k, 3)
    assert empty["ssm"]["ssm"].dtype == torch.float32
    assert tuple(empty["kv"][0].shape) == (G, 3, 16, tcfg.n_kv_heads,
                                           tcfg.head_dim)


def test_engine_serves_the_reference_tokens_and_a_greedy_loop():
    """The slice as a whole: the port's engine, from the reference's
    weights, serves exactly the reference's greedy tokens (float32
    compute) through the kernels' path, and a manual greedy loop on the
    parameters gives the same."""
    ref = _reference()
    tcfg = ref["float32"]["tcfg"]
    params = convert.lm_params_from(ref["params"], tcfg, CPU)
    flags = TTF.OptFlags(attn_impl="pallas")
    eng = ServingEngine(tcfg, params, slots=2, cache_len=CACHE, flags=flags,
                        device=CPU)
    reqs = [Request(rid=i, prompt=ref["toks"][i], max_new=STEPS + 1)
            for i in range(2)]
    done = eng.run(reqs, prompt_len=PROMPT)
    np.testing.assert_array_equal(np.stack([r.output for r in done]),
                                  ref["float32"]["tokens"])
    with torch.inference_mode():
        batch = {"tokens": torch.from_numpy(ref["toks"][:1])}
        logits, cache = api.prefill_fn(tcfg)(params, batch, CACHE, flags)
        toks = [int(torch.argmax(logits[:, -1], -1)[0])]
        for _ in range(STEPS):
            tok = torch.tensor([[toks[-1]]], dtype=torch.int32)
            logits, cache = api.decode_fn(tcfg)(params, cache, tok, flags)
            toks.append(int(torch.argmax(logits[:, -1], -1)[0]))
    np.testing.assert_array_equal(done[0].output, np.asarray(toks))


def test_lm_params_round_trip():
    """The unstacked shared block crosses by key beside the stacked
    layers, and both come back bit for bit."""
    ref = _reference()
    tcfg = ref["bfloat16"]["tcfg"]
    params = convert.lm_params_from(ref["params"], tcfg, CPU)
    shared = params["shared_attn"]
    d, hd = tcfg.d_model, tcfg.head_dim
    assert set(shared) == {"ln1", "attn", "ln2", "mlp"}
    assert tuple(shared["attn"]["wq"]["w"].shape) == (d, tcfg.n_heads * hd)
    np.testing.assert_array_equal(
        shared["mlp"]["w_up"]["w"].numpy(),
        ref["params"]["shared_attn"]["mlp"]["w_up"]["w"])
    assert len(params["layers"]) == tcfg.n_layers
    assert set(params["layers"][0]) == {"ln", "mamba"}
    back = convert.lm_params_to_numpy(params)
    flat_ref = jax.tree_util.tree_leaves_with_path(ref["params"])
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_back]
    for (path, a), (_, b) in zip(flat_ref, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


def test_compute_params_change_no_bit():
    """The weights the engine reads: the shared block's dense weights cast
    once to the compute dtype like any dense block's, its norm scales left
    float32; the outputs are those of casting at every use, bit for
    bit."""
    _, tcfg = _cfgs()
    params = api.init_params(tcfg, torch.Generator().manual_seed(3), CPU)
    weights = TTF.compute_params(params, tcfg)
    shared = weights["shared_attn"]
    assert shared["attn"]["wo"]["w"].dtype == torch.bfloat16
    assert shared["mlp"]["w_gate"]["w"].dtype == torch.bfloat16
    assert shared["ln1"]["scale"].dtype == torch.float32
    toks = torch.randint(0, tcfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        a, ca = TTF.lm_prefill(params, tcfg, toks, cache_len=12)
        b, cb = TTF.lm_prefill(weights, tcfg, toks, cache_len=12)
        assert torch.equal(a, b)
        for name, x in _leaves(ca).items():
            assert torch.equal(x, _leaves(cb)[name]), name
        tok = torch.argmax(a[:, -1], -1)[:, None].int()
        a, _ = TTF.lm_decode_step(params, tcfg, ca, tok)
        b, _ = TTF.lm_decode_step(weights, tcfg, cb, tok)
    assert torch.equal(a, b)


def test_a_depth_the_groups_do_not_divide_raises():
    """The reference reshapes its layers to ``[G, k, ...]``, which fails
    unless ``shared_attn_every`` divides ``n_layers``; the port says so."""
    _, tcfg = _cfgs()
    odd = dataclasses.replace(tcfg, n_layers=5)
    with pytest.raises(ValueError, match="multiple of shared_attn_every"):
        api.init_params(odd, torch.Generator(), CPU)
    with pytest.raises(ValueError):
        api.init_decode_cache(odd, 1, 8, CPU)
    with pytest.raises(ValueError):
        api.init_params(dataclasses.replace(tcfg, shared_attn_every=0),
                        torch.Generator(), CPU)
