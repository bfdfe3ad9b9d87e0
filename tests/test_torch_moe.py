"""The port's MoE layer against the reference's, on the CPU.

``moe_apply`` of the reduced Granite-MoE (8 experts top-2) and the
reduced Llama-4-Scout (8 experts top-1 and a shared expert) is held to
``repro.models.moe.moe_apply`` on the same weights (``convert.params_from``
of the reference's ``moe_init``) and inputs made with numpy, over token
counts whose routing groups divide unevenly and an explicit
``n_groups``: float32 compute within 1e-6 of the largest magnitude, bf16
within 3e-2 (the two frameworks round at different places).  The routing
decisions ``(topi, keep)`` are recomputed on the reference's side with
the reference's own formula and are equal exactly in float32, ties
included (the lower expert index first, as ``jax.lax.top_k``).  Then the
torch forms of ``tests/test_models.py``'s MoE behaviours.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402

CPU = "cpu"
ARCHS = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e"]
# per compute dtype: (jax dtype, torch dtype, tolerance relative to the
# largest magnitude)
DT = {"float32": (jnp.float32, torch.float32, 1e-6),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
# (B, S, n_groups): one group; groups of 375 and 131 tokens (the largest
# divisors of 750 and 655 at or below granite's 512); scout's 3500 tokens
# in two groups of 1750 (its group size is 2048); four groups given
SHAPES = [(2, 16, None), (3, 250, None), (5, 131, None), (5, 700, None),
          (2, 16, 4)]


def _cfgs(arch, compute_dtype="float32", **kw):
    """The reference's and the port's reduced config, equal field by
    field."""
    out = [dataclasses.replace(get(arch).reduced(),
                               compute_dtype=compute_dtype, **kw)
           for get in (j_get_config, get_config)]
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


def _rel(got, exp) -> float:
    got = got.float().numpy()
    exp = np.asarray(jnp.asarray(exp).astype(jnp.float32))
    return float(np.abs(got - exp).max() / np.abs(exp).max())


def _layer(arch, compute_dtype="float32", seed=0, **kw):
    """Both configs, the reference's parameters (jnp) and the port's."""
    jcfg, tcfg = _cfgs(arch, compute_dtype, **kw)
    tree = jax.tree.map(np.asarray,
                        JMOE.moe_init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), \
        convert.params_from(tree, CPU)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _reference_routing(p, xg, cfg):
    """The reference ``moe_apply``'s routing lines, on its side: (topv,
    topi, pos, keep)."""
    G, T, _ = xg.shape
    E_real, E, k = cfg.n_experts, cfg.n_experts_padded, cfg.top_k
    logits = JL.dense(p["router"], xg, compute_dtype=jnp.float32)
    if E != E_real:
        logits = jnp.where((jnp.arange(E) >= E_real)[None, None, :], -1e30,
                           logits)
    topv, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    topv = topv / jnp.maximum(topv.sum(-1, keepdims=True), 1e-9)
    cap = int((T * k * cfg.capacity_factor) / E_real + 1)
    cap = max(cap - cap % -8, 8)
    oh = jax.nn.one_hot(topi, E, dtype=jnp.int32)
    flat = oh.reshape(G, T * k, E)
    pos = ((jnp.cumsum(flat, axis=1) - 1) * flat).sum(-1).reshape(G, T, k)
    return topv, topi, pos, pos < cap, cap


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s))
                         .replace("None", "auto"))
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, cd, shape):
    B, S, n_groups = shape
    jdt, tdt, tol = DT[cd]
    jcfg, tcfg, jp, tp = _layer(arch, cd)
    x = _x((B, S, jcfg.d_model))
    exp = JMOE.moe_apply(jp, jnp.asarray(x).astype(jdt), jcfg,
                         n_groups=n_groups)
    with torch.inference_mode():
        got = TMOE.moe_apply(tp, torch.from_numpy(x).to(tdt), tcfg,
                             n_groups=n_groups)
    assert got.dtype == tdt and tuple(got.shape) == exp.shape == x.shape
    assert _rel(got, exp) < tol


@pytest.mark.parametrize("shape", SHAPES[:4],
                         ids=lambda s: "x".join(map(str, s[:2])))
@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_decisions_equal_the_reference_exactly(arch, cf, shape):
    """At the config's capacity factor and at 0.5, where every group
    drops (token, slot)s."""
    B, S, _ = shape
    jcfg, tcfg, jp, tp = _layer(arch, capacity_factor=cf)
    G = TMOE.n_groups_for(B * S, tcfg)
    xg = _x((G, B * S // G, jcfg.d_model), seed=2)
    topv, topi, pos, keep, cap = _reference_routing(jp, jnp.asarray(xg),
                                                    jcfg)
    with torch.inference_mode():
        r = TMOE.moe_route(tp, torch.from_numpy(xg), tcfg)
    assert r.cap == cap
    np.testing.assert_array_equal(r.topi.numpy(), np.asarray(topi))
    np.testing.assert_array_equal(r.pos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(keep))
    np.testing.assert_allclose(r.topv.numpy(), np.asarray(topv), rtol=0,
                               atol=1e-6)
    assert r.pos.dtype == torch.int32
    assert bool((~r.keep).any()) or cf > 1 or B * S < 500


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_aux_loss_matches_reference(arch):
    jcfg, tcfg, jp, tp = _layer(arch)
    x = _x((3, 40, jcfg.d_model), seed=3)
    exp = float(JMOE.moe_aux_loss(jp, jnp.asarray(x), jcfg))
    got = float(TMOE.moe_aux_loss(tp, torch.from_numpy(x), tcfg))
    assert abs(got - exp) <= 1e-6 * abs(exp)


def test_router_ties_take_the_lower_index():
    """Router columns repeated in pairs give each token tied
    probabilities: the lower expert index wins, as ``jax.lax.top_k``
    orders it, both in ``top_k`` alone and in the layer's routing."""
    jcfg, tcfg, _, _ = _layer("granite-moe-3b-a800m")
    rng = np.random.default_rng(4)
    half = rng.standard_normal((jcfg.d_model, 4)).astype(np.float32) * 0.1
    w = np.repeat(half, 2, axis=1)[:, rng.permutation(8)]
    jp = {"router": {"w": jnp.asarray(w)}}
    tp = convert.params_from({"router": {"w": w}}, CPU)
    xg = _x((1, 64, jcfg.d_model), seed=5)
    _, topi, pos, keep, _ = _reference_routing(jp, jnp.asarray(xg), jcfg)
    r = TMOE.moe_route(tp, torch.from_numpy(xg), tcfg)
    gate = r.gate.numpy()
    tied = np.take_along_axis(gate, r.topi.numpy(), -1)
    assert (tied[..., 0] == tied[..., 1]).all()     # every top pair tied
    np.testing.assert_array_equal(r.topi.numpy(), np.asarray(topi))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(keep))
    assert (r.topi[..., 0] < r.topi[..., 1]).all()
    # top_k alone, on many exact ties
    vals = rng.integers(0, 3, (50, 12)).astype(np.float32)
    for k in (1, 3, 7):
        v, i = TMOE.top_k(torch.from_numpy(vals), k)
        jv, ji = jax.lax.top_k(jnp.asarray(vals), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_moe_init_matches_reference_structure():
    jcfg, tcfg = _cfgs("llama4-scout-17b-a16e", expert_pad=2)
    exp = jax.tree_util.tree_leaves_with_path(
        JMOE.moe_init(jax.random.PRNGKey(0), jcfg))
    tree = TMOE.moe_init(torch.Generator().manual_seed(0), tcfg, CPU)
    flat = {}

    def walk(m, path):
        for k, v in m.items():
            if isinstance(v, torch.nn.Module):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = v
    walk(tree, ())
    assert sorted(flat) == sorted(tuple(p.key for p in path)
                                  for path, _ in exp)
    for path, leaf in exp:
        t = flat[tuple(p.key for p in path)]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32


# ---------------------------------------------------------------------------
# torch forms of tests/test_models.py's MoE behaviours
# ---------------------------------------------------------------------------
def _prefill_vs_decode(cfg, seed=1):
    """Last-position logits of a 16-token prefill, and of a 15-token
    prefill followed by one decode step of the 16th token."""
    params = api.init_params(cfg, torch.Generator().manual_seed(seed), CPU)
    toks = torch.randint(0, cfg.vocab, (2, 16), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed))
    with torch.inference_mode():
        logits, _ = api.prefill_fn(cfg)(params, {"tokens": toks}, 32)
        _, cache = api.prefill_fn(cfg)(params, {"tokens": toks[:, :-1]}, 32)
        logits2, _ = api.decode_fn(cfg)(params, cache, toks[:, -1:])
    return logits, logits2


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_exact_without_capacity_drops(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32", capacity_factor=8.0)
    logits, logits2 = _prefill_vs_decode(cfg)
    assert float((logits - logits2).abs().max()) < 1e-4


def test_moe_capacity_drops_bounded():
    """Token-drop rate under capacity_factor=1.25 stays modest for a
    balanced router at init."""
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              compute_dtype="float32")
    gen = torch.Generator().manual_seed(1)
    p = TMOE.moe_init(gen, cfg, CPU)
    x = torch.randn((4, 64, cfg.d_model), generator=gen)
    y = TMOE.moe_apply(p, x, cfg)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    aux = float(TMOE.moe_aux_loss(p, x, cfg))
    # balanced-ish at init: aux loss near 1 (its minimum for uniform routing)
    assert 0.5 < aux < 3.0


def test_moe_padded_experts_receive_no_tokens():
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(),
                              n_experts=6, expert_pad=2,
                              compute_dtype="float32")
    gen = torch.Generator().manual_seed(1)
    p = TMOE.moe_init(gen, cfg, CPU)
    r = TMOE.moe_route(p, torch.randn((2, 8, cfg.d_model), generator=gen),
                       cfg)
    assert int((r.topi >= cfg.n_experts).sum()) == 0
    assert float(r.gate[..., cfg.n_experts:].max()) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_f32(arch):
    """The reference's test_decode_matches_prefill_f32 leaves the MoE ids
    out: at the config's capacity a 16-token prefill drops (token, slot)s
    that a one-token decode step keeps, so the two differ in the
    reference too.  The port holds the reference's outcome on the same
    weights: its prefill and its decode each equal the reference's
    within 1e-4 of the largest magnitude, so the gap between them is the
    reference's."""
    jcfg, tcfg = _cfgs(arch)
    jparams = j_api.init_params(jcfg, jax.random.PRNGKey(1))
    params = convert.lm_params_from(jax.tree.map(np.asarray, jparams), tcfg,
                                    CPU)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 16)).astype(
        np.int32)

    @jax.jit            # the file's one model compile per id
    def reference(p, t):
        full = j_api.prefill_fn(jcfg)(p, {"tokens": t}, 32)[0]
        _, cache = j_api.prefill_fn(jcfg)(p, {"tokens": t[:, :-1]}, 32)
        return full, j_api.decode_fn(jcfg)(p, cache, t[:, -1:])[0]

    exp, exp2 = reference(jparams, jnp.asarray(toks))
    tt = torch.from_numpy(toks)
    with torch.inference_mode():
        got = api.prefill_fn(tcfg)(params, {"tokens": tt}, 32)[0]
        _, cache = api.prefill_fn(tcfg)(params, {"tokens": tt[:, :-1]}, 32)
        got2 = api.decode_fn(tcfg)(params, cache, tt[:, -1:])[0]
    assert _rel(got, exp) < 1e-4 and _rel(got2, exp2) < 1e-4
    gap = float(np.abs(np.asarray(exp) - np.asarray(exp2)).max())
    assert abs(float((got - got2).abs().max()) - gap) <= 1e-4 * max(gap, 1)
