"""The port's training substrate on the CPU: the torch twins of every test
in ``tests/test_train.py`` (AdamW lowers the loss, accumulation equals the
full batch, the lr schedule, checkpoint round trip and atomicity, the
async commit, the pipeline's determinism and seeking, restart-exact
resume, straggler flagging), and the port held to the JAX package: one
train step from the same parameters, AdamW state and batch (float32
compute; ``accum_steps`` 1 and 2, ``compress_grads`` off and on), the
pipeline's tokens, ``make_batch``'s integers and the int8 round trip.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (one intra-op thread a worker)
from repro.configs.base import get_config as j_get_config  # noqa: E402
from repro.configs.shapes import ShapeSpec as JShape  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JPipeline  # noqa: E402
from repro.distributed import compression as j_comp  # noqa: E402
from repro.models import api as j_api  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train.train_step import build_train_step as j_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.coordinator import Coordinator  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import trainer as trainer_lib  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    build_train_step, init_train_state, stacked_groups)
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

CPU = "cpu"
STEP_TOL = 1e-5


def small_cfg(get=get_config, **kw):
    return dataclasses.replace(get("qwen1.5-0.5b").reduced(), n_layers=2,
                               **kw)


def small_batch(cfg, seed=0):
    """The reference's ``small_batch``: threefry ``randint`` of [2, 17]."""
    toks = prng.randint(prng.PRNGKey(seed, device=CPU), (2, 17), 0,
                        cfg.vocab)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# twins of tests/test_train.py
# ---------------------------------------------------------------------------
def test_adamw_decreases_loss():
    cfg = small_cfg()
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=50)
    step = build_train_step(cfg, ocfg)
    params, ostate = init_train_state(cfg, gen(), CPU)
    batch = small_batch(cfg)
    losses = []
    for _ in range(12):
        params, ostate, stats = step(params, ostate, batch)
        losses.append(float(stats["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_grad_accumulation_matches_full_batch():
    cfg = small_cfg(compute_dtype="float32")
    ocfg = opt.AdamWConfig()
    batch = small_batch(cfg)
    p1, o1 = init_train_state(cfg, gen(), CPU)
    p1, _, st1 = build_train_step(cfg, ocfg, accum_steps=1)(p1, o1, batch)
    p2, o2 = init_train_state(cfg, gen(), CPU)
    p2, _, st2 = build_train_step(cfg, ocfg, accum_steps=2)(p2, o2, batch)
    assert abs(float(st1["loss"] - st2["loss"])) < 1e-4
    diffs = [float((a - b).detach().abs().max()) for a, b in
             zip(p1.parameters(), p2.parameters())]
    assert max(diffs) < 1e-4


def test_lr_schedule_shape():
    c = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_ratio=0.1)
    lrs = [float(opt.lr_schedule(c, torch.tensor(s))) for s in
           [0, 5, 10, 55, 100]]
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(0.1, abs=1e-6)
    jc = j_opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                           min_lr_ratio=0.1)
    for s in range(0, 120, 7):
        assert float(opt.lr_schedule(c, s)) == pytest.approx(
            float(j_opt.lr_schedule(jc, jnp.asarray(s))), rel=1e-6)


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    cfg = small_cfg()
    params, ostate = init_train_state(cfg, gen(), CPU)
    saved = [p.detach().clone() for p in params.parameters()]
    d = str(tmp_path / "ck")
    ckpt.save(d, 7, (params, ostate), data_offset=42)
    with torch.no_grad():       # what is saved is what was there
        for p in params.parameters():
            p.add_(1.0)
    (p2, o2), manifest = ckpt.restore(d, (params, ostate))
    assert manifest["step"] == 7 and manifest["data_offset"] == 42
    for a, b in zip(saved, p2.parameters()):
        np.testing.assert_array_equal(a.numpy(), b.detach().numpy())
    assert all(p.requires_grad for p in p2.parameters())
    assert isinstance(o2, opt.AdamWState) and o2.mu.keys() == ostate.mu.keys()
    assert ckpt.latest_step(d) == 7
    # no .tmp dirs survive
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_checkpoint_bf16_leaves_and_shards(tmp_path, monkeypatch):
    """A bf16 leaf is stored as its uint16 bits (dtype in the manifest)
    and comes back bit for bit; leaves past the shard size start a new
    file; a tree that does not match the manifest is refused."""
    monkeypatch.setattr(ckpt, "_MAX_SHARD_BYTES", 64)
    x = torch.randn(5, 7).to(torch.bfloat16)
    tree = {"a": x, "b": [torch.arange(40, dtype=torch.int32),
                          torch.randn(3)]}
    d = str(tmp_path / "ck")
    final = ckpt.save(d, 1, tree)
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["dtypes"] == ["bfloat16", "int32", "float32"]
    assert manifest["n_shards"] == 3     # each leaf here passes 64 bytes
    back, _ = ckpt.restore(d, tree)
    assert back["a"].dtype == torch.bfloat16
    assert torch.equal(back["a"].view(torch.int16), x.view(torch.int16))
    assert torch.equal(back["b"][0], tree["b"][0])
    with pytest.raises(ValueError, match="does not match"):
        ckpt.restore(d, {"a": x})


def test_async_checkpointer_commits(tmp_path):
    cfg = small_cfg()
    params, _ = init_train_state(cfg, gen(), CPU)
    ac = ckpt.AsyncCheckpointer(str(tmp_path / "ck2"))
    ac.save_async(3, params, data_offset=5)
    ac.wait()
    assert ac.last_committed == 3
    restored, manifest = ckpt.restore(str(tmp_path / "ck2"), params)
    assert manifest["data_offset"] == 5


def test_async_checkpointer_commits_epoch_to_the_store(tmp_path):
    """After the rename, the epoch and the data offset are in the
    coordination store (the Trainer's)."""
    t = Trainer(small_cfg(), opt.AdamWConfig(),
                DataConfig(vocab=64, seq_len=8, global_batch=2),
                TrainConfig(ckpt_dir=str(tmp_path)), device=CPU)
    t.checkpointer.save_async(4, t.params, data_offset=9)
    t.checkpointer.wait()
    store = t.checkpointer.store
    assert Coordinator.get_host(store, ckpt.CKPT_EPOCH_KEY) == 4
    assert Coordinator.get_host(store, ckpt.DATA_OFFSET_KEY) == 9


def test_data_pipeline_deterministic_and_seekable():
    dc = DataConfig(vocab=100, seq_len=16, global_batch=4, dp_rank=0,
                    dp_size=2, seed=9)
    p1 = TokenPipeline(dc, device=CPU)
    b0 = p1.batch_at(0)
    b5 = p1.batch_at(5)
    p2 = TokenPipeline(dc, start_index=5, device=CPU)
    assert torch.equal(b5["tokens"], p2.batch_at(5)["tokens"])
    # ranks see different data
    dc1 = dataclasses.replace(dc, dp_rank=1)
    b0_r1 = TokenPipeline(dc1, device=CPU).batch_at(0)
    assert not torch.equal(b0["tokens"], b0_r1["tokens"])
    # labels are next-token shifted
    full = p1._tokens_for_index(0)
    np.testing.assert_array_equal(b0["labels"].numpy(), full[:, 1:])
    # iteration yields the same batches and counts the offset before each
    it = iter(TokenPipeline(dc, start_index=5, device=CPU))
    pipe_b5 = next(it)
    assert torch.equal(pipe_b5["tokens"], b5["tokens"])
    it.close()


@pytest.mark.parametrize("rank,index", [(0, 0), (0, 5), (1, 0)])
def test_pipeline_tokens_equal_reference(rank, index):
    kw = dict(vocab=151936, seq_len=33, global_batch=4, dp_rank=rank,
              dp_size=2, seed=9)
    exp = JPipeline(JDataConfig(**kw)).batch_at(index)
    got = TokenPipeline(DataConfig(**kw), device=CPU).batch_at(index)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(exp[k]))


def test_trainer_restart_resumes_exactly(tmp_path):
    """Kill-and-restart: the restarted trainer reproduces the same loss
    trajectory as an uninterrupted run (checkpoint + data-offset resume);
    on the CPU the losses are equal bit for bit."""
    cfg = small_cfg(compute_dtype="float32")
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=20)
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=4)

    def mk(dir_):
        tc = TrainConfig(steps=6, ckpt_every=3, ckpt_dir=str(dir_),
                         log_every=100)
        return Trainer(cfg, ocfg, dc, tc, seed=11, device=CPU)

    t_full = mk(tmp_path / "a")
    hist_full = t_full.train(6)

    t1 = mk(tmp_path / "b")
    t1.train(3)
    t1.checkpointer.wait()
    t2 = mk(tmp_path / "b")
    assert t2.maybe_restore()
    assert t2.step == 3 and t2.pipeline.index == 3
    hist_resumed = t2.train(6)
    a = [h["loss"] for h in hist_full[3:]]
    b = [h["loss"] for h in hist_resumed]
    assert a == b


def test_straggler_flagging(monkeypatch):
    recs = [{"time_s": 0.1}] * 5
    med = float(np.median([r["time_s"] for r in recs]))
    assert 0.5 > 3.0 * med  # a 0.5s step after 0.1s medians gets flagged
    # the Trainer flags a step past 3x the median of its first five
    durations = iter([0.1] * 6 + [0.5, 0.1])
    clock = {"t": 0.0, "start": True}

    def perf_counter():
        if not clock["start"]:
            clock["t"] += next(durations)
        clock["start"] = not clock["start"]
        return clock["t"]

    monkeypatch.setattr(trainer_lib.time, "perf_counter", perf_counter)
    t = Trainer(small_cfg(), opt.AdamWConfig(),
                DataConfig(vocab=64, seq_len=8, global_batch=2),
                TrainConfig(steps=8, ckpt_every=100, ckpt_dir="unused"),
                device=CPU)
    t.checkpointer.save_async = lambda *a, **kw: None
    hist = t.train(8)
    assert [h["straggler"] for h in hist] == [False] * 6 + [True, False]


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------
def _hold(exp, got, what: str, tol=STEP_TOL, slack=0.0) -> None:
    """Every leaf (name -> array) within ``tol`` of its largest magnitude
    (plus ``slack``)."""
    assert exp.keys() == got.keys(), what
    for k, e in exp.items():
        e = np.asarray(e, dtype=np.float32)
        g = got[k].detach().float().cpu().numpy()
        scale = float(np.abs(e).max())
        err = float(np.abs(g - e).max())
        assert err <= tol * scale + slack, (what, k, err, scale)


def _named(tree, cfg) -> dict:
    return {k: p.detach() for k, p in
            convert.lm_params_from(tree, cfg, CPU).named_parameters()}


def test_adamw_update_matches_reference():
    """The optimizer alone, on the same parameters, gradients and state:
    parameters, moments and stats within 1e-6 of each leaf's largest
    magnitude (only roundings differ)."""
    rng = np.random.default_rng(5)
    shapes = {"w": (6, 5), "b": (5,), "tiny": (7,)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         shapes.items()}
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         shapes.items()}
    g["tiny"] *= 1e-9                        # below eps: the update's edge
    mu = {k: (rng.standard_normal(s) * 1e-2).astype(np.float32)
          for k, s in shapes.items()}
    nu = {k: (rng.random(s) * 1e-4).astype(np.float32)
          for k, s in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, grad_clip=0.5)
    jp, js, jstats = j_opt.update(
        j_opt.AdamWConfig(**kw), g, j_opt.AdamWState(
            step=jnp.asarray(4, jnp.int32), mu=mu, nu=nu), p)
    params = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in p.items()})
    state = opt.AdamWState(
        step=torch.tensor(4, dtype=torch.int32),
        mu={k: torch.from_numpy(v.copy()) for k, v in mu.items()},
        nu={k: torch.from_numpy(v.copy()) for k, v in nu.items()})
    params, state, stats = opt.update(
        opt.AdamWConfig(**kw), {k: torch.from_numpy(v) for k, v in
                                g.items()}, state, params)
    for k in ("grad_norm", "lr"):
        assert float(stats[k]) == pytest.approx(float(jstats[k]), rel=1e-6)
    for exp, got in ((jp, dict(params.items())), (js.mu, state.mu),
                     (js.nu, state.nu)):
        for k, e in exp.items():
            e = np.asarray(e)
            err = float(np.abs(got[k].detach().numpy() - e).max())
            assert err <= 1e-6 * float(np.abs(e).max()), k


@pytest.mark.parametrize("accum,compress", [(1, False), (2, True)])
def test_train_step_matches_reference(accum, compress):
    """One JAX step, then from its parameters and AdamW state (converted)
    one more step on both sides with the same batch.  The loss, the
    gradient norm, the lr and both moments (which are linear in the
    gradients) agree within 1e-5 of each leaf's largest magnitude.  The
    parameters move by lr times AdamW's normalised update m / (sqrt(v) +
    eps), which for an element whose gradient is near zero (the key bias:
    its gradient is only the rotary's position dependence) turns the
    gradients' float32 summation noise into a visible change of
    direction: they are held to 1e-5 of each leaf's largest magnitude
    plus 1e-3 of the step's lr.  With ``compress_grads`` a gradient that
    the two frameworks' roundings put on both sides of an int8 rounding
    edge moves by one quantum, 1/127 of its block's largest value: the
    first moment is then held to that step ((1 - b1) / 127 of the leaf),
    and since both sides start from the same parameters, each parameter
    to 1e-5 of its leaf plus lr times the difference of the two sides'
    normalised updates (each from its own moments) and 1e-3."""
    jcfg = small_cfg(j_get_config, compute_dtype="float32")
    cfg = small_cfg(compute_dtype="float32")
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    kw = dict(accum_steps=accum, compress_grads=compress)
    jstep = jax.jit(j_build(jcfg, j_opt.AdamWConfig(**ocfg), **kw))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (4, 17),
                                             dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = j_api.init_params(jcfg, jax.random.PRNGKey(0))
    jparams, jstate, _ = jstep(jparams, j_opt.init(jparams), jb)
    np_params = jax.tree.map(np.asarray, jparams)
    params = convert.lm_params_from(np_params, cfg, CPU)
    for p in params.parameters():
        p.requires_grad_(True)
    state = convert.adamw_state_from(jax.tree.map(np.asarray, jstate), cfg,
                                     CPU)
    assert int(state.step) == 1
    # the state crosses back unchanged
    back = convert.adamw_state_to_numpy(state, params, cfg)
    for a, b in zip(jax.tree.leaves(jstate.mu), jax.tree.leaves(back["mu"])):
        np.testing.assert_array_equal(np.asarray(a), b)

    mu_before = _named(jax.tree.map(np.asarray, jstate.mu), cfg)
    jparams, jstate, jstats = jstep(jparams, jstate, jb)
    step = build_train_step(cfg, opt.AdamWConfig(**ocfg), **kw)
    params, state, stats = step(params, state, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm", "lr"):
        assert float(stats[k]) == pytest.approx(float(jstats[k]),
                                                rel=STEP_TOL), k
    assert int(state.step) == int(jstate.step) == 2
    lr = float(jstats["lr"])
    exp = _named(jax.tree.map(np.asarray, jparams), cfg)
    got = dict(params.named_parameters())
    if compress:    # a flipped quantum may turn an element's update
        oc = opt.AdamWConfig(**ocfg)

        def update(m, v):   # AdamW's normalised update after step 2
            return (m / (1 - oc.b1 ** 2)) / (np.sqrt(v / (1 - oc.b2 ** 2))
                                             + oc.eps)
        jmu, jnu = (_named(jax.tree.map(np.asarray, x), cfg)
                    for x in (jstate.mu, jstate.nu))
        for k, e in exp.items():
            e = e.numpy()
            du = np.abs(update(state.mu[k].numpy(), state.nu[k].numpy())
                        - update(jmu[k].numpy(), jnu[k].numpy()))
            err = np.abs(got[k].detach().numpy() - e)
            assert (err <= STEP_TOL * np.abs(e).max()
                    + lr * (du + 1e-3)).all(), k
    else:
        _hold(exp, got, "params", slack=lr * 1e-3)
    for name in ("mu", "nu"):
        exp = _named(jax.tree.map(np.asarray, getattr(jstate, name)), cfg)
        slack = dict.fromkeys(exp, 0.0)
        if compress:
            # one quantum q of the reference's leaf, its largest gradient
            # g over 127, moves mu by (1 - b1) q and nu by (1 - b2)(2 g q +
            # q^2) (the gradient is mu's increment)
            mu = _named(jax.tree.map(np.asarray, jstate.mu), cfg)
            for names in stacked_groups(exp).values():
                g = max(float(((mu[k] - 0.9 * mu_before[k]) / 0.1)
                              .abs().max()) for k in names)
                q = g / 127
                bound = 0.1 * q if name == "mu" else 0.05 * (2 * g * q + q * q)
                slack.update(dict.fromkeys(names, 1.01 * bound))
        for k, e in exp.items():
            _hold({k: e.numpy()}, {k: getattr(state, name)[k]}, name,
                  slack=slack[k])


def test_make_batch_integers_equal_reference():
    for arch in ("qwen1.5-0.5b", "internvl2-26b", "whisper-base"):
        jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
        exp = j_api.make_batch(jcfg, JShape("t", "train", 64, 2), "train",
                               jax.random.PRNGKey(3))
        got = api.make_batch(cfg, ShapeSpec("t", "train", 64, 2), "train",
                             prng.PRNGKey(3, device=CPU))
        assert exp.keys() == got.keys()
        for k, e in exp.items():
            e = np.asarray(e.astype(jnp.float32))
            g = got[k].float().numpy()
            if k in ("tokens", "labels"):
                np.testing.assert_array_equal(g, e)
            else:   # normal x 0.1 through erfinv, then the compute dtype
                assert np.abs(g - e).max() <= 1e-6 + 2 ** -8 * np.abs(e).max()


def test_prng_normal_matches_jax_random_normal():
    """float32 normals from the same threefry key: the same uniforms
    through sqrt(2) erfinv.  Below |x| = 2.5 within 1e-6; in the tails
    XLA's float32 erfinv strays from the exact inverse (4.6e-6 of the
    value at most here, where ``torch.erfinv`` is within some 3e-8 of
    float64's), so every element within 1e-5 of max(1, |x|)."""
    for seed, shape in ((0, (1000,)), (7, (3, 5, 64)), (3, (20000,))):
        exp = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
        got = prng.normal(prng.PRNGKey(seed, device=CPU), shape).numpy()
        assert got.dtype == np.float32 and got.shape == exp.shape
        err = np.abs(got - exp)
        assert err[np.abs(exp) < 2.5].max() <= 1e-6
        assert (err / np.maximum(1.0, np.abs(exp))).max() <= 1e-5


def test_compress_roundtrip_equals_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 300)).astype(np.float32)
    x[0, :256] = 0.0                         # an all-zero block
    x[1, :5] = [127.0, 2.5, -2.5, 3.5, 0.5]  # halves: round to even
    for a in (x, x[0, :7], rng.standard_normal((513,)).astype(np.float32)):
        q, s, n = compression.quantize_int8(torch.from_numpy(a))
        jq, js, jn = j_comp.quantize_int8(jnp.asarray(a))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert n == jn
        np.testing.assert_array_equal(
            compression.compress_roundtrip(torch.from_numpy(a)).numpy(),
            np.asarray(j_comp.compress_roundtrip(jnp.asarray(a))))
