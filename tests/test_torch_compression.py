"""Gradient compression of the port against the reference's: the twins
of ``tests/test_compression.py``, error feedback over 50 steps equal to
the reference's bit for bit, and ``psum_compressed`` over 4 gloo ranks
on the CPU equal to the sum of the four round trips."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as JC
from repro_torch.configs.base import get_config
from repro_torch.core import collectives as coll
from repro_torch.distributed import compression as C
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import build_train_step, init_train_state

import torch_dist_worker as W


def test_roundtrip_relative_error_bounded():
    rng = np.random.default_rng(0)
    for shape in [(1000,), (37, 129), (4, 4, 4)]:
        x = torch.from_numpy((rng.standard_normal(shape) * 0.01).astype(
            np.float32))
        y = C.compress_roundtrip(x)
        rel = float((x - y).abs().max() / (x.abs().max() + 1e-12))
        assert rel < 1.0 / 127 + 1e-3, rel


def test_quantize_handles_zeros_and_outliers():
    x = torch.zeros((300,), dtype=torch.float32)
    assert torch.equal(C.compress_roundtrip(x), x)
    x = torch.zeros((512,), dtype=torch.float32)
    x[7], x[300] = 1e6, -1e-8
    y = C.compress_roundtrip(x)
    assert float(y[7]) == 1e6  # block max is exactly representable
    assert torch.isfinite(y).all()


def test_error_feedback_reduces_bias():
    """With error feedback the accumulated compressed sum converges to
    the true sum (residual carrying); plain compression keeps a bias."""
    rng = np.random.default_rng(1)
    g = torch.from_numpy((rng.standard_normal((256,)) * 1e-3).astype(
        np.float32))
    grads = {"w": g}
    ef = C.ErrorFeedback.init(grads)
    acc_ef = torch.zeros_like(g)
    acc_plain = torch.zeros_like(g)
    for _ in range(50):
        cg, ef = C.compress_with_feedback(grads, ef)
        acc_ef = acc_ef + cg["w"]
        acc_plain = acc_plain + C.compress_roundtrip(g)
    true = 50 * g
    err_ef = float((acc_ef - true).abs().mean())
    err_plain = float((acc_plain - true).abs().mean())
    assert err_ef <= err_plain * 0.9 or err_ef < 1e-6


def test_train_step_with_compression_still_learns():
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              n_layers=2)
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=50)
    step = build_train_step(cfg, ocfg, compress_grads=True)
    params, ostate = init_train_state(cfg, torch.Generator().manual_seed(0),
                                      "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 17)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    losses = []
    for _ in range(10):
        params, ostate, stats = step(params, ostate, batch)
        losses.append(float(stats["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses


def test_error_feedback_equals_reference_over_50_steps():
    """Fifty steps of ``compress_with_feedback`` on drifting gradients:
    every compressed gradient and residual equal to the reference's."""
    rng = np.random.default_rng(7)
    shapes = {"w": (37, 129), "b": (300,), "e": (4, 8, 16)}
    ef, jef = None, None
    for step in range(50):
        raw = {k: (rng.standard_normal(s) * 10.0 ** -(step % 5)).astype(
            np.float32) for k, s in shapes.items()}
        grads = {k: torch.from_numpy(v) for k, v in raw.items()}
        jgrads = {k: jnp.asarray(v) for k, v in raw.items()}
        if ef is None:
            ef, jef = C.ErrorFeedback.init(grads), JC.ErrorFeedback.init(
                jgrads)
        cg, ef = C.compress_with_feedback(grads, ef)
        jcg, jef = JC.compress_with_feedback(jgrads, jef)
        for k in shapes:
            np.testing.assert_array_equal(cg[k].numpy(), np.asarray(jcg[k]))
            np.testing.assert_array_equal(ef.residual[k].numpy(),
                                          np.asarray(jef.residual[k]))


def test_psum_compressed_over_four_gloo_ranks():
    """Each rank's seeded gradients, int8 round trip, summed over 4 gloo
    ranks: the sum of the four round trips within float32 rounding, the
    same on every rank; the recorder shows one float32 all-reduce a leaf
    of the padded blocks (the reference's arithmetic: dequantized float32
    on the wire)."""
    rng = np.random.default_rng(11)
    shapes = {"w": (64, 300), "b": (1000,), "s": (3,)}
    grads = {k: (rng.standard_normal((4,) + s) * 0.01).astype(np.float32)
             for k, s in shapes.items()}
    res = coll.spawn_ranks(W.psum_compressed_run, 4, device="cpu",
                           args=(grads,))
    for k, g in grads.items():
        trips = np.stack([C.compress_roundtrip(torch.from_numpy(g[r]))
                          .numpy() for r in range(4)])
        exp = trips.astype(np.float64).sum(0)
        scale = np.abs(trips).max() * 4
        for r in range(4):
            got = res[r]["out"][k]
            assert got.shape == shapes[k] and got.dtype == np.float32
            np.testing.assert_allclose(got, exp, rtol=0,
                                       atol=scale * 2 * 2 ** -24)
            np.testing.assert_array_equal(got, res[0]["out"][k])
    padded = sum(-(-int(np.prod(s)) // C.BLOCK) * C.BLOCK
                 for s in shapes.values())
    for r in range(4):
        rep = res[r]["coll"]
        assert rep["counts"]["all-reduce"] == len(shapes)
        assert rep["all-reduce"] == 2 * 4 * padded
        assert rep["total"] == rep["all-reduce"]


@pytest.mark.parametrize("shape", [(1000,), (37, 129), (4, 4, 4), (256,)])
def test_roundtrip_equals_reference(shape):
    x = (np.random.default_rng(3).standard_normal(shape) * 0.05).astype(
        np.float32)
    np.testing.assert_array_equal(
        C.compress_roundtrip(torch.from_numpy(x)).numpy(),
        np.asarray(JC.compress_roundtrip(jnp.asarray(x))))
