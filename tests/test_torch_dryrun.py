"""The dry-run on an emulated mesh (``launch/dryrun.py``) and the sharded
model on real ranks.

``lower_cell`` at full size on the 16x16 mesh for four cells: the local
shapes its specs give (the kv cache's ``(None, ("data",), None, None,
"model")``, the long-context cache's length over ``data``, expert
parallelism) and the per-device argument bytes, equal to the sum of the
local shard bytes that the reference's own specs give.  A reduced MoE
train cell on a 2x2x2 fake mesh, its routing groups' gradient split over
all three axes, traces (the full-size multi-pod MoE train cells failed in
the grouping reshape's backward).  A 4-rank gloo run
on a 2x2 mesh (reduced Qwen2.5-3B, 2 layers, float32, ``SINGLE_POD``
rules): the sharded prefill's logits, a ``seq_parallel_decode`` step
against a cache whose length is sharded, and one train step's loss,
gradients and updated parameters equal to the unsharded port's
(``torch_dist_worker.check_sharded_run``; the hybrid's twin is in
``test_torch_sharding.py``).  A kernel
wrapper refuses a DTensor, and the flash wrappers report their kernels'
work on meta tensors to the step counter.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs import shapes as JS
from repro.distributed import sharding as jsh
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro_torch.configs.base import get_config
from repro_torch.core import collectives as coll
from repro_torch.launch import dryrun

import torch_dist_worker as W


class FakeMesh:
    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.zeros(tuple(sizes.values()))


SIZES = {"data": 16, "model": 16}


def _local_bytes(shape, dtype, spec) -> int:
    """Bytes of one device's shard of a leaf under a reference spec."""
    n = 1
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        names = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        div = int(np.prod([SIZES[a] for a in names])) if names else 1
        assert size % div == 0
        n *= size // div
    return n * np.dtype(dtype).itemsize


def _ref_arg_bytes(arch: str, shape_id: str, rules_name: str) -> int:
    """The reference's per-device argument bytes of a cell: its step's
    parameters (+ AdamW state), cache and batch, each leaf's local shard
    by the reference's own specs."""
    cfg, shape = JB.get_config(arch), JS.SHAPES[shape_id]
    rules, mesh = getattr(jsh, rules_name), FakeMesh(SIZES)
    kind = shape.kind
    if kind != "train":
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    params = jax.eval_shape(lambda: japi.init_params(
        cfg, jax.random.PRNGKey(0)))
    p_specs = jsh.build_param_specs(params, rules, mesh)
    trees = [(params, p_specs)]
    if kind == "train":
        state = jax.eval_shape(lambda: jopt.init(params))
        trees += [(state.mu, p_specs), (state.nu, p_specs),
                  (state.step, jax.sharding.PartitionSpec())]
    if kind == "decode":
        cache = jax.eval_shape(lambda: japi.init_decode_cache(
            cfg, shape.global_batch, shape.seq_len))
        cache = {k: v for k, v in cache.items() if k != "t"}
        trees.append((cache, jsh.cache_specs(cache, rules, mesh)))
    batch = japi.input_specs(cfg, shape, kind)
    trees.append((batch, jsh.batch_specs(batch, rules, mesh)))
    total = 0
    for tree, specs in trees:
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert len(leaves) == len(spec_leaves)
        total += sum(_local_bytes(x.shape, x.dtype, s)
                     for x, s in zip(leaves, spec_leaves))
    return total


# (arch, shape, rules, leaf, its local shape)
CELLS = [
    ("qwen2.5-3b", "decode_32k", "SINGLE_POD_SERVE",
     "cache.kv.0", (36, 8, 32768, 2, 8)),
    ("zamba2-2.7b", "long_500k", "SINGLE_POD_SERVE",
     "cache.kv.0", (9, 1, 32768, 2, 80)),
    ("qwen1.5-0.5b", "train_4k", "SINGLE_POD",
     "layers.0.attn.wq.w", (64, 64)),
    ("llama4-scout-17b-a16e", "prefill_32k", "SINGLE_POD_SERVE",
     "layers.0.moe.experts.w_gate", (1, 5120, 8192)),
]


@pytest.mark.parametrize("arch,shape_id,rules,leaf,local", CELLS,
                         ids=[c[0] + "-" + c[1] for c in CELLS])
def test_lower_cell_full_size(arch, shape_id, rules, leaf, local):
    flags = dict(serve_flags=dataclasses.replace(
        dryrun.SERVE_FLAGS, seq_parallel_decode=True)) if (
            shape_id == "long_500k") else {}
    report, info = dryrun.lower_cell(arch, shape_id, "single", verbose=False,
                                     **flags)
    assert info["rules"] == getattr(dryrun.sh, rules)
    assert info["local_shapes"][leaf] == local
    assert info["arg_bytes"] == _ref_arg_bytes(arch, shape_id, rules)
    mem = report.memory_analysis
    assert mem["argument_bytes"] == info["arg_bytes"]
    assert report.n_chips == 256
    for v in (report.flops_per_device, report.bytes_per_device,
              report.compute_s, report.memory_s, mem["peak_bytes"]):
        assert np.isfinite(v) and v > 0
    assert report.model_flops_total == dryrun.roofline.model_flops(
        get_config(arch), dryrun.SHAPES[shape_id], dryrun.SHAPES[shape_id]
        .kind)


@functools.lru_cache(maxsize=None)
def _moe_train_trace():
    """A reduced Granite-MoE train cell traced on a 2x2x2 (pod, data,
    model) fake mesh under the multi-pod rules: 4 rows of 64 tokens, one a
    device on the 4-way batch axes, in 16 groups of 16 tokens.  Returns the
    trace and, where ``sharding`` holds the groups' gradient
    (``_GradPlacements``), the placements it arrived in and left in."""
    from repro_torch.configs.shapes import ShapeSpec

    seen = []
    hold = getattr(dryrun.sh, "_GradPlacements", None)
    with pytest.MonkeyPatch.context() as mp:
        if hold is not None:
            back = hold.backward

            def spy(ctx, g):
                out = back(ctx, g)
                seen.append((tuple(g.placements), tuple(out.placements)))
                return out

            mp.setattr(hold, "backward", staticmethod(spy))
        mp.setitem(dryrun.MESHES, "2x2x2",
                   ((2, 2, 2), ("pod", "data", "model")))
        cfg = dataclasses.replace(
            get_config("granite-moe-3b-a800m").reduced(), n_layers=1,
            moe_group_tokens=16)
        with dryrun.fake_mesh("2x2x2") as mesh:
            res = dryrun.trace_step(cfg, ShapeSpec("t", "train", 64, 4),
                                    "train", mesh, dryrun.sh.MULTI_POD,
                                    dryrun.TRAIN_FLAGS)
    return res, seen


def test_moe_train_cell_traces_with_groups_split_over_three_axes():
    """The groups' gradient comes back from the routing and dispatch split
    over all three axes (2 groups a device, half a row), and the grouping
    reshape's backward must view it as whole rows.  Without ``moe_apply``'s
    hold the step failed in ``ViewBackward0`` (the full-size twins:
    ``granite-moe-3b-a800m`` and ``llama4-scout-17b-a16e`` x ``train_4k``
    x ``multi``)."""
    res, _ = _moe_train_trace()
    assert res["step"].local_shapes["tokens"] == (1, 64)
    for v in (res["flops"], res["bytes"], res["coll"]):
        assert np.isfinite(v) and v > 0


def test_moe_groups_gradient_held_to_their_placements():
    """``moe_apply`` holds the groups' gradient to the groups' own
    placements: it arrives split over all three axes and leaves split over
    the batch axes only."""
    from torch.distributed.tensor import Replicate, Shard

    _, seen = _moe_train_trace()
    split, held = (Shard(0),) * 3, (Shard(0), Shard(0), Replicate())
    assert (split, held) in seen
    assert all(out == held for _, out in seen)


# ---------------------------------------------------------------------------
# 4 gloo ranks on a 2x2 mesh against the unsharded port
# ---------------------------------------------------------------------------
def test_sharded_model_matches_unsharded_on_four_gloo_ranks():
    spec = W.sharded_model_spec("qwen2.5-3b")
    got = coll.spawn_ranks(W.sharded_model_run, 4, device="cpu",
                           timeout=120.0, args=(spec,))[0]
    W.check_sharded_run(got, W.unsharded_model_run(spec), spec)


def test_kernel_wrappers_refuse_a_dtensor():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.kv_engine import kernel as kv
    from repro_torch.kernels.ssd_scan import kernel as ssd

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
        q = distribute_tensor(torch.zeros(1, 2, 8, 16), mesh, [Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            fa.flash_attention(q, q, q)
        with pytest.raises(TypeError, match="DTensor"):
            fa.flash_attention_lse(q, q, q)
        x = distribute_tensor(torch.zeros(2, 64, 4), mesh, [Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            ssd.ssd_scan(x, x[..., 0], x[:, 0, 0], x, x, x[:, 0, 0])
        i = distribute_tensor(torch.zeros(1, 8, 2, 4, dtype=torch.int32),
                              mesh, [Replicate()])
        with pytest.raises(TypeError, match="DTensor"):
            kv.cluster_read_engine(i, i[..., 0], i[:, :, 0, 0], i[:, :, 0, 0])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("which", ["forward", "forward_lse", "backward"])
def test_meta_wrappers_report_the_kernels_work(which):
    """On meta tensors the flash wrappers report their kernels' work to
    the active step counter through ``build.WORK_SINK``: QK^T and PV
    (two products) a visible pair forward, seven backward (S and dP in
    both backward kernels, then dV, dK and dQ), and each tensor's bytes
    once; with no counter active nothing is reported."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.roofline.analysis import StepCounter

    B, HQ, HKV, S, SK, D = 2, 4, 2, 48, 64, 16
    q = torch.empty(B, HQ, S, D, dtype=torch.bfloat16, device="meta")
    k = torch.empty(B, HKV, SK, D, dtype=torch.bfloat16, device="meta")
    lse = torch.empty(B, HQ, S, dtype=torch.float32, device="meta")
    pairs = sum(min(i + SK - S + 1, SK) for i in range(S))   # offset SK - S
    qb, kb, lb = 2 * q.numel(), 2 * k.numel(), 4 * lse.numel()
    name, products, nbytes, call = {
        "forward": ("flash_attention", 2,
                    qb + 2 * kb + qb, lambda: fa.flash_attention(q, k, k)),
        "forward_lse": ("flash_attention_lse", 2, qb + 2 * kb + qb + lb,
                        lambda: fa.flash_attention_lse(q, k, k)),
        "backward": ("flash_attention_bwd", 7,
                     3 * qb + 2 * kb + lb + qb + 2 * kb,
                     lambda: fa.flash_attention_bwd(q, k, k, q, lse, q)),
    }[which]
    if which == "forward":       # flash_attention aligns causal top-left
        pairs = sum(min(i + 1, SK) for i in range(S))
    assert build.WORK_SINK.get() is None
    call()                       # no counter: nothing to report to
    with StepCounter() as counter:
        call()
    assert counter.kernels == {name: 1}
    assert counter.flops == 2 * products * B * HQ * D * pairs
    assert counter.bytes_accessed == nbytes
