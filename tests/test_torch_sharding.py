"""The port's sharding rules and roofline model against the reference's:
the twins of ``tests/test_sharding.py``; every parameter, cache and batch
spec of the 10 archs equal to the reference's (the layer dim dropped); the
collective recorder's twin of the HLO parser on a fake process group; and
``model_flops`` equal for every applicable (arch, shape)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import base as JB
from repro.configs import shapes as JS
from repro.distributed import sharding as jsh
from repro.models import api as japi
from repro.roofline import analysis as jra
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.launch import dryrun
from repro_torch.models import api
from repro_torch.roofline import analysis as ra


class FakeMesh:
    """The reference's test mesh: axis names and a device grid."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.zeros(tuple(sizes.values()))


class PortMesh:
    """The same mesh as the port reads one (``DeviceMesh``'s fields)."""

    def __init__(self, sizes: dict):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


SIZES = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}
MESH = PortMesh(SIZES)


def port_params(cfg):
    """The port's parameters of ``cfg`` as fake tensors (no storage)."""
    with FakeTensorMode():
        return api.init_params(cfg, torch.Generator(), "cpu")


def specs_for(arch_id):
    cfg = get_config(arch_id).reduced()
    params = port_params(cfg)
    return cfg, params, sh.build_param_specs(params, sh.SINGLE_POD, MESH)


# ---------------------------------------------------------------------------
# the twins of tests/test_sharding.py
# ---------------------------------------------------------------------------
def test_dense_param_specs():
    cfg, params, specs = specs_for("llama3.2-3b")
    assert specs["embed.table"] == P(None, "model")
    assert specs["head.w"] == P(None, "model")
    # each layer's leaf: the reference's stacked spec, layer dim dropped
    for i in range(cfg.n_layers):
        assert specs[f"layers.{i}.attn.wq.w"] == P("data", "model")
        assert specs[f"layers.{i}.attn.wo.w"] == P("model", "data")
        assert specs[f"layers.{i}.ln1.scale"] == P(None)


def test_moe_param_specs_ep():
    # FULL config: 16 experts divide the 16-way model axis (EP)
    cfg = get_config("llama4-scout-17b-a16e")
    specs = sh.build_param_specs(port_params(cfg), sh.SINGLE_POD, MESH)
    # [E, d, f]: E -> model (EP), d -> data (FSDP)
    assert specs["layers.0.moe.experts.w_gate"] == P("model", "data", None)
    assert specs["layers.0.moe.experts.w_down"] == P("model", None, "data")
    # reduced config (8 experts) can't split 16 ways -> replicated E
    _, _, rspecs = specs_for("llama4-scout-17b-a16e")
    assert rspecs["layers.0.moe.experts.w_gate"][0] is None


def test_indivisible_dims_replicate():
    spec = sh.param_pspec("layers/attn/wq/w", 3, (4, 100, 100),
                          sh.SINGLE_POD, SIZES, True)
    assert spec == P(None, None, None)
    spec = sh.param_pspec("layers/attn/wq/w", 3, (4, 128, 128),
                          sh.SINGLE_POD, SIZES, True)
    assert spec == P(None, "data", "model")


def test_cache_specs_kv_preference():
    cfg = get_config("qwen2.5-3b")  # kv=2 (indivisible), head_dim=128
    with FakeTensorMode():
        cache = api.init_decode_cache(cfg, 128, 1024, "cpu")
    specs = sh.cache_specs(cache, sh.SINGLE_POD, MESH)
    # batch -> data; kv=2 can't split 16 ways -> head_dim 128 -> model
    assert specs["kv"][0] == P(None, ("data",), None, None, "model")


def test_cache_specs_long_context_seq_parallel():
    cfg = get_config("zamba2-2.7b")
    with FakeTensorMode():
        cache = api.init_decode_cache(cfg, 1, 524_288, "cpu")
    specs = sh.cache_specs(cache, sh.SINGLE_POD, MESH)
    # B=1 can't shard -> cache length shards over data; kv=32 -> model
    assert specs["kv"][0] == P(None, None, "data", "model", None)
    assert specs["ssm"]["ssm"][-3] == "model"  # heads


def test_batch_specs_divisibility_guard():
    rules = sh.SINGLE_POD
    b = {"token": torch.empty((1, 1), dtype=torch.int32, device="meta")}
    assert sh.batch_specs(b, rules, MESH)["token"] == P(None, None)
    b2 = {"tokens": torch.empty((128, 10), dtype=torch.int32,
                                device="meta")}
    assert sh.batch_specs(b2, rules, MESH)["tokens"] == P(("data",), None)


def test_shard_noop_outside_rules_context():
    x = torch.ones((4, 4))
    assert sh.shard(x, "batch", None) is x
    # inside one, a plain tensor (not a DTensor) is returned as it is
    with sh.use_rules(sh.SINGLE_POD, MESH):
        assert sh.shard(x, "batch", None) is x


SAMPLE = [  # the reference's SAMPLE_HLO: (kind, dtype, result shape, group)
    ("all-reduce", torch.bfloat16, (16, 512), 4),
    ("all-gather", torch.float32, (64, 128), 32),
    ("reduce-scatter", torch.bfloat16, (8, 128), 8),
    ("all-to-all", torch.int8, (512,), 2),
    ("collective-permute", torch.bfloat16, (32,), 2),
]
SAMPLE_HLO = """
  %ar = bf16[16,512]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = f32[64,128]{1,0} all-gather(%y), replica_groups=[16,32]<=[512], dimensions={0}
  %rs = bf16[8,128]{1,0} reduce-scatter(%z), replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%add
  %aa = (s8[256]{0}, s8[256]{0}) all-to-all(%a, %b), replica_groups={{0,1}}
  %cp = bf16[32]{0} collective-permute(%c), source_target_pairs={{0,1},{1,2}}
"""


def _issue(kind, dtype, shape, g, groups):
    """One collective of ``kind`` with ``shape`` as its result, on a group
    of ``g`` ranks of the fake world."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    pg = groups[g]
    n = int(np.prod(shape))
    if kind == "all-reduce":
        out = funcol.all_reduce(torch.zeros(shape, dtype=dtype), "sum", pg)
    elif kind == "all-gather":
        out = funcol.all_gather_tensor(
            torch.zeros((shape[0] // g,) + shape[1:], dtype=dtype), 0, pg)
    elif kind == "reduce-scatter":
        out = funcol.reduce_scatter_tensor(
            torch.zeros((shape[0] * g,) + shape[1:], dtype=dtype), "sum", 0,
            pg)
    elif kind == "all-to-all":
        out = funcol.all_to_all_single(torch.zeros(n, dtype=dtype), None,
                                       None, pg)
    else:
        dist.send(torch.zeros(shape, dtype=dtype), dst=1, group=pg)
        return
    funcol.wait_tensor(out)


def test_collective_parser_bytes_and_factors():
    """The recorder gives, for the reference's sample (the same result
    shapes and group sizes issued on a fake group), the dict its parser
    gives."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        groups = {g: dist.new_group(list(range(g)))
                  for g in sorted({s[3] for s in SAMPLE})}
        with ra.CollectiveRecorder() as rec, warnings.catch_warnings():
            # all_gather_tensor/reduce_scatter_tensor: deprecated names of
            # the functional collectives DTensor issues
            warnings.simplefilter("ignore", FutureWarning)
            for kind, dtype, shape, g in SAMPLE:
                _issue(kind, dtype, shape, g, groups)
        out = rec.report()
    finally:
        dist.destroy_process_group()
    exp = jra.parse_collective_bytes(SAMPLE_HLO)
    for k in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute", "total"):
        assert out[k] == exp[k], k
    assert out["counts"] == {k: 1 for k in out["counts"]}
    assert out["all-reduce"] == 16 * 512 * 2 * 2.0          # 2x result
    assert out["reduce-scatter"] == 8 * 128 * 2 * 7         # (g-1) x result


@pytest.mark.parametrize("dtype,shape,nbytes", [
    (torch.bfloat16, (2, 3), 12), (torch.bool, (10,), 10),
    (torch.uint32, (), 4), (torch.float32, (4,), 16), (torch.int8, (8,), 8)])
def test_type_bytes_tuples_and_dtypes(dtype, shape, nbytes):
    """The recorder's bytes of a result, the twin of the parser's HLO type
    sizes; a tuple result is the sum of its tensors."""
    t = torch.empty(shape, dtype=dtype, device="meta")
    assert ra._nbytes(t) == nbytes == jra._type_bytes(
        {torch.bfloat16: "bf16", torch.bool: "pred", torch.uint32: "u32",
         torch.float32: "f32", torch.int8: "s8"}[dtype]
        + "[" + ",".join(map(str, shape)) + "]")


def test_model_flops_formulas():
    cfg = get_config("llama4-scout-17b-a16e")
    train = ra.model_flops(cfg, SHAPES["train_4k"], "train")
    n_active = cfg.param_count(active_only=True)
    n_total = cfg.param_count(active_only=False)
    assert n_active < n_total * 0.25  # top-1 of 16 experts + shared
    assert train > 6.0 * n_active * 256 * 4096  # matmul floor + attention
    dec = ra.model_flops(cfg, SHAPES["decode_32k"], "decode")
    assert dec < train / 1000


# ---------------------------------------------------------------------------
# equality with the reference's specs, arch by arch
# ---------------------------------------------------------------------------
def _ref_leaves(tree, prefix=()):
    """``{path tuple: leaf}`` of a reference spec or shape tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_ref_leaves(v, prefix + (str(k),)))
        return out
    if isinstance(tree, (tuple, list)) and not isinstance(
            tree, (jax.sharding.PartitionSpec, P)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_ref_leaves(v, prefix + (str(i),)))
        return out
    return {prefix: tree}


def _spec(spec) -> tuple:
    """A spec's entries, a one-axis tuple as its axis (jax's
    ``PartitionSpec`` reads ``("data",)`` back as ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("rules,sizes", [("SINGLE_POD", SIZES),
                                         ("MULTI_POD", MULTI)],
                         ids=["single", "multi"])
def test_param_specs_equal_reference(arch, rules, sizes):
    cfg = get_config(arch).reduced()
    jcfg = JB.get_config(arch).reduced()
    jparams = jax.eval_shape(
        lambda: japi.init_params(jcfg, jax.random.PRNGKey(0)))
    ref = _ref_leaves(jsh.build_param_specs(
        jparams, getattr(jsh, rules), FakeMesh(sizes)))
    got = sh.build_param_specs(port_params(cfg), getattr(sh, rules),
                               PortMesh(sizes))
    seen = set()
    for name, spec in got.items():
        parts = name.split(".")
        stacked = parts[0] in sh.STACKS and parts[1].isdigit()
        path = tuple([parts[0]] + parts[2:]) if stacked else tuple(parts)
        exp = _spec(ref[path])
        assert _spec(spec) == (exp[1:] if stacked else exp), (name, exp)
        seen.add(path)
    assert seen == set(ref)


DECODE_CELLS = [(a, s) for a in ARCH_IDS for s in ("decode_32k", "long_500k")
                if applicable(get_config(a), s)[0]]


@pytest.mark.parametrize("arch,shape_id", DECODE_CELLS)
def test_cache_and_batch_specs_equal_reference(arch, shape_id):
    cfg, jcfg = get_config(arch), JB.get_config(arch)
    shape, jshape = SHAPES[shape_id], JS.SHAPES[shape_id]
    jmesh = FakeMesh(SIZES)
    jcache = jax.eval_shape(lambda: japi.init_decode_cache(
        jcfg, jshape.global_batch, jshape.seq_len))
    with FakeTensorMode():
        cache = api.init_decode_cache(cfg, shape.global_batch,
                                      shape.seq_len, "cpu")
    ref = _ref_leaves(jsh.cache_specs(jcache, jsh.SINGLE_POD, jmesh))
    got = _ref_leaves(sh.cache_specs(cache, sh.SINGLE_POD, MESH))
    assert set(got) == set(ref)
    for path in ref:
        assert _spec(got[path]) == _spec(ref[path]), path
    for kind in ("decode", "prefill"):
        jb = jsh.batch_specs(japi.input_specs(jcfg, jshape, kind),
                             jsh.SINGLE_POD, jmesh)
        b = sh.batch_specs(api.input_specs(cfg, shape, kind), sh.SINGLE_POD,
                           MESH)
        assert {k: _spec(v) for k, v in b.items()} == {
            k: _spec(v) for k, v in jb.items()}


def test_input_specs_are_meta_stand_ins():
    cfg, jcfg = get_config("internvl2-26b"), JB.get_config("internvl2-26b")
    for kind in ("train", "prefill", "decode"):
        got = api.input_specs(cfg, SHAPES["train_4k"], kind)
        exp = japi.input_specs(jcfg, JS.SHAPES["train_4k"], kind)
        assert set(got) == set(exp)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == exp[k].shape
            assert str(t.dtype).split(".")[-1] == str(exp[k].dtype) or (
                t.dtype == torch.bfloat16 and exp[k].dtype == jnp.bfloat16)


# ---------------------------------------------------------------------------
# model_flops and the serving rules
# ---------------------------------------------------------------------------
ALL_CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES
             if applicable(get_config(a), s)[0]]


def test_all_cells_counted():
    assert len(ALL_CELLS) == 32


@pytest.mark.parametrize("arch,shape_id", ALL_CELLS)
def test_model_flops_equal_reference(arch, shape_id):
    kind = SHAPES[shape_id].kind
    got = ra.model_flops(get_config(arch), SHAPES[shape_id], kind)
    exp = jra.model_flops(JB.get_config(arch), JS.SHAPES[shape_id], kind)
    assert got == exp


# per arch: does serving drop FSDP?  With 20 GB a device (a quarter of
# the H100's 80 GB) every arch does; the reference's 4 GiB (a quarter of
# a 16 GiB TPU) keeps FSDP for Llama-4-Scout alone.
FSDP_FREE = {a: True for a in ARCH_IDS}
REFERENCE_FSDP_FREE = {a: a != "llama4-scout-17b-a16e" for a in ARCH_IDS}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serving_fsdp_choice_per_arch(arch):
    cfg = get_config(arch)
    assert dryrun.serve_fsdp_free(cfg) is FSDP_FREE[arch]
    rules = dryrun.rules_for("single", "decode", cfg)
    assert (rules.fsdp is None) is FSDP_FREE[arch]
    assert dryrun.rules_for("single", "train", cfg).fsdp == "data"
    per_device = cfg.param_count() * 2 / 16
    assert (per_device <= 4 * 2**30) is REFERENCE_FSDP_FREE[arch]


@pytest.mark.parametrize("make,world,shape,names", [
    ("production", 256, (16, 16), ("data", "model")),
    ("production_multi", 512, (2, 16, 16), ("pod", "data", "model")),
    ("serving", 256, (4, 4, 16), ("chain", "data", "model")),
    ("serving_multi", 512, (2, 4, 4, 16), ("pod", "chain", "data", "model")),
    ("host", 8, (8,), ("chain",)),
])
def test_meshes_have_the_reference_shapes(make, world, shape, names):
    """``launch/mesh.py``'s meshes, built on a fake group of their size:
    the reference's shapes and axis names."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import mesh as M

    build = {
        "production": lambda: M.make_production_mesh(device_type="cpu"),
        "production_multi": lambda: M.make_production_mesh(
            multi_pod=True, device_type="cpu"),
        "serving": lambda: M.make_serving_mesh(device_type="cpu"),
        "serving_multi": lambda: M.make_serving_mesh(multi_pod=True,
                                                     device_type="cpu"),
        "host": lambda: M.make_host_mesh(device_type="cpu"),
    }[make]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = build()
        assert tuple(mesh.shape) == shape
        assert mesh.mesh_dim_names == names
        assert sh.axis_sizes(mesh) == dict(zip(names, shape))
    finally:
        dist.destroy_process_group()


def test_sharded_hybrid_matches_unsharded_on_four_gloo_ranks():
    """The reduced Zamba2 (SSM blocks and the shared attention block) on
    a 2x2 mesh of gloo ranks under ``SINGLE_POD``: the SSD core on its
    local shards (``ssd_scan/ops._ssd_on_mesh``), prefill, a
    ``seq_parallel_decode`` step, the loss, gradients and AdamW update
    against the unsharded port (``torch_dist_worker.check_sharded_run``)."""
    from repro_torch.core import collectives as coll

    import torch_dist_worker as W

    spec = W.sharded_model_spec("zamba2-2.7b")
    got = coll.spawn_ranks(W.sharded_model_run, 4, device="cpu",
                           timeout=120.0, args=(spec,))[0]
    W.check_sharded_run(got, W.unsharded_model_run(spec), spec)
