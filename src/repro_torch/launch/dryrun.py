"""Multi-pod dry-run on an emulated mesh: trace every (arch x shape x mesh)
cell's step (the port's ``repro/launch/dryrun.py``).

For each cell this script:
  1. sets up a fake process group of the mesh's size (rank 0's view of
     the job: ``torch.testing``'s ``FakeStore`` and backend "fake", whose
     collectives do nothing) and builds the production mesh on it
     (16x16 single-pod / 2x16x16 multi-pod); the group is destroyed when
     the cell ends;
  2. builds the parameters, AdamW state, cache and batch at the full
     config on the ``meta`` device (the counterpart of ``eval_shape``:
     shapes and dtypes, no storage; the parameters are drawn under
     ``FakeTensorMode``, as their init draws from a generator) and
     distributes them by the logical sharding rules
     (distributed/sharding.py), each parameter a DTensor
     ``nn.Parameter``; the per-device argument bytes are the local
     shards' bytes, exact;
  3. runs the train (loss, backward, AdamW), prefill or decode step under
     ``use_rules(rules, mesh)`` and ``implicit_replication()`` (plain
     tensors the model makes, positions and masks, count as replicated)
     inside ``roofline.StepCounter``: per-device matrix FLOPs on the
     local shapes, per-device bytes (every local op's inputs and outputs:
     eager's traffic, nothing fused), the collectives DTensor issues, and
     the peak of live local bytes (the counter's docstring states the
     method).  The kernel wrappers take meta tensors as their fake
     kernels: attention counts as the flash kernels' work on the card,
     one call, not the plain version's blocks; the rest of the step is
     the port's plain torch;
  4. as the reference, runs the step at depth 1 and depth 2 only (two
     shallow traces) and extrapolates to the full depth,
     ``d1 + (units - 1) * max(d2 - d1, 0)``, for FLOPs, bytes, each
     collective kind and the peak's part above the arguments;
  5. writes a roofline JSON per cell.  A cell that cannot be traced (an
     op DTensor has no strategy for, say) is reported as FAIL with its
     error, and the run goes on and exits 1.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape train_4k --mesh single --out roofline_out
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
Opt flags: --remat {none,full,dots} --attn {naive,chunked} --accum N
  --compress-grads --no-probes (trace the full depth once instead)
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import ARCH_IDS, ArchConfig, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.distributed import sharding as sh
from repro_torch.models import api
from repro_torch.models.transformer import OptFlags
from repro_torch.roofline import analysis as roofline
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import build_train_step

# The reference's production defaults: remat-full + chunked CE + TP
# sequence parallelism for training, chunked attention everywhere.
TRAIN_FLAGS = OptFlags(remat="full", chunked_ce=True, seq_parallel_acts=True,
                       attn_impl="chunked", cast_params_bf16=True)
SERVE_FLAGS = OptFlags(attn_impl="chunked")

MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
    # one device (the runs chip_smoke.py times): plain tensors, no group
    "one": ((1, 1), ("data", "model")),
}


def serve_fsdp_free(cfg: ArchConfig) -> bool:
    """No-FSDP serving (weights resident, no per-step gathers) when the
    bf16 parameters over the 16-way model axis take at most a quarter of
    a device's memory (``roofline.HBM_BYTES``)."""
    return cfg.param_count() * 2 / 16 <= roofline.HBM_BYTES / 4


def rules_for(mesh_name: str, kind: str = "train", cfg=None) -> sh.MeshRules:
    serve = kind in ("prefill", "decode")
    free = serve_fsdp_free(cfg) if (serve and cfg is not None) else True
    if mesh_name == "multi":
        return sh.MULTI_POD_SERVE if (serve and free) else sh.MULTI_POD
    return sh.SINGLE_POD_SERVE if (serve and free) else sh.SINGLE_POD


@contextlib.contextmanager
def fake_mesh(mesh_name: str):
    """The mesh ``mesh_name`` on a fake process group of its size (this
    process is rank 0); the group is destroyed on exit.  A one-device
    mesh is None: its step runs on plain tensors, with no group."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape, names = MESHES[mesh_name]
    if math.prod(shape) == 1:
        yield None
        return
    if dist.is_initialized():
        raise RuntimeError("dry-run: a default process group is already "
                           "set up; the dry-run makes its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def _serving_cfg(cfg: ArchConfig) -> ArchConfig:
    """Serving uses bf16 params (production inference precision)."""
    return dataclasses.replace(cfg, param_dtype="bfloat16")


def _place(tree, specs, mesh):
    """``tree`` distributed by ``specs`` on ``mesh`` (as it is without
    one)."""
    return tree if mesh is None else sh.distribute_tree(tree, specs, mesh)


def meta_params(cfg) -> torch.nn.Module:
    """``cfg``'s parameters on the meta device: drawn under
    ``FakeTensorMode`` (the init draws from a generator), each then
    replaced by a meta tensor of its shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = api.init_params(cfg, torch.Generator(), "cpu")
    for mod in params.modules():
        for name, p in list(mod._parameters.items()):
            mod._parameters[name] = torch.nn.Parameter(
                torch.empty(p.shape, dtype=p.dtype, device="meta"),
                requires_grad=False)
    return params


@dataclasses.dataclass
class Step:
    """A cell's state on the mesh and the call that runs its step."""
    run: object
    arg_bytes: int
    specs: dict
    local_shapes: dict


def build_step(cfg, shape, kind, mesh, rules, flags, *, accum_steps=1,
               compress_grads=False) -> Step:
    """The cell's parameters, optimizer state, cache and batch on
    ``mesh``, as meta DTensors, and its step."""
    if kind != "train":
        cfg = _serving_cfg(cfg)
    params = meta_params(cfg)
    for p in params.parameters():
        p.requires_grad_(kind == "train")
    p_specs = sh.build_param_specs(params, rules, mesh)
    if mesh is not None:
        sh.distribute_params(params, p_specs, mesh)
    batch = api.input_specs(cfg, shape, kind)
    batch = _place(batch, sh.batch_specs(batch, rules, mesh), mesh)
    specs = {"params": p_specs}
    arg_bytes = sh.local_bytes(params) + sh.local_bytes(batch)
    if kind == "train":
        state = opt.init(params)
        arg_bytes += sh.local_bytes([state.step, state.mu, state.nu])
        step = build_train_step(cfg, opt.AdamWConfig(), flags,
                                accum_steps=accum_steps,
                                compress_grads=compress_grads)
        run = lambda: step(params, state, batch)  # noqa: E731
    elif kind == "prefill":
        prefill = api.prefill_fn(cfg)
        run = lambda: prefill(params, batch, shape.seq_len, flags)  # noqa
    else:
        cache = api.init_decode_cache(cfg, shape.global_batch,
                                      shape.seq_len, "meta")
        specs["cache"] = sh.cache_specs(cache, rules, mesh)
        cache = _place(cache, specs["cache"], mesh)
        arg_bytes += sh.local_bytes(cache)
        decode = api.decode_fn(cfg)
        run = lambda: decode(params, cache, batch["token"], flags)  # noqa
        batch["cache"] = cache
    local = _local_shapes(dict(params.named_parameters()))
    local.update(_local_shapes(batch))
    return Step(run, arg_bytes, specs, local)


def _local_shapes(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_local_shapes(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_local_shapes(v, f"{prefix}{i}."))
        return out
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if sh.is_dtensor(tree) else tree
        return {prefix[:-1]: tuple(t.shape)}
    return {}


def trace_step(cfg, shape, kind, mesh, rules, flags, **kw) -> dict:
    """Build the cell's state and run its step once, counted (module
    docstring, steps 2-3)."""
    from torch.distributed.tensor.experimental import implicit_replication

    t0 = time.perf_counter()
    step = build_step(cfg, shape, kind, mesh, rules, flags, **kw)
    counter = roofline.StepCounter(base_bytes=step.arg_bytes)
    grad = torch.enable_grad() if kind == "train" else torch.no_grad()
    with sh.use_rules(rules, mesh), implicit_replication(), grad, counter:
        try:
            step.run()
        except RuntimeError as e:
            if counter.failed is None:
                raise
            raise RuntimeError(f"{counter.failed}: {e}") from e
    coll = counter.report()
    return {"flops": float(counter.flops),
            "bytes": float(counter.bytes_accessed),
            "coll": coll["total"],
            "coll_breakdown": {k: v for k, v in coll.items()
                               if k not in ("total", "counts")},
            "coll_counts": coll["counts"],
            "arg_bytes": step.arg_bytes,
            "temp_bytes": counter.peak - step.arg_bytes,
            "kernels": dict(counter.kernels),
            "seconds": time.perf_counter() - t0,
            "step": step}


def _probe_depths(cfg: ArchConfig):
    """Depth-1/depth-2 probe configs + the real repeat count."""
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        return (
            dataclasses.replace(cfg, n_layers=k),
            dataclasses.replace(cfg, n_layers=2 * k),
            cfg.n_layers // k,
        )
    if cfg.family == "encdec":
        return (
            dataclasses.replace(cfg, n_layers=1, enc_layers=1, dec_layers=1),
            dataclasses.replace(cfg, n_layers=2, enc_layers=2, dec_layers=2),
            cfg.dec_layers,
        )
    return (
        dataclasses.replace(cfg, n_layers=1),
        dataclasses.replace(cfg, n_layers=2),
        cfg.n_layers,
    )


def _corrected_costs(cfg, shape, kind, mesh, rules, flags, **kw):
    """Trace the depth-1/2 probes; extrapolate the full depth's per-device
    cost: corrected = d1 + (units - 1) * max(d2 - d1, 0), leafwise."""
    d1_cfg, d2_cfg, units = _probe_depths(cfg)
    out = {}
    for name, pcfg in (("d1", d1_cfg), ("d2", d2_cfg)):
        res = trace_step(pcfg, shape, kind, mesh, rules, flags, **kw)
        res.pop("step")
        out[name] = res

    def extrap(a, b):
        return a + (units - 1) * max(b - a, 0.0)

    d1, d2 = out["d1"], out["d2"]
    corrected = {"flops": extrap(d1["flops"], d2["flops"]),
                 "bytes accessed": extrap(d1["bytes"], d2["bytes"]),
                 "temp_bytes": extrap(d1["temp_bytes"], d2["temp_bytes"])}
    coll = {k: extrap(d1["coll_breakdown"][k], d2["coll_breakdown"][k])
            for k in d1["coll_breakdown"]}
    coll["total"] = sum(coll.values())
    coll["counts"] = {k: int(extrap(d1["coll_counts"][k],
                                    d2["coll_counts"][k]))
                      for k in d1["coll_counts"]}
    out["units"] = units
    return corrected, coll, out


def lower(cfg: ArchConfig, shape: ShapeSpec, mesh_name: str, *,
          arch: str | None = None, train_flags: OptFlags = TRAIN_FLAGS,
          serve_flags: OptFlags = SERVE_FLAGS, accum_steps: int = 1,
          compress_grads: bool = False, probes: bool = True,
          verbose: bool = True):
    """Trace one (config x shape x mesh) cell.  Returns (report, info):
    ``info`` holds the full-depth state's ``specs``, ``local_shapes`` and
    ``arg_bytes``."""
    kind = shape.kind
    rules = rules_for(mesh_name, kind, cfg)
    flags = train_flags if kind == "train" else serve_flags
    kw = (dict(accum_steps=accum_steps, compress_grads=compress_grads)
          if kind == "train" else {})
    t0 = time.perf_counter()
    with fake_mesh(mesh_name) as mesh:
        n_dev = 1 if mesh is None else mesh.size()
        if probes:
            full = build_step(cfg, shape, kind, mesh, rules, flags, **kw)
            corrected, coll, probe_raw = _corrected_costs(
                cfg, shape, kind, mesh, rules, flags, **kw)
            temp = corrected["temp_bytes"]
        else:
            res = trace_step(cfg, shape, kind, mesh, rules, flags, **kw)
            full = res["step"]
            corrected = {"flops": res["flops"],
                         "bytes accessed": res["bytes"]}
            coll = {**res["coll_breakdown"], "total": res["coll"],
                    "counts": res["coll_counts"]}
            temp, probe_raw = res["temp_bytes"], {}
    mem = {"argument_bytes": full.arg_bytes, "temp_bytes": temp,
           "peak_bytes": full.arg_bytes + temp,
           "trace_seconds": time.perf_counter() - t0}
    report = roofline.analyze(
        arch=arch or cfg.name, shape=shape, kind=kind, cfg=cfg,
        mesh_name=mesh_name, n_chips=n_dev, cost=corrected, coll=coll,
        memory_analysis=mem, note=f"flags={flags} rules={rules}",
        probes=probe_raw)
    if verbose:
        print(
            f"[{report.arch} x {shape.name} x {mesh_name}] devices={n_dev} "
            f"trace={mem['trace_seconds']:.1f}s "
            f"args={mem['argument_bytes'] / 2**30:.2f}GiB "
            f"temp={temp / 2**30:.2f}GiB "
            f"peak~{mem['peak_bytes'] / 2**30:.2f}GiB/device | "
            f"compute={report.compute_s * 1e3:.2f}ms "
            f"memory={report.memory_s * 1e3:.2f}ms "
            f"coll={report.collective_s * 1e3:.2f}ms "
            f"-> {report.bottleneck}-bound, useful={report.useful_ratio:.2f}",
            flush=True)
    info = {"specs": full.specs, "local_shapes": full.local_shapes,
            "arg_bytes": full.arg_bytes, "rules": rules}
    return report, info


def lower_cell(arch_id: str, shape_id: str, mesh_name: str, **kw):
    """``lower`` of a registered (arch, shape) cell; (None, why) where the
    shape does not apply to the arch."""
    cfg = get_config(arch_id)
    ok, why = applicable(cfg, shape_id)
    if not ok:
        return None, why
    return lower(cfg, SHAPES[shape_id], mesh_name, arch=arch_id, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="roofline_out")
    ap.add_argument("--remat", choices=["none", "full", "dots"],
                    default="full")
    ap.add_argument("--attn", choices=["naive", "chunked"], default="chunked")
    ap.add_argument("--no-chunked-ce", action="store_true")
    ap.add_argument("--no-sp-acts", action="store_true")
    ap.add_argument("--no-cast-bf16", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--no-probes", action="store_true",
                    help="trace the full depth once instead of the "
                         "depth-1/2 probes")
    ap.add_argument("--tag", default="", help="suffix for output filenames")
    args = ap.parse_args(argv)

    train_flags = OptFlags(
        remat=args.remat,
        chunked_ce=not args.no_chunked_ce,
        seq_parallel_acts=not args.no_sp_acts,
        attn_impl=args.attn,
        cast_params_bf16=not args.no_cast_bf16,
    )
    serve_flags = OptFlags(attn_impl=args.attn)

    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    failures = []
    for arch_id, shape_id in cells:
        for mesh_name in meshes:
            tag = f"{arch_id}_{shape_id}_{mesh_name}"
            if args.tag:
                tag += f"_{args.tag}"
            path = os.path.join(args.out, tag + ".json")
            try:
                report, info = lower_cell(
                    arch_id, shape_id, mesh_name,
                    train_flags=train_flags, serve_flags=serve_flags,
                    accum_steps=args.accum,
                    compress_grads=args.compress_grads,
                    probes=not args.no_probes)
            except Exception as e:  # noqa: BLE001 - report and continue
                failures.append((tag, repr(e)))
                print(f"[{tag}] FAIL: {e!r}", flush=True)
                traceback.print_exc()
                with open(path, "w") as f:
                    json.dump({"fail": repr(e)}, f)
                continue
            if report is None:
                print(f"[{tag}] SKIP: {info}", flush=True)
                with open(path, "w") as f:
                    json.dump({"skip": info}, f)
                continue
            roofline.save_report(report, path)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        sys.exit(1)
    print("\ndry-run complete: every applicable cell traced.")


if __name__ == "__main__":
    main()
