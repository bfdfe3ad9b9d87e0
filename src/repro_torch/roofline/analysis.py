"""Roofline analysis of a step (the port's ``repro/roofline/analysis.py``).

Three terms per (arch x shape x mesh), in seconds, on one H100 SXM:

    compute    = FLOPs_per_device / BF16_FLOP_PER_S
    memory     = bytes_per_device / HBM_BYTES_PER_S
    collective = coll_bytes_per_device / NVLINK_BYTES_PER_S

The figures are NVIDIA's H100 SXM data sheet values (dense, no sparsity,
at the card's full 700 W limit); every bound ``chip_smoke.py`` prints
reads them from here.

The FLOPs and bytes come from ``StepCounter``, a ``TorchDispatchMode``
that sees the ops a step runs on each device's LOCAL tensors: over
DTensors it returns ``NotImplemented`` for the DTensor-level op, so
DTensor desugars it into local ops and collectives, which the mode then
counts.  FLOPs are the matrix products' (``torch.utils.flop_counter``'s
formulas: mm, bmm, addmm, baddbmm, convolutions, SDPA); elementwise ops
count bytes only.  Bytes are every non-view local op's inputs and outputs,
each time it runs: the traffic of eager PyTorch, where no op is fused.
The collectives are recorded by ``CollectiveRecorder`` (the counterpart
of the reference's HLO parser): each ``_c10d_functional`` collective
(DTensor's, and ``torch.distributed._functional_collectives``') and each
``c10d`` collective (``torch.distributed.all_reduce`` and the rest) with
its result bytes and group size, weighted with the reference's ring
factors:

    all-reduce      2 x result bytes          (reduce-scatter + all-gather)
    all-gather      1 x result bytes          (receives result minus shard)
    reduce-scatter  (g-1) x result bytes      (input = g x result)
    all-to-all      1 x result bytes
    collective-permute  1 x result bytes      (a point-to-point send)

MODEL_FLOPS (the "useful" floor) = 6*N*D for training (N = active params,
D = tokens) / 2*N*D for inference, plus the causal-attention quadratic
term; the MODEL/counted ratio exposes remat recompute and MoE capacity
waste, and MODEL_FLOPS over a measured step time and the bf16 peak is the
step's MFU.
"""
from __future__ import annotations

import dataclasses
import json
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.kernels.build import WORK_SINK

# NVIDIA H100 SXM data sheet (dense rates, 700 W)
BF16_FLOP_PER_S = 989e12     # bf16 tensor-core peak
TF32_FLOP_PER_S = 495e12     # TF32 tensor-core peak
F32_FLOP_PER_S = 67e12       # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12    # HBM3 bandwidth
HBM_BYTES = 80e9             # device memory (80 GB)
NVLINK_BYTES_PER_S = 450e9   # NVLink 4, each direction (900 GB/s both)

_COLLECTIVES = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": None,   # (g-1) x result
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}
# op name (namespace.op, overload dropped) -> kind
_KINDS = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
}


def _op_name(func) -> str:
    return f"{func.namespace}.{func._opname}"


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def _group_size(func, args, kwargs) -> int:
    """The group size of a collective: its ``group_size`` argument, else
    the size of its process group (by name, or the ``ProcessGroup``)."""
    schema = func._schema.arguments
    named = dict(zip((a.name for a in schema), args))
    named.update(kwargs)
    if "group_size" in named:
        return int(named["group_size"])
    if "group_name" in named:
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group(named["group_name"]).size()
    for a in args:
        if hasattr(a, "size") and not isinstance(a, torch.Tensor) \
                and callable(a.size):
            return int(a.size())
    return 2


def _result_bytes(func, args, out) -> int:
    """Bytes of a collective's result: a ``send``'s tensors, a ``c10d``
    op's output tensors (in place: its first argument), a functional
    op's returned tensors."""
    name = _op_name(func)
    if name == "c10d.send" or (name.startswith("c10d.") and out is None):
        src = args[0]
    elif name.startswith("c10d."):
        src = out[0] if isinstance(out, (tuple, list)) else out
    else:
        src = out
    return sum(_nbytes(t) for t in tree_leaves(src)
               if isinstance(t, torch.Tensor))


def _has_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


class CollectiveRecorder(TorchDispatchMode):
    """Records the collectives run under it (module docstring):
    ``report()`` gives bytes per kind with the ring factors, ``"total"``
    and ``"counts"``, the layout of the reference's
    ``parse_collective_bytes``."""

    def __init__(self):
        super().__init__()
        self.bytes = {k: 0.0 for k in _COLLECTIVES}
        self.counts = {k: 0 for k in _COLLECTIVES}

    def record(self, func, args, kwargs, out) -> None:
        kind = _KINDS.get(_op_name(func))
        if kind is None:
            return
        factor = _COLLECTIVES[kind]
        if factor is None:
            factor = float(_group_size(func, args, kwargs) - 1)
        self.bytes[kind] += _result_bytes(func, args, out) * factor
        self.counts[kind] += 1

    def report(self) -> dict:
        out = dict(self.bytes)
        out["total"] = sum(self.bytes.values())
        out["counts"] = dict(self.counts)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor(types):
            # let DTensor desugar the op into local ops and collectives,
            # which come back through this mode
            return NotImplemented
        out = func(*args, **kwargs)
        self.record(func, args, kwargs, out)
        return out


def _is_view(func) -> bool:
    return func.is_view or func._schema.name in _NO_TRAFFIC


_NO_TRAFFIC = {"aten::detach", "aten::alias", "aten::lift_fresh",
               "prim::device", "aten::_to_copy_meta", "aten::empty_like",
               "aten::empty", "aten::empty_strided",
               "_c10d_functional::wait_tensor"}


class StepCounter(CollectiveRecorder):
    """Counts what a step does on this device's local tensors: matrix
    FLOPs, bytes in and out of every non-view op (module docstring), the
    collectives, and the peak of live local bytes.

    Live bytes: ``base`` (what the caller holds alive through the step:
    parameters, optimizer state, cache, batch) plus every output of a
    non-view op from when it is made until its tensor is freed (a weak
    reference's callback; outputs that alias an input are not new
    memory).  A view that outlives its base keeps memory this count has
    already released, so the peak is a lower bound of the allocator's.

    DTensor infers each op's global output shape by running it on fake
    tensors of a mode of its own; ops on fake tensors are that inference,
    not the step's work, and are not counted.  A kernel wrapper handed
    ``meta`` tensors reports the kernel's work (``build.note_kernel``,
    counted in ``kernels`` by name) instead of running its plain version.  A
    local op that raises is kept in ``failed`` (the op, and the autograd
    node running it in a backward) for the caller's report.
    """

    def __init__(self, base_bytes: int = 0):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.live = base_bytes
        self.peak = base_bytes
        self.kernels = {}
        self.failed = None
        self._token = None

    def __enter__(self):
        self._token = WORK_SINK.set(self.note_kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        WORK_SINK.reset(self._token)
        return super().__exit__(*exc)

    def note_kernel(self, name: str, flops: float, nbytes: float) -> None:
        """A kernel's work, from a wrapper handed ``meta`` tensors."""
        self.flops += flops
        self.bytes_accessed += nbytes
        self.kernels[name] = self.kernels.get(name, 0) + 1

    def _free(self, n: int) -> None:
        self.live -= n

    @staticmethod
    def _foreign(tensors) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor

        return any(isinstance(t, FakeTensor) for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor(types):
            return NotImplemented
        try:
            out = func(*args, **kwargs)
        except RuntimeError:
            node = torch._C._current_autograd_node()
            self.failed = f"{func}" + ("" if node is None else
                                      f" in {node.name()}")
            raise
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if self._foreign(ins) or self._foreign(outs):
            return out
        self.record(func, args, kwargs, out)
        if _is_view(func) or func.namespace in ("_c10d_functional", "c10d"):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        self.bytes_accessed += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        in_storages = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if t.untyped_storage()._cdata in in_storages:
                continue     # written in place
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def model_flops(cfg: ArchConfig, shape: ShapeSpec, kind: str) -> float:
    """Useful-work floor (per whole job, NOT per device)."""
    n_active = cfg.param_count(active_only=True)
    B, S = shape.global_batch, shape.seq_len

    def attn_fwd():
        """Forward attention FLOPs (QK^T + PV) for one full pass."""
        if not cfg.n_heads:
            return 0.0
        hd = cfg.n_heads * cfg.head_dim
        if cfg.family == "encdec":
            enc = 4 * cfg.enc_layers * B * cfg.enc_len ** 2 * hd
            dec = 4 * cfg.dec_layers * B * S * S * hd * 0.5
            cross = 4 * cfg.dec_layers * B * S * cfg.enc_len * hd
            return enc + dec + cross
        if cfg.family == "hybrid":
            layers = cfg.n_layers // cfg.shared_attn_every
            return 4 * layers * B * S * S * hd * 0.5
        return 4 * cfg.n_layers * B * S * S * hd * 0.5

    if kind == "train":
        tokens = B * S
        return 6.0 * n_active * tokens + 3 * attn_fwd()
    if kind == "prefill":
        tokens = B * S
        return 2.0 * n_active * tokens + attn_fwd()
    # decode: one token per sequence + attention over the cache
    base = 2.0 * n_active * B
    attn = 0.0
    if cfg.n_heads:
        layers = (
            cfg.n_layers // cfg.shared_attn_every
            if cfg.family == "hybrid"
            else (cfg.dec_layers or cfg.n_layers)
        )
        attn = 4 * layers * B * S * cfg.n_heads * cfg.head_dim
    return base + attn


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: dict
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_total: float
    useful_ratio: float            # MODEL_FLOPS / (counted FLOPs * chips)
    roofline_fraction: float       # compute term over the largest term
    memory_analysis: dict
    note: str = ""
    probes: dict = dataclasses.field(default_factory=dict)

    @property
    def bound_s(self) -> float:
        """The least time the step could take: the largest term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def mfu(self, measured_s: float) -> float:
        """Model FLOPs per device over the bf16 peak, as a share of a
        measured step time."""
        return self.model_flops_total / (
            measured_s * BF16_FLOP_PER_S * self.n_chips)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def analyze(
    *,
    arch: str,
    shape: ShapeSpec,
    kind: str,
    cfg: ArchConfig,
    mesh_name: str,
    n_chips: int,
    cost: dict,
    coll: dict,
    memory_analysis: Optional[dict] = None,
    note: str = "",
    probes: Optional[dict] = None,
) -> RooflineReport:
    """``cost``: per-device ``"flops"`` and ``"bytes accessed"``;
    ``coll``: a ``CollectiveRecorder.report()`` (or its extrapolation)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    compute_s = flops / BF16_FLOP_PER_S
    memory_s = byts / HBM_BYTES_PER_S
    coll_s = coll["total"] / NVLINK_BYTES_PER_S
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape, kind)
    useful = mf / max(flops * n_chips, 1.0)
    frac = compute_s / max(max(terms.values()), 1e-30)
    return RooflineReport(
        arch=arch,
        shape=shape.name,
        mesh=mesh_name,
        n_chips=n_chips,
        flops_per_device=flops,
        bytes_per_device=byts,
        coll_bytes_per_device=coll["total"],
        coll_breakdown={k: v for k, v in coll.items()
                        if k not in ("total", "counts")},
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=coll_s,
        bottleneck=bottleneck,
        model_flops_total=mf,
        useful_ratio=useful,
        roofline_fraction=frac,
        memory_analysis=memory_analysis or {},
        note=note,
        probes=probes or {},
    )


def save_report(report: RooflineReport, path: str):
    with open(path, "w") as f:
        json.dump(report.to_json(), f, indent=1)
