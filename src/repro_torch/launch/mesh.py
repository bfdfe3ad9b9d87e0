"""Production mesh construction (the port's ``repro/launch/mesh.py``).

Defined as functions (never module-level constants), so importing this
module touches no process group or device: a ``DeviceMesh`` needs the
default process group, which the caller sets up first (``dryrun.py``'s
fake group of the mesh's size, or ``torch.distributed.init_process_group``
on real ranks).  ``device_type`` is "cuda" unless the caller asks for the
CPU, as the port's other entry points.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 single pod (256 devices) or 2x16x16 two-pod (512 devices)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_serving_mesh(*, chain: int = 4, multi_pod: bool = False,
                      device_type: str = "cuda") -> DeviceMesh:
    """Serving mesh with an explicit chain-replication axis carved out of
    the data axis: (chain, data, model)."""
    if multi_pod:
        shape = (2, chain, 16 // chain, 16)
        axes = ("pod", "chain", "data", "model")
    else:
        shape = (chain, 16 // chain, 16)
        axes = ("chain", "data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(n: int | None = None, axis: str = "chain",
                   device_type: str = "cuda") -> DeviceMesh:
    """Small 1-D mesh over the default group's ranks (tests/examples)."""
    n = n or dist.get_world_size()
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))
