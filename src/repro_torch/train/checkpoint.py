"""Checkpoints with async save and coordinator-registered epochs (the
port's copy of ``repro/train/checkpoint.py``, in its layout).

Layout: ``<dir>/step_<N>/``
  ``manifest.json`` - step, data offset, the tree's leaf paths and dtypes
  ``shard_<i>.npz`` - the flat leaves (a new file past 1 GiB)

* saves are atomic: written to ``step_<N>.tmp``, then renamed;
* the epoch and the data offset are committed to the coordination store
  (``Coordinator.put_host``, keys ``CKPT_EPOCH_KEY`` and
  ``DATA_OFFSET_KEY``) only after the rename;
* ``AsyncCheckpointer`` saves on a background thread from a host snapshot
  taken before ``save_async`` returns.

A tree is the port's: ``nn.Module`` parameter trees (``named_parameters``
order), dicts (insertion order), lists, tuples and NamedTuples (the
optimizer state), and tensors or numpy arrays at the leaves, flattened in
that fixed order.  A bf16 leaf is stored as its uint16 bits, its dtype in
the manifest (numpy has no bf16).  ``restore`` returns a new tree of
``tree_like``'s structure, each leaf on its counterpart's device and in
its dtype (a parameter keeps its ``requires_grad``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.models import layers as L

CKPT_EPOCH_KEY = 0       # well-known coordination keys
DATA_OFFSET_KEY = 1

_MAX_SHARD_BYTES = 1 << 30


def _flatten(tree, path: str = "") -> list:
    """``[(path, leaf), ...]`` in the fixed order of the module's
    docstring."""
    if isinstance(tree, nn.Module):
        return [(f"{path}{k}", p) for k, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flatten(v, f"{path}{k}/")]
    if isinstance(tree, (list, tuple)):
        keys = getattr(tree, "_fields", range(len(tree)))
        return [x for k, v in zip(keys, tree) for x in _flatten(v, f"{path}{k}/")]
    return [(path.rstrip("/"), tree)]


def _unflatten(tree, leaves):
    """A tree of ``tree``'s structure with the next items of the iterator
    ``leaves`` (tensors) in place of its leaves."""
    if isinstance(tree, nn.ParameterDict):
        return nn.ParameterDict({
            k: nn.Parameter(next(leaves), requires_grad=p.requires_grad)
            for k, p in tree.items()})
    if isinstance(tree, L.ParamTree):
        return L.ParamTree({
            k: (_unflatten(v, leaves) if isinstance(v, nn.Module)
                else nn.Parameter(next(leaves), requires_grad=v.requires_grad))
            for k, v in tree.items()})
    if isinstance(tree, nn.ModuleList):
        return nn.ModuleList([_unflatten(m, leaves) for m in tree])
    if isinstance(tree, nn.ModuleDict):
        return nn.ModuleDict({k: _unflatten(m, leaves)
                              for k, m in tree.items()})
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_unflatten(v, leaves) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return next(leaves)


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """A leaf as (numpy array, dtype name); bf16 as its uint16 bits."""
    if isinstance(x, np.ndarray):
        return x, str(x.dtype)
    x = x.detach().to("cpu", copy=True)   # a snapshot, never a view
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return x.numpy(), str(x.dtype).replace("torch.", "")


def _from_numpy(a: np.ndarray, dtype: str, like) -> Any:
    if isinstance(like, np.ndarray):
        return a.astype(like.dtype)
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=like.device, dtype=like.dtype).clone()


def host_snapshot(tree) -> list:
    """``[(path, numpy array, dtype name), ...]`` of the tree's leaves."""
    return [(p, *_to_numpy(x)) for p, x in _flatten(tree)]


def save(path: str, step: int, tree: Any, *, data_offset: int = 0,
         extra: Optional[dict] = None) -> str:
    """Synchronous atomic save of ``tree`` (or of a ``host_snapshot``
    list).  Returns the final directory."""
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    leaves = tree if isinstance(tree, list) else host_snapshot(tree)
    shards: list[list[int]] = [[]]
    size = 0
    for i, (_, a, _) in enumerate(leaves):
        if size > _MAX_SHARD_BYTES:
            shards.append([])
            size = 0
        shards[-1].append(i)
        size += a.nbytes
    for si, idxs in enumerate(shards):
        np.savez(os.path.join(tmp, f"shard_{si}.npz"),
                 **{f"leaf_{i}": leaves[i][1] for i in idxs})
    manifest = {
        "step": step,
        "data_offset": data_offset,
        "n_leaves": len(leaves),
        "n_shards": len(shards),
        "treedef": [p for p, _, _ in leaves],
        "dtypes": [dt for _, _, dt in leaves],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(path: str) -> list[int]:
    return [int(d.split("_")[1]) for d in os.listdir(path)
            if d.startswith("step_") and not d.endswith(".tmp")]


def restore(path: str, tree_like: Any, step: Optional[int] = None):
    """Restore into the structure of ``tree_like`` (the latest step unless
    ``step``).  Returns ``(tree, manifest)``."""
    if step is None:
        steps = sorted(_steps(path))
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        step = steps[-1]
    final = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    buf: dict[int, np.ndarray] = {}
    for si in range(manifest["n_shards"]):
        with np.load(os.path.join(final, f"shard_{si}.npz")) as z:
            for k in z.files:
                buf[int(k.split("_")[1])] = z[k]
    like = _flatten(tree_like)
    if len(like) != manifest["n_leaves"] or \
            [p for p, _ in like] != manifest["treedef"]:
        raise ValueError(f"checkpoint {final} does not match the model's "
                         "tree")
    leaves = (_from_numpy(buf[i], manifest["dtypes"][i], x)
              for i, (_, x) in enumerate(like))
    return _unflatten(tree_like, leaves), manifest


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = _steps(path)
    return max(steps) if steps else None


class AsyncCheckpointer:
    """Background-thread saver; at most one save in flight (``save_async``
    waits for the previous one)."""

    def __init__(self, path: str, coordinator=None, store=None):
        self.path = path
        self.coordinator = coordinator
        self.store = store
        self._thread: Optional[threading.Thread] = None
        self._last_committed: Optional[int] = None

    def save_async(self, step: int, tree: Any, *, data_offset: int = 0):
        snapshot = host_snapshot(tree)   # taken before returning
        self.wait()

        def work():
            save(self.path, step, snapshot, data_offset=data_offset)
            self._last_committed = step
            if self.coordinator is not None and self.store is not None:
                self.store = self.coordinator.put_host(
                    self.store, CKPT_EPOCH_KEY, step)
                self.store = self.coordinator.put_host(
                    self.store, DATA_OFFSET_KEY, data_offset)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @property
    def last_committed(self) -> Optional[int]:
        return self._last_committed
