"""Carry state and weights between the JAX package and the port.

For the engine, what crosses over is state: a ``SimState`` (its wave
table and telemetry plane included), an open-loop generator
(``loadgen_from``), message schedules, partition maps, role tables, the
control plane's host state, and transactions and their results.  For
the models it is a parameter tree: ``lm_params_from`` builds the port's
from the reference's ``init_lm`` pytree and ``encdec_params_from`` from
its ``init_encdec`` pytree; ``lm_params_to_numpy`` and
``encdec_params_to_numpy`` turn them back; ``adamw_state_from`` and
``adamw_state_to_numpy`` do the same for the AdamW state, whose moments
are trees like the parameters'.  These functions take any NamedTuple-like object whose fields
hold array-likes (the JAX package's pytrees after ``np.asarray``, or
numpy arrays) and build the port's structure on a given device, field by
field by name; ``to_numpy`` turns the port's structures back into numpy
for comparison.  The configuration and control-plane converters read the
reference's dataclasses and ``Coordinator`` by attribute name.  Nothing
here imports JAX: the caller hands over the objects.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core.chain import SimState
from repro_torch.core.coordinator import ChainMembership, Coordinator
from repro_torch.core.loadgen import LoadGenState
from repro_torch.core.metrics import Metrics, ReplyLog
from repro_torch.core.store import Store
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.txn import LockTable, Txn, TxnResult, WaveState
from repro_torch.core.types import (
    ChainConfig,
    ClusterConfig,
    Msg,
    PartitionMap,
    Roles,
    resolve_device,
)
from repro_torch.models.layers import ParamTree

_NESTED = {
    "stores": Store,
    "inbox": Msg,
    "locks": LockTable,
    "metrics": Metrics,
    "replies": ReplyLog,
    "roles": Roles,
    "pmap": PartitionMap,
    "wave": WaveState,
    "telemetry": Telemetry,
}
# NamedTuple fields that hold a NamedTuple of their own
_INNER = {WaveState: {"coord_in": Msg}, LoadGenState: {"backlog": Msg}}


def _tensor(x, device) -> torch.Tensor:
    # np.array copies: JAX hands out read-only buffers
    return torch.from_numpy(np.array(x)).to(device)


def from_arrays(cls, obj, device="cuda"):
    """Build the port's NamedTuple ``cls`` from ``obj``'s same-named
    fields (array-likes), on ``device``."""
    dev = resolve_device(device)
    inner = _INNER.get(cls, {})
    return cls(**{f: (from_arrays(inner[f], getattr(obj, f), dev)
                      if f in inner else _tensor(getattr(obj, f), dev))
                  for f in cls._fields})


def state_from_arrays(state, device="cuda") -> SimState:
    """A port ``SimState`` from the reference's ``SimState``: every
    leaf, the wave table with its nested ``coord_in`` Msg and the
    telemetry plane (zero-size leaves when it is off) included."""
    dev = resolve_device(device)
    parts = {f: from_arrays(cls, getattr(state, f), dev)
             for f, cls in _NESTED.items()}
    return SimState(**parts, t=_tensor(state.t, dev))


def telemetry_from(tel, device="cuda") -> Telemetry:
    """The port's ``Telemetry`` from the reference's (``SimState.
    telemetry``, [C]-leading leaves)."""
    return from_arrays(Telemetry, tel, device)


def loadgen_from(gen, device="cuda") -> LoadGenState:
    """The port's ``LoadGenState`` from the reference's, its backlog
    ``Msg`` included."""
    return from_arrays(LoadGenState, gen, device)


def to_numpy(tree):
    """The same NamedTuple structure with numpy leaves."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[to_numpy(x) for x in tree])
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def txns_from(txns) -> list[Txn]:
    """The port's ``Txn``s with the fields of ``txns`` (the reference's)."""
    return [Txn(txn_id=int(t.txn_id),
                writes=tuple((int(k), int(v)) for k, v in t.writes),
                reads=tuple(int(k) for k in t.reads), client=int(t.client))
            for t in txns]


def results_from(results) -> list[TxnResult]:
    """The port's ``TxnResult``s with the fields of ``results`` (the
    reference's)."""
    return [TxnResult(txn_id=int(r.txn_id), committed=bool(r.committed),
                      mode=r.mode, nacks=int(r.nacks),
                      write_seqs={int(k): int(v)
                                  for k, v in r.write_seqs.items()},
                      read_values={int(k): int(v)
                                   for k, v in r.read_values.items()})
            for r in results]


def cluster_from(cfg) -> ClusterConfig:
    """The port's ``ClusterConfig`` with the fields of ``cfg`` (a
    reference ``ClusterConfig``)."""
    chain = ChainConfig(**{f.name: getattr(cfg.chain, f.name)
                           for f in dataclasses.fields(ChainConfig)})
    return ClusterConfig(chain=chain, n_chains=cfg.n_chains,
                         buckets_per_chain=cfg.buckets_per_chain,
                         spare_keys=cfg.spare_keys)


def memberships_from(chains) -> list[ChainMembership]:
    """Port ``ChainMembership``s with the fields of ``chains``."""
    return [ChainMembership(node_ids=list(m.node_ids), epoch=m.epoch,
                            writes_frozen=m.writes_frozen) for m in chains]


def coordinator_state(co) -> dict:
    """The host state of a control plane (the reference's ``Coordinator``
    or the port's) as plain Python values, equal between the two when
    they agree: memberships, partition placement, epochs, free landing
    regions, the open migration and the failure detectors."""
    return {
        "chains": [(list(m.node_ids), m.epoch, m.writes_frozen)
                   for m in co.chains],
        "owner": [int(x) for x in co._p_owner],
        "base": [int(x) for x in co._p_base],
        "epoch": int(co._p_epoch),
        "slot_epoch": np.asarray(co._p_slot_epoch).tolist(),
        "free": {int(c): [int(x) for x in v] for c, v in co._p_free.items()},
        "pending_move": (None if co._pending_move is None
                         else tuple(int(x) for x in co._pending_move)),
        "failover_timeout": co.failover.timeout_ticks,
        "detectors": [dataclasses.asdict(d) for d in co.detectors],
    }


def coordinator_from(co, device="cuda") -> Coordinator:
    """A port ``Coordinator`` with the host state of ``co`` (the
    reference's): the same cluster, memberships, partition placement,
    epochs, free regions, open migration and detectors."""
    out = Coordinator(cluster_from(co.cluster), device=device)
    out.chains = memberships_from(co.chains)
    out._p_owner = [int(x) for x in co._p_owner]
    out._p_base = [int(x) for x in co._p_base]
    out._p_epoch = int(co._p_epoch)
    out._p_slot_epoch = np.array(co._p_slot_epoch, np.int32)
    out._p_free = {int(c): [int(x) for x in v] for c, v in co._p_free.items()}
    out._pending_move = (None if co._pending_move is None
                         else tuple(int(x) for x in co._pending_move))
    out.failover.timeout_ticks = co.failover.timeout_ticks
    for mine, theirs in zip(out.detectors, co.detectors):
        for f in dataclasses.fields(mine):
            setattr(mine, f.name, copy.deepcopy(getattr(theirs, f.name)))
    return out


# ---------------------------------------------------------------------------
# model parameters
# ---------------------------------------------------------------------------
def params_from(tree: dict, device="cuda"):
    """A port parameter tree from a reference parameter dict with numpy
    leaves: ``nn.ParameterDict`` for a dict of arrays, ``nn.ModuleDict``
    for a dict of dicts, ``layers.ParamTree`` for a dict that holds both
    (the Mamba-2 mixer's)."""
    return _params_module(tree, resolve_device(device))


def _params_module(tree: dict, device):
    leaves = [not isinstance(v, dict) for v in tree.values()]
    if all(leaves):
        return nn.ParameterDict({
            k: nn.Parameter(_tensor(v, device), requires_grad=False)
            for k, v in tree.items()})
    if any(leaves):
        return ParamTree({
            k: (_params_module(v, device) if isinstance(v, dict)
                else _tensor(v, device))
            for k, v in tree.items()})
    return nn.ModuleDict({k: _params_module(v, device)
                          for k, v in tree.items()})


def _index(tree: dict, i: int) -> dict:
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _stacks_from(params: dict, stacks: dict, device) -> dict:
    """The port's entries of a reference parameter tree: each stacked
    ``[L, ...]`` entry of ``stacks`` (name -> L) split into an
    ``nn.ModuleList`` of L blocks, the other sub-dicts as modules, bare
    arrays as tensors."""
    return {k: (nn.ModuleList([_params_module(_index(v, i), device)
                               for i in range(stacks[k])])
                if k in stacks else _params_module(v, device)
                if isinstance(v, dict) else _tensor(v, device))
            for k, v in params.items()}


def lm_params_from(params: dict, cfg, device="cuda"):
    """The port's parameter tree (``transformer.init_lm``'s structure) from
    the reference's ``init_lm`` pytree with numpy leaves: the stacked
    ``[L, ...]`` layer leaves are split into ``cfg.n_layers`` blocks."""
    return nn.ModuleDict(_stacks_from(params, {"layers": cfg.n_layers},
                                      resolve_device(device)))


def encdec_params_from(params: dict, cfg, device="cuda"):
    """The port's encoder-decoder tree (``encdec.init_encdec``'s structure)
    from the reference's ``init_encdec`` pytree with numpy leaves: the
    stacked ``enc_layers``/``dec_layers`` leaves are split into
    ``cfg.enc_layers``/``cfg.dec_layers`` blocks; ``pos_dec`` stays a
    tensor beside the sub-dicts."""
    return ParamTree(_stacks_from(
        params, {"enc_layers": cfg.enc_layers, "dec_layers": cfg.dec_layers},
        resolve_device(device)))


def _numpy_tree(module) -> dict:
    return {k: (_numpy_tree(m) if isinstance(m, nn.Module)
                else m.detach().cpu().numpy())
            for k, m in module.items()}


def _stacks_to_numpy(params, stacks) -> dict:
    """The reference's pytree layout with numpy leaves: the blocks of each
    entry in ``stacks`` stacked on a leading ``[L, ...]`` axis."""
    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(x[k] for x in leaves)) for k in leaves[0]}
        return np.stack(leaves)

    return {k: (stack(*[_numpy_tree(b) for b in m]) if k in stacks
                else _numpy_tree(m) if isinstance(m, nn.Module)
                else m.detach().cpu().numpy())
            for k, m in params.items()}


def lm_params_to_numpy(params) -> dict:
    """The reference's pytree layout (layers stacked on ``[L, ...]``) with
    numpy leaves, from the port's parameter tree."""
    return _stacks_to_numpy(params, ("layers",))


def encdec_params_to_numpy(params) -> dict:
    """The reference's ``init_encdec`` layout (both layer stacks on
    ``[L, ...]``) with numpy leaves, from the port's tree."""
    return _stacks_to_numpy(params, ("enc_layers", "dec_layers"))


def _tree_from(cfg):
    return encdec_params_from if cfg.family == "encdec" else lm_params_from


def adamw_state_from(state, cfg, device="cuda"):
    """The port's ``optimizer.AdamWState`` from the reference's (numpy
    leaves): ``mu`` and ``nu`` split into blocks as the parameters are
    (``lm_params_from``/``encdec_params_from``) and keyed by the port's
    parameter names."""
    from repro_torch.train.optimizer import AdamWState

    dev = resolve_device(device)

    def named(tree) -> dict:
        return {k: p.detach() for k, p in
                _tree_from(cfg)(tree, cfg, dev).named_parameters()}

    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        mu=named(state.mu), nu=named(state.nu))


def adamw_state_to_numpy(state, params, cfg) -> dict:
    """``{"step", "mu", "nu"}`` in the reference's layout with numpy
    leaves, from the port's AdamW state of the parameter tree
    ``params``."""
    from repro_torch.train.checkpoint import _unflatten

    to_numpy = (encdec_params_to_numpy if cfg.family == "encdec"
                else lm_params_to_numpy)

    def tree(values: dict) -> dict:
        names = [k for k, _ in params.named_parameters()]
        return to_numpy(_unflatten(params, (values[k] for k in names)))

    return {"step": np.asarray(state.step.cpu(), dtype=np.int32),
            "mu": tree(state.mu), "nu": tree(state.nu)}
