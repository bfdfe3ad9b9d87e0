"""The port's collectives (``core/collectives.py``) on gloo CPU ranks
against their JAX counterparts under ``shard_map`` on 8 emulated
devices: ``ppermute_next`` with ``jax.lax.ppermute``'s zero fill,
``all_gather_tiled``, ``psum`` and ``broadcast_from`` (against the
tail-masked ``psum`` it replaces), each over chain groups of 4 on a
(2, 4) layout, exact for int32, float32 and bf16, except a float32
``psum``: gloo and XLA add the four terms in their own orders, so it is
held within 4 eps of the sum of their magnitudes.  Also: ``Msg`` and
role-row packing round trips, the rank layout, the byte counts, and a
rank that raises or dies failing the launcher.
"""
import concurrent.futures
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker as W
from helpers import run_with_devices
from repro_torch.core import chain as t_chain
from repro_torch.core import collectives as coll
from repro_torch.core.types import Msg, Roles

REFERENCE = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P

data = dict(np.load(%(inp)r))
mesh = jax.make_mesh((2, 4), ("g", "chain"))
n = 4

def body(x):
    x = x[0, 0]
    idx = jax.lax.axis_index("chain")
    out = dict(
        ppermute=jax.lax.ppermute(x, "chain", [(i, i + 1) for i in range(n - 1)]),
        all_gather=jax.lax.all_gather(x, "chain", axis=0, tiled=True),
        broadcast=jax.lax.psum(jnp.where(idx == n - 1, x, jnp.zeros_like(x)),
                               "chain"))
    if x.dtype != jnp.bfloat16:
        out["psum"] = jax.lax.psum(x, "chain")
    return {k: v[None, None] for k, v in out.items()}

out = {}
for name, arr in data.items():
    x = jnp.asarray(arr)
    if name == "bfloat16":
        x = x.view(jnp.bfloat16)
    x = x.reshape((2, 4) + x.shape[1:])
    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("g", "chain"),
                              out_specs=P("g", "chain"), check_vma=False))
    for k, v in f(x).items():
        v = np.asarray(v)
        if v.dtype != np.float32 and v.dtype != np.int32:
            v = v.view(np.int16)
        out[f"{name}/{k}"] = v
np.savez(%(out)r, **out)
print("COLLECTIVES_OK")
"""


def _data():
    rng = np.random.default_rng(3)
    return {
        "int32": rng.integers(-(1 << 30), 1 << 30, (8, 3, 5)).astype(np.int32),
        "float32": rng.standard_normal((8, 4, 2)).astype(np.float32),
        "bfloat16": torch.from_numpy(rng.standard_normal((8, 6)).astype(
            np.float32)).to(torch.bfloat16).view(torch.int16).numpy(),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    inp, out = str(tmp / "inputs.npz"), str(tmp / "reference.npz")
    data = _data()
    np.savez(inp, **data)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref_run = pool.submit(run_with_devices,
                              REFERENCE % dict(inp=inp, out=out), 8, 300)
        port = coll.spawn_ranks(W.collectives_run, 8, device="cpu",
                                args=(data,))
        assert "COLLECTIVES_OK" in ref_run.result()
    return dict(np.load(out)), port, data


@pytest.mark.parametrize("dtype", ["int32", "float32", "bfloat16"])
@pytest.mark.parametrize("op", ["ppermute", "all_gather", "psum",
                                "broadcast"])
def test_collective_equals_jax(runs, dtype, op):
    ref, port, data = runs
    if op == "psum" and dtype == "bfloat16":
        assert "psum" not in port[0][dtype]
        return
    exp = ref[f"{dtype}/{op}"]                       # [2, 4, ...]
    for r in range(8):
        got = port[r][dtype][op]
        e = exp[r // 4, r % 4]
        assert got.dtype == e.dtype and got.shape == e.shape, (r, got.shape,
                                                              e.shape)
        if op == "psum" and dtype == "float32":
            # gloo and XLA add the four terms in their own orders
            g = r // 4 * 4
            bound = 4 * np.finfo(np.float32).eps * np.abs(
                data[dtype][g:g + 4]).sum(axis=0)
            assert (np.abs(got - e) <= bound).all(), (op, dtype, r)
            continue
        assert np.array_equal(got, e), (op, dtype, r)


def test_ppermute_head_receives_zeros(runs):
    _, port, data = runs
    for r in range(8):
        got = port[r]["int32"]["ppermute"]
        if r % 4 == 0:
            assert (got == 0).all()
        else:
            assert np.array_equal(got, data["int32"][r - 1])


def test_rank_layout_and_bytes(runs):
    _, port, data = runs
    nbytes = sum(a[0].nbytes for a in data.values())
    for r in range(8):
        g, pos, ranks = port[r]["layout"]
        assert (g, pos) == (r // 4, r % 4)
        assert ranks == tuple(range(g * 4, g * 4 + 4))
        sent = port[r]["bytes"]
        assert sent["ppermute"] == (0 if pos == 3 else nbytes)
        assert sent["all_gather"] == 3 * nbytes
        assert sent["psum"] == 3 * (data["int32"][0].nbytes
                                    + data["float32"][0].nbytes)
        assert sent["broadcast"] == (3 * nbytes if pos == 3 else 0)


@pytest.mark.parametrize("shape,W", [((5,), 4), ((2, 3), 4), ((1, 1, 7), 2),
                                     ((0,), 4)])
def test_msg_pack_round_trip(shape, W):
    rng = np.random.default_rng(len(shape) * 10 + W)
    msg = Msg(**{f: torch.from_numpy(rng.integers(
        -(1 << 31), (1 << 31) - 1, shape + ((W,) if f == "value" else ()),
        dtype=np.int64).astype(np.int32)) for f in Msg._fields})
    packed = coll.pack_msg(msg)
    assert packed.dtype == torch.int32
    assert packed.shape == (int(np.prod(shape)), len(Msg._fields) - 1 + W)
    back = coll.unpack_msg(packed, shape)
    for f in Msg._fields:
        assert torch.equal(getattr(back, f), getattr(msg, f)), f


def test_roles_row_round_trip():
    for alive, frozen in ((range(4), False), ([0, 2, 3], True)):
        roles = Roles.from_membership(4, alive, frozen=frozen, device="cpu")
        rows = torch.cat([t_chain._pack_roles(
            Roles(*[x[i:i + 1] for x in roles]), 15) for i in range(4)])
        assert rows.shape == (4, 15) and rows.dtype == torch.int32
        back = t_chain._unpack_roles(rows)
        for f in Roles._fields:
            assert torch.equal(getattr(back, f), getattr(roles, f)), f


@pytest.mark.parametrize("how,exc", [
    ("raise", mp.ProcessRaisedException),
    ("exit", mp.ProcessExitedException)])
def test_failing_rank_fails_the_launch(how, exc):
    t0 = time.perf_counter()
    with pytest.raises(exc):
        coll.spawn_ranks(W.raise_on, 2, device="cpu", timeout=30,
                         args=(1, how))
    assert time.perf_counter() - t0 < 60


def test_rank_device_maps_ranks_onto_cards():
    assert coll.rank_device(5, "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            coll.rank_device(0, "cuda")


def test_spawn_ranks_runs_on_cuda_unless_asked_for_the_cpu():
    """The launcher's ranks default to the card, as every entry point of
    the port does; with no card that is an error before any rank starts."""
    import inspect

    assert inspect.signature(coll.spawn_ranks).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            coll.spawn_ranks(W.raise_on, 2, args=(1, "raise"))
        assert time.perf_counter() - t0 < 5
