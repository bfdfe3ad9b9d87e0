#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card, at full size.

    python3 chip_smoke.py

Builds the hand-written kv_engine kernels from ``src/repro_torch/kernels/
kv_engine/csrc`` with nvcc (sm_90a), then:

1. prints the card's name and power limit (nvidia-smi);
2. holds each kernel against its plain PyTorch version on the card, at
   the engine's shapes (a [32, 65536, 4, 4] store, a [32, 320] batch),
   on a seeded store with dirty versions, duplicate keys, window overflow
   and out-of-range keys, and times kernel, plain version and library
   yardstick beside the kernel's bound;
3. drives the main path: an 8-chain x 4-node NetCRAQ cluster of 65,536
   128-bit registers per node (about 170 MiB of int32 state on the card)
   through ``ChainSim.run`` with a 32-tick schedule and a 16-tick drain,
   with the launch counters zeroed just before and read just after, and
   checks drops == 0, inflight == 0, replies == offered, every
   acknowledged write read back from all 4 replicas, and one launch of
   each kernel per tick;
4. runs the same configuration at 4 ticks on CUDA and on the CPU (plain
   versions) and requires identical stores, metrics and reply logs;
5. times the ticks of the full-size run and where a tick's time goes;
6. runs NetChain through phases 3-4 at the same size.

Any failure raises (non-zero exit).  Without a card, or without the repo
beside it, the script exits non-zero before printing any result.  The
second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

try:
    from repro_torch.core import chain as t_chain  # noqa: E402
    from repro_torch.core import store as store_lib  # noqa: E402
    from repro_torch.core import txn as txn_lib  # noqa: E402
    from repro_torch.core.chain import ChainSim  # noqa: E402
    from repro_torch.core.metrics import ReplyLog  # noqa: E402
    from repro_torch.core.store import batch_rank  # noqa: E402
    from repro_torch.core.types import (  # noqa: E402
        OP_NOP, OP_WRITE_REPLY, ChainConfig, ClusterConfig, Msg, tree_map)
    from repro_torch.core.workload import (  # noqa: E402
        WorkloadConfig, make_schedule)
    from repro_torch.kernels.kv_engine import kernel as kv_kernel  # noqa: E402
    from repro_torch.kernels.kv_engine import ops as kv_ops  # noqa: E402
    from repro_torch.kernels.kv_engine import ref as kv_ref  # noqa: E402
except ImportError as exc:  # run outside a checkout of the repo
    sys.exit(f"chip_smoke: the repro_torch package is not beside this "
             f"script ({exc})")

# The configuration (PERF.md, "Cells").
N_CHAINS, N_NODES, NUM_KEYS, VERSIONS, WORDS = 8, 4, 65536, 4, 4
INJECT, ROUTE = 64, 256
WORKLOAD = dict(ticks=32, queries_per_tick=32, write_fraction=0.25,
                key_skew="uniform", seed=0)
EXTRA_TICKS = 16
REDUCED_TICKS, REDUCED_EXTRA = 4, 8
ITERS = 40                         # timed calls per kernel measurement
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
KERNEL_SRC = "src/repro_torch/kernels/kv_engine/csrc/kv_engine.cu"
REPLACES = {
    "kv_read": "src/repro/kernels/kv_engine/kernel.py:153",
    "kv_write": "src/repro/kernels/kv_engine/kernel.py:510",
}


def log(*args):
    print(*args, flush=True)


def require(cond, msg) -> None:
    """A check of the run that holds under ``python -O`` too."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cluster(protocol: str) -> ClusterConfig:
    return ClusterConfig(
        chain=ChainConfig(n_nodes=N_NODES, num_keys=NUM_KEYS,
                          num_versions=VERSIONS, value_words=WORDS,
                          protocol=protocol),
        n_chains=N_CHAINS)


def schedule(cl: ClusterConfig, ticks: int, device) -> Msg:
    """The workload's [T, C, n, 32] lanes padded with NOP lanes to the
    engine's inject capacity, so every tick has the [C, n, 64] injection
    shape of the drain ticks."""
    sched = make_schedule(cl, WorkloadConfig(**{**WORKLOAD, "ticks": ticks}),
                          device=device)
    T, C, n, q = sched.op.shape
    pad = Msg.empty((T, C, n, INJECT - q), WORDS, device=device)
    return Msg.concat([sched, pad], dim=3)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_calls(calls) -> float:
    """Mean ms per call of the zero-argument ``calls`` on the current
    stream, each between its own pair of CUDA events.  When the host
    enqueues slower than the card runs, this is host time."""
    pairs = []
    for fn in calls:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / len(calls)


def device_time(calls):
    """(mean device ms per call, {kernel name: device us}) of the
    zero-argument ``calls``, from torch.profiler's CUDA activity: the
    summed duration of every kernel, copy and fill they launched.
    (None, {}) if the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us
    total = sum(by_name.values())
    if total <= 0:
        return None, {}
    return total / 1e3 / len(calls), by_name


def launch_floor_ms() -> float:
    x = torch.zeros(1, device="cuda")
    time_calls([lambda: x.add_(1)] * 10)
    return time_calls([lambda: x.add_(1)] * 200)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def seeded_store(gen, N, B):
    """A store with dirty versions (pending 0..V-1), and a batch of keys
    with duplicates (the first 64 of each row in 16 keys) and keys
    outside [0, K)."""
    values = torch.randint(0, 1 << 20, (N, NUM_KEYS, VERSIONS, WORDS),
                           generator=gen, dtype=torch.int32)
    seqs = torch.randint(-1, 100, (N, NUM_KEYS, VERSIONS), generator=gen,
                         dtype=torch.int32)
    pending = torch.randint(0, VERSIONS, (N, NUM_KEYS), generator=gen,
                            dtype=torch.int32)
    keys = torch.randint(-4, NUM_KEYS + 4, (N, B), generator=gen,
                         dtype=torch.int32)
    keys[:, :64] = torch.randint(0, 16, (N, 64), generator=gen,
                                 dtype=torch.int32)
    return values, seqs, pending, keys


def max_abs_err(got, exp) -> int:
    return max(int((g.long() - e.long()).abs().max()) for g, e in
               zip(got, exp))


def read_bound_bytes(pending, keys) -> int:
    """Bytes the read must move for this batch: the keys, per distinct
    in-range (node, key) its pending word, cell 0 (W words + seq) and,
    when dirty, the latest cell; the five outputs written once."""
    N, B = keys.shape
    ok = (keys >= 0) & (keys < NUM_KEYS)
    rows = torch.arange(N, device=keys.device)[:, None].expand(N, B)
    flat = (rows * NUM_KEYS + keys.long())[ok].unique()
    dirty = int((pending.reshape(-1)[flat] > 0).sum())
    cell = 4 * (WORDS + 1)
    return (4 * N * B + flat.numel() * (4 + cell) + dirty * cell
            + 4 * N * B * (2 * WORDS + 3))


def write_bound_bytes(keys, active, accepted) -> int:
    """Bytes the append must move: the batch (keys, W words, seq, active,
    rank), per distinct active in-range (node, key) its pending word read
    and written, per accepted write one cell (W words + seq), and the
    accepted flags."""
    N, B = keys.shape
    live = (active > 0) & (keys >= 0) & (keys < NUM_KEYS)
    rows = torch.arange(N, device=keys.device)[:, None].expand(N, B)
    touched = (rows * NUM_KEYS + keys.long())[live].unique().numel()
    return (4 * N * B * (WORDS + 4) + 8 * touched
            + int(accepted.sum()) * 4 * (WORDS + 1) + 4 * N * B)


def check_kernels() -> dict:
    N, B = N_CHAINS * N_NODES, INJECT + ROUTE
    gen = torch.Generator(device="cpu").manual_seed(11)
    values, seqs, pending, keys = (x.cuda() for x in seeded_store(gen, N, B))
    out = {}

    # -- read --------------------------------------------------------------
    got = kv_kernel.cluster_read_engine(values, seqs, pending, keys)
    exp = kv_ref.cluster_read_engine_ref(values, seqs, pending, keys)
    torch.cuda.synchronize()
    err = max_abs_err(got, exp)
    require(err == 0, f"kv_read differs from its plain version by {err}")
    rows = torch.arange(N, device="cuda")[:, None]
    keys_in = keys.clamp(0, NUM_KEYS - 1)
    out["kv_read"] = dict(
        max_abs_err=err,
        calls=lambda n: [lambda: kv_kernel.cluster_read_engine(
            values, seqs, pending, keys)] * n,
        plain=lambda n: [lambda: kv_ref.cluster_read_engine_ref(
            values, seqs, pending, keys)] * n,
        # one advanced-index gather of each query's whole register row
        library=lambda n: [lambda: values[rows, keys_in]] * n,
        bound_bytes=read_bound_bytes(pending, keys),
    )

    # -- write: slots from pending before the launch, window overflow --------
    pending.clamp_(max=1)
    wvals = torch.randint(0, 1 << 20, (N, B, WORDS), generator=gen,
                          dtype=torch.int32).cuda()
    wseqs = torch.randint(0, 1 << 16, (N, B), generator=gen,
                          dtype=torch.int32).cuda()
    active = torch.randint(0, 2, (N, B), generator=gen,
                           dtype=torch.int32).cuda()
    rank = batch_rank(keys, active.bool())
    snap = [x.clone() for x in (values, seqs, pending)]
    got = kv_kernel.cluster_write_engine(values, seqs, pending, keys, wvals,
                                         wseqs, active, rank)
    plain = [x.clone() for x in snap]
    exp = kv_ref.cluster_write_engine_ref(*plain, keys, wvals, wseqs, active,
                                          rank)
    torch.cuda.synchronize()
    err = max_abs_err(got, exp)
    require(err == 0, f"kv_write differs from its plain version by {err}")
    accepted = got[3]
    live = (active > 0) & (keys >= 0) & (keys < NUM_KEYS)
    require(0 < int(accepted.sum()) < int(live.sum()),
            "the write check must both accept and overflow")
    # every timed append starts from its own copy of the same pending
    # snapshot, so each one does the work of the checked one
    def appends(fn):
        return lambda n: [
            lambda p=snap[2].clone(): fn(values, seqs, p, keys, wvals,
                                         wseqs, active, rank)
            for _ in range(n)]

    out["kv_write"] = dict(
        max_abs_err=err,
        calls=appends(kv_kernel.cluster_write_engine),
        plain=appends(kv_ref.cluster_write_engine_ref),
        library=None,   # no single PyTorch call ranks and appends
        bound_bytes=write_bound_bytes(keys, active, accepted),
    )
    for rec in out.values():
        rec["bound_ms"] = rec.pop("bound_bytes") / HBM_BYTES_PER_S * 1e3
        rec["bound_by"] = "bytes"
        for key in ("", "plain_", "library_"):
            make = rec.pop(key.rstrip("_") or "calls")
            if make is None:
                rec[f"{key}ms"] = rec[f"{key}call_ms"] = None
                continue
            time_calls(make(3))                       # warm-up
            dev_ms, kernels = device_time(make(ITERS))
            rec[f"{key}call_ms"] = time_calls(make(ITERS))
            rec[f"{key}device_measured"] = dev_ms is not None
            rec[f"{key}ms"] = dev_ms if dev_ms is not None else \
                rec[f"{key}call_ms"]
            if key == "":
                rec["device_kernels_us"] = {
                    k: v / ITERS for k, v in kernels.items()}
    return out


# ---------------------------------------------------------------------------
# phases 3-4: the cluster run and its checks
# ---------------------------------------------------------------------------
def check_readback(state, protocol: str) -> int:
    """Every acknowledged write reads back: for each (chain, key) the
    newest acknowledged write's seq and value sit in cell 0 of all live
    replicas, with no dirty version left."""
    log_ = state.replies
    n_checked = 0
    for c in range(N_CHAINS):
        cur = int(log_.cursor[c])
        op = log_.op[c, :cur]
        w = op == OP_WRITE_REPLY
        keys, seqs, val0 = (x[c, :cur][w] for x in
                            (log_.key, log_.seq, log_.value0))
        if keys.numel() == 0:
            continue
        # newest acknowledged write per key: max seq (seqs rise per key)
        order = torch.argsort(keys.long() * (1 << 32) + seqs.long())
        keys, seqs, val0 = keys[order], seqs[order], val0[order]
        last = torch.ones_like(keys, dtype=torch.bool)
        last[:-1] = keys[1:] != keys[:-1]
        keys, seqs, val0 = keys[last].long(), seqs[last], val0[last]
        st = state.stores
        require(torch.equal(st.seqs[c][:, keys, 0],
                            seqs[None].expand(N_NODES, -1)),
                f"{protocol}: chain {c} replicas disagree with acknowledged "
                "seqs")
        require(torch.equal(st.values[c][:, keys, 0, 0],
                            val0[None].expand(N_NODES, -1)),
                f"{protocol}: chain {c} replicas lost an acknowledged value")
        require(int(st.pending[c][:, keys].abs().sum()) == 0,
                f"{protocol}: chain {c} left dirty versions on written keys")
        n_checked += keys.numel()
    return n_checked


def main_path(protocol: str, device="cuda") -> dict:
    cl = cluster(protocol)
    sim = ChainSim(cl, inject_capacity=INJECT, route_capacity=ROUTE,
                   device=device)
    sched = schedule(cl, WORKLOAD["ticks"], device)
    state = sim.init_state()
    offered = int((sched.op != OP_NOP).sum())
    torch.cuda.synchronize()
    kv_kernel.reset_launches()
    t0 = time.perf_counter()
    state = sim.run(state, sched, extra_ticks=EXTRA_TICKS,
                    assert_drained=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kv_kernel.LAUNCHES)
    m = state.metrics.asdict()
    ticks = WORKLOAD["ticks"] + EXTRA_TICKS
    require(m["drops"] == 0, f"{protocol}: {m['drops']} drops")
    require(sim.inflight(state) == 0, f"{protocol}: ops left in flight")
    require(m["replies"] == offered,
            f"{protocol}: {m['replies']} replies for {offered} offered ops")
    n_keys = check_readback(state, protocol)
    require(n_keys > 0, f"{protocol}: no acknowledged write to read back")
    want_write = ticks if protocol == "netcraq" else 0
    require(launches == {"kv_read": ticks, "kv_write": want_write},
            f"{protocol}: launches {launches} over {ticks} ticks")
    log(f"{protocol}: main path {ticks} ticks in {wall * 1e3:.3f} ms "
        f"(first run, includes warm-up), offered={offered} "
        f"replies={m['replies']} drops={m['drops']} "
        f"dirty_appends={m['dirty_appends']} packets={m['packets']} "
        f"acknowledged keys read back from {N_NODES} replicas: {n_keys}, "
        f"launches {launches}")
    return {"sim": sim, "launches": launches, "metrics": m}


def cpu_equality(protocol: str) -> None:
    """The same schedule at reduced depth on CUDA (kernels) and on the
    CPU (plain versions): identical stores, metrics and reply logs."""
    cl = cluster(protocol)
    out = {}
    for dev in ("cuda", "cpu"):
        sim = ChainSim(cl, inject_capacity=INJECT, route_capacity=ROUTE,
                       device=dev)
        sched = schedule(cl, REDUCED_TICKS, dev)
        t0 = time.perf_counter()
        out[dev] = sim.run(sim.init_state(), sched, extra_ticks=REDUCED_EXTRA)
        if dev == "cuda":
            torch.cuda.synchronize()
        log(f"{protocol}: reduced run ({REDUCED_TICKS}+{REDUCED_EXTRA} "
            f"ticks) on {dev} in {time.perf_counter() - t0:.3f} s")
    for name in ("stores", "metrics", "replies", "locks", "inbox"):
        for f, a, b in zip(getattr(out["cpu"], name)._fields,
                           getattr(out["cpu"], name),
                           getattr(out["cuda"], name)):
            require(torch.equal(a, b.cpu()),
                    f"{protocol}: CUDA and CPU runs differ in {name}.{f}")
    log(f"{protocol}: CUDA run == CPU plain run (stores, metrics, replies, "
        "locks, inbox)")


# ---------------------------------------------------------------------------
# phase 5: tick time and where it goes
# ---------------------------------------------------------------------------
STAGES = [
    ("commit", store_lib, "commit"),
    ("assign_seqs", store_lib, "assign_seqs"),
    ("overwrite_clean", store_lib, "overwrite_clean"),
    ("kv_read (ops)", kv_ops, "cluster_read_batch"),
    ("kv_write (ops, incl. rank)", kv_ops, "cluster_write_batch"),
    ("head_txn_stage", txn_lib, "head_txn_stage"),
    ("stale_route_admission", t_chain, "stale_route_admission"),
    ("segmented_route", t_chain, "segmented_route"),
    ("reply_log.append", ReplyLog, "append"),
]


def tick_times(protocol: str, sim: ChainSim) -> dict:
    """µs/tick over the schedule's ticks after a warm-up, then the same
    ticks with CUDA events around each stage (stream time between the
    stage's first and last enqueue, summed over the ticks)."""
    cl = sim.cluster
    sched = schedule(cl, WORKLOAD["ticks"], "cuda")
    ticks = [tree_map(lambda x, i=i: x[i], sched)
             for i in range(sched.op.shape[0])]
    state = sim.run(sim.init_state(), sched, extra_ticks=0)   # warm-up
    state = sim.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for inj in ticks:
        state = sim.tick(state, inj)
    torch.cuda.synchronize()
    us_tick = (time.perf_counter() - t0) / len(ticks) * 1e6

    events: dict[str, list] = {}
    originals = []
    for name, owner, attr in STAGES:
        fn = getattr(owner, attr)
        originals.append((owner, attr, fn))

        def timed(*a, _fn=fn, _name=name, **k):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            r = _fn(*a, **k)
            e.record()
            events.setdefault(_name, []).append((s, e))
            return r
        setattr(owner, attr, timed)
    try:
        state = sim.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for inj in ticks:
            state = sim.tick(state, inj)
        torch.cuda.synchronize()
        us_tick_traced = (time.perf_counter() - t0) / len(ticks) * 1e6
    finally:
        for owner, attr, fn in originals:
            setattr(owner, attr, fn)
    stages = {name: sum(s.elapsed_time(e) for s, e in ev) * 1e3 / len(ticks)
              for name, ev in events.items()}

    # device activity over the same ticks: busy time and its top kernels
    states = [sim.init_state()]

    def one_tick(inj):
        states[0] = sim.tick(states[0], inj)

    t0 = time.perf_counter()
    dev_ms, kernels = device_time([lambda inj=inj: one_tick(inj)
                                   for inj in ticks])
    wall_us = (time.perf_counter() - t0) / len(ticks) * 1e6
    busy_us = None if dev_ms is None else dev_ms * 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log(f"{protocol}: {us_tick:.1f} us/tick over {len(ticks)} ticks "
        f"(C={N_CHAINS} n={N_NODES} K={NUM_KEYS}); with stage events "
        f"{us_tick_traced:.1f} us/tick; per-tick stage time (us, stream "
        "time between a stage's first and last enqueue): "
        + ", ".join(f"{k}={v:.1f}" for k, v in sorted(
            stages.items(), key=lambda kv: -kv[1])))
    if busy_us is None:
        log(f"{protocol}: profiler saw no device activity: device busy "
            "share not measured")
    else:
        log(f"{protocol}: under the profiler {wall_us:.1f} us/tick wall, "
            f"device busy {busy_us:.1f} us/tick "
            f"(idle share {1 - busy_us / wall_us:.4f}); top device time "
            "per tick (us): " + "; ".join(
                f"{k[:60]}={v / len(ticks):.1f}" for k, v in top))
    return {"us_per_tick": us_tick, "stages_us": stages,
            "device_busy_us_per_tick": busy_us,
            "profiled_wall_us_per_tick": wall_us,
            "kv_device_us_per_tick": {
                k: v / len(ticks) for k, v in kernels.items()
                if any(n in k for n in ("kv_read_kernel", "kv_snapshot_kernel",
                                        "kv_write_kernel"))}}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device - this script measures the "
                 "port on a GPU and has no CPU mode")
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    kv_kernel.build()
    log(f"built {KERNEL_SRC} for sm_90a in {time.perf_counter() - t0:.1f} s")
    log(smi())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    kernels = check_kernels()
    floor = launch_floor_ms()
    us = lambda ms: "n/a" if ms is None else f"{ms * 1e3:.2f} us"
    for name, rec in kernels.items():
        log(f"{name}: equals its plain version; device time per call "
            f"{us(rec['ms'])} (plain {us(rec['plain_ms'])}, library "
            f"{us(rec['library_ms'])}); event-timed call {us(rec['call_ms'])}"
            f" (plain {us(rec['plain_call_ms'])}, library "
            f"{us(rec['library_call_ms'])}); bound {us(rec['bound_ms'])} "
            f"by bytes; one-element add_ {us(floor)}; device kernels "
            f"{rec.get('device_kernels_us')}")

    craq_run = main_path("netcraq")
    cpu_equality("netcraq")
    craq_times = tick_times("netcraq", craq_run["sim"])
    chain_run = main_path("netchain")
    cpu_equality("netchain")
    chain_times = tick_times("netchain", chain_run["sim"])

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SRC,
         "replaces": REPLACES[name],
         "launches": craq_run["launches"][name],
         "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
         "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
         "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
        for name, rec in kernels.items()]}
    log(json.dumps({
        "netcraq": craq_times, "netchain": chain_times,
        "netchain_launches": chain_run["launches"],
        "kernel_detail": kernels, "add_one_ms": floor,
        "seconds": time.perf_counter() - t_start,
    }))
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
