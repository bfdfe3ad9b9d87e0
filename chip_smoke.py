#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card, at full size.

    python3 chip_smoke.py [--phases 12,13]

Builds the hand-written kernels from ``src/repro_torch/kernels/kv_engine/
csrc``, ``src/repro_torch/kernels/flash_attention/csrc`` and
``src/repro_torch/kernels/ssd_scan/csrc`` with nvcc (sm_90a, one nvcc per
source, all three at once), then:

1. prints the card's name and power limit (nvidia-smi);
2. holds each kernel against its plain PyTorch version on the card, at
   the shapes its path gives it, and times kernel, plain version and
   library yardstick beside the kernel's bound: the per-node kernels on
   a [32, 65536, 4, 4] store and a [32, 320] batch with dirty versions,
   duplicate keys, window overflow and out-of-range keys, each in its
   ops mode (the node step's read with its decision, the append with
   its rank; the main path's mode, one device activity per call of
   ``kv_ops``) and its engine mode (the Pallas kernels' contract), with
   an empty kernel of the same grid timed beside them; the bucketed
   kernels on the tail replica of a seeded [8, 4, 65536, 4, 4] store and
   458,752 global keys under a map with two migrated buckets, each in its
   ops mode (``partitioned_read_batch``/``partitioned_write_batch`` in
   one launch: raw global keys with duplicates, window overflow and 1 %
   outside the key space, the map lookup, decision and rank inside) and
   its engine mode (the keys resolved, 1 % parked on chain -1 and 1 % with
   a slot outside [0, K)), each bound by bytes and, beside that, by the
   32-byte sectors the card must move;
3. drives the main path: an 8-chain x 4-node NetCRAQ cluster of 65,536
   128-bit registers per node (about 170 MiB of int32 state on the card)
   through ``ChainSim.run`` with a 32-tick schedule and a 16-tick drain,
   with the launch counters zeroed just before and read just after, and
   checks drops == 0, inflight == 0, replies == offered, every
   acknowledged write read back from all 4 replicas, and one launch of
   each kernel per tick;
4. runs the same configuration at 4 ticks, and the live rebalance of
   phase 7 at 12 ticks, on CUDA and on the CPU (plain versions) and
   requires identical stores, metrics, reply logs and global-key
   read-backs;
5. times the ticks of the full-size run and where a tick's time goes,
   with the device activities per tick and the two kv stages;
6. runs NetChain through phases 3-4 at the same size;
7. live rebalance (``benchmarks/fig_rebalance.py``'s run at full width):
   a zipf tenant hot-spots chain 0, the control plane moves its two
   hottest buckets to chains 1 and 2 (freeze, drain, copy, publish, one
   stale-client tick each), and the run is held to an undisturbed twin
   (chains 3-7 bit-identical), to its freeze windows (write NACKs only
   there), to ``committed_view`` and to a serial replay of every
   acknowledged write, read back for every global key through
   ``partitioned_read_batch`` on the tail replica in one launch; then the
   read-back's device activities, device time and wall time per call;
8. global-key writes through ``partitioned_write_batch`` on a copy of
   that tail under the migrated map: duplicates serialize, keys outside
   the key space are dropped and read back as decision -1, one launch of
   each kernel; then both entry points' device activities, device time
   and wall time per call at that batch;
9. failover and two-phase recovery (``benchmarks/fig_failover.py``'s
   lifecycle at full width): a node dies, clients redirect after the
   detector's timeout, the chain freezes, the replacement copies its
   CRAQ source and is spliced back in; held to the freeze window, the
   copy source, an undisturbed twin, the read-back of every
   acknowledged write and 95 % of the twin's throughput after recovery;
10. the flash_attention kernel's two routes against their plain version,
   timed as in phase 2 and bound by operations: the tensor-core route
   (bf16) at one layer's prefill of phase 11 (q [8, 16, 2048, 128], k/v
   [8, 2, 2048, 128], causal), a ragged tile edge (S = SK = 200) and
   S > SK, the f32 route at float32 (same GQA group) and S < SK; the
   SDPA yardstick is timed beside each route, and the f32 kernel on the
   bf16 serving shape (the design the tensor-core route replaced);
11. the serving path at full width (``examples/kv_serving.py``'s run):
   the coordination store keeps model version and serving epoch, and
   ``ServingEngine`` serves Qwen2.5-3B (36 layers, random weights from a
   seed) 16 requests of 2048-token prompts, 32 new tokens each, in 2
   waves of 8 through the kernel; held to the outputs, 72 kernel
   launches all on the tensor-core route and no plain-version call,
   determinism, a manual greedy loop, the version bump, the naive
   attention path's prefill logits and, at 2 layers, the CPU's plain
   versions; prints per wave prefill ms, decode ms per token, tokens/s,
   p50/p99 latency and a decode step's device-busy share; then the f32
   route's own path, Qwen2.5-3B in float32 compute at full width and 2
   layers, its launches all on the f32 route, held to the CPU's logits
   and tokens;
12. the ssd_scan kernel pair (``ssd_cb_kernel``: C B^T per batch and
   chunk; ``ssd_scan_kernel``: the scan in 3xTF32 on the tensor cores)
   against its plain version (``ssd_chunked``), y and the final state,
   one launch of each per call, timed as in phase 2 beside its bound:
   one layer's prefill of phase 13 (x [8, 2000, 64, 64] bf16 as the
   model's strided view, dt [8, 2000, 64], B/C [8, 2000, 128] shared by
   the heads, chunk 64 with a ragged last chunk), float32 x, L = 2048,
   L = 40 < chunk, chunks 16 and 32; no library call computes the scan;
   prints the per-call time, each kernel's share of it, and the bounds
   by bytes and by operations at the bf16 and the 3xTF32 rates; then
   ``chunk_cb`` (the first kernel alone) against ``ref.chunk_cb`` and a
   batched ``torch.matmul``;
13. the same serving run as phase 11 on Mamba2-1.3B (48 layers, random
   weights from a seed; 16 requests of 2000-token prompts, 32 new tokens
   each, 2 waves of 8) with every SSD core of prefill on the kernels;
   held to 96 launches of each kernel of the pair and no plain-version
   call, determinism, a manual greedy loop, the version bump, the plain
   path's (``impl="chunked"``) prefill logits and ``lm_forward`` scoring
   of 2 x 2000 tokens (48 launches of each) at full depth and, at 2
   layers, the CPU's plain versions; prints the same serving metrics and
   the peak device memory;
14. cross-chain transactions (``benchmarks/fig_txn_pipeline.py``'s
   proportions) on phase 7's cluster: two mixes of 4,096
   transactions (2 keys uniform, 4 keys zipf) through ``TxnWaveDriver``
   into the in-network wave coordinator (16 slots of 4 keys per chain),
   96 through the host ``TxnDriver`` in waves of 6; each run held, after
   a drain, to free locks and wave slots, no drop or write NACK, one
   result per transaction, an acyclic serial order, and every global key
   equal to the serial replay of the committed subset in
   ``committed_view`` and in a one-launch ``partitioned_read_batch``
   read-back; one launch of each kv kernel per tick and no plain-version
   call; the first 256 on CUDA and on the CPU (plain versions) with
   identical results and state; prints commits, aborts, ticks, commits
   per tick, admission rounds per commit, wall µs per wave tick, and the
   device activities of a wave tick, of the wave-less tick and of the
   coordinator stage;
15. open-loop load (``benchmarks/fig_hockey.py``'s sweep at phase 7's
   cluster with the default telemetry plane): ``ChainSim.run_openloop``
   draws each tick's arrivals on the card (threefry, 4,096 candidate
   lanes, twice the 2,048-op lane capacity; a backlog of 8,192) for
   ``uniform_write`` and ``zipf_txn`` at 1/8 to 3/2 of capacity, 64
   ticks and a 32-tick drain a point, each held to exact conservation
   (offered = replies + shed + deferred + writes the version window
   refused), no drop, an empty fabric, free locks (a 16-tick lease) and
   the histogram's percentile buckets equal to the reply log's while the
   log holds every reply; the write class's p50 rises up to the knee and
   some point sheds; one kv_read and one kv_write launch per tick and no
   plain call; then a headline run of >= 1,000,000 client ops whose log
   overflows (percentiles from the histogram alone) and a one-launch
   read-back of every global key; 8 ticks of ``zipf_txn`` at 3/2 of
   capacity on CUDA and on the CPU with identical state, telemetry and
   backlog; prints offered, delivered and shed per tick and p50/p99/p999
   per class at every point, wall µs per tick, an open-loop tick's device
   activities and busy share, phase 5's tick with the telemetry plane on
   beside off, the host syncs of an open-loop window (none in
   ``gen_tick``), and how many of 4 calls' records a short profiler
   window keeps at the end of the run;
16. the declarative chaos suite (``benchmarks/fig_chaos.py``'s
   proportions at phase 7's cluster): ``run_scenario`` drives open-loop
   segments of the txn_mix mix under zipf at 3/32 of lane capacity (192
   ops a tick, 4,096 candidate lanes, a backlog of 8,192, abandonment
   0.10, a 16-tick lease) through ``none``, a ``failure_storm`` of node 1
   on all 8 chains, a ``migration_wave`` and ``stale_clients``; each is
   held to stores == the serial reference, 0 leaked locks, converged
   live replicas and an empty fabric, and every global key is read back
   through one ``partitioned_read_batch`` launch and held to the oracle;
   the moves must meet the stale-route gate; the storm, whose failures
   strand dirty versions as the reference's do, is held to every check
   but the drain of those versions and to where they may lie
   (``stranded_versions``); its delivered rate before, during and after;
   then the lease arm (LEASE_OFF leaks more at 128 ticks than at 64,
   none reclaimed; a 16-tick lease drains to 0); one kv_read and one
   kv_write launch a tick, no plain call, no host sync in a segment; and
   a four-kind scenario on 2 x 4 x 1,024 registers on CUDA and on the
   CPU with identical state, report and backlog;
17. ``ChainDist`` and the kv_cache protocols on torch.distributed, one
   chain node per rank, every rank on this card over gloo (the exchanges
   staged through host memory; with several cards rank ``r`` takes card
   ``r % count``), at phase 3's node size (65,536 registers
   of 4 words and 4 versions a rank, 256 inbox lanes): (a) one NetCRAQ
   chain of 4 ranks, 32 ticks of client traffic (32 ops a node a tick,
   a quarter writes sent to the head, uniform keys) and a 16-tick
   drain, held to replies == offered, an empty fabric, no dirty
   version, every acknowledged write read back on all 4 replicas, and
   one ``kv_read`` and one ``kv_write`` launch a rank a step with no
   plain call; wall µs a step (median, p99, slowest rank) and a replayed
   split between the node step, the exchanges, the replicated lock
   stage, the packing and the compactions; with a card for each of the
   4 ranks, (a) and (d) again over NCCL, one rank a card, with the same
   checks; (b) two chains of 4
   ranks with the telemetry plane, node 1 of chain 1 failed through the
   control plane's role table and PREPARE/COMMIT traffic at chain 0's
   head: the same checks per chain, only its own ops answered, nothing
   stored on the dead rank, free locks, every transaction granted and
   committed, each rank's histogram == its replies; (c) (b)'s first 8
   steps on the CPU ranks (plain versions) == the CUDA ranks', every
   output; (d) the kv_cache protocols at
   ``benchmarks/replication_dryrun.py``'s shapes (Qwen2.5-3B's cache at
   batch 32, bf16) over 4 ranks, held to the reference test's relations,
   with ms a step and the bytes a rank sends a step.

``--phases 12,13`` runs the build of the kernels those phases use,
phase 1 and the named phases only (4 and 5 bring 3 along, 8 brings 7;
15, 16 and 17 stand alone);
the JSON record then lists the kernels of the phases that ran.  The
script measures the ``repro_torch`` under ``src/`` beside it: a copy of
it placed in another checkout (a parent commit's, unpacked with ``git
archive``) measures that checkout's package with these phases.

Any failure raises (non-zero exit).  Without a card, or without the repo
beside it, the script exits non-zero before printing any result.  The
second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent

sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

try:
    from repro_torch.configs.base import get_config  # noqa: E402
    from repro_torch.core import chain as t_chain  # noqa: E402
    from repro_torch.core import collectives  # noqa: E402
    from repro_torch.core import chaos as chaos_lib  # noqa: E402
    from repro_torch.core import prng  # noqa: E402
    from repro_torch.core import store as store_lib  # noqa: E402
    from repro_torch.core import txn as txn_lib  # noqa: E402
    from repro_torch.core.txn import (  # noqa: E402
        TxnDriver, TxnWaveDriver, reference_execute, serial_order)
    from repro_torch.core.chain import ChainDist, ChainSim  # noqa: E402
    from repro_torch.core.coordinator import Coordinator  # noqa: E402
    from repro_torch.core import loadgen as loadgen_lib  # noqa: E402
    from repro_torch.core.failure import (  # noqa: E402
        FailureDetector, HedgedReadPolicy)
    from repro_torch.core.metrics import ReplyLog  # noqa: E402
    from repro_torch.core.store import Store, batch_rank, init_store  # noqa: E402
    from repro_torch.core.types import (  # noqa: E402
        CLIENT_BASE, LEASE_OFF, NOWHERE, OP_COMMIT, OP_NOP, OP_PREPARE,
        OP_PREPARE_ACK, OP_READ, OP_TXN_REPLY, OP_WRITE, OP_WRITE_REPLY,
        ChainConfig, ClusterConfig, Msg, PartitionMap, Roles,
        is_txn_op, reply_op_class, tree_map, value_from_int)
    from repro_torch.core.workload import (  # noqa: E402
        TxnWorkloadConfig, WorkloadConfig, _sample_keys, make_schedule,
        make_txn_workload, route_stream)
    from repro_torch.kernels.kv_engine import kernel as kv_kernel  # noqa: E402
    from repro_torch.kernels.kv_engine import ops as kv_ops  # noqa: E402
    from repro_torch.kernels.kv_engine import ref as kv_ref  # noqa: E402
    from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
    from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
    from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
    from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
    from repro_torch.models import api  # noqa: E402
    from repro_torch.obs import tail_percentiles  # noqa: E402
    from repro_torch.models import transformer as TF  # noqa: E402
    from repro_torch.models.transformer import OptFlags  # noqa: E402
    from repro_torch.serve import kv_cache as KV  # noqa: E402
    from repro_torch.serve.engine import (  # noqa: E402
        Request, ServingEngine, build_decode_step)
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
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12             # H100 SXM f32 peak outside tensor cores
TF32_FLOP_PER_S = 495e12           # H100 SXM dense TF32 tensor-core peak
KV_SRC = "src/repro_torch/kernels/kv_engine/csrc/kv_engine.cu"
FA_SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SSD_SRC = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SOURCES = {"kv_read": KV_SRC, "kv_write": KV_SRC,
           "kv_bucketed_read": KV_SRC, "kv_bucketed_write": KV_SRC,
           "flash_attention": FA_SRC, "flash_attention_f32": FA_SRC,
           "ssd_cb": SSD_SRC, "ssd_scan": SSD_SRC}
REPLACES = {
    "kv_read": "src/repro/kernels/kv_engine/kernel.py:153",
    "kv_write": "src/repro/kernels/kv_engine/kernel.py:510",
    "kv_bucketed_read": "src/repro/kernels/kv_engine/kernel.py:249",
    "kv_bucketed_write": "src/repro/kernels/kv_engine/kernel.py:339",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:96",
    "flash_attention_f32": "src/repro/kernels/flash_attention/kernel.py:96",
    "ssd_cb": "src/repro/kernels/ssd_scan/kernel.py:94",
    "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:94",
}
# The partition map of phases 2 and 7-8, in fig_rebalance's proportions:
# 14 buckets of 4096 registers per chain and two bucket-sized landing
# regions in each chain's spare tail (458,752 global keys).
BUCKETS_PER_CHAIN, SPARE_KEYS = 14, 8192
# phase 7: fig_rebalance's stream, lanes and migration schedule;
# per_tick = 0.75 * C * n * q saturates the hot chain's lanes
REBALANCE = dict(ticks=44, q=4, hot_fraction=0.85, zipf_a=0.5,
                 write_fraction=0.1, seed=0)
FREEZE_AFTER, PUBLISH_AFTER = (12, 20), (18, 26)
REDUCED_REBALANCE = dict(ticks=12, freeze=(2,), publish=(8,), drain=6)
# phase 9: fig_failover's lifecycle
FAILOVER = dict(ticks=48, q=8, fail_tick=12, freeze_tick=28,
                recover_tick=32, chain=0, node=1, timeout_ticks=3,
                write_fraction=0.1, seed=0)
# phases 10-11: examples/kv_serving.py's serving run at Qwen2.5-3B's full
# width and depth: 16 requests of 2048-token prompts, 32 new tokens each,
# in 2 waves of 8 slots; the weights are random from SERVE_SEED
SERVE_ARCH, SLOTS, CACHE_LEN = "qwen2.5-3b", 8, 2080
N_REQUESTS, PROMPT_LEN, MAX_NEW, SERVE_SEED = 16, 2048, 32, 0
MODEL_VERSION_KEY, SERVING_EPOCH_KEY = 10, 11
# phases 12-13: the same run at Mamba2-1.3B's full width and depth, on
# 2000-token prompts (not a multiple of the SSD chunk of 64, so every
# sequence ends in a ragged chunk, as real prompts do)
SSM_ARCH, SSM_PROMPT_LEN = "mamba2-1.3b", 2000
# each serving path at full width and 2 layers, CUDA (kernel) against the
# CPU (plain versions)
REDUCED_SERVE = dict(n_layers=2, requests=2, prompt_len=256, steps=4)
FA_ITERS = 10                      # timed calls per attention measurement
# phase 14: cross-chain transactions at phase 7's cluster, in
# benchmarks/fig_txn_pipeline.py's proportions (every transaction spans
# chains, every key written, zipf_a 1.2), two mixes of 4,096, each on a
# fresh engine with 16 coordinator slots of 4 participants per chain and
# 2-tick drains between admission rounds; 96 of k2_uniform through the
# host driver in waves of 6 on the same cluster without a wave table, as
# fig_txn_pipeline runs it; the first 256 of k2_uniform on CUDA and on
# the CPU.  Each chain's completion log holds 1,024 rows: one mix puts
# about 512 (binomial, sd 21) on each chain's log.  The cluster keeps
# phase 7's 4 versions: a committed write the version window cannot hold
# would come back to its coordinator as a write NACK (a negative write
# seq in its result) and leave the store short of the serial replay, and
# both are checked; fig_txn_pipeline runs 8 versions on 64 registers.
TXN_MIXES = {"k2_uniform": dict(keys_per_txn=2, key_skew="uniform", seed=0),
             "k4_zipf": dict(keys_per_txn=4, key_skew="zipf", seed=1)}
TXN_COMMON = dict(n_txns=4096, cross_chain_fraction=1.0, write_fraction=1.0,
                  zipf_a=1.2)
WAVE_DEPTH, WAVE_KEYS, WAVE_LOG, STEP_TICKS = 16, 4, 1024, 2
TXN_REPLY_CAPACITY = 16384
HOST_TXNS, HOST_WAVE, CPU_TXNS, PROFILED_TICKS = 96, 6, 256, 4
KV_PLAIN = ("cluster_read_decide_ref", "cluster_read_engine_ref",
            "cluster_write_append_ref", "cluster_write_engine_ref",
            "partitioned_read_ref", "partitioned_write_ref",
            "bucketed_read_engine_ref", "bucketed_write_engine_ref")


def log(*args):
    print(*args, flush=True)


def require(cond, msg) -> None:
    """A check of the run that holds under ``python -O`` too."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cluster(protocol: str, partitioned: bool = False) -> ClusterConfig:
    """The phases' cluster; ``partitioned`` gives it the bucketed map."""
    extra = (dict(buckets_per_chain=BUCKETS_PER_CHAIN, spare_keys=SPARE_KEYS)
             if partitioned else {})
    return ClusterConfig(
        chain=ChainConfig(n_nodes=N_NODES, num_keys=NUM_KEYS,
                          num_versions=VERSIONS, value_words=WORDS,
                          protocol=protocol),
        n_chains=N_CHAINS, **extra)


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


def device_time(calls, counts: dict | None = None):
    """(mean device ms per call, {kernel name: device us}, number of
    device activities) of the zero-argument ``calls``, from
    torch.profiler's CUDA activity: the summed duration of every kernel,
    copy and fill they launched; ``counts``, where given, gets the
    number of activities by name.  (None, {}, 0) if the profiler saw no
    device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    count = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us
            count += 1
            if counts is not None:
                counts[e.name] = counts.get(e.name, 0) + 1
    total = sum(by_name.values())
    if total <= 0:
        return None, {}, 0
    return total / 1e3 / len(calls), by_name, count


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
    """Bytes the engine-mode read must move for this batch: the keys, per
    distinct in-range (node, key) its pending word, cell 0 (W words +
    seq) and, when dirty, the latest cell; the five outputs written
    once."""
    N, B = keys.shape
    ok = (keys >= 0) & (keys < NUM_KEYS)
    rows = torch.arange(N, device=keys.device)[:, None].expand(N, B)
    flat = (rows * NUM_KEYS + keys.long())[ok].unique()
    dirty = int((pending.reshape(-1)[flat] > 0).sum())
    cell = 4 * (WORDS + 1)
    return (4 * N * B + flat.numel() * (4 + cell) + dirty * cell
            + 4 * N * B * (2 * WORDS + 3))


def decide_bound_bytes(keys) -> int:
    """Bytes the ops-mode read must move: the keys and the nodes' tail
    flags, per distinct (node, register the key resolves to) its pending
    word and the one cell (W words + seq) its reply takes, and the reply
    and decision written once."""
    N, B = keys.shape
    rows = torch.arange(N, device=keys.device)[:, None].expand(N, B)
    reg = store_lib.gather_index(keys, NUM_KEYS).long()
    regs = (rows * NUM_KEYS + reg).unique().numel()
    return (4 * N * B + N + regs * 4 * (WORDS + 2)
            + 4 * N * B * (WORDS + 2))


def write_bound_bytes(keys, active, accepted) -> int:
    """Bytes the engine-mode append must move: the batch (keys, W words,
    seq, active, rank), per distinct active in-range (node, key) its
    pending word read and written, per accepted write one cell (W words
    + seq), and the accepted flags."""
    N, B = keys.shape
    live = (active > 0) & (keys >= 0) & (keys < NUM_KEYS)
    rows = torch.arange(N, device=keys.device)[:, None].expand(N, B)
    touched = (rows * NUM_KEYS + keys.long())[live].unique().numel()
    return (4 * N * B * (WORDS + 4) + 8 * touched
            + int(accepted.sum()) * 4 * (WORDS + 1) + 4 * N * B)


def append_bound_bytes(keys, active, accepted) -> int:
    """Bytes the ops-mode append must move (it reads no rank): every
    lane's key and active byte, per distinct active (node, register its
    key clamps to) the pending word, per write that lands its W words
    and seq read and its cell written, per distinct register written to
    its pending word, and the accepted bytes."""
    N, B = keys.shape
    rows = torch.arange(N, device=keys.device)[:, None].expand(N, B)
    wrapped = torch.where(keys < 0, keys + NUM_KEYS, keys).long()
    lands = accepted & (wrapped >= 0) & (wrapped < NUM_KEYS)
    read = (rows * NUM_KEYS + wrapped.clamp(0, NUM_KEYS - 1))[active]
    written = (rows * NUM_KEYS + wrapped)[lands]
    return (5 * N * B + 4 * read.unique().numel()
            + 8 * (WORDS + 1) * int(lands.sum())
            + 4 * written.unique().numel() + N * B)


def one_launch_per_call(name: str, kernel: str, fn) -> None:
    """The main path's entry ``fn`` dispatches one device activity per
    call, its kernel's (where the profiler sees the card)."""
    counts: dict[str, int] = {}
    calls = 4
    _, _, n = device_time([fn] * calls, counts=counts)
    if n == 0:
        log(f"{name}: profiler saw no device activity: launches per call "
            "not measured")
        return
    # the profiler may drop one record of a window, never add one
    require(calls - 1 <= n <= calls and all(kernel in k for k in counts),
            f"{name}: {n} device activities for {calls} calls: {counts}")
    log(f"{name}: one device activity per call ({kernel}; {n} of {calls} "
        "recorded)")


def per_call(what: str, make, calls: int = 5) -> dict:
    """An entry point's cost per call: its device activities (kernels,
    copies, fills) and their device time from the profiler, and the wall
    time between host clocks around ``calls`` calls and a synchronize.
    ``make(n)`` gives n zero-argument calls, each on inputs of its own
    where a call edits them.  A window counts only where the profiler
    recorded every kv kernel launch in it (``kv_kernel.LAUNCHES``); after
    three that did not, activities and device time are None."""
    for fn in make(2):   # warm-up: the build, the scratch
        fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a window of a long process may lose records
        counts: dict[str, int] = {}
        before = sum(kv_kernel.LAUNCHES.values())
        dev_ms, _, n = device_time(make(calls), counts=counts)
        launched = sum(kv_kernel.LAUNCHES.values()) - before
        seen = sum(c for k, c in counts.items() if "kv_" in k)
        if n and seen >= launched:   # every kv kernel launch recorded
            break
    else:
        n = 0
    fns = make(calls)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) / calls * 1e6
    # a window that lost records measured nothing, not 0 or a part
    rec = {"activities": n / calls if n else None,
           "device_us": dev_ms * 1e3 if n else None,
           "wall_us": wall_us, "by_name": counts}
    log(f"{what} ({smi()}): "
        + (f"{n / calls:.2f} device activities a call, device time "
           f"{dev_ms * 1e3:.2f} us a call" if n else
           "device activities and device time not measured (the profiler "
           f"recorded {seen} of the {launched} kv kernel launches)")
        + f", wall {wall_us:.2f} us a call ({calls} calls); "
        f"activities {counts}")
    return rec


def check_kernels() -> dict:
    N, B = N_CHAINS * N_NODES, INJECT + ROUTE
    gen = torch.Generator(device="cpu").manual_seed(11)
    values, seqs, pending, keys = (x.cuda() for x in seeded_store(gen, N, B))
    # each chain's last node is its tail, as in the flattened [C * n] roles
    is_tail = torch.arange(N, device="cuda") % N_NODES == N_NODES - 1
    out = {}
    # the grids kv_engine.cu launches the two kernels with: a thread per
    # query in blocks of 256; a block per node of B threads (B <= 512)
    read_grid = ((N * B + 255) // 256, 256)
    write_grid = (N, (B + 31) // 32 * 32)

    # -- read: the node step's (ops mode), then the Pallas contract --------
    got = kv_kernel.cluster_read_decide(values, seqs, pending, keys, is_tail)
    exp = kv_ref.cluster_read_decide_ref(values, seqs, pending, keys,
                                         is_tail)
    torch.cuda.synchronize()
    err = max_abs_err(got, exp)
    require(err == 0, f"kv_read (ops) differs from its plain version by "
            f"{err}")
    require(set(got[2].unique().tolist()) == {0, 1, 2},
            "the read check must take all three decisions")
    rows = torch.arange(N, device="cuda")[:, None]
    keys_in = store_lib.gather_index(keys, NUM_KEYS).long()
    out["kv_read"] = dict(
        max_abs_err=err, grid=read_grid,
        calls=lambda n: [lambda: kv_kernel.cluster_read_decide(
            values, seqs, pending, keys, is_tail)] * n,
        plain=lambda n: [lambda: kv_ref.cluster_read_decide_ref(
            values, seqs, pending, keys, is_tail)] * n,
        # one advanced-index gather of each query's whole register row
        library=lambda n: [lambda: values[rows, keys_in]] * n,
        bound_bytes=decide_bound_bytes(keys),
    )
    got = kv_kernel.cluster_read_engine(values, seqs, pending, keys)
    exp = kv_ref.cluster_read_engine_ref(values, seqs, pending, keys)
    torch.cuda.synchronize()
    err = max_abs_err(got, exp)
    require(err == 0, f"kv_read (engine) differs from its plain version by "
            f"{err}")
    keys_ok = keys.clamp(0, NUM_KEYS - 1).long()
    out["kv_read_engine"] = dict(
        max_abs_err=err, grid=read_grid,
        calls=lambda n: [lambda: kv_kernel.cluster_read_engine(
            values, seqs, pending, keys)] * n,
        plain=lambda n: [lambda: kv_ref.cluster_read_engine_ref(
            values, seqs, pending, keys)] * n,
        library=lambda n: [lambda: values[rows, keys_ok]] * n,
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
    live_b = active.bool()
    snap = [x.clone() for x in (values, seqs, pending)]
    got = kv_kernel.cluster_write_append(*[x.clone() for x in snap], keys,
                                         wvals, wseqs, live_b)
    exp = kv_ref.cluster_write_append_ref(*[x.clone() for x in snap], keys,
                                          wvals, wseqs, live_b)
    torch.cuda.synchronize()
    err = max_abs_err(got, exp)
    require(err == 0, f"kv_write (ops) differs from its plain version by "
            f"{err}")
    require(0 < int(got[3].sum()) < int(live_b.sum()),
            "the ops write check must both accept and overflow")
    appended = got[3]
    rank = batch_rank(keys, live_b)
    got = kv_kernel.cluster_write_engine(values, seqs, pending, keys, wvals,
                                         wseqs, active, rank)
    plain = [x.clone() for x in snap]
    exp = kv_ref.cluster_write_engine_ref(*plain, keys, wvals, wseqs, active,
                                          rank)
    torch.cuda.synchronize()
    err_engine = max_abs_err(got, exp)
    require(err_engine == 0, f"kv_write (engine) differs from its plain "
            f"version by {err_engine}")
    accepted = got[3]
    live = (active > 0) & (keys >= 0) & (keys < NUM_KEYS)
    require(0 < int(accepted.sum()) < int(live.sum()),
            "the engine write check must both accept and overflow")
    # every timed append starts from its own copy of the same pending
    # snapshot, so each one does the work of the checked one
    def appends(fn, *batch):
        return lambda n: [
            lambda p=snap[2].clone(): fn(values, seqs, p, keys, wvals,
                                         wseqs, *batch)
            for _ in range(n)]

    out["kv_write"] = dict(
        max_abs_err=err, grid=write_grid,
        calls=appends(kv_kernel.cluster_write_append, live_b),
        plain=appends(kv_ref.cluster_write_append_ref, live_b),
        library=None,   # no single PyTorch call ranks and appends
        bound_bytes=append_bound_bytes(keys, live_b, appended),
    )
    out["kv_write_engine"] = dict(
        max_abs_err=err_engine, grid=write_grid,
        calls=appends(kv_kernel.cluster_write_engine, active, rank),
        plain=appends(kv_ref.cluster_write_engine_ref, active, rank),
        library=None,
        bound_bytes=write_bound_bytes(keys, active, accepted),
    )

    # the main path's entry points: one launch each, nothing around it
    store = Store(*[x.clone() for x in snap], torch.ones_like(pending))
    one_launch_per_call("kv_ops.cluster_read_batch", "kv_read_kernel",
                        lambda: kv_ops.cluster_read_batch(store, keys,
                                                          is_tail=is_tail))
    one_launch_per_call("kv_ops.cluster_write_batch", "kv_write_kernel",
                        lambda: kv_ops.cluster_write_batch(
                            store, keys, wvals, wseqs, live_b))
    grids = {name: rec.pop("grid") for name, rec in out.items()}
    out = measure(out)
    for name, (blocks, threads) in grids.items():
        launch = lambda b=blocks, t=threads: kv_kernel.empty_kernel(b, t)
        time_calls([launch] * 3)
        _, kernels, n = device_time([launch] * ITERS)
        out[name]["empty_kernel_ms"] = (sum(kernels.values()) / n / 1e3
                                        if n else None)
        out[name]["empty_kernel_grid"] = [blocks, threads]
    return out


def measure(out: dict) -> dict:
    """Time each record's kernel, plain version and library yardstick
    (device time from the profiler where it sees the card, else event
    time) and turn its bound into ms: the larger of its bytes at the
    card's HBM rate and its operations (``bound_flop``, where the record
    has them) at the record's peak (``flop_per_s``; the bf16 tensor-core
    peak unless stated)."""
    for rec in out.values():
        bytes_ms = rec.pop("bound_bytes") / HBM_BYTES_PER_S * 1e3
        if "sector_bytes" in rec:   # the same moves in whole sectors
            rec["sector_bound_ms"] = (rec.pop("sector_bytes")
                                      / HBM_BYTES_PER_S * 1e3)
        peak = rec.pop("flop_per_s", BF16_FLOP_PER_S)
        flop_ms = rec.pop("bound_flop", 0) / peak * 1e3
        rec["bound_ms"] = max(bytes_ms, flop_ms)
        rec["bound_by"] = "operations" if flop_ms > bytes_ms else "bytes"
        iters = rec.pop("iters", ITERS)
        for key in ("", "plain_", "library_"):
            make = rec.pop(key.rstrip("_") or "calls")
            if make is None:
                rec[f"{key}ms"] = rec[f"{key}call_ms"] = None
                continue
            time_calls(make(3))                       # warm-up
            counts: dict[str, int] = {}
            dev_ms, kernels, _ = device_time(make(iters), counts=counts)
            # the profiler now and then drops one kernel record from a
            # window; the calls are alike, so each kernel counts its mean
            # over the launches kept, times its launches per call
            kernels = {k: us / counts[k] * max(1, round(counts[k] / iters))
                       for k, us in kernels.items()}
            if dev_ms is not None:
                dev_ms = sum(kernels.values()) / 1e3
            rec[f"{key}call_ms"] = time_calls(make(iters))
            rec[f"{key}device_measured"] = dev_ms is not None
            rec[f"{key}ms"] = dev_ms if dev_ms is not None else \
                rec[f"{key}call_ms"]
            if key == "":
                rec["device_kernels_us"] = kernels
    return out


def migrated_map(cl: ClusterConfig, device) -> PartitionMap:
    """Chain 0's buckets 0 and 1 moved to the landing regions of chains 1
    and 2, at epoch 2 (the map phase 7 publishes, up to which buckets)."""
    homes = [cl.bucket_home(b) for b in range(cl.num_buckets)]
    owner, base = [c for c, _ in homes], [b for _, b in homes]
    for bucket, dst in ((0, 1), (1, 2)):
        owner[bucket], base[bucket] = dst, cl.keys_in_use
    return PartitionMap.build(owner, base, 2, n_chains=cl.n_chains,
                              num_keys=NUM_KEYS, bucket_slots=cl.bucket_slots,
                              device=device)


def bucketed_batch(cl: ClusterConfig, pmap: PartitionMap, gen):
    """(gkeys, slots, chains) of a batch of ``num_global_keys`` global
    keys: the first 4096 over 64 keys (migrated and home buckets, many
    writes each) and 1 % outside the key space (-1, -7, G, G + 5), for the
    ops modes; the engine modes' (slots, chains) are those keys resolved
    through ``pmap``, with 1 % parked on chain -1 and 1 % with a slot
    outside [0, K)."""
    G = cl.num_global_keys
    dev = pmap.owner.device
    i32 = torch.int32
    gk = torch.randint(0, G, (G,), generator=gen, device=dev, dtype=i32)
    n_dup = min(4096, G // 4)
    gk[:n_dup] = torch.randint(0, 64, (n_dup,), generator=gen, device=dev,
                               dtype=i32)
    chains = cl.key_to_chain(gk, pmap).to(i32)
    slots = cl.key_to_slot(gk, pmap).to(i32)
    outside = torch.tensor([-1, -7, G, G + 5], dtype=i32, device=dev)
    pick = torch.randint(0, 4, (G,), generator=gen, device=dev)
    gk = torch.where(torch.rand(G, generator=gen, device=dev) < 0.01,
                     outside[pick], gk)
    chains[torch.rand(G, generator=gen, device=dev) < 0.01] = -1
    odd = torch.rand(G, generator=gen, device=dev) < 0.01
    pick = torch.randint(0, 3, (G,), generator=gen, device=dev)
    far = torch.tensor([-1, NUM_KEYS, NUM_KEYS + 7], dtype=i32, device=dev)
    slots = torch.where(odd, far[pick], slots)
    return gk.contiguous(), slots.contiguous(), chains.contiguous()


SECTOR = 32   # bytes the card moves per access: a sector of a cache line


def sectors_of(addr: torch.Tensor) -> int:
    """Distinct 32-byte sectors of the byte addresses ``addr`` (each an
    access that lies within one sector: a 4-byte word or an aligned
    16-byte cell)."""
    return int(torch.unique(addr // SECTOR).numel())


def dense_sectors(*nbytes: int) -> int:
    """Sectors of arrays read or written whole, in order."""
    return sum(-(-n // SECTOR) for n in nbytes)


class Leaves:
    """Byte addresses of one replica's store leaves (``[C, K, ...]`` with
    a free chain stride, as the bucketed kernels take them)."""

    def __init__(self, values, seqs, pending):
        self.v, self.s, self.p = values, seqs, pending

    def cell(self, c, s, q):
        return (self.v.data_ptr() + 4 * (c * self.v.stride(0)
                                         + (s * VERSIONS + q) * WORDS))

    def seq(self, c, s, q):
        return self.s.data_ptr() + 4 * (c * self.s.stride(0)
                                        + s * VERSIONS + q)

    def pend(self, c, s):
        return self.p.data_ptr() + 4 * (c * self.p.stride(0) + s)


def read_bounds(leaves: Leaves, chains, slots, tail=None, n_in=2,
                n_map=0) -> tuple:
    """(bytes, sectors) a flat read must move: its ``n_in`` int32 inputs
    per query (``n_map`` map words), per distinct in-store register the
    pending word and the cells it answers with (engine, ``tail`` None:
    cell 0 and, when dirty, the latest; ops: the one cell of the reply),
    each with its seq, and the outputs (engine: two cells and three
    words a query; ops: a cell and four words)."""
    B = chains.numel()
    ok = (chains >= 0) & (chains < N_CHAINS) & (slots >= 0) & (
        slots < NUM_KEYS)
    c, s = chains[ok].long(), slots[ok].long()
    p = leaves.p[c, s].long()
    if tail is None:
        q = torch.cat([torch.zeros_like(p), p[(p > 0) & (p < VERSIONS)]])
        cs = torch.cat([c, c[(p > 0) & (p < VERSIONS)]])
        ss = torch.cat([s, s[(p > 0) & (p < VERSIONS)]])
        out = B * 4 * (2 * WORDS + 3)
    else:
        q = p if tail else torch.zeros_like(p)
        keep = (q >= 0) & (q < VERSIONS)
        cs, ss, q = c[keep], s[keep], q[keep]
        out = B * 4 * (WORDS + 4)
    regs = torch.unique(c * NUM_KEYS + s).numel()
    cells = torch.unique((cs * NUM_KEYS + ss) * VERSIONS + q).numel()
    nbytes = 4 * (n_in * B + n_map) + 4 * regs + 4 * (WORDS + 1) * cells \
        + out
    nsect = (dense_sectors(4 * B * n_in, 4 * n_map, out)
             + sectors_of(leaves.pend(c, s)) + sectors_of(leaves.cell(cs, ss, q))
             + sectors_of(leaves.seq(cs, ss, q)))
    return nbytes, nsect * SECTOR


def write_bounds(leaves: Leaves, chains, slots, live, rank, accepted,
                 wvals, wseqs, in_bytes: int, flag_bytes: int) -> tuple:
    """(bytes, sectors) a flat append must move: ``in_bytes`` of inputs
    per lane (keys, mask, rank as the mode takes them) and ``flag_bytes``
    of accept flag; per distinct live register its pending word read, and
    written where a write was accepted; per accepted write its cell (W
    words) and seq read from the batch and written to the store.
    ``leaves`` hold the pending counts as they were before the append;
    ``rank`` is the write's place among the live writes to its target."""
    B = chains.numel()
    c, s = chains.long(), slots.long()
    lc, ls = c[live], s[live]
    ac = accepted.bool() & live
    slot = leaves.p[c.clamp(0, N_CHAINS - 1), s.clamp(0, NUM_KEYS - 1)] \
        + 1 + rank
    lands = ac & (slot >= 0)
    dc, ds, dq = c[lands], s[lands], slot[lands].long()
    lanes = torch.nonzero(lands).flatten()
    read_regs = torch.unique(lc * NUM_KEYS + ls).numel()
    wrote_regs = torch.unique(c[ac] * NUM_KEYS + s[ac]).numel()
    n_land = int(lands.sum())
    nbytes = (B * (in_bytes + flag_bytes) + 4 * (read_regs + wrote_regs)
              + 2 * 4 * (WORDS + 1) * n_land)
    nsect = (dense_sectors(B * in_bytes, B * flag_bytes)
             + sectors_of(leaves.pend(lc, ls))
             + sectors_of(leaves.pend(c[ac], s[ac]))
             + sectors_of(leaves.cell(dc, ds, dq))
             + sectors_of(leaves.seq(dc, ds, dq))
             + sectors_of(wvals.data_ptr() + 16 * lanes)
             + sectors_of(wseqs.data_ptr() + 4 * lanes))
    return nbytes, nsect * SECTOR


def check_bucketed_kernels(device="cuda") -> dict:
    """Both modes of the bucketed kernels against their plain versions on
    the tail replica of a seeded full-size [C, n, K, V, W] store: the ops
    modes (``bucketed_read_resolve``/``bucketed_write_append``, what
    ``partitioned_read_batch``/``partitioned_write_batch`` launch) on raw
    global keys, the engine modes on resolved slots and chains."""
    cl = cluster("netcraq", partitioned=True)
    gen = torch.Generator(device=device).manual_seed(12)
    full = (N_CHAINS, N_NODES, NUM_KEYS, VERSIONS)
    i32 = torch.int32
    stores = [
        torch.randint(0, 1 << 20, full + (WORDS,), generator=gen,
                      device=device, dtype=i32),
        torch.randint(-1, 100, full, generator=gen, device=device, dtype=i32),
        torch.randint(0, VERSIONS, full[:3], generator=gen, device=device,
                      dtype=i32),
    ]
    tail = [x[:, -1] for x in stores]
    leaves = Leaves(*tail)
    pmap = migrated_map(cl, device)
    gkeys, slots, chains = bucketed_batch(cl, pmap, gen)
    in_range, g_chains, g_slots = kv_ref.place_keys_ref(gkeys, cl, pmap)
    B = slots.numel()
    n_map = 2 * cl.num_buckets
    out = {}

    # -- read: the global-key read (ops mode), then the Pallas contract ------
    got = kv_kernel.bucketed_read_resolve(*tail, gkeys, cl, pmap, True)
    exp = kv_ref.partitioned_read_ref(*tail, gkeys, cl, pmap, True)
    sync(device)
    err = max_abs_err(got, exp)
    require(err == 0, f"kv_bucketed_read (ops) differs from its plain "
            f"version by {err}")
    require(set(got[2].unique().tolist()) == {-1, 0, 1},
            "the ops read check must take decisions -1, 0 and 1")
    ch = g_chains.clamp(0, N_CHAINS - 1).long()
    sl = g_slots.clamp(0, NUM_KEYS - 1).long()
    nbytes, nsect = read_bounds(leaves, g_chains, g_slots, tail=True,
                                n_in=1, n_map=n_map)
    out["kv_bucketed_read"] = dict(
        max_abs_err=err,
        calls=lambda n: [lambda: kv_kernel.bucketed_read_resolve(
            *tail, gkeys, cl, pmap, True)] * n,
        plain=lambda n: [lambda: kv_ref.partitioned_read_ref(
            *tail, gkeys, cl, pmap, True)] * n,
        # one advanced-index gather of each query's whole register row
        library=lambda n: [lambda: tail[0][ch, sl]] * n,
        bound_bytes=nbytes, sector_bytes=nsect,
    )
    got = kv_kernel.bucketed_read_engine(*tail, slots, chains)
    exp = kv_ref.bucketed_read_engine_ref(*tail, slots, chains)
    sync(device)
    err = max_abs_err(got, exp)
    require(err == 0, f"kv_bucketed_read (engine) differs from its plain "
            f"version by {err}")
    require(int((chains == -1).sum()) > 0 and int((slots >= NUM_KEYS).sum())
            > 0 and int((got[2][chains == -1] != 0).sum()) == 0,
            "the read check must park queries, and parked ones read zeros")
    ch_e = chains.clamp(0, N_CHAINS - 1).long()
    sl_e = slots.clamp(0, NUM_KEYS - 1).long()
    nbytes, nsect = read_bounds(leaves, chains, slots)
    out["kv_bucketed_read_engine"] = dict(
        max_abs_err=err,
        calls=lambda n: [lambda: kv_kernel.bucketed_read_engine(
            *tail, slots, chains)] * n,
        plain=lambda n: [lambda: kv_ref.bucketed_read_engine_ref(
            *tail, slots, chains)] * n,
        library=lambda n: [lambda: tail[0][ch_e, sl_e]] * n,
        bound_bytes=nbytes, sector_bytes=nsect,
    )

    # -- write: the global-key append (ops mode), then the Pallas contract ---
    stores[2].clamp_(max=1)
    wvals = torch.randint(0, 1 << 20, (B, WORDS), generator=gen,
                          device=device, dtype=i32)
    wseqs = torch.randint(0, 1 << 16, (B,), generator=gen, device=device,
                          dtype=i32)
    active = torch.randint(0, 2, (B,), generator=gen, device=device,
                           dtype=i32)
    live_b = active.bool()
    snap = [x.clone() for x in stores]
    pend0 = tail[2].clone()

    def each_side(fn_kernel, fn_plain, *batch):
        """The kernel on the store, its plain version on a copy; returns
        (kernel's outputs, max abs error over outputs and stores)."""
        plain_stores = [x.clone() for x in stores]
        got = fn_kernel(*tail, *batch)
        exp = fn_plain(*[x[:, -1] for x in plain_stores], *batch)
        sync(device)
        err = max(max_abs_err(got, exp), max_abs_err(stores, plain_stores))
        for x, y in zip(stores, snap):
            x.copy_(y)
        return got, err

    got, err = each_side(kv_kernel.bucketed_write_append,
                         kv_ref.partitioned_write_ref, gkeys, wvals, wseqs,
                         live_b, cl, pmap)
    require(err == 0, f"kv_bucketed_write (ops) differs from its plain "
            f"version by {err}")
    live_ops = live_b & in_range & (g_chains >= 0) & (g_slots >= 0) & (
        g_slots < NUM_KEYS)
    require(0 < int(got[3].sum()) < int(live_ops.sum()),
            "the ops write check must both accept and overflow")
    rank = batch_rank((g_chains.long() * NUM_KEYS + g_slots.long())[None],
                      (live_b & in_range)[None])[0]
    nbytes, nsect = write_bounds(leaves, g_chains, g_slots, live_ops,
                                 rank, got[3], wvals, wseqs, 5, 1)
    nbytes += 4 * n_map
    nsect += dense_sectors(4 * n_map) * SECTOR

    def appends(fn, *batch):
        # every timed append counts into its own copy of the same pending
        return lambda n: [
            lambda p=pend0.clone(): fn(tail[0], tail[1], p, *batch)
            for _ in range(n)]

    out["kv_bucketed_write"] = dict(
        max_abs_err=err,
        calls=appends(kv_kernel.bucketed_write_append, gkeys, wvals, wseqs,
                      live_b, cl, pmap),
        plain=appends(kv_ref.partitioned_write_ref, gkeys, wvals, wseqs,
                      live_b, cl, pmap),
        library=None,   # no single PyTorch call ranks and appends
        bound_bytes=nbytes, sector_bytes=nsect,
    )
    ok = (chains >= 0) & (slots >= 0) & (slots < NUM_KEYS)
    target = torch.where(ok, chains.long() * NUM_KEYS + slots.long(), -1)
    rank = batch_rank(target[None], (active.bool() & ok)[None])[0]
    got, err = each_side(kv_kernel.bucketed_write_engine,
                         kv_ref.bucketed_write_engine_ref, slots, chains,
                         wvals, wseqs, active, rank)
    require(err == 0, f"kv_bucketed_write (engine) differs from its plain "
            f"version by {err}")
    live = (active > 0) & ok
    require(0 < int(got[3].sum()) < int(live.sum()),
            "the engine write check must both accept and overflow")
    nbytes, nsect = write_bounds(leaves, chains, slots, live, rank,
                                 got[3], wvals, wseqs, 16, 4)
    out["kv_bucketed_write_engine"] = dict(
        max_abs_err=err,
        calls=appends(kv_kernel.bucketed_write_engine, slots, chains, wvals,
                      wseqs, active, rank),
        plain=appends(kv_ref.bucketed_write_engine_ref, slots, chains, wvals,
                      wseqs, active, rank),
        library=None,
        bound_bytes=nbytes, sector_bytes=nsect,
    )
    return measure(out)


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
                   telemetry=False, device=device)
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
    require(launches == {"kv_read": ticks, "kv_write": want_write,
                         "kv_bucketed_read": 0, "kv_bucketed_write": 0},
            f"{protocol}: launches {launches} over {ticks} ticks")
    log(f"{protocol} ({on_card(device)}): main path {ticks} ticks in "
        f"{wall * 1e3:.3f} ms "
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
                       telemetry=False, device=dev)
        sched = schedule(cl, REDUCED_TICKS, dev)
        t0 = time.perf_counter()
        out[dev] = sim.run(sim.init_state(), sched, extra_ticks=REDUCED_EXTRA)
        if dev == "cuda":
            torch.cuda.synchronize()
        log(f"{protocol} ({on_card(dev)}): reduced run "
            f"({REDUCED_TICKS}+{REDUCED_EXTRA} "
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
# phase 7: live rebalance under a hot spot (fig_rebalance at full width)
# ---------------------------------------------------------------------------
def rebalance_stream(cl: ClusterConfig, ticks: int, per_tick: int,
                     device) -> Msg:
    """fig_rebalance's [T, Q] global-key client stream, drawn as it draws
    it (threefry, ``split(PRNGKey(seed), 5)`` into hot, rank, background,
    write and value keys) on ``device``: ``hot_fraction`` of the queries
    hit a zipf tenant whose keys all live on chain 0 (g = rank * C), the
    rest are uniform; ``write_fraction`` of them are writes."""
    T, Q, C = ticks, per_tick, cl.n_chains
    k_hot, k_rank, k_bg, k_w, k_v = prng.split(
        prng.PRNGKey(REBALANCE["seed"], device), 5)
    wl = WorkloadConfig(key_skew="zipf", zipf_a=REBALANCE["zipf_a"])
    hot_keys = _sample_keys(k_rank, (T, Q), cl.keys_in_use, wl) * C
    bg = prng.randint(k_bg, (T, Q), 0, cl.num_global_keys)
    f32 = lambda x: torch.full((), x, dtype=torch.float32, device=device)
    is_hot = prng.uniform(k_hot, (T, Q)) < f32(REBALANCE["hot_fraction"])
    is_write = prng.uniform(k_w, (T, Q)) < f32(REBALANCE["write_fraction"])
    vals = prng.randint(k_v, (T, Q), 1, 1 << 20)
    qid = torch.arange(T * Q, dtype=torch.int32, device=device).reshape(T, Q)
    base = Msg.empty((T, Q), WORDS, device=device)
    value = torch.zeros((T, Q, WORDS), dtype=torch.int32, device=device)
    value[..., 0] = torch.where(is_write, vals, 0)
    return base._replace(
        op=torch.where(is_write, OP_WRITE, OP_READ).to(torch.int32),
        key=torch.where(is_hot, hot_keys, bg).to(torch.int32),
        value=value,
        src=CLIENT_BASE + qid % 512,
        client=CLIENT_BASE + qid % 512,
        qid=qid,
        t_inject=torch.arange(T, dtype=torch.int32, device=device)[
            :, None].expand(T, Q).contiguous())


def hottest_buckets(cl: ClusterConfig, stream: Msg, upto: int, k: int = 2):
    """The ``k`` most-offered buckets homed on chain 0 over the first
    ``upto`` ticks (what a load-aware control plane would sample)."""
    b = cl.bucket_of(stream.key[:upto].reshape(-1).long())
    counts = torch.bincount(b, minlength=cl.num_buckets).tolist()
    return sorted(range(cl.buckets_per_chain), key=lambda x: -counts[x])[:k]


def per_tick(counts: list) -> torch.Tensor:
    """[T, C] per-tick increments of a list of T cumulative [C] counters."""
    stacked = torch.stack(counts)
    return torch.diff(stacked, dim=0, prepend=torch.zeros_like(stacked[:1]))


def rebalance_run(cl, stream, migrate: bool, device, *, ticks, freeze,
                  publish, drain, hot):
    """fig_rebalance's ``run_once``: route each tick through the clients'
    cached map, tick, and (``migrate``) move ``hot[i]`` to chain i + 1
    between freeze[i] and publish[i], with the clients keeping the
    pre-publish map for one more tick.  Returns (coordinator, state,
    replies per tick [T, C], write NACKs per tick [T, C], router stale
    count, host seconds spent routing, ticking and in the control
    plane).  Every tick ends in a copy to the host, so the three
    sums split the wall time between them."""
    q = REBALANCE["q"]
    sim = ChainSim(cl, inject_capacity=q, route_capacity=max(256, 16 * q),
                   reply_capacity=4096, device=device)
    co = Coordinator(cl, device=device)
    state = sim.init_state()
    client_pmap = co.partition_map()
    client_epoch = 0
    live_pmap, live_epoch = client_pmap, 0
    replies, nacks = [], []
    router_stale = 0
    moves = iter(enumerate(hot))
    pending = None
    spent = dict(route=0.0, tick=0.0, control=0.0)
    clock = time.perf_counter
    for t in range(ticks):
        t0 = clock()
        if live_epoch != co.partition_epoch:
            live_pmap, live_epoch = co.partition_map(), co.partition_epoch
        routed = route_stream(cl, tree_map(lambda x: x[t:t + 1], stream), q,
                              pmap=client_pmap, live_pmap=live_pmap)
        router_stale += int(routed.stale)
        t1 = clock()
        state = sim.tick(state, tree_map(lambda x: x[0], routed.lanes))
        replies.append(state.metrics.replies.cpu())
        nacks.append(state.metrics.write_nacks.cpu())
        t2 = clock()
        if migrate:
            if t in freeze and pending is None:
                i, pending = next(moves)
                co.begin_rebalance(pending, i + 1)
                state = co.install_roles(state)
            if t in publish and pending is not None:
                state = co.complete_rebalance(state)
                pending = None
            elif client_epoch != live_epoch:
                client_pmap, client_epoch = live_pmap, live_epoch
        sync(device)
        t3 = clock()
        spent["route"] += t1 - t0
        spent["tick"] += t2 - t1
        spent["control"] += t3 - t2
    state = sim.drain(state, drain)
    return (co, state, per_tick(replies), per_tick(nacks), router_stale,
            spent)


def serial_replay(cl: ClusterConfig, state, stream: Msg) -> torch.Tensor:
    """[G] value word 0 of every global key after replaying each
    acknowledged write in the engine's serialization order (the largest
    write seq of a key wins) onto an empty store."""
    r = state.replies
    require(int(r.lost.sum()) == 0, "the reply log overflowed")
    key_of = torch.full((int(stream.qid.max()) + 1,), -1, dtype=torch.long,
                        device=stream.key.device)
    key_of[stream.qid.reshape(-1).long()] = stream.key.reshape(-1).long()
    cur = r.cursor.tolist()
    keys, seqs, vals = [], [], []
    for c in range(cl.n_chains):
        w = r.op[c, :cur[c]] == OP_WRITE_REPLY
        keys.append(key_of[r.qid[c, :cur[c]][w].long()])
        seqs.append(r.seq[c, :cur[c]][w].long())
        vals.append(r.value0[c, :cur[c]][w])
    keys, seqs, vals = (torch.cat(x) for x in (keys, seqs, vals))
    order = torch.argsort(keys * (1 << 32) + seqs)   # per key, seq rising
    keys, vals = keys[order], vals[order]
    newest = torch.ones_like(keys, dtype=torch.bool)
    newest[:-1] = keys[1:] != keys[:-1]
    out = torch.zeros(cl.num_global_keys, dtype=torch.int32,
                      device=keys.device)
    out[keys[newest]] = vals[newest]
    return out


def read_back(cl: ClusterConfig, state, pmap):
    """Every global key read through ``partitioned_read_batch`` on the
    tail replica (its ``[:, -1]`` slice, in place), in one launch.
    Returns (reply_val [G, W], decision [G])."""
    tail = Store(*[x[:, -1] for x in state.stores])
    gkeys = torch.arange(cl.num_global_keys, dtype=torch.int32,
                         device=state.stores.values.device)
    rv, _, dec, _, _ = kv_ops.partitioned_read_batch(cl, tail, gkeys, pmap,
                                                     is_tail=True)
    return rv, dec


def check_consistent(cl, co, state, stream, what: str) -> int:
    """The read-back of every global key equals ``committed_view`` and
    the serial replay of the acknowledged writes; replicas converged."""
    vals = state.stores.values[..., 0, 0]
    require(int(state.stores.pending.abs().sum()) == 0,
            f"{what}: dirty versions left after the drain")
    require(torch.equal(vals, vals[:, -1:].expand_as(vals)),
            f"{what}: replicas did not converge")
    rv, dec = read_back(cl, state, co.partition_map())
    require(bool((dec == 0).all()), f"{what}: a read-back was not clean")
    view = txn_lib.committed_view(cl, state)
    require(sorted(view) == list(range(cl.num_global_keys)),
            f"{what}: committed_view does not cover the key space")
    view_t = torch.tensor([view[g] for g in range(cl.num_global_keys)],
                          dtype=torch.int32, device=rv.device)
    replay = serial_replay(cl, state, stream)
    require(torch.equal(rv[:, 0], view_t),
            f"{what}: read-back differs from committed_view")
    require(torch.equal(rv[:, 0], replay),
            f"{what}: read-back differs from the serial replay")
    return int((replay != 0).sum())


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def rebalance_phase(device="cuda") -> dict:
    cl = cluster("netcraq", partitioned=True)
    T, q = REBALANCE["ticks"], REBALANCE["q"]
    per_tick = int(0.75 * N_CHAINS * N_NODES * q)
    stream = rebalance_stream(cl, T, per_tick, device)
    hot = hottest_buckets(cl, stream, FREEZE_AFTER[0])
    kw = dict(ticks=T, freeze=FREEZE_AFTER, publish=PUBLISH_AFTER,
              drain=4 * N_NODES, hot=hot)
    t0 = time.perf_counter()
    co_s, st_s, tput_s, nack_s, stale_s, _ = rebalance_run(
        cl, stream, False, device, **kw)
    sync(device)
    t_static = time.perf_counter() - t0
    kv_kernel.reset_launches()
    t0 = time.perf_counter()
    co_m, st_m, tput_m, nack_m, stale_m, spent = rebalance_run(
        cl, stream, True, device, **kw)
    sync(device)
    t_run = time.perf_counter() - t0
    n_written = check_consistent(cl, co_m, st_m, stream, "rebalance")
    sync(device)
    t_mig = time.perf_counter() - t0
    launches = dict(kv_kernel.LAUNCHES)
    check_consistent(cl, co_s, st_s, stream, "static twin")

    m, m_s = st_m.metrics.per_chain(), st_s.metrics.per_chain()
    require(sum(m["stale_routes"]) > 0 and stale_m > 0,
            "no stale client was redirected")
    require(sum(m["stale_routes"]) <= stale_m,
            "more stale NACKs than stale-routed queries")
    require(sum(m_s["stale_routes"]) == 0 and stale_s == 0,
            "the static run saw stale routes")
    require(m["migration_moves"] == [2, 1, 1] + [0] * (N_CHAINS - 3),
            f"migration_moves {m['migration_moves']}")
    require(sum(m["drops"]) == 0 and sum(m_s["drops"]) == 0, "drops")
    frozen = {t for f, p in zip(FREEZE_AFTER, PUBLISH_AFTER)
              for t in range(f + 1, p + 1)}
    nack_ticks = {t for t in range(T) if int(nack_m[t].sum())}
    require(nack_ticks and nack_ticks <= frozen and
            int(nack_m[:, 1:].sum()) == 0,
            f"write NACKs at ticks {sorted(nack_ticks)} outside the freeze "
            f"windows {sorted(frozen)}")
    require(int(nack_s.sum()) == 0, "the static run NACKed writes")
    for c in range(3, N_CHAINS):
        for name in ("stores", "replies", "metrics"):
            for f, a, b in zip(getattr(st_m, name)._fields,
                               getattr(st_m, name), getattr(st_s, name)):
                if name == "metrics" and f == "migration_moves":
                    continue
                require(torch.equal(a[c], b[c]),
                        f"spectator chain {c} diverged in {name}.{f}")
        require(torch.equal(tput_m[:, c], tput_s[:, c]),
                f"spectator chain {c} per-tick replies diverged")
    require(launches["kv_bucketed_read"] == 1 and
            launches["kv_bucketed_write"] == 0,
            f"the read-back must be one launch: launches {launches}")
    tail = Store(*[x[:, -1] for x in st_m.stores])
    gkeys = torch.arange(cl.num_global_keys, dtype=torch.int32,
                         device=tail.values.device)
    pmap = co_m.partition_map()
    read_back_cost = None
    if torch.device(device).type == "cuda":
        read_back_cost = per_call(
            f"partitioned_read_batch, phase 7's read-back of "
            f"{cl.num_global_keys} keys",
            lambda n: [lambda: kv_ops.partitioned_read_batch(
                cl, tail, gkeys, pmap, is_tail=True)] * n)
    window = slice(PUBLISH_AFTER[-1] + 2, T)
    served_s = int(tput_s[window].sum())
    served_m = int(tput_m[window].sum())
    log(f"rebalance ({on_card(device)}): {T}+{4 * N_NODES} ticks at "
        f"{per_tick} queries/tick, "
        f"buckets {hot} of chain 0 moved to chains 1, 2 "
        f"(now {[co_m.bucket_placement(b) for b in hot]}, epoch "
        f"{co_m.partition_epoch}); replies over ticks {window.start}.."
        f"{T - 1}: migrated {served_m}, static {served_s}, gain "
        f"{served_m / max(served_s, 1):.4f}x; stale_routes "
        f"{sum(m['stale_routes'])} (router {stale_m}); write_nacks "
        f"{sum(m['write_nacks'])} at ticks {sorted(nack_ticks)}; "
        f"migration_moves {m['migration_moves']}; drops 0; chains 3-"
        f"{N_CHAINS - 1} bit-identical to the static twin; all "
        f"{cl.num_global_keys} global keys read back through the map "
        f"== committed_view == serial replay ({n_written} written); "
        f"launches {launches}; wall {t_mig:.3f} s, of which the run "
        f"{t_run:.3f} s (per schedule tick: routing "
        f"{spent['route'] / T * 1e3:.3f} ms, tick {spent['tick'] / T * 1e3:.3f}"
        f" ms, control plane {spent['control'] / T * 1e3:.3f} ms; the "
        f"{4 * N_NODES} drain ticks the rest) and the read-back with its "
        f"checks {t_mig - t_run:.3f} s (static twin {t_static:.3f} s)")
    return {"launches": launches, "state": st_m, "coordinator": co_m,
            "cluster": cl, "hot": hot, "gain": served_m / max(served_s, 1),
            "read_back_cost": read_back_cost}


# ---------------------------------------------------------------------------
# phase 8: global-key writes under the migrated map
# ---------------------------------------------------------------------------
def partitioned_write_phase(reb: dict) -> dict:
    """fig_rebalance's final map; ``tests/test_kernels.py``'s partitioned
    write/read checks at full size on a copy of the tail replica."""
    cl, co, state = reb["cluster"], reb["coordinator"], reb["state"]
    pmap = co.partition_map()
    tail = Store(*[x[:, -1].clone() for x in state.stores])
    before = Store(*[x.clone() for x in tail])
    dev = tail.values.device
    G = cl.num_global_keys
    g_all = torch.arange(G, device=dev)
    moved = g_all[torch.isin(cl.bucket_of(g_all),
                             torch.tensor(reb["hot"], device=dev))]
    gen = torch.Generator(device="cpu").manual_seed(8)
    rand = torch.randint(0, G, (512,), generator=gen).to(dev)
    odd = torch.tensor([-1, -7, G, G + 5, 1 << 20], device=dev)
    gkeys = torch.cat([moved, moved[:1024], rand, odd]).to(torch.int32)
    B = gkeys.numel()
    wvals = value_from_int(1_000_000 + torch.arange(B, device=dev))
    wseqs = (1 << 20) + torch.arange(B, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.int32, device=dev)
    kv_kernel.reset_launches()
    tail, acc = kv_ops.partitioned_write_batch(cl, tail, gkeys, wvals, wseqs,
                                               active, pmap)
    rv, rs, dec, chains, slots = kv_ops.partitioned_read_batch(
        cl, tail, gkeys, pmap, is_tail=True)
    sync(dev)
    launches = dict(kv_kernel.LAUNCHES)

    # the sequential expectation: per key, writes in batch order until
    # the window (V - 1 dirty cells over a drained register) is full
    keys = gkeys.tolist()
    inr = [0 <= g < G for g in keys]
    n_seen, exp_acc, last = {}, [], {}
    for i, g in enumerate(keys):
        ok = inr[i] and n_seen.get(g, 0) < VERSIONS - 1
        exp_acc.append(ok)
        if inr[i]:
            n_seen[g] = n_seen.get(g, 0) + 1
        if ok:
            last[g] = 1_000_000 + i
    inr_t = torch.tensor(inr, device=dev)
    require(acc.tolist() == exp_acc, "accepted writes differ from the "
            "sequential order")
    require(max(n_seen.values()) >= 2, "the batch must repeat keys")
    exp_val = torch.tensor([last.get(g, 0) if ok else 0
                            for g, ok in zip(keys, inr)], device=dev)
    require(torch.equal(rv[:, 0].long(), exp_val),
            "a key's newest write is not what its read returns")
    require(bool((dec[inr_t] == 1).all()) and bool((dec[~inr_t] == -1).all())
            and int(rv[~inr_t].abs().sum()) == 0,
            "decisions: written keys 1 (dirty at the tail), outside -1")
    safe = torch.where(inr_t, gkeys, 0)
    require(torch.equal(chains, torch.where(
        inr_t, cl.key_to_chain(safe, pmap).to(torch.int32), -1)) and
        torch.equal(slots[inr_t],
                    cl.key_to_slot(gkeys[inr_t], pmap).to(torch.int32)),
        "chains/slots differ from key_to_chain/key_to_slot")
    touched = torch.zeros((N_CHAINS, NUM_KEYS), dtype=torch.bool, device=dev)
    touched[chains[inr_t].long(), slots[inr_t].long()] = True
    require(int((tail.pending - before.pending).sum()) == int(acc.sum()),
            "pending grew by other than the accepted writes")
    for f, a, b in zip(Store._fields, tail, before):
        require(torch.equal(a[~touched], b[~touched]),
                f"a write outside the key space changed {f}")
    require(launches == {"kv_read": 0, "kv_write": 0, "kv_bucketed_read": 1,
                         "kv_bucketed_write": 1}, f"launches {launches}")
    log(f"partitioned writes: {B} global keys ({moved.numel()} in the "
        f"migrated buckets, {len(keys) - sum(inr)} outside the key space) "
        f"under map epoch {co.partition_epoch}: {int(acc.sum())} accepted, "
        f"duplicates serialized, outside keys dropped and read back as "
        f"decision -1, every other register untouched; launches {launches}")
    if dev.type != "cuda":
        return {"launches": launches}
    # each timed write on its own copy of the tail as it was
    write_cost = per_call(
        f"partitioned_write_batch, phase 8's {B} keys",
        lambda n: [lambda st=Store(*[x.clone() for x in before]):
                   kv_ops.partitioned_write_batch(cl, st, gkeys, wvals,
                                                  wseqs, active, pmap)
                   for _ in range(n)])
    read_cost = per_call(
        f"partitioned_read_batch, phase 8's {B} keys",
        lambda n: [lambda: kv_ops.partitioned_read_batch(
            cl, tail, gkeys, pmap, is_tail=True)] * n)
    return {"launches": launches, "write_cost": write_cost,
            "read_cost": read_cost}


# ---------------------------------------------------------------------------
# phase 9: failover and two-phase recovery (fig_failover at full width)
# ---------------------------------------------------------------------------
def failover_schedule(cl: ClusterConfig, device) -> Msg:
    """fig_failover's [T, C, n, 2q] schedule: q client queries per lane,
    q NOP slots that a redirected lane lands in."""
    f = FAILOVER
    sched = make_schedule(cl, WorkloadConfig(
        ticks=f["ticks"], queries_per_tick=f["q"],
        write_fraction=f["write_fraction"], seed=f["seed"]), device=device)
    pad = Msg.empty(tuple(sched.op.shape[:3]) + (f["q"],), WORDS,
                    device=device)
    return Msg.concat([sched, pad], dim=3)


def redirect(inj: Msg, chain: int, dead: int, target: int, q: int) -> Msg:
    """Client phase-1 failover: this tick's queries of the dead node's
    lane ride the target node's spare slots instead."""
    lane = tree_map(lambda x: x[chain, dead, :q].clone(), inj)
    lane = lane._replace(dst=torch.where(lane.op != OP_NOP, target,
                                         NOWHERE).to(torch.int32))
    inj = tree_map(lambda x: x.clone(), inj)
    for dst, src in zip(inj, lane):
        dst[chain, target, q:2 * q] = src
    blank = Msg.empty(inj.op.shape[-1], WORDS, device=inj.op.device)
    for dst, src in zip(inj, blank):
        dst[chain, dead] = src
    return inj


def failover_run(cl, sched, disturb: bool, device):
    f = FAILOVER
    q, c_fail, dead = f["q"], f["chain"], f["node"]
    sim = ChainSim(cl, inject_capacity=2 * q, route_capacity=max(128, 16 * q),
                   reply_capacity=4 * f["ticks"] * N_NODES * q * 2 + 64,
                   device=device)
    co = Coordinator(cl, device=device)
    det = FailureDetector(n_nodes=N_NODES, timeout_ticks=f["timeout_ticks"])
    state = sim.init_state()
    dead_pos = co.chains[c_fail].position_of(dead)
    replies, nacks, copy_ok = [], [], None
    redirecting = False
    spent = dict(control=0.0, tick=0.0)
    clock = time.perf_counter
    for t in range(f["ticks"]):
        t0 = clock()
        inj = tree_map(lambda x: x[t], sched)
        if disturb:
            if t == f["fail_tick"]:
                co.fail_node(c_fail, dead)
                state = co.install_roles(state)
            if t == f["freeze_tick"]:
                co.begin_recovery(c_fail)
                state = co.install_roles(state)
            if t == f["recover_tick"]:
                src = co.recovery_source(c_fail, dead_pos)
                _, stores = co.complete_recovery(
                    c_fail, dead, dead_pos, state.stores, locks=state.locks)
                copy_ok = all(torch.equal(x[c_fail, dead], x[c_fail, src])
                              for x in stores)
                state = co.install_roles(state._replace(stores=stores))
                redirecting = False
            if redirecting and t < f["recover_tick"]:
                target = co.failover.redirect(co.chains[c_fail], dead,
                                              client=dead, key=t)
                inj = redirect(inj, c_fail, dead, target, q)
            det.tick()
            for i in co.chains[c_fail].node_ids:
                det.heard_from(i)
            if f["fail_tick"] <= t < f["recover_tick"] and det.suspected():
                redirecting = True
        sync(device)
        t1 = clock()
        state = sim.tick(state, inj)
        replies.append(state.metrics.replies.cpu())
        nacks.append(state.metrics.write_nacks.cpu())
        spent["control"] += t1 - t0
        spent["tick"] += clock() - t1
    state = sim.drain(state, 4 * N_NODES)
    return state, per_tick(replies), per_tick(nacks), copy_ok, spent


def failover_phase(device="cuda") -> dict:
    f = FAILOVER
    cl = cluster("netcraq")
    sched = failover_schedule(cl, device)
    t0 = time.perf_counter()
    base, tput_b, _, _, _ = failover_run(cl, sched, False, device)
    kv_kernel.reset_launches()
    failed, tput_f, nack_f, copy_ok, spent = failover_run(cl, sched, True,
                                                          device)
    sync(device)
    launches = dict(kv_kernel.LAUNCHES)
    wall = time.perf_counter() - t0
    c_fail = f["chain"]
    require(copy_ok, "the replacement's store differs from its copy source")
    nack_ticks = {t for t in range(f["ticks"]) if int(nack_f[t].sum())}
    window = set(range(f["freeze_tick"], f["recover_tick"]))
    require(nack_ticks and nack_ticks <= window
            and int(nack_f.sum()) == int(nack_f[:, c_fail].sum()),
            f"write NACKs at ticks {sorted(nack_ticks)}, freeze window "
            f"{sorted(window)}")
    for c in range(N_CHAINS):
        if c == c_fail:
            continue
        for name in ("stores", "replies", "metrics"):
            for fld, a, b in zip(getattr(failed, name)._fields,
                                 getattr(failed, name), getattr(base, name)):
                require(torch.equal(a[c], b[c]),
                        f"chain {c} diverged from the twin in {name}.{fld}")
        require(torch.equal(tput_f[:, c], tput_b[:, c]),
                f"chain {c} per-tick replies diverged from the twin")
    n_keys = check_readback(failed, "failover")
    col = tput_f[:, c_fail].double()
    warm = min(4, f["fail_tick"] // 2)
    baseline = float(col[warm:f["fail_tick"]].mean())
    dip = float(col[f["fail_tick"]:f["recover_tick"]].min())
    recovered = float(col[f["recover_tick"] + 2:].mean())
    recovered_ref = float(tput_b[f["recover_tick"] + 2:, c_fail].double()
                          .mean())
    require(dip < baseline, "the failure made no visible dip")
    require(recovered >= 0.95 * recovered_ref,
            f"throughput did not recover: {recovered} vs undisturbed "
            f"{recovered_ref}")
    m = failed.metrics.asdict()
    log(f"failover ({on_card(device)}): node {f['node']} of chain "
        f"{c_fail} failed at tick "
        f"{f['fail_tick']}, writes frozen {f['freeze_tick']}.."
        f"{f['recover_tick'] - 1}, replacement copied from its CRAQ source "
        f"at {f['recover_tick']}; chain {c_fail} replies/tick: baseline "
        f"{baseline}, dip {dip}, recovered {recovered} (twin {recovered_ref}, "
        f"recovered_frac {recovered / recovered_ref}); drops {m['drops']}, "
        f"write_nacks {m['write_nacks']} at ticks {sorted(nack_ticks)}; "
        f"chains 1-{N_CHAINS - 1} bit-identical to the twin; acknowledged "
        f"keys read back from {N_NODES} replicas: {n_keys}; launches "
        f"{launches}; wall {wall:.3f} s for both runs (disturbed run per "
        f"schedule tick: tick {spent['tick'] / f['ticks'] * 1e3:.3f} ms, "
        f"control plane, detector and redirect "
        f"{spent['control'] / f['ticks'] * 1e3:.3f} ms)")
    return {"launches": launches}


def rebalance_equality() -> None:
    """Phase 7's lifecycle at reduced depth (one move) on CUDA (kernels)
    and on the CPU (plain versions): identical states and read-backs."""
    cl = cluster("netcraq", partitioned=True)
    r = REDUCED_REBALANCE
    per_tick = int(0.75 * N_CHAINS * N_NODES * REBALANCE["q"])
    out = []
    for dev in ("cuda", "cpu"):
        stream = rebalance_stream(cl, r["ticks"], per_tick, dev)
        hot = hottest_buckets(cl, stream, r["freeze"][0], k=1)
        t0 = time.perf_counter()
        co, state, tput, nacks, _, _ = rebalance_run(
            cl, stream, True, dev, ticks=r["ticks"], freeze=r["freeze"],
            publish=r["publish"], drain=r["drain"], hot=hot)
        out.append((state, read_back(cl, state, co.partition_map()), tput,
                    nacks))
        sync(dev)
        log(f"rebalance ({on_card(dev)}): reduced run ({r['ticks']}+"
            f"{r['drain']} ticks, "
            f"bucket {hot[0]} moved) on {dev} in "
            f"{time.perf_counter() - t0:.3f} s")
    (gpu, gpu_rb, *gpu_t), (cpu, cpu_rb, *cpu_t) = out
    for name in ("stores", "metrics", "replies", "locks", "inbox", "roles",
                 "pmap"):
        for f, a, b in zip(getattr(cpu, name)._fields, getattr(cpu, name),
                           getattr(gpu, name)):
            require(torch.equal(a, b.cpu()),
                    f"rebalance: CUDA and CPU runs differ in {name}.{f}")
    for a, b in zip((*cpu_rb, *cpu_t), (*gpu_rb, *gpu_t)):
        require(torch.equal(a, b.cpu()),
                "rebalance: CUDA and CPU read-backs differ")
    require(int(gpu.metrics.migration_moves.sum()) == 2,
            "rebalance: the reduced run moved no bucket")
    log("rebalance: CUDA run == CPU plain run (stores, metrics, replies, "
        "locks, inbox, roles, map, read-back of every global key)")


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

    counts: dict[str, int] = {}
    t0 = time.perf_counter()
    dev_ms, kernels, n_act = device_time([lambda inj=inj: one_tick(inj)
                                          for inj in ticks], counts=counts)
    wall_us = (time.perf_counter() - t0) / len(ticks) * 1e6
    busy_us = None if dev_ms is None else dev_ms * 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    kv_names = [k for k in kernels if "kv_" in k]
    kv_us = {k: kernels[k] / len(ticks) for k in kv_names}
    kv_per_tick = {k: counts[k] / len(ticks) for k in kv_names}
    log(f"{protocol} ({on_card('cuda')}): {us_tick:.1f} us/tick over "
        f"{len(ticks)} ticks "
        f"(C={N_CHAINS} n={N_NODES} K={NUM_KEYS}); with stage events "
        f"{us_tick_traced:.1f} us/tick; per-tick stage time (us, stream "
        "time between a stage's first and last enqueue): "
        + ", ".join(f"{k}={v:.1f}" for k, v in sorted(
            stages.items(), key=lambda kv: -kv[1])))
    if busy_us is None:
        log(f"{protocol}: profiler saw no device activity: device busy "
            "share and activities per tick not measured")
    else:
        log(f"{protocol}: under the profiler {wall_us:.1f} us/tick wall, "
            f"device busy {busy_us:.1f} us/tick "
            f"(idle share {1 - busy_us / wall_us:.4f}); top device time "
            "per tick (us): " + "; ".join(
                f"{k[:60]}={v / len(ticks):.1f}" for k, v in top))
        log(f"{protocol}: {n_act / len(ticks):.2f} device activities per "
            "tick; kv stages (us of stream time per tick): "
            + ", ".join(f"{k}={stages[k]:.1f}" for k in (
                "kv_read (ops)", "kv_write (ops, incl. rank)") if k in stages)
            + "; kv kernels per tick (launches, device us): "
            + "; ".join(f"{k[:48]} {kv_per_tick[k]:.2f}, {kv_us[k]:.2f}"
                        for k in kv_names))
    return {"us_per_tick": us_tick, "stages_us": stages,
            "device_busy_us_per_tick": busy_us,
            "profiled_wall_us_per_tick": wall_us,
            "device_activities_per_tick": n_act / len(ticks),
            "kv_device_us_per_tick": kv_us,
            "kv_launches_per_tick": kv_per_tick}


# ---------------------------------------------------------------------------
# phase 10: the flash_attention kernel against its plain version
# ---------------------------------------------------------------------------
def attention_inputs(gen, B, HQ, HKV, S, SK, D, dtype):
    """q, k, v as the model hands them to the kernel: [B, H, S, D] views
    of [B, S, H, D] projections."""
    def one(H, T):
        x = torch.randn((B, T, H, D), generator=gen, device="cuda")
        return x.to(dtype).transpose(1, 2)
    return one(HQ, S), one(HKV, SK), one(HKV, SK)


def attention_bound(q, k, causal: bool = True):
    """(bytes, operations) the attention must move and do for these
    inputs: q and o once, k and v once; 4 * D operations (q.k and p.v)
    per (query, key) pair under the kernel's mask."""
    B, HQ, S, D = q.shape
    HKV, SK = k.shape[1], k.shape[2]
    pairs = (sum(min(i + 1, SK) for i in range(S)) if causal else S * SK)
    nbytes = q.element_size() * D * (2 * B * HQ * S + 2 * B * HKV * SK)
    return nbytes, 4 * D * B * HQ * pairs


def check_flash_attention() -> dict:
    """Both routes of the kernel against its plain version on the card:
    the tensor-core route at the serving shape (one layer's prefill of
    phase 11), a ragged tile edge and S > SK, the f32 route at float32 and
    S < SK, each case held to the route ``fa_kernel.route`` gives it; then
    times each route beside its plain version, the SDPA yardstick and its
    bound: the tensor-core route at the serving shape, the f32 route at
    its float32 case.  The design the tensor-core route replaced (the f32
    kernel, which a misaligned bf16 view still takes) is timed at the
    serving shape too."""
    cfg = get_config(SERVE_ARCH)
    HQ, HKV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("serving", SLOTS, PROMPT_LEN, PROMPT_LEN, bf16, 2e-2, "mma"),
             ("float32", 2, PROMPT_LEN, PROMPT_LEN, f32, 2e-5, "f32"),
             ("ragged", SLOTS, 200, 200, bf16, 2e-2, "mma"),
             ("s_lt_sk", 2, 200, 700, f32, 2e-5, "f32"),
             ("s_gt_sk", 2, 700, 200, bf16, 2e-2, "mma")]
    gen = torch.Generator(device="cuda").manual_seed(13)
    errs = {"mma": {}, "f32": {}}
    for name, B, S, SK, dtype, tol, want in cases:
        q, k, v = attention_inputs(gen, B, HQ, HKV, S, SK, D, dtype)
        fa_kernel.reset_launches()
        got = fa_kernel.flash_attention(q, k, v)
        exp = fa_ref.flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        require(fa_kernel.LAUNCHES[f"flash_attention_{want}"] == 1,
                f"flash_attention {name}: took the wrong route "
                f"{fa_kernel.LAUNCHES}, want {want}")
        err = float((got.float() - exp.float()).abs().max())
        require(bool(torch.isfinite(got).all()),
                f"flash_attention {name}: non-finite output")
        require(err <= tol, f"flash_attention {name} [{B}, {HQ}/{HKV}, "
                f"{S}, {SK}, {D}] {dtype}: differs from its plain version "
                f"by {err} > {tol}")
        errs[want][name] = err
        log(f"flash_attention {name} ({want} route): q [{B}, {HQ}, {S}, "
            f"{D}], k/v [{B}, {HKV}, {SK}, {D}] {str(dtype)[6:]}: max abs "
            f"err {err:.3g} (tolerance {tol})")
        del q, k, v, got, exp

    def record(q, k, v, peak):
        nbytes, flop = attention_bound(q, k)
        return dict(
            calls=lambda n: [lambda: fa_kernel.flash_attention(q, k, v)] * n,
            plain=lambda n: [lambda: fa_ref.flash_attention_ref(q, k, v)] * n,
            # timed here only; the port never calls it
            library=lambda n: [lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)] * n,
            bound_bytes=nbytes, bound_flop=flop, flop_per_s=peak,
            iters=FA_ITERS)
    serving = attention_inputs(gen, SLOTS, HQ, HKV, PROMPT_LEN, PROMPT_LEN,
                               D, bf16)
    single = attention_inputs(gen, 2, HQ, HKV, PROMPT_LEN, PROMPT_LEN, D,
                              f32)
    out = measure({
        "flash_attention": dict(record(*serving, BF16_FLOP_PER_S),
                                max_abs_err=max(errs["mma"].values()),
                                case_errs=errs["mma"]),
        "flash_attention_f32": dict(record(*single, F32_FLOP_PER_S),
                                    max_abs_err=max(errs["f32"].values()),
                                    case_errs=errs["f32"])})
    for name, (q, k, _), peak in (("flash_attention", serving, "bf16 "
                                   "tensor-core"),
                                  ("flash_attention_f32", single,
                                   "f32 CUDA-core")):
        rec = out[name]
        nbytes, flop = attention_bound(q, k)
        rec["tflop_per_s"] = flop / rec["ms"] / 1e9
        log(f"{name} at q {list(q.shape)} {str(q.dtype)[6:]}: "
            f"{flop / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; {rec['ms']:.4f}"
            f" ms per call = {rec['tflop_per_s']:.1f} TFLOP/s; SDPA "
            f"{rec['library_ms']:.4f} ms; bound {rec['bound_ms']:.4f} ms by "
            f"{rec['bound_by']} at the {peak} peak")
    # the replaced design: a bf16 view whose rows are not 16-byte aligned
    # takes the f32 kernel
    padded = [torch.empty(x.shape[:3] + (D + 1,), dtype=bf16,
                          device="cuda")[..., :D] for x in serving]
    for dst, src in zip(padded, serving):
        dst.copy_(src)
    require(fa_kernel.route(*padded) == "f32",
            "a misaligned bf16 view should take the f32 route")
    time_calls([lambda: fa_kernel.flash_attention(*padded)] * 2)
    old_ms, _, _ = device_time([lambda: fa_kernel.flash_attention(*padded)]
                               * 3)
    out["flash_attention"]["replaced_design_ms"] = old_ms
    log(f"flash_attention at the serving shape on the design this route "
        f"replaced (the f32 kernel, bf16 inputs): {old_ms} ms per call")
    return out


# ---------------------------------------------------------------------------
# phase 12: the ssd_scan kernel against its plain version
# ---------------------------------------------------------------------------
def ssd_inputs(gen, Bz, L, H, P, N, dtype):
    """x, dt, A, B, C, D as the Mamba-2 mixer hands them to the kernel: x,
    B and C strided views of one conv output [Bz, L, H*P + 2N] (x in
    ``dtype``, B and C float32), dt [Bz, L, H] in (0.01, 0.2), A < 0."""
    wide = torch.randn((Bz, L, H * P + 2 * N), generator=gen, device="cuda")
    x = wide.to(dtype)[..., : H * P].reshape(Bz, L, H, P)
    wide = wide * 0.3
    dt = torch.rand((Bz, L, H), generator=gen, device="cuda") * 0.19 + 0.01
    A = -(torch.rand((H,), generator=gen, device="cuda") * 1.5 + 0.5)
    D = torch.randn((H,), generator=gen, device="cuda")
    return x, dt, A, wide[..., H * P: H * P + N], wide[..., H * P + N:], D


def ssd_bound(x, B, chunk: int = 64):
    """(bytes, operations, operations of C B^T) the scan must move and do
    for these inputs: x and dt read once, B and C once per batch (shared by
    the heads), A and D once, y and h_final written once; per (batch,
    head) and chunk of q rows, the causal C.B and M.x products over
    q(q+1)/2 pairs and the C.h and state products over q rows, 2
    operations per multiply-add.  The last count is the C.B part, which
    the kernels do once per batch instead of once per head."""
    Bz, L, H, P = x.shape
    N = B.shape[-1]
    nbytes = (2 * x.element_size() * Bz * L * H * P + 4 * Bz * L * H
              + 2 * 4 * Bz * L * N + 2 * 4 * H + 4 * Bz * H * N * P)
    flop = cb = 0
    for l0 in range(0, L, min(chunk, L)):
        q = min(chunk, L - l0)
        flop += 2 * (q * (q + 1) // 2 * (N + P) + 2 * q * N * P)
        cb += 2 * q * (q + 1) // 2 * N
    return nbytes, flop * Bz * H, cb * Bz * H


def cb_inputs(B, chunk: int = 64):
    """(bytes, operations) of G = C B^T per chunk: B and C read once, G
    (q x q per chunk) written once, every pair of a chunk's rows."""
    Bz, L, N = B.shape
    nbytes = flop = 0
    for l0 in range(0, L, min(chunk, L)):
        q = min(chunk, L - l0)
        nbytes += 4 * q * q
        flop += 2 * q * q * N
    return (2 * 4 * Bz * L * N + Bz * nbytes), Bz * flop


def check_ssd_scan() -> dict:
    """The kernels against their plain versions on the card: the pair
    (``ssd_scan_heads``: ``ssd_cb_kernel`` then ``ssd_scan_kernel``)
    against ``ssd_chunked`` at one Mamba2-1.3B layer's prefill of phase 13
    (8 x 2000 tokens, bf16 x, a ragged last chunk), float32 x, L = 2048,
    L = 40 < chunk, chunks 16 and 32, y within ``tol`` of its largest
    magnitude, the final state within 1e-5 of its own; ``chunk_cb`` alone
    against ``ref.chunk_cb`` at the prefill shape.  Then times both beside
    their plain versions at the prefill shape; no single PyTorch call
    computes the scan, one ``torch.matmul`` computes C B^T per chunk."""
    cfg = get_config(SSM_ARCH)
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("prefill", SLOTS, SSM_PROMPT_LEN, 64, bf16, 1e-2),
             ("float32", 2, SSM_PROMPT_LEN, 64, f32, 1e-5),
             ("L2048", 2, 2048, 64, bf16, 1e-2),
             ("short", SLOTS, 40, 64, bf16, 1e-2),
             ("chunk16", 2, 500, 16, f32, 1e-5),
             ("chunk32", 2, 500, 32, bf16, 1e-2)]
    gen = torch.Generator(device="cuda").manual_seed(17)
    errs = {}
    for name, Bz, L, chunk, dtype, tol in cases:
        x, dt, A, Bm, Cm, D = ssd_inputs(gen, Bz, L, H, P, N, dtype)
        ssd_kernel.reset_launches()
        y, h = ssd_kernel.ssd_scan_heads(x, dt, A, Bm, Cm, D, chunk=chunk,
                                         h_final=True)
        require(ssd_kernel.LAUNCHES == {"ssd_cb": 1, "ssd_scan": 1},
                f"ssd_scan {name}: launches {ssd_kernel.LAUNCHES}")
        ey, eh = ssd_ops.ssd(x, dt, A, Bm, Cm, D, impl="chunked",
                             chunk=chunk, return_state=True)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
                f"ssd_scan {name}: non-finite output")
        err_y = float((y.float() - ey.float()).abs().max())
        err_h = float((h - eh).abs().max())
        rel_y = err_y / float(ey.float().abs().max())
        rel_h = err_h / float(eh.abs().max())
        require(rel_y <= tol and rel_h <= 1e-5,
                f"ssd_scan {name} [{Bz}, {L}, {H}, {P}], N {N}, chunk "
                f"{chunk}, {dtype}: differs from its plain version by "
                f"{rel_y} (y) / {rel_h} (h_final) of the max magnitude")
        errs[name] = {"y": err_y, "h_final": err_h}
        log(f"ssd_scan {name}: x [{Bz}, {L}, {H}, {P}] {str(dtype)[6:]}, "
            f"N {N}, chunk {chunk}: max abs err y {err_y:.3g} ({rel_y:.3g} "
            f"of its max; tolerance {tol}), h_final {err_h:.3g} "
            f"({rel_h:.3g}; tolerance 1e-5)")
        del x, dt, A, Bm, Cm, D, y, h, ey, eh
    x, dt, A, Bm, Cm, D = ssd_inputs(gen, SLOTS, SSM_PROMPT_LEN, H, P, N,
                                     bf16)
    g = ssd_kernel.chunk_cb(Bm, Cm)
    eg = ssd_ref.chunk_cb(Bm, Cm)
    torch.cuda.synchronize()
    cb_err = float((g - eg).abs().max())
    cb_rel = cb_err / float(eg.abs().max())
    require(tuple(g.shape) == tuple(eg.shape) and cb_rel <= 1e-5,
            f"ssd_cb: differs from its plain version by {cb_rel} of the "
            f"max magnitude")
    log(f"ssd_cb: B/C [{SLOTS}, {SSM_PROMPT_LEN}, {N}] -> G "
        f"{list(g.shape)}: max abs err {cb_err:.3g} ({cb_rel:.3g} of its "
        f"max; tolerance 1e-5, float32 summed in another order)")
    # the library yardstick: one batched matmul over chunks padded once
    q = 64
    pad = (-SSM_PROMPT_LEN) % q
    padded = [F.pad(t, (0, 0, 0, pad)).reshape(SLOTS, -1, q, N)
              for t in (Bm, Cm)]
    nbytes, flop, cb_flop = ssd_bound(x, Bm)
    cb_bytes, cb_ops = cb_inputs(Bm)
    out = measure({
        "ssd_cb": dict(
            max_abs_err=cb_err,
            calls=lambda n: [lambda: ssd_kernel.chunk_cb(Bm, Cm)] * n,
            plain=lambda n: [lambda: ssd_ref.chunk_cb(Bm, Cm)] * n,
            library=lambda n: [lambda: torch.matmul(
                padded[1], padded[0].transpose(-1, -2))] * n,
            bound_bytes=cb_bytes, bound_flop=cb_ops,
            flop_per_s=F32_FLOP_PER_S, iters=FA_ITERS),
        "ssd_scan": dict(
            max_abs_err=max(e["y"] for e in errs.values()), case_errs=errs,
            calls=lambda n: [lambda: ssd_kernel.ssd_scan_heads(
                x, dt, A, Bm, Cm, D, h_final=True)] * n,
            plain=lambda n: [lambda: ssd_ops.ssd(
                x, dt, A, Bm, Cm, D, impl="chunked", return_state=True)] * n,
            library=None,   # no single PyTorch call computes the scan
            bound_bytes=nbytes, bound_flop=flop, iters=FA_ITERS)})
    rec = out["ssd_scan"]
    split = {("ssd_cb" if "ssd_cb_kernel" in k else "ssd_scan" if
              "ssd_scan_kernel" in k else k[:40]): us
             for k, us in rec["device_kernels_us"].items()}
    pair_us = sum(split.values())
    tc_flop = 3 * (flop - cb_flop)
    log(f"ssd_scan at the prefill shape ({smi()}): "
        f"{rec['ms'] * 1e3:.2f} us per call (event-timed "
        f"{rec['call_ms'] * 1e3:.2f} us; plain {rec['plain_ms'] * 1e3:.2f} "
        f"us), per kernel of the pair "
        + ", ".join(f"{k} {us:.2f} us ({us / pair_us:.1%})"
                    for k, us in split.items())
        + f"; {flop / 1e9:.2f} GFLOP of the plain version "
        f"({flop / BF16_FLOP_PER_S * 1e6:.1f} us at the bf16 peak, "
        f"{flop / F32_FLOP_PER_S * 1e6:.1f} us at the f32 CUDA-core peak), "
        f"{(flop - cb_flop) / 1e9:.2f} GFLOP once C B^T is per batch "
        f"({(flop - cb_flop) / (TF32_FLOP_PER_S / 3) * 1e6:.1f} us at "
        f"TF32/3, the 3xTF32 rate; {tc_flop / rec['ms'] / 1e9:.1f} TFLOP/s "
        f"of TF32 products counted as three), {nbytes / 1e6:.1f} MB "
        f"({nbytes / HBM_BYTES_PER_S * 1e6:.1f} us); bound "
        f"{rec['bound_ms'] * 1e3:.2f} us by {rec['bound_by']}")
    cb = out["ssd_cb"]
    log(f"ssd_cb at the prefill shape: {cb['ms'] * 1e3:.2f} us (plain "
        f"{cb['plain_ms'] * 1e3:.2f} us, torch.matmul "
        f"{cb['library_ms'] * 1e3:.2f} us), {cb_ops / 1e9:.3f} GFLOP, "
        f"{cb_bytes / 1e6:.1f} MB; bound {cb['bound_ms'] * 1e3:.2f} us by "
        f"{cb['bound_by']}")
    return out


# ---------------------------------------------------------------------------
# phases 11 and 13: the serving paths at full width (examples/kv_serving.py)
# ---------------------------------------------------------------------------
class PlainCalls:
    """Counts calls of a kernel's plain versions while active (the
    wrappers and ops look them up on the ``ref`` module at each call)."""

    def __init__(self, module, names):
        self.module = module
        self.calls = dict.fromkeys(names, 0)
        self._orig = {}

    def __enter__(self):
        for name in self.calls:
            fn = self._orig[name] = getattr(self.module, name)

            def counted(*a, _fn=fn, _name=name, **k):
                self.calls[_name] += 1
                return _fn(*a, **k)
            setattr(self.module, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.module, name, fn)


@contextlib.contextmanager
def naive_attention():
    """The dense model's plain path: prefill attention on the naive
    softmax."""
    yield OptFlags(attn_impl="naive")


@contextlib.contextmanager
def chunked_ssd():
    """The SSM model's plain path on the card: ``ops.ssd(impl="pallas")``
    answered by ``impl="chunked"`` (the reference's own route) while
    active."""
    kernel_route = ssd_kernel.ssd_scan_heads

    def plain(x, dt, A, B, C, D, *, chunk, h_final):
        return ssd_ops.ssd(x, dt, A, B, C, D, impl="chunked", chunk=chunk,
                           return_state=h_final)
    ssd_kernel.ssd_scan_heads = plain
    try:
        yield OptFlags()
    finally:
        ssd_kernel.ssd_scan_heads = kernel_route


@dataclasses.dataclass(frozen=True)
class ServePath:
    """One serving path: the model, its prompts, the kernel its prefill
    launches (``kernel.LAUNCHES[key]``; every one of them also under
    ``route`` where the kernel has routes, and once more under ``paired``
    where a second kernel runs before it), that kernel's plain versions
    (the first is the one the CPU runs per layer) and the plain path the
    kernel path is held to at full depth."""
    phase: int
    arch: str
    prompt_len: int
    cache_len: int
    kernel: object
    key: str
    route: str | None
    plain_module: object
    plain_names: tuple
    flags: OptFlags
    plain_path: object
    score: bool            # also hold lm_forward (scoring) to the plain path
    kernel_tag: str        # in the device names of the kernel's launches
    paired: str | None = None


SERVE_PATHS = {
    "dense": ServePath(11, SERVE_ARCH, PROMPT_LEN, CACHE_LEN, fa_kernel,
                       "flash_attention", "flash_attention_mma", fa_ref,
                       ("flash_attention_ref", "attention_ref"),
                       OptFlags(attn_impl="pallas"), naive_attention, False,
                       "flash_"),
    "ssm": ServePath(13, SSM_ARCH, SSM_PROMPT_LEN, SSM_PROMPT_LEN,
                     ssd_kernel, "ssd_scan", None, ssd_ref,
                     ("ssd_chunked", "ssd_scan_with_final_ref"), OptFlags(),
                     chunked_ssd, True, "ssd_", paired="ssd_cb"),
}


def memory_gib(device, peak: bool = False) -> str:
    if torch.device(device).type != "cuda":
        return "n/a"
    used = (torch.cuda.max_memory_allocated() if peak
            else torch.cuda.memory_allocated())
    return f"{used / 2**30:.2f}"


def rel_err(got, exp) -> float:
    got, exp = got.float().cpu(), exp.float().cpu()
    return float((got - exp).abs().max() / exp.abs().max())


def percentile(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q))


def decode_busy_share(eng: ServingEngine, batch, flags: OptFlags,
                      steps: int = 8) -> dict:
    """Wall time of one decode step (after a prefill of ``batch``) and the
    device-busy share of it: profiler device time of the same steps over
    their unprofiled wall time."""
    decode = build_decode_step(eng.cfg)
    with torch.inference_mode():
        logits, cache = api.prefill_fn(eng.cfg)(eng.weights, batch,
                                                eng.cache_len, flags)
        held = {"tok": torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None],
                "cache": cache}

        def step():
            held["tok"], held["cache"] = decode(eng.weights, held["cache"],
                                                held["tok"])
        for _ in range(2):
            step()
        sync(eng.device)
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync(eng.device)
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
        if eng.device.type != "cuda":
            return {"decode_step_ms": wall_ms, "device_busy_ms": None,
                    "busy_share": None, "device_ops": None,
                    "top_device_us": {}}
        dev_ms, kernels, count = device_time([step] * steps)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"decode_step_ms": wall_ms, "device_busy_ms": dev_ms,
            "busy_share": None if dev_ms is None else dev_ms / wall_ms,
            "device_ops": count / steps,
            "top_device_us": {k[:60]: v / steps for k, v in top}}


def prefill_split(eng: ServingEngine, batch, flags: OptFlags,
                  kernel_tag: str) -> dict:
    """Wall time of one warm prefill of ``batch`` and where its device
    time goes (torch.profiler): the path's kernel (device kernels whose
    name holds ``kernel_tag``), matrix products (cuBLAS/cuBLASLt, CUTLASS)
    and everything else."""
    def step():
        return api.prefill_fn(eng.cfg)(eng.weights, batch, eng.cache_len,
                                       flags)
    with torch.inference_mode():
        step()
        sync(eng.device)
        t0 = time.perf_counter()
        step()
        sync(eng.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        if eng.device.type != "cuda":
            return {"wall_ms": wall_ms, "device_ms": None}
        dev_ms, kernels, count = device_time([step])
    gemm_tags = ("gemm", "nvjet", "cutlass", "xmma", "cublas")
    split = {"kernel": 0.0, "matmul": 0.0, "other": 0.0}
    for name, us in kernels.items():
        low = name.lower()
        part = ("kernel" if kernel_tag in name else "matmul"
                if any(t in low for t in gemm_tags) else "other")
        split[part] += us / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "busy_share": None if dev_ms is None else dev_ms / wall_ms,
            "device_ops": count, "device_ms_by_part": split,
            "top_device_us": {k[:60]: v for k, v in top}}


def describe(cfg) -> str:
    if cfg.family == "ssm":
        return (f"d_inner {cfg.d_inner}, {cfg.ssm_heads} SSD heads of "
                f"{cfg.ssm_headdim}, state {cfg.ssm_state}, conv "
                f"{cfg.ssm_conv}")
    return f"heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}"


def serving_phase(path: ServePath, device="cuda") -> dict:
    """examples/kv_serving.py on the card at the model's full width and
    depth: the coordination store keeps model version and serving epoch,
    the engine serves 16 requests in 2 waves with prefill through the
    path's kernel, and the run is held to its outputs, its launches,
    determinism, a manual greedy loop, the plain path (and for scoring
    models lm_forward on both) and, at 2 layers, the CPU's plain
    versions."""
    cfg = get_config(path.arch)
    kernel, key, flags = path.kernel, path.key, path.flags
    name = f"serving {cfg.name}"
    coord = Coordinator(ChainConfig(n_nodes=4, num_keys=64), device=device)
    store = Store(*[x[0] for x in init_store(coord.cfg, device=device)])
    store = coord.put_host(store, MODEL_VERSION_KEY, 1)
    store = coord.put_host(store, SERVING_EPOCH_KEY, 1)
    require(coord.get_host(store, MODEL_VERSION_KEY) == 1 and
            coord.get_host(store, SERVING_EPOCH_KEY) == 1,
            f"{name}: the coordination store lost version or epoch")
    detector = FailureDetector(n_nodes=4, timeout_ticks=8)
    hedge = HedgedReadPolicy(fanout=2)

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SERVE_SEED)
    params = api.init_params(cfg, gen, device)
    eng = ServingEngine(cfg, params, slots=SLOTS, cache_len=path.cache_len,
                        flags=flags, device=device)
    sync(device)
    n_params = sum(p.numel() for p in params.parameters())
    log(f"{name} at full width: {n_params / 1e9:.3f} B params "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, {describe(cfg)}, "
        f"vocab {cfg.vocab_padded}); weights made and cast in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{memory_gib(device)} GiB; coordination "
        f"store: model_version=1, epoch=1; hedged reads target "
        f"{hedge.targets(1, coord.chains[0])}")

    rng = np.random.default_rng(SERVE_SEED)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab,
                                               path.prompt_len),
                    max_new=MAX_NEW) for i in range(N_REQUESTS)]
    sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kernel.reset_launches()
    with PlainCalls(path.plain_module, path.plain_names) as plain:
        t0 = time.perf_counter()
        done = eng.run(reqs, prompt_len=path.prompt_len)
        wall = time.perf_counter() - t0
    launches = kernel.LAUNCHES[key]
    n_waves = -(-N_REQUESTS // SLOTS)
    require(len(done) == N_REQUESTS, f"{name}: {len(done)} requests done")
    for r in done:
        require(r.output is not None and len(r.output) == MAX_NEW and
                int(r.output.min()) >= 0 and
                int(r.output.max()) < cfg.vocab_padded,
                f"{name}: request {r.rid} output {r.output}")
    require(launches == cfg.n_layers * n_waves,
            f"{name}: {launches} {key} launches, want {cfg.n_layers} x "
            f"{n_waves}")
    if path.route is not None:
        require(kernel.LAUNCHES[path.route] == launches,
                f"{name}: not every launch took the {path.route} route "
                f"({kernel.LAUNCHES})")
    if path.paired is not None:
        require(kernel.LAUNCHES[path.paired] == launches,
                f"{name}: {kernel.LAUNCHES[path.paired]} {path.paired} "
                f"launches, want one per {key} launch ({launches})")
    require(sum(plain.calls.values()) == 0,
            f"{name}: plain versions called on the kernel path "
            f"{plain.calls}")
    lat = eng.latencies_ms
    waves = []
    for w in eng.waves:
        ms = w["prefill_ms"] + w["decode_ms"]
        waves.append({**w, "decode_ms_per_token": w["decode_ms"]
                      / max(w["decode_steps"], 1),
                      "prompt_tokens_per_s": w["requests"] * path.prompt_len
                      / w["prefill_ms"] * 1e3,
                      "tokens_per_s": w["requests"] * MAX_NEW / ms * 1e3})
    card = on_card(device)
    for i, w in enumerate(waves):
        log(f"{name} wave {i} ({card}): {w['requests']} requests, prefill "
            f"{w['prefill_ms']:.3f} ms ({w['prompt_tokens_per_s']:.1f} "
            f"prompt tokens/s), decode {w['decode_ms_per_token']:.3f} ms per "
            f"token, {w['tokens_per_s']:.2f} generated tokens/s")
    peak = memory_gib(device, peak=True)
    log(f"{name} ({card}): {N_REQUESTS} requests in {wall:.3f} s, latency "
        f"p50 {percentile(lat, 50):.3f} ms p99 {percentile(lat, 99):.3f} ms; "
        f"{key} launches {launches} ({path.route or 'one'} route; all "
        f"launches {kernel.LAUNCHES}), plain calls {plain.calls}; "
        f"peak device memory {peak} GiB")

    # the same prompt twice gives the same tokens; a manual greedy loop
    # on the float32 parameters gives the engine's
    prompt = reqs[0].prompt
    r1, r2 = (eng.run([Request(rid=100 + i, prompt=prompt,
                               max_new=MAX_NEW)],
                      prompt_len=path.prompt_len)[0] for i in range(2))
    require(np.array_equal(r1.output, r2.output),
            f"{name}: the same prompt served twice differs")
    with torch.inference_mode():
        batch = {"tokens": torch.as_tensor(prompt[None], dtype=torch.int32,
                                           device=device)}
        logits, cache = api.prefill_fn(cfg)(eng.params, batch,
                                            path.cache_len, flags)
        toks = [int(torch.argmax(logits[:, -1], -1)[0])]
        for _ in range(MAX_NEW - 1):
            tok = torch.tensor([[toks[-1]]], dtype=torch.int32,
                               device=device)
            logits, cache = api.decode_fn(cfg)(eng.params, cache, tok, flags)
            toks.append(int(torch.argmax(logits[:, -1], -1)[0]))
    require(np.array_equal(r1.output, np.asarray(toks)),
            f"{name}: the manual greedy loop differs from the engine")
    del cache, logits

    # replica health, then the model rollout through the chain
    for node in range(4):
        detector.tick()
        detector.heard_from(node)
    require(detector.suspected() == [], f"{name}: a replica is suspected")
    store = coord.put_host(store, MODEL_VERSION_KEY, 2)
    require(coord.get_host(store, MODEL_VERSION_KEY) == 2,
            f"{name}: the version bump did not read back")

    # the first wave's prefill (and, for scoring, lm_forward over two of
    # its prompts) on the kernel path and on the plain path
    first = {"tokens": torch.as_tensor(
        np.stack([r.prompt for r in reqs[:SLOTS]]), dtype=torch.int32,
        device=device)}
    scored = first["tokens"][:2]
    out = {}
    with torch.inference_mode():
        kernel.reset_launches()
        lk = api.prefill_fn(cfg)(eng.weights, first, path.cache_len,
                                 flags)[0]
        out["score_launches"] = None
        if path.score:
            kernel.reset_launches()
            hk = TF.lm_forward(eng.weights, cfg, scored, flags=flags)
            out["score_launches"] = kernel.LAUNCHES[key]
            require(out["score_launches"] == cfg.n_layers and
                    (path.paired is None or
                     kernel.LAUNCHES[path.paired] == cfg.n_layers),
                    f"{name}: scoring launched {kernel.LAUNCHES}, want "
                    f"{cfg.n_layers} of {key}"
                    + ("" if path.paired is None else f" and {path.paired}"))
        with path.plain_path() as plain_flags, \
                PlainCalls(path.plain_module, path.plain_names) as plain:
            kernel.reset_launches()
            ln = api.prefill_fn(cfg)(eng.weights, first, path.cache_len,
                                     plain_flags)[0]
            hn = (TF.lm_forward(eng.weights, cfg, scored, flags=plain_flags)
                  if path.score else None)
        require(sum(kernel.LAUNCHES.values()) == 0 and
                sum(plain.calls.values()) > 0,
                f"{name}: the plain path launched {key} or called no plain "
                f"version ({plain.calls})")
    plain_err = rel_err(lk, ln)
    agree = float((lk.argmax(-1) == ln.argmax(-1)).float().sum())
    require(plain_err <= 5e-2, f"{name}: kernel-path prefill logits differ "
            f"from the plain path's by {plain_err} of their max magnitude")
    log(f"{name}: first-wave prefill logits, kernel vs plain path: max "
        f"diff {plain_err:.4g} of the max magnitude; first tokens agree on "
        f"{agree:.0f} of {SLOTS}")
    out["score_rel"] = None
    if path.score:
        out["score_rel"] = rel_err(hk, hn)
        require(out["score_rel"] <= 5e-2, f"{name}: kernel-path lm_forward "
                f"differs from the plain path's by {out['score_rel']}")
        log(f"{name}: lm_forward scoring {tuple(scored.shape)} tokens "
            f"through {out['score_launches']} {key} launches, kernel vs "
            f"plain path: max diff {out['score_rel']:.4g} of the max "
            f"magnitude")
        del hk, hn
    pre = prefill_split(eng, first, flags, path.kernel_tag)
    log(f"{name} warm prefill of {SLOTS} x {path.prompt_len} tokens "
        f"({card}): {pre['wall_ms']:.3f} ms wall, device {pre['device_ms']}"
        f" ms (busy share {pre.get('busy_share')}); device ms by part "
        f"{pre.get('device_ms_by_part')}; top device us "
        f"{pre.get('top_device_us')}")
    busy = decode_busy_share(eng, first, flags)
    log(f"{name} decode step ({card}): {busy['decode_step_ms']:.3f} ms wall"
        f", device busy {busy['device_busy_ms']} ms, busy share "
        f"{busy['busy_share']}, {busy['device_ops']} device kernels, copies "
        f"and fills per step; top device us/step {busy['top_device_us']}")
    del eng, params, lk, ln
    if device == "cuda":
        torch.cuda.empty_cache()
    reduced = serving_cpu_equality(path, device)
    paired = {} if path.paired is None else {path.paired: launches}
    return {"launches": {key: launches, **paired}, "waves": waves,
            "latency_p50_ms": percentile(lat, 50),
            "latency_p99_ms": percentile(lat, 99), "wall_s": wall,
            "peak_gib": peak, "kernel_vs_plain_rel": plain_err,
            "first_token_agree": agree, **out, "prefill": pre,
            "decode": busy,
            "reduced_cpu": reduced}


def serving_cpu_equality(path: ServePath, device="cuda") -> dict:
    """The path at full width and 2 layers: prefill and teacher-forced
    decode steps on CUDA (the kernel) and on the CPU (the plain versions)
    from the same weights; logits within 2e-2 of their largest magnitude
    (bf16 rounded in another order on each device)."""
    cfg = dataclasses.replace(get_config(path.arch),
                              n_layers=REDUCED_SERVE["n_layers"])
    gen = torch.Generator(device=device).manual_seed(SERVE_SEED + 1)
    weights = {device: TF.compute_params(api.init_params(cfg, gen, device),
                                         cfg)}
    weights["cpu"] = TF.compute_params(weights[device], cfg, "cpu")
    rng = np.random.default_rng(SERVE_SEED + 1)
    B, S = REDUCED_SERVE["requests"], REDUCED_SERVE["prompt_len"]
    toks = rng.integers(0, cfg.vocab, (B, S))
    logits, forced = {}, None
    for dev in ("cpu", device):
        t0 = time.perf_counter()
        path.kernel.reset_launches()
        with PlainCalls(path.plain_module, path.plain_names) as plain, \
                torch.inference_mode():
            lg, cache = api.prefill_fn(cfg)(
                weights[dev], {"tokens": torch.as_tensor(
                    toks, dtype=torch.int32, device=dev)}, S + 8, path.flags)
            out = [lg]
            if forced is None:
                forced = torch.argmax(lg[:, -1], -1).to(torch.int32)
            tok = forced[:, None].to(dev)
            for _ in range(REDUCED_SERVE["steps"]):
                lg, cache = api.decode_fn(cfg)(weights[dev], cache, tok,
                                               path.flags)
                out.append(lg)
        logits[dev] = [x.cpu() for x in out]
        want = (0, 1) if dev == "cpu" else (cfg.n_layers, 0)
        got = (path.kernel.LAUNCHES[path.key],
               plain.calls[path.plain_names[0]] // cfg.n_layers)
        require(got == want, f"serving {cfg.name} reduced on {dev}: "
                f"(launches, plain calls per layer) {got}, want {want}")
        log(f"serving {cfg.name} reduced ({on_card(dev)}): {cfg.n_layers} "
            f"layers, {B} x {S} prompt + {REDUCED_SERVE['steps']} decode "
            f"steps in {time.perf_counter() - t0:.3f} s")
    errs = [rel_err(c, p) for c, p in zip(logits[device], logits["cpu"])]
    require(max(errs) <= 2e-2, f"serving {cfg.name} reduced: CUDA logits "
            f"differ from the CPU's by {errs} of their max magnitude")
    log(f"serving {cfg.name} reduced: CUDA (kernel) vs CPU (plain) logits, "
        f"relative max diff per step {[f'{e:.3g}' for e in errs]}")
    return {"rel_errs": errs}


def f32_route_serving(device="cuda") -> dict:
    """The f32 route's own path: Qwen2.5-3B served in float32 compute
    (``compute_dtype="float32"``) at full width and 2 layers, where every
    prefill attention takes the f32 kernel; the launch counters are zeroed
    just before the serving run and read just after.  Held to the same run
    on the CPU's plain versions: prefill logits within 1e-4 of their max
    magnitude (float32 summed in another order; tests/test_torch_cuda.py's
    limit) and the tokens."""
    cfg = dataclasses.replace(get_config(SERVE_ARCH),
                              n_layers=REDUCED_SERVE["n_layers"],
                              compute_dtype="float32")
    params = api.init_params(
        cfg, torch.Generator(device=device).manual_seed(SERVE_SEED + 2),
        device)
    rng = np.random.default_rng(SERVE_SEED + 2)
    B, S = REDUCED_SERVE["requests"], REDUCED_SERVE["prompt_len"]
    prompts = [rng.integers(0, cfg.vocab, S) for _ in range(B)]
    flags = OptFlags(attn_impl="pallas")
    tokens, logits = {}, {}
    for dev in (device, "cpu"):
        eng = ServingEngine(cfg, params, slots=B, cache_len=S + 8,
                            flags=flags, device=dev)
        sync(dev)
        fa_kernel.reset_launches()
        done = eng.run([Request(rid=i, prompt=pr,
                                max_new=REDUCED_SERVE["steps"])
                        for i, pr in enumerate(prompts)], prompt_len=S)
        got = dict(fa_kernel.LAUNCHES)
        want = cfg.n_layers if dev == device else 0
        require(got["flash_attention_f32"] == want and
                got["flash_attention"] == want,
                f"f32-route serving on {dev}: launches {got}, want {want} "
                "on the f32 route")
        if dev == device:
            launches = got["flash_attention_f32"]
        tokens[dev] = np.stack([r.output for r in done])
        with torch.inference_mode():
            toks = torch.as_tensor(np.stack(prompts), dtype=torch.int32,
                                   device=dev)
            logits[dev] = api.prefill_fn(cfg)(
                eng.weights, {"tokens": toks}, S + 8, flags)[0].cpu()
        del eng
    rel = rel_err(logits[device], logits["cpu"])
    same = bool(np.array_equal(tokens[device], tokens["cpu"]))
    require(rel <= 1e-4, f"f32-route serving: CUDA prefill logits differ "
            f"from the CPU's by {rel} of their max magnitude")
    require(same, f"f32-route serving: CUDA tokens {tokens[device]} differ "
            f"from the CPU's {tokens['cpu']}")
    log(f"serving {cfg.name} in float32 compute ({on_card(device)}): "
        f"{cfg.n_layers} layers, {B} x {S} prompt, "
        f"{REDUCED_SERVE['steps']} new tokens each; {launches} launches, "
        f"all on the f32 route; prefill logits vs CPU {rel:.3g} of the max "
        f"magnitude; tokens equal the CPU's")
    return {"launches": {"flash_attention_f32": launches}, "rel_err": rel}


# ---------------------------------------------------------------------------
# phase 14: cross-chain transactions at full width (fig_txn_pipeline's
# proportions at phase 7's cluster)
# ---------------------------------------------------------------------------
def txn_sim(cl: ClusterConfig, device, wave: bool = True) -> ChainSim:
    return ChainSim(cl, inject_capacity=INJECT, route_capacity=ROUTE,
                    reply_capacity=TXN_REPLY_CAPACITY,
                    wave_depth=WAVE_DEPTH if wave else 0,
                    wave_keys=WAVE_KEYS, wave_log_capacity=WAVE_LOG,
                    device=device)


def txn_mix(cl: ClusterConfig, name: str) -> list:
    return make_txn_workload(cl, TxnWorkloadConfig(**TXN_COMMON,
                                                   **TXN_MIXES[name]))


def same_tree(a, b, what: str) -> None:
    """Exact equality of two same-structured NamedTuples of tensors (the
    second may live on another device)."""
    if hasattr(a, "_fields"):
        for f in a._fields:
            same_tree(getattr(a, f), getattr(b, f), f"{what}.{f}")
        return
    require(torch.equal(a, b.to(a.device)), f"{what} differs")


def check_txn_run(cl, co, sim, state, txns, results, what: str) -> dict:
    """After a drain: locks, dirty versions, wave slots and the fabric
    empty, nothing dropped or NACKed, one result per transaction, the
    committed writes atomic and serializable, and every global key equal
    to the serial replay of the committed subset, in ``committed_view``
    and read back through ``partitioned_read_batch`` in one launch."""
    m = state.metrics.asdict()
    require(txn_lib.locks_all_free(state.locks), f"{what}: a lock leaked")
    require(int(state.stores.pending.sum()) == 0,
            f"{what}: dirty versions left after the drain")
    require(Coordinator.waves_drained(state), f"{what}: a wave slot is busy")
    require(sim.inflight(state) == 0, f"{what}: ops left in flight")
    require(m["drops"] == 0, f"{what}: {m['drops']} drops")
    require(m["write_nacks"] == 0,
            f"{what}: {m['write_nacks']} write NACKs (the version window "
            "overflowed: num_versions is below the in-flight write depth)")
    by_id = {t.txn_id: t for t in txns}
    require(len(results) == len(txns) and
            sorted(r.txn_id for r in results) == sorted(by_id),
            f"{what}: {len(results)} results for {len(txns)} transactions")
    committed = {r.txn_id for r in results if r.committed}
    for r in results:
        if r.committed:
            require(set(r.write_seqs) == {k for k, _ in
                                          by_id[r.txn_id].writes},
                    f"{what}: txn {r.txn_id} committed a part of its writes")
            require(min(r.write_seqs.values(), default=0) >= 0,
                    f"{what}: txn {r.txn_id} has a NACKed write (the version "
                    "window is below the in-flight write depth)")
    order = serial_order(results)       # raises on a precedence cycle
    tail = [t for t in sorted(committed) if t not in set(order)]
    expected = reference_execute([by_id[t] for t in order + tail])
    G = cl.num_global_keys
    dev = state.stores.values.device
    exp_t = torch.tensor([expected.get(g, 0) for g in range(G)],
                         dtype=torch.int32, device=dev)
    view = txn_lib.committed_view(cl, state)
    require(sorted(view) == list(range(G)),
            f"{what}: committed_view does not cover the key space")
    require(torch.equal(torch.tensor([view[g] for g in range(G)],
                                     dtype=torch.int32, device=dev), exp_t),
            f"{what}: committed_view differs from the serial replay")
    before = kv_kernel.LAUNCHES["kv_bucketed_read"]
    rv, dec = read_back(cl, state, co.partition_map())
    require(kv_kernel.LAUNCHES["kv_bucketed_read"] - before ==
            (1 if dev.type == "cuda" else 0),
            f"{what}: the read-back was not one launch")
    require(bool((dec == 0).all()), f"{what}: a read-back was not clean")
    require(torch.equal(rv[:, 0], exp_t),
            f"{what}: read-back differs from the serial replay")
    return m


def launch_check(launches: dict, ticks: int, plain: dict, what: str):
    require(launches == {"kv_read": ticks, "kv_write": ticks,
                         "kv_bucketed_read": 0, "kv_bucketed_write": 0},
            f"{what}: launches {launches} over {ticks} ticks")
    require(not any(plain.values()), f"{what}: plain-version calls {plain}")


def wave_run(cl, txns, device, what: str):
    """``txns`` through ``TxnWaveDriver`` on a fresh wave engine, the
    launch counters zeroed just before the run and read just after; then
    a drain of 4n ticks and the checks.  Returns the run's record."""
    sim = txn_sim(cl, device)
    co = Coordinator(cl, device=device)
    drv = TxnWaveDriver(sim, co.txn_planner)
    state = sim.init_state()
    sync(device)
    kv_kernel.reset_launches()
    with PlainCalls(kv_ref, KV_PLAIN) as plain:
        t0 = time.perf_counter()
        state, results = drv.run(state, txns, step_ticks=STEP_TICKS)
        sync(device)
        wall = time.perf_counter() - t0
    launches = dict(kv_kernel.LAUNCHES)
    if torch.device(device).type == "cuda":
        launch_check(launches, drv.last_ticks, plain.calls, what)
    state = sim.drain(state, 4 * N_NODES)
    m = check_txn_run(cl, co, sim, state, txns, results, what)
    commits = sum(r.committed for r in results)
    require(m["wave_commits"] == commits and
            m["wave_commits"] + m["wave_aborts"] == len(txns),
            f"{what}: wave counters {m['wave_commits']}/{m['wave_aborts']} "
            f"for {commits} commits of {len(txns)}")
    rec = {"txns": len(txns), "commits": commits,
           "aborts": len(txns) - commits, "ticks": drv.last_ticks,
           "rounds": drv.last_rounds,
           "commits_per_tick": commits / drv.last_ticks,
           "rounds_per_commit": drv.last_rounds / max(commits, 1),
           "expired": sum(r.mode == "wave_expired" for r in results),
           "lock_conflicts": m["lock_conflicts"],
           "mean_occupancy": m["wave_occupancy"] / drv.last_ticks,
           "wall_s": wall, "wall_us_per_tick": wall / drv.last_ticks * 1e6,
           "launches": launches}
    log(f"transactions {what} ({on_card(device)}): {len(txns)} txns, "
        f"{commits} commits, {rec['aborts']} aborts ({rec['expired']} "
        f"lease-expired), {drv.last_ticks} ticks, "
        f"{rec['commits_per_tick']:.4f} commits/tick, {drv.last_rounds} "
        f"admission rounds ({rec['rounds_per_commit']:.4f} per commit), "
        f"mean occupancy {rec['mean_occupancy']:.2f} of "
        f"{N_CHAINS * WAVE_DEPTH} slots, lock_conflicts "
        f"{m['lock_conflicts']}; wall {wall:.3f} s "
        f"({rec['wall_us_per_tick']:.1f} us per wave tick, admission "
        f"included); launches {launches}; after a {4 * N_NODES}-tick "
        f"drain: locks free, waves drained, 0 drops, 0 write NACKs, "
        f"serializable, all {cl.num_global_keys} global keys == serial "
        f"replay (committed_view and one-launch read-back)")
    return rec


def host_run(cl, txns, device="cuda") -> dict:
    """fig_txn_pipeline's host baseline: ``TxnDriver`` one wave of 6 at a
    time on the cluster without a wave table; its ticks are the run's and
    the 4n-tick drain's, as fig_txn_pipeline counts them."""
    sim = txn_sim(cl, device, wave=False)
    co = Coordinator(cl, device=device)
    drv = TxnDriver(sim, co.txn_planner)
    state, results = sim.init_state(), []
    sync(device)
    kv_kernel.reset_launches()
    with PlainCalls(kv_ref, KV_PLAIN) as plain:
        t0 = time.perf_counter()
        for i in range(0, len(txns), HOST_WAVE):
            state, res = drv.run(state, txns[i:i + HOST_WAVE])
            results += res
        sync(device)
        wall = time.perf_counter() - t0
    ticks_run = int(state.t)
    if torch.device(device).type == "cuda":
        launch_check(dict(kv_kernel.LAUNCHES), ticks_run, plain.calls,
                     "host driver")
    state = sim.drain(state, 4 * N_NODES)
    ticks = int(state.t)
    check_txn_run(cl, co, sim, state, txns, results, "host driver")
    commits = sum(r.committed for r in results)
    rounds = 2 * ((len(txns) + HOST_WAVE - 1) // HOST_WAVE)
    log(f"transactions host driver ({on_card(device)}): {len(txns)} txns "
        f"of k2_uniform in waves of {HOST_WAVE}, {commits} commits, "
        f"{ticks} ticks ({ticks_run} in the waves), "
        f"{commits / ticks:.4f} commits/tick, {rounds} host barriers "
        f"({rounds / max(commits, 1):.4f} per commit); wall {wall:.3f} s "
        f"({wall / ticks_run * 1e6:.1f} us per tick)")
    return {"txns": len(txns), "commits": commits, "ticks": ticks,
            "commits_per_tick": commits / ticks, "wall_s": wall,
            "wall_us_per_tick": wall / ticks_run * 1e6}


def txn_tick_costs(cl, txns, device="cuda") -> dict:
    """µs and device activities per tick of the wave engine with every
    slot it can fill busy, beside the same cluster's wave-less tick; and
    the coordinator stage's own activities and device time (its step and
    both cluster routes, called alone on the inputs one tick gave them)."""
    wave_sim, plain_sim = txn_sim(cl, device), txn_sim(cl, device, False)
    drv = TxnWaveDriver(wave_sim, Coordinator(cl, device=device).txn_planner)
    queue = [drv._plan(t) for t in txns[:N_CHAINS * WAVE_DEPTH * 2]]
    out = {}
    for name, sim in (("wave", wave_sim), ("wave-less", plain_sim)):
        state = sim.init_state()
        if sim.wave_depth:
            state, n = drv._admit(state, queue,
                                  state.wave.phase.cpu().numpy(), 0)
        empty = sim.empty_injection()
        state = sim.drain(state, 2)                   # warm-up
        sync(device)
        t0 = time.perf_counter()
        state = sim.drain(state, 8)
        sync(device)
        us = (time.perf_counter() - t0) / 8 * 1e6
        box = [state]

        def one_tick():
            box[0] = sim.tick(box[0], empty)
        dev_ms, _, n_act = device_time([one_tick] * PROFILED_TICKS)
        out[name] = {"us_per_tick": us,
                     "activities_per_tick": (n_act / PROFILED_TICKS
                                             if n_act else None),
                     "device_us_per_tick": (dev_ms * 1e3
                                            if dev_ms is not None else None)}
    # the coordinator stage alone, on the inputs of one busy tick
    state = wave_sim.init_state()
    state, _ = drv._admit(state, [drv._plan(t) for t in txns[:256]],
                          state.wave.phase.cpu().numpy(), 0)
    state = wave_sim.drain(state, 1)
    seen = []
    route, step = t_chain.cluster_route, txn_lib.wave_coordinator_step

    def keep(fn):
        def wrapped(*a, **k):
            seen.append((fn, a, k))
            return fn(*a, **k)
        return wrapped
    t_chain.cluster_route = keep(route)
    txn_lib.wave_coordinator_step = keep(step)
    try:
        wave_sim.tick(state, wave_sim.empty_injection())
    finally:
        t_chain.cluster_route, txn_lib.wave_coordinator_step = route, step
    require(len(seen) == 3, f"coordinator stage calls {len(seen)}")
    # the step reads its inputs only, so its replays see the same table
    calls = [lambda fn=fn, a=a, k=k: fn(*a, **k) for fn, a, k in seen]
    dev_ms, _, n_act = device_time(calls * PROFILED_TICKS)
    stage = {"activities_per_tick": (n_act / PROFILED_TICKS
                                     if n_act else None),
             "device_us_per_tick": (dev_ms * 1e3 * len(calls)
                                    if dev_ms is not None else None)}
    out["coordinator_stage"] = stage
    w, p = out["wave"], out["wave-less"]
    fmt = lambda x, f=".2f": "not measured" if x is None else format(x, f)
    log(f"transactions ({on_card(device)}): wave tick "
        f"{w['us_per_tick']:.1f} us wall (a full table admitted before the "
        f"timed ticks), {fmt(w['activities_per_tick'])} device "
        f"activities and {fmt(w['device_us_per_tick'], '.1f')} us of device "
        f"time a tick; the same cluster's wave-less tick "
        f"{p['us_per_tick']:.1f} us, {fmt(p['activities_per_tick'])} "
        f"activities, {fmt(p['device_us_per_tick'], '.1f')} us; the "
        f"coordinator stage (step and both cluster routes) "
        f"{fmt(stage['activities_per_tick'])} activities and "
        f"{fmt(stage['device_us_per_tick'], '.1f')} us of device time a "
        "tick")
    return out


def txn_cpu_equality(cl, txns, device="cuda") -> None:
    """The first transactions of k2_uniform on CUDA (kernels) and on the
    CPU (plain versions): identical results, stores, wave tables (the
    completion log included), locks, metrics, reply logs and inboxes."""
    out = {}
    for dev in (device, "cpu"):
        sim = txn_sim(cl, dev)
        drv = TxnWaveDriver(sim, Coordinator(cl, device=dev).txn_planner)
        t0 = time.perf_counter()
        state, results = drv.run(sim.init_state(), txns,
                                 step_ticks=STEP_TICKS)
        sync(dev)
        log(f"transactions ({on_card(dev)}): {len(txns)} txns of "
            f"k2_uniform in {drv.last_ticks} ticks on {dev} in "
            f"{time.perf_counter() - t0:.3f} s")
        out[dev] = (state, results, drv.last_rounds)
    require(out[device][1] == out["cpu"][1] and
            out[device][2] == out["cpu"][2],
            "transactions: CUDA and CPU results differ")
    for name in ("stores", "wave", "locks", "metrics", "replies", "inbox",
                 "t"):
        same_tree(getattr(out["cpu"][0], name), getattr(out[device][0], name),
                  f"transactions: CUDA vs CPU {name}")
    log(f"transactions: CUDA run == CPU plain run over {len(txns)} txns "
        "(results, stores, wave table and completion log, locks, metrics, "
        "reply logs, inboxes)")


def txn_phase() -> dict:
    cl = cluster("netcraq", partitioned=True)
    t0 = time.perf_counter()
    mixes = {name: txn_mix(cl, name) for name in TXN_MIXES}
    out = {}
    for name, txns in mixes.items():
        out[name] = wave_run(cl, txns, "cuda", name)
    out["host"] = host_run(cl, mixes["k2_uniform"][:HOST_TXNS])
    out["costs"] = txn_tick_costs(cl, mixes["k2_uniform"])
    txn_cpu_equality(cl, mixes["k2_uniform"][:CPU_TXNS])
    out["seconds"] = time.perf_counter() - t0
    k2, host = out["k2_uniform"], out["host"]
    log(f"transactions ({smi()}): k2_uniform wave "
        f"{k2['commits_per_tick']:.4f} commits/tick against the host "
        f"driver's {host['commits_per_tick']:.4f} "
        f"({k2['commits_per_tick'] / host['commits_per_tick']:.2f}x); "
        f"phase 14 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: open-loop load on phase 7's cluster (benchmarks/fig_hockey.py's
# sweep, its lane, backlog and load ratios at full width)
# ---------------------------------------------------------------------------
# lane capacity C * n * c_in = 2,048 ops a tick; fig_hockey draws twice
# that many candidate lanes and backlogs four times that many arrivals
OL_CAPACITY = N_CHAINS * N_NODES * INJECT
OL_WIDTH, OL_BACKLOG, OL_REPLY = 2 * OL_CAPACITY, 4 * OL_CAPACITY, 16384
OL_SHARES = (0.125, 0.25, 0.5, 0.75, 1.0, 1.5)
# two of fig_hockey's six scenarios; both gate on the write class, whose
# lanes (the chain head's) saturate first
OL_SCENARIOS = {
    "uniform_write": dict(write_fraction=0.5),
    "zipf_txn": dict(write_fraction=0.25, txn_fraction=0.25,
                     key_skew="zipf", zipf_a=1.2),
}
OL_GATE = "write"
OL_TICKS, OL_DRAIN = 64, 32
# the two-shot client leaves the PREPAREs of the last generated tick (and,
# under overload, PREPAREs admitted behind their own COMMIT) holding
# locks; a lease shorter than the drain reclaims them
OL_LEASE = 16
# one run of >= 1,000,000 client ops; 8 x 16,384 reply-log rows overflow
HEADLINE = dict(qps=float(OL_CAPACITY), write_fraction=0.1, ticks=512)
HEADLINE_OPS = 1_000_000
OL_CPU_TICKS, OL_PROFILED, OL_SYNC_TICKS = 8, 4, 4
QS = (50.0, 99.0, 99.9)


def ol_sim(device) -> ChainSim:
    """Phase 7's cluster with the default telemetry plane."""
    return ChainSim(cluster("netcraq", partitioned=True),
                    inject_capacity=INJECT, route_capacity=ROUTE,
                    reply_capacity=OL_REPLY, device=device)


def ol_state(sim: ChainSim):
    state = sim.init_state()
    return state._replace(locks=txn_lib.set_lease(state.locks, OL_LEASE))


def ol_gen(sim: ChainSim, qps: float, mix: dict, device):
    return loadgen_lib.make_loadgen(sim.cluster, qps=qps,
                                    backlog_capacity=OL_BACKLOG,
                                    device=device, **mix)


class Refusals:
    """Counts, on the device, the writes a node's version window refused
    (``cluster_write_batch``'s active lanes it did not accept): NetCRAQ
    drops such a write without a reply, so it closes the conservation
    identity offered = replies + shed + deferred + refused."""

    def __init__(self, device):
        self.count = torch.zeros((), dtype=torch.int64, device=device)

    def __enter__(self):
        self._orig = fn = kv_ops.cluster_write_batch

        def counted(store, keys, wvals, wseqs, active, **kw):
            store, accepted = fn(store, keys, wvals, wseqs, active, **kw)
            self.count += (active.to(torch.bool) & ~accepted).sum()
            return store, accepted
        kv_ops.cluster_write_batch = counted
        return self

    def __exit__(self, *exc):
        kv_ops.cluster_write_batch = self._orig


def ol_run(sim: ChainSim, gen, ticks: int, device, what: str):
    """One open-loop run from a fresh state and an empty backlog: the
    launch counters zeroed just before and read just after; then exact
    conservation, the drain, free locks and histogram/reply-log bucket
    parity (while the log did not overflow).  Returns (state, gen,
    record)."""
    state, gen = ol_state(sim), loadgen_lib.reset(gen)
    sync(device)
    kv_kernel.reset_launches()
    with PlainCalls(kv_ref, KV_PLAIN) as plain, Refusals(device) as ref:
        t0 = time.perf_counter()
        state, gen = sim.run_openloop(state, gen, ticks,
                                      arrival_width=OL_WIDTH,
                                      extra_ticks=OL_DRAIN)
        sync(device)
        wall = time.perf_counter() - t0
    launches = dict(kv_kernel.LAUNCHES)
    if torch.device(device).type == "cuda":
        launch_check(launches, ticks + OL_DRAIN, plain.calls, what)
    m = state.metrics.asdict()
    deferred = int((gen.backlog.op != OP_NOP).sum())
    delivered = int(state.replies.cursor.sum() + state.replies.lost.sum())
    refused = int(ref.count)
    require(m["offered"] == delivered + m["admission_drops"] + deferred
            + refused,
            f"{what}: offered {m['offered']} != replies {delivered} + shed "
            f"{m['admission_drops']} + deferred {deferred} + refused "
            f"{refused}")
    require(m["drops"] == 0, f"{what}: {m['drops']} fabric drops")
    require(sim.inflight(state) == 0, f"{what}: ops left in flight")
    require(txn_lib.locks_all_free(state.locks),
            f"{what}: a lock is held after the drain")
    # raises where the histogram and an unbroken reply log disagree
    pct, _, overflowed = tail_percentiles(state, None, qs=QS)
    pct = {c: None if e is None else {q: r["ticks"] for q, r in e.items()}
           for c, e in pct.items()}
    rec = {"offered": m["offered"], "delivered": delivered,
           "shed": m["admission_drops"], "deferred": deferred,
           "refused": refused, "lease_expiries": m["lease_expiries"],
           "log_overflowed": overflowed, "pct_ticks": pct,
           "wall_us_per_tick": wall / (ticks + OL_DRAIN) * 1e6,
           "launches": launches}
    per = lambda k: rec[k] / ticks
    tails = "; ".join(
        f"{c} " + ("-" if e is None else "/".join(map(str, e.values())))
        for c, e in pct.items())
    source = ("histogram only (log overflowed)" if overflowed
              else "histogram == reply log buckets")
    log(f"open loop {what} ({on_card(device)}): per tick offered "
        f"{per('offered'):.2f}, delivered {per('delivered'):.2f}, shed "
        f"{per('shed'):.2f} ({deferred} deferred, {refused} refused by "
        f"the version window, {m['lease_expiries']} lease expiries); "
        f"ticks p50/p99/p999 {tails}; {source}; "
        f"{rec['wall_us_per_tick']:.1f} us/tick wall over {ticks} + "
        f"{OL_DRAIN} ticks; launches {launches}")
    return state, gen, rec


def ol_sweep(device="cuda") -> dict:
    """fig_hockey's sweep: every scenario at every load share, each point
    from a fresh state; the gate class's p50 rises monotonically up to
    the knee (the first point that sheds), and some point sheds."""
    sim = ol_sim(device)
    out = {}
    for name, mix in OL_SCENARIOS.items():
        gen = ol_gen(sim, 1.0, mix, device)
        curve = []
        for share in OL_SHARES:
            qps = share * OL_CAPACITY
            gen = gen._replace(qps=torch.full((), qps, dtype=torch.float32,
                                              device=device))
            _, gen, rec = ol_run(sim, gen, OL_TICKS, device,
                                 f"{name} at {share:g} of capacity")
            curve.append({"qps": qps, "share": share, **rec})
        knee = next((i for i, r in enumerate(curve) if r["shed"] > 0), None)
        require(knee is not None, f"{name}: no point sheds")
        p50 = [r["pct_ticks"][OL_GATE]["p50"] for r in curve[:knee + 1]]
        require(all(a <= b for a, b in zip(p50, p50[1:])),
                f"{name}: {OL_GATE} p50 not monotone up to the knee: {p50}")
        out[name] = {"points": curve, "knee_qps": curve[knee]["qps"]}
        log(f"open loop {name}: knee (first shed) at qps "
            f"{curve[knee]['qps']:g} of capacity {OL_CAPACITY}; {OL_GATE} "
            f"p50 up to it {p50}")
    return out


def ol_headline(device="cuda") -> dict:
    """One run of >= 1,000,000 client ops whose reply log overflows, so
    its percentiles come from the histogram alone; then every global
    key read back through ``partitioned_read_batch`` in one launch."""
    sim = ol_sim(device)
    gen = ol_gen(sim, HEADLINE["qps"],
                 dict(write_fraction=HEADLINE["write_fraction"]), device)
    state, gen, rec = ol_run(sim, gen, HEADLINE["ticks"], device,
                             "headline")
    require(rec["offered"] >= HEADLINE_OPS,
            f"headline offered only {rec['offered']} ops")
    require(rec["log_overflowed"], "headline: the reply log did not overflow")
    cl = sim.cluster
    before = kv_kernel.LAUNCHES["kv_bucketed_read"]
    rv, dec = read_back(cl, state, state.pmap)
    require(kv_kernel.LAUNCHES["kv_bucketed_read"] - before ==
            (1 if torch.device(device).type == "cuda" else 0),
            "headline: the read-back was not one launch")
    require(bool((dec == 0).all()), "headline: a read-back was not clean")
    view = txn_lib.committed_view(cl, state)
    view_t = torch.tensor([view[g] for g in range(cl.num_global_keys)],
                          dtype=torch.int32, device=rv.device)
    require(torch.equal(rv[:, 0], view_t),
            "headline: read-back differs from committed_view")
    wall_s = rec["wall_us_per_tick"] * (HEADLINE["ticks"] + OL_DRAIN) / 1e6
    log(f"open loop headline ({smi()}): {rec['offered']:,} client ops in "
        f"{wall_s:.2f} s ({rec['offered'] / wall_s:,.0f} offered ops/s "
        f"wall), all {cl.num_global_keys} global keys read back in one "
        "launch == committed_view")
    return {**rec, "wall_s": wall_s}


def ol_cpu_equality(device="cuda") -> None:
    """``zipf_txn`` at 3/2 of capacity for a few ticks on CUDA and on the
    CPU: identical stores, metrics, reply logs, telemetry leaves, locks,
    inboxes and generator backlogs."""
    out = {}
    for dev in (device, "cpu"):
        sim = ol_sim(dev)
        gen = ol_gen(sim, 1.5 * OL_CAPACITY, OL_SCENARIOS["zipf_txn"], dev)
        t0 = time.perf_counter()
        out[dev] = sim.run_openloop(ol_state(sim), gen, OL_CPU_TICKS,
                                    arrival_width=OL_WIDTH, extra_ticks=0)
        sync(dev)
        log(f"open loop ({on_card(dev)}): {OL_CPU_TICKS} ticks of zipf_txn "
            f"at 1.5x capacity on {dev} in {time.perf_counter() - t0:.3f} s")
    (cpu, cpu_gen), (gpu, gpu_gen) = out["cpu"], out[device]
    for name in ("stores", "metrics", "replies", "telemetry", "locks",
                 "inbox", "t"):
        same_tree(getattr(cpu, name), getattr(gpu, name),
                  f"open loop: CUDA vs CPU {name}")
    same_tree(cpu_gen.backlog, gpu_gen.backlog, "open loop: CUDA vs CPU "
              "backlog")
    log(f"open loop: CUDA run == CPU plain run over {OL_CPU_TICKS} ticks "
        f"(stores, metrics, reply logs, telemetry, locks, inboxes, "
        f"backlog of {int((cpu_gen.backlog.op != OP_NOP).sum())})")


def tick_cost(step, n: int) -> dict:
    """Wall µs a step over ``n`` steps after one warm-up, then device
    activities and busy µs a step over ``OL_PROFILED`` profiled steps,
    and the device's idle share of the unprofiled step."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / n * 1e6
    dev_ms, _, n_act = device_time([step] * OL_PROFILED)
    busy = None if dev_ms is None else dev_ms * 1e3
    # against the unprofiled wall time: the profiler slows the host
    return {"us_per_tick": us,
            "activities_per_tick": n_act / OL_PROFILED if n_act else None,
            "device_busy_us_per_tick": busy,
            "idle_share": None if busy is None else 1 - busy / us}


def count_syncs(fn) -> int:
    """Host syncs ``fn`` makes on the card, as the sync debug mode flags
    them (each synchronizing CUDA call warns once)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def ol_costs(device="cuda") -> dict:
    """An open-loop tick's wall time, device activities and busy share at
    half of capacity; phase 5's tick with the telemetry plane on beside
    it off; the host syncs inside an open-loop window and inside
    ``gen_tick`` alone (which must make none)."""
    fmt = lambda x, f=".2f": "not measured" if x is None else format(x, f)
    sim = ol_sim(device)
    gen = ol_gen(sim, 0.5 * OL_CAPACITY, OL_SCENARIOS["uniform_write"],
                 device)
    box = [ol_state(sim), gen]

    def ol_step():
        box[0], box[1] = sim.run_openloop(box[0], box[1], 1,
                                          arrival_width=OL_WIDTH,
                                          extra_ticks=0)
    out = {"openloop": tick_cost(ol_step, 16)}
    gen_box = [box[1]]

    def gen_step():
        _, gen_box[0], _, _ = loadgen_lib.gen_tick(
            gen_box[0], sim.cluster, OL_WIDTH, INJECT, box[0].t)
    out["gen_tick"] = tick_cost(gen_step, 16)
    out["syncs_window"] = count_syncs(
        lambda: [ol_step() for _ in range(OL_SYNC_TICKS)])
    out["syncs_gen_tick"] = count_syncs(
        lambda: [gen_step() for _ in range(OL_SYNC_TICKS)])
    require(out["syncs_gen_tick"] == 0,
            f"gen_tick synced the host {out['syncs_gen_tick']} times")
    cl = cluster("netcraq")
    sched = schedule(cl, WORKLOAD["ticks"], device)
    for tel in (False, True):
        psim = ChainSim(cl, inject_capacity=INJECT, route_capacity=ROUTE,
                        telemetry=tel, device=device)
        pbox, i = [psim.init_state()], [0]

        def p5_step():
            pbox[0] = psim.tick(pbox[0], tree_map(
                lambda x: x[i[0] % WORKLOAD["ticks"]], sched))
            i[0] += 1
        out[f"phase5_telemetry_{tel}"] = tick_cost(p5_step,
                                                    WORKLOAD["ticks"])
    o, g = out["openloop"], out["gen_tick"]
    log(f"open loop ({smi()}): a tick at 0.5 of capacity "
        f"(uniform_write, generation included) {o['us_per_tick']:.1f} us "
        f"wall, {fmt(o['activities_per_tick'])} device activities, device "
        f"busy {fmt(o['device_busy_us_per_tick'], '.1f')} us (idle share "
        f"{fmt(o['idle_share'], '.4f')}); gen_tick alone "
        f"{g['us_per_tick']:.1f} us, {fmt(g['activities_per_tick'])} "
        f"activities, {fmt(g['device_busy_us_per_tick'], '.1f')} us busy; "
        f"host syncs in {OL_SYNC_TICKS} open-loop ticks "
        f"{out['syncs_window']}, in {OL_SYNC_TICKS} gen_tick calls "
        f"{out['syncs_gen_tick']}")
    off, on = out["phase5_telemetry_False"], out["phase5_telemetry_True"]
    log(f"phase 5's tick ({smi()}): telemetry=False {off['us_per_tick']:.1f}"
        f" us wall, {fmt(off['activities_per_tick'])} device activities, "
        f"{fmt(off['device_busy_us_per_tick'], '.1f')} us busy; "
        f"telemetry=True {on['us_per_tick']:.1f} us, "
        f"{fmt(on['activities_per_tick'])} activities, "
        f"{fmt(on['device_busy_us_per_tick'], '.1f')} us busy")
    return out


def profiler_windows(n: int = 12) -> dict:
    """How many of 4 one-kernel calls' device records each of ``n``
    profiler windows keeps at this point of the process (the windows of a
    few short calls that a long process loses; PERF.md section 7)."""
    x = torch.zeros(1, device="cuda")
    kept = [device_time([lambda: x.add_(1)] * 4)[2] for _ in range(n)]
    out = {"process_s": time.perf_counter() - T_START, "kept_of_4": kept}
    log(f"profiler windows at {out['process_s']:.0f} s into the process: "
        f"records kept of 4 per window {kept}")
    return out


def openloop_phase() -> dict:
    t0 = time.perf_counter()
    out = {"sweep": ol_sweep(), "headline": ol_headline()}
    ol_cpu_equality()
    out["costs"] = ol_costs()
    out["profiler_windows"] = profiler_windows()
    out["seconds"] = time.perf_counter() - t0
    log(f"open loop: phase 15 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 16: the declarative chaos suite on phase 7's cluster
# (benchmarks/fig_chaos.py's proportions at full width)
# ---------------------------------------------------------------------------
# fig_chaos offers 6 ops a tick on 64 lanes (2 chains x 4 nodes x 8): 3/32
# of lane capacity, here 192 of 2,048; its segments, horizon, lease and
# abandonment; the txn_mix mix under zipf for the disturbances
CH_SEG, CH_TICKS, CH_LEASE, CH_ABANDON = 8, 96, 16, 0.10
CH_QPS = 3 / 32 * OL_CAPACITY
CH_WIDTH, CH_BACKLOG, CH_REPLY, CH_SEED = OL_WIDTH, OL_BACKLOG, 32768, 11
CH_MIX = dict(write_fraction=0.25, txn_fraction=0.25, key_skew="zipf",
              zipf_a=1.2, abandon_fraction=CH_ABANDON)
# fig_chaos's wave (0, 1), (3, 0) moves chain 0's first bucket to chain 1
# and chain 1's second bucket to chain 0 (2 buckets a chain there); its
# stale-client move (1, 1) takes chain 0's second bucket to chain 1
CH_WAVE = [(0, 1), (BUCKETS_PER_CHAIN + 1, 0)]
CH_STALE = (1, 1)
# a storm never drains its stranded dirty versions (``stranded_versions``):
# 8 segments outlive the fabric and the 16-tick lease
CH_STORM_DRAIN = 8
# the lease arm: fig_chaos's lease_rows, uniform keys
CH_HORIZONS, CH_LEASE_MIX = (64, 128), dict(
    write_fraction=0.25, txn_fraction=0.25, abandon_fraction=0.25)
# CUDA against the CPU: a reduced cluster and one scenario of all four
# event kinds
CH_REDUCED = dict(num_keys=1024, spare_keys=128, n_chains=2, ticks=48)


def chaos_sim(cl, device) -> ChainSim:
    return ChainSim(cl, inject_capacity=INJECT, route_capacity=ROUTE,
                    reply_capacity=CH_REPLY, device=device)


def chaos_gen(cl, device, qps=None, mix=None):
    return loadgen_lib.make_loadgen(cl, qps=CH_QPS if qps is None else qps,
                                    seed=CH_SEED,
                                    backlog_capacity=CH_BACKLOG,
                                    device=device, **(mix or CH_MIX))


def chaos_scenarios(cl) -> list:
    return [chaos_lib.none_scenario(CH_TICKS, CH_SEG),
            chaos_lib.failure_storm(cl.n_chains, CH_TICKS, CH_SEG, node=1),
            chaos_lib.migration_wave(CH_WAVE, CH_TICKS, CH_SEG),
            chaos_lib.stale_clients(*CH_STALE, CH_TICKS, CH_SEG)]


def mixed_scenario(cl, ticks: int):
    """fail, migrate (chain 1's second bucket onto chain 0, the failed
    node included), lease and recover, one each."""
    E = chaos_lib.ChaosEvent
    return chaos_lib.ChaosScenario("mixed", (
        E(tick=CH_SEG, kind="fail", chain=0, node=1),
        E(tick=2 * CH_SEG, kind="migrate", bucket=cl.buckets_per_chain + 1,
          dst_chain=0),
        E(tick=3 * CH_SEG, kind="lease", lease_ticks=CH_LEASE - 4),
        E(tick=4 * CH_SEG, kind="recover", chain=0, node=1, position=1),
    ), ticks, CH_SEG)


def stranded_versions(sim, state, co, what: str) -> dict:
    """The failure storm against the two drain invariants the reference's
    failure handling cannot meet under load (ROADMAP section 3; both
    faults pinned in ``tests/test_torch_chaos.py``): a write or ACK in
    flight to a node when it fails is dropped, and the recovery copy
    races ACKs still addressed to the predecessor.  Each leaves a dirty
    version on the failed node's predecessor or the spliced node, with a
    stale slot 0 where the ACK was lost.  Requires that these are the
    only departures: every node past the failed position is clean, and
    every live replica whose slot 0 differs from the tail's holds a
    dirty version of that key (CRAQ serves a dirty key from the tail).
    Returns the counts."""
    st = state.stores
    fail_pos = 1
    require(int(st.pending[:, fail_pos + 1:].abs().sum()) == 0,
            f"{what}: a dirty version past the failed position")
    vals = st.values[:, :, :, 0, 0]
    tails = torch.tensor([m.tail for m in co.chains], device=vals.device)
    tail_vals = vals[torch.arange(vals.shape[0], device=vals.device), tails]
    live = torch.zeros(vals.shape[:2], dtype=torch.bool, device=vals.device)
    for c, m in enumerate(co.chains):
        live[c, m.node_ids] = True
    diverged = live[..., None] & (vals != tail_vals[:, None])
    dirty = st.pending != 0
    require(not bool((diverged & ~dirty).any()),
            f"{what}: a clean replica diverged from the tail")
    out = {"dirty_versions": int(dirty.sum()),
           "diverged_slots": int(diverged.sum()),
           "dirty_on_predecessor": int(dirty[:, fail_pos - 1].sum()),
           "dirty_on_spliced_node": int(dirty[:, fail_pos].sum())}
    log(f"{what}: {out['dirty_versions']} dirty versions stranded "
        f"({out['dirty_on_predecessor']} on node {fail_pos - 1}, "
        f"{out['dirty_on_spliced_node']} on the spliced node {fail_pos}), "
        f"{out['diverged_slots']} slot-0 copies behind the tail, all on "
        "dirty keys; nodes past the failed position clean")
    return out


def chaos_run(sim, gen, scenario, device, *, lease=None, check=True,
              storm=False, width=None):
    """One scenario through ``run_scenario`` from a fresh state, the
    launch counters zeroed just before and read just after; with
    ``check``, then every global key read back in one launch on the tail
    replica and held to the oracle.  ``storm`` runs the scenario without
    ``run_scenario``'s checks and holds it to all of them but the two the
    reference's failure handling breaks under load
    (``stranded_versions``).  Returns (state, gen, record)."""
    lease = CH_LEASE if lease is None else lease
    width = CH_WIDTH if width is None else width
    gen0 = tree_map(lambda x: x.clone(), gen)
    co = Coordinator(sim.cluster, device=device)
    sync(device)
    kv_kernel.reset_launches()
    with PlainCalls(kv_ref, KV_PLAIN) as plain:
        t0 = time.perf_counter()
        state, gen, rep = chaos_lib.run_scenario(
            sim, gen, scenario, coordinator=co, lease_ticks=lease,
            arrival_width=width, check=check and not storm,
            drain_segments=CH_STORM_DRAIN if storm else 24)
        sync(device)
        wall = time.perf_counter() - t0
    launches = dict(kv_kernel.LAUNCHES)
    ticks = int(state.t)
    what = f"chaos {scenario.name}"
    if torch.device(device).type == "cuda":
        launch_check(launches, ticks, plain.calls, what)
    m = rep["metrics"]
    total = scenario.total_ticks + rep["extra_ticks"]
    if storm:
        require(rep["leaked_locks"] == 0, f"{what}: leaked locks")
        require(sim.inflight(state) == 0, f"{what}: ops left in flight")
        rep["serial_keys"] = chaos_lib.check_serial_reference(
            sim, state, gen0, width, total)
    rec = {"seconds": wall, "ticks": ticks, "extra_ticks": rep["extra_ticks"],
           "drained": rep["drained"],
           "serial_keys": rep["serial_keys"], "leaked_locks":
           rep["leaked_locks"], "lease_expiries": m["lease_expiries"],
           "stale_routes": m["stale_routes"], "offered": m["offered"],
           "shed": m["admission_drops"], "txn_commits": m["txn_commits"],
           "wall_us_per_tick": wall / ticks * 1e6, "launches": launches,
           "samples": rep["samples"]}
    if storm:
        rec["stranded"] = stranded_versions(sim, state, co, what)
    if check:
        cl = sim.cluster
        require(sim.inflight(state) == 0, f"{what}: ops left in flight")
        before = kv_kernel.LAUNCHES["kv_bucketed_read"]
        rv, dec = read_back(cl, state, state.pmap)
        require(kv_kernel.LAUNCHES["kv_bucketed_read"] - before ==
                (1 if torch.device(device).type == "cuda" else 0),
                f"{what}: the read-back was not one launch")
        require(bool((dec == 0).all()), f"{what}: a read-back was not clean")
        gk, val = chaos_lib.serial_reference_tensors(sim, state, gen0, width,
                                                     total)
        want = torch.zeros(cl.num_global_keys, dtype=torch.int32,
                           device=rv.device)
        want[gk.to(rv.device)] = val.to(rv.device)
        require(torch.equal(rv[:, 0], want),
                f"{what}: the read-back differs from the serial reference "
                f"at {int((rv[:, 0] != want).sum())} keys")
        rec["read_back_keys"] = cl.num_global_keys
    log(f"chaos {scenario.name} ({on_card(device)}): {wall:.2f} s, "
        f"{ticks} ticks ({scenario.total_ticks} offered + "
        f"{rep['extra_ticks']} settle + drain), drained {rep['drained']}, "
        f"serial keys {rep['serial_keys']}, leaked {rep['leaked_locks']}, "
        f"lease expiries {m['lease_expiries']}, stale routes "
        f"{m['stale_routes']}, offered {m['offered']}, shed "
        f"{m['admission_drops']}, txn commits {m['txn_commits']}; "
        f"{rec['wall_us_per_tick']:.1f} us wall per open-loop tick; "
        f"launches {launches}")
    return state, gen, rec


def storm_recovery(rec, scenario) -> dict:
    """fig_chaos's storm_recovery_rows: the delivered rate per segment
    before, during and after the storm, from the boundary samples (the
    settle ticks included), and after / before."""
    fail_at, recover_at = scenario.events[0].tick, scenario.events[-1].tick
    rates = {"before": [], "during": [], "after": []}
    s = rec["samples"]
    for a, b in zip(s, s[1:]):
        dt = b["t"] - a["t"]
        if dt <= 0:
            continue
        r = (b["replies"] - a["replies"]) / dt
        if b["t"] <= fail_at:
            rates["before"].append(r)
        elif a["t"] >= recover_at:
            rates["after"].append(r)
        else:
            rates["during"].append(r)
    mean = lambda xs: sum(xs) / len(xs) if xs else 0.0
    out = {k: mean(v) for k, v in rates.items()}
    out["recovery_fraction"] = (out["after"] / out["before"]
                                if out["before"] else None)
    return out


def chaos_disturbances(device="cuda") -> dict:
    """The four disturbances under the full drain invariants, the moves
    meeting the stale-route gate, the storm's recovery, and one segment's
    host syncs (none)."""
    cl = cluster("netcraq", partitioned=True)
    sim = chaos_sim(cl, device)
    out = {}
    for scenario in chaos_scenarios(cl):
        _, _, rec = chaos_run(sim, chaos_gen(cl, device), scenario, device,
                              storm=scenario.name == "failure_storm")
        require(rec["leaked_locks"] == 0 and rec["serial_keys"] > 0,
                f"chaos {scenario.name}: leaked or checked nothing")
        if scenario.name in ("migration_wave", "stale_clients"):
            require(rec["stale_routes"] > 0,
                    f"chaos {scenario.name}: no stale route")
        if scenario.name == "failure_storm":
            rec["recovery"] = storm_recovery(rec, scenario)
            r = rec["recovery"]
            log(f"chaos failure_storm ({on_card(device)}): replies per tick "
                f"{r['before']:.2f} before, {r['during']:.2f} during, "
                f"{r['after']:.2f} after; recovery fraction "
                f"{r['recovery_fraction']}")
        rec.pop("samples")
        out[scenario.name] = rec
    state = ol_state(sim)
    gen = chaos_gen(cl, device)
    state, gen = sim.run_openloop(state, gen, CH_SEG, arrival_width=CH_WIDTH,
                                  extra_ticks=0)
    box = [state, gen]

    def segment():
        box[0], box[1] = sim.run_openloop(box[0], box[1], CH_SEG,
                                          arrival_width=CH_WIDTH,
                                          extra_ticks=0)
    out["segment_syncs"] = count_syncs(segment)
    require(out["segment_syncs"] == 0,
            f"a chaos segment synced the host {out['segment_syncs']} times")
    log(f"chaos: host syncs in one {CH_SEG}-tick open-loop segment "
        f"{out['segment_syncs']}")
    return out


def chaos_lease_arm(device="cuda") -> dict:
    """fig_chaos's lease arm: under LEASE_OFF the abandoned locks leak
    and the leak grows with the horizon, nothing reclaimed; lease 16 at
    the longer horizon drains to 0, reclaiming at least the shorter
    horizon's leak."""
    cl = cluster("netcraq", partitioned=True)
    sim = chaos_sim(cl, device)
    leak = {}
    for h in CH_HORIZONS:
        _, _, rec = chaos_run(sim, chaos_gen(cl, device, mix=CH_LEASE_MIX),
                              chaos_lib.none_scenario(h, CH_SEG), device,
                              lease=LEASE_OFF, check=False)
        require(rec["lease_expiries"] == 0,
                f"lease off at {h} ticks reclaimed {rec['lease_expiries']}")
        leak[h] = rec["leaked_locks"]
    h0, h1 = CH_HORIZONS
    require(0 < leak[h0] < leak[h1],
            f"the LEASE_OFF leak did not grow with the horizon: {leak}")
    _, _, fin = chaos_run(sim, chaos_gen(cl, device, mix=CH_LEASE_MIX),
                          chaos_lib.none_scenario(h1, CH_SEG), device)
    require(fin["leaked_locks"] == 0 and fin["lease_expiries"] >= leak[h0],
            f"lease {CH_LEASE}: leaked {fin['leaked_locks']}, reclaimed "
            f"{fin['lease_expiries']} of the {leak[h0]} stranded at {h0}")
    fin.pop("samples")
    log(f"chaos lease arm ({on_card(device)}): LEASE_OFF leaks {leak} locks "
        f"(horizon: leak), 0 reclaimed; lease {CH_LEASE} at {h1} ticks: 0 "
        f"leaked, {fin['lease_expiries']} reclaimed")
    return {"leak_off": leak, "lease_16": fin}


def chaos_cpu_equality(device="cuda") -> None:
    """One scenario of all four event kinds on a reduced cluster (2
    chains x 4 nodes x 1,024 registers), on CUDA and on the CPU:
    identical state, report and backlog.  Its failure strands dirty
    versions as the storm's does, so it is held as the storm is."""
    r = CH_REDUCED
    cl = ClusterConfig(
        chain=ChainConfig(n_nodes=N_NODES, num_keys=r["num_keys"],
                          num_versions=VERSIONS, value_words=WORDS),
        n_chains=r["n_chains"], buckets_per_chain=BUCKETS_PER_CHAIN,
        spare_keys=r["spare_keys"])
    cap = r["n_chains"] * N_NODES * INJECT
    qps, width = 3 / 32 * cap, 2 * cap
    out = {}
    for dev in (device, "cpu"):
        sim = chaos_sim(cl, dev)
        state, gen, rec = chaos_run(sim, chaos_gen(cl, dev, qps),
                                    mixed_scenario(cl, r["ticks"]), dev,
                                    storm=True, width=width)
        out[dev] = (state, gen, rec)
    (cpu, cpu_gen, cpu_rec), (gpu, gpu_gen, gpu_rec) = out["cpu"], out[device]
    for name in cpu._fields:
        same_tree(getattr(cpu, name), getattr(gpu, name),
                  f"chaos: CUDA vs CPU {name}")
    same_tree(cpu_gen.backlog, gpu_gen.backlog, "chaos: CUDA vs CPU backlog")
    for k in ("ticks", "extra_ticks", "serial_keys", "leaked_locks",
              "lease_expiries", "stale_routes", "offered", "samples"):
        require(cpu_rec[k] == gpu_rec[k],
                f"chaos: CUDA vs CPU report {k}: {gpu_rec[k]} != {cpu_rec[k]}")
    require(gpu_rec["stale_routes"] > 0 and gpu_rec["extra_ticks"] > 0,
            "chaos: the mixed scenario moved nothing")
    log(f"chaos: CUDA run == CPU plain run of the four-kind scenario "
        f"({r['n_chains']} x {N_NODES} x {r['num_keys']}, {gpu_rec['ticks']} "
        f"ticks: state, report, backlog)")


def chaos_phase() -> dict:
    t0 = time.perf_counter()
    out = {"disturbances": chaos_disturbances(),
           "lease": chaos_lease_arm()}
    chaos_cpu_equality()
    out["seconds"] = time.perf_counter() - t0
    log(f"chaos: phase 16 took {out['seconds']:.1f} s ({smi()})")
    return out


# ---------------------------------------------------------------------------
# phase 17: ChainDist and the kv_cache protocols on torch.distributed, one
# chain node per rank, every rank on this card.  The workers run in the
# spawned ranks, which import this script without running ``main``.
# ---------------------------------------------------------------------------
# phase 3's node size: 65,536 registers of 4 words and 4 versions, about
# 5 MiB of store a rank; 256 inbox lanes a node, the last 96 kept for each
# tick's client ops (checked: carried traffic never reaches them)
DIST_BACKEND, DIST_TIMEOUT = "gloo", 180
DIST_BATCH, DIST_CLIENT_LANES = 256, 96
DIST_OPS, DIST_WRITE_FRACTION = 32, 0.25    # client ops a node a tick
DIST_TICKS, DIST_DRAIN = 32, 16             # (a): one chain of 4 ranks
GROUPED_TICKS, GROUPED_DRAIN = 16, 16       # (b): 2 chains of 4 ranks
GROUPED_DEAD = (1, 1)                       # (chain, node) failed in (b)
TXN_PER_TICK, TXN_COMMIT_AFTER = 4, 2       # PREPAREs at chain 0's head
CPU_STEPS = 8                               # (c): CUDA against the CPU
REPLAY_ITERS = 10
# (d): benchmarks/replication_dryrun.py's shapes: Qwen2.5-3B's cache (36
# layers, 2 KV heads of 128) at batch 32 in bf16, a one-token page [L, B,
# 1, KV, D] for the appends and a 128-token window for the reads
KV_LAYERS, KV_HEADS, KV_DIM, KV_BATCH, KV_WINDOW = 36, 2, 128, 32, 128
KV_STEPS = 5


def dist_cluster(n_chains: int) -> ClusterConfig:
    return ClusterConfig(chain=ChainConfig(
        n_nodes=N_NODES, num_keys=NUM_KEYS, num_versions=VERSIONS,
        value_words=WORDS, protocol="netcraq"), n_chains=n_chains)


def dist_traffic(seed: int, C: int, ticks: int, drain: int, *,
                 dead=None, txn: bool = False) -> dict:
    """Client traffic as numpy lanes ``[ticks + drain, C, n, B]``: each
    live node issues ``DIST_OPS`` ops a tick for ``ticks`` ticks, writes
    (a quarter) sent to the chain's head and reads served where they are
    issued, with qid ``counter * C + chain``; with ``txn``,
    ``TXN_PER_TICK`` PREPAREs on distinct keys at chain 0's head each tick
    and their COMMITs ``TXN_COMMIT_AFTER`` ticks later.  Reads take
    uniform keys; writes take distinct keys outside the transactions'
    (a write the version window refuses is dropped without a reply, and
    replies == offered needs none refused).  Client ops take the last
    ``DIST_CLIENT_LANES`` lanes of a node's batch."""
    rng = np.random.default_rng(seed)
    txn_keys = ticks * TXN_PER_TICK if txn else 0
    write_keys = [iter(rng.permutation(np.arange(txn_keys, NUM_KEYS)))
                  for _ in range(C)]
    T, B, n = ticks + drain, DIST_BATCH, N_NODES
    shape = (T, C, n, B)
    f = {name: np.zeros(shape, np.int32) for name in Msg._fields}
    f["value"] = np.zeros(shape + (WORDS,), np.int32)
    for name in ("seq", "qid", "dst"):
        f[name][:] = -1
    fill = np.full((T, C, n), B - DIST_CLIENT_LANES)
    counter = 0

    def put(t, c, node, op, key, value, seq=-1, client=0):
        nonlocal counter
        at = (t, c, node, fill[t, c, node])
        require(at[-1] < B, "dist_traffic: more client ops than lanes")
        fill[t, c, node] += 1
        f["op"][at], f["key"][at], f["seq"][at] = op, key, seq
        f["value"][at] = value
        f["src"][at] = f["client"][at] = CLIENT_BASE + client
        f["dst"][at], f["t_inject"][at] = node, t
        f["qid"][at] = counter * C + c
        counter += 1

    for t in range(ticks):
        for c in range(C):
            for p in range(n):
                if (c, p) == dead:
                    continue
                writes = rng.random(DIST_OPS) < DIST_WRITE_FRACTION
                keys = rng.integers(0, NUM_KEYS, DIST_OPS)
                vals = rng.integers(0, 1 << 30, (DIST_OPS, WORDS))
                for w, k, v in zip(writes, keys, vals):
                    put(t, c, 0 if w else p, OP_WRITE if w else OP_READ,
                        next(write_keys[c]) if w else k, v,
                        client=int(rng.integers(0, 1 << 16)))
        if txn:
            for j in range(TXN_PER_TICK):
                key, tid = t * TXN_PER_TICK + j, 1000 + t * TXN_PER_TICK + j
                put(t, 0, 0, OP_PREPARE, key, 0, seq=tid, client=tid)
                put(t + TXN_COMMIT_AFTER, 0, 0, OP_COMMIT, key,
                    rng.integers(0, 1 << 30, WORDS), seq=tid, client=tid)
    return f


def sync_on(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_copy(tree) -> dict:
    return {f: getattr(tree, f).cpu().clone() for f in tree._fields}


def dist_run(d: ChainDist, traffic: dict, roles: Roles, *,
             telemetry: bool = False, record: int = 0,
             sample: int = 0) -> dict:
    """``traffic`` through ``d.make_step(DIST_BATCH)`` after one warm-up
    step on a scratch state, with the launch counters zeroed just before
    and read just after and the plain versions counted; each step timed
    from its client ops to a synchronisation after it.  Returns the final
    state, every step's replies (on the device), the step times, the
    bytes sent, the merged inbox of step ``sample`` and the outputs of the
    first ``record`` steps on the host."""
    dev, B = d.device, DIST_BATCH
    pmap = d.default_pmap()
    step = d.make_step(B, telemetry=telemetry)
    tel_arg = lambda tel: (tel,) if telemetry else ()
    T = traffic["op"].shape[0]
    injs = [d.shard(Msg(**{k: torch.from_numpy(v[t] if d.grouped else
                                               v[t, 0])
                           for k, v in traffic.items()})) for t in range(T)]
    empty = Msg.empty(d.lead + (B,), WORDS, device=dev)
    step(d.init_state(), empty, roles, pmap, d.init_locks(),
         *tel_arg(d.init_telemetry() if telemetry else None))
    stores, locks, inbox = d.init_state(), d.init_locks(), empty
    tel = d.init_telemetry() if telemetry else None
    replies, times, recs, merged = [], [], [], None
    collide = torch.zeros((), dtype=torch.bool, device=dev)
    sync_on(dev)
    kv_kernel.reset_launches()
    collectives.reset_bytes()
    with PlainCalls(kv_ref, KV_PLAIN) as plain:
        for t, inj in enumerate(injs):
            t0 = time.perf_counter()
            live = inj.op != OP_NOP
            collide |= (live & (inbox.op != OP_NOP)).any()
            inbox = tree_map(lambda a, b: torch.where(
                live.reshape(live.shape + (1,) * (a.dim() - live.dim())),
                b, a), inbox, inj)
            if t == sample:
                merged = tree_map(torch.clone, inbox)
            out = step(stores, inbox, roles, pmap, locks, *tel_arg(tel))
            stores, inbox, rep, locks = out[:4]
            tel = out[4] if telemetry else None
            sync_on(dev)
            times.append(time.perf_counter() - t0)
            replies.append(rep)
            if t < record:
                recs.append([host_copy(x) for x in out])
    launches = dict(kv_kernel.LAUNCHES)
    sent = dict(collectives.BYTES_SENT)
    require(not bool(collide), "ChainDist: client lanes collided with "
            "carried traffic (load over the batch)")
    return dict(stores=stores, inbox=inbox, locks=locks, tel=tel,
                replies=Msg.concat(replies, dim=len(d.lead)), times=times,
                launches=launches, plain=dict(plain.calls), bytes=sent,
                records=recs, merged=merged, steps=T)


def dist_checks(d: ChainDist, run: dict, traffic: dict, roles: Roles,
                what: str) -> dict:
    """A run's checks on this rank, each over its chain group: replies ==
    offered, only this chain's ops answered, an empty fabric, no dirty
    version, free locks, the launch counts and no plain-version call;
    every acknowledged write (and committed transaction) read back from
    a live replica's clean cell, and nothing stored on a dead one."""
    g, dev, K = d.group, d.device, d.cfg.num_keys
    rep = run["replies"]
    live = rep.op != OP_NOP
    c = d.chain
    offered = int((traffic["op"][:, c] != OP_NOP).sum())
    total = int(collectives.psum(live.sum().reshape(1), g))
    require(total == offered,
            f"{what}: chain {c} replied {total} of {offered} offered ops")
    require(bool((rep.qid[live] % d.C == c).all()),
            f"{what}: rank {d.rank} answered another chain's op")
    require(not bool((run["inbox"].op != OP_NOP).any()),
            f"{what}: rank {d.rank} left traffic in flight")
    st = run["stores"]
    require(int(st.pending.abs().sum()) == 0,
            f"{what}: rank {d.rank} left dirty versions")
    require(bool((run["locks"].holder == -1).all()),
            f"{what}: rank {d.rank} holds locks after the drain")
    steps = run["steps"]
    require(run["launches"] == {"kv_read": steps, "kv_write": steps,
                                "kv_bucketed_read": 0,
                                "kv_bucketed_write": 0},
            f"{what}: rank {d.rank} launches {run['launches']} over "
            f"{steps} steps")
    require(not any(run["plain"].values()),
            f"{what}: rank {d.rank} plain-version calls {run['plain']}")
    # the tail's newest acknowledged write per key, broadcast to its chain
    acked = live & ((rep.op == OP_WRITE_REPLY)
                    | ((rep.op == OP_TXN_REPLY) & (rep.seq >= 0)))
    key, seq = rep.key[acked].long(), rep.seq[acked]
    newest = torch.full((K,), -1, dtype=torch.int32, device=dev)
    newest.scatter_reduce_(0, key, seq, reduce="amax")
    won = newest[key] == seq
    val0 = torch.zeros(K, dtype=torch.int32, device=dev)
    val0[key[won]] = rep.value[acked][won][:, 0]
    table = collectives.broadcast_from(torch.stack([newest, val0]), g.n - 1,
                                       g)
    keys = torch.nonzero(table[0] >= 0).flatten()
    flat = lambda x: x.reshape((K,) + x.shape[len(d.lead) + 1:])
    seqs, values = flat(st.seqs), flat(st.values)
    if bool(roles.alive.all()):
        require(torch.equal(seqs[keys, 0], table[0, keys])
                and torch.equal(values[keys, 0, 0], table[1, keys]),
                f"{what}: rank {d.rank} lost an acknowledged write")
    else:
        fresh = d.init_state()
        require(all(torch.equal(a, b) for a, b in zip(st, fresh))
                and not bool(live.any()),
                f"{what}: the dead rank {d.rank} stored or answered")
    return dict(offered=offered, replies=total, keys=int(keys.numel()))


def slowest(d: ChainDist, xs) -> np.ndarray:
    """Each entry of ``xs`` (this rank's numbers), the largest over the
    chain group's ranks."""
    t = torch.tensor(xs, dtype=torch.float64, device=d.device)
    return collectives.all_gather_tiled(
        t.reshape(1, -1), d.group).cpu().numpy().max(axis=0)


def replay_split(d: ChainDist, stores, roles: Roles, inbox: Msg) -> dict:
    """Where a step's time goes, replayed on this rank on a step's merged
    inbox: the node step (a copy of the store each time; on a card one
    ``kv_read`` and one ``kv_write`` launch), on every rank at once as
    in a step and then one rank at a time (the others wait); the step's
    three exchanges at their sizes (the lock stage's ``all_gather`` of
    ``B + 1`` packed lanes, the next-hop ``ppermute`` and the fabric's
    ``all_gather`` of ``4 B``); the replicated head lock stage on the
    chain's gathered batch; the packing and unpacking around the three
    exchanges; and the two compactions (``3 B`` lanes to the replies,
    ``5 B`` to the next inbox).  Medians over ``REPLAY_ITERS``, the
    slowest rank's, every rank at once."""
    dev, B, k, n = d.device, DIST_BATCH, len(d.lead), d.n
    local = lambda tree: tree_map(
        lambda x: x.reshape((1,) + x.shape[k:]), tree)
    my_roles, store, inb = local(roles), local(stores), local(inbox)
    width = len(Msg._fields) - 1 + WORDS
    feed = torch.zeros((B + 1, width), dtype=torch.int32, device=dev)
    fab = torch.zeros((4 * B, width), dtype=torch.int32, device=dev)
    cand = is_txn_op(inb.op) & (inb.src >= CLIENT_BASE)
    txn_all = tree_map(lambda x: x[None], d.gather(inb.mask(cand)))
    roles_all = tree_map(lambda x: x.reshape(1, n), d.gather(roles))
    bstore = tree_map(lambda x: x[:, None].expand((1, n) + x.shape[1:]),
                      store)
    wide = lambda m: Msg.concat([inb] * m, dim=1)
    replies_in, inbox_in = wide(3), wide(5)
    packed = collectives.pack_msg(inb)
    packed_n = packed.repeat(n, 1)

    def timed(fn) -> float:
        sync_on(dev)
        t0 = time.perf_counter()
        fn()
        sync_on(dev)
        return time.perf_counter() - t0

    def node_step() -> float:
        s = tree_map(torch.clone, store)
        return timed(lambda: d.node_step(d.cfg, s, my_roles, inb))

    def exchanges():
        collectives.all_gather_tiled(feed, d.group)
        collectives.ppermute_next(fab, d.group)
        collectives.all_gather_tiled(fab, d.group)

    def packing():
        for _ in range(3):
            collectives.pack_msg(inb)
        collectives.unpack_msg(packed_n, (1, n * B))
        collectives.unpack_msg(packed, (1, B))
        collectives.unpack_msg(packed_n, (1, n * B))

    def compaction():
        ChainDist._compact(replies_in, B)
        ChainDist._compact(inbox_in, B)

    parts = {"node_step": [], "exchange": [], "lock_stage": [],
             "packing": [], "compaction": []}
    for _ in range(REPLAY_ITERS):
        parts["node_step"].append(node_step())
        parts["exchange"].append(timed(exchanges))
        parts["lock_stage"].append(timed(lambda: txn_lib.head_txn_stage(
            d.init_locks(), roles_all, bstore, txn_all)))
        parts["packing"].append(timed(packing))
        parts["compaction"].append(timed(compaction))
    alone_t = []
    for r in range(d.n):
        torch.distributed.barrier(group=d.group.pg)
        if d.pos == r:
            alone_t = [node_step() for _ in range(REPLAY_ITERS)]
    torch.distributed.barrier(group=d.group.pg)
    us = slowest(d, [np.median(x) * 1e6 for x in
                     (*parts.values(), alone_t)])
    out = {f"{name}_us": float(u) for name, u in zip(parts, us)}
    out["node_step_alone_us"] = float(us[-1])
    return out


def kv_cache_steps(rank: int, world: int, dev) -> dict:
    """(d): the kv_cache protocols at replication_dryrun's shapes, held to
    tests/test_chain_dist.py's relations (node i > 0 keeps node i - 1's
    page, the tail's seq reaches everyone, reads fetch the tail's window,
    the tail ends with the head's page), then timed: ms a step (median of
    ``KV_STEPS``, slowest rank) and the bytes a rank sends a step."""
    g = collectives.chain_group(world)
    n = g.n
    page_shape = (KV_LAYERS, KV_BATCH, 1, KV_HEADS, KV_DIM)
    win_shape = (KV_LAYERS, KV_BATCH, KV_WINDOW, KV_HEADS, KV_DIM)

    def seeded(shape, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    page = lambda r: seeded(page_shape, 100 + r)
    own, win = page(rank), seeded(win_shape, 200 + rank)
    seq = torch.full((1,), 10 + rank, dtype=torch.int32, device=dev)
    _, replica, ack = KV.netcraq_append(own, seq, group=g)
    require(torch.equal(replica, page(rank - 1) if rank else own)
            and int(ack) == 10 + n - 1,
            f"kv_cache: netcraq_append on rank {rank}")
    fetched = KV.netchain_read(win, group=g)
    require(torch.equal(fetched, seeded(win_shape, 200 + n - 1)),
            f"kv_cache: netchain_read on rank {rank}")
    committed, ack2 = KV.netchain_append(own, seq, group=g)
    require(torch.equal(committed, page(0) if rank == n - 1 else own)
            and int(ack2) == 10 + n - 1,
            f"kv_cache: netchain_append on rank {rank}")
    protocols = {
        "netcraq": lambda: KV.netcraq_append(own, seq, group=g),
        "netchain": lambda: (KV.netchain_read(win, group=g),
                             KV.netchain_append(own, seq, group=g))}
    out = {}
    for name, fn in protocols.items():
        collectives.reset_bytes()
        fn()
        sent = sum(collectives.BYTES_SENT.values())
        times = []
        for _ in range(KV_STEPS):
            sync_on(dev)
            t0 = time.perf_counter()
            fn()
            sync_on(dev)
            times.append(time.perf_counter() - t0)
        out[name] = dict(bytes=sent, ms=np.median(times) * 1e3)
    ms = collectives.all_gather_tiled(torch.tensor(
        [[out["netcraq"]["ms"], out["netchain"]["ms"]]],
        dtype=torch.float64, device=dev), g).cpu().numpy().max(axis=0)
    out["netcraq"]["slowest_ms"], out["netchain"]["slowest_ms"] = ms
    return out


def dist_chain_worker(rank: int, world: int, dev) -> dict:
    """(a) one NetCRAQ chain of ``world`` ranks under client traffic and
    a drain, then (d) the kv_cache protocols on the same ranks."""
    d = ChainDist(dist_cluster(1), rank=rank, world=world, device=dev)
    traffic = dist_traffic(17, 1, DIST_TICKS, DIST_DRAIN)
    roles = d.full_roles()
    run = dist_run(d, traffic, roles, sample=DIST_TICKS // 2)
    checks = dist_checks(d, run, traffic, roles, "ChainDist (a)")
    times = slowest(d, run["times"]) * 1e6
    split = replay_split(d, run["stores"], roles, run["merged"])
    return dict(checks=checks, launches=run["launches"], steps=run["steps"],
                step_us=times, split=split, bytes=run["bytes"],
                kv=kv_cache_steps(rank, world, dev))


def dist_grouped_worker(rank: int, world: int, dev) -> dict:
    """(b) two NetCRAQ chains of 4 ranks with the telemetry plane, node 1
    of chain 1 failed through the control plane's role table and
    transactions at chain 0's head; (c) its first ``CPU_STEPS`` steps on
    the CPU (the plain versions) against the card's, every output."""
    cl = dist_cluster(2)
    co = Coordinator(cl, device="cpu")
    co.fail_node(*GROUPED_DEAD)
    traffic = dist_traffic(18, 2, GROUPED_TICKS, GROUPED_DRAIN,
                           dead=GROUPED_DEAD, txn=True)
    d = ChainDist(cl, rank=rank, world=world, group_axis=True, device=dev)
    roles = d.shard(co.roles_table())
    run = dist_run(d, traffic, roles, telemetry=True, record=CPU_STEPS)
    checks = dist_checks(d, run, traffic, roles, "ChainDist (b)")
    rep, tel = run["replies"], run["tel"]
    seen = int((reply_op_class(rep.op, rep.seq) >= 0).sum())
    require(int(tel.lat_hist.sum()) == seen
            and int(tel.ring_cursor) == run["steps"],
            f"ChainDist (b): rank {rank} histogram holds "
            f"{int(tel.lat_hist.sum())} of {seen} replies")
    txn = torch.stack([(rep.op == OP_PREPARE_ACK).sum(),
                       ((rep.op == OP_TXN_REPLY) & (rep.seq >= 0)).sum()])
    txn = collectives.psum(txn, d.group).tolist()
    want = GROUPED_TICKS * TXN_PER_TICK if d.chain == 0 else 0
    require(txn == [want, want], f"ChainDist (b): chain {d.chain} granted "
            f"and committed {txn} of {want} transactions")
    times = slowest(d, run["times"][CPU_STEPS:]) * 1e6

    cpu = ChainDist(cl, rank=rank, world=world, group_axis=True,
                    device="cpu")
    first = {k: v[:CPU_STEPS] for k, v in traffic.items()}
    plain = dist_run(cpu, first, cpu.shard(co.roles_table()),
                     telemetry=True, record=CPU_STEPS)
    for t, (g_out, c_out) in enumerate(zip(run["records"],
                                           plain["records"])):
        for i, (gt, ct) in enumerate(zip(g_out, c_out)):
            for f, x in gt.items():
                require(torch.equal(x, ct[f]),
                        f"ChainDist (c): rank {rank} step {t} output {i} "
                        f"{f}: CUDA != CPU")
    return dict(checks=checks, launches=run["launches"], steps=run["steps"],
                step_us=times, bytes=run["bytes"], txn=txn,
                hist=int(tel.lat_hist.sum()), compared=CPU_STEPS)


def chain_report(a: list, card: str, how: str) -> dict:
    """(a)'s lines and numbers from its ranks' results."""
    r0 = a[0]
    us, split = r0["step_us"], r0["split"]
    log(f"ChainDist (a) ({card}; {how}): 1 chain x {N_NODES} ranks x "
        f"{NUM_KEYS} registers, {r0['steps']} steps ({DIST_TICKS} of "
        f"traffic, {DIST_DRAIN} of drain), offered "
        f"{r0['checks']['offered']} = replies {r0['checks']['replies']}, "
        f"{r0['checks']['keys']} acknowledged keys read back on all "
        f"{N_NODES} replicas; launches per rank "
        f"{[x['launches'] for x in a]}, no plain call")
    log(f"ChainDist (a) ({card}; {how}): wall us per step (slowest rank) "
        f"median {np.median(us):.1f}, p99 {np.percentile(us, 99):.1f}, max "
        f"{us.max():.1f}; replayed: node step {split['node_step_us']:.1f} "
        f"us on every rank at once, {split['node_step_alone_us']:.1f} us "
        f"one rank at a time, the three exchanges "
        f"{split['exchange_us']:.1f} us, the lock stage "
        f"{split['lock_stage_us']:.1f} us, packing "
        f"{split['packing_us']:.1f} us, the two compactions "
        f"{split['compaction_us']:.1f} us; bytes sent per rank per step "
        f"{[round(sum(x['bytes'].values()) / x['steps']) for x in a]}")
    return dict(step_us_median=float(np.median(us)),
                step_us_p99=float(np.percentile(us, 99)), split=split,
                launches=[x["launches"] for x in a],
                chain_bytes_per_step=[sum(x["bytes"].values()) / x["steps"]
                                      for x in a])


def dist_phase(device="cuda") -> dict:
    """Phase 17: (a) and (d) on 4 ranks, (b) and (c) on 8, rank ``r`` on
    card ``r % device_count`` (all on one card when there is one),
    ``DIST_BACKEND`` between them; with a card for each of (a)'s ranks,
    (a) and (d) again over NCCL, one rank a card."""
    t0 = time.perf_counter()
    card = on_card(device)
    cards = torch.cuda.device_count() if torch.device(
        device).type == "cuda" else 0
    where = (f"every rank on one device ({device}); the ranks exchange "
             "through host memory (pinned staging copies)" if cards <= 1
             else f"rank r on cuda:(r % {cards}); the ranks exchange "
             "through host memory (pinned staging copies)")
    log(f"distributed ({card}): backend {DIST_BACKEND}, one chain node a "
        f"rank, {where}")
    a = collectives.spawn_ranks(dist_chain_worker, N_NODES,
                                backend=DIST_BACKEND, device=device,
                                timeout=DIST_TIMEOUT)
    res = dict(backend=DIST_BACKEND, cards=max(cards, 1),
               **chain_report(a, card, f"{DIST_BACKEND}, {where}"))
    kv = {p: dict(bytes=[x["kv"][p]["bytes"] for x in a],
                  ms=a[0]["kv"][p]["slowest_ms"])
          for p in ("netcraq", "netchain")}
    for p, rec in kv.items():
        log(f"kv_cache {p} ({card}; {DIST_BACKEND}): {KV_LAYERS} layers x "
            f"batch {KV_BATCH} x {KV_HEADS} x {KV_DIM} bf16, page 1 token, "
            f"window {KV_WINDOW}: {rec['ms']:.3f} ms per step (slowest "
            f"rank), bytes sent per rank per step {rec['bytes']}")
    if cards >= N_NODES:
        nccl = collectives.spawn_ranks(dist_chain_worker, N_NODES,
                                       backend="nccl", device=device,
                                       timeout=DIST_TIMEOUT)
        res["nccl"] = chain_report(nccl, card,
                                   "nccl, one rank a card, no staging")
        res["nccl"]["kv_cache"] = {
            p: dict(bytes=[x["kv"][p]["bytes"] for x in nccl],
                    ms=nccl[0]["kv"][p]["slowest_ms"])
            for p in ("netcraq", "netchain")}
        for p, rec in res["nccl"]["kv_cache"].items():
            log(f"kv_cache {p} ({card}; nccl, one rank a card): "
                f"{rec['ms']:.3f} ms per step (slowest rank), bytes sent "
                f"per rank per step {rec['bytes']}")
    b = collectives.spawn_ranks(dist_grouped_worker, 2 * N_NODES,
                                backend=DIST_BACKEND, device=device,
                                timeout=DIST_TIMEOUT)
    us_b = np.maximum(b[0]["step_us"], b[N_NODES]["step_us"])
    log(f"ChainDist (b) ({card}): 2 chains x {N_NODES} ranks, telemetry "
        f"on, node {GROUPED_DEAD[1]} of chain {GROUPED_DEAD[0]} dead, "
        f"{b[0]['steps']} steps; offered = replies per chain "
        f"{[b[c * N_NODES]['checks']['replies'] for c in range(2)]}; "
        f"transactions granted and committed per chain "
        f"{[b[c * N_NODES]['txn'] for c in range(2)]}; histogram counts "
        f"per rank {[x['hist'] for x in b]}; launches per rank "
        f"{[x['launches']['kv_read'] for x in b]} kv_read, "
        f"{[x['launches']['kv_write'] for x in b]} kv_write; wall us per "
        f"step after the recorded steps median {np.median(us_b):.1f}, p99 "
        f"{np.percentile(us_b, 99):.1f}")
    log(f"ChainDist (c) ({card}): the first {CPU_STEPS} steps of (b) on "
        f"CUDA ranks == CPU ranks (plain versions), every output, all 8 "
        "ranks")
    seconds = time.perf_counter() - t0
    log(f"distributed: phase 17 took {seconds:.1f} s ({card})")
    res["launches"] += [x["launches"] for x in b]
    return dict(res, kv_cache=kv,
                grouped_step_us_median=float(np.median(us_b)),
                seconds=seconds)


def on_card(device) -> str:
    """What a timing ran on: the card's name and power limit, or the
    host's CPU."""
    return smi() if torch.device(device).type == "cuda" else "host CPU"


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def build_kernels(phases) -> None:
    """The kernel sources the phases run, built at once, one nvcc each
    (all three for a whole run)."""
    t0 = time.perf_counter()
    kernels = [(src, k) for src, k, uses in (
        (KV_SRC, kv_kernel, (*range(2, 10), 14, 15, 16, 17)),
        (FA_SRC, fa_kernel, (10, 11)),
        (SSD_SRC, ssd_kernel, (12, 13))) if set(uses) & phases]
    with concurrent.futures.ThreadPoolExecutor(max(len(kernels), 1)) as pool:
        builds = [pool.submit(k.build) for _, k in kernels]
        for b in builds:
            b.result()
    log(f"built {', '.join(src for src, _ in kernels) or 'nothing'} for "
        f"sm_90a in {time.perf_counter() - t0:.1f} s")


ALL_PHASES = tuple(range(1, 18))


def parse_phases(argv) -> set:
    """``--phases 12,13``: the build, phase 1 and the named phases (a
    phase that needs an earlier one's run brings it along: 4 and 5 need 3,
    8 needs 7).  No argument: every phase."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phase numbers (default: all)")
    args = ap.parse_args(argv)
    if args.phases is None:
        return set(ALL_PHASES)
    phases = {1} | {int(x) for x in args.phases.split(",") if x.strip()}
    if not phases <= set(ALL_PHASES):
        ap.error(f"phases outside {ALL_PHASES[0]}-{ALL_PHASES[-1]}: "
                 f"{sorted(phases - set(ALL_PHASES))}")
    if phases & {4, 5}:
        phases.add(3)
    if 8 in phases:
        phases.add(7)
    return phases


T_START = time.perf_counter()


def main(argv=None) -> None:
    phases = parse_phases(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device - this script measures the "
                 "port on a GPU and has no CPU mode")
    t_start = T_START
    build_kernels(phases)
    log(smi())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; float32 matmul in "
        f"TF32: {torch.backends.cuda.matmul.allow_tf32}; phases "
        f"{sorted(phases)}")

    kernels = {}
    if 2 in phases:
        kernels.update(check_kernels())
        kernels.update(check_bucketed_kernels())
    if 10 in phases:
        kernels.update(check_flash_attention())
    if 12 in phases:
        kernels.update(check_ssd_scan())
    floor = launch_floor_ms()
    card = smi()
    us = lambda ms: "n/a" if ms is None else f"{ms * 1e3:.2f} us"

    def dev_us(rec, key):   # event time where the profiler saw nothing
        if rec[f"{key}ms"] is None or rec.get(f"{key}device_measured",
                                              True):
            return us(rec[f"{key}ms"])
        return f"not measured (event time {us(rec[f'{key}ms'])})"

    for name, rec in kernels.items():
        log(f"{name} ({card}): equals its plain version; device time per "
            f"call {dev_us(rec, '')} (plain {dev_us(rec, 'plain_')}, library "
            f"{dev_us(rec, 'library_')}); event-timed call "
            f"{us(rec['call_ms'])}"
            f" (plain {us(rec['plain_call_ms'])}, library "
            f"{us(rec['library_call_ms'])}); bound {us(rec['bound_ms'])} "
            f"by {rec['bound_by']}"
            + (f" ({us(rec['sector_bound_ms'])} in 32-byte sectors)"
               if "sector_bound_ms" in rec else "")
            + f"; one-element add_ {us(floor)}"
            + (f"; empty kernel of the same grid "
               f"{us(rec['empty_kernel_ms'])}" if "empty_kernel_ms" in rec
               else "")
            + f"; device kernels {rec.get('device_kernels_us')}")

    run, launches = {}, {}
    if 3 in phases:
        craq_run = main_path("netcraq")
        launches.update(craq_run["launches"])
    if 4 in phases:
        cpu_equality("netcraq")
        rebalance_equality()
    if 5 in phases:
        run["netcraq"] = tick_times("netcraq", craq_run["sim"])
    if 6 in phases:
        chain_run = main_path("netchain")
        cpu_equality("netchain")
        run["netchain"] = tick_times("netchain", chain_run["sim"])
        run["netchain_launches"] = chain_run["launches"]
    if 7 in phases:
        reb = rebalance_phase()
        launches["kv_bucketed_read"] = reb["launches"]["kv_bucketed_read"]
        run["rebalance_launches"] = reb["launches"]
        run["rebalance_gain"] = reb["gain"]
        run["read_back_cost"] = reb["read_back_cost"]
    if 8 in phases:
        writes = partitioned_write_phase(reb)
        launches["kv_bucketed_write"] = \
            writes["launches"]["kv_bucketed_write"]
        run["partitioned_write_launches"] = writes["launches"]
        run["partitioned_write_cost"] = writes["write_cost"]
        run["partitioned_read_cost"] = writes["read_cost"]
    if 9 in phases:
        run["failover_launches"] = failover_phase()["launches"]
    if 11 in phases:
        run["serving"] = serving_phase(SERVE_PATHS["dense"])
        run["serving_f32_route"] = f32_route_serving()
        launches.update(run["serving"]["launches"])
        launches.update(run["serving_f32_route"]["launches"])
    if 13 in phases:
        run["ssm_serving"] = serving_phase(SERVE_PATHS["ssm"])
        launches.update(run["ssm_serving"]["launches"])
    if 14 in phases:
        run["transactions"] = txn_phase()
        if "netcraq" in run:
            log(f"transactions: device activities per tick, phase 5's "
                f"wave-less netcraq tick "
                f"{run['netcraq']['device_activities_per_tick']:.2f}")
    if 15 in phases:
        run["openloop"] = openloop_phase()
    if 16 in phases:
        run["chaos"] = chaos_phase()
    if 17 in phases:
        run["distributed"] = dist_phase()

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches.get(name),
         "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
         "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
         "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
        for name, rec in kernels.items() if name in SOURCES]}
    log(json.dumps({
        "card": card, **run, "kernel_detail": kernels, "add_one_ms": floor,
        "seconds": time.perf_counter() - t_start,
    }))
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
