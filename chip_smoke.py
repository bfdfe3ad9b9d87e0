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
   bf16 serving shape (the design the tensor-core route replaced); then
   the prefill shapes of phases 18 and 20 on the tensor-core route,
   checked and timed the same way (Granite-MoE: q [8, 24, 2048, 64], k/v
   [8, 8, 2048, 64]; Llama-4-Scout: q [8, 40, 2048, 128], k/v [8, 8,
   2048, 128]; Zamba2: q, k and v [8, 32, 2048, 80], a head dim below the
   kernel's width of 128, read with TMA's zero fill, and the f32 kernel
   timed there too, the route that head dim took before), and head dims
   80 (ragged, S != SK both ways), 32 and 72 on that route;
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
   batched ``torch.matmul``; then Zamba2's layer of phase 20 (x [8, 2048,
   80, 64] bf16, state 64), held and timed the same way;
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
   with ms a step and the bytes a rank sends a step;
18. the MoE family on phase 11's serving run: Granite-MoE-3B-A800M at
   full width and depth (32 layers, 40 experts padded to 48, top-8,
   random weights from a seed; 16 requests of 2048-token prompts, 32 new
   tokens, 2 waves) and Llama-4-Scout-17B-16E at full width with its
   depth cut to 2 of 48 layers (one card holds 2; 8 requests, 16 new
   tokens), every attention launch on the tensor-core route (64 and 2)
   and no plain call, with phase 11's holds on the outputs, determinism,
   the manual greedy loop and the version bump; routing is held with no
   hook in the model: (a) the blocks driven from here layer by layer on
   the first wave, each layer fed one hidden state through the kernel
   path and the plain path, the block outputs equal on the tokens whose
   routing agrees and every differing decision at a top-k gap below
   2**-8, the routing recomputed on the CPU from the same input differing
   only below 1e-5; (b) the whole model in float32 compute, kernel path
   (the f32 route) against the plain path, within 1e-4; (c) 2 layers in
   float32 compute on CUDA against the CPU, within 1e-4; bf16 whole-model
   logits printed beside the decisions the two runs flip; prints the
   serving metrics, the MoE stages' device time, and each layer's dropped
   share of (token, slot) pairs;
19. the examples' torch twins (``examples/quickstart_torch.py``,
   ``fault_tolerance_torch.py``, ``kv_serving_torch.py``,
   ``train_lm_torch.py`` for 40 steps) on the card, their default device,
   and with ``--device cpu``: the same lines but for wall-clock numbers
   (and train_lm's run-specific text; its losses within 2e-2); the two
   chain examples launch the kv kernels on the card and call no plain
   version;
20. the hybrid family on phase 11's serving run: Zamba2-2.7B at full
   width and depth (54 SSM layers in 9 groups of 6, each group followed
   by the one shared attention block of 32 heads of 80; random weights
   from a seed; 16 requests of 2048-token prompts, 32 new tokens, 2
   waves), held to 18 attention launches all on the tensor-core route,
   108 of each kernel of the ssd pair and no plain call, with phase 11's
   holds on the outputs, determinism, the manual greedy loop and the
   version bump; the whole model in float32 compute at full depth on 2
   prompts, the kernel path (the f32 attention route, the ssd pair)
   against the plain path (naive attention, ``impl="chunked"``): prefill
   logits and ``lm_forward`` scoring within 1e-4 of their largest
   magnitude, and over 4 greedy decode steps the tokens equal wherever
   the plain path's top two lie more than 1e-3 of that magnitude apart;
   one group (6 layers) in float32 compute on CUDA against the CPU,
   within 1e-4 and equal tokens; the bf16 whole-model logits and scoring,
   kernel vs plain path, printed; prints the serving metrics and the
   prefill's device split (attention, the ssd pair, matrix products, the
   rest);
21. the encoder-decoder and the VLM stub frontend on phase 11's serving
   run: Whisper-base at full width and depth (6 encoder and 6 decoder
   layers of 8 heads of 64; random weights from a seed; 16 requests of
   128-token decoder prompts and 1,500 frames each, 64 new tokens, 2
   waves, a 192-position decoder cache), every prefill attention on the
   tensor-core route (the encoder's and the cross-attention non-causal):
   36 launches and no call of the kernel's plain version, the decode
   steps' cross-attention on the naive path as the reference routes it
   (one ``attention_ref`` call a decoder layer a step, counted); then
   InternVL2-26B at full width with its depth cut to 16 of 48 layers (one
   card holds 16), 256 vision embeddings ahead of 1,792 text tokens, 32
   new tokens, 32 launches; each with phase 11's holds (determinism, the
   manual greedy loop, the version bump, the naive path's prefill logits
   on seeded frames or embeddings, 2 layers of each stack on CUDA against
   the CPU), Whisper also in float32 compute at 2 + 2 layers on the f32
   route against the CPU (1e-4, equal tokens), InternVL2's text logits
   held to change with its embeddings; prints the serving metrics per
   wave (prefill ms, decode ms per token, tokens/s, p50/p99 latency, peak
   device memory), a decode step's busy share, the prefill's device split
   and Whisper's encoder's share of it;
22. training (``kernels/flash_attention/csrc/flash_attention_bwd.cu``,
   built beside the other sources): (a) the flash_attention kernel's
   forward with its log-sum-exp (the bottom-right causal offset of the
   reference's ``chunked_attention``) and the three backward launches
   (``flash_bwd_delta_kernel``, then dK/dV and dQ: bf16 on the
   tensor-core pair ``flash_bwd_dkdv_mma_kernel``,
   ``flash_bwd_dq_mma_kernel``, float32 and views TMA refuses on the
   f32 pair ``flash_bwd_dkdv_kernel``, ``flash_bwd_dq_kernel``, split
   TF32 on ``mma.sync``) against ``ref.chunked_fwd``/``chunked_bwd`` at
   ``BWD_CASES`` (the training shape [4, 16, 4096, 64] bf16 causal,
   Qwen2.5-3B's GQA group, head dim 80, ragged S = SK = 200, 200 queries
   after 700 keys, Whisper's cross-attention, float32, float32 at the GQA
   group, the training shape with a dO view TMA refuses), each case's
   launches by route: o, lse, dq, dk and dv each held, bf16 on the
   tensor-core pair to the error's norm against the plain version with
   its two roundings and against the unrounded one, bf16 on the f32 pair
   against the unrounded one, with two controls that must read past each
   (delta dropped, the causal mask dropped), float32 to its maximum
   against the plain version and its split TF32 emulation
   (``ref.chunked_bwd(..., split_tf32=True)``); ptxas's report of the
   f32 pair; each kernel timed at the training shape, the GQA group, head
   dim 80, float32, float32 GQA and the misaligned bf16 view beside its
   bound (the f32 pair's also beside its split TF32 bound), the plain
   version and SDPA (its forward, its whole backward), delta beside
   ``torch.linalg.vecdot``; (b)
   Qwen1.5-0.5B at full width and 2 layers, one loss and its gradients:
   float32, the kernel path against the plain path on the card (every
   leaf within 1e-4); bf16, the card against the CPU (loss and gradient
   norm within 2e-2); (c) the ``Trainer`` on Qwen1.5-0.5B at full width
   and depth (24 layers, random weights from seed 0; batch 4 of
   train_4k's 4,096-token sequences; chunked attention, full remat,
   chunked cross-entropy of 1,024; AdamW with warmup 2): 6 steps from
   the pipeline with a checkpoint after step 3 (48 forward launches and
   24 of each backward kernel a step, on the tensor-core pair), then in
   the same Trainer 8 steps
   on one repeated batch, which lower the loss by more than 0.5, and one
   profiled step (attention forward, attention backward, matrix
   products, the rest; busy share); a fresh Trainer restored from the
   checkpoint gives steps 4-6's losses bit for bit; prints ms a step,
   tokens/s, peak device memory and the seconds of each part;
23. the multi-device modules (``distributed/``, ``launch/``,
   ``roofline/``): (a) the dry-run's counter (``launch/dryrun.py`` on a
   one-device mesh) on phase 22 (c)'s training step and phase 11's
   prefill wave: counted FLOPs and bytes, model FLOPs, the roofline's
   compute and memory terms against the H100's data sheet, and, beside
   each run's measured time, ``mfu`` (model FLOPs over the time and the
   bf16 peak) and the bound's share of the time; (b) ``psum_compressed``
   and 3 steps of ``compress_with_feedback`` on 4 gloo ranks sharing the
   card, one Qwen1.5-0.5B layer's seeded gradients a rank: the CUDA
   ranks equal the CPU ranks bit for bit, the sum within 4 x (block max
   / 254) of the exact sum, the bytes a rank sends (the collective
   recorder) and the median ms of 5 calls after an untimed one; (c)
   Qwen2.5-3B at full width and 2 layers on a (1, 1) ``DeviceMesh`` under
   ``SINGLE_POD_SERVE``, every parameter a DTensor: the prefill's and a
   decode step's logits equal the run without rules bit for bit, with the
   same attention launches;
24. the port's contract linter (``src/repro_torch/analysis``: int32 lane
   pins, host syncs in code tagged sync-free, scatters in code tagged
   scatter-free) run as ``python -m repro_torch.analysis --strict
   --json`` in a subprocess over the package and this script: any
   finding fails the run; prints the findings per rule, the file count
   and the seconds.

Phase 10 also holds and times the kernel non-causal (``NONCAUSAL``):
Whisper's encoder (q, k, v [8, 8, 1500, 64]) and cross-attention (q [8,
8, 128, 64], k/v [8, 8, 1500, 64]) on the tensor-core route, ragged S >
SK and S < SK at head dims 80 and 128, and the f32 route at S < SK and
Whisper's cross-attention shape, each bound by all S x SK pairs; and
InternVL2's prefill shape (q [8, 48, 2048, 128], k/v [8, 8, 2048, 128]).

A kernel's ``launches`` in the record add up over the main paths that
ran it (phases 11, 18, 20 and 21 for the attention kernel, 13 and 20 for
the ssd pair, phase 22's 6-step Trainer run for the forward with lse,
``flash_attention_lse``, delta and the backward's tensor-core pair, its
float32 step check (b) for the backward's f32 pair), each counted from
zero just before its run.  ``--phases
12,13`` runs the build of the kernels those phases use, phase 1 and the
named phases only (4 and 5 bring 3 along, 8 brings 7, 23 brings 11
and 22; 15-22 and 24 stand alone);
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

import collections
import concurrent.futures
import contextlib
import copy
import dataclasses
import gc
import importlib.util
import io
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
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
    from repro_torch.kernels import build as kernel_build  # noqa: E402
    from repro_torch.kernels.kv_engine import kernel as kv_kernel  # noqa: E402
    from repro_torch.kernels.kv_engine import ops as kv_ops  # noqa: E402
    from repro_torch.kernels.kv_engine import ref as kv_ref  # noqa: E402
    from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402
    from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel  # noqa: E402
    from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
    from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402
    from repro_torch.models import api  # noqa: E402
    from repro_torch.models import attention as attn_lib  # noqa: E402
    from repro_torch.models import encdec as encdec_lib  # noqa: E402
    from repro_torch.models import layers as layers_lib  # noqa: E402
    from repro_torch.models import moe as moe_lib  # noqa: E402
    from repro_torch.obs import tail_percentiles  # noqa: E402
    from repro_torch.models import transformer as TF  # noqa: E402
    from repro_torch.models.transformer import OptFlags  # noqa: E402
    from repro_torch.serve import kv_cache as KV  # noqa: E402
    from repro_torch.serve import engine as engine_lib  # noqa: E402
    from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
    from repro_torch.train import optimizer as opt  # noqa: E402
    from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
    from repro_torch.distributed import compression  # noqa: E402
    from repro_torch.distributed import sharding as sh  # noqa: E402
    from repro_torch.launch import dryrun  # noqa: E402
    # the H100 SXM's data-sheet figures, every bound below reads them
    from repro_torch.roofline.analysis import (  # noqa: E402
        BF16_FLOP_PER_S, F32_FLOP_PER_S, HBM_BYTES_PER_S, TF32_FLOP_PER_S,
        CollectiveRecorder)
    from repro_torch.train.train_step import init_train_state  # noqa: E402
    from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: E402
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
KV_SRC = "src/repro_torch/kernels/kv_engine/csrc/kv_engine.cu"
FA_SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SSD_SRC = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
FA_BWD_SRC = ("src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_bwd.cu")
SOURCES = {"kv_read": KV_SRC, "kv_write": KV_SRC,
           "kv_bucketed_read": KV_SRC, "kv_bucketed_write": KV_SRC,
           "flash_attention": FA_SRC, "flash_attention_f32": FA_SRC,
           "ssd_cb": SSD_SRC, "ssd_scan": SSD_SRC,
           "flash_attention_lse": FA_SRC, "flash_bwd_delta": FA_BWD_SRC,
           "flash_bwd_dkdv": FA_BWD_SRC, "flash_bwd_dq": FA_BWD_SRC,
           "flash_bwd_dkdv_mma": FA_BWD_SRC, "flash_bwd_dq_mma": FA_BWD_SRC}
REPLACES = {
    "kv_read": "src/repro/kernels/kv_engine/kernel.py:153",
    "kv_write": "src/repro/kernels/kv_engine/kernel.py:510",
    "kv_bucketed_read": "src/repro/kernels/kv_engine/kernel.py:249",
    "kv_bucketed_write": "src/repro/kernels/kv_engine/kernel.py:339",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:96",
    "flash_attention_f32": "src/repro/kernels/flash_attention/kernel.py:96",
    "ssd_cb": "src/repro/kernels/ssd_scan/kernel.py:94",
    "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:94",
    "flash_attention_lse": "src/repro/kernels/flash_attention/kernel.py:96",
    # no pallas_call: the custom VJP of the reference's chunked_attention
    "flash_bwd_delta": "src/repro/kernels/flash_attention/ops.py:107",
    "flash_bwd_dkdv": "src/repro/kernels/flash_attention/ops.py:107",
    "flash_bwd_dq": "src/repro/kernels/flash_attention/ops.py:107",
    "flash_bwd_dkdv_mma": "src/repro/kernels/flash_attention/ops.py:107",
    "flash_bwd_dq_mma": "src/repro/kernels/flash_attention/ops.py:107",
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
# phase 18: the MoE family on the same serving run.  Granite-MoE-3B-A800M
# at full width and depth (32 layers, 40 experts padded to 48, top-8, in
# routing groups of 512 tokens); Llama-4-Scout-17B-16E at full width and 2
# of its 48 layers (16 experts top-1 and a shared expert: about 2.2 B
# parameters a layer, so all 48 would be some 105 B, 210 GB in bf16, past
# one 80 GB card), 8 requests of 2048-token prompts, 16 new tokens each.
MOE_ARCH, SCOUT_ARCH = "granite-moe-3b-a800m", "llama4-scout-17b-a16e"
SCOUT_LAYERS, SCOUT_REQUESTS, SCOUT_MAX_NEW = 2, 8, 16
# Top-k routing is discontinuous, so routing is held decision by decision:
# a (token, slot) whose expert differs between two runs on inputs that
# differ by rounding must sit where its probabilities lie closer than the
# rounding can move them: 2**-8, bf16's unit roundoff (the MoE inputs are
# bf16, and a probability is below 1) between the kernel and plain paths;
# 1e-5 between the card and the CPU on the same input (the router is
# float32 on both, summed in another order).
BF16_GAP_TOL, F32_GAP_TOL = 2.0 ** -8, 1e-5
# the gaps of the decisions that differ are counted between these edges
GAP_EDGES = (1e-7, 1e-6, 1e-5, 1e-4, 1e-3, BF16_GAP_TOL)
# a block's output on the tokens whose routing agrees, kernel against plain
# path (one attention call in bf16: phase 10's tolerance), and the float32
# logits of a whole model or of 2 layers on the card against the CPU (the
# f32 route's serving tolerance)
MOE_LAYER_TOL, F32_TOL = 2e-2, 1e-4
# phase 20: the hybrid family on the same serving run, Zamba2-2.7B at full
# width and depth (54 SSM layers, the shared attention block after every
# 6: 9 applications; 32 heads of 80); the whole model in float32 compute
# on 2 of the first wave's prompts, kernel path against the plain path,
# for its prefill, its scoring and 4 greedy decode steps, whose argmax is
# held wherever the plain path's top two lie more than HYBRID_GAP of the
# logits' largest magnitude apart
HYBRID_ARCH = "zamba2-2.7b"
HYBRID_F32_PROMPTS, HYBRID_STEPS, HYBRID_GAP = 2, 4, 1e-3
# phase 21: the encoder-decoder and the VLM stub frontend on the same
# serving run.  Whisper-base at full width and depth (6 encoder and 6
# decoder layers, 8 heads of 64): 16 requests of 128-token decoder
# prompts, 64 new tokens each, 2 waves, the encoder running 1,500 frames a
# request; the decoder cache holds 192 positions (Whisper's own table
# holds 448).  InternVL2-26B at full width and depth, 48 layers: some
# 19.9 B parameters, 79.6 GB in float32, which one card cannot hold beside
# a bf16 copy, so its weights are drawn in the compute dtype
# (``init_params(compute_dtype=True)``, one block in float32 at a time):
# 39.8 GB in bf16, and the cache of phase 11 (2,080 positions, 3.3 GB)
# holds a wave of 256 vision embeddings ahead of 1,792 text tokens (S =
# 2,048, as phases 11, 13, 18 and 20), 32 new tokens.  The engine feeds the
# stub frontends zeros, as the reference's does; the held comparisons feed
# seeded inputs (normal x 0.1, as the reference's make_batch draws them).
WHISPER_ARCH, WHISPER_PROMPT_LEN, WHISPER_CACHE_LEN = "whisper-base", 128, 192
WHISPER_MAX_NEW = 64
VLM_ARCH = "internvl2-26b"
VLM_PROMPT_LEN = PROMPT_LEN - get_config(VLM_ARCH).vis_len
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
    per (query, key) pair under the kernel's mask: the causal pairs
    (top-left), or all S x SK of them when non-causal."""
    B, HQ, S, D = q.shape
    HKV, SK = k.shape[1], k.shape[2]
    pairs = (sum(min(i + 1, SK) for i in range(S)) if causal else S * SK)
    nbytes = q.element_size() * D * (2 * B * HQ * S + 2 * B * HKV * SK)
    return nbytes, 4 * D * B * HQ * pairs


def f32_route_peak(dtype) -> float:
    """The f32 forward's rate, in operations of ``attention_bound`` a
    second: S and P V are each half of them, on the TF32 tensor cores in
    three split products, or on bf16 inputs one (S) and two (P V)."""
    return TF32_FLOP_PER_S / (1.5 if dtype == torch.bfloat16 else 3)


def f32_route_ms(q, k, v) -> float:
    """Device ms a call of the f32 kernel on bf16 inputs of these shapes,
    read through views whose rows are not 16-byte aligned (which the
    tensor-core route does not take): the design that route replaced."""
    D = q.shape[3]
    padded = [torch.empty(x.shape[:3] + (D + 1,), dtype=x.dtype,
                          device="cuda")[..., :D] for x in (q, k, v)]
    for dst, src in zip(padded, (q, k, v)):
        dst.copy_(src)
    require(fa_kernel.route(*padded) == "f32",
            "a misaligned bf16 view should take the f32 route")
    time_calls([lambda: fa_kernel.flash_attention(*padded)] * 2)
    # a call is one launch: its time is the mean over the records the
    # profiler kept (a window late in a long run may drop one)
    counts: dict[str, int] = {}
    kernels = device_time([lambda: fa_kernel.flash_attention(*padded)] * 3,
                          counts=counts)[1]
    return (sum(us / counts[k] for k, us in kernels.items()) / 1e3
            if kernels else None)


# The non-causal cases of phase 10, as (B, S, SK, dtype, tolerance, route,
# heads): Whisper's encoder self-attention and its cross-attention (128
# decoder positions against the 1,500 frames, 1,500 = 23 x 64 + 28: a
# ragged key edge) at one layer's prefill of phase 21, ragged S > SK and
# S < SK at head dims 80 (Zamba2's heads) and 128 (Qwen2.5-3B's), and the
# f32 route at S < SK and at Whisper's cross-attention
NONCAUSAL = {
    "whisper_encoder": (SLOTS, 1500, 1500, torch.bfloat16, 2e-2, "mma",
                        "whisper"),
    "whisper_cross": (SLOTS, 128, 1500, torch.bfloat16, 2e-2, "mma",
                      "whisper"),
    "nc_d80_s_gt_sk": (2, 700, 200, torch.bfloat16, 2e-2, "mma", "zamba2"),
    "nc_d80_s_lt_sk": (2, 200, 700, torch.bfloat16, 2e-2, "mma", "zamba2"),
    "nc_d128_s_gt_sk": (2, 700, 200, torch.bfloat16, 2e-2, "mma", "qwen"),
    "nc_d128_s_lt_sk": (2, 200, 700, torch.bfloat16, 2e-2, "mma", "qwen"),
    "nc_f32_s_lt_sk": (2, 200, 700, torch.float32, 2e-5, "f32", "qwen"),
    "nc_f32_whisper_cross": (SLOTS, 128, 1500, torch.float32, 2e-5, "f32",
                             "whisper"),
}


# The decoder's causal self-attention of phase 21's Whisper prefill (128
# prompt positions), checked and timed beside the non-causal cases
WHISPER_DECODER = {"whisper_decoder": (SLOTS, WHISPER_PROMPT_LEN,
                                       WHISPER_PROMPT_LEN, torch.bfloat16,
                                       2e-2, "mma", "whisper")}
# A bf16 case is also held to its error's norm over the plain version's
# (``rms_err``), which at N(0, 1) inputs rounding alone keeps near bf16's
# unit roundoff (2**-9) while the absolute 2e-2 cannot see a fault that
# moves outputs of some 0.04 by 1%.  The limit is twice the largest
# reading of a sound kernel (0.0024, Whisper's encoder on an H100; PERF.md
# section 6).  A non-causal
# kernel that dropped its key mask past SK would let the last tile's
# zero-filled keys (score 0, value 0) into every row's softmax, diluting
# it by pad / (SK e^(1/2) + pad); ``unmasked_tail`` computes that
# function, and each case whose padded keys are at least MASK_SHARE of its
# tile-rounded keys must read past its limit with it (the control).
BF16_RMS_TOL = 5e-3
TILE_KEYS = 64          # keys per K/V tile of both CUDA kernels
MASK_SHARE = 0.01


def rms_err(got, exp) -> float:
    d = got.float() - exp.float()
    return float(d.norm() / exp.float().norm())


def unmasked_tail(q, k, v):
    """The plain version of a non-causal case with the last tile's keys
    past SK left in (zero keys and values): what a kernel that dropped its
    key mask would compute.  None when SK fills its tiles, or its padded
    keys are under MASK_SHARE of them."""
    SK = k.shape[2]
    pad = -SK % TILE_KEYS
    if pad < MASK_SHARE * (SK + pad):
        return None
    def zero_fill(x):
        return torch.cat([x, x.new_zeros(x.shape[:2] + (pad, x.shape[3]))],
                         dim=2)
    return fa_ref.flash_attention_ref(q, zero_fill(k), zero_fill(v),
                                      causal=False)


def check_flash_attention() -> dict:
    """Both routes of the kernel against its plain version on the card:
    the tensor-core route at the serving shape (one layer's prefill of
    phase 11), a ragged tile edge and S > SK, the f32 route at float32 and
    S < SK, each case held to the route ``fa_kernel.route`` gives it; then
    times each route beside its plain version, the SDPA yardstick and its
    bound: the tensor-core route at the serving shape, the f32 route at
    its float32 case.  The design the tensor-core route replaced (the f32
    kernel, which a misaligned bf16 view still takes) is timed at the
    serving shape too.  Then the prefill shapes of phases 18, 20 and 21
    on the tensor-core route, checked and timed the same way; Zamba2's
    head dim 80, below the kernel's width of 128, also ragged, with S !=
    SK both ways, and the head dims 32 and 72, and the f32 kernel timed
    at its prefill shape (the route it took before).  Then Whisper's
    causal decoder self-attention (``WHISPER_DECODER``) and the
    non-causal cases (``NONCAUSAL``), checked and timed the same way, the
    latter's bound counting all S x SK pairs.  Every bf16 case is also
    held to its error's norm (``BF16_RMS_TOL``), and each non-causal case
    with a ragged key edge to the dropped-mask control (``unmasked_tail``)
    reading past its limit."""
    cfg = get_config(SERVE_ARCH)
    HQ, HKV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    bf16, f32 = torch.bfloat16, torch.float32
    heads = {name: (c.n_heads, c.n_kv_heads, c.head_dim)
             for name, c in prefill_configs().items()}
    zamba = heads["zamba2"]
    cases = [("serving", SLOTS, PROMPT_LEN, PROMPT_LEN, bf16, 2e-2, "mma"),
             ("float32", 2, PROMPT_LEN, PROMPT_LEN, f32, 2e-5, "f32"),
             ("ragged", SLOTS, 200, 200, bf16, 2e-2, "mma"),
             ("s_lt_sk", 2, 200, 700, f32, 2e-5, "f32"),
             ("s_gt_sk", 2, 700, 200, bf16, 2e-2, "mma")]
    # phases 18, 20 and 21's prefill shapes: one layer's attention of a
    # wave
    cases += [(name, SLOTS, PROMPT_LEN, PROMPT_LEN, bf16, 2e-2, "mma")
              for name in heads]
    # head dims below the tensor-core kernel's width, read with zero fill
    extra = {"d80_ragged": zamba, "d80_s_gt_sk": zamba,
             "d80_s_lt_sk": zamba, "d32": (8, 2, 32), "d72": (8, 8, 72)}
    cases += [("d80_ragged", SLOTS, 200, 200, bf16, 2e-2, "mma"),
              ("d80_s_gt_sk", 2, 700, 200, bf16, 2e-2, "mma"),
              ("d80_s_lt_sk", 2, 200, 700, bf16, 2e-2, "mma"),
              ("d32", 2, 1000, 1000, bf16, 2e-2, "mma"),
              ("d72", 2, 1000, 1000, bf16, 2e-2, "mma")]
    whisper = get_config(WHISPER_ARCH)
    model_heads = {**heads, "qwen": (HQ, HKV, D),
                   "whisper": (whisper.n_heads, whisper.n_kv_heads,
                               whisper.head_dim)}
    for name, (B, S, SK, dtype, tol, want, model) in {
            **WHISPER_DECODER, **NONCAUSAL}.items():
        cases.append((name, B, S, SK, dtype, tol, want))
        extra[name] = model_heads[model]
    heads_of = {**heads, **extra}
    gen = torch.Generator(device="cuda").manual_seed(13)
    errs = {"mma": {}, "f32": {}}
    rms, controls, split = {}, {}, {}
    ptxas = ptxas_of("flash_fwd_kernel<")
    log(ptxas_line("the f32 forward", ptxas))
    for name, B, S, SK, dtype, tol, want in cases:
        HQ, HKV, D = heads_of.get(name, (cfg.n_heads, cfg.n_kv_heads,
                                         cfg.head_dim))
        causal = name not in NONCAUSAL
        q, k, v = attention_inputs(gen, B, HQ, HKV, S, SK, D, dtype)
        fa_kernel.reset_launches()
        got = fa_kernel.flash_attention(q, k, v, causal=causal)
        exp = fa_ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        require(fa_kernel.LAUNCHES[f"flash_attention_{want}"] == 1,
                f"flash_attention {name}: took the wrong route "
                f"{fa_kernel.LAUNCHES}, want {want}")
        require(got.stride() == q.stride(), f"flash_attention {name}: "
                f"output strides {got.stride()}, q's {q.stride()}")
        err = float((got.float() - exp.float()).abs().max())
        require(bool(torch.isfinite(got).all()),
                f"flash_attention {name}: non-finite output")
        mask = "causal" if causal else "non-causal"
        what = (f"flash_attention {name} [{B}, {HQ}/{HKV}, {S}, {SK}, {D}] "
                f"{dtype} {mask}")
        require(err <= tol, f"{what}: differs from its plain version by "
                f"{err} > {tol}")
        errs[want][name] = err
        if want == "f32":   # float32 here: also its split TF32 emulation
            emu = fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                             split_tf32=True)
            split[name] = float((got - emu).abs().max() / emu.abs().max())
            require(split[name] <= SPLIT_TOL, f"{what}: reads "
                    f"{split[name]} of the split TF32 emulation's largest "
                    f"magnitude > {SPLIT_TOL}")
            del emu
        # bf16: also the error's norm; non-causal: the dropped-mask control
        half = dtype == torch.bfloat16
        held = f"max abs err {err:.3g} (tolerance {tol})"
        if name in split:
            held += (f", {split[name]:.3g} of the split TF32 emulation's "
                     f"largest magnitude (limit {SPLIT_TOL})")
        if half:
            rms[name] = rms_err(got, exp)
            require(rms[name] <= BF16_RMS_TOL, f"{what}: error norm "
                    f"{rms[name]} of the plain version's > {BF16_RMS_TOL}")
            held += (f", error norm {rms[name]:.3g} of the plain version's "
                     f"(limit {BF16_RMS_TOL})")
        ctrl = None if causal else unmasked_tail(q, k, v)
        if ctrl is not None:
            c_err = (rms_err(ctrl, exp) if half else
                     float((ctrl.float() - exp.float()).abs().max()))
            limit = BF16_RMS_TOL if half else tol
            require(c_err > limit, f"{what}: the plain version with its key "
                    f"mask dropped reads {c_err} <= {limit}: the hold cannot "
                    "see a dropped mask")
            controls[name] = c_err
            held += (f"; with the key mask dropped past SK "
                     f"({-SK % TILE_KEYS} keys) the plain version reads "
                     f"{c_err:.3g}")
        log(f"flash_attention {name} ({want} route, {mask}): q [{B}, {HQ}, "
            f"{S}, {D}], k/v [{B}, {HKV}, {SK}, {D}] {str(dtype)[6:]}: "
            f"{held}")
        del q, k, v, got, exp, ctrl
    HQ, HKV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def record(q, k, v, peak, causal=True):
        nbytes, flop = attention_bound(q, k, causal)
        return dict(
            calls=lambda n: [lambda: fa_kernel.flash_attention(
                q, k, v, causal=causal)] * n,
            plain=lambda n: [lambda: fa_ref.flash_attention_ref(
                q, k, v, causal=causal)] * n,
            # timed here only; the port never calls it
            library=lambda n: [lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)] * n,
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
        "flash_attention_f32": dict(record(*single, f32_route_peak(f32)),
                                    max_abs_err=max(errs["f32"].values()),
                                    case_errs=errs["f32"],
                                    split_errs=split, ptxas=ptxas)})
    # the bound of the route's earlier design on the CUDA cores, for
    # comparison: the same operations at the f32 CUDA-core peak
    nbytes, flop = attention_bound(*single[:2])
    out["flash_attention_f32"]["cuda_core_bound_ms"] = max(
        nbytes / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S) * 1e3
    for name, (q, k, _), peak in (("flash_attention", serving, "bf16 "
                                   "tensor-core peak"),
                                  ("flash_attention_f32", single,
                                   "TF32 tensor-core peak, three split "
                                   "products")):
        rec = out[name]
        nbytes, flop = attention_bound(q, k)
        rec["tflop_per_s"] = flop / rec["ms"] / 1e9
        log(f"{name} at q {list(q.shape)} {str(q.dtype)[6:]}: "
            f"{flop / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; {rec['ms']:.4f}"
            f" ms per call = {rec['tflop_per_s']:.1f} TFLOP/s; SDPA "
            f"{rec['library_ms']:.4f} ms; bound {rec['bound_ms']:.4f} ms by "
            f"{rec['bound_by']} at the {peak}"
            + (f"; at the f32 CUDA-core peak {rec['cuda_core_bound_ms']:.4f}"
               " ms" if "cuda_core_bound_ms" in rec else "")
            + f" ({smi()})")
    # the replaced design: a bf16 view whose rows are not 16-byte aligned
    # takes the f32 kernel
    old_ms = f32_route_ms(*serving)
    out["flash_attention"]["replaced_design_ms"] = old_ms
    log(f"flash_attention at the serving shape on the design this route "
        f"replaced (the f32 kernel, bf16 inputs): {old_ms} ms per call")
    del serving, single
    # phases 18, 20 and 21's shapes on the tensor-core route, timed as the
    # serving one; Zamba2's also on the f32 kernel, its route before; then
    # the non-causal cases
    timed = {name: (SLOTS, PROMPT_LEN, PROMPT_LEN, bf16, None, "mma", name)
             for name in heads}
    timed.update(WHISPER_DECODER)
    timed.update(NONCAUSAL)
    shapes, noncausal = {}, {}
    for name, (B, S, SK, dtype, _, want, model) in timed.items():
        hq, hkv, d = model_heads[model]
        causal = name not in NONCAUSAL
        qkv = attention_inputs(gen, B, hq, hkv, S, SK, d, dtype)
        peak, peak_name = ((BF16_FLOP_PER_S, "bf16 tensor-core")
                           if want == "mma" else
                           (f32_route_peak(dtype), "split TF32 tensor-core"))
        rec = measure({name: dict(record(*qkv, peak, causal),
                                  max_abs_err=errs[want][name],
                                  rms_err=rms.get(name),
                                  unmasked_tail_err=controls.get(name))
                       })[name]
        nbytes, flop = attention_bound(*qkv[:2], causal)
        rec["tflop_per_s"] = flop / rec["ms"] / 1e9
        rec["route"] = want
        if name == "zamba2":
            rec["f32_route_ms"] = f32_route_ms(*qkv)
        (shapes if causal else noncausal)[name] = rec
        log(f"flash_attention at {name} ({want} route, "
            f"{'causal' if causal else 'non-causal'}) q {list(qkv[0].shape)}"
            f" k/v {list(qkv[1].shape)} {str(dtype)[6:]} ({smi()}): "
            f"{flop / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; {rec['ms']:.4f}"
            f" ms per call = {rec['tflop_per_s']:.1f} TFLOP/s; plain version"
            f" {rec['plain_ms']:.4f} ms; SDPA {rec['library_ms']:.4f} ms; "
            f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} at the "
            f"{peak_name} peak"
            + (f"; the f32 kernel (its route before head dim {d} took the "
               f"tensor cores) {rec['f32_route_ms']} ms"
               if "f32_route_ms" in rec else ""))
        del qkv
    out["flash_attention"]["prefill_shapes"] = shapes
    out["flash_attention"]["noncausal_shapes"] = noncausal
    out["flash_attention"]["rms_errs"] = rms
    out["flash_attention"]["unmasked_tail_errs"] = controls
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
    computes the scan, one ``torch.matmul`` computes C B^T per chunk.
    Zamba2's layer of phase 20 (x [8, 2048, 80, 64], state 64) is held
    and timed the same way."""
    cfg = get_config(SSM_ARCH)
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    zcfg = get_config(HYBRID_ARCH)
    zamba = (zcfg.ssm_heads, zcfg.ssm_headdim, zcfg.ssm_state)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("prefill", SLOTS, SSM_PROMPT_LEN, 64, bf16, 1e-2),
             ("float32", 2, SSM_PROMPT_LEN, 64, f32, 1e-5),
             ("L2048", 2, 2048, 64, bf16, 1e-2),
             ("short", SLOTS, 40, 64, bf16, 1e-2),
             ("chunk16", 2, 500, 16, f32, 1e-5),
             ("chunk32", 2, 500, 32, bf16, 1e-2),
             ("zamba2", SLOTS, PROMPT_LEN, 64, bf16, 1e-2)]
    gen = torch.Generator(device="cuda").manual_seed(17)
    errs = {}
    for name, Bz, L, chunk, dtype, tol in cases:
        H, P, N = zamba if name == "zamba2" else (
            cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state)
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
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
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
    del x, dt, A, Bm, Cm, D, padded
    # Zamba2's layer of phase 20, the pair timed as at the prefill shape
    zx = ssd_inputs(gen, SLOTS, PROMPT_LEN, *zamba, bf16)
    nbytes, flop, _ = ssd_bound(zx[0], zx[3])
    rec = measure({"zamba2": dict(
        max_abs_err=errs["zamba2"]["y"],
        calls=lambda n: [lambda: ssd_kernel.ssd_scan_heads(
            *zx, h_final=True)] * n,
        plain=lambda n: [lambda: ssd_ops.ssd(
            *zx, impl="chunked", return_state=True)] * n,
        library=None, bound_bytes=nbytes, bound_flop=flop,
        iters=FA_ITERS)})["zamba2"]
    zsplit = {("ssd_cb" if "ssd_cb_kernel" in k else "ssd_scan" if
               "ssd_scan_kernel" in k else k[:40]): us
              for k, us in rec["device_kernels_us"].items()}
    out["ssd_scan"]["zamba2_shape"] = rec
    log(f"ssd_scan at Zamba2's prefill x {list(zx[0].shape)} bf16, N "
        f"{zamba[2]} ({smi()}): {rec['ms'] * 1e3:.2f} us per call (plain "
        f"{rec['plain_ms'] * 1e3:.2f} us), per kernel of the pair "
        + ", ".join(f"{k} {us:.2f} us" for k, us in zsplit.items())
        + f"; {flop / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB; bound "
        f"{rec['bound_ms'] * 1e3:.2f} us by {rec['bound_by']}")
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
def plain_calls(pairs):
    """``PlainCalls`` over several ``(module, names)`` pairs at once; yields
    one view of all their counts by name."""
    with contextlib.ExitStack() as stack:
        yield collections.ChainMap(*(
            stack.enter_context(PlainCalls(module, names)).calls
            for module, names in pairs))


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


@contextlib.contextmanager
def naive_attention_chunked_ssd():
    """The hybrid model's plain path: prefill attention on the naive
    softmax, the SSD core on ``impl="chunked"``."""
    with chunked_ssd():
        yield OptFlags(attn_impl="naive")


@dataclasses.dataclass(frozen=True)
class PathKernel:
    """A kernel a serving path's prefill launches: its wrapper module and
    counter (``kernel.LAUNCHES[key]``; every launch also under ``route``
    where the kernel has routes), its launches in one prefill or scoring
    pass of a config (``per_pass(cfg)``), the plain version the CPU calls
    in place of its launches (None: none of its own), and the part of the
    prefill's device time its launches make (device kernel names that hold
    ``tag``)."""
    kernel: object
    key: str
    route: str | None
    per_pass: object
    cpu_plain: str | None
    part: str
    tag: str


def every_layer(cfg) -> int:
    return cfg.n_layers


def encdec_calls(cfg) -> int:
    """The encoder-decoder's prefill: each encoder layer's self-attention
    and each decoder layer's self- and cross-attention."""
    return cfg.enc_layers + 2 * cfg.dec_layers


def every_group(cfg) -> int:
    """The hybrid's shared attention: once after each group of
    ``shared_attn_every`` SSM layers."""
    return cfg.n_layers // cfg.shared_attn_every


ATTENTION = PathKernel(fa_kernel, "flash_attention", "flash_attention_mma",
                       every_layer, "flash_attention_ref", "attention",
                       "flash_")
SSD_PAIR = (PathKernel(ssd_kernel, "ssd_scan", None, every_layer,
                       "ssd_chunked", "ssd pair", "ssd_"),
            PathKernel(ssd_kernel, "ssd_cb", None, every_layer, None,
                       "ssd pair", "ssd_"))
FA_PLAIN = (fa_ref, ("flash_attention_ref", "attention_ref"))
SSD_PLAIN = (ssd_ref, ("ssd_chunked", "ssd_scan_with_final_ref"))


@dataclasses.dataclass(frozen=True)
class ServePath:
    """One serving path: the model, its prompts, the kernels its prefill
    launches, their plain versions (``(module, names)`` pairs) and the
    plain path the kernel path is held to at full depth."""
    phase: int
    arch: str
    prompt_len: int
    cache_len: int
    kernels: tuple         # PathKernel, ...
    plain: tuple
    flags: OptFlags
    plain_path: object
    score: bool            # also hold lm_forward (scoring) to the plain path
    # the bf16 prefill logits (and scoring), kernel vs plain path, within
    # this share of their max magnitude (None: printed, not held)
    bf16_tol: float | None = 5e-2
    n_layers: int | None = None    # a depth cut (None: the config's)
    requests: int = N_REQUESTS
    max_new: int = MAX_NEW
    # plain versions a decode step calls once per decoder layer (Whisper's
    # cross-attention of the new position, on the naive path as the
    # reference routes it); none of the kernel's own
    decode_plain: tuple = ()
    # the weights drawn in the compute dtype (float32 ones would not fit)
    compute_init: bool = False


SERVE_PATHS = {
    "dense": ServePath(11, SERVE_ARCH, PROMPT_LEN, CACHE_LEN, (ATTENTION,),
                       (FA_PLAIN,), OptFlags(attn_impl="pallas"),
                       naive_attention, False),
    "ssm": ServePath(13, SSM_ARCH, SSM_PROMPT_LEN, SSM_PROMPT_LEN, SSD_PAIR,
                     (SSD_PLAIN,), OptFlags(), chunked_ssd, True),
    "moe": ServePath(18, MOE_ARCH, PROMPT_LEN, CACHE_LEN, (ATTENTION,),
                     (FA_PLAIN,), OptFlags(attn_impl="pallas"),
                     naive_attention, False),
    "scout": ServePath(18, SCOUT_ARCH, PROMPT_LEN, CACHE_LEN, (ATTENTION,),
                       (FA_PLAIN,), OptFlags(attn_impl="pallas"),
                       naive_attention, False, n_layers=SCOUT_LAYERS,
                       requests=SCOUT_REQUESTS, max_new=SCOUT_MAX_NEW),
    # the bf16 logits of 54 layers are printed, not held: phases 10 and 12
    # hold the bf16 kernels at this model's shapes, and the float32 run at
    # full depth holds the algorithm (hybrid_float32)
    "hybrid": ServePath(20, HYBRID_ARCH, PROMPT_LEN, CACHE_LEN,
                        (dataclasses.replace(ATTENTION, per_pass=every_group),
                         *SSD_PAIR),
                        (FA_PLAIN, SSD_PLAIN), OptFlags(attn_impl="pallas"),
                        naive_attention_chunked_ssd, True, bf16_tol=None),
    "whisper": ServePath(21, WHISPER_ARCH, WHISPER_PROMPT_LEN,
                         WHISPER_CACHE_LEN,
                         (dataclasses.replace(ATTENTION,
                                              per_pass=encdec_calls),),
                         (FA_PLAIN,), OptFlags(attn_impl="pallas"),
                         naive_attention, False, max_new=WHISPER_MAX_NEW,
                         decode_plain=("attention_ref",)),
    "vlm": ServePath(21, VLM_ARCH, VLM_PROMPT_LEN, CACHE_LEN, (ATTENTION,),
                     (FA_PLAIN,), OptFlags(attn_impl="pallas"),
                     naive_attention, False, compute_init=True),
}


def path_config(path: ServePath):
    cfg = get_config(path.arch)
    return (cfg if path.n_layers is None
            else dataclasses.replace(cfg, n_layers=path.n_layers))


def prefill_configs() -> dict:
    """The decoders of phases 18, 20 and 21 whose prefill shapes phases 10
    and 12 check, Scout at its depth cut."""
    return {"granite": path_config(SERVE_PATHS["moe"]),
            "scout": path_config(SERVE_PATHS["scout"]),
            "zamba2": path_config(SERVE_PATHS["hybrid"]),
            "internvl2": path_config(SERVE_PATHS["vlm"])}


def stub_inputs(cfg, B: int, device, seed: int | None = None) -> dict:
    """The stub frontend's inputs of a batch of ``B`` (the engine's:
    ``frames`` for the encoder-decoder, ``embeds`` for the VLM): zeros, as
    the engine feeds them, unless a seed is given, then normal x 0.1 (the
    reference's make_batch), drawn on the CPU so every device gets the
    same values."""
    zeros = engine_lib.stub_inputs(cfg, B, device)
    if seed is None:
        return zeros
    gen = torch.Generator().manual_seed(seed)
    return {name: (torch.randn(x.shape, generator=gen) * 0.1).to(x)
            for name, x in zeros.items()}


def decode_plain_calls(path: ServePath, cfg, steps: int) -> dict:
    """The plain-version calls ``steps`` decode steps of the path make (by
    name, every counted name listed): Whisper's naive cross-attention,
    once per decoder layer a step."""
    out = dict.fromkeys((n for _, names in path.plain for n in names), 0)
    for name in path.decode_plain:
        out[name] += steps * cfg.dec_layers
    return out


def reset_path(path: ServePath) -> None:
    for module in {id(k.kernel): k.kernel for k in path.kernels}.values():
        module.reset_launches()


def path_launches(path: ServePath) -> dict:
    """Every counter of the path's kernels, as they stand."""
    out = {}
    for k in path.kernels:
        out.update(k.kernel.LAUNCHES)
    return out


def check_launches(path: ServePath, cfg, passes: int, what: str,
                   route_of=None) -> dict:
    """Each kernel of the path launched ``per_pass(cfg) * passes`` times,
    every launch on its route (``route_of``: a kernel key's route in place
    of the path's own).  Returns the counts by key."""
    got = path_launches(path)
    for k in path.kernels:
        want = k.per_pass(cfg) * passes
        route = (route_of or {}).get(k.key, k.route)
        require(got[k.key] == want and (route is None or got[route] == want),
                f"{what}: {got[k.key]} {k.key} launches, want {want}"
                + ("" if route is None else f" all on {route}")
                + f" (all launches {got})")
    return {k.key: got[k.key] for k in path.kernels}


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
                  parts: dict) -> dict:
    """Wall time of one warm prefill of ``batch`` and where its device
    time goes (torch.profiler): each of the path's kernels (``parts``:
    part name -> a tag its device kernels' names hold), matrix products
    (cuBLAS/cuBLASLt, CUTLASS) and everything else."""
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
    split = {**dict.fromkeys(parts, 0.0), "matmul": 0.0, "other": 0.0}
    for name, us in kernels.items():
        low = name.lower()
        part = next((p for p, tag in parts.items() if tag in name),
                    "matmul" if any(t in low for t in gemm_tags)
                    else "other")
        split[part] += us / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_ms": dev_ms,
            "busy_share": None if dev_ms is None else dev_ms / wall_ms,
            "device_ops": count, "device_ms_by_part": split,
            "top_device_us": {k[:60]: v for k, v in top}}


def describe(cfg) -> str:
    if cfg.family == "encdec":
        return (f"{cfg.enc_layers} encoder and {cfg.dec_layers} decoder "
                f"layers, heads {cfg.n_heads}/{cfg.n_kv_heads} of "
                f"{cfg.head_dim}, d_ff {cfg.d_ff}, {cfg.enc_len} frames a "
                "request")
    ssm = (f"d_inner {cfg.d_inner}, {cfg.ssm_heads} SSD heads of "
           f"{cfg.ssm_headdim}, state {cfg.ssm_state}, conv {cfg.ssm_conv}")
    if cfg.family == "ssm":
        return ssm
    out = (f"heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, d_ff "
           f"{cfg.d_ff}")
    if cfg.family == "hybrid":
        return (f"{ssm}; the shared attention block after every "
                f"{cfg.shared_attn_every} SSM layers ({every_group(cfg)} "
                f"applications): {out}")
    if cfg.family == "moe":
        out += (f", {cfg.n_experts} experts (padded to "
                f"{cfg.n_experts_padded}) top-{cfg.top_k}"
                + (" and a shared expert" if cfg.shared_expert else "")
                + f", routing groups of up to {cfg.moe_group_tokens} tokens, "
                f"capacity factor {cfg.capacity_factor}; "
                f"{cfg.param_count(True) / 1e9:.3f} B active of "
                f"{cfg.param_count() / 1e9:.3f} B without embeddings")
    if cfg.vis_len:
        out += f", {cfg.vis_len} vision embeddings ahead of the prompt"
    return out


def serving_phase(path: ServePath, device="cuda") -> dict:
    """examples/kv_serving.py on the card at the model's full width and
    depth: the coordination store keeps model version and serving epoch,
    the engine serves 16 requests in 2 waves with prefill through the
    path's kernel, and the run is held to its outputs, its launches,
    determinism, a manual greedy loop, the plain path (and for scoring
    models lm_forward on both) and, at 2 layers, the CPU's plain
    versions."""
    cfg = path_config(path)
    flags = path.flags
    name = f"serving {cfg.name}"
    n_req, max_new = path.requests, path.max_new
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
    params = api.init_params(cfg, gen, device,
                             compute_dtype=path.compute_init)
    eng = ServingEngine(cfg, params, slots=SLOTS, cache_len=path.cache_len,
                        flags=flags, device=device)
    sync(device)
    n_params = sum(p.numel() for p in params.parameters())
    cut = ("" if path.n_layers is None else
           f" (depth cut to {cfg.n_layers} of "
           f"{get_config(path.arch).n_layers} layers: one card)")
    depth = "" if cfg.family == "encdec" else f"{cfg.n_layers} layers, "
    log(f"{name} at full width{cut}: {n_params / 1e9:.3f} B params "
        f"({depth}d_model {cfg.d_model}, {describe(cfg)}, "
        f"vocab {cfg.vocab_padded}); weights made and cast"
        + (" part by part" if path.compute_init else "") + " in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{memory_gib(device)} GiB; coordination "
        f"store: model_version=1, epoch=1; hedged reads target "
        f"{hedge.targets(1, coord.chains[0])}")

    rng = np.random.default_rng(SERVE_SEED)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab,
                                               path.prompt_len),
                    max_new=max_new) for i in range(n_req)]
    sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_path(path)
    peaks = []

    def wave_peak(_):
        # each wave's own peak
        peaks.append(memory_gib(device, peak=True))
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
    with plain_calls(path.plain) as plain:
        t0 = time.perf_counter()
        done = eng.run(reqs, prompt_len=path.prompt_len, on_wave=wave_peak)
        wall = time.perf_counter() - t0
    n_waves = len(eng.waves)
    require(n_waves == -(-n_req // eng.slots),
            f"{name}: {n_waves} waves of {n_req} requests")
    require(len(done) == n_req, f"{name}: {len(done)} requests done")
    for r in done:
        require(r.output is not None and len(r.output) == max_new and
                int(r.output.min()) >= 0 and
                int(r.output.max()) < cfg.vocab_padded,
                f"{name}: request {r.rid} output {r.output}")
    launches = check_launches(path, cfg, n_waves, name)
    all_launches = path_launches(path)
    # no plain version of the kernel; Whisper's decode steps call the
    # naive cross-attention, as the reference routes them
    want_plain = decode_plain_calls(path, cfg, n_waves * (max_new - 1))
    require(dict(plain) == want_plain,
            f"{name}: plain-version calls {dict(plain)} on the kernel path, "
            f"want {want_plain}")
    lat = eng.latencies_ms
    waves, start = [], 0
    # the positions a prefill runs: the vision embeddings and the prompt;
    # the encoder-decoder's decoder prompt, its frames counted apart
    positions = cfg.vis_len + path.prompt_len
    frames = cfg.enc_len if cfg.family == "encdec" else 0
    for i, w in enumerate(eng.waves):
        ms = w["prefill_ms"] + w["decode_ms"]
        wave_lat = lat[start: start + w["requests"]]
        start += w["requests"]
        per_s = w["requests"] / w["prefill_ms"] * 1e3
        waves.append({**w, "decode_ms_per_token": w["decode_ms"]
                      / max(w["decode_steps"], 1),
                      "prefill_positions_per_s": per_s * positions,
                      "encoder_frames_per_s": per_s * frames or None,
                      "tokens_per_s": w["requests"] * max_new / ms * 1e3,
                      "latency_p50_ms": percentile(wave_lat, 50),
                      "latency_p99_ms": percentile(wave_lat, 99),
                      "peak_gib": peaks[i]})
    card = on_card(device)
    what = ("decoder prompt tokens/s" if frames else "prompt tokens/s"
            if not cfg.vis_len else "prompt and vision positions/s")
    for i, w in enumerate(waves):
        rate = f"{w['prefill_positions_per_s']:.1f} {what}" + (
            f", {w['encoder_frames_per_s']:.1f} encoder frames/s"
            if frames else "")
        log(f"{name} wave {i} ({card}): {w['requests']} requests, prefill "
            f"{w['prefill_ms']:.3f} ms ({rate}), decode "
            f"{w['decode_ms_per_token']:.3f} ms per "
            f"token, {w['tokens_per_s']:.2f} generated tokens/s, latency p50 "
            f"{w['latency_p50_ms']:.3f} ms p99 {w['latency_p99_ms']:.3f} ms, "
            f"peak device memory {w['peak_gib']} GiB")
    peak = max(peaks, key=lambda x: -1.0 if x == "n/a" else float(x))
    log(f"{name} ({card}): {n_req} requests in {wall:.3f} s, latency "
        f"p50 {percentile(lat, 50):.3f} ms p99 {percentile(lat, 99):.3f} ms; "
        f"launches {launches} (routes: every launch on "
        f"{[k.route or k.key for k in path.kernels]}; all counters "
        f"{all_launches}), plain calls {dict(plain)}; peak device memory "
        f"{peak} GiB")

    # the same prompt twice gives the same tokens; a manual greedy loop
    # on the parameters as made (float32, or with ``compute_init`` those
    # the steps read) gives the engine's
    prompt = reqs[0].prompt
    r1, r2 = (eng.run([Request(rid=100 + i, prompt=prompt,
                               max_new=max_new)],
                      prompt_len=path.prompt_len)[0] for i in range(2))
    require(np.array_equal(r1.output, r2.output),
            f"{name}: the same prompt served twice differs")
    with torch.inference_mode():
        batch = {"tokens": torch.as_tensor(prompt[None], dtype=torch.int32,
                                           device=device),
                 **stub_inputs(cfg, 1, device)}
        logits, cache = api.prefill_fn(cfg)(eng.params, batch,
                                            path.cache_len, flags)
        toks = [int(torch.argmax(logits[:, -1], -1)[0])]
        for _ in range(max_new - 1):
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
    # its prompts) on the kernel path and on the plain path; the stub
    # frontends' inputs seeded
    first = {"tokens": torch.as_tensor(
        np.stack([r.prompt for r in reqs[:SLOTS]]), dtype=torch.int32,
        device=device), **stub_inputs(cfg, SLOTS, device, SERVE_SEED + 3)}
    scored = first["tokens"][:2]
    out = {}
    with torch.inference_mode():
        reset_path(path)
        lk = api.prefill_fn(cfg)(eng.weights, first, path.cache_len,
                                 flags)[0]
        out["score_launches"] = None
        if path.score:
            reset_path(path)
            hk = TF.lm_forward(eng.weights, cfg, scored, flags=flags)
            out["score_launches"] = check_launches(path, cfg, 1,
                                                   f"{name} scoring")
        with path.plain_path() as plain_flags, \
                plain_calls(path.plain) as plain:
            reset_path(path)
            ln = api.prefill_fn(cfg)(eng.weights, first, path.cache_len,
                                     plain_flags)[0]
            hn = (TF.lm_forward(eng.weights, cfg, scored, flags=plain_flags)
                  if path.score else None)
        require(sum(path_launches(path).values()) == 0 and
                sum(plain.values()) > 0,
                f"{name}: the plain path launched a kernel "
                f"({path_launches(path)}) or called no plain version "
                f"({dict(plain)})")
    plain_err = rel_err(lk, ln)
    agree = float((lk.argmax(-1) == ln.argmax(-1)).float().sum())
    if cfg.family == "moe":
        # bf16 whole-model logits are printed, not held: routing is held
        # decision by decision, layer by layer, and in float32 compute
        out["moe"] = moe_checks(eng, first, path, lk, device)
        log(f"{name}: first-wave prefill logits in bf16 (not held), kernel "
            f"vs plain path: max diff {plain_err:.4g} of the max magnitude, "
            f"with {out['moe']['chain_flips']} of "
            f"{out['moe']['decisions']} (token, slot) decisions flipped "
            f"between the two runs; first tokens agree on {agree:.0f} of "
            f"{SLOTS}")
    else:
        tol = path.bf16_tol
        require(tol is None or plain_err <= tol, f"{name}: kernel-path "
                f"prefill logits differ from the plain path's by "
                f"{plain_err} of their max magnitude")
        held = "printed, not held" if tol is None else f"tolerance {tol}"
        log(f"{name}: first-wave prefill logits, kernel vs plain path: max "
            f"diff {plain_err:.4g} of the max magnitude ({held}); first "
            f"tokens agree on {agree:.0f} of {SLOTS}")
    out["score_rel"] = None
    if path.score:
        out["score_rel"] = rel_err(hk, hn)
        require(path.bf16_tol is None or out["score_rel"] <= path.bf16_tol,
                f"{name}: kernel-path lm_forward differs from the plain "
                f"path's by {out['score_rel']}")
        log(f"{name}: lm_forward scoring {tuple(scored.shape)} tokens "
            f"through launches {out['score_launches']}, kernel vs plain "
            f"path: max diff {out['score_rel']:.4g} of the max magnitude ("
            + ("printed, not held" if path.bf16_tol is None
               else f"tolerance {path.bf16_tol}") + ")")
        del hk, hn
    if cfg.family == "hybrid":
        out["float32"] = hybrid_float32(eng, first, path, device)
    if cfg.vis_len:
        out["embeds_change"] = embeds_change(eng, first, path, lk)
    pre = prefill_split(eng, first, flags,
                        {k.part: k.tag for k in path.kernels})
    log(f"{name} warm prefill of {SLOTS} x {path.prompt_len} tokens"
        + (f" after {cfg.vis_len} vision embeddings" if cfg.vis_len else "")
        + " "
        f"({card}): {pre['wall_ms']:.3f} ms wall, device {pre['device_ms']}"
        f" ms (busy share {pre.get('busy_share')}); device ms by part "
        f"{pre.get('device_ms_by_part')}; top device us "
        f"{pre.get('top_device_us')}")
    if cfg.family == "encdec":
        out["encoder"] = encoder_share(eng, first, flags, pre)
    busy = decode_busy_share(eng, first, flags)
    log(f"{name} decode step ({card}): {busy['decode_step_ms']:.3f} ms wall"
        f", device busy {busy['device_busy_ms']} ms, busy share "
        f"{busy['busy_share']}, {busy['device_ops']} device kernels, copies "
        f"and fills per step; top device us/step {busy['top_device_us']}")
    del eng, params, lk, ln
    if device == "cuda":
        torch.cuda.empty_cache()
    reduced = serving_cpu_equality(path, device)
    if cfg.family == "encdec":
        # the f32 route's own run of this family
        out["reduced_cpu_float32"] = serving_cpu_equality(path, device,
                                                          "float32")
    return {"launches": launches, "waves": waves,
            "latency_p50_ms": percentile(lat, 50),
            "latency_p99_ms": percentile(lat, 99), "wall_s": wall,
            "peak_gib": peak, "kernel_vs_plain_rel": plain_err,
            "first_token_agree": agree, **out, "prefill": pre,
            "decode": busy,
            "reduced_cpu": reduced}


def encoder_share(eng: ServingEngine, first, flags: OptFlags,
                  pre: dict) -> dict:
    """The encoder's part of a warm prefill: ``encdec.encode`` alone on
    the first wave's frames, its wall and device ms beside the whole
    prefill's (``pre``, ``prefill_split``'s record)."""
    def step():
        return encdec_lib.encode(eng.weights, eng.cfg, first["frames"],
                                 flags)
    with torch.inference_mode():
        step()
        sync(eng.device)
        t0 = time.perf_counter()
        step()
        sync(eng.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = (device_time([step])[0] if eng.device.type == "cuda"
                  else None)
    share = (None if dev_ms is None or not pre.get("device_ms")
             else dev_ms / pre["device_ms"])
    log(f"serving {eng.cfg.name} encoder of the warm prefill "
        f"({on_card(eng.device)}): {wall_ms:.3f} ms wall (prefill "
        f"{pre['wall_ms']:.3f}), device {dev_ms} ms (prefill "
        f"{pre.get('device_ms')}), share of the prefill's device time "
        f"{share}")
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "device_share": share}


def embeds_change(eng: ServingEngine, first, path: ServePath, lk) -> dict:
    """The reference's ``test_vlm_embeds_change_text_logits`` at full
    width: the first wave's prefill with other vision embeddings (zeros,
    the engine's) gives other text logits than with the seeded ones
    (``lk``); both through the kernel path."""
    with torch.inference_mode():
        other = {**first, "embeds": torch.zeros_like(first["embeds"])}
        lz = api.prefill_fn(eng.cfg)(eng.weights, other, path.cache_len,
                                     path.flags)[0]
    diff = float((lz - lk).abs().max())
    require(diff > 1e-4, f"serving {eng.cfg.name}: the vision embeddings "
            f"do not reach the text logits (max diff {diff})")
    log(f"serving {eng.cfg.name}: the first wave's last-position logits "
        f"with zero vision embeddings against the seeded ones: max diff "
        f"{diff:.4g} (must exceed 1e-4)")
    return {"max_diff": diff}


def block_halves(layer_p, x, cfg, positions, impl: str):
    """A MoE block of the model driven from here: ``h`` after the
    attention half (prefill attention ``impl``), the MoE layer's input
    ``rmsnorm(h)`` and the block's output, through the model's own
    functions."""
    h = x + attn_lib.attn_apply(
        layer_p["attn"], layers_lib.rmsnorm(layer_p["ln1"], x), cfg,
        positions=positions, impl=impl)
    return (layers_lib.rmsnorm(layer_p["ln2"], h),
            TF._mlp(layer_p, h, cfg))


def routing_of(router, inner, cfg) -> "moe_lib.Routing":
    """The MoE layer's routing of ``inner [B, S, d]``, grouped as the
    layer groups it (``router``: the layer's ``{"router": {"w"}}``)."""
    B, S, d = inner.shape
    G = moe_lib.n_groups_for(B * S, cfg)
    return moe_lib.moe_route(router, inner.reshape(G, -1, d), cfg)


def routing_diff(a, b, tol: float, what: str) -> dict:
    """Decisions of two routings of one token batch.  A token whose
    experts differ (``topi``, slot by slot) must have, in ``a``'s
    probabilities, a gap below ``tol`` between two neighbours of its
    top k + 1 from the first slot that differs on; a slot whose expert
    agrees may differ in ``keep`` only in a group that holds such a token
    (the capacity ranks behind it shift).  Returns the counts and the
    largest such gap."""
    k = a.topi.shape[-1]
    differs = a.topi != b.topi                                 # [G, T, k]
    tokens = differs.any(-1)
    probs = torch.sort(a.gate, dim=-1, descending=True).values[..., : k + 1]
    gaps = probs[..., :-1] - probs[..., 1:]                    # [G, T, k]
    first = torch.where(differs, torch.arange(k, device=differs.device),
                        k).amin(-1, keepdim=True)
    at = torch.where(torch.arange(k, device=differs.device) >= first, gaps,
                     float("inf")).amin(-1)                    # [G, T]
    flip_gaps = at[tokens]
    worst = float(flip_gaps.max()) if flip_gaps.numel() else 0.0
    require(worst < tol, f"{what}: {int(tokens.sum())} tokens route "
            f"differently, one with a top-k gap {worst} >= {tol}")
    keep_only = (a.keep != b.keep) & ~differs
    stray = keep_only & ~tokens.any(-1, keepdim=True)[..., None]
    require(not bool(stray.any()), f"{what}: {int(stray.sum())} kept/"
            f"dropped differences in groups where no token routes "
            f"differently")
    hist = np.histogram(flip_gaps.cpu().numpy(),
                        bins=(0.0, *GAP_EDGES, np.inf))[0]
    return {"tokens": int(tokens.sum()), "slots": int(differs.sum()),
            "keep_only": int(keep_only.sum()), "max_gap": worst,
            "gap_counts": hist.tolist(),
            "gaps": sorted(float(g) for g in flip_gaps.cpu())[:8]}


def float32_whole_model(eng: ServingEngine, first, path: ServePath,
                        device="cuda") -> dict:
    """(b): the whole model in float32 compute, kernel path (the f32 route)
    against the plain path, through ``lm_forward`` on the first wave.
    Top-k routing stays discontinuous in float32: at 2**17 decisions a
    layer some lie closer than float32 rounding, and with the capacity
    ranks a decision that differs moves the tokens after it in its group,
    and through attention the later tokens of its row.  So both paths also
    run as whole models driven from here (each layer on its own hidden
    state, the same functions, the drive equal to ``lm_forward``): at the
    first layer where their routing differs, every differing decision must
    sit at a top-k gap below ``F32_GAP_TOL``, and the final hidden states
    are held to ``F32_TOL`` at every position no differing decision can
    reach (before the first in its group and in its row).  The
    last-position logits are printed."""
    cfg = dataclasses.replace(eng.cfg, compute_dtype="float32")
    w = TF.compute_params(eng.params, cfg)
    name = f"serving {cfg.name} float32"
    tokens = first["tokens"]
    B, S = tokens.shape
    positions = TF._positions(B, S, tokens.device)
    kernel_flags = OptFlags(flash_kernel=True)
    with torch.inference_mode():
        fa_kernel.reset_launches()
        with plain_calls(path.plain) as plain:
            hk = TF.lm_forward(w, cfg, tokens, flags=kernel_flags)
        launches = dict(fa_kernel.LAUNCHES)
        require(launches["flash_attention_f32"] == cfg.n_layers and
                launches["flash_attention"] == cfg.n_layers and
                sum(plain.values()) == 0,
                f"{name}: launches {launches}, plain calls {dict(plain)}; "
                f"want {cfg.n_layers} on the f32 route")
        hp = TF.lm_forward(w, cfg, tokens, flags=OptFlags())
        # the two whole models driven layer by layer
        x = layers_lib.embed(w["embed"], tokens, compute_dtype=cfg.cdtype())
        xk = xp = x
        reached = torch.zeros((B, S), dtype=torch.bool, device=x.device)
        first_diff, per_layer = None, []
        for i, lp in enumerate(w["layers"]):
            router = {"router": lp["moe"]["router"]}
            inner_k, xk = block_halves(lp, xk, cfg, positions, "pallas")
            inner_p, xp = block_halves(lp, xp, cfg, positions, "naive")
            rk, rp = (routing_of(router, v, cfg) for v in (inner_k, inner_p))
            differs = ((rk.topi != rp.topi) | (rk.keep != rp.keep)).any(-1)
            per_layer.append(int(differs.sum()))
            if not per_layer[-1]:
                continue
            d = routing_diff(rk, rp, F32_GAP_TOL if first_diff is None
                             else float("inf"), f"{name} layer {i}")
            if first_diff is None:
                first_diff = dict(layer=i, **d)
            T = differs.shape[1]
            at = torch.arange(T, device=x.device)
            first = torch.where(differs, at, T).amin(-1, keepdim=True)
            reached |= (at >= first).reshape(B, S)
        reached = torch.cummax(reached.int(), dim=1).values.bool()
        drive = [layers_lib.rmsnorm(w["final_norm"], v) for v in (xk, xp)]
        logits = [TF._logits(w, cfg, v[:, -1:]) for v in (xk, xp)]
    drive_err = max(rel_err(drive[0], hk), rel_err(drive[1], hp))
    require(drive_err <= 1e-6, f"{name}: the drive differs from lm_forward "
            f"by {drive_err}")
    held = ~reached
    n_held = int(held.sum())
    require(n_held > 0, f"{name}: every position is reached by a routing "
            f"difference ({per_layer})")
    err = rel_err(hk[held], hp[held])
    require(err <= F32_TOL, f"{name}: kernel-path hidden states differ from "
            f"the plain path's by {err} at the {n_held} positions no routing "
            f"difference reaches")
    last = rel_err(*logits)
    where = ("none" if first_diff is None else
             f"layer {first_diff['layer']}, its largest top-k gap "
             f"{first_diff['max_gap']:.3g}")
    log(f"{name} (b) whole model through lm_forward on {B} x {S} tokens "
        f"({on_card(device)}): {cfg.n_layers} launches on the f32 route; "
        f"tokens routed differently per layer between the two runs "
        f"{per_layer}; the first such layer: {where} (tolerance "
        f"{F32_GAP_TOL}); final hidden states at the {n_held} of "
        f"{B * S} positions no difference reaches (the first "
        f"{held.sum(1).tolist()} of each row): kernel vs plain {err:.3g} of "
        f"the max magnitude (tolerance {F32_TOL}); last-position logits "
        f"(not held) {last:.3g}; the drive vs lm_forward {drive_err:.3g}")
    return {"f32_rel_err": err, "f32_positions_held": n_held,
            "f32_last_logits_rel": last, "f32_flips_by_layer": per_layer,
            "f32_first_diff": first_diff}


def moe_checks(eng: ServingEngine, first, path: ServePath, lk,
               device="cuda") -> dict:
    """The MoE path's own checks at full width, with no hook in the
    model: (a) the blocks driven from here layer by layer on the first
    wave's prompts, each layer fed one hidden state through the kernel
    path and the plain path: the block's output agrees on the tokens whose
    routing agrees, and every decision that differs sits at a gap below
    ``BF16_GAP_TOL``; the routing of the kernel path's MoE input is
    recomputed on the CPU and differs from the card's only below
    ``F32_GAP_TOL``.  Beside it the two paths run as whole models (each
    layer on its own hidden state): their flipped decisions are counted for
    the bf16 logits, which are printed, not held.  (b) The whole model in
    float32 compute (``float32_whole_model``).  Then the MoE stages'
    device time at layer 0's shape, and each layer's dropped share."""
    cfg, w = eng.cfg, eng.weights
    name = f"serving {cfg.name}"
    tokens = first["tokens"]
    B, S = tokens.shape
    positions = TF._positions(B, S, tokens.device)
    card = on_card(device)
    out = {"layers": [], "decisions": 0, "chain_flips": 0}
    with torch.inference_mode():
        x = layers_lib.embed(w["embed"], tokens, compute_dtype=cfg.cdtype())
        hk = hp = x
        for i, lp in enumerate(w["layers"]):
            router = {"router": lp["moe"]["router"]}
            inner_k, out_k = block_halves(lp, hk, cfg, positions, "pallas")
            inner_p, out_p = block_halves(lp, hk, cfg, positions, "naive")
            rk, rp = (routing_of(router, v, cfg) for v in (inner_k, inner_p))
            same = routing_diff(rk, rp, BF16_GAP_TOL,
                                f"{name} layer {i}, kernel vs plain path")
            cpu_router = {"router": {"w": router["router"]["w"].cpu()}}
            rc = routing_of(cpu_router, inner_k.cpu(), cfg)
            host = routing_diff(rk._replace(**{
                f: getattr(rk, f).cpu() for f in ("gate", "topv", "topi",
                                                   "pos", "keep")}), rc,
                F32_GAP_TOL, f"{name} layer {i}, card vs CPU")
            agree = ((rk.topi == rp.topi) & (rk.keep == rp.keep)).all(-1)
            agree = agree.reshape(B, S)
            err = rel_err(out_k[agree], out_p[agree])
            require(err <= MOE_LAYER_TOL, f"{name} layer {i}: kernel vs "
                    f"plain block output {err} > {MOE_LAYER_TOL} on the "
                    f"tokens whose routing agrees")
            # the plain path as a whole model: its own hidden state
            inner_own, hp = block_halves(lp, hp, cfg, positions, "naive")
            chain = routing_diff(rk, routing_of(router, inner_own, cfg),
                                 float("inf"), f"{name} layer {i} chains")
            out["decisions"] += rk.topi.numel()
            out["chain_flips"] += chain["slots"]
            out["layers"].append({
                "dropped": 1.0 - float(rk.keep.float().mean()),
                "kernel_vs_plain": same, "card_vs_cpu": host,
                "block_rel_err": err, "tokens_compared": int(agree.sum()),
                "chain_flips": chain["slots"]})
            if i == 0:
                inner0 = inner_k
            hk = out_k
        chain_logits = TF._logits(w, cfg, hk[:, -1:])
    drive_err = rel_err(chain_logits, lk)
    lay = out["layers"]
    counts = [tuple(x["kernel_vs_plain"][f] for f in ("tokens", "slots",
                                                       "keep_only"))
              for x in lay]
    log(f"{name} (a) layer by layer on {B} x {S} tokens ({card}): kernel vs "
        f"plain path on one input per layer, (tokens, slots, keep-only) that "
        f"route differently {counts}, "
        f"largest top-k gap at such a token "
        f"{max(x['kernel_vs_plain']['max_gap'] for x in lay):.3g} (tolerance "
        f"{BF16_GAP_TOL:.4g}); block output on the tokens that agree, "
        f"largest rel diff {max(x['block_rel_err'] for x in lay):.3g} "
        f"(tolerance {MOE_LAYER_TOL}); card vs CPU routing of the same "
        f"input, differing tokens {[x['card_vs_cpu']['tokens'] for x in lay]}"
        f", largest gap {max(x['card_vs_cpu']['max_gap'] for x in lay):.3g} "
        f"(tolerance {F32_GAP_TOL}); the drive's last-position logits vs the "
        f"engine's prefill {drive_err:.3g}")
    edges = ", ".join(f"{e:.3g}" for e in GAP_EDGES)
    for what in ("kernel_vs_plain", "card_vs_cpu"):
        counts = np.sum([x[what]["gap_counts"] for x in lay], axis=0)
        log(f"{name}: top-k gaps of every token routed differently, "
            f"{what.replace('_', ' ')}, all layers, counted between the "
            f"edges (0, {edges}, inf): {counts.tolist()}")
    for i, x in enumerate(lay):
        if x["kernel_vs_plain"]["tokens"] or x["card_vs_cpu"]["tokens"]:
            log(f"{name} layer {i}: the smallest gaps at the tokens routed "
                f"differently, kernel vs plain "
                f"{[f'{g:.3g}' for g in x['kernel_vs_plain']['gaps']]}, "
                f"card vs CPU "
                f"{[f'{g:.3g}' for g in x['card_vs_cpu']['gaps']]}")
    out["drive_rel_err"] = drive_err
    out["dropped_by_layer"] = [round(x["dropped"], 4) for x in lay]
    log(f"{name}: dropped share of (token, slot) pairs per layer (the "
        f"capacity rule, first wave) {out['dropped_by_layer']}; flipped "
        f"decisions between the two whole-model runs per layer "
        f"{[x['chain_flips'] for x in lay]}")

    out.update(float32_whole_model(eng, first, path, device))
    require(drive_err <= 1e-6, f"{name}: the drive's logits differ from "
            f"the engine's prefill by {drive_err}")

    if torch.device(device).type != "cuda":
        return out
    # the MoE stages' device time at layer 0's shape
    p0 = w["layers"][0]["moe"]
    with torch.inference_mode():
        xg = inner0.reshape(moe_lib.n_groups_for(B * S, cfg), -1, cfg.d_model)
        r = moe_lib.moe_route(p0, xg, cfg)
        xe, comb = moe_lib.moe_dispatch(r, xg, cfg)
        ye = moe_lib.moe_experts(p0, xe, cfg)
        stages = {
            "route": lambda: moe_lib.moe_route(p0, xg, cfg),
            "dispatch": lambda: moe_lib.moe_dispatch(r, xg, cfg),
            "experts": lambda: moe_lib.moe_experts(p0, xe, cfg),
            "combine": lambda: moe_lib.moe_combine(comb, ye, cfg),
            "moe_apply": lambda: moe_lib.moe_apply(p0, inner0, cfg)}
        ms = {}
        for stage, fn in stages.items():
            time_calls([fn] * 2)
            ms[stage] = device_time([fn] * 3)[0]
    out["stage_ms"] = ms
    log(f"{name}: layer 0's MoE stages at the wave's prefill shape ({card}), "
        f"device ms a call {ms}; times {cfg.n_layers} layers "
        + ", ".join(f"{k} {v * cfg.n_layers:.3f} ms" for k, v in ms.items()
                    if v is not None))
    return out


def serving_cpu_equality(path: ServePath, device="cuda",
                         compute_dtype: str | None = None) -> dict:
    """The path at full width and 2 layers (the hybrid: one group, its
    ``shared_attn_every`` SSM layers and the shared block; the
    encoder-decoder: 2 of each stack): prefill and teacher-forced decode
    steps on CUDA (the kernels) and on the CPU (the plain versions) from
    the same weights and the same seeded stub-frontend inputs; logits
    within 2e-2 of their largest magnitude (bf16 rounded in another order
    on each device).  The MoE and hybrid families run in float32 compute,
    as ``compute_dtype="float32"`` asks of any: held to ``F32_TOL`` and to
    equal greedy tokens at every step, every launch on the f32 route (in
    bf16 a routing decision near a tie may go either way on the two
    devices, and the hybrid's float32 run holds its algorithm)."""
    base = get_config(path.arch)
    n_layers = (base.shared_attn_every if base.family == "hybrid"
                else REDUCED_SERVE["n_layers"])
    cfg = dataclasses.replace(base, n_layers=n_layers)
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, enc_layers=n_layers,
                                  dec_layers=n_layers)
    tol = 2e-2
    if cfg.family in ("moe", "hybrid") or compute_dtype == "float32":
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
        tol = F32_TOL
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
        reset_path(path)
        with plain_calls(path.plain) as plain, torch.inference_mode():
            batch = {"tokens": torch.as_tensor(toks, dtype=torch.int32,
                                               device=dev),
                     **stub_inputs(cfg, B, dev, SERVE_SEED + 1)}
            lg, cache = api.prefill_fn(cfg)(
                weights[dev], batch, cfg.vis_len + S + 8, path.flags)
            out = [lg]
            if forced is None:
                forced = torch.argmax(lg[:, -1], -1).to(torch.int32)
            tok = forced[:, None].to(dev)
            for _ in range(REDUCED_SERVE["steps"]):
                lg, cache = api.decode_fn(cfg)(weights[dev], cache, tok,
                                               path.flags)
                out.append(lg)
        logits[dev] = [x.cpu() for x in out]
        what = f"serving {cfg.name} reduced on {dev}"
        if dev == "cpu":
            got = path_launches(path)
            require(sum(got.values()) == 0, f"{what}: launches {got}")
            for k in path.kernels:
                if k.cpu_plain is not None:
                    require(plain[k.cpu_plain] // k.per_pass(cfg) == 1,
                            f"{what}: {plain[k.cpu_plain]} calls of "
                            f"{k.cpu_plain}, want one per {k.key} launch "
                            f"({k.per_pass(cfg)})")
        else:
            # float32 compute takes the f32 attention route
            f32 = {"flash_attention": "flash_attention_f32"}
            check_launches(path, cfg, 1, what,
                           f32 if cfg.compute_dtype == "float32" else None)
            want = decode_plain_calls(path, cfg, REDUCED_SERVE["steps"])
            require(dict(plain) == want,
                    f"{what}: plain calls {dict(plain)}, want {want}")
        log(f"serving {cfg.name} reduced ({on_card(dev)}, "
            f"{cfg.compute_dtype}): {cfg.n_layers} layers, {B} x {S} prompt "
            f"+ {REDUCED_SERVE['steps']} decode steps in "
            f"{time.perf_counter() - t0:.3f} s")
    errs = [rel_err(c, p) for c, p in zip(logits[device], logits["cpu"])]
    require(max(errs) <= tol, f"serving {cfg.name} reduced: CUDA logits "
            f"differ from the CPU's by {errs} of their max magnitude")
    same = [bool(torch.equal(c[:, -1].argmax(-1), p[:, -1].argmax(-1)))
            for c, p in zip(logits[device], logits["cpu"])]
    require(cfg.compute_dtype != "float32" or all(same),
            f"serving {cfg.name} reduced: greedy tokens differ between CUDA "
            f"and the CPU at steps {[i for i, x in enumerate(same) if not x]}")
    log(f"serving {cfg.name} reduced: CUDA (kernel) vs CPU (plain) logits "
        f"in {cfg.compute_dtype} compute, relative max diff per step "
        f"{[f'{e:.3g}' for e in errs]} (tolerance {tol}); greedy tokens "
        f"equal at every step: {all(same)}")
    return {"rel_errs": errs, "compute_dtype": cfg.compute_dtype,
            "n_layers": cfg.n_layers, "tokens_equal": all(same)}


def hybrid_float32(eng: ServingEngine, first, path: ServePath,
                   device="cuda") -> dict:
    """The hybrid's whole model at full depth in float32 compute, on
    ``HYBRID_F32_PROMPTS`` of the first wave's prompts: the kernel path
    (the f32 attention route and the ssd pair) against the plain path
    (naive attention, ``impl="chunked"``).  Prefill logits and
    ``lm_forward`` scoring within ``F32_TOL`` of their largest magnitude;
    then ``HYBRID_STEPS`` decode steps on both from their own caches, each
    fed the plain path's greedy token, the argmax of every step equal
    wherever the plain path's top two lie more than ``HYBRID_GAP`` of the
    logits' largest magnitude apart (the positions closer than that are
    counted and printed)."""
    cfg = dataclasses.replace(eng.cfg, compute_dtype="float32")
    w = TF.compute_params(eng.params, cfg)        # float32: no copy
    name = f"serving {cfg.name} float32"
    tokens = first["tokens"][:HYBRID_F32_PROMPTS]
    runs = {}
    with torch.inference_mode():
        for which in ("plain", "kernel"):
            ctx = (path.plain_path() if which == "plain"
                   else contextlib.nullcontext(path.flags))
            with ctx as flags, plain_calls(path.plain) as plain:
                reset_path(path)
                lg, cache = api.prefill_fn(cfg)(w, {"tokens": tokens},
                                                path.cache_len, flags)
                hidden = TF.lm_forward(w, cfg, tokens, flags=flags)
                launches = path_launches(path)
                if which == "kernel":
                    check_launches(path, cfg, 2, f"{name} kernel path",
                                   {"flash_attention": "flash_attention_f32"})
                    require(sum(plain.values()) == 0, f"{name}: plain calls "
                            f"{dict(plain)} on the kernel path")
                else:
                    require(sum(launches.values()) == 0 and
                            sum(plain.values()) > 0,
                            f"{name} plain path: launches {launches}, plain "
                            f"calls {dict(plain)}")
            runs[which] = {"logits": [lg], "hidden": hidden,
                           "cache": cache, "launches": launches}
        for _ in range(HYBRID_STEPS):
            tok = torch.argmax(runs["plain"]["logits"][-1][:, -1], -1)
            for run in runs.values():
                lg, run["cache"] = api.decode_fn(cfg)(
                    w, run["cache"], tok.to(torch.int32)[:, None], path.flags)
                run["logits"].append(lg)
    kern, plain = runs["kernel"], runs["plain"]
    prefill_rel = rel_err(kern["logits"][0], plain["logits"][0])
    score_rel = rel_err(kern["hidden"], plain["hidden"])
    decode_rels = [rel_err(a, b) for a, b in zip(kern["logits"][1:],
                                                  plain["logits"][1:])]
    compared = close = 0
    for a, b in zip(kern["logits"], plain["logits"]):
        a, b = a[:, -1].float().cpu(), b[:, -1].float().cpu()
        top2 = torch.topk(b, 2, dim=-1).values
        wide = (top2[:, 0] - top2[:, 1]) > HYBRID_GAP * b.abs().max()
        differ = a.argmax(-1) != b.argmax(-1)
        require(not bool((differ & wide).any()),
                f"{name}: greedy tokens differ where the plain path's top "
                f"two lie more than {HYBRID_GAP} of the max magnitude apart")
        compared += int(wide.sum())
        close += int((~wide).sum())
    require(prefill_rel <= F32_TOL and score_rel <= F32_TOL,
            f"{name}: kernel-path prefill logits {prefill_rel} or scoring "
            f"{score_rel} differ from the plain path's by more than "
            f"{F32_TOL} of their max magnitude")
    log(f"{name} whole model, {cfg.n_layers} layers, on "
        f"{tuple(tokens.shape)} tokens ({on_card(device)}): kernel path "
        f"(launches {kern['launches']}) vs plain path: prefill logits "
        f"{prefill_rel:.3g}, lm_forward scoring {score_rel:.3g} of the max "
        f"magnitude (tolerance {F32_TOL}); {HYBRID_STEPS} decode steps on "
        f"the plain path's greedy tokens, logits {[f'{e:.3g}' for e in decode_rels]} "
        f"(printed); greedy tokens equal at all {compared} positions whose "
        f"top two lie more than {HYBRID_GAP} of the max magnitude apart, "
        f"{close} positions closer than that (not held)")
    return {"prefill_rel": prefill_rel, "score_rel": score_rel,
            "decode_rels": decode_rels, "tokens_compared": compared,
            "tokens_near_tie": close}


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


# ---------------------------------------------------------------------------
# phase 19: the examples' torch twins on the card and on the CPU
# ---------------------------------------------------------------------------
EXAMPLES = ("quickstart", "fault_tolerance", "kv_serving", "train_lm")
# a wall-clock number (seconds, milliseconds, tokens per second): the only
# numbers of an example's output that may differ between two runs
WALL_CLOCK = re.compile(r"[\d,]+(\.\d+)?(?=(s|ms| tok/s)\b)")
# train_lm: 40 steps (of its 200 by default), and what is particular to a
# run: its step times, each with the straggler flag read from it, its
# temporary checkpoint directory and its losses, which the card and the
# CPU compute from the same weights in bf16 and round at different places
# (held pairwise to EXAMPLE_LOSS_TOL)
EXAMPLE_ARGV = {"train_lm": ["--steps", "40"]}
RUN_SPECIFIC = {"train_lm": re.compile(
    r"(?<=loss )\d+\.\d+|(?<=from )\d+\.\d+|(?<=checkpoints -> )\S+"
    r"|\(\d+ ms\)( STRAGGLER)?")}
EXAMPLE_LOSS = re.compile(r"(?<=loss )\d+\.\d+|(?<=from )\d+\.\d+")
EXAMPLE_LOSS_TOL = 2e-2


def run_example(name: str, argv: list) -> tuple:
    """(stdout lines, seconds, kernel launches, plain kv calls) of
    ``examples/<name>_torch.py``'s ``main(argv)``."""
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kv_kernel.reset_launches()
    fa_kernel.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with PlainCalls(kv_ref, KV_PLAIN) as plain, \
            contextlib.redirect_stdout(buf):
        mod.main(argv)
    secs = time.perf_counter() - t0
    launches = {k: v for k, v in {**kv_kernel.LAUNCHES,
                                   **fa_kernel.LAUNCHES}.items() if v}
    return (buf.getvalue().splitlines(), secs, launches,
            sum(plain.calls.values()))


def examples_phase() -> dict:
    """Each twin's ``main()`` on the card (its default device) and with
    ``--device cpu``: the same lines but for wall-clock numbers; on the
    card the chain examples launch the kv kernels each tick and call no
    plain version, and on the CPU nothing launches."""
    out = {}
    card = smi()
    for name in EXAMPLES:
        argv = EXAMPLE_ARGV.get(name, [])
        got, secs, launches, plain = run_example(name, argv)
        exp, cpu_secs, cpu_launches, _ = run_example(
            name, [*argv, "--device", "cpu"])
        if name in RUN_SPECIFIC:
            losses = [[float(x) for line in lines
                       for x in EXAMPLE_LOSS.findall(line)]
                      for lines in (got, exp)]
            gap = max(abs(a - b) for a, b in zip(*losses))
            require(len(losses[0]) == len(losses[1]) > 2 and
                    gap <= EXAMPLE_LOSS_TOL and losses[0][-2] < losses[0][0],
                    f"example {name}: card losses {losses[0]}, CPU "
                    f"{losses[1]} (limit {EXAMPLE_LOSS_TOL})")
            log(f"example {name}: card and CPU losses differ by at most "
                f"{gap:.4g} (limit {EXAMPLE_LOSS_TOL})")
        masked = [[WALL_CLOCK.sub("<wall>", RUN_SPECIFIC[name].sub(
                       "<run>", x) if name in RUN_SPECIFIC else x)
                   for x in lines] for lines in (got, exp)]
        require(masked[0] == masked[1] and len(got) > 3,
                f"example {name}: the card's lines differ from the CPU's "
                f"beyond wall-clock numbers:\n{got}\n{exp}")
        require(not cpu_launches, f"example {name} on the CPU launched "
                f"{cpu_launches}")
        if name in ("quickstart", "fault_tolerance"):   # the chain ticks
            require(launches.get("kv_read", 0) > 0 and
                    launches.get("kv_write", 0) > 0 and plain == 0,
                    f"example {name} on the card: launches {launches}, "
                    f"plain kv calls {plain}")
        for line in got:
            if line.strip():
                log(f"example {name} ({card}): {line}")
        log(f"example {name}: card run {secs:.2f} s, CPU run {cpu_secs:.2f} "
            f"s; the lines equal but for wall-clock numbers; launches on "
            f"the card {launches or 'none'}, plain kv calls {plain}")
        out[name] = {"seconds": secs, "cpu_seconds": cpu_secs,
                     "launches": launches, "lines": len(got)}
    return out


# ---------------------------------------------------------------------------
# phase 22: training
# ---------------------------------------------------------------------------
# The backward kernels' cases, as (B, HQ, HKV, S, SK, D, dtype, causal):
# the training shape of (c) (Qwen1.5-0.5B, 16 heads of 64, MHA, S 4,096),
# Qwen2.5-3B's GQA group (16/2 heads of 128), Zamba2's head dim 80, a
# ragged edge (S = SK = 200), 200 causal queries after 700 keys (offset
# 500, the bottom-right mask), Whisper's cross-attention (its 448-token
# decoder context against 1,500 frames, non-causal), float32 (the f32
# pair), float32 at Qwen2.5-3B's GQA group and the training shape in bf16
# with dO a view whose rows are not 16-byte aligned (``BWD_DO_PADDED``:
# the f32 pair on bf16, its 4-byte copies)
BWD_CASES = {
    "train": (4, 16, 16, 4096, 4096, 64, torch.bfloat16, True),
    "gqa": (2, 16, 2, 2048, 2048, 128, torch.bfloat16, True),
    "d80": (1, 32, 32, 2048, 2048, 80, torch.bfloat16, True),
    "ragged": (2, 16, 2, 200, 200, 128, torch.bfloat16, True),
    "s_lt_sk": (2, 16, 2, 200, 700, 128, torch.bfloat16, True),
    "whisper_cross": (8, 8, 8, 448, 1500, 64, torch.bfloat16, False),
    "float32": (2, 16, 16, 2048, 2048, 64, torch.float32, True),
    "float32_gqa": (2, 16, 2, 2048, 2048, 128, torch.float32, True),
    "bf16_view": (4, 16, 16, 4096, 4096, 64, torch.bfloat16, True),
}
# dO's rows padded to D + 2 elements (132 bytes at D 64): TMA refuses it
BWD_DO_PADDED = ("bf16_view",)
BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")
# each route's dk/dv and dq counters (``kernel.route_bwd``): bf16 at these
# shapes takes the tensor-core pair, float32 the f32 pair
BWD_ROUTES = {"mma": ("flash_bwd_dkdv_mma", "flash_bwd_dq_mma"),
              "f32": ("flash_bwd_dkdv_f32", "flash_bwd_dq_f32")}
# timed beside their bounds, the plain version and SDPA
BWD_TIMED = ("train", "gqa", "d80", "float32", "float32_gqa", "bf16_view")
# A bf16 case runs the tensor-core pair, whose products take p and dS as
# bf16 operands; its gradients are held twice, each by its error's norm:
# against the plain version that makes the same two roundings
# (``ref.chunked_bwd(..., round_bf16=True)``), to BWD_EMU_TOL, set from
# the readings (the rest is summation order, ``ex2.approx`` and a p or dS
# that rounds the other way near a tie, where dP - delta cancels), and
# against the unrounded plain version to the forward's BF16_RMS_TOL (the
# two roundings alone read 2.5e-3 to 2.7e-3 there).  Two controls, the
# plain version with the roundings and with delta dropped (o = 0) or,
# causal, the mask dropped, must read past both limits.  Float32 gradients
# (the f32 pair) to 1e-4 of their largest magnitude against the plain
# version and to SPLIT_TOL against it in the pair's split TF32 arithmetic
# (``ref.chunked_bwd(..., split_tf32=True)``); bf16 on the f32 pair (its
# products exact but for p's and dS's splits, only the outputs rounded)
# by its error's norm to F32_ROUTE_BF16_TOL against the unrounded plain
# version, its controls likewise.  The backward's plain version reads
# the kernel's own o and lse, so the lse is held on its own, to LSE_TOL
# absolute, against the plain forward on the inputs upcast to float32
# (``lse_plain``): it scales the float32 score as the kernels do, where
# the reference's forward rounds q * scale to bf16 first (up to 2**-9 of
# a score; 4.7e-3 of the lse at D 128).  The two then differ only in the
# order of float32 sums: 1.9e-6 at D 64, where q * scale is exact in bf16
# (PERF.md); a shift of the lse by d scales every p, and so every
# gradient, by exp(-d).
BWD_EMU_TOL = 1e-3     # 2.9x the largest sound reading (3.48e-4; PERF.md)
F32_BWD_TOL = 1e-4
SPLIT_TOL = 1e-5
# delta against ``ref.delta_ref``: float32 sums in another order
DELTA_TOL = 1e-5
F32_ROUTE_BF16_TOL = 2.5e-4
LSE_TOL = 5e-5
# (c): Qwen1.5-0.5B at full width and depth, train_4k's sequence with its
# global batch of 256 cut to 4; (b): 2 layers, 256 tokens
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH = "qwen1.5-0.5b", 4096, 4
TRAIN_FLAGS = OptFlags(attn_impl="chunked", remat="full", chunked_ce=True,
                       ce_chunk=1024)
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
TRAIN_REPEAT, TRAIN_STEPS, TRAIN_CKPT, TRAIN_DROP = 8, 6, 3, 0.5
STEP_CHECK = dict(n_layers=2, seq=256, batch=1)
STEP_F32_TOL, STEP_BF16_TOL = 1e-4, 2e-2


def visible_pairs(S: int, SK: int, causal: bool, offset: int) -> int:
    """(query, key) pairs under the mask: all S x SK, or causal those with
    ``k_pos <= q_pos + offset``."""
    if not causal:
        return S * SK
    return int(np.clip(np.arange(S) + offset + 1, 0, SK).sum())


def backward_bounds(q, k, causal: bool) -> dict:
    """Per kernel (and for the whole backward) the (bytes, operations) the
    function must move and do: each input read once, each output written
    once; the products per visible pair (dkdv: s, dO v^T, p^T dO, dS^T q;
    dq: s, dO v^T, dS k; the backward five, 2.5 times the forward's)."""
    B, HQ, S, D = q.shape
    HKV, SK = k.shape[1], k.shape[2]
    e = q.element_size()
    pairs = B * HQ * visible_pairs(S, SK, causal, SK - S)
    rows, keys = B * HQ * S * D * e, B * HKV * SK * D * e
    stats = 8 * B * HQ * S                    # lse and delta, float32
    return {"flash_bwd_delta": (2 * rows + stats // 2, 2 * B * HQ * S * D),
            "flash_bwd_dkdv": (2 * rows + 4 * keys + stats, 8 * D * pairs),
            "flash_bwd_dq": (3 * rows + 2 * keys + stats, 6 * D * pairs),
            "backward": (4 * rows + 4 * keys + stats // 2, 10 * D * pairs)}


def split_tf32_ms(q, k, causal: bool) -> dict:
    """The f32 pair's products at the TF32 tensor-core peak, each counted
    as the split TF32 products it takes: three, less one for each operand
    exact in TF32 (a bf16 q, k, v or dO; p and dS are float32, always
    split): dkdv's s, dO v^T, p^T dO and dS^T q, dq's s, dO v^T and dS
    k; the whole backward's five, s and dO v^T once."""
    B, HQ, S, D = q.shape
    SK = k.shape[2]
    pairs = B * HQ * visible_pairs(S, SK, causal, SK - S)
    both = 1 if q.dtype == torch.bfloat16 else 3     # s, dO v^T
    one = 2 if q.dtype == torch.bfloat16 else 3      # p or dS times an input
    per = {"flash_bwd_dkdv": 2 * both + 2 * one, "flash_bwd_dq": 2 * both + one,
           "backward": 2 * both + 3 * one}
    return {n: 2 * D * pairs * t / TF32_FLOP_PER_S * 1e3
            for n, t in per.items()}


def ptxas_of(*prefixes) -> dict:
    """What ptxas reported (registers, spills, wgmma serialization) for
    the kernels whose names start with one of ``prefixes``, when this
    process built them."""
    return {name: u for per_lib in kernel_build.ptxas_report().values()
            for name, u in per_lib.items() if name.startswith(prefixes)}


def ptxas_line(what: str, ptxas: dict) -> str:
    if not ptxas:
        return f"ptxas, {what}: not built by this process"
    return f"ptxas, {what}: " + "; ".join(
        f"{n} {u['registers']} registers, {u['spill_stores']}/"
        f"{u['spill_loads']} bytes spilled (stores/loads), wgmma "
        f"{'serialized (C7512)' if u['wgmma_serialized'] else 'not serialized'}"
        for n, u in ptxas.items())


def fwd_plain(q, k, v, causal: bool, split_tf32: bool = False):
    qc, kc = fa_ref.default_blocks(q.shape[2], k.shape[2])
    return fa_ref.chunked_fwd(q, k, v, causal=causal, scale=q.shape[3] ** -0.5,
                              q_chunk=qc, k_chunk=kc, split_tf32=split_tf32)


def delta_hold(o, do, name: str) -> tuple:
    """Delta's own output against its plain version (``ref.delta_ref``):
    ``(delta, error, control)``, each reading of the plain version's
    largest magnitude, held to DELTA_TOL; the control, the plain version
    with the row of the largest delta zeroed in o, must read past it."""
    fa_kernel.reset_launches()
    delta = fa_kernel.flash_bwd_delta(o, do)
    sync(o.device)
    require(o.device.type == "cpu"
            or fa_kernel.LAUNCHES["flash_bwd_delta"] == 1,
            f"delta {name}: launches {fa_kernel.LAUNCHES}")
    exp = fa_ref.delta_ref(o, do)
    top = float(exp.abs().max())
    got = float((delta - exp).abs().max()) / top
    require(got <= DELTA_TOL, f"delta {name}: reads {got} of the plain "
            f"version's largest magnitude > {DELTA_TOL}")
    b, h, row = np.unravel_index(int(exp.abs().argmax()), tuple(exp.shape))
    o_cut = o.clone()
    o_cut[b, h, row] = 0
    ctrl = float((fa_ref.delta_ref(o_cut, do) - exp).abs().max()) / top
    require(ctrl > DELTA_TOL, f"delta {name}: the control (a row of o "
            f"zeroed) reads {ctrl} <= {DELTA_TOL}: the hold cannot see it")
    return delta, got, ctrl


def lse_plain(q, k, v, causal: bool):
    """The plain forward's lse from the inputs upcast to float32 (see
    ``LSE_TOL``)."""
    return fwd_plain(q.float(), k.float(), v.float(), causal)[1]


def bwd_plain(q, k, v, o, lse, do, causal: bool, round_bf16: bool = False,
              split_tf32: bool = False):
    qc, kc = fa_ref.default_blocks(q.shape[2], k.shape[2])
    return fa_ref.chunked_bwd(q, k, v, o, lse, do, causal=causal,
                              scale=q.shape[3] ** -0.5, q_chunk=qc,
                              k_chunk=kc, round_bf16=round_bf16,
                              split_tf32=split_tf32)


def per_kernel_us(fn, iters: int, want=()) -> dict:
    """Device µs of one call of ``fn`` by kernel name (the mean over the
    records the profiler kept).  A window of a long process may lose
    records: it is taken again, up to three times, until it holds some
    record and one whose name contains each of ``want``."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        counts: dict[str, int] = {}
        kernels = device_time([fn] * iters, counts=counts)[1]
        if kernels and all(any(w in k for k in kernels) for w in want):
            break
    return {k: us / counts[k] * max(1, round(counts[k] / iters))
            for k, us in kernels.items()}


def sdpa_backward_us(q, k, v, do, causal: bool):
    """SDPA's backward alone: device µs of every kernel of one backward
    call (``torch.autograd.grad`` of a forward taken outside the window,
    its graph kept), whichever path SDPA picks (a fused backward, or the
    math path's products and softmax backward)."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                         enable_gqa=True)

    def run():
        torch.autograd.grad(out, leaves, do, retain_graph=True)
    kernels = per_kernel_us(run, FA_ITERS)
    return (sum(kernels.values()) if kernels else None), sorted(kernels)


def check_flash_backward(device="cuda") -> dict:
    """(a): the forward with lse and the three backward kernels against
    their plain versions (``ref.chunked_fwd``, ``ref.chunked_bwd``) at
    ``BWD_CASES``, every output held, each bf16 case (the tensor-core
    pair) against the emulating and the unrounded plain version with its
    controls, float32 (the f32 pair) to its maximum; then, at
    ``BWD_TIMED``, each kernel timed beside its bound, the plain version
    and SDPA."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(22)
    cases, abs_errs, controls, timed = {}, {}, {}, {}
    card = smi()
    ptxas = ptxas_of("flash_bwd_dkdv_kernel<", "flash_bwd_dq_kernel<")
    log(ptxas_line("the f32 pair", ptxas))
    for name, (B, HQ, HKV, S, SK, D, dtype, causal) in BWD_CASES.items():
        q, k, v = attention_inputs(gen, B, HQ, HKV, S, SK, D, dtype)
        do = torch.randn((B, S, HQ, D), generator=gen,
                         device=device).to(dtype).transpose(1, 2)
        if name in BWD_DO_PADDED:
            do = torch.empty((B, S, HQ, D + 2), dtype=dtype,
                             device=device)[..., :D].copy_(
                do.transpose(1, 2)).transpose(1, 2)
        half = dtype == torch.bfloat16
        path = ("f32" if name in BWD_DO_PADDED or not half else "mma")
        require(device == "cpu" or fa_kernel.route_bwd(q, k, v, do) == path,
                f"backward {name}: route {fa_kernel.route_bwd(q, k, v, do)}"
                f", want {path}")
        mma = path == "mma"
        fa_kernel.reset_launches()
        o, lse = fa_kernel.flash_attention_lse(q, k, v, causal=causal)
        grads = fa_kernel.flash_attention_bwd(q, k, v, o, lse, do,
                                              causal=causal)
        sync(device)
        require(fa_kernel.LAUNCHES["flash_attention"] == 1 and all(
            fa_kernel.LAUNCHES[x] == (x in BWD_KERNELS + BWD_ROUTES[path])
            for x in (*BWD_KERNELS, *BWD_ROUTES["mma"],
                      *BWD_ROUTES["f32"])),
            f"backward {name}: launches {fa_kernel.LAUNCHES}, want one of "
            f"each kernel on the {path} route")
        # the kernels write each gradient in its input's layout
        require((device == "cpu" or all(
            g.stride() == x.stride() for g, x in zip(grads, (q, k, v))))
                and all(bool(torch.isfinite(x).all())
                        for x in (o, lse, *grads)),
                f"backward {name}: strides or non-finite outputs")
        o_ref, lse_ref = fwd_plain(q, k, v, causal)
        if dtype != torch.float32:
            lse_ref = lse_plain(q, k, v, causal)
        delta, delta_err, delta_ctrl = delta_hold(o, do, name)
        ref_grads = bwd_plain(q, k, v, o, lse, do, causal)
        emu_grads = (bwd_plain(q, k, v, o, lse, do, causal, round_bf16=True)
                     if mma else ref_grads)
        what = (f"backward {name} [{B}, {HQ}/{HKV}, {S}, {SK}, {D}] "
                f"{str(dtype)[6:]} {'causal' if causal else 'non-causal'}")

        def err(got, exp):
            if half:
                return rms_err(got, exp)
            return float((got.float() - exp.float()).abs().max()
                         / exp.float().abs().max())
        rec = {"o": err(o, o_ref),
               "lse": float((lse - lse_ref).abs().max()),
               "delta": delta_err}
        controls[f"{name}/delta_row_zeroed"] = delta_ctrl
        if not half:   # the f32 forward against its split emulation
            o_emu = fwd_plain(q, k, v, causal, split_tf32=True)[0]
            rec["o_split"] = float((o - o_emu).abs().max()
                                   / o_emu.abs().max())
            require(rec["o_split"] <= SPLIT_TOL, f"{what}: o reads "
                    f"{rec['o_split']} of the split TF32 emulation > "
                    f"{SPLIT_TOL}")
            del o_emu
        require(rec["o"] <= (BF16_RMS_TOL if half else F32_BWD_TOL),
                f"{what}: o reads {rec['o']}")
        require(rec["lse"] <= LSE_TOL, f"{what}: lse differs by "
                f"{rec['lse']} > {LSE_TOL}")
        # (suffix, plain gradients, limit): bf16 on the tensor-core pair
        # against the emulating and the unrounded plain version, on the
        # f32 pair against the unrounded one; float32 against the plain
        # version and its split TF32 emulation
        if mma:
            holds = (("", emu_grads, BWD_EMU_TOL),
                     ("_unrounded", ref_grads, BF16_RMS_TOL))
        elif half:
            holds = (("", ref_grads, F32_ROUTE_BF16_TOL),)
        else:
            holds = (("", ref_grads, F32_BWD_TOL), ("_split", bwd_plain(
                q, k, v, o, lse, do, causal, split_tf32=True), SPLIT_TOL))
        for suffix, refs, limit in holds:
            for g_name, g, r in zip(("dq", "dk", "dv"), grads, refs):
                rec[g_name + suffix] = err(g, r)
                require(rec[g_name + suffix] <= limit, f"{what}: {g_name} "
                        f"reads {rec[g_name + suffix]} > {limit} against "
                        f"the plain version{suffix or ' it is held to'}")
        if half:
            ctrl = {"delta_dropped": bwd_plain(
                q, k, v, torch.zeros_like(o), lse, do, causal, mma)}
            if causal:
                ctrl["mask_dropped"] = bwd_plain(q, k, v, o, lse, do, False,
                                                 mma)
            for c_name, c_grads in ctrl.items():
                for suffix, refs, limit in holds:
                    c_err = max(err(a, r) for a, r in zip(c_grads, refs))
                    # a NaN reading counts as past the limit
                    require(not c_err <= limit, f"{what}: the control "
                            f"{c_name} reads {c_err} <= {limit}: the hold "
                            "cannot see it")
                    controls[f"{name}/{c_name}{suffix}"] = c_err
        cases[name] = rec
        abs_errs[name] = {
            n: float((a.float() - b.float()).abs().max()) for n, a, b in zip(
                ("o", "lse", "delta", "dq", "dk", "dv"), (o, lse, delta, *grads),
                (o_ref, lse_ref, fa_ref.delta_ref(o, do), *emu_grads))}
        log(f"backward {name} ({card}): q [{B}, {HQ}, {S}, {D}], k/v [{B}, "
            f"{HKV}, {SK}, {D}] {str(dtype)[6:]} "
            f"{'causal' if causal else 'non-causal'}, {path} route: "
            + ", ".join(f"{k} {v:.3g}" for k, v in rec.items())
            + (f" (error norm against the emulating plain version, limit "
               f"{BWD_EMU_TOL}; _unrounded against the unrounded one, "
               f"limit {BF16_RMS_TOL}; lse {LSE_TOL})" if mma else
               f" (error norm against the plain version, limit "
               f"{F32_ROUTE_BF16_TOL}; lse {LSE_TOL})" if half else
               f" (max err of max, limit {F32_BWD_TOL}; _split against "
               f"the split TF32 emulation, limit {SPLIT_TOL}; lse "
               f"{LSE_TOL})")
            + "".join(f"; control {c} {e:.3g}" for c, e in controls.items()
                      if c.startswith(f"{name}/")))
        if name in BWD_TIMED:
            timed[name] = time_backward(q, k, v, o, lse, do, causal)
        del q, k, v, do, o, lse, grads, o_ref, lse_ref, ref_grads, emu_grads
        del delta
        if device != "cpu":
            torch.cuda.empty_cache()
    recs = {}
    # each kernel at its route's case (the tensor-core pair and the rest at
    # the training shape, the f32 pair at float32): the error on what it
    # writes
    for kname, case, names, timing in (
            ("flash_attention_lse", "train", ("o",), "flash_attention_lse"),
            ("flash_bwd_delta", "train", ("delta",), "flash_bwd_delta"),
            ("flash_bwd_dkdv_mma", "train", ("dk", "dv"), "flash_bwd_dkdv"),
            ("flash_bwd_dq_mma", "train", ("dq",), "flash_bwd_dq"),
            ("flash_bwd_dkdv", "float32", ("dk", "dv"), "flash_bwd_dkdv"),
            ("flash_bwd_dq", "float32", ("dq",), "flash_bwd_dq")):
        recs[kname] = {"max_abs_err": max(abs_errs[case][n] for n in names),
                       **timed[case][timing]}
        if kname.endswith("_mma"):
            recs[kname]["shapes"] = {c: timed[c][timing]
                                     for c in ("gqa", "d80")}
        elif case == "float32" and kname != "flash_bwd_delta":
            recs[kname]["shapes"] = {c: timed[c][timing]
                                     for c in ("float32_gqa", "bf16_view")}
            recs[kname]["ptxas"] = {n: u for n, u in ptxas.items()
                                    if n.startswith(kname + "_kernel<")}
    recs["flash_attention_lse"]["max_abs_err_lse"] = abs_errs["train"]["lse"]
    # the f32 route's forward with lse, and delta, at the float32 cases
    recs["flash_attention_lse"]["f32_route"] = {
        c: timed[c]["flash_attention_lse"] for c in ("float32", "float32_gqa")}
    recs["flash_bwd_delta"]["shapes"] = {
        c: timed[c]["flash_bwd_delta"] for c in ("float32", "bf16_view")}
    for c in ("float32", "float32_gqa"):
        r = timed[c]["flash_attention_lse"]
        log(f"the f32 forward with lse at {c} ({card}): {r['ms'] * 1e3:.2f} "
            f"us (bound {r['bound_ms'] * 1e3:.2f} in split TF32, at the f32 "
            f"CUDA-core peak {r['cuda_core_bound_ms'] * 1e3:.2f}; SDPA's "
            f"forward {r['library_ms'] * 1e3:.2f} us)")
    recs["flash_attention_lse"]["case_errs"] = cases
    recs["flash_attention_lse"]["case_abs_errs"] = abs_errs
    recs["flash_attention_lse"]["controls"] = controls
    recs["flash_attention_lse"]["backward"] = {c: timed[c]["backward"]
                                               for c in BWD_TIMED}
    f32 = {c: timed[c]["backward"] for c in ("float32", "float32_gqa",
                                             "bf16_view")}
    log("the f32 pair (" + card + "): " + "; ".join(
        f"{c} dkdv {timed[c]['flash_bwd_dkdv']['ms'] * 1e3:.2f} us (bound "
        f"{timed[c]['flash_bwd_dkdv']['bound_ms'] * 1e3:.2f} in split TF32, "
        f"at the f32 CUDA-core peak "
        f"{timed[c]['flash_bwd_dkdv']['cuda_core_bound_ms'] * 1e3:.2f}), "
        f"dq {timed[c]['flash_bwd_dq']['ms'] * 1e3:.2f} us (bound "
        f"{timed[c]['flash_bwd_dq']['bound_ms'] * 1e3:.2f} in split TF32, "
        f"at the f32 CUDA-core peak "
        f"{timed[c]['flash_bwd_dq']['cuda_core_bound_ms'] * 1e3:.2f}), "
        f"whole backward {r['ms'] * 1e3:.2f} us against SDPA's "
        + ("n/a" if r["sdpa_bwd_ms"] is None else
           f"{r['sdpa_bwd_ms'] * 1e3:.2f} us")
        + f", the plain version {r['plain_ms'] * 1e3:.2f} us"
        for c, r in f32.items()))
    log(f"training: phase 22's (a) took {time.perf_counter() - t0:.1f} s")
    return recs


def time_backward(q, k, v, o, lse, do, causal: bool) -> dict:
    """Each kernel's device ms beside its bound, the plain version's (the
    tensor-core pair's: with its roundings) and SDPA's (forward: SDPA's
    forward; the backward kernels: SDPA's whole backward, which computes
    dq, dk and dv in one call)."""
    card = smi()
    mma = fa_kernel.route_bwd(q, k, v, do) == "mma"
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
    bounds = backward_bounds(q, k, causal)
    # the f32 routes' products run on the TF32 tensor cores, split: their
    # operations in ms at that rate (the CUDA-core bound kept beside)
    split = {} if mma else split_tf32_ms(q, k, causal)
    fwd_bytes, fwd_flop = attention_bound(q, k, causal)
    bounds["flash_attention_lse"] = (fwd_bytes + 4 * q.shape[0]
                                     * q.shape[1] * q.shape[2], fwd_flop)
    if fa_kernel.route(q, k, v) == "f32":
        split["flash_attention_lse"] = (fwd_flop / f32_route_peak(q.dtype)
                                        * 1e3)
    kern = per_kernel_us(lambda: fa_kernel.flash_attention_bwd(
        q, k, v, o, lse, do, causal=causal), FA_ITERS, want=BWD_KERNELS)
    fwd = per_kernel_us(lambda: fa_kernel.flash_attention_lse(
        q, k, v, causal=causal), FA_ITERS, want=(
            "flash_mma_kernel" if fa_kernel.route(q, k, v) == "mma"
            else "flash_fwd_kernel",))
    plain_bwd = sum(per_kernel_us(lambda: bwd_plain(
        q, k, v, o, lse, do, causal, mma), 2).values())
    plain_fwd = sum(per_kernel_us(lambda: fwd_plain(q, k, v, causal),
                                  2).values())
    plain_delta = sum(per_kernel_us(lambda: (do.float() * o.float()).sum(-1),
                                    FA_ITERS).values())
    lib_delta = sum(per_kernel_us(lambda: torch.linalg.vecdot(o, do, dim=-1),
                                  FA_ITERS).values())
    sdpa_fwd = sum(per_kernel_us(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True), FA_ITERS).values())
    sdpa_bwd, sdpa_names = sdpa_backward_us(q, k, v, do, causal)
    out = {}
    for name, tag, plain_us, lib_us in (
            ("flash_attention_lse", ("flash_mma_kernel", "flash_fwd_kernel"),
             plain_fwd, sdpa_fwd),
            ("flash_bwd_delta", ("flash_bwd_delta",), plain_delta,
             lib_delta),
            ("flash_bwd_dkdv", ("flash_bwd_dkdv",), plain_bwd, sdpa_bwd),
            ("flash_bwd_dq", ("flash_bwd_dq",), plain_bwd, sdpa_bwd)):
        src = fwd if name == "flash_attention_lse" else kern
        us = sum(t for kn, t in src.items() if any(x in kn for x in tag))
        require(us > 0, f"{name}: the profiler kept no record of it "
                f"({sorted(src)})")
        nbytes, flop = bounds[name]
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flop_ms = split.get(name, flop / peak * 1e3)
        out[name] = {"ms": us / 1e3, "plain_ms": plain_us / 1e3,
                     "library_ms": None if lib_us is None else lib_us / 1e3,
                     "bound_ms": max(bytes_ms, flop_ms),
                     "bound_by": "operations" if flop_ms > bytes_ms
                     else "bytes",
                     "tflop_per_s": flop / us / 1e6}
        if name in split:
            out[name]["cuda_core_bound_ms"] = max(
                bytes_ms, flop / F32_FLOP_PER_S * 1e3)
    whole = sum(out[n]["ms"] for n in BWD_KERNELS)
    nbytes, flop = bounds["backward"]
    out["backward"] = {"ms": whole, "bound_ms": max(
        nbytes / HBM_BYTES_PER_S * 1e3, split.get("backward",
                                                  flop / peak * 1e3)),
        "sdpa_bwd_ms": None if sdpa_bwd is None else sdpa_bwd / 1e3,
        "sdpa_bwd_kernels": sdpa_names, "plain_ms": plain_bwd / 1e3}
    route = f" ({'mma' if mma else 'f32'} route)"
    for name, r in out.items():
        log(f"{name}{'' if name == 'flash_attention_lse' else route} at q "
            f"{list(q.shape)} k/v {list(k.shape)} "
            f"{str(q.dtype)[6:]} ({card}): {r['ms']:.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms"
            + (f" by {r['bound_by']} ({r['tflop_per_s']:.1f} TFLOP/s)"
               if "bound_by" in r else " (five products a visible pair)")
            + (f" (split TF32; at the f32 CUDA-core peak "
               f"{r['cuda_core_bound_ms']:.4f} ms)"
               if "cuda_core_bound_ms" in r else "")
            + f"; plain version {r['plain_ms']:.4f} ms"
            + (f"; SDPA {r['library_ms']:.4f} ms" if r.get("library_ms")
               is not None else "")
            + (f"; SDPA's backward {r['sdpa_bwd_ms']} ms "
               f"({r['sdpa_bwd_kernels']})"
               if "sdpa_bwd_ms" in r else ""))
    return out


@contextlib.contextmanager
def plain_chunked_attention():
    """The training path's plain version on the card: ChunkedAttention's
    kernel calls answered by ``ref.chunked_fwd``/``chunked_bwd`` while
    active."""
    fwd, bwd = fa_kernel.flash_attention_lse, fa_kernel.flash_attention_bwd

    def plain_fwd(q, k, v, *, causal, scale, blocks):
        return fa_ref.chunked_fwd(q, k, v, causal=causal, scale=scale,
                                  q_chunk=blocks[0], k_chunk=blocks[1])

    def plain_bwd(q, k, v, o, lse, do, *, causal, scale, blocks):
        return fa_ref.chunked_bwd(q, k, v, o, lse, do, causal=causal,
                                  scale=scale, q_chunk=blocks[0],
                                  k_chunk=blocks[1])
    fa_kernel.flash_attention_lse = plain_fwd
    fa_kernel.flash_attention_bwd = plain_bwd
    try:
        yield
    finally:
        fa_kernel.flash_attention_lse = fwd
        fa_kernel.flash_attention_bwd = bwd


def loss_and_grads(cfg, params, batch, flags) -> tuple:
    named = dict(params.named_parameters())
    loss = api.loss_fn(cfg)(params, batch, flags)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), dict(zip(named, grads))


def step_checks(device="cuda") -> dict:
    """(b): Qwen1.5-0.5B at full width and 2 layers, one loss and its
    gradients: in float32 compute the kernel path against the plain path
    on the card, every leaf within 1e-4 of its largest magnitude; in bf16
    the card against the CPU, the loss and the global gradient norm
    within 2e-2."""
    base = dataclasses.replace(get_config(TRAIN_ARCH),
                               n_layers=STEP_CHECK["n_layers"])
    batch = TokenPipeline(DataConfig(
        vocab=base.vocab, seq_len=STEP_CHECK["seq"],
        global_batch=STEP_CHECK["batch"], seed=5), device=device).batch_at(0)
    out = {}
    # one draw of the float32 parameters (compute_dtype does not change
    # them), on the host and copied to the card
    host = init_train_state(base, torch.Generator().manual_seed(0),
                            "cpu")[0]
    params = {"cpu": host, device: copy.deepcopy(host).to(device)}
    cfg = dataclasses.replace(base, compute_dtype="float32")
    fa_kernel.reset_launches()
    loss_k, grads_k = loss_and_grads(cfg, params[device], batch,
                                     TRAIN_FLAGS)
    sync(device)
    launches = dict(fa_kernel.LAUNCHES)
    with plain_chunked_attention():
        loss_p, grads_p = loss_and_grads(cfg, params[device], batch,
                                         TRAIN_FLAGS)
    if torch.device(device).type == "cuda":
        n = cfg.n_layers
        require(launches["flash_attention_f32"] == 2 * n and all(
            launches[x] == n for x in BWD_KERNELS + BWD_ROUTES["f32"])
            and not any(launches[x] for x in BWD_ROUTES["mma"]),
            f"step check float32: launches {launches}, want {2 * n} "
            f"forward (one recomputed) and {n} of each backward kernel, on "
            "the f32 route")
    worst = max(rel_err(grads_k[k], grads_p[k]) for k in grads_p)
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    require(worst <= STEP_F32_TOL and loss_err <= STEP_F32_TOL,
            f"step check float32: kernel vs plain path loss {loss_err}, "
            f"worst leaf {worst} > {STEP_F32_TOL}")
    out["float32"] = {"loss_rel_err": loss_err, "worst_leaf": worst,
                      "launches": launches}
    log(f"train step, float32, 2 layers ({on_card(device)}): loss "
        f"{float(loss_k):.6f}, kernel vs plain path loss {loss_err:.3g}, "
        f"worst gradient leaf {worst:.3g} of its largest magnitude (limit "
        f"{STEP_F32_TOL}); launches {launches}")
    del grads_k, grads_p
    # bf16: the card against the CPU, the same host-drawn weights
    runs = {}
    for dev in (device, "cpu"):
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, grads = loss_and_grads(base, params[dev], b, TRAIN_FLAGS)
        runs[dev] = (float(loss), float(opt.global_norm(grads.values())))
        del grads
    del params
    (lc, gc_), (lp, gp) = runs[device], runs["cpu"]
    errs = (abs(lc - lp) / abs(lp), abs(gc_ - gp) / abs(gp))
    require(max(errs) <= STEP_BF16_TOL, f"step check bf16: card vs CPU "
            f"loss {errs[0]}, gradient norm {errs[1]} > {STEP_BF16_TOL}")
    out["bf16"] = {"loss": runs, "loss_rel_err": errs[0],
                   "grad_norm_rel_err": errs[1]}
    log(f"train step, bf16, 2 layers: card ({on_card(device)}) loss {lc:.5f}"
        f" grad norm {gc_:.5f}, CPU loss {lp:.5f} grad norm {gp:.5f}: "
        f"{errs[0]:.3g}, {errs[1]:.3g} (limit {STEP_BF16_TOL})")
    return out


def step_split(trainer, batch, wall_ms: float) -> dict:
    """Where one training step's device time goes (torch.profiler):
    attention forward (the flash kernel, recompute included), attention
    backward (the three backward kernels), matrix products and the rest;
    its busy share against the median step's wall time."""
    def step():
        trainer.params, trainer.opt_state, _ = trainer.step_fn(
            trainer.params, trainer.opt_state, batch)
    dev_ms, kernels, count = device_time([step])
    gemm_tags = ("gemm", "nvjet", "cutlass", "xmma", "cublas")
    split = {"attention_fwd": 0.0, "attention_bwd": 0.0, "matmul": 0.0,
             "other": 0.0}
    for name, us in kernels.items():
        low = name.lower()
        part = ("attention_bwd" if "flash_bwd" in name else
                "attention_fwd" if ("flash_mma_kernel" in name
                                    or "flash_fwd_kernel" in name) else
                "matmul" if any(t in low for t in gemm_tags) else "other")
        split[part] += us / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"device_ms": dev_ms, "device_ms_by_part": split,
            "busy_share": None if dev_ms is None else dev_ms / wall_ms,
            "device_ops": count, "top_device_us": {k[:60]: v for k, v in top}}


def trainer_phase(device="cuda") -> dict:
    """(c): the Trainer on Qwen1.5-0.5B at full width and depth: 6 steps
    from the pipeline with a checkpoint after step 3, the main path (the
    launch counters are zeroed just before it and read just after: 48
    forward launches a step, 24 of each backward kernel, on the
    tensor-core pair); the same Trainer then takes 8 steps on one
    repeated batch, which must lower the loss by more than 0.5, and one
    more step, profiled; a fresh Trainer restored from the checkpoint runs
    steps 4-6 with the same losses bit for bit."""
    cfg = get_config(TRAIN_ARCH)
    card = on_card(device)
    ocfg = opt.AdamWConfig(**TRAIN_OPT)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    on_gpu = torch.device(device).type == "cuda"
    n_attn = cfg.n_layers
    out, parts = {}, {}

    def trainer(steps):
        return Trainer(cfg, ocfg, dcfg, TrainConfig(
            steps=steps, ckpt_every=TRAIN_CKPT, ckpt_dir=tmp),
            flags=TRAIN_FLAGS, seed=0, device=device)

    def lap(name, t0):
        parts[name] = time.perf_counter() - t0
        return time.perf_counter()
    try:
        if on_gpu:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        a = trainer(TRAIN_STEPS)
        t0 = lap("set-up", t0)
        # 6 steps through the pipeline, a checkpoint after step 3 (the only
        # save kept: a save of the 620 M parameters and both moments is
        # 7.4 GB)
        save = a.checkpointer.save_async
        a.checkpointer.save_async = lambda step, tree, **kw: (
            save(step, tree, **kw) if step == TRAIN_CKPT else None)
        fa_kernel.reset_launches()
        hist_a = a.train(TRAIN_STEPS)
        run_s = time.perf_counter() - t0
        launches = dict(fa_kernel.LAUNCHES)
        t0 = lap("pipeline run", t0)
        if on_gpu:
            want = {"flash_attention": 2 * n_attn * TRAIN_STEPS,
                    **{k: n_attn * TRAIN_STEPS
                       for k in BWD_KERNELS + BWD_ROUTES["mma"]},
                    **dict.fromkeys(BWD_ROUTES["f32"], 0)}
            require(all(launches[k] == n for k, n in want.items()),
                    f"trainer: launches {launches}, want {want}")
        log(f"trainer ({card}): 6 steps through the pipeline "
            f"{[round(h['loss'], 4) for h in hist_a]} in {run_s:.1f} s "
            f"(a checkpoint after step {TRAIN_CKPT}); launches {launches}")
        # then 8 steps on one repeated batch
        batch = a.pipeline.batch_at(0)
        losses, times = [], []
        fa_kernel.reset_launches()
        for _ in range(TRAIN_REPEAT):
            sync(device)
            t1 = time.perf_counter()
            a.params, a.opt_state, stats = a.step_fn(a.params, a.opt_state,
                                                     batch)
            losses.append(float(stats["loss"]))
            times.append(time.perf_counter() - t1)
        repeat_launches = dict(fa_kernel.LAUNCHES)
        require(all(np.isfinite(losses)) and
                losses[-1] < losses[0] - TRAIN_DROP,
                f"trainer: 8 steps on one batch lowered the loss from "
                f"{losses[0]} to {losses[-1]}, not by {TRAIN_DROP}")
        step_ms = float(np.median(times[1:])) * 1e3
        tokens = TRAIN_BATCH * TRAIN_SEQ
        peak = memory_gib(device, peak=True)
        t0 = lap("repeated batch", t0)
        split = step_split(a, batch, step_ms) if on_gpu else {}
        t0 = lap("profiled step", t0)
        out["repeated_batch"] = {
            "losses": losses, "step_ms": times, "median_step_ms": step_ms,
            "tokens_per_s": tokens / step_ms * 1e3, "peak_gib": peak,
            "init_s": parts["set-up"], "launches": repeat_launches, **split}
        log(f"trainer ({card}): Qwen1.5-0.5B, {cfg.n_layers} layers, batch "
            f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_FLAGS.attn_impl} attention,"
            f" remat {TRAIN_FLAGS.remat}, chunked CE {TRAIN_FLAGS.ce_chunk}: "
            f"losses on one repeated batch after the pipeline run "
            f"{[round(x, 4) for x in losses]}; median step {step_ms:.1f} ms,"
            f" {tokens / step_ms * 1e3:,.0f} tokens/s, peak {peak} GiB, "
            f"set-up {parts['set-up']:.1f} s; launches {repeat_launches}")
        if split and split["device_ms"] is None:
            log(f"trainer step split ({card}): not measured (the profiler "
                "kept no record of the step)")
        elif split:
            log(f"trainer step split ({card}): device "
                f"{split['device_ms']:.1f} ms of a {step_ms:.1f} ms step "
                f"(busy {split['busy_share']:.3f}), "
                + ", ".join(f"{k} {v:.1f} ms" for k, v in
                            split["device_ms_by_part"].items())
                + f"; {split['device_ops']} device activities; top "
                f"{split['top_device_us']}")
        del a, batch, stats
        gc.collect()
        if on_gpu:
            torch.cuda.empty_cache()
        # a fresh Trainer restored from the checkpoint runs steps 4-6
        b = trainer(TRAIN_STEPS)
        b.checkpointer.save_async = lambda *a_, **kw: None
        require(b.maybe_restore() and b.step == TRAIN_CKPT
                and b.pipeline.index == TRAIN_CKPT,
                f"trainer: restore gave step {b.step}, offset "
                f"{b.pipeline.index}")
        t0 = lap("restore", t0)
        hist_b = b.train(TRAIN_STEPS)
        t0 = lap("resumed run", t0)
        full = [h["loss"] for h in hist_a[TRAIN_CKPT:]]
        resumed = [h["loss"] for h in hist_b]
        require(full == resumed, f"trainer: resumed losses {resumed} differ "
                f"from the uninterrupted run's {full}")
        del b
        out["resume"] = {"losses": [h["loss"] for h in hist_a],
                         "resumed": resumed, "run_s": run_s,
                         "launches": launches,
                         "stragglers": [h["straggler"] for h in hist_a]}
        out["parts_s"] = parts
        log(f"trainer ({card}): restored at step {TRAIN_CKPT} and resumed: "
            f"steps 4-6 {resumed} == the uninterrupted run's, bit for bit; "
            "(c) took " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                     parts.items()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        if on_gpu:
            torch.cuda.empty_cache()
    return out


def training_phase() -> tuple:
    """Phase 22's (b) and (c) ((a) runs with the other kernel checks);
    returns (run record, each kernel's launches on its main path: (c)'s
    6-step run for the forward, delta and the tensor-core pair, (b)'s
    float32 step for the f32 pair)."""
    t0 = time.perf_counter()
    steps = step_checks()
    t1 = time.perf_counter()
    run = trainer_phase()
    t2 = time.perf_counter()
    log(f"training: phase 22's (b) took {t1 - t0:.1f} s, (c) "
        f"{t2 - t1:.1f} s")
    main, f32 = run["resume"]["launches"], steps["float32"]["launches"]
    return {"step_checks": steps, **run}, {
        "flash_attention_lse": main["flash_attention"],
        "flash_bwd_delta": main["flash_bwd_delta"],
        **{k: main[k] for k in BWD_ROUTES["mma"]},
        "flash_bwd_dkdv": f32["flash_bwd_dkdv_f32"],
        "flash_bwd_dq": f32["flash_bwd_dq_f32"]}


# ---------------------------------------------------------------------------
# phase 23: distributed/, launch/ and roofline/ on the card
# ---------------------------------------------------------------------------
# (b): one Qwen1.5-0.5B layer's gradients (full width) on 4 ranks
COMPRESS_ARCH, COMPRESS_RANKS, COMPRESS_SEED = "qwen1.5-0.5b", 4, 2300
COMPRESS_TIMED = 5       # timed calls after one untimed; the median is kept
# (c): Qwen2.5-3B at full width and 2 layers, 2 x 256 tokens
SHARDED_LAYERS, SHARDED_BATCH, SHARDED_PROMPT = 2, 2, 256


def roofline_of_runs(run: dict) -> dict:
    """(a): the dry-run's counter (``launch/dryrun.py``, on a one-device
    mesh) on the two runs this script times whole: phase 22 (c)'s
    training step and phase 11's prefill wave, each beside its measured
    time: model FLOPs over the measured time and the bf16 peak (MFU), and
    the roofline bound's share of the measured time."""
    card = smi()
    cells = {
        "train_step": (get_config(TRAIN_ARCH),
                       ShapeSpec("phase22_step", "train", TRAIN_SEQ,
                                 TRAIN_BATCH), TRAIN_FLAGS,
                       run["training"]["repeated_batch"]["median_step_ms"]),
        "prefill_wave": (get_config(SERVE_ARCH),
                         ShapeSpec("phase11_prefill", "prefill", PROMPT_LEN,
                                   SLOTS), SERVE_PATHS["dense"].flags,
                         run["serving"]["prefill"]["device_ms"]),
    }
    out = {}
    for name, (cfg, shape, flags, ms) in cells.items():
        require(ms is not None, f"roofline {name}: no measured time")
        t0 = time.perf_counter()
        rep, _ = dryrun.lower(cfg, shape, "one", train_flags=flags,
                              serve_flags=flags, verbose=False)
        s = ms / 1e3
        rec = {"measured_ms": ms, "counted_flops": rep.flops_per_device,
               "counted_bytes": rep.bytes_per_device,
               "model_flops": rep.model_flops_total,
               "compute_ms": rep.compute_s * 1e3,
               "memory_ms": rep.memory_s * 1e3,
               "bound_ms": rep.bound_s * 1e3, "bottleneck": rep.bottleneck,
               "mfu": rep.mfu(s), "bound_share": rep.bound_s / s,
               "kernels": rep.probes["d1"]["kernels"],
               "trace_s": time.perf_counter() - t0}
        require(all(np.isfinite(v) and v > 0 for v in (
            rec["counted_flops"], rec["counted_bytes"], rec["mfu"],
            rec["bound_share"])) and rec["mfu"] < 1,
                f"roofline {name}: {rec}")
        out[name] = rec
        log(f"roofline {name} ({card}): {cfg.name}, {shape.global_batch} x "
            f"{shape.seq_len}, {flags.attn_impl} attention, remat "
            f"{flags.remat}, kernels a probe {rec['kernels']}: counted {rec['counted_flops']:.4g} "
            f"FLOPs and {rec['counted_bytes']:.4g} bytes (eager, each op's "
            f"inputs and outputs) a step, model FLOPs "
            f"{rec['model_flops']:.4g}; compute {rec['compute_ms']:.2f} ms, "
            f"memory {rec['memory_ms']:.2f} ms -> {rec['bottleneck']}-bound "
            f"{rec['bound_ms']:.2f} ms; measured {ms:.2f} ms: mfu "
            f"{rec['mfu']:.4f}, bound share {rec['bound_share']:.4f}; "
            f"counted in {rec['trace_s']:.1f} s")
    return out


def compress_grads(rank: int) -> dict:
    """Rank ``rank``'s seeded float32 gradients at the leaf shapes of one
    Qwen1.5-0.5B layer (full width), on the CPU."""
    cfg = dataclasses.replace(get_config(COMPRESS_ARCH), n_layers=1)
    shapes = {n: tuple(p.shape) for n, p in dryrun.meta_params(cfg)
              .named_parameters() if n.startswith("layers.0.")}
    gen = torch.Generator().manual_seed(COMPRESS_SEED + rank)
    return {n: torch.randn(s, generator=gen) * 0.01
            for n, s in shapes.items()}


def compress_worker(rank: int, world: int, dev) -> dict:
    """(b) on one rank: ``psum_compressed`` of this rank's gradients on
    the card (once under the collective recorder, then ``COMPRESS_TIMED``
    timed repeats, each equal to the first) and on the CPU, and
    ``compress_with_feedback`` over 3 steps on both."""
    grads = compress_grads(rank)
    on_dev = {k: v.to(dev) for k, v in grads.items()}
    with CollectiveRecorder() as rec:
        summed = compression.psum_compressed(on_dev)    # untimed: warm-up
    times = []
    for _ in range(COMPRESS_TIMED):
        torch.distributed.barrier()
        sync(dev)
        t0 = time.perf_counter()
        again = compression.psum_compressed(on_dev)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        require(all(torch.equal(again[k], summed[k]) for k in grads),
                "compressed all-reduce: a repeat differs")
    cpu = compression.psum_compressed(grads)
    same = all(torch.equal(summed[k].cpu(), cpu[k]) for k in grads)
    ef_dev, ef_cpu = (compression.ErrorFeedback.init(g)
                      for g in (on_dev, grads))
    ef_same = True
    for _ in range(3):
        c_dev, ef_dev = compression.compress_with_feedback(on_dev, ef_dev)
        c_cpu, ef_cpu = compression.compress_with_feedback(grads, ef_cpu)
        ef_same &= all(torch.equal(c_dev[k].cpu(), c_cpu[k]) and
                       torch.equal(ef_dev.residual[k].cpu(),
                                   ef_cpu.residual[k]) for k in grads)
    return dict(ms=float(np.median(times)), times=times, coll=rec.report(),
                same=same, ef_same=ef_same,
                summed={k: v.cpu() for k, v in summed.items()}
                if rank == 0 else None)


def compressed_allreduce(device="cuda") -> dict:
    """(b): ``psum_compressed`` and ``compress_with_feedback`` on 4 gloo
    ranks on the card: CUDA ranks equal to CPU ranks bit for bit, the sum
    within 4 x (block max / 254) of the exact sum of the 4 ranks'
    gradients, the bytes a rank sends (the recorder) and the ms."""
    card = on_card(device)
    res = collectives.spawn_ranks(compress_worker, COMPRESS_RANKS,
                                  backend="gloo", device=device,
                                  timeout=DIST_TIMEOUT)
    require(all(r["same"] and r["ef_same"] for r in res),
            "compressed all-reduce: CUDA ranks differ from CPU ranks")
    grads = [compress_grads(r) for r in range(COMPRESS_RANKS)]
    worst, n = 0.0, 0
    for k, got in res[0]["summed"].items():
        exact = sum(g[k].double() for g in grads)
        blocks = [compression.quantize_int8(g[k])[1] for g in grads]
        bmax = torch.stack(blocks).amax(0) * 127.0      # each block's max
        allowed = (4 * bmax / 254).repeat_interleave(compression.BLOCK)
        err = F.pad((got.double() - exact).reshape(-1).abs(),
                    (0, -got.numel() % compression.BLOCK))
        slack = 8 * 2.0 ** -24 * exact.abs().max()
        require(bool((err <= allowed.double() + slack).all()),
                f"compressed all-reduce {k}: error past 4 x block max / 254")
        worst = max(worst, float((err / (allowed.double() + slack)).max()))
        n += got.numel()
    coll = res[0]["coll"]
    ms = max(r["ms"] for r in res)      # the slowest rank's median
    log(f"compressed all-reduce ({card}; gloo, {COMPRESS_RANKS} ranks on "
        f"one card, staged through host memory): one Qwen1.5-0.5B layer's "
        f"{len(grads[0])} leaves, {n:,} floats a rank: CUDA ranks == CPU "
        f"ranks bit for bit (psum and 3 error-feedback steps); error at "
        f"most {worst:.3f} of 4 x block max / 254; bytes a rank sends "
        f"{coll['total']:,.0f} ({coll['counts']['all-reduce']} float32 "
        f"all-reduces, ring factor 2: the reference's dequantized payload, "
        f"4 bytes an element); {ms:.3f} ms (the slowest rank's median of "
        f"{COMPRESS_TIMED} calls after an untimed one; each rank's calls: "
        f"{[[round(t, 3) for t in r['times']] for r in res]})")
    return {"ms": ms, "times": [r["times"] for r in res], "bytes_sent": coll["total"], "coll": coll,
            "elements": n, "worst_share_of_bound": worst}


def sharded_serving(device="cuda") -> dict:
    """(c): Qwen2.5-3B at full width and 2 layers on a one-card
    ``DeviceMesh`` under ``SINGLE_POD_SERVE``, every parameter a DTensor
    of its spec: the prefill's and one decode step's logits equal the same
    run's without rules, bit for bit, with the same attention launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    card = on_card(device)
    cfg = dataclasses.replace(get_config(SERVE_ARCH),
                              n_layers=SHARDED_LAYERS)
    flags = OptFlags(attn_impl="chunked")
    gen = torch.Generator(device=device).manual_seed(SERVE_SEED)
    toks = torch.randint(0, cfg.vocab, (SHARDED_BATCH, SHARDED_PROMPT + 1),
                         generator=gen, device=device, dtype=torch.int32)
    prompt, nxt = toks[:, :-1], toks[:, -1:]

    def run(params):
        fa_kernel.reset_launches()
        with torch.no_grad():
            logits, cache = api.prefill_fn(cfg)(
                params, {"tokens": prompt}, SHARDED_PROMPT + 8, flags)
            step, _ = api.decode_fn(cfg)(params, cache, nxt, flags)
            full = [x.full_tensor() if sh.is_dtensor(x) else x
                    for x in (logits, step)]
        sync(device)
        return full, dict(fa_kernel.LAUNCHES)

    params = api.init_params(cfg, gen, device, compute_dtype=True)
    plain, plain_launches = run(params)
    dev = torch.device(device)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{tmp}/store", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh(dev.type, (1, 1),
                                mesh_dim_names=("data", "model"))
        rules = sh.SINGLE_POD_SERVE
        sh.distribute_params(params, sh.build_param_specs(params, rules,
                                                          mesh), mesh)
        with sh.use_rules(rules, mesh), implicit_replication():
            sharded, launches = run(params)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    same = all(torch.equal(a, b) for a, b in zip(sharded, plain))
    require(same, "sharded serving: logits differ from the run without "
            "rules")
    require(launches == plain_launches and launches["flash_attention"] ==
            (SHARDED_LAYERS if dev.type == "cuda" else 0),
            f"sharded serving: attention launches {launches}, without rules "
            f"{plain_launches}")
    log(f"sharded serving ({card}): Qwen2.5-3B, {SHARDED_LAYERS} layers, "
        f"{SHARDED_BATCH} x {SHARDED_PROMPT} tokens, SINGLE_POD_SERVE on a "
        f"(1, 1) DeviceMesh, every parameter a DTensor: prefill and one "
        f"decode step's logits == the run without rules, bit for bit; "
        f"attention through local_map, flash_attention launches "
        f"{launches['flash_attention']} (without rules "
        f"{plain_launches['flash_attention']})")
    return {"same": same, "launches": launches}


def distributed_slice_phase(run: dict) -> dict:
    """Phase 23: (a) the roofline of phases 22 and 11, (b) the compressed
    all-reduce on 4 ranks, (c) the sharded serving path on one card."""
    return {"roofline": roofline_of_runs(run),
            "compressed_allreduce": compressed_allreduce(),
            "sharded_serving": sharded_serving()}


def on_card(device) -> str:
    """What a timing ran on: the card's name and power limit, or the
    host's CPU."""
    return smi() if torch.device(device).type == "cuda" else "host CPU"


def lint_phase() -> dict:
    """Phase 24: the port's contract linter (``python -m
    repro_torch.analysis --strict --json``) in a subprocess, over the
    package and this script; a finding, or an exit other than 0, fails
    the run."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict", "--json"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    seconds = time.perf_counter() - t0
    report = json.loads(proc.stdout) if proc.stdout.strip() else {}
    for f in report.get("findings", []):
        log(f"lint: {f['path']}:{f['line']}:{f['col']}: {f['rule']} "
            f"{f['message']}")
    summary = report.get("summary", {})
    per_rule = {r: summary.get("per_rule", {}).get(r, 0)
                for r in report.get("rules", [])}
    log(f"lint: repro_torch.analysis --strict over {report.get('files')} "
        f"files in {seconds:.2f} s: {summary.get('total')} findings, per "
        f"rule {per_rule}, {len(report.get('pragmas', []))} pragmas; exit "
        f"{proc.returncode}")
    require(proc.returncode == 0 and summary.get("total") == 0,
            f"the port's linter failed (exit {proc.returncode}): "
            f"{proc.stderr.strip()[-2000:]}")
    return {"files": report["files"], "per_rule": per_rule,
            "seconds": seconds}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def build_kernels(phases) -> dict:
    """The kernel sources the phases run, built at once, one nvcc each
    (all four for a whole run); logs and returns each kernel's registers
    and spills as ptxas reported them."""
    t0 = time.perf_counter()
    kernels = [(src, build) for src, build, uses in (
        (KV_SRC, kv_kernel.build, (*range(2, 10), 14, 15, 16, 17, 19)),
        (FA_SRC, fa_kernel.build, (10, 11, 18, 20, 21, 22)),
        (FA_BWD_SRC, fa_kernel.build_bwd, (22,)),
        (SSD_SRC, ssd_kernel.build, (12, 13, 20))) if set(uses) & phases]
    with concurrent.futures.ThreadPoolExecutor(max(len(kernels), 1)) as pool:
        builds = [pool.submit(build) for _, build in kernels]
        for b in builds:
            b.result()
    log(f"built {', '.join(src for src, _ in kernels) or 'nothing'} for "
        f"sm_90a in {time.perf_counter() - t0:.1f} s")
    usage = kernel_build.ptxas_report()
    for lib, per_kernel in usage.items():
        log(f"ptxas, {lib}: " + "; ".join(
            f"{name} {u['registers']} registers"
            + (f", {u['spill_stores']}/{u['spill_loads']} bytes spilled "
               "(stores/loads)" if u["spill_stores"] or u["spill_loads"]
               else "")
            + (", wgmma serialized" if u["wgmma_serialized"] else "")
            for name, u in per_kernel.items()))
    return usage


ALL_PHASES = tuple(range(1, 25))


def parse_phases(argv) -> set:
    """``--phases 12,13``: the build, phase 1 and the named phases (a
    phase that needs an earlier one's run brings it along: 4 and 5 need 3,
    8 needs 7, 23 reads 11's and 22's times).  No argument: every
    phase."""
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
    if 23 in phases:
        phases |= {11, 22}
    return phases


T_START = time.perf_counter()


def main(argv=None) -> None:
    phases = parse_phases(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device - this script measures the "
                 "port on a GPU and has no CPU mode")
    t_start = T_START
    ptxas = build_kernels(phases)
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
    if 22 in phases:
        # phase 22 (a), timed here with the other kernel checks: late in a
        # long run the profiler keeps no record of a short window
        kernels.update(check_flash_backward())
    floor = launch_floor_ms()
    card = smi()
    us = lambda ms: "n/a" if ms is None else f"{ms * 1e3:.2f} us"

    def dev_us(rec, key):   # event time where the profiler saw nothing
        if rec[f"{key}ms"] is None or rec.get(f"{key}device_measured",
                                              True):
            return us(rec[f"{key}ms"])
        return f"not measured (event time {us(rec[f'{key}ms'])})"

    for name, rec in kernels.items():
        if "call_ms" not in rec:    # phase 22's records print their own
            continue
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

    def add_launches(counts: dict) -> None:
        """A kernel's launches add up over the main paths that ran it,
        each counted from zero."""
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
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
        add_launches(run["ssm_serving"]["launches"])
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
    if 18 in phases:
        for key in ("moe", "scout"):
            t0 = time.perf_counter()
            rec = run[f"{key}_serving"] = serving_phase(SERVE_PATHS[key])
            add_launches(rec["launches"])
            log(f"{key}_serving: phase 18's run took "
                f"{time.perf_counter() - t0:.1f} s")
    if 19 in phases:
        t0 = time.perf_counter()
        run["examples"] = examples_phase()
        log(f"examples: phase 19's run took {time.perf_counter() - t0:.1f} s")
    if 20 in phases:
        t0 = time.perf_counter()
        run["hybrid_serving"] = serving_phase(SERVE_PATHS["hybrid"])
        add_launches(run["hybrid_serving"]["launches"])
        log(f"hybrid_serving: phase 20's run took "
            f"{time.perf_counter() - t0:.1f} s")
    if 21 in phases:
        for key in ("whisper", "vlm"):
            t0 = time.perf_counter()
            rec = run[f"{key}_serving"] = serving_phase(SERVE_PATHS[key])
            add_launches(rec["launches"])
            log(f"{key}_serving: phase 21's run took "
                f"{time.perf_counter() - t0:.1f} s")
    if 22 in phases:
        run["training"], counts = training_phase()
        add_launches(counts)
    if 23 in phases:
        t0 = time.perf_counter()
        run["distributed_slice"] = distributed_slice_phase(run)
        log(f"distributed slice: phase 23's run took "
            f"{time.perf_counter() - t0:.1f} s")
    if 24 in phases:
        run["lint"] = lint_phase()

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches.get(name),
         "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
         "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
         "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]}
        for name, rec in kernels.items() if name in SOURCES]}
    log(json.dumps({
        "card": card, **run, "kernel_detail": kernels, "ptxas": ptxas,
        "add_one_ms": floor,
        "seconds": time.perf_counter() - t_start,
    }))
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
