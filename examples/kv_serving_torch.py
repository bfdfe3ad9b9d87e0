"""End-to-end run on the PyTorch port (the paper's kind: a serving
system): serve a small LM with batched requests on the ServingEngine,
with the NetCRAQ chain as the coordination layer - model version, serving
epoch and per-wave cache metadata live in the in-network store, and
replica health runs through the failure detector + hedged-read policy.
The same flow as ``kv_serving.py``, on ``repro_torch`` (random weights
from a torch generator seeded 0): it runs on a CUDA card unless
``--device cpu`` is given (with no card, the default is an error).

    PYTHONPATH=src python examples/kv_serving_torch.py [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.coordinator import Coordinator
from repro_torch.core.failure import FailureDetector, HedgedReadPolicy
from repro_torch.core.store import Store, init_store
from repro_torch.core.types import ChainConfig
from repro_torch.models import api
from repro_torch.serve.engine import Request, ServingEngine

MODEL_VERSION_KEY = 10
SERVING_EPOCH_KEY = 11


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    # -- model: reduced qwen1.5 (same family as the full config) ----------
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(), n_layers=2)
    params = api.init_params(cfg, torch.Generator().manual_seed(0), dev)
    n_params = sum(x.numel() for x in params.parameters())
    print(f"serving {cfg.name} (reduced: {n_params / 1e6:.1f}M params)")

    # -- coordination: NetCRAQ chain stores serving metadata --------------
    coord = Coordinator(ChainConfig(n_nodes=4, num_keys=64), device=dev)
    store = Store(*[x[0] for x in init_store(coord.cfg, device=dev)])
    store = coord.put_host(store, MODEL_VERSION_KEY, 1)
    store = coord.put_host(store, SERVING_EPOCH_KEY, 1)
    print(f"coordination store: model_version="
          f"{coord.get_host(store, MODEL_VERSION_KEY)}, epoch="
          f"{coord.get_host(store, SERVING_EPOCH_KEY)}")

    detector = FailureDetector(n_nodes=4, timeout_ticks=8)
    hedge = HedgedReadPolicy(fanout=2)
    print(f"hedged reads target {hedge.targets(1, coord.chains[0])} "
          "(cheap under CRAQ: any replica serves clean reads)")

    # -- batched serving ---------------------------------------------------
    engine = ServingEngine(cfg, params, slots=8, cache_len=64, device=dev)
    rng = np.random.default_rng(0)
    requests = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab, 16), max_new=8)
        for i in range(32)
    ]
    t0 = time.perf_counter()
    done = engine.run(requests, prompt_len=16)
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    lat = np.asarray(engine.latencies_ms)
    print(f"\nserved {len(done)} requests / {toks} tokens in {dt:.2f}s "
          f"({toks / dt:,.0f} tok/s)")
    print(f"latency p50={np.percentile(lat, 50):.1f}ms "
          f"p99={np.percentile(lat, 99):.1f}ms")
    for node in range(4):
        detector.tick()
        detector.heard_from(node)
    print(f"replica health: suspected={detector.suspected()} (all alive)")

    # -- model rollout: bump the version through the chain ----------------
    store = coord.put_host(store, MODEL_VERSION_KEY, 2)
    print(f"\nrolled out model_version="
          f"{coord.get_host(store, MODEL_VERSION_KEY)} via the chain "
          "(clients discover it with a 2-packet clean read)")


if __name__ == "__main__":
    main()
