"""Serving engine of the port: batched prefill + greedy decode in waves,
with per-request latency accounting (the reference's
``repro/serve/engine.py``).

``build_prefill_step`` / ``build_decode_step`` are the step functions;
``ServingEngine`` is the host loop: it admits requests in waves of
``slots``, prefills each wave together, decodes it in lock step and
records when each request was submitted and done.  It serves every
family of ``api`` (dense, MoE, SSM, hybrid, VLM, encoder-decoder) with
no logic of its own per family but the stub frontends' inputs, zeros as
the reference's engine gives them (``stub_inputs``).  The cache is whatever the model's prefill returns and its decode
updates; ``cache_len`` must hold every position a wave writes (the VLM's
``vis_len`` included), except for the SSM family, which keeps no KV
cache.  It runs on one device (``device``, CUDA
unless the caller asks for the CPU) under ``torch.inference_mode()``.
The multi-replica cache protocols (NetCRAQ and NetChain over a chain
group of ranks) are in ``serve/kv_cache.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.models import api
from repro_torch.models import transformer as TF
from repro_torch.models.transformer import BASELINE_FLAGS, OptFlags


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """The next token ``[B, 1]`` int32: argmax of the last position (the
    first index on ties, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def build_prefill_step(cfg: ArchConfig, cache_len: int,
                       flags: OptFlags = BASELINE_FLAGS):
    pf = api.prefill_fn(cfg)

    def prefill_step(params, batch):
        logits, cache = pf(params, batch, cache_len, flags)
        return _greedy(logits), cache

    return prefill_step


def build_decode_step(cfg: ArchConfig, flags: OptFlags = BASELINE_FLAGS):
    df = api.decode_fn(cfg)

    def decode_step(params, cache, token):
        logits, cache = df(params, cache, token, flags)
        return _greedy(logits), cache

    return decode_step


def stub_inputs(cfg: ArchConfig, B: int, device) -> dict:
    """The stub frontend's inputs of a batch of ``B``, zeros in the compute
    dtype: ``frames [B, enc_len, d]`` for the encoder-decoder, ``embeds
    [B, vis_len, d]`` for a config with ``vis_len``, none otherwise."""
    lead = {"frames": cfg.enc_len if cfg.family == "encdec" else 0,
            "embeds": cfg.vis_len}
    return {name: torch.zeros((B, n, cfg.d_model), dtype=cfg.cdtype(),
                              device=device)
            for name, n in lead.items() if n}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int = 16
    submitted_at: float = 0.0
    done_at: float = 0.0
    output: Optional[np.ndarray] = None


class ServingEngine:
    """Host-side batch scheduler over a fixed slot count, on one device.

    ``params`` stays as given (``self.params``); the steps read
    ``self.weights``, the same parameters cast once to the compute dtype
    on ``device`` (``transformer.compute_params``: bit for bit the same
    outputs, without converting float32 weights on every step).
    ``waves`` records, per wave, its size and the wall time of its
    prefill (to a device synchronize) and of its decode steps."""

    def __init__(self, cfg: ArchConfig, params, *, slots: int = 8,
                 cache_len: int = 256, flags: OptFlags = BASELINE_FLAGS,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params
        self.weights = TF.compute_params(params, cfg, self.device)
        self.slots = slots
        self.cache_len = cache_len
        self._prefill = build_prefill_step(cfg, cache_len, flags)
        self._decode = build_decode_step(cfg, flags)
        self.completed: list[Request] = []
        self.waves: list[dict] = []

    def run(self, requests: list[Request], prompt_len: int,
            on_wave=None) -> list[Request]:
        """Serve a request list in waves of ``slots`` (prefill together,
        decode lock-step; per-request early exit on max_new).
        ``on_wave(record)``, if given, is called after each wave with its
        record (``waves[-1]``)."""
        out = []
        for i in range(0, len(requests), self.slots):
            wave = requests[i: i + self.slots]
            out.extend(self._run_wave(wave, prompt_len))
            if on_wave is not None:
                on_wave(self.waves[-1])
        self.completed.extend(out)
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_wave(self, wave, prompt_len: int):
        toks = np.stack([r.prompt[:prompt_len] for r in wave])
        for r in wave:
            r.submitted_at = time.perf_counter()
        t0 = time.perf_counter()
        max_new = max(r.max_new for r in wave)
        need = self.cfg.vis_len + prompt_len + max_new - 1
        if self.cfg.family != "ssm" and need > self.cache_len:
            raise ValueError(
                f"cache_len={self.cache_len} cannot hold the {need} "
                f"positions of a wave (vis_len {self.cfg.vis_len} + prompt "
                f"{prompt_len} + {max_new - 1} decode steps)")
        with torch.inference_mode():
            batch = {"tokens": torch.as_tensor(toks, dtype=torch.int32,
                                               device=self.device),
                     **stub_inputs(self.cfg, len(wave), self.device)}
            tok, cache = self._prefill(self.weights, batch)
            self._sync()
            t1 = time.perf_counter()
            outs = [tok]
            for _ in range(max_new - 1):
                tok, cache = self._decode(self.weights, cache, tok)
                outs.append(tok)
            gen = torch.cat(outs, dim=1).cpu().numpy()
        t2 = time.perf_counter()
        for b, r in enumerate(wave):
            r.output = gen[b, : r.max_new]
            r.done_at = time.perf_counter()
        self.waves.append({"requests": len(wave), "prompt_len": prompt_len,
                           "prefill_ms": 1e3 * (t1 - t0),
                           "decode_steps": max_new - 1,
                           "decode_ms": 1e3 * (t2 - t1)})
        return wave

    @property
    def latencies_ms(self) -> list[float]:
        return [
            1e3 * (r.done_at - r.submitted_at) for r in self.completed
            if r.done_at
        ]
