"""Trainer loop: checkpoint and restart, async saves, straggler flagging,
the checkpoint epoch in the coordination store (the port's copy of
``repro/train/trainer.py``).

The host only feeds batches (prefetched), steps, logs and snapshots
checkpoints: one ``float(loss)`` a step is the loop's one sync with the
device.  The model, its AdamW state, the coordination store and the
batches live on ``device`` (the card unless the caller asks for the
CPU).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.coordinator import Coordinator
from repro_torch.core.store import Store, init_store
from repro_torch.core.types import ChainConfig, resolve_device
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.transformer import BASELINE_FLAGS, OptFlags
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import build_train_step, init_train_state


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_ckpt"
    accum_steps: int = 1
    compress_grads: bool = False
    straggler_slack: float = 3.0   # step-time multiple before flagging


class Trainer:
    def __init__(self, cfg: ArchConfig, opt_cfg: opt.AdamWConfig,
                 data_cfg: DataConfig, tcfg: TrainConfig,
                 flags: OptFlags = BASELINE_FLAGS, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.flags = flags
        self.device = resolve_device(device)
        self.pipeline = TokenPipeline(data_cfg, device=self.device)
        self.step_fn = build_train_step(
            cfg, opt_cfg, flags, accum_steps=tcfg.accum_steps,
            compress_grads=tcfg.compress_grads)
        # drawn on the host, so the card and the CPU start from the same
        # weights
        self.params, self.opt_state = init_train_state(
            cfg, torch.Generator().manual_seed(seed), self.device)
        self.step = 0
        self.history: list[dict] = []
        self.coordinator = Coordinator(ChainConfig(n_nodes=4, num_keys=64),
                                       device=self.device)
        self.coord_store = Store(*[x[0] for x in init_store(
            self.coordinator.cfg, device=self.device)])
        self.checkpointer = ckpt.AsyncCheckpointer(
            tcfg.ckpt_dir, self.coordinator, self.coord_store)
        self.step_times: list[float] = []

    # -- restart -------------------------------------------------------------
    def maybe_restore(self) -> bool:
        last = ckpt.latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return False
        (self.params, self.opt_state), manifest = ckpt.restore(
            self.tcfg.ckpt_dir, (self.params, self.opt_state), last)
        self.step = manifest["step"]
        self.pipeline.index = manifest["data_offset"]
        return True

    # -- loop ----------------------------------------------------------------
    def train(self, steps: Optional[int] = None) -> list[dict]:
        steps = steps or self.tcfg.steps
        it = iter(self.pipeline)
        t_ref = None
        while self.step < steps:
            batch = next(it)
            t0 = time.perf_counter()
            self.params, self.opt_state, stats = self.step_fn(
                self.params, self.opt_state, batch)
            loss = float(stats["loss"])
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            self.step += 1

            # straggler detection: a step far beyond the running median
            # flags this worker for the coordinator
            if t_ref is None and len(self.step_times) >= 5:
                t_ref = float(np.median(self.step_times))
            straggler = bool(t_ref is not None
                             and dt > self.tcfg.straggler_slack * t_ref)

            rec = {"step": self.step, "loss": loss, "time_s": dt,
                   "straggler": straggler,
                   "grad_norm": float(stats["grad_norm"])}
            self.history.append(rec)
            if self.step % self.tcfg.ckpt_every == 0 or self.step == steps:
                self.checkpointer.save_async(
                    self.step, (self.params, self.opt_state),
                    data_offset=self.pipeline.index)
        it.close()
        self.checkpointer.wait()
        return self.history
