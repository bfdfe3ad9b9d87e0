"""Deterministic synthetic token pipeline, shard-aware and prefetched (the
port's copy of ``repro/data/pipeline.py``).

Batch ``index`` of data-parallel rank ``dp_rank`` is a pure function of
``(seed, index, dp_rank)``: numpy's Philox generator with ``key=seed`` and
``counter=[0, 0, dp_rank, index]``, the reference's own draw, so the two
packages' batches are equal bit for bit and a resume from a checkpointed
offset is exact.  A background thread prefetches host batches (numpy);
the consumer moves each to ``device`` as it takes it.  ``index`` is
bumped before each ``yield``, so the offset a checkpoint records is the
next batch's.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.types import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    dp_rank: int = 0
    dp_size: int = 1
    seed: int = 1234
    prefetch: int = 2

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.dp_size:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of dp_size {self.dp_size}")
        return self.global_batch // self.dp_size


class TokenPipeline:
    def __init__(self, cfg: DataConfig, start_index: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.index = start_index
        self.device = resolve_device(device)
        self._q: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- deterministic access ------------------------------------------------
    def _tokens_for_index(self, index: int) -> np.ndarray:
        """Batch ``index`` for this rank: int32 ``[local_batch, seq_len +
        1]``."""
        c = self.cfg
        rng = np.random.Generator(
            np.random.Philox(key=c.seed, counter=[0, 0, c.dp_rank, index]))
        return rng.integers(0, c.vocab, size=(c.local_batch, c.seq_len + 1),
                            dtype=np.int32)

    def _host_batch(self, index: int) -> dict:
        toks = self._tokens_for_index(index)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def batch_at(self, index: int) -> dict:
        """Batch ``index`` on the device: ``tokens`` and ``labels`` (the
        next-token shift), int32 ``[local_batch, seq_len]``."""
        return self._to_device(self._host_batch(index))

    # -- iteration with background prefetch ----------------------------------
    def _producer(self):
        while not self._stop.is_set():
            item = self._host_batch(self.index_to_produce)
            self.index_to_produce += 1
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    pass

    def __iter__(self) -> Iterator[dict]:
        self._q = queue.Queue(maxsize=self.cfg.prefetch)
        self.index_to_produce = self.index
        self._stop.clear()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        try:
            while True:
                item = self._q.get()
                # bump before the yield: the generator suspends there, so an
                # increment after it would lag the checkpointed offset
                self.index += 1
                yield self._to_device(item)
        finally:
            self.stop()

    def stop(self):
        self._stop.set()
        if self._q is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join()
            self._thread = None
