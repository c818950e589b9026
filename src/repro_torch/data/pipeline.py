"""Deterministic synthetic token pipeline with host-side prefetch, a
copy of `repro.data.pipeline` (host numpy; batches array-equal to the
reference's for the same seed, step, rank and world).

Production shape: a seeded, stateless source (step -> batch) so any step
is reproducible after restart (checkpoint stores only the step number);
a background thread keeps a bounded prefetch queue full (double
buffering overlaps host batch generation with device compute); shards
slice the global batch by data-parallel rank for multi-host launches.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLM:
    """Zipf-ish token stream with next-token labels; step-indexed and
    fully deterministic (restart-safe)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks ** 1.1
        self._probs = probs / probs.sum()

    def batch_at(self, step: int, rank: int = 0, world: int = 1) -> dict:
        cfg = self.cfg
        assert cfg.global_batch % world == 0
        per = cfg.global_batch // world
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, rank]))
        toks = rng.choice(cfg.vocab_size, size=(per, cfg.seq_len + 1),
                          p=self._probs).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Bounded background prefetch: next batches are generated while the
    device step runs (the async/overlap trick at the host level)."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2, rank: int = 0, world: int = 1):
        self.source = source
        self.queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self.rank, self.world = rank, world
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step, self.rank, self.world)
            while not self._stop.is_set():
                try:
                    self.queue.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple:
        return self.queue.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
