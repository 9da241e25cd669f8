"""Deterministic, shardable data pipeline.

The port's own copy of ``repro.data.pipeline`` (numpy only): the same
seeds give the same batches, so ``batch_at`` is identical in both
packages.

Production posture: each host owns a disjoint shard of the global batch
(``host_id``/``num_hosts``), batches are derivable from ``step`` alone
(stateless resume — the checkpoint stores just the step counter), and a
double-buffered prefetch thread hides host->device transfer.

The token source here is synthetic (seeded permutation LM over a
Zipf-ish unigram mix — enough structure that training measurably
reduces loss) plus a memory-mapped binary-token file source for real
corpora.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    source: str = "synthetic"       # synthetic | mmap
    path: Optional[str] = None      # for mmap: int32 token file

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split over {self.num_hosts} hosts")
        return self.global_batch // self.num_hosts


class SyntheticLM:
    """Seeded synthetic corpus: next-token = affine-permuted current
    token with occasional resets — learnable structure, zero storage."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        v = cfg.vocab_size
        rng = np.random.default_rng(cfg.seed)
        self.perm = rng.permutation(v)
        self.unigram = rng.zipf(1.5, size=v * 4) % v

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for a given global step — pure function of (seed, step,
        host_id): resume == replay."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_id))
        b, s = cfg.host_batch, cfg.seq_len
        start = self.unigram[rng.integers(0, len(self.unigram), b)]
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = start
        noise = rng.random((b, s))
        resets = self.unigram[rng.integers(0, len(self.unigram), (b, s))]
        for t in range(s):
            nxt = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < 0.05, resets[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class MmapTokens:
    """Memory-mapped int32 token stream, deterministic strided reads."""

    def __init__(self, cfg: DataConfig):
        if not cfg.path:
            raise ValueError("mmap source needs a path")
        self.cfg = cfg
        self.tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")
        self.n_windows = (len(self.tokens) - 1) // cfg.seq_len

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b, s = cfg.host_batch, cfg.seq_len
        rng = np.random.default_rng((cfg.seed, step, cfg.host_id))
        idx = rng.integers(0, self.n_windows, b)
        toks = np.stack([self.tokens[i * s:i * s + s + 1] for i in idx])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def make_source(cfg: DataConfig):
    return MmapTokens(cfg) if cfg.source == "mmap" else SyntheticLM(cfg)


#: Queue marker the producer enqueues after recording a failure, so the
#: consumer wakes up and re-raises instead of blocking forever.
_SENTINEL = object()


class Prefetcher:
    """Double-buffered background prefetch keyed by step (resumable).

    A failing source must not hang training: if ``batch_at`` raises, the
    producer records the exception and enqueues a sentinel; the consumer
    drains any already-buffered good batches, then re-raises the
    producer's error as a ``RuntimeError`` (with the original chained as
    ``__cause__``) instead of blocking on an empty queue forever."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.step = start_step
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        step = self.step
        try:
            while not self._stop.is_set():
                batch = self.source.batch_at(step)
                try:
                    self.q.put((step, batch), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue
        except BaseException as e:
            self._error = e
            while not self._stop.is_set():
                try:
                    self.q.put(_SENTINEL, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            try:
                item = self.q.get(timeout=0.5)
            except queue.Empty:
                if self._error is not None:
                    raise RuntimeError(
                        "data producer failed") from self._error
                if not self.thread.is_alive():
                    raise RuntimeError("data producer thread died")
                continue
            if item is _SENTINEL:
                raise RuntimeError("data producer failed") from self._error
            return item

    def close(self):
        self._stop.set()
        # drain so the producer can observe the stop flag
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=2.0)
