"""Deterministic, shard-aware token data pipeline.

The port's own copy of `repro.data.pipeline` (numpy only, no tensor): the
same sources, batches and prefetch order, so a batch here equals the
reference's element for element.

Sources:
  SyntheticSource : structured pseudo-text (Zipf unigrams + local n-gram
                    structure so a small LM actually has something to
                    learn), deterministic in (seed, shard, index).
  MemmapSource    : flat binary token file (np.memmap), the production
                    path for tokenized corpora.

Loader semantics match multi-host training: each data shard reads a
disjoint slice by (shard_id, num_shards); batches are (tokens, targets)
with targets = next-token labels.  A background thread keeps a prefetch
queue full.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np


class SyntheticSource:
    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab = vocab_size
        self.seed = seed

    def sequence(self, index: int, length: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, index))
        # Zipf unigram base
        ranks = np.arange(1, self.vocab + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(self.vocab, size=length + 1, p=probs)
        # inject learnable bigram structure: token t+1 = f(t) half the time
        follow = (toks[:-1] * 31 + 7) % self.vocab
        mask = rng.random(length) < 0.5
        toks[1:][mask] = follow[mask]
        return toks.astype(np.int32)


class MemmapSource:
    def __init__(self, path: str | Path, dtype=np.uint16):
        self.arr = np.memmap(path, dtype=dtype, mode="r")

    def sequence(self, index: int, length: int) -> np.ndarray:
        n = len(self.arr)
        start = (index * length) % max(n - length - 1, 1)
        return np.asarray(self.arr[start: start + length + 1], np.int32)

    @staticmethod
    def write(path: str | Path, tokens: np.ndarray, dtype=np.uint16):
        np.asarray(tokens, dtype).tofile(path)


@dataclass
class LoaderConfig:
    batch_size: int          # per-shard batch
    seq_len: int
    shard_id: int = 0
    num_shards: int = 1
    prefetch: int = 2
    seed: int = 0


class DataLoader:
    """Yields {"tokens": (B, S) int32, "targets": (B, S) int32} forever."""

    def __init__(self, source, cfg: LoaderConfig):
        self.source = source
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._step = 0
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._stop = threading.Event()
        self._thread.start()

    def _index(self, step: int, row: int) -> int:
        c = self.cfg
        return (step * c.num_shards + c.shard_id) * c.batch_size + row

    def _make(self, step: int) -> dict:
        c = self.cfg
        seqs = np.stack([self.source.sequence(self._index(step, r), c.seq_len)
                         for r in range(c.batch_size)])
        return dict(tokens=seqs[:, :-1].astype(np.int32),
                    targets=seqs[:, 1:].astype(np.int32))

    def _fill(self):
        # a batch is made once and offered until the queue takes it (the
        # reference makes it anew on every offer: the same batches in the
        # same order, at the cost of a busy thread holding the GIL)
        step, batch = 0, None
        while not self._stop.is_set():
            if batch is None:
                batch = self._make(step)
            try:
                self._q.put(batch, timeout=0.2)
            except queue.Full:
                continue
            step, batch = step + 1, None

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def batch_at(self, step: int) -> dict:
        """Random access (deterministic restart support)."""
        return self._make(step)

    def close(self):
        self._stop.set()
