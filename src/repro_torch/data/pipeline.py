"""Data pipeline: deterministic synthetic LM stream + host-sharded loader.

A numpy-only copy of ``repro.data.pipeline`` (the port imports nothing of
the reference): the same batches from the same seed.

Design mirrors a production multi-host input pipeline:
  * the logical dataset is an infinite, seedable, *indexable* stream, so any
    host can compute any batch — restart/elastic re-shard need no data state
    beyond the step counter (checkpoint stores only `step`);
  * each host takes a disjoint slice of the global batch
    (``ShardedLoader``) determined by (host_id, n_hosts);
  * a background ``Prefetcher`` thread keeps `depth` batches ready so input
    never serializes with the step (compute/IO overlap on the host side).

The reference's elastic ``ShardedLoader.reshard`` is left out: the port
trains in one process.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLM:
    """Deterministic synthetic token stream: batch `i` is a pure function of
    (seed, i). A light Markov structure makes the loss meaningfully
    decreasing (learnable bigram skeleton + noise) rather than pure noise."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed random bigram table: next-token bias
        self._bigram = rng.integers(0, cfg.vocab,
                                    size=(cfg.vocab,)).astype(np.int32)

    @staticmethod
    def _hash(x: np.ndarray) -> np.ndarray:
        """splitmix64 — counter-based randomness, vectorized."""
        x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        x ^= x >> np.uint64(30)
        x = (x * np.uint64(0xBF58476D1CE4E5B9)).astype(np.uint64)
        x ^= x >> np.uint64(27)
        x = (x * np.uint64(0x94D049BB133111EB)).astype(np.uint64)
        return x ^ (x >> np.uint64(31))

    def batch(self, index: int, start: int, size: int) -> dict[str, np.ndarray]:
        """Rows [start, start+size) of global batch `index`.

        Row r of batch i is a pure function of (seed, i, r) — NOT of the
        (start, size) slicing — so any shard decomposition (and any elastic
        re-shard) sees identical data."""
        cfg = self.cfg
        rows = (np.arange(start, start + size, dtype=np.uint64)[:, None]
                + np.uint64(index) * np.uint64(1 << 20)
                + np.uint64(cfg.seed) * np.uint64(1 << 40))
        t_ix = np.arange(cfg.seq_len + 1, dtype=np.uint64)[None, :]
        h = self._hash(rows * np.uint64(0x100000001) + t_ix)
        rand = (h % np.uint64(cfg.vocab)).astype(np.int32)
        noise = (self._hash(h) >> np.uint64(40)).astype(np.float64) / (1 << 24)
        toks = np.empty((size, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rand[:, 0]
        for t in range(cfg.seq_len):
            follow = self._bigram[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < 0.75, follow,
                                      rand[:, t + 1])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class ShardedLoader:
    """Host-sharded view of the stream: host h of H owns rows
    [h*B/H, (h+1)*B/H) of every global batch."""

    def __init__(self, source: SyntheticLM, host_id: int, n_hosts: int):
        cfg = source.cfg
        assert cfg.global_batch % n_hosts == 0, (cfg.global_batch, n_hosts)
        self.source = source
        self.host_id = host_id
        self.n_hosts = n_hosts

    @property
    def per_host(self) -> int:
        return self.source.cfg.global_batch // self.n_hosts

    def batch(self, index: int) -> dict[str, np.ndarray]:
        return self.source.batch(index, self.host_id * self.per_host,
                                 self.per_host)


class Prefetcher:
    """Background thread that keeps `depth` batches ready."""

    def __init__(self, loader: ShardedLoader, start_step: int = 0,
                 depth: int = 2):
        self.loader = loader
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.loader.batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict[str, np.ndarray]]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def make_train_iterator(cfg: DataConfig, host_id: int = 0, n_hosts: int = 1,
                        start_step: int = 0, prefetch: int = 2) -> Prefetcher:
    return Prefetcher(ShardedLoader(SyntheticLM(cfg), host_id, n_hosts),
                      start_step=start_step, depth=prefetch)
