"""Data pipeline: deterministic synthetic stream + binary-corpus reader,
with background prefetch — the port's copy of ``repro/train/data.py``
(numpy and a thread; ``batch_at(step)`` gives the reference's arrays).

Determinism contract (fault tolerance): batch(step) is a pure function of
(seed, step), so restart-from-checkpoint resumes the exact stream without
any pipeline state in the checkpoint.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.configs.base import ModelConfig


class SyntheticLM:
    """Zipf-ish synthetic token stream (power-law ids like real corpora)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        v = self.cfg.vocab_size
        # zipf via inverse-cdf on a pareto-ish tail, clipped to vocab
        u = rng.random((self.batch, self.seq + 1))
        toks = np.minimum((u ** -1.2).astype(np.int64), v - 1).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.frontend == "vision":
            ft = self.cfg.frontend_tokens
            out["patch_embeds"] = rng.normal(
                size=(self.batch, ft, self.cfg.d_model)).astype(np.float32)
            out["tokens"] = out["tokens"][:, : self.seq - ft]
            lab = np.full((self.batch, self.seq), -1, np.int32)
            lab[:, ft:] = toks[:, 1: self.seq - ft + 1]
            out["labels"] = lab
        if self.cfg.encoder_layers > 0:
            out["enc_frames"] = rng.normal(
                size=(self.batch, self.seq // 2, self.cfg.d_model)
            ).astype(np.float32)
        return out


class BinCorpus:
    """Memory-mapped flat token file (uint16/uint32); window sampling is a
    pure function of (seed, step) for deterministic resume."""

    def __init__(self, path: str, cfg: ModelConfig, batch: int, seq: int,
                 dtype=np.uint16, seed: int = 0):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        n = len(self.tokens) - self.seq - 1
        starts = rng.integers(0, n, self.batch)
        toks = np.stack([np.asarray(self.tokens[s: s + self.seq + 1])
                         for s in starts]).astype(np.int32)
        toks %= self.cfg.vocab_size
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Background-thread prefetch of batch_at(step) for step = start..∞."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            b = self.source.batch_at(s)
            while not self._stop.is_set():
                try:
                    self.q.put((s, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def next(self) -> tuple[int, dict]:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=2)
