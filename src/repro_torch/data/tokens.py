"""Synthetic LM token pipeline: deterministic and prefetched (port of
``repro.data.tokens``).

Per-step batches come from a seeded Zipf-ish unigram stream on the host
(numpy, the reference's batches bit for bit), are placed on a device, and
are prefetched on a background thread so host data work overlaps device
compute. Batch content is a pure function of (seed, step), so a restart
resumes bit-identically from a checkpointed step.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device


class TokenStream:
    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, embed_dim: int | None = None):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.embed_dim = embed_dim  # set for embeds-input (vlm/audio) archs
        # Zipf-like unigram distribution (fixed across steps).
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._p = p / p.sum()

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step) -> host numpy batch."""
        rng = np.random.default_rng((self.seed * 1_000_003 + step) & 0x7FFFFFFF)
        toks = rng.choice(self.vocab, size=(self.batch, self.seq + 1),
                          p=self._p).astype(np.int32)
        out = {"labels": toks[:, 1:]}
        if self.embed_dim is None:
            out["tokens"] = toks[:, :-1]
        else:
            # frontend stub: precomputed frame/patch embeddings
            out["embeds"] = rng.standard_normal(
                (self.batch, self.seq, self.embed_dim)).astype(np.float32) * 0.1
        return out


class PrefetchLoader:
    """Background-thread prefetch + device placement: yields ``(step,
    batch)`` with every array of the batch a tensor on ``device`` (default
    ``"cuda"``; raises without a card)."""

    def __init__(self, stream: TokenStream, device="cuda",
                 start_step: int = 0, prefetch: int = 2):
        self.stream = stream
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _place(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            b = self.stream.batch_at(step)
            try:
                self._q.put((step, self._place(b)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
