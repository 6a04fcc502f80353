"""LEGACY LM-decode path: batched generate with a persistent KV cache (port
of ``repro.serve.engine``).

Prefill once, then decode in lockstep (every sequence of the batch at the
same position), the standard benchmark-serving shape. Streams cannot join
or leave mid-generation; the paper's workload, point-cloud registration,
is served with continuous batching by
:mod:`repro_torch.serve.registration_service`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm


class Engine:
    """Lockstep LM generate engine: one prefill, then one eager decode step
    a token at positions ``s + i - 1``, each writing the KV cache in place
    (the reference donates the cache buffer to its jitted step).

    ``params`` is a :class:`repro_torch.models.lm.DecoderLM`; it is moved
    to ``device`` (default ``"cuda"``; raises without a card)."""

    def __init__(self, cfg: ArchConfig, params: lm.DecoderLM,
                 max_len: int = 2048, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.max_len = max_len

    @torch.inference_mode()
    def generate(self, prompts, n_steps: int, temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """prompts: (B, S) int tokens (tensor or numpy) -> (B, n_steps)
        int32 generated tokens on the engine's device.

        Greedy (``temperature <= 0``) takes the argmax, the first index on
        ties; otherwise tokens are drawn from ``softmax(logits /
        temperature)`` with ``generator`` (default: seeded with 0)."""
        cfg = self.cfg
        if isinstance(prompts, np.ndarray):
            prompts = torch.from_numpy(prompts)
        prompts = prompts.to(self.device)
        b, s = prompts.shape
        if s + n_steps > self.max_len:
            raise ValueError(f"prompt {s} + {n_steps} steps exceeds max_len "
                             f"{self.max_len}")
        if generator is None and temperature > 0.0:
            generator = torch.Generator(self.device).manual_seed(0)
        logits, cache = lm.prefill(self.params, cfg, tokens=prompts,
                                   max_len=self.max_len)
        tok = self._sample(logits, temperature, generator)
        out = [tok]
        for i in range(1, n_steps):
            logits, cache = lm.decode_step(self.params, cfg, s + i - 1, cache,
                                           token=tok)
            tok = self._sample(logits, temperature, generator)
            out.append(tok)
        return torch.stack(out, dim=1)

    @staticmethod
    def _sample(logits, temperature, generator):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)
