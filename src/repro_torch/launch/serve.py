"""Batched LM serving driver (legacy lockstep decode path; port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        [--smoke] --batch 4 --prompt-len 32 --gen 32 [--device cuda|cpu]

Drives :class:`repro_torch.serve.engine.Engine`, the LM-zoo decode loop,
not the paper's workload (``python -m repro_torch.launch.registration
--mode serve`` serves the point-cloud fleet). Weights are random, from
``lm.init_params_numpy(cfg, seed)``; prompts are uniform tokens from
``prompt_tokens(seed + 1, ...)``. Runs on ``--device`` (default ``cuda``;
raises without a card).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.engine import Engine


def prompt_tokens(seed: int, batch: int, prompt_len: int,
                  vocab_size: int) -> np.ndarray:
    """(batch, prompt_len) int32 prompts, uniform over the vocabulary."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab_size, (batch, prompt_len), dtype=np.int32)


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list_archs(), default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.embed_inputs:
        raise SystemExit(f"{args.arch} takes precomputed embeddings; serve "
                         "via examples/odometry.py-style drivers instead")
    device = resolve_device(args.device)
    params = lm.init_params(cfg, args.seed, device=device)
    engine = Engine(cfg, params, max_len=args.prompt_len + args.gen,
                    device=device)
    prompts = prompt_tokens(args.seed + 1, args.batch, args.prompt_len,
                            cfg.vocab_size)
    generator = torch.Generator(device).manual_seed(args.seed)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.gen, temperature=args.temperature,
                          generator=generator)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = args.batch * args.gen
    print(f"generated {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s incl. prefill)")
    print("sample:", out[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()
