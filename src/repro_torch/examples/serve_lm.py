"""Serve a small model with batched requests (prefill + decode engine; port
of ``examples/serve_lm.py``, which serves qwen2-0.5b).

    python -m repro_torch.examples.serve_lm [--arch ARCH] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import list_archs
from repro_torch.launch import serve as serve_driver


def main(argv=None) -> torch.Tensor:
    """The arch's smoke config (default qwen2-0.5b), 4 prompts of 32
    tokens, 32 generated; returns the (4, 32) generated tokens."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list_archs(), default="qwen2-0.5b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    out = serve_driver.main(["--arch", args.arch, "--smoke", "--batch",
                             "4", "--prompt-len", "32", "--gen", "32",
                             "--device", args.device])
    print("OK")
    return out


if __name__ == "__main__":
    main()
