"""Train a ~100M-param qwen2-family model for a few hundred steps (port of
``examples/train_lm.py``).

    python -m repro_torch.examples.train_lm [--steps 200] [--full-100m] \
        [--ckpt-dir DIR] [--device cuda|cpu]

Drives ``repro_torch.launch.train`` on qwen2-0.5b's smoke config (or, with
``--full-100m``, a 12L x 768d x 32k-vocab config, ~100M parameters) and
prints ``OK`` when the last loss is below the first. The checkpoint
directory defaults to ``repro_train_lm`` under the temporary directory,
and the launcher resumes from it: as in the reference, a second run from
the same directory has no step left and fails (ROADMAP queue 3).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.launch import train as train_driver


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_lm"))
    ap.add_argument("--full-100m", action="store_true",
                    help="12L x 768d x 32k-vocab (~100M params)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    argv2 = ["--arch", "qwen2-0.5b", "--smoke",
             "--steps", str(args.steps), "--batch", str(args.batch),
             "--seq", str(args.seq), "--ckpt-dir", args.ckpt_dir,
             "--device", args.device]
    import repro_torch.configs.qwen2_0_5b as q
    smoke = q.smoke
    if args.full_100m:
        # register a one-off 100M config in place of the smoke entry
        cfg100 = dataclasses.replace(
            smoke(), name="qwen2-100m", n_layers=12, d_model=768,
            n_heads=12, n_kv_heads=4, d_head=64, d_ff=2048,
            vocab_size=32000)
        q.smoke = lambda: cfg100
    try:
        losses = train_driver.main(argv2)
    finally:
        q.smoke = smoke
    if not losses[-1] < losses[0]:
        raise SystemExit("loss did not improve")
    print("OK")
    return losses


if __name__ == "__main__":
    main()
