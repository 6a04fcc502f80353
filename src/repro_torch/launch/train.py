"""End-to-end training driver (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        [--smoke] --steps 50 --batch 8 --seq 128 --ckpt-dir build/run1 \
        [--device cuda|cpu]

Streams deterministic data with prefetch onto ``--device`` (default
``cuda``; raises without a card), checkpoints atomically (async, keep-k),
resumes from the latest checkpoint if present, and runs the straggler
watchdog; prints the reference's lines and returns the step losses.
Weights are random, from ``lm.init_params_numpy(cfg, seed)`` (JAX's PRNG
cannot be reproduced); the optimizer is ``pick_optimizer``'s with
``cosine_schedule(lr, 20, max(steps, 21))``. It builds no mesh: the
reference builds one when it sees several devices and never uses it.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config, get_smoke, list_archs
from repro_torch.data.tokens import PrefetchLoader, TokenStream
from repro_torch.device import resolve_device
from repro_torch.optim import cosine_schedule, pick_optimizer
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import train_step as ts


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list_archs(), default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    opt = pick_optimizer(cfg.total_params(),
                         cosine_schedule(args.lr, warmup_steps=20,
                                         total_steps=max(args.steps, 21)))
    step_fn = ts.make_train_step(cfg, opt, remat=args.remat,
                                 accum_steps=args.accum)

    state = ts.init_state(args.seed, cfg, opt, device)
    start_step = 0
    manager = None
    if args.ckpt_dir:
        manager = ckpt_lib.CheckpointManager(args.ckpt_dir, keep_last_k=3,
                                             save_interval_steps=args.ckpt_every)
        if ckpt_lib.latest_step(args.ckpt_dir) is not None:
            state, start_step, _ = manager.restore_latest(
                ts.abstract_state(cfg, opt), device=device)
            print(f"resumed from step {start_step}")

    stream = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=args.seed,
                         embed_dim=None if cfg.embed_inputs else cfg.d_model)
    loader = PrefetchLoader(stream, device=device, start_step=start_step)
    watchdog = ckpt_lib.StragglerWatchdog()

    if manager is not None:
        ckpt_lib.install_preemption_handler(
            manager, lambda: (state, start_step))

    t_start = time.time()
    losses = []
    try:
        for step, batch in loader:
            if step >= args.steps:
                break
            t0 = time.time()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0
            if watchdog.observe(step, dt):
                print(f"[watchdog] step {step} straggled: {dt:.2f}s "
                      f"(ema {watchdog.ema:.2f}s)")
            if step % args.log_every == 0:
                tok_s = args.batch * args.seq / dt
                print(f"step {step:5d} loss {loss:.4f} {dt*1e3:7.1f} ms "
                      f"{tok_s:9.0f} tok/s")
            if manager is not None and manager.should_save(step + 1):
                manager.save_async(state, step + 1)
            start_step = step + 1
    finally:
        loader.close()
        if manager is not None:
            manager.save_sync(state, start_step)
            manager.wait()
    total = time.time() - t_start
    # as in the reference, a run with no step left to take (resumed at
    # --steps) fails here on the empty ``losses`` (ROADMAP queue 3)
    print(f"done: {start_step} steps in {total:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
