"""Fleet-scale registration: many frame-pairs in one batched engine call
(port of ``examples/fleet_registration.py``).

Mixed-size clouds are collated into shape buckets and registered as one
batch by ``RegistrationEngine.register_pairs``. With ``--engine
distributed`` the same batch runs through the legacy point-sharded fleet
engine (``core.distributed``) over the local cards, frames split over
``"data"`` and each target over ``"model"``.

    python -m repro_torch.examples.fleet_registration --frames 4

Engines take the port's names or the reference's, mapped as the launcher
maps them (``xla`` -> ``torch``, the plain search and the default, as in
the reference; ``pallas`` -> ``cuda``, the NN kernel; ``distributed``, the
NN kernel on each shard; ``pyramid``). The pairs are drawn from a seeded
``torch.Generator`` (seed 0) with ``core.transform.random_rigid_transform``:
the reference's recipe, other draws than its JAX PRNG's. Everything runs
on ``--device`` (default ``cuda``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import ICPParams, get_engine
from repro_torch.core.transform import random_rigid_transform, transform_points
from repro_torch.launch.registration import ENGINE_ALIASES


def fleet_pairs(frames: int, points: int):
    """``frames`` (source, target) pairs and their ground-truth T: a target
    of ``points - 37 * (i % 3)`` points uniform in a 20 m cube (mixed sizes
    on purpose: the collator buckets them), T within 0.1 rad and 0.3 m, the
    source the target moved by T⁻¹ plus 2 mm noise. numpy float32, drawn on
    the CPU from ``torch.Generator().manual_seed(0)``."""
    g = torch.Generator().manual_seed(0)
    pairs, gts = [], []
    for i in range(frames):
        m = points - 37 * (i % 3)
        tgt = torch.rand((m, 3), generator=g) * 20.0 - 10.0
        T = random_rigid_transform(max_angle=0.1, max_translation=0.3,
                                   generator=g)
        s = transform_points(torch.linalg.inv(T), tgt)
        s = s + 0.002 * torch.randn(s.shape, generator=g)
        pairs.append((s.numpy(), tgt.numpy()))
        gts.append(T.numpy())
    return pairs, gts


def main(argv=None) -> list[float]:
    """Register the fleet; returns max |T - T_gt| per frame."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--engine", default="xla",
                    choices=["xla", "pallas", "distributed", "pyramid",
                             "torch", "cuda"])
    ap.add_argument("--minimizer", default="point_to_point",
                    choices=["point_to_point", "point_to_plane"])
    ap.add_argument("--robust", default="none",
                    choices=["none", "huber", "tukey"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    pairs, gts = fleet_pairs(args.frames, args.points)
    engine = get_engine(ENGINE_ALIASES.get(args.engine, args.engine),
                        device=args.device, chunk=256)
    params = ICPParams(max_iterations=25, chunk=256,
                       minimizer=args.minimizer, robust_kernel=args.robust)
    t0 = time.time()
    res, batch = engine.register_pairs(pairs, params)
    T = res.T.cpu().numpy()
    dt = time.time() - t0
    errs = [float(np.abs(T[i] - gts[i]).max()) for i in range(args.frames)]
    print(f"{args.frames} registrations (buckets src={batch.src.shape} "
          f"dst={batch.dst.shape}, engine={args.engine}) in {dt:.2f}s "
          f"({dt / args.frames * 1e3:.0f} ms/frame incl. first-call setup)")
    print("max |T - T_gt| per frame:", [f"{e:.4f}" for e in errs])
    assert max(errs) < 0.05
    print("OK")
    return errs


if __name__ == "__main__":
    main()
