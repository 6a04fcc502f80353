"""Autotune the fused ICP kernel's launch setting on the card (port of
``tools/autotune_fused.py``).

    python -m repro_torch.tools.autotune_fused [--m 16384] [--samples 4096] \\
        [--device cuda] [--out PATH] [--apply]

Sweeps ``kernels.fused_icp.FusedConfig``: warps (queries) per block, one of
``WARPS_PER_BLOCK``, times the bf16 prune, 8 settings. On the reference's
scene and frame pair (seq 0, frame 5; the target subsampled to ``--m``
points) it gathers the first iteration's candidate rows once and, per
setting, times the fused pass alone and one whole fused iteration (the
pass, its ``torch.sum`` and ``core.transform.estimate_from_moments``) with
CUDA events around back-to-back calls (``repro_torch.device.device_ms``),
and reads the setting's compiled resources (``fused_resources``:
registers, spills, occupancy).

Parity gate: a setting's moment planes must be the bits of the plain
version (``kernels.ref.fused_moment_planes``) and its T the bits of the
default setting's; the reference's ``transform_diff <= 1e-3`` is recorded
beside that. A setting that fails cannot win, and if every setting fails
the tool raises.

The winner is the setting whose pass takes the least device time; it
displaces the default only if its slowest block beat the default's
fastest (every reading better, else the difference is noise). The pass is
what a setting changes. The whole iteration is recorded beside it, but it
ranks nothing on this port: each Kabsch step copies a constant from the
host (``core/svd3x3.py``), so an iteration cannot be queued ahead of the
card, and its time (milliseconds, varying by a third between blocks) is
the host's, against a pass of ~0.013 ms.

The JSON report (default ``build/autotune_fused.json``, git-ignored; never
the reference's committed ``BENCH_fused_autotune.json``) holds every
setting, the winner, the default and the card's name and power limit.
``--apply`` exits 1 when the winner is not ``DEFAULT_CONFIG``: update it
after a kernel change or on another card. ``--device cpu`` runs the plain
version, where the launch setting does not apply: the report says that its
host-clock times rank nothing.
"""
from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import sys
import time

import numpy as np
import torch

from repro_torch.core import ICPParams
from repro_torch.core.nn_search_grid import (DEFAULT_GRID_DIMS,
                                             gather_candidate_points,
                                             grid_voxel_size)
from repro_torch.core.transform import estimate_from_moments
from repro_torch.data.pointcloud import SceneConfig, frame_pair
from repro_torch.data.voxelize import build_voxel_grid
from repro_torch.device import card_line, device_ms, resolve_device
from repro_torch.kernels import build, fused_icp, ref
from repro_torch.kernels.fused_icp import (DEFAULT_CONFIG, WARPS_PER_BLOCK,
                                           FusedConfig)

PRUNE_CANDIDATES = (False, True)
MAX_PER_CELL = 32                # the pyramid polish's grid capacity
TRANSFORM_TOL = 1e-3             # the reference's parity bar
DEFAULT_OUT = build.REPO_ROOT / "build" / "autotune_fused.json"
REFERENCE_BASELINE = "BENCH_fused_autotune.json"
# The reference's sweep scene and frame (tools/autotune_fused.py).
SEED_FRAME = 5
SCENE = SceneConfig(n_ground=40_000, n_walls=30_000, n_poles=8_000,
                    n_clutter=9_000, extent=40.0, sensor_range=45.0)


def settings() -> list[FusedConfig]:
    """Every launch setting the sweep ranks, warps-major."""
    return [FusedConfig(w, p)
            for w, p in itertools.product(WARPS_PER_BLOCK, PRUNE_CANDIDATES)]


def sweep_inputs(m: int, samples: int, device):
    """The reference's inputs: seq 0 frame ``SEED_FRAME`` with ``samples``
    source points, the target subsampled to ``m`` points by
    ``default_rng(0)``, and the first iteration's (T = I) candidate rows
    over a (128, 128, 32) grid of voxel ``max(1, gate)``. Returns
    ``(q, cand, sv, m)`` on ``device``."""
    src, dst_full, _ = frame_pair(0, SEED_FRAME, SCENE, samples)
    rng = np.random.default_rng(0)
    dst = dst_full[rng.choice(dst_full.shape[0], min(m, dst_full.shape[0]),
                              replace=False)]
    q = torch.as_tensor(src, dtype=torch.float32, device=device)
    grid = build_voxel_grid(
        torch.as_tensor(dst, dtype=torch.float32, device=device),
        grid_voxel_size(ICPParams().max_correspondence_distance),
        DEFAULT_GRID_DIMS)
    cand = gather_candidate_points(q, grid, MAX_PER_CELL, 1)
    sv = torch.ones(q.shape[:-1], dtype=torch.float32, device=device)
    return q, cand, sv, int(dst.shape[0])


def time_setting(iteration, planes, device: torch.device) -> dict:
    """Median, fastest and slowest block of ms of one call of
    ``iteration`` and of ``planes``: ``device_ms`` on the card (the
    host-bound iteration at 5 calls a block, 3 blocks), the host clock on
    the CPU."""
    out = {}
    for name, fn, reps, blocks in (("iter", iteration, 5, 3),
                                   ("pass", planes, 20, 5)):
        if device.type == "cuda":
            med, lo, hi, ahead = device_ms(fn, reps=reps, blocks=blocks)
        else:
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            med, lo, hi, ahead = float(np.median(times)), min(times), \
                max(times), False
        out.update({f"{name}_ms": med, f"{name}_ms_min": lo,
                    f"{name}_ms_max": hi, f"{name}_device_only": ahead})
    return out


def sweep(m: int = 16_384, samples: int = 4096, *, device="cuda",
          out_json: str | pathlib.Path | None = None) -> dict:
    """Rank every launch setting; returns the report (and writes it to
    ``out_json`` when given)."""
    dev = resolve_device(device)
    if out_json is not None and pathlib.Path(out_json).name == \
            REFERENCE_BASELINE:
        raise ValueError(f"{REFERENCE_BASELINE} is the reference's committed "
                         f"baseline; write the port's report elsewhere")
    params = ICPParams()
    kw = dict(gate=params.max_correspondence_distance,
              robust_kernel=params.robust_kernel,
              robust_scale=params.robust_scale)
    q, cand, sv, m_used = sweep_inputs(m, samples, dev)
    plain = {p: ref.fused_moment_planes(q, cand, sv, prune=p, **kw)
             for p in PRUNE_CANDIDATES}

    def planes_fn(cfg):
        return lambda: fused_icp.moment_planes(
            q, cand, sv, prune=cfg.prune,
            warps_per_block=cfg.warps_per_block, **kw)

    def iteration_fn(cfg):
        def step():
            s = fused_icp.fused_moment_sweep(
                q, cand, sv, prune=cfg.prune,
                warps_per_block=cfg.warps_per_block, **kw)
            mo = fused_icp._assemble(s)
            return estimate_from_moments(mo.sw, mo.sp, mo.sq, mo.spq)
        return step

    T_default = iteration_fn(DEFAULT_CONFIG)()
    rows = []
    for cfg in settings():
        planes = planes_fn(cfg)()
        T = iteration_fn(cfg)()
        row = dict(cfg._asdict())
        row["planes_bit_equal"] = bool(torch.equal(planes, plain[cfg.prune]))
        row["T_bit_equal"] = bool(torch.equal(T, T_default))
        row["transform_diff"] = float((T - T_default).abs().max())
        row["parity_ok"] = (row["planes_bit_equal"] and row["T_bit_equal"]
                            and row["transform_diff"] <= TRANSFORM_TOL)
        row.update(time_setting(iteration_fn(cfg), planes_fn(cfg), dev))
        row["resources"] = fused_icp.fused_resources(
            cfg, ck=cand.shape[-2], device=dev if dev.type == "cuda" else None)
        rows.append(row)
        print(f"warps={cfg.warps_per_block:2d} prune={int(cfg.prune)} "
              f"iter={row['iter_ms']:9.4f} ms pass={row['pass_ms']:9.4f} ms "
              f"diff={row['transform_diff']:.2e}"
              + ("" if row["parity_ok"] else "  PARITY FAIL"))

    valid = [r for r in rows if r["parity_ok"]]
    if not valid:
        raise RuntimeError("autotune: every setting failed the parity gate")
    best = min(valid, key=lambda r: r["pass_ms"])
    default = next(r for r in rows if (r["warps_per_block"], r["prune"])
                   == tuple(DEFAULT_CONFIG))
    within_noise = (default["parity_ok"]
                    and best["pass_ms_max"] >= default["pass_ms_min"])
    if within_noise:
        best = default
    on_card = dev.type == "cuda"
    report = dict(
        device=dev.type,
        device_name=torch.cuda.get_device_name(dev) if on_card else "cpu",
        card=card_line() if on_card else None,
        times_rank_nothing=not on_card,
        timing=("device ms (CUDA events around back-to-back calls)"
                if on_card else "host-clock ms of the plain version: the "
                "launch setting does not apply on the CPU, and these times "
                "rank nothing"),
        n=int(q.shape[-2]), m=m_used, ck=int(cand.shape[-2]),
        gate=params.max_correspondence_distance,
        configs=rows,
        ranked_by="pass_ms",
        best={k: best[k] for k in ("warps_per_block", "prune", "pass_ms",
                                   "iter_ms")},
        best_within_noise_of_default=within_noise,
        default=dict(DEFAULT_CONFIG._asdict()),
        default_is_best=(best["warps_per_block"], best["prune"])
        == tuple(DEFAULT_CONFIG))
    if out_json is not None:
        out = pathlib.Path(out_json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=2) + "\n")
    print(f"\nbest: warps={best['warps_per_block']} prune={best['prune']} "
          f"({best['pass_ms']:.4f} ms a pass) on {report['device_name']}"
          + ("" if report["default_is_best"]
             else " — differs from FusedConfig defaults"))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=16_384,
                    help="target cloud size (default 16384)")
    ap.add_argument("--samples", type=int, default=4096,
                    help="query cloud size (default 4096)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help=f"report path (default {DEFAULT_OUT})")
    ap.add_argument("--apply", action="store_true",
                    help="exit 1 if the winner differs from the committed "
                         "FusedConfig defaults (reminder to update them)")
    args = ap.parse_args(argv)
    report = sweep(m=args.m, samples=args.samples, device=args.device,
                   out_json=args.out)
    if args.apply and not report["default_is_best"]:
        print("autotune: update DEFAULT_CONFIG in "
              "src/repro_torch/kernels/fused_icp.py", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
