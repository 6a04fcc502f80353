"""End-to-end driver: LiDAR odometry over a synthetic sequence (port of
``examples/odometry.py``).

Two execution modes over the same synthetic KITTI-like stream (the paper's
autonomous-driving use case, §IV-A):

  * ``--mode scan_to_map`` (default) — streaming scan-to-map odometry:
    every frame registers against the rolling local submap with a
    constant-velocity warm start (``repro_torch.core.odometry``). Per-frame
    error stops compounding because the map is the common anchor.
  * ``--mode frame_to_frame`` — the classic chain of consecutive-pair
    registrations. All pairs are independent, so the whole sequence runs
    as ONE batched engine call (``register_pairs``) and only the cheap
    4x4 pose composition stays sequential on the host.

By default the stream *resamples* surface points every frame (a real
LiDAR never hits the same points twice); ``--static-world`` restores the
legacy static-world protocol, whose identical points across frames hand
frame-to-frame ICP an unrealistically exact correspondence. Both modes
share the per-frame iteration cap (``--iters``) so drift is comparable
like-for-like.

    python -m repro_torch.examples.odometry --frames 30
    python -m repro_torch.examples.odometry --mode frame_to_frame

Engines take the port's names or the reference's, mapped as the launcher
maps them (``xla`` -> ``torch``, the plain search; ``pallas`` -> ``cuda``,
the NN kernel; ``distributed``; ``pyramid``, the default: scan-to-map
polishes with the grid candidate-sweep kernel, frame-to-frame adds the NN
kernel's coarse levels). Everything runs on ``--device`` (default
``cuda``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import (ICPParams, OdometryConfig, OdometryPipeline,
                              get_engine)
from repro_torch.data.pointcloud import (SceneConfig, gt_pose,
                                         sample_consecutive_pairs,
                                         sequence_scans)
from repro_torch.launch.registration import ENGINE_ALIASES


def run_frame_to_frame(args, params, scans, gt):
    pairs = sample_consecutive_pairs(scans, args.samples)
    engine = get_engine(ENGINE_ALIASES.get(args.engine, args.engine),
                        device=args.device)
    t0 = time.time()
    res, _ = engine.register_pairs(pairs, params)
    T_all = res.T.cpu().numpy().astype(np.float64)   # waits for the card
    elapsed = time.time() - t0

    pose = np.eye(4)          # accumulated odometry (frame-0 frame)
    drift = []
    iterations = res.iterations.cpu().numpy()
    rmse = res.rmse.cpu().numpy()
    for frame in range(args.frames):
        # T maps frame f coords into frame f+1: accumulate inverse to get
        # the pose of frame f+1 in frame-0 coordinates.
        pose = pose @ np.linalg.inv(T_all[frame])
        err = np.linalg.norm(pose[:3, 3] - gt(frame + 1)[:3, 3])
        drift.append(err)
        print(f"frame {frame + 1:3d}: iters {int(iterations[frame]):2d}, "
              f"rmse {float(rmse[frame]):.4f}, "
              f"cumulative drift {err:.3f} m")
    iters = float(np.mean(iterations))
    print(f"\nframe_to_frame: {args.frames} registrations in one batched "
          f"call: {elapsed:.2f}s ({elapsed / args.frames * 1e3:.1f} ms/frame "
          f"incl. first-call setup, engine={args.engine}); mean iters "
          f"{iters:.2f}; final drift {drift[-1]:.3f} m")
    return np.asarray(drift)


def run_scan_to_map(args, params, scans, gt):
    # engine_kwargs stays at the OdometryConfig default: polish-only
    # pyramid schedule, dropped automatically for other engines.
    pipe = OdometryPipeline(OdometryConfig(
        engine=ENGINE_ALIASES.get(args.engine, args.engine), params=params,
        motion_model=not args.no_warm_start), device=args.device)
    t0 = time.time()
    poses, diags = pipe.run(scans)   # host poses: the card is done
    elapsed = time.time() - t0
    drift = []
    for frame in range(1, args.frames + 1):
        err = np.linalg.norm(poses[frame][:3, 3] - gt(frame)[:3, 3])
        drift.append(err)
        d = diags[frame]
        flag = "" if d.accepted else "  REJECTED(motion-model pose)"
        print(f"frame {frame:3d}: iters {d.iterations:2d}, "
              f"inliers {d.inlier_frac:.2f}, map occ {d.map_occupancy:.2f}, "
              f"cumulative drift {err:.3f} m{flag}")
    print(f"\nscan_to_map: {args.frames} frames in {elapsed:.2f}s "
          f"({elapsed / args.frames * 1e3:.1f} ms/frame incl. first-call "
          f"setup, engine={args.engine}, warm_start="
          f"{not args.no_warm_start}); mean iters "
          f"{pipe.mean_iterations():.2f}; rejected {pipe.rejected_frames()}; "
          f"final drift {drift[-1]:.3f} m")
    return np.asarray(drift)


def main(argv=None) -> np.ndarray:
    """Run the stream; returns the cumulative drift (m) of frames 1..F."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=2)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--samples", type=int, default=2048,
                    help="source sample count (frame_to_frame mode)")
    ap.add_argument("--iters", type=int, default=30,
                    help="per-frame iteration cap (both modes)")
    ap.add_argument("--mode", default="scan_to_map",
                    choices=["scan_to_map", "frame_to_frame"])
    ap.add_argument("--engine", default="pyramid",
                    choices=["xla", "pallas", "distributed", "pyramid",
                             "torch", "cuda"])
    ap.add_argument("--minimizer", default="point_to_point",
                    choices=["point_to_point", "point_to_plane"])
    ap.add_argument("--robust", default="huber",
                    choices=["none", "huber", "tukey"],
                    help="IRLS reweighting; huber (default) bounds the "
                         "map-frontier pull that biases streaming odometry "
                         "(DESIGN.md §10)")
    ap.add_argument("--robust-scale", type=float, default=0.3,
                    help="robust kernel scale in metres")
    ap.add_argument("--no-warm-start", action="store_true",
                    help="disable the constant-velocity motion model "
                         "(scan_to_map mode)")
    ap.add_argument("--static-world", action="store_true",
                    help="legacy protocol: identical world points every "
                         "frame (flatters frame_to_frame)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = SceneConfig(n_ground=9000, n_walls=6000, n_poles=1800,
                      n_clutter=1700, extent=40.0, sensor_range=45.0)
    params = ICPParams(max_iterations=args.iters,
                       max_correspondence_distance=1.0,
                       transformation_epsilon=1e-5,
                       minimizer=args.minimizer, robust_kernel=args.robust,
                       robust_scale=args.robust_scale)
    scans = sequence_scans(args.seq, args.frames + 1, cfg,
                           resample=not args.static_world)
    gt = gt_pose(args.seq)

    if args.mode == "frame_to_frame":
        drift = run_frame_to_frame(args, params, scans, gt)
        # resampled streams random-walk the pairwise chain — the gap this
        # example exists to demonstrate; only gross divergence fails.
        assert drift[-1] < 3.0, "odometry diverged"
    else:
        drift = run_scan_to_map(args, params, scans, gt)
        # --no-warm-start is an ablation: it exists to SHOW the stream
        # degrading without the motion model, so it skips the hard bound.
        if not args.no_warm_start:
            assert drift[-1] < 0.5, "odometry diverged"
    print("OK")
    return drift


if __name__ == "__main__":
    main()
