"""Synthetic KITTI-like LiDAR scene generator.

A copy of ``repro.data.pointcloud`` (numpy only, same code), kept in the port
so that the port and ``chip_smoke.py`` build byte-identical scenes without
importing the JAX package. ``tests/test_torch_engine_api.py`` pins the two
copies to the same bytes.

KITTI itself is not redistributable inside the repository, so the
benchmark harness synthesises structurally similar scenes: a ground plane,
building facades, poles and scattered clutter, scanned with range-limited
sensor noise from a moving ego pose. Ten seeded "sequences" with different
motion profiles stand in for KITTI odometry 00-09 (DESIGN.md §7). All the
paper's *relative* claims (accuracy parity vs k-d tree baseline, speedup,
convergence behaviour) are evaluated on these.

Frame generation is pure numpy (host data path, like a real loader);
samplers return float32 (N,3) arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Motion profiles per synthetic sequence: (speed m/frame, yaw-rate rad/frame).
# Loosely shaped on KITTI odometry: 01 is highway (fast), 03 suburban turns, etc.
_SEQ_PROFILES = {
    0: (0.8, 0.010), 1: (2.5, 0.002), 2: (1.0, 0.008), 3: (0.7, 0.020),
    4: (1.8, 0.001), 5: (0.9, 0.012), 6: (1.5, 0.006), 7: (0.6, 0.015),
    8: (1.1, 0.009), 9: (1.6, 0.005),
}


@dataclasses.dataclass
class SceneConfig:
    n_ground: int = 60_000
    n_walls: int = 45_000
    n_poles: int = 12_000
    n_clutter: int = 13_000     # total ≈ 130k, the paper's per-frame NN candidate count
    extent: float = 60.0        # half-width of the scene, metres
    sensor_range: float = 55.0
    noise_std: float = 0.02     # LiDAR range noise, metres


def _rot_z(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def make_world(seed: int, cfg: SceneConfig = SceneConfig(),
               point_seed: int | None = None) -> np.ndarray:
    """Build a world point set (float64 internally for pose math).

    ``point_seed=None`` (default) reproduces the original static world
    byte-for-byte: one rng stream draws both the scene *layout* (building
    placement, pole positions, heights) and the *surface sample points*.

    With ``point_seed`` set, surface points draw from a separate stream
    while the layout stays pinned by ``seed`` — the same scene, freshly
    sampled. Real LiDAR never hits the same surface points twice; a
    static world therefore hands frame-to-frame ICP an unrealistic
    point-identity correspondence. Odometry streams should draw one
    ``point_seed`` per frame (:func:`sequence_scans`) so consecutive
    frames share *surfaces*, not samples.
    """
    rng = np.random.default_rng(1000 + seed)
    # prng draws surface samples; aliasing it to rng keeps the legacy
    # single-stream draw order exactly (baseline scenes are pinned by it).
    prng = (rng if point_seed is None
            else np.random.default_rng(2_000_000_000 + point_seed))
    e = cfg.extent
    # Ground plane with gentle undulation (z is a function of x, y, so
    # resampled grounds lie on the same surface).
    g_xy = prng.uniform(-2 * e, 2 * e, size=(cfg.n_ground, 2))
    g_z = 0.05 * np.sin(0.08 * g_xy[:, 0]) * np.cos(0.05 * g_xy[:, 1])
    ground = np.column_stack([g_xy, g_z])
    # Building facades: vertical planes along the corridor.
    walls = []
    n_buildings = 14
    per = cfg.n_walls // n_buildings
    for _ in range(n_buildings):
        cx = rng.uniform(-2 * e, 2 * e)
        cy = rng.uniform(-e, e) + np.sign(rng.standard_normal()) * rng.uniform(8, 20)
        w, h = rng.uniform(8, 25), rng.uniform(4, 12)
        axis = rng.integers(0, 2)
        u = prng.uniform(-w / 2, w / 2, per)
        z = prng.uniform(0, h, per)
        if axis == 0:
            pts = np.column_stack([cx + u, np.full(per, cy), z])
        else:
            pts = np.column_stack([np.full(per, cx), cy + u, z])
        walls.append(pts)
    walls = np.concatenate(walls, axis=0)
    # Poles (trees / signs): thin vertical cylinders.
    n_poles_obj = 60
    per_pole = cfg.n_poles // n_poles_obj
    px = rng.uniform(-2 * e, 2 * e, n_poles_obj)
    py = rng.uniform(-e, e, n_poles_obj)
    poles = []
    for i in range(n_poles_obj):
        theta = prng.uniform(0, 2 * np.pi, per_pole)
        r = rng.uniform(0.05, 0.25)
        z = prng.uniform(0, rng.uniform(2, 6), per_pole)
        poles.append(np.column_stack([px[i] + r * np.cos(theta),
                                      py[i] + r * np.sin(theta), z]))
    poles = np.concatenate(poles, axis=0)
    clutter = np.column_stack([
        prng.uniform(-2 * e, 2 * e, cfg.n_clutter),
        prng.uniform(-e, e, cfg.n_clutter),
        np.abs(prng.normal(0.5, 0.5, cfg.n_clutter)),
    ])
    return np.concatenate([ground, walls, poles, clutter], axis=0)


def ego_pose(seq: int, frame: int) -> tuple[np.ndarray, np.ndarray]:
    """Ground-truth pose (R, t) of the ego vehicle at ``frame``."""
    speed, yaw_rate = _SEQ_PROFILES[seq % 10]
    yaw = yaw_rate * frame
    # Integrate an arc (constant curvature per profile).
    if abs(yaw_rate) < 1e-9:
        x, y = speed * frame, 0.0
    else:
        radius = speed / yaw_rate
        x = radius * np.sin(yaw)
        y = radius * (1.0 - np.cos(yaw))
    return _rot_z(yaw), np.array([x, y, 0.0])


def gt_pose(seq: int):
    """Frame-0-anchored ground-truth pose lookup for a sequence.

    Returns ``gt(frame) -> (4, 4)``: the pose of ``frame``'s sensor in
    frame-0 coordinates — the trajectory every odometry run measures
    drift against. The frame-0 anchor is computed once; it is
    loop-invariant across a whole trajectory evaluation.
    """
    R0, t0 = ego_pose(seq, 0)

    def gt(frame: int) -> np.ndarray:
        R1, t1 = ego_pose(seq, frame)
        T = np.eye(4)
        T[:3, :3] = R0.T @ R1
        T[:3, 3] = R0.T @ (t1 - t0)
        return T

    return gt


def sample_consecutive_pairs(scans, samples: int, seed: int = 0):
    """(sampled_source, full_target) pairs of consecutive stream frames.

    The frame-to-frame protocol's pair construction (§IV-A source
    sampling), shared by the odometry example and the drift benchmark so
    they measure the same thing by construction.
    """
    rng = np.random.default_rng(seed)
    pairs = []
    for f in range(len(scans) - 1):
        sel = rng.choice(scans[f].shape[0],
                         min(samples, scans[f].shape[0]), replace=False)
        pairs.append((scans[f][sel], scans[f + 1]))
    return pairs


def scan_frame(world: np.ndarray, seq: int, frame: int,
               cfg: SceneConfig = SceneConfig(), seed: int = 0) -> np.ndarray:
    """Scan the world from the ego pose at ``frame``: sensor-frame points.

    Range-gated, with additive noise — what a registration stack sees.
    """
    rng = np.random.default_rng(seed * 100_003 + seq * 1009 + frame)
    R, t = ego_pose(seq, frame)
    local = (world - t) @ R            # world -> sensor frame (R is orthogonal)
    r = np.linalg.norm(local, axis=1)
    keep = r <= cfg.sensor_range
    pts = local[keep]
    pts = pts + rng.normal(0.0, cfg.noise_std, pts.shape)
    return pts.astype(np.float32)


def sequence_scans(seq: int, frames: int, cfg: SceneConfig = SceneConfig(),
                   resample: bool = True, seed: int = 0) -> list[np.ndarray]:
    """Sensor-frame scan stream for frames ``0..frames-1`` of a sequence.

    ``resample=True`` (the odometry protocol) redraws surface sample
    points per frame from the pinned scene layout — consecutive frames
    then share surfaces but not samples, like a real spinning LiDAR.
    ``resample=False`` scans one static world (the legacy protocol —
    identical points across frames give pairwise ICP an exact
    point-identity correspondence no real sensor provides).
    """
    if not resample:
        world = make_world(seq, cfg)
        return [scan_frame(world, seq, f, cfg, seed) for f in range(frames)]
    out = []
    for f in range(frames):
        world = make_world(seq, cfg, point_seed=seed * 65_537 + f)
        out.append(scan_frame(world, seq, f, cfg, seed))
    return out


def frame_pair(seq: int, frame: int, cfg: SceneConfig = SceneConfig(),
               n_source_samples: int = 4096, seed: int = 0):
    """(source_sampled, target_full, T_gt): consecutive-frame registration task.

    Matches the paper's protocol (§IV-A): 4096 points randomly sampled from
    the source frame; the full target cloud is the NN search space. T_gt maps
    frame ``frame``'s sensor coordinates onto frame ``frame+1``'s.

    Builds the world per call; sequence loops should build it once and
    use :func:`frame_pair_from_world`.
    """
    world = make_world(seq, cfg)
    return frame_pair_from_world(world, seq, frame, cfg, n_source_samples,
                                 seed)


def frame_pair_from_world(world: np.ndarray, seq: int, frame: int,
                          cfg: SceneConfig = SceneConfig(),
                          n_source_samples: int = 4096, seed: int = 0):
    """:func:`frame_pair` against a prebuilt world — identical outputs,
    amortises the world build over a whole sequence (odometry loops)."""
    src = scan_frame(world, seq, frame, cfg, seed)
    dst = scan_frame(world, seq, frame + 1, cfg, seed)
    rng = np.random.default_rng(seed * 7 + seq * 31 + frame)
    sel = rng.choice(src.shape[0], size=min(n_source_samples, src.shape[0]),
                     replace=False)
    src_s = src[sel]
    R0, t0 = ego_pose(seq, frame)
    R1, t1 = ego_pose(seq, frame + 1)
    # x_sensor1 = R1ᵀ(x_world - t1); x_world = R0 x_sensor0 + t0
    R_gt = R1.T @ R0
    t_gt = R1.T @ (t0 - t1)
    T_gt = np.eye(4)
    T_gt[:3, :3] = R_gt
    T_gt[:3, 3] = t_gt
    return src_s.astype(np.float32), dst.astype(np.float32), T_gt.astype(np.float32)
