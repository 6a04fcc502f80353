"""Synthetic KITTI-like LiDAR scenes, drawn on the device from a seed.

The benchmark's own copy of the port's scene generator
(``repro_torch/data/pointcloud.py``: a ground plane with gentle undulation,
14 building facades, 60 poles and scattered clutter, scanned from a moving
ego pose with range gating and additive noise), rewritten in torch so that
a run draws thousands of scans on the card in its set-up instead of on the
host. The numbers differ from the numpy generator's for any seed; the
structure, the point counts, the ten motion profiles and the pose
conventions are the same.

A *layout* (where the buildings and poles stand) is fixed by a world seed.
Every frame resamples the surfaces from the layout with a seed of its own,
as a spinning sensor never hits the same surface points twice, so
consecutive frames share surfaces and not samples. Seeds are mixed with
:func:`mix` (SHA-256), so any integer seed, large or negative, gives a
fixed stream on every run.
"""
from __future__ import annotations

import hashlib
import math
from typing import NamedTuple

import numpy as np
import torch

# (speed m/frame, yaw rate rad/frame) of the ten synthetic sequences, shaped
# loosely on KITTI odometry 00-09 (01 the highway, 03 suburban turns).
SEQ_PROFILES = {
    0: (0.8, 0.010), 1: (2.5, 0.002), 2: (1.0, 0.008), 3: (0.7, 0.020),
    4: (1.8, 0.001), 5: (0.9, 0.012), 6: (1.5, 0.006), 7: (0.6, 0.015),
    8: (1.1, 0.009), 9: (1.6, 0.005),
}
N_BUILDINGS = 14
N_POLES = 60


class Scene(NamedTuple):
    """Point counts and geometry of a world (``SceneConfig``'s fields)."""
    n_ground: int = 60_000
    n_walls: int = 45_000
    n_poles: int = 12_000
    n_clutter: int = 13_000
    extent: float = 60.0          # half-width of the scene, metres
    sensor_range: float = 55.0
    noise_std: float = 0.02       # range noise, metres
    max_points: int = 0           # the sensor's most returns a scan (0: none)


def scene_from_config(d: dict) -> Scene:
    """A :class:`Scene` from a configuration's ``scene`` object."""
    unknown = sorted(set(d) - set(Scene._fields))
    if unknown:
        raise ValueError(f"unknown scene keys: {unknown}")
    return Scene(**d)


def mix(*keys) -> int:
    """A 63-bit seed from any tuple of integers and strings."""
    h = hashlib.sha256(repr(tuple(keys)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def ego_pose(seq: int, frame: int) -> tuple[np.ndarray, np.ndarray]:
    """Ground-truth pose (R, t) of the ego at ``frame`` (any integer: the
    arc of constant curvature runs both ways from frame 0)."""
    speed, yaw_rate = SEQ_PROFILES[seq % 10]
    yaw = yaw_rate * frame
    if abs(yaw_rate) < 1e-9:
        x, y = speed * frame, 0.0
    else:
        radius = speed / yaw_rate
        x, y = radius * math.sin(yaw), radius * (1.0 - math.cos(yaw))
    c, s = math.cos(yaw), math.sin(yaw)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return R, np.array([x, y, 0.0])


def relative_pose(seq: int, frame_a: int, frame_b: int) -> np.ndarray:
    """(4, 4) transform from frame ``a``'s sensor coordinates to frame
    ``b``'s."""
    Ra, ta = ego_pose(seq, frame_a)
    Rb, tb = ego_pose(seq, frame_b)
    T = np.eye(4)
    T[:3, :3] = Rb.T @ Ra
    T[:3, 3] = Rb.T @ (ta - tb)
    return T


class Layout(NamedTuple):
    """Where a world's buildings and poles stand (device tensors)."""
    buildings: torch.Tensor   # (14, 6): cx, cy, width, height, axis, _
    poles: torch.Tensor       # (60, 4): px, py, radius, height


def make_layout(world_seed: int, scene: Scene, device) -> Layout:
    """The layout of world ``world_seed``: two draws on the device."""
    g = generator(mix("layout", world_seed), device)
    e = scene.extent
    u = torch.rand((N_BUILDINGS, 6), generator=g, device=device)
    side = torch.where(u[:, 2] < 0.5, -1.0, 1.0)
    buildings = torch.stack([
        (4.0 * u[:, 0] - 2.0) * e,
        (2.0 * u[:, 1] - 1.0) * e + side * (8.0 + 12.0 * u[:, 3]),
        8.0 + 17.0 * u[:, 4],
        4.0 + 8.0 * u[:, 5],
        (torch.rand(N_BUILDINGS, generator=g, device=device) < 0.5).float(),
        torch.zeros(N_BUILDINGS, device=device)], -1)
    p = torch.rand((N_POLES, 4), generator=g, device=device)
    poles = torch.stack([(4.0 * p[:, 0] - 2.0) * e, (2.0 * p[:, 1] - 1.0) * e,
                         0.05 + 0.2 * p[:, 2], 2.0 + 4.0 * p[:, 3]], -1)
    return Layout(buildings, poles)


def sample_worlds(layout: Layout, scene: Scene, frames: int,
                  g: torch.Generator, device) -> torch.Tensor:
    """``frames`` fresh samplings of the world's surfaces, drawn together:
    (frames, P, 3) float32 world points, ground, then facades, poles and
    clutter."""
    e = scene.extent
    f32 = dict(device=device, dtype=torch.float32)
    lead = (frames,)
    gxy = (torch.rand(lead + (scene.n_ground, 2), generator=g, **f32) * 4.0
           - 2.0) * e
    gz = (0.05 * torch.sin(0.08 * gxy[..., 0])
          * torch.cos(0.05 * gxy[..., 1]))
    ground = torch.cat([gxy, gz[..., None]], -1)

    b = layout.buildings
    per = scene.n_walls // N_BUILDINGS
    uz = torch.rand(lead + (N_BUILDINGS, per, 2), generator=g, **f32)
    along = (uz[..., 0] - 0.5) * b[:, 2:3]
    z = uz[..., 1] * b[:, 3:4]
    on_x = b[:, 4:5] < 0.5                 # facade runs along x
    wx = torch.where(on_x, b[:, 0:1] + along, b[:, 0:1].expand_as(along))
    wy = torch.where(on_x, b[:, 1:2].expand_as(along), b[:, 1:2] + along)
    walls = torch.stack([wx, wy, z], -1).reshape(frames, -1, 3)

    q = layout.poles
    per_pole = scene.n_poles // N_POLES
    up = torch.rand(lead + (N_POLES, per_pole, 2), generator=g, **f32)
    theta = 2.0 * math.pi * up[..., 0]
    poles = torch.stack([q[:, 0:1] + q[:, 2:3] * torch.cos(theta),
                         q[:, 1:2] + q[:, 2:3] * torch.sin(theta),
                         up[..., 1] * q[:, 3:4]], -1).reshape(frames, -1, 3)

    uc = torch.rand(lead + (scene.n_clutter, 2), generator=g, **f32)
    cz = torch.randn(lead + (scene.n_clutter,), generator=g, **f32)
    clutter = torch.stack([(4.0 * uc[..., 0] - 2.0) * e,
                           (2.0 * uc[..., 1] - 1.0) * e,
                           (0.5 + 0.5 * cz).abs()], -1)
    return torch.cat([ground, walls, poles, clutter], 1)


def scans(layout: Layout, scene: Scene, seq: int, frames: list[int],
          seed: int, device) -> list[torch.Tensor]:
    """Sensor-frame scans of ``frames`` (a list of frame indices), each
    (n, 3) float32 on ``device``: the surfaces resampled for every frame,
    seen from the ego pose, gated at the sensor's range, with range noise;
    above ``scene.max_points`` returns, a uniform subset of them in scan
    order. One draw for all the frames, one host sync."""
    g = generator(mix("scans", seed), device)
    world = sample_worlds(layout, scene, len(frames), g, device)
    poses = [ego_pose(seq, f) for f in frames]
    R = torch.as_tensor(np.stack([p[0] for p in poses]), dtype=torch.float32,
                        device=device)
    t = torch.as_tensor(np.stack([p[1] for p in poses]), dtype=torch.float32,
                        device=device)
    local = torch.bmm(world - t[:, None], R)
    local = local + scene.noise_std * torch.randn(local.shape, generator=g,
                                                  device=device)
    keep = (local * local).sum(-1) <= scene.sensor_range ** 2
    if scene.max_points:
        # a uniform subset: the max_points smallest random keys of a frame
        key = torch.rand(keep.shape, generator=g, device=device)
        key = torch.where(keep, key, 2.0)
        rank = key.argsort(-1).argsort(-1)
        keep &= rank < scene.max_points
    counts = keep.sum(-1).tolist()
    return list(local[keep].split(counts))
