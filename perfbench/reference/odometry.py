"""Scan-to-map odometry, plain: the benchmark's frozen reference for the
registration service's streams.

Written from the configuration's semantics in plain PyTorch and NumPy, and
nothing of the program's:

  * the voxel downsample: the centroid of every occupied voxel of a lattice
    anchored half a voxel below the scan's minimum, the voxels in the order
    of their (x, y, z) cell, the first ``cap`` of them kept;
  * the submap fuse: the map's points and the new scan in world coordinates
    together, those farther than the eviction radius from the ego dropped,
    and those outside a lattice of ``dims`` voxels centred on the ego (its
    corner snapped to the voxel grid), then downsampled on that lattice to
    the map's capacity;
  * the constant-velocity motion model: the prediction ``P_k @ v`` with
    ``v = P_{k-1}^-1 P_k`` after an accepted frame, decayed toward the
    identity after a rejected one;
  * the registration: :func:`perfbench.reference.icp.icp` with the Huber
    weight, from the prediction; a frame is accepted when the result is not
    degenerate and its inlier fraction reaches the configured minimum.

It follows a stream step by step from the poses the program emitted: the
map a frame is registered against is the reference's own fuse of the
reference's own downsampled scans, placed at the program's earlier poses,
and the prediction is the motion model of those poses. So each frame's
pose is judged as the answer to the registration that the earlier poses
pose, and frame 1 of every stream, whose map is frame 0 alone, is judged
from the scans alone.

Every function works on several independent streams (lanes) at once.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from perfbench.reference import icp as ref_icp

_FIELD = 14                      # bits a cell coordinate takes in a key
_LANE_SHIFT = 3 * _FIELD


class Odometry(NamedTuple):
    """The configuration's per-stream settings."""
    scan_voxel: float
    scan_budget: int
    map_voxel: float
    map_capacity: int
    map_dims: tuple
    evict_radius: float
    max_iterations: int
    gate: float
    epsilon: float
    huber: float
    min_inlier_frac: float
    velocity_decay: float


def downsample(lanes: list, voxel: float, cap: int,
               origins: torch.Tensor | None = None) -> list:
    """Voxel centroids of every lane's points (a list of (n, 3) float32
    tensors on one device), in cell order, at most ``cap`` a lane.
    ``origins`` (L, 3) anchors each lane's lattice; by default half a voxel
    below the lane's minimum, snapped to the grid."""
    dev = lanes[0].device
    v = torch.tensor(voxel, dtype=torch.float32, device=dev)
    sizes = torch.tensor([p.shape[0] for p in lanes], device=dev)
    lane = torch.repeat_interleave(torch.arange(len(lanes), device=dev), sizes)
    pts = torch.cat(lanes)
    if origins is None:
        lo = torch.stack([p.amin(0) if p.shape[0] else
                          torch.zeros(3, device=dev) for p in lanes])
        origins = torch.floor((lo - 0.5 * v) / v) * v
    cell = torch.floor((pts - origins[lane]) / v).long()
    if cell.numel() and (cell.min() < 0 or cell.max() >= 1 << _FIELD):
        raise ValueError("a cell coordinate leaves the key's range")
    key = ((lane << _LANE_SHIFT) | (cell[:, 0] << 2 * _FIELD)
           | (cell[:, 1] << _FIELD) | cell[:, 2])
    uniq, inverse, counts = torch.unique(key, sorted=True,
                                         return_inverse=True,
                                         return_counts=True)
    sums = torch.zeros((uniq.shape[0], 3), dtype=torch.float64, device=dev)
    sums.index_add_(0, inverse, pts.double())
    centroids = sums.float() / counts[:, None].float()
    ulane = uniq >> _LANE_SHIFT
    per_lane = torch.bincount(ulane, minlength=len(lanes))
    first = torch.cumsum(per_lane, 0) - per_lane
    rank = torch.arange(uniq.shape[0], device=dev) - first[ulane]
    keep = rank < cap
    kept = torch.bincount(ulane[keep], minlength=len(lanes)).tolist()
    return list(centroids[keep].split(kept))


def fuse(maps: list, scans: list, centers: torch.Tensor,
         odo: Odometry) -> list:
    """Each lane's map (k, 3) with its world-frame scan (n, 3) fused
    around its ego position ``centers`` (L, 3)."""
    dev = centers.device
    v = torch.tensor(odo.map_voxel, dtype=torch.float32, device=dev)
    dims = torch.tensor(odo.map_dims, dtype=torch.float32, device=dev)
    origins = torch.floor((centers - 0.5 * dims * v) / v) * v
    kept = []
    for i, (m, s) in enumerate(zip(maps, scans)):
        pts = torch.cat([m, s])
        d = pts - centers[i]
        near = (d * d).sum(-1) <= odo.evict_radius ** 2
        cell = torch.floor((pts - origins[i]) / v)
        inside = ((cell >= 0) & (cell < dims)).all(-1)
        kept.append(pts[near & inside])
    return downsample(kept, odo.map_voxel, odo.map_capacity, origins)


def decay(T: np.ndarray, factor: float) -> np.ndarray:
    """A rigid motion shrunk toward the identity: the translation and the
    rotation angle (about the same axis) scaled by ``factor``."""
    R = T[:3, :3]
    angle = float(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))
    out = np.eye(4)
    if angle > 1e-8:
        axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]])
        axis /= max(np.linalg.norm(axis), 1e-12)
        K = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                      [-axis[1], axis[0], 0.0]])
        a = angle * factor
        out[:3, :3] = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)
    out[:3, 3] = factor * T[:3, 3]
    return out


class Stream:
    """One stream's reference state: its map, the program's poses so far,
    and the motion model."""

    def __init__(self, device):
        self.map = torch.zeros((0, 3), device=device)
        self.poses: list = []
        self.velocity = np.eye(4)

    def predict(self) -> np.ndarray:
        if len(self.poses) < 2:
            return self.poses[-1]
        return self.poses[-1] @ self.velocity


def _pad(lanes: list, width: int):
    dev = lanes[0].device
    out = torch.zeros((len(lanes), width, 3), device=dev)
    valid = torch.zeros((len(lanes), width), dtype=torch.bool, device=dev)
    for i, p in enumerate(lanes):
        out[i, :p.shape[0]] = p
        valid[i, :p.shape[0]] = True
    return out, valid


class Frame(NamedTuple):
    """What the reference made of one frame."""
    n_scan: int          # voxels of the downsampled scan
    n_map: int           # map points the frame registered against
    expected: np.ndarray | None   # the pose it should have (checked frames)
    control: np.ndarray | None    # the same in TF32 (the control)
    restep: tuple = (0.0, 0.0)  # from the program's and the control's pose
    ok: tuple = (True, True)    # accepted by the reference, by the control
    converged: bool = False     # the reference's registration converged
    inlier_frac: float = 0.0    # the reference's inlier fraction


def step(streams: dict, items: list, odo: Odometry, device, *,
         check: set = frozenset(), control: bool = False) -> dict:
    """One round of several streams. ``items`` holds ``(sid, scan,
    pose, accepted)`` a stream: its host scan (n, 3), and the pose and
    acceptance the program emitted for it. Streams in ``check`` are
    registered by the reference from the prediction (and, with
    ``control``, again in TF32); the others only keep their maps. Returns
    ``{sid: Frame}``."""
    scans = [torch.as_tensor(np.asarray(s, np.float32), device=device)
             for _, s, _, _ in items]
    ds = downsample(scans, odo.scan_voxel, odo.scan_budget)
    out = {}
    todo = [i for i, (sid, *_) in enumerate(items)
            if sid in check and sid in streams]
    expected = {}
    if todo:
        src, sv = _pad([ds[i] for i in todo], odo.scan_budget)
        maps = [streams[items[i][0]].map for i in todo]
        dst, dv = _pad(maps, max(1, max(m.shape[0] for m in maps)))
        T0 = torch.as_tensor(np.stack([streams[items[i][0]].predict()
                                       for i in todo]), device=device)
        runs = [False, True] if control else [False]
        for tf32 in runs:
            r = ref_icp.icp(src, dst, sv, dv,
                            max_iterations=odo.max_iterations, gate=odo.gate,
                            epsilon=odo.epsilon, huber=odo.huber, T0=T0,
                            allow_tf32=tf32)
            ok = ((~r.degenerate) & (r.inlier_frac >= odo.min_inlier_frac)
                  ).tolist()
            Ts = r.T.cpu().numpy()
            if not tf32:
                judged = dict(zip(todo, zip(r.converged.tolist(),
                                            r.inlier_frac.tolist())))
            for j, i in enumerate(todo):
                pose = Ts[j] if ok[j] else T0[j].cpu().numpy()
                expected.setdefault(i, []).append((pose, ok[j]))
        cands = [np.stack([np.asarray(items[i][2], np.float64)
                           for i in todo])]
        if control:
            cands.append(np.stack([expected[i][1][0] for i in todo]))
        steps = [ref_icp.restep(src, dst, sv, dv,
                                torch.as_tensor(P, device=device), odo.gate,
                                odo.huber).tolist() for P in cands]
        steps += [[0.0] * len(todo)] * (2 - len(steps))
    fuse_lanes, fuse_scans, centers = [], [], []
    for i, (sid, _, pose, accepted) in enumerate(items):
        pose = np.asarray(pose, np.float64)
        st = streams.get(sid)
        if st is None:        # the stream's first frame bootstraps its map
            st = streams[sid] = Stream(device)
            out[sid] = Frame(ds[i].shape[0], 0, np.eye(4),
                             np.eye(4) if control else None)
            fused, pose = True, np.eye(4)
        else:
            got = expected.get(i)
            c = (tuple(steps[k][todo.index(i)] for k in range(2)) if got
                 else (0.0, 0.0))
            out[sid] = Frame(ds[i].shape[0], st.map.shape[0],
                             got[0][0] if got else None,
                             got[1][0] if got and control else None, c)
            if got:
                out[sid] = out[sid]._replace(
                    ok=(got[0][1], got[-1][1]), converged=judged[i][0],
                    inlier_frac=judged[i][1])
            fused = got[0][1] if got else bool(accepted)
            if fused:
                st.velocity = np.linalg.inv(st.poses[-1]) @ pose
            else:
                st.velocity = decay(st.velocity, odo.velocity_decay)
        st.poses.append(pose)
        if fused:
            P = torch.as_tensor(pose, dtype=torch.float32, device=device)
            fuse_lanes.append(sid)
            fuse_scans.append(ds[i] @ P[:3, :3].T + P[:3, 3])
            centers.append(P[:3, 3])
    if fuse_lanes:
        new = fuse([streams[s].map for s in fuse_lanes], fuse_scans,
                   torch.stack(centers), odo)
        for sid, m in zip(fuse_lanes, new):
            streams[sid].map = m
    return out
