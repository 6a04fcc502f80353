"""The paper's CPU baseline: PCL-style k-d tree ICP, in numpy/scipy.

A copy of ``repro.core.baseline`` for the port (no JAX import), so that
``chip_smoke.py`` can hold the card's result against the k-d tree on the
same pair.

FPPS compares against a software-only PCL ICP on a Xeon (paper §IV-A). PCL's
``IterativeClosestPoint`` uses a k-d tree (FLANN) for correspondence
estimation and SVD for transform estimation. We reimplement that faithfully:
scipy.spatial.cKDTree (same complexity class and the de-facto CPU reference)
+ numpy Kabsch, with identical convergence semantics to ``core.icp``.

This gives the benchmark harness a genuine like-for-like baseline for the
Table III (accuracy parity) and Table IV (latency/speedup) reproductions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial import cKDTree


@dataclasses.dataclass
class BaselineResult:
    T: np.ndarray
    rmse: float
    iterations: int
    converged: bool
    inlier_frac: float


def _kabsch(src: np.ndarray, dst: np.ndarray, w: np.ndarray) -> np.ndarray:
    wsum = max(w.sum(), 1e-12)
    src_mean = (src * w[:, None]).sum(0) / wsum
    dst_mean = (dst * w[:, None]).sum(0) / wsum
    src_c = src - src_mean
    dst_c = dst - dst_mean
    H = (src_c * w[:, None]).T @ dst_c
    U, _, Vt = np.linalg.svd(H)
    D = np.eye(3)
    D[2, 2] = np.linalg.det(Vt.T @ U.T)
    R = Vt.T @ D @ U.T
    t = dst_mean - R @ src_mean
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def kdtree_icp(source: np.ndarray, target: np.ndarray,
               max_iterations: int = 50,
               max_correspondence_distance: float = 1.0,
               transformation_epsilon: float = 1e-5,
               initial_transform: np.ndarray | None = None) -> BaselineResult:
    """PCL-equivalent ICP: k-d tree NN + SVD, same stopping rules as core.icp."""
    source = np.asarray(source, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    tree = cKDTree(target)  # built once: the target frame is static
    T = np.eye(4) if initial_transform is None else np.asarray(
        initial_transform, dtype=np.float64)
    rmse = float("inf")
    inlier_frac = 0.0
    it = 0
    converged = False
    for it in range(1, max_iterations + 1):
        src_t = source @ T[:3, :3].T + T[:3, 3]
        dist, idx = tree.query(src_t, k=1)
        matched = target[idx]
        w = (dist <= max_correspondence_distance).astype(np.float64)
        T_delta = _kabsch(src_t, matched, w)
        T = T_delta @ T
        delta = (np.sum((T_delta[:3, :3] - np.eye(3)) ** 2)
                 + np.sum(T_delta[:3, 3] ** 2))
        src_new = src_t @ T_delta[:3, :3].T + T_delta[:3, 3]
        d2 = np.sum((src_new - matched) ** 2, axis=1)
        rmse = float(np.sqrt((d2 * w).sum() / max(w.sum(), 1e-12)))
        inlier_frac = float(w.mean())
        if delta <= transformation_epsilon:
            converged = True
            break
    return BaselineResult(T=T, rmse=rmse, iterations=it,
                          converged=converged, inlier_frac=inlier_frac)
