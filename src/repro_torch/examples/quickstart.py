"""Quickstart: register two LiDAR scans with the FPPS PCL-like API (port of
``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cuda|cpu]

On the card the brute-force NN search is the CUDA kernel
(``kernels/csrc/nn_search.cu``); ``--device cpu`` runs its plain version.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import FppsICP
from repro_torch.data.pointcloud import SceneConfig, frame_pair


def main(argv=None) -> np.ndarray:
    """Align seq 0 frame 3 of a reduced scene; returns the estimated T."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    # A reduced synthetic KITTI-like frame pair (fast on CPU).
    cfg = SceneConfig(n_ground=9000, n_walls=6000, n_poles=1800,
                      n_clutter=1700, extent=40.0, sensor_range=45.0)
    source, target, T_gt = frame_pair(seq=0, frame=3, cfg=cfg,
                                      n_source_samples=2048)

    # Exactly the paper's Table I API surface:
    icp = FppsICP(device=args.device)
    icp.hardwareInitialize()
    icp.setInputSource(source)
    icp.setInputTarget(target)
    icp.setMaxCorrespondenceDistance(1.0)
    icp.setMaxIterationCount(50)
    icp.setTransformationEpsilon(1e-5)
    T = icp.align()

    print("estimated transform:\n", np.round(T, 4))
    print("ground truth:\n", np.round(T_gt, 4))
    print(f"converged={icp.hasConverged()} fitness={icp.getFitnessScore():.4f}")
    err = np.linalg.norm(T[:3, 3] - T_gt[:3, 3])
    print(f"translation error: {err:.4f} m")
    assert err < 0.1, "registration failed"
    print("OK")
    return T


if __name__ == "__main__":
    main()
