"""The frozen reference against hand-made answers, on the CPU."""
import numpy as np
import pytest
import torch
from perfbench.reference import icp as ref_icp
from perfbench.reference import odometry as ref_odo
from perfbench.traffic import scenes


def _rigid(yaw, t):
    T = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = t
    return T


def test_icp_recovers_a_hand_made_transform():
    g = torch.Generator().manual_seed(0)
    dst = torch.rand((2, 4000, 3), generator=g) * torch.tensor([20, 20, 3.])
    T = _rigid(0.04, [0.3, -0.2, 0.05])
    Ti = torch.tensor(np.linalg.inv(T), dtype=torch.float32)
    src = dst[:, :1500] @ Ti[:3, :3].T + Ti[:3, 3]
    sv = torch.ones(2, 1500, dtype=torch.bool)
    dv = torch.ones(2, 4000, dtype=torch.bool)
    dv[1, 3000:] = False        # masked rows never match
    r = ref_icp.icp(src, dst, sv, dv, max_iterations=50, gate=1.0,
                    epsilon=1e-12, huber=0.3)
    t_err, r_err = ref_icp.pose_errors(r.T.numpy(), np.stack([T, T]))
    assert t_err.max() < 1e-4 and r_err.max() < 1e-5
    assert not r.degenerate.any()


def test_icp_stops_at_epsilon_and_freezes_degenerate_lanes():
    src = torch.zeros((2, 10, 3))
    dst = torch.full((2, 10, 3), 100.0)     # nothing inside the gate
    sv = torch.ones(2, 10, dtype=torch.bool)
    r = ref_icp.icp(src, dst, sv, sv.clone(), max_iterations=50, gate=1.0,
                    epsilon=1e-5)
    assert r.degenerate.all() and (r.iterations == 1).all()
    assert np.allclose(r.T.numpy(), np.eye(4))


def test_tf32_switch_is_restored():
    before = torch.get_float32_matmul_precision()
    with ref_icp.tf32(True):
        assert torch.get_float32_matmul_precision() == "high"
    assert torch.get_float32_matmul_precision() == before


def test_pose_errors():
    A = _rigid(0.0, [0, 0, 0])[None]
    B = _rigid(1e-6, [0.003, 0.004, 0])[None]
    t, r = ref_icp.pose_errors(A, B)
    assert t[0] == pytest.approx(0.005) and r[0] == pytest.approx(1e-6)


def test_downsample_is_centroids_in_cell_order_capped():
    pts = torch.tensor([[0.1, 0.1, 0.1], [0.3, 0.2, 0.1], [1.6, 0.1, 0.1],
                        [0.1, 1.6, 0.1], [0.1, 0.1, 1.6]])
    (c,) = ref_odo.downsample([pts], 0.75, 10)
    # origin: floor((min - 0.375) / 0.75) * 0.75 = -0.75; cells by (x, y, z)
    want = [[0.2, 0.15, 0.1], [0.1, 0.1, 1.6], [0.1, 1.6, 0.1],
            [1.6, 0.1, 0.1]]
    assert torch.allclose(c, torch.tensor(want))
    (c2,) = ref_odo.downsample([pts], 0.75, 2)
    assert torch.equal(c2, c[:2])
    a, b = ref_odo.downsample([pts, pts[2:]], 0.75, 10)
    assert torch.equal(a, c) and b.shape == (3, 3)


def _odo(**kw):
    base = dict(scan_voxel=0.75, scan_budget=4096, map_voxel=0.75,
                map_capacity=4096, map_dims=(64, 64, 16), evict_radius=20.0,
                max_iterations=30, gate=1.0, epsilon=1e-5, huber=0.3,
                min_inlier_frac=0.2, velocity_decay=0.5)
    base.update(kw)
    return ref_odo.Odometry(**base)


def test_fuse_evicts_far_points_and_clips_to_the_lattice():
    odo = _odo(evict_radius=5.0, map_dims=(8, 8, 8))
    m = torch.tensor([[0.1, 0.1, 0.1], [4.0, 0.0, 0.0]])
    s = torch.tensor([[0.2, 0.1, 0.1], [9.0, 0.0, 0.0]])
    (out,) = ref_odo.fuse([m], [s], torch.zeros((1, 3)), odo)
    # 9 m is evicted; 4 m lies outside the 6 m lattice centred on the ego
    assert out.shape == (1, 3)
    assert torch.allclose(out[0], torch.tensor([0.15, 0.1, 0.1]))


def test_a_tiny_stream_follows_the_truth():
    scene = scenes.Scene(3000, 2800, 600, 600, 30.0, 28.0, 0.02, 0)
    lay = scenes.make_layout(4, scene, "cpu")
    frames = list(range(-2, 3))
    sc = [s.numpy() for s in scenes.scans(lay, scene, 0, frames, 4, "cpu")]
    gt = [np.linalg.inv(scenes.relative_pose(0, frames[0], f))
          for f in frames]         # frame f's sensor in frame 0's coords
    odo = _odo()
    streams = {}
    for i, s in enumerate(sc):
        made = ref_odo.step(streams, [("a", s, gt[i], True)], odo, "cpu",
                            check={"a"})["a"]
        t_err, _ = ref_icp.pose_errors(made.expected[None], gt[i][None])
        assert t_err[0] < 0.1, (i, t_err)   # a sparse 7k-point world
        assert (made.n_map > 0) == (i > 0)
    assert len(streams["a"].poses) == len(sc)


def test_motion_model_predicts_constant_velocity_and_decays():
    st = ref_odo.Stream("cpu")
    st.poses = [np.eye(4), _rigid(0.0, [1.0, 0, 0])]
    st.velocity = _rigid(0.0, [1.0, 0, 0])
    assert np.allclose(st.predict()[:3, 3], [2.0, 0, 0])
    assert np.allclose(ref_odo.decay(_rigid(0.2, [1.0, 0, 0]), 0.5),
                       _rigid(0.1, [0.5, 0, 0]))
