"""The benchmark's scene generator and traffic, on the CPU."""
import numpy as np
import pytest
import torch
from perfbench import harness
from perfbench.traffic import generate, scenes

HDL64 = scenes.scene_from_config(harness.config("kitti-hdl64-pairs")["scene"])
FLEET = scenes.scene_from_config(
    harness.config("kitti-fleet-service")["scene"])
SMALL = scenes.Scene(3000, 2800, 600, 600, 30.0, 28.0, 0.02, 4000)


def test_another_seed_draws_other_samples_of_the_same_worlds():
    mix = {"segment_frames": 2, "pool_drives": 3}
    a = generate.drives(mix, SMALL, 1, "cpu")
    b = generate.drives(mix, SMALL, 2, "cpu")
    assert sorted(d.world for d in a) == sorted(d.world for d in b)
    assert sorted(d.profile for d in a) == sorted(d.profile for d in b)
    first = {d.world: d.scans[0] for d in a}
    assert not any(np.array_equal(first[d.world], d.scans[0]) for d in b)


def test_a_seed_gives_the_same_scans_twice_and_another_seed_others():
    mix = dict(harness.traffic("pairs-b128-prior"),
               pairs_per_profile=[2, 1, 0, 0, 0, 0, 0, 0, 0, 1])
    a = generate.pair_batches(mix, SMALL, 64, 2**31 + 12345, "cpu")
    b = generate.pair_batches(mix, SMALL, 64, 2**31 + 12345, "cpu")
    c = generate.pair_batches(mix, SMALL, 64, 7, "cpu")
    for x, y in zip(a, b):
        for (s1, d1), (s2, d2) in zip(x.pairs, y.pairs):
            assert np.array_equal(s1, s2) and np.array_equal(d1, d2)
        assert np.array_equal(x.init, y.init)
    assert not np.array_equal(a[0].pairs[0][1], c[0].pairs[0][1])
    assert len(a) == mix["pool_batches"] and len(a[0].pairs) == 4
    assert all(s.shape == (64, 3) for s, _ in a[0].pairs)


def test_warm_starts_are_the_truth_perturbed_by_the_prior():
    mix = dict(harness.traffic("pairs-b128-prior"),
               pairs_per_profile=[3] * 10)
    (b, _) = generate.pair_batches(mix, SMALL, 16, 5, "cpu")
    err = np.linalg.inv(b.truth) @ b.init.astype(np.float64)
    assert 0.01 < np.abs(err[:, :2, 3]).mean() < 0.5
    assert np.abs(err[:, :3, 3]).max() < 2.0


def test_hdl64_targets_stay_in_their_bucket():
    """No scan exceeds the sensor's 131,072 returns, and the largest of a
    batch's profiles fill the 131,072-row bucket (every batch collates to
    one shape)."""
    sizes = []
    for profile in range(10):
        lay = scenes.make_layout(profile, HDL64, "cpu")
        sizes += [s.shape[0] for s in scenes.scans(lay, HDL64, profile,
                                                   [-7, 0, 6], 99, "cpu")]
    assert max(sizes) <= 131_072 and max(sizes) > 98_304
    assert min(sizes) > 65_536


def test_fleet_scans_fit_the_service_staging():
    """The fleet's scans are HDL-64E scans, staged whole."""
    cap = harness.config("kitti-fleet-service")["service"]["scan_capacity"]
    for profile in range(10):
        lay = scenes.make_layout(100 + profile, FLEET, "cpu")
        sc = scenes.scans(lay, FLEET, profile, [-16, 0, 15], 3, "cpu")
        assert all(65_536 < s.shape[0] <= cap for s in sc)


@pytest.mark.parametrize("profile", range(10))
def test_a_segments_ego_path_stays_inside_the_world(profile):
    seg = harness.traffic("replay-32f-churn")["segment_frames"]
    frames = range(-seg // 2, -seg // 2 + seg)
    for f in frames:
        _, t = scenes.ego_pose(profile, f)
        assert abs(t[0]) < FLEET.extent and abs(t[1]) < FLEET.extent
    # the pairs' frames, centred the same way, stay inside too
    k = max(harness.traffic("pairs-b128-prior")["pairs_per_profile"])
    for f in range(-(k + 1) // 2, -(k + 1) // 2 + k + 1):
        _, t = scenes.ego_pose(profile, f)
        assert abs(t[0]) < HDL64.extent


def test_relative_pose_moves_frame_a_onto_frame_b():
    Ra, ta = scenes.ego_pose(3, 4)
    Rb, tb = scenes.ego_pose(3, 5)
    p = np.array([3.0, -2.0, 1.0])
    world = Ra @ p + ta
    T = scenes.relative_pose(3, 4, 5)
    assert np.allclose(T[:3, :3] @ p + T[:3, 3], Rb.T @ (world - tb))


def test_fleet_plan_staggers_and_turns_slots_over():
    mix = {"segment_frames": 8, "pool_drives": 5}
    plan = generate.FleetPlan(mix, 4)
    assert [v.first for v in plan.live] == [0, 2, 4, 6]
    retired = []
    for _ in range(8):
        items = plan.round()
        assert all(0 <= f < 8 for _, f in items)
        retired.append(len(plan.retire_finished()))
    assert retired == [0, 1, 0, 1, 0, 1, 0, 1]
    # the pool's drives in turn, for every seed (the plan takes none)
    assert [v.drive for v in plan.vehicles] == [0, 1, 2, 3, 4, 0, 1, 2]


def test_scans_are_sensor_frame_and_range_gated():
    lay = scenes.make_layout(1, SMALL, "cpu")
    (s,) = scenes.scans(lay, SMALL, 0, [0], 1, "cpu")
    r = torch.linalg.norm(s, dim=-1)
    assert float(r.max()) <= SMALL.sensor_range + 0.2
    assert s.shape[0] <= SMALL.max_points
