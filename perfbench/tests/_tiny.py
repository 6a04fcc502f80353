"""Tiny sizes of both cells, for runs of the harness on the CPU."""
import copy

from perfbench import harness

TINY_SCENE = {"n_ground": 3000, "n_walls": 2800, "n_poles": 600,
              "n_clutter": 600, "extent": 30.0, "sensor_range": 28.0,
              "noise_std": 0.02, "max_points": 4000}


def pairs():
    cfg = copy.deepcopy(harness.config("kitti-hdl64-pairs"))
    cfg["scene"] = dict(TINY_SCENE)
    cfg["source_points"] = 256
    cfg["check"]["sample_pairs"] = 64
    mix = dict(harness.traffic("pairs-b128-prior"),
               pairs_per_profile=[1, 1, 1, 0, 0, 0, 0, 0, 0, 1])
    return cfg, mix


def fleet():
    cfg = copy.deepcopy(harness.config("kitti-fleet-service"))
    cfg["scene"] = dict(TINY_SCENE, max_points=4096)
    cfg["service"] = dict(cfg["service"], slots=4, scan_capacity=4096)
    odo = cfg["odometry"]
    cfg["odometry"] = dict(odo, scan_budget=1024,
                           submap=dict(odo["submap"], capacity=2048))
    cfg["check"]["sample_vehicles"] = 64
    mix = dict(harness.traffic("replay-32f-churn"), segment_frames=5,
               pool_drives=6, warmup_rounds=1)
    return cfg, mix
