"""The one traffic generator: reads a mix (``perfbench/traffic/mixes``)
and a configuration's scene, and draws the cell's inputs from the run's
seed on the device, handing them over as host arrays, as a sensor driver
or a log reader would.

Two kinds of mix:

  * ``pair_batches``: batches of consecutive-frame scan pairs, a few
    consecutive frames from each of the ten motion profiles, each profile
    in a world of its own; the source is a uniform sample of frame f, the
    target the whole of frame f+1, and the warm start the true motion
    perturbed by the error of an odometry prior (:func:`pair_batches`);
  * ``vehicle_replay``: a pool of recorded drives, a fixed number of
    frames each, that vehicles replay through a service's slots; a vehicle
    retires at the end of its drive and the next one takes its slot, the
    first vehicles staggered so that slots turn over a few at a time
    (:func:`drives`, :class:`FleetPlan`).

Every seed gets the same work: the worlds come from a fixed catalog (a
world's layout and its motion profile are fixed by its place in the
catalog), and so do the batches' profiles and the vehicles' drives, slots
and turnover. The seed draws every frame's surface samples and noise, the
sources' samples and the warm starts' errors. So two seeds give the same
load up to sampling, and the seed moves the inputs and not the load.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from perfbench.traffic import scenes

class PairBatch(NamedTuple):
    pairs: list            # [(src (N, 3), dst (M_k, 3)) float32 host arrays]
    init: np.ndarray       # (B, 4, 4) float32 warm starts
    truth: np.ndarray      # (B, 4, 4) float64 true source -> target motion


def _rotation(rx: float, ry: float, rz: float) -> np.ndarray:
    def axis(a, i, j):
        R = np.eye(3)
        c, s = np.cos(a), np.sin(a)
        R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
        return R
    return axis(rz, 0, 1) @ axis(ry, 2, 0) @ axis(rx, 1, 2)


def prior_error(rng: np.random.Generator, prior: dict) -> np.ndarray:
    """A small rigid error (4, 4): normal translation (``sigma_xy_m``,
    ``sigma_z_m``) and rotation (``sigma_yaw_rad``, ``sigma_tilt_rad``)."""
    sx, sz = prior["sigma_xy_m"], prior["sigma_z_m"]
    syaw, stilt = prior["sigma_yaw_rad"], prior["sigma_tilt_rad"]
    E = np.eye(4)
    E[:3, :3] = _rotation(rng.normal(0, stilt), rng.normal(0, stilt),
                          rng.normal(0, syaw))
    E[:3, 3] = [rng.normal(0, sx), rng.normal(0, sx), rng.normal(0, sz)]
    return E


def pair_batches(mix: dict, scene: scenes.Scene, source_points: int,
                 seed: int, device) -> list[PairBatch]:
    """``mix["pool_batches"]`` batches of ``sum(mix["pairs_per_profile"])``
    pairs. Profile p contributes ``pairs_per_profile[p]`` consecutive
    pairs of one world, its frames centred on frame 0; each source is
    ``source_points`` points of its frame, drawn uniformly."""
    out = []
    n_src = int(source_points)
    for b in range(int(mix["pool_batches"])):
        pairs, init, truth = [], [], []
        rng = np.random.default_rng(scenes.mix(seed, "prior", b))
        g = scenes.generator(scenes.mix(seed, "pick", b), device)
        for p, k in enumerate(mix["pairs_per_profile"]):
            if k == 0:
                continue
            frames = list(range(-(k + 1) // 2, -(k + 1) // 2 + k + 1))
            lay = scenes.make_layout(scenes.mix("catalog", "pairs", b, p),
                                     scene, device)
            sc = scenes.scans(lay, scene, p, frames,
                              scenes.mix(seed, "frames", b, p), device)
            picks = [sc[i][torch.randperm(sc[i].shape[0], generator=g,
                                          device=device)[:n_src]]
                     for i in range(k)]
            dst = np.split(torch.cat(sc[1:]).cpu().numpy(),
                           np.cumsum([s.shape[0] for s in sc[1:]])[:-1])
            src = np.split(torch.cat(picks).cpu().numpy(), k)
            for i in range(k):
                T = scenes.relative_pose(p, frames[i], frames[i + 1])
                pairs.append((src[i], dst[i]))
                truth.append(T)
                init.append(prior_error(rng, mix["prior"]) @ T)
        out.append(PairBatch(pairs, np.stack(init).astype(np.float32),
                             np.stack(truth)))
    return out


class Drive(NamedTuple):
    profile: int
    world: int
    scans: list            # [(n_f, 3) float32 host arrays], one a frame


def drives(mix: dict, scene: scenes.Scene, seed: int, device) -> list[Drive]:
    """The pool of ``mix["pool_drives"]`` recorded drives of
    ``mix["segment_frames"]`` frames, centred on frame 0 of their
    profile's path: drive ``w`` is catalog world ``w`` and runs profile
    ``w % 10``, for every seed."""
    n = int(mix["segment_frames"])
    frames = list(range(-n // 2, -n // 2 + n))
    out = []
    for w in range(int(mix["pool_drives"])):
        world = scenes.mix("catalog", "drives", w)
        lay = scenes.make_layout(world, scene, device)
        sc = scenes.scans(lay, scene, w % 10, frames,
                          scenes.mix(seed, "frames", w), device)
        host = np.split(torch.cat(sc).cpu().numpy(),
                        np.cumsum([s.shape[0] for s in sc])[:-1])
        out.append(Drive(w % 10, world, host))
    return out


class Vehicle(NamedTuple):
    vid: int        # order of admission
    slot: int
    drive: int      # index into the pool
    first: int      # first frame of the drive it replays


class FleetPlan:
    """Which vehicle each slot serves, round by round. Slot ``i``'s first
    vehicle joins its drive at frame ``i * segment // slots``, so the first
    wave retires a few slots a round; every later vehicle replays a whole
    drive, the pool's drives in turn."""

    def __init__(self, mix: dict, slots: int):
        self.segment = int(mix["segment_frames"])
        self.pool = int(mix["pool_drives"])
        self.slots = slots
        self.vehicles: list[Vehicle] = []
        self.live: list[Vehicle] = []
        self.next_frame: list[int] = []
        for i in range(slots):
            self._admit(i, (i * self.segment) // slots)

    def _admit(self, slot: int, first: int) -> Vehicle:
        v = Vehicle(len(self.vehicles), slot, len(self.vehicles) % self.pool,
                    first)
        self.vehicles.append(v)
        if slot < len(self.live):
            self.live[slot] = v
            self.next_frame[slot] = first
        else:
            self.live.append(v)
            self.next_frame.append(first)
        return v

    def round(self) -> list[tuple[Vehicle, int]]:
        """This round's (vehicle, frame) for every slot, then advance."""
        out = [(v, self.next_frame[v.slot]) for v in self.live]
        for v, f in out:
            self.next_frame[v.slot] = f + 1
        return out

    def retire_finished(self) -> list[tuple[Vehicle, Vehicle]]:
        """Replace every vehicle at the end of its drive; returns (old,
        new) pairs."""
        out = []
        for slot, v in enumerate(list(self.live)):
            if self.next_frame[slot] >= self.segment:
                out.append((v, self._admit(slot, 0)))
        return out
