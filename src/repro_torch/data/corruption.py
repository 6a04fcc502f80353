"""Deterministic sensor-fault injectors for point-cloud streams (DESIGN.md §12).

A verbatim copy of ``repro.data.corruption`` (numpy only): the port keeps its
own so that it never imports the JAX package. Fault masks and points must
stay bit-identical to the reference's; ``tests/test_torch_corruption.py``
checks every injector.

FPPS targets embedded autonomous platforms where LiDAR input is routinely
degraded — occlusion by close traffic, random dropout from low-reflectance
surfaces, heavy-tailed range noise in rain, ghost returns off dynamic
objects, duplicated points from firmware glitches, whole NaN/Inf rows from
driver faults, and dropped frames on a saturated bus. This module is the
*fault model* those scenarios compile down to: a small algebra of pure,
seeded injectors over ``(points, valid)`` clouds.

Conventions (shared with ``repro_torch.data.collate``):

  * Every injector is a **pure function** of its inputs and an integer
    ``seed`` — same seed, same cloud in, byte-identical cloud out. No
    global RNG state is read or written, so injectors compose and the
    whole fault matrix is reproducible from one base seed.
  * Injectors take and return ``(points (N,3) float32, valid (N,) bool)``.
    Rows an injector *removes* (occlusion, dropout, crop, frame drop) are
    masked invalid and moved to the far ``PAD_SENTINEL``, so downstream
    consumers that ignore masks stay correct — identical to collate pads.
  * Rows an injector *adds* (ghosts, duplicates) are appended, flagged
    valid: the sensor reports them as real returns, and it is the
    pipeline's job to survive them.
  * ``inject_nonfinite`` is the deliberate exception: corrupted rows keep
    ``valid=True`` while carrying NaN/Inf coordinates — a faulty driver
    does not mark its garbage, so neither does the injector. The engine
    boundary's scrub (``repro_torch.core.icp.scrub_nonfinite``) is what must
    catch these.

Fault specs: the compact string form the drivers and benchmarks share,
``"dropout:0.3,occlusion:90deg,nan:10"`` — see :func:`parse_fault_spec`
and :func:`apply_faults`. Per-frame seeds derive deterministically from
``(seed, frame, injector name)``, so a stream replays exactly.
"""
from __future__ import annotations

import zlib
from typing import Callable, NamedTuple, Sequence

import numpy as np

from repro_torch.data.collate import PAD_SENTINEL


def _as_cloud(points, valid):
    pts = np.asarray(points, dtype=np.float32)
    if valid is None:
        valid = np.ones((pts.shape[0],), dtype=bool)
    else:
        valid = np.asarray(valid, dtype=bool).copy()
    return pts.copy(), valid


def _mask_rows(pts: np.ndarray, valid: np.ndarray,
               drop: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Invalidate ``drop`` rows and park them at the collate sentinel."""
    valid = valid & ~drop
    pts[~valid] = PAD_SENTINEL
    return pts, valid


# -- removal faults ----------------------------------------------------------

def sector_occlusion(points, valid=None, *, seed: int = 0,
                     width_deg: float = 90.0,
                     center_deg: float | None = None):
    """Occlude an azimuth sector (a truck beside the ego, a tunnel wall).

    ``width_deg`` of azimuth centred at ``center_deg`` (drawn from ``seed``
    when None) vanishes from the scan. Sensor-frame clouds put the ego at
    the origin, so azimuth is ``atan2(y, x)``.
    """
    pts, valid = _as_cloud(points, valid)
    rng = np.random.default_rng(seed)
    center = (rng.uniform(-180.0, 180.0) if center_deg is None
              else float(center_deg))
    az = np.degrees(np.arctan2(pts[:, 1], pts[:, 0]))
    # Wrapped angular distance to the sector centre.
    dist = np.abs((az - center + 180.0) % 360.0 - 180.0)
    return _mask_rows(pts, valid, valid & (dist <= width_deg / 2.0))


def random_dropout(points, valid=None, *, seed: int = 0, frac: float = 0.3):
    """Drop a random ``frac`` of the valid returns (low-reflectance loss)."""
    pts, valid = _as_cloud(points, valid)
    rng = np.random.default_rng(seed)
    drop = valid & (rng.random(pts.shape[0]) < float(frac))
    return _mask_rows(pts, valid, drop)


def low_overlap_crop(points, valid=None, *, seed: int = 0,
                     keep_frac: float = 0.4):
    """Keep only a contiguous azimuth window covering ``keep_frac`` of the
    sweep — the low-overlap regime where correspondence-starved ICP slides
    (the failure mode the correspondence-free FPGA lines target)."""
    pts, valid = _as_cloud(points, valid)
    rng = np.random.default_rng(seed)
    center = rng.uniform(-180.0, 180.0)
    half = 180.0 * float(keep_frac)
    az = np.degrees(np.arctan2(pts[:, 1], pts[:, 0]))
    dist = np.abs((az - center + 180.0) % 360.0 - 180.0)
    return _mask_rows(pts, valid, valid & (dist > half))


def frame_drop(points, valid=None, *, seed: int = 0):
    """Lose the whole frame (bus saturation): every row masked invalid.

    The shape survives so stream collation is undisturbed; registration
    against an all-invalid source is the degenerate case the zero-inlier
    freeze already handles — the recovery cascade's tier-4 coast is what
    turns it into a survivable event.
    """
    pts, valid = _as_cloud(points, valid)
    return _mask_rows(pts, valid, valid.copy())


# -- perturbation faults -----------------------------------------------------

def range_noise(points, valid=None, *, seed: int = 0, std: float = 0.05,
                heavy_tail: bool = False, df: float = 2.0):
    """Range (radial) noise: each return slides along its own ray.

    ``heavy_tail=True`` draws Student-t(``df``) steps instead of Gaussian —
    the rain/spray regime where a fat tail of multi-metre outliers rides a
    small-sigma core. Invalid rows are untouched (they are sentinels).
    """
    pts, valid = _as_cloud(points, valid)
    rng = np.random.default_rng(seed)
    n = pts.shape[0]
    step = (rng.standard_t(float(df), n) if heavy_tail
            else rng.standard_normal(n)) * float(std)
    r = np.linalg.norm(pts, axis=1)
    ray = pts / np.maximum(r, 1e-6)[:, None]
    pts = np.where(valid[:, None], pts + ray * step[:, None], pts)
    return pts.astype(np.float32), valid


# -- additive faults ---------------------------------------------------------

def ghost_points(points, valid=None, *, seed: int = 0, count: int = 256,
                 radius: float = 8.0, offset: float = 6.0):
    """Append a ghost cluster (dynamic object / multipath blob).

    ``count`` points in a ``radius``-sized cluster ``offset`` metres from
    the ego, flagged valid — the sensor believes them. Clustered (not
    uniform) on purpose: a coherent blob biases registration the way a
    passing vehicle does, where uniform noise would mostly be gated out.
    """
    pts, valid = _as_cloud(points, valid)
    rng = np.random.default_rng(seed)
    az = rng.uniform(-np.pi, np.pi)
    center = np.array([offset * np.cos(az), offset * np.sin(az),
                       rng.uniform(0.0, 2.0)], dtype=np.float32)
    blob = center + rng.normal(0.0, radius / 4.0,
                               (int(count), 3)).astype(np.float32)
    return (np.concatenate([pts, blob.astype(np.float32)], axis=0),
            np.concatenate([valid, np.ones(int(count), bool)]))


def duplicate_points(points, valid=None, *, seed: int = 0, count: int = 256):
    """Append exact duplicates of random valid rows (firmware echo)."""
    pts, valid = _as_cloud(points, valid)
    rng = np.random.default_rng(seed)
    idx = np.flatnonzero(valid)
    if idx.size == 0:
        return pts, valid
    sel = rng.choice(idx, size=int(count), replace=True)
    return (np.concatenate([pts, pts[sel]], axis=0),
            np.concatenate([valid, np.ones(int(count), bool)]))


def inject_nonfinite(points, valid=None, *, seed: int = 0, count: int = 8,
                     inf_frac: float = 0.25):
    """Corrupt ``count`` valid rows to NaN (or ±Inf for ``inf_frac`` of
    them) — **leaving them flagged valid**, like the driver fault they
    model. This is the poison the engine-boundary scrub must neutralise."""
    pts, valid = _as_cloud(points, valid)
    rng = np.random.default_rng(seed)
    idx = np.flatnonzero(valid)
    if idx.size == 0:
        return pts, valid
    sel = rng.choice(idx, size=min(int(count), idx.size), replace=False)
    is_inf = rng.random(sel.size) < float(inf_frac)
    pts[sel] = np.nan
    pts[sel[is_inf]] = np.inf
    pts[sel[is_inf], 1] = -np.inf
    return pts, valid


# -- fault specs -------------------------------------------------------------

class FaultSpec(NamedTuple):
    """One parsed injector invocation: ``fn(points, valid, seed=...)``."""
    name: str
    fn: Callable
    kwargs: dict


def _parse_value(raw: str) -> float:
    return float(raw.rstrip("degm"))


# spec key -> (injector, value -> kwargs). Values are single scalars in the
# compact string form; call injectors directly for the full kwarg surface.
_SPEC_TABLE: dict[str, tuple[Callable, Callable[[float], dict]]] = {
    "occlusion": (sector_occlusion, lambda v: {"width_deg": v}),
    "dropout": (random_dropout, lambda v: {"frac": v}),
    "crop": (low_overlap_crop, lambda v: {"keep_frac": v}),
    "noise": (range_noise, lambda v: {"std": v}),
    "tnoise": (range_noise, lambda v: {"std": v, "heavy_tail": True}),
    "ghost": (ghost_points, lambda v: {"count": int(v)}),
    "dup": (duplicate_points, lambda v: {"count": int(v)}),
    "nan": (inject_nonfinite, lambda v: {"count": int(v)}),
    "drop": (frame_drop, lambda v: {}),
}

FAULT_NAMES = tuple(sorted(_SPEC_TABLE))


def parse_fault_spec(spec: str | Sequence[FaultSpec]) -> tuple[FaultSpec, ...]:
    """Parse ``"dropout:0.3,occlusion:90deg,nan:10"`` into injector calls.

    Each comma-separated entry is ``name[:value]``; the value's meaning is
    per-injector (fraction, degrees, count, metres — units suffixes
    ``deg``/``m`` are accepted and ignored). Already-parsed specs pass
    through, so callers can hand either form around.
    """
    if not isinstance(spec, str):
        return tuple(spec)
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, raw = entry.partition(":")
        name = name.strip()
        if name not in _SPEC_TABLE:
            raise ValueError(f"unknown fault {name!r}; "
                             f"expected one of {FAULT_NAMES}")
        fn, to_kwargs = _SPEC_TABLE[name]
        kwargs = to_kwargs(_parse_value(raw.strip())) if raw.strip() else {}
        out.append(FaultSpec(name=name, fn=fn, kwargs=kwargs))
    return tuple(out)


def fault_seed(seed: int, frame: int, name: str) -> int:
    """Deterministic per-(stream, frame, injector) seed — crc32 keeps it
    stable across processes/platforms (unlike ``hash``)."""
    key = f"{seed}/{frame}/{name}".encode()
    return int(zlib.crc32(key))


def apply_faults(points, spec: str | Sequence[FaultSpec], *, seed: int = 0,
                 frame: int = 0, valid=None):
    """Run every injector of ``spec`` over the cloud, in spec order.

    Seeds derive from ``(seed, frame, injector name)``, so one base seed
    replays an entire faulted stream deterministically and two injectors in
    one frame never share a random stream.
    """
    pts, valid = _as_cloud(points, valid)
    for fault in parse_fault_spec(spec):
        pts, valid = fault.fn(pts, valid,
                              seed=fault_seed(seed, frame, fault.name),
                              **fault.kwargs)
    return pts, valid
