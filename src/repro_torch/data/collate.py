"""Shape-bucket collation for batched registration (DESIGN.md §3).

A verbatim copy of ``repro.data.collate`` (numpy only): the port keeps its
own so that it never imports the JAX package. The constants below must stay
equal to the reference's; ``tests/test_torch_engine_api.py`` checks them.

Real LiDAR frames have variable point counts (range gating drops a
different subset every scan), but one compiled executable needs fixed
shapes. The collator pads every cloud up to a *bucket* size from a small
geometric ladder, so an entire sequence lands in one (B, N_b, 3)/(B, M_b, 3)
batch and the jit cache sees a handful of shapes instead of one per frame.

Padding uses a finite far-away sentinel (±1e6 m): padded *target* rows can
never win a nearest-neighbour argmin against real scene points, and padded
*source* rows always fail the correspondence-distance gate — so even an
engine that ignores the masks stays correct. The masks are still produced
and threaded (``dst_valid`` into the exact searcher, ``src_valid`` into the
Kabsch weights) so results are bit-comparable to the unpadded run.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

# Far outside any metric scene, but finite: inf coordinates would turn the
# matmul distance expansion into inf - inf = NaN (see core.nn_search).
PAD_SENTINEL = 1.0e6

# Geometric ~1.5x ladder (all multiples of 128, so every bucket is
# tile-aligned for the Pallas kernel); worst-case padding waste ~33%.
# Sizes above the top round up to the top's multiple.
DEFAULT_BUCKETS: tuple[int, ...] = (256, 384, 512, 768, 1024, 1536, 2048,
                                    3072, 4096, 6144, 8192, 12288, 16384,
                                    24576, 32768, 49152, 65536, 98304, 131072)


def bucket_size(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n (multiples of the largest bucket beyond the top)."""
    if n <= 0:
        raise ValueError(f"cloud must be non-empty, got n={n}")
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return ((n + top - 1) // top) * top


def pad_cloud(points: np.ndarray, size: int):
    """Pad (n,3) -> ((size,3) float32, (size,) bool valid mask)."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    if n > size:
        raise ValueError(f"cloud of {n} points does not fit bucket {size}")
    out = np.full((size, 3), PAD_SENTINEL, dtype=np.float32)
    out[:n] = points
    valid = np.zeros((size,), dtype=bool)
    valid[:n] = True
    return out, valid


class CollatedBatch(NamedTuple):
    """A padded frame-pair batch ready for ``icp_batch`` / ``register_batch``."""
    src: np.ndarray        # (B, N_b, 3) float32
    dst: np.ndarray        # (B, M_b, 3) float32
    src_valid: np.ndarray  # (B, N_b) bool
    dst_valid: np.ndarray  # (B, M_b) bool
    src_sizes: tuple[int, ...]  # true per-frame point counts
    dst_sizes: tuple[int, ...]


def collate_pairs(pairs: Sequence[tuple[np.ndarray, np.ndarray]],
                  buckets: Sequence[int] = DEFAULT_BUCKETS) -> CollatedBatch:
    """Collate [(src, dst), ...] into one fixed-shape batch.

    All sources share one bucket (the smallest fitting the largest source)
    and likewise all targets, so the whole sequence is served by a single
    compiled executable.
    """
    if not pairs:
        raise ValueError("collate_pairs needs at least one frame pair")
    src_sizes = tuple(int(np.asarray(s).shape[0]) for s, _ in pairs)
    dst_sizes = tuple(int(np.asarray(d).shape[0]) for _, d in pairs)
    n_b = bucket_size(max(src_sizes), buckets)
    m_b = bucket_size(max(dst_sizes), buckets)
    srcs, dsts, svs, dvs = [], [], [], []
    for s, d in pairs:
        sp, sv = pad_cloud(s, n_b)
        dp, dv = pad_cloud(d, m_b)
        srcs.append(sp)
        dsts.append(dp)
        svs.append(sv)
        dvs.append(dv)
    return CollatedBatch(src=np.stack(srcs), dst=np.stack(dsts),
                         src_valid=np.stack(svs), dst_valid=np.stack(dvs),
                         src_sizes=src_sizes, dst_sizes=dst_sizes)
