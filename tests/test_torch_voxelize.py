"""Port vs reference: voxel grid tables and voxel downsample.

Seeded numpy clouds go through ``repro.data.voxelize`` (JAX, CPU) and
``repro_torch.data.voxelize`` (PyTorch, CPU). The grid tables (``points``,
``point_ids``, ``start``, ``count``, ``origin``) must be identical; the
downsampled centroids agree within 1e-6 relative (the port sums in float64,
the reference in float32) with the identical row order, ``out_valid`` and
``dropped`` count. A batched build equals its per-lane builds exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.data import voxelize as jv
from repro.data.collate import collate_pairs
from repro_torch.data import voxelize as tv

GRID_FIELDS = ("points", "point_ids", "start", "count", "origin")


def _cloud(seed, n=500, scale=8.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-scale, scale, (n, 3)).astype(np.float32)


def _kw(valid, origin, to):
    out = {}
    if valid is not None:
        out["valid"] = to(valid)
    if origin is not None:
        out["origin"] = to(origin)
    return out


CASES = {
    # name: (valid mask or None, origin or None, dims)
    "plain": (None, None, (16, 16, 16)),
    "valid": ("mask", None, (16, 16, 16)),
    # a 4^3 lattice of 2 m cells at the origin: most points clip into it
    "clipped": (None, np.zeros(3, np.float32), (4, 4, 4)),
    "clipped_valid": ("mask", np.full(3, -3.0, np.float32), (5, 3, 4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_grid_tables_identical(case):
    mask, origin, dims = CASES[case]
    pts = _cloud(1)
    valid = (np.random.default_rng(2).uniform(size=len(pts)) > 0.25
             if mask else None)
    gj = jv.build_voxel_grid(jnp.asarray(pts), 2.0, dims,
                             **_kw(valid, origin, jnp.asarray))
    gt = tv.build_voxel_grid(torch.from_numpy(pts), 2.0, dims,
                             **_kw(valid, origin, torch.from_numpy))
    assert gt.dims == gj.dims and gt.num_cells == gj.num_cells
    for f in GRID_FIELDS:
        a, b = np.asarray(getattr(gj, f)), getattr(gt, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert float(gt.voxel_size) == float(gj.voxel_size)


def test_cell_coords_preclamp_sentinels():
    """Far sentinels stay ordinary out-of-range ints with clip=False."""
    pts = np.array([[1e6, -1e6, 0.5], [1e15, 3.0, -1e15], [0.0, 0.0, 0.0]],
                   np.float32)
    origin = np.array([-1.0, -2.0, -3.0], np.float32)
    a = jv.cell_coords(jnp.asarray(pts), jnp.asarray(origin), 1.0,
                       (8, 8, 8), clip=False)
    b = tv.cell_coords(torch.from_numpy(pts), torch.from_numpy(origin),
                       torch.tensor(1.0), (8, 8, 8), clip=False)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert b.dtype == torch.int32 and int(b.abs().max()) == 2 ** 30


@pytest.mark.parametrize("case,voxel,cap", [
    ("plain", 2.0, 400),
    ("valid", 2.0, 384),
    ("truncated", 0.5, 64),      # more occupied cells than capacity
    ("origin_negative", 1.5, 300),  # negative cell coords, explicit origin
])
def test_downsample_matches_reference(case, voxel, cap):
    pts = _cloud(3, n=512, scale=20.0 if case == "truncated" else 8.0)
    valid = origin = None
    if case == "valid":  # 300 points padded to the 384 bucket
        batch = collate_pairs([(pts[:300], pts)])
        pts, valid = batch.src[0], batch.src_valid[0]
    if case == "origin_negative":
        origin = np.array([2.0, -1.0, 0.5], np.float32)
    cj, vj, dj = jv.voxel_downsample(jnp.asarray(pts), voxel, max_points=cap,
                                     with_stats=True,
                                     **_kw(valid, origin, jnp.asarray))
    ct, vt, dt = tv.voxel_downsample(torch.from_numpy(pts), voxel,
                                     max_points=cap, with_stats=True,
                                     **_kw(valid, origin, torch.from_numpy))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert int(dt) == int(dj) and dt.dtype == torch.int32
    if case == "truncated":
        assert int(dt) > 0 and bool(vt.all())
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6,
                               atol=1e-6)
    assert ct.shape == (cap, 3)


def test_downsample_capacity_above_cloud_pads():
    pts = _cloud(4, n=100)
    cj, vj = jv.voxel_downsample(jnp.asarray(pts), 2.0, max_points=160)
    ct, vt = tv.voxel_downsample(torch.from_numpy(pts), 2.0, max_points=160)
    assert ct.shape == (160, 3)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6,
                               atol=1e-6)
    assert np.all(ct.numpy()[~vt.numpy()] == 1e6)


def _batch():
    pairs = [(_cloud(10 + k, n=n), _cloud(20 + k, n=m))
             for k, (n, m) in enumerate([(180, 600), (220, 700), (150, 380)])]
    return collate_pairs(pairs)


def test_batched_grid_equals_per_lane_builds():
    b = _batch()
    dst, dv = torch.from_numpy(b.dst), torch.from_numpy(b.dst_valid)
    g = tv.build_voxel_grid(dst, 2.0, (16, 16, 16), valid=dv)
    assert g.start.shape == (3, 16 ** 3) and g.points.shape == dst.shape
    for k in range(3):
        one = tv.build_voxel_grid(dst[k], 2.0, (16, 16, 16), valid=dv[k])
        for f in GRID_FIELDS:
            assert torch.equal(getattr(g, f)[k], getattr(one, f)), (k, f)


def test_batched_downsample_equals_per_lane():
    b = _batch()
    dst, dv = torch.from_numpy(b.dst), torch.from_numpy(b.dst_valid)
    c, v, d = tv.voxel_downsample(dst, 2.0, max_points=256, valid=dv,
                                  with_stats=True)
    assert c.shape == (3, 256, 3) and d.shape == (3,)
    for k in range(3):
        c1, v1, d1 = tv.voxel_downsample(dst[k], 2.0, max_points=256,
                                         valid=dv[k], with_stats=True)
        assert torch.equal(c[k], c1) and torch.equal(v[k], v1)
        assert int(d[k]) == int(d1)
