"""Port vs reference: the rolling voxel submap, fp32 and fp16 storage.

Three inserts of one seeded cloud moved by three poses go through
``repro.data.submap.Submap`` (JAX, CPU) and ``repro_torch.data.submap``
(PyTorch, CPU), with points beyond ``evict_radius`` and outside the
lattice, at a roomy and at a saturating capacity. Held to:

  * valid masks, origins (bitwise) and ``dropped_cells`` equal;
  * fp32 points within 1e-6 m (the port sums centroids in float64, the
    reference in float32);
  * fp16 stored offsets within one fp16 ulp, +inf rows equal;
  * ``state_bytes`` equal; a batch of 2 the same bits as two single fuses;
    ``submap_state_from_reference`` round-trips the reference's state.
"""
import numpy as np
import pytest
import torch

from repro.data import submap as js
from repro_torch.data import submap as ts

POINT_TOL = 1e-6


def _params(storage, capacity):
    return dict(voxel_size=0.75, capacity=capacity, dims=(32, 32, 16),
                evict_radius=10.0, storage=storage)


def _pose(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.3, 0.3)
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    T[:3, 3] = rng.uniform(-2.0, 2.0, 3)
    return T


def _scans(n=2400):
    rng = np.random.default_rng(42)
    # +-14 m in x/y: beyond the 10 m evict radius. Most points lie in a
    # 3 m slab (several per cell, revisited by every insert); one in ten
    # reaches +-9 m in z, outside the 12 m-high lattice.
    base = rng.uniform([-14, -14, -1.5], [14, 14, 1.5], (n, 3))
    tall = rng.random(n) < 0.1
    base[tall, 2] = rng.uniform(-9, 9, tall.sum())
    base = base.astype(np.float32)
    out = []
    for k in range(3):
        T = _pose(k)
        pts = (base @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        valid = rng.random(n) < 0.95
        out.append((pts, valid, T[:3, 3].copy()))
    return out


def _run_both(storage, capacity):
    jp = js.SubmapParams(**_params(storage, capacity))
    tp = ts.SubmapParams(**_params(storage, capacity))
    jm, tm = js.Submap(jp), ts.Submap(tp, device="cpu")
    for pts, valid, center in _scans():
        jm.insert(pts, center, valid=valid)
        tm.insert(pts, center, valid=valid)
    return jm, tm


@pytest.fixture(scope="module", params=[("fp32", 4096), ("fp32", 256),
                                        ("fp16", 4096), ("fp16", 256)],
                ids=lambda p: f"{p[0]}-cap{p[1]}")
def maps(request):
    return request.param, _run_both(*request.param)


def test_cells_origin_and_counters_equal(maps):
    (storage, capacity), (jm, tm) = maps
    assert np.array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    assert np.array_equal(tm.origin.numpy(), np.asarray(jm.origin))
    assert tm.dropped_cells == jm.dropped_cells
    assert tm.size == jm.size and tm.occupancy() == jm.occupancy()
    assert tm.frames_inserted == jm.frames_inserted == 3
    if capacity == 256:
        assert tm.dropped_cells > 0 and tm.size == capacity
    else:
        assert tm.dropped_cells == 0


def test_points_within_tolerance(maps):
    (storage, _), (jm, tm) = maps
    valid = np.asarray(jm.valid)
    pt, pj = tm.points.numpy(), np.asarray(jm.points)
    assert np.array_equal(pt[~valid], pj[~valid])  # sentinel rows
    if storage == "fp32":
        assert np.abs(pt[valid] - pj[valid]).max() <= POINT_TOL
    else:
        st, sj = tm.state[0].numpy(), np.asarray(jm.state[0])
        assert np.array_equal(np.isinf(st), np.isinf(sj))
        ulp = np.spacing(np.abs(sj[valid]).astype(np.float16))
        assert np.all(np.abs(st[valid].astype(np.float32)
                             - sj[valid].astype(np.float32))
                      <= ulp.astype(np.float32))


def test_grid_view_matches_reference(maps):
    _, (jm, tm) = maps
    gt, gj = tm.grid(), jm.grid()
    assert np.array_equal(gt.count.numpy(), np.asarray(gj.count))
    assert np.array_equal(gt.start.numpy(), np.asarray(gj.start))
    assert np.array_equal(gt.origin.numpy(), np.asarray(gj.origin))


def test_state_round_trips_from_reference(maps):
    (storage, capacity), (jm, _) = maps
    tp = ts.SubmapParams(**_params(storage, capacity))
    leaves = tuple(np.asarray(x) for x in jm.state)
    state = ts.submap_state_from_reference(leaves, tp, "cpu")
    for a, b in zip(state, leaves):
        assert a.numpy().dtype == b.dtype
        assert np.array_equal(a.numpy(), b)
    pts, valid, origin = ts.state_views(state, tp)
    assert np.array_equal(pts.numpy(), np.asarray(jm.points))
    assert np.array_equal(valid.numpy(), np.asarray(jm.valid))
    with pytest.raises(ValueError):
        ts.submap_state_from_reference(leaves[:-1], tp, "cpu")


@pytest.mark.parametrize("storage", ["fp32", "fp16"])
@pytest.mark.parametrize("capacity", [256, 4096])
def test_batch_of_two_equals_two_single_fuses(storage, capacity):
    tp = ts.SubmapParams(**_params(storage, capacity))
    scans = _scans()
    state = ts.empty_state(tp, "cpu", batch=(2,))
    singles = [ts.empty_state(tp, "cpu") for _ in range(2)]
    for k in range(2):  # lanes see different scans in different orders
        pts = torch.stack([torch.from_numpy(scans[k][0]),
                           torch.from_numpy(scans[2 - k][0])])
        valid = torch.stack([torch.from_numpy(scans[k][1]),
                             torch.from_numpy(scans[2 - k][1])])
        center = torch.stack([torch.from_numpy(scans[k][2]),
                              torch.from_numpy(scans[2 - k][2])])
        state, occ, dropped = ts.fuse_state(state, pts, valid, center, tp)
        for lane in range(2):
            singles[lane], o1, d1 = ts.fuse_state(
                singles[lane], pts[lane], valid[lane], center[lane], tp)
            assert int(o1) == int(occ[lane])
            assert int(d1) == int(dropped[lane])
    for lane in range(2):
        for a, b in zip(state, singles[lane]):
            assert torch.equal(a[lane], b)


@pytest.mark.parametrize("storage", ["fp32", "fp16"])
def test_state_bytes_and_params(storage):
    for capacity in (256, 24576):
        jp = js.SubmapParams(**_params(storage, capacity))
        tp = ts.submap_params_from_reference(jp._asdict())
        assert tuple(tp) == tuple(jp)
        assert ts.state_bytes(tp) == js.state_bytes(jp)
    assert ts.STORAGE_MODES == js.STORAGE_MODES
    with pytest.raises(ValueError):
        ts.Submap(ts.SubmapParams(storage="bf16"), device="cpu")
    with pytest.raises(ValueError):
        ts.submap_params_from_reference(dict(jp._asdict(), bogus=1))
