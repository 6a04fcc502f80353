"""Port vs reference: grid-bucketed NN and the candidate-sweep wrapper.

Seeded numpy clouds go through ``repro.core.nn_search_grid`` (JAX, CPU; the
Pallas wrapper in interpret mode at <= 256 queries) and
``repro_torch.core.nn_search_grid`` / ``repro_torch.kernels.nn_search_grid``
(PyTorch, CPU: the kernel wrapper's plain version). ``gather_candidates``
and ``neighborhood_stats`` must be identical, grid-NN indices identical and
d² within 1e-6.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.data.voxelize import build_voxel_grid as j_build
from repro.kernels.nn_search_grid import nn_search_grid_pallas
from repro_torch.data.voxelize import build_voxel_grid as t_build
from repro_torch.kernels import nn_search_grid as tk

# The packages export a function of the module's name: take the modules.
jg = importlib.import_module("repro.core.nn_search_grid")
tg = importlib.import_module("repro_torch.core.nn_search_grid")

DIMS = (16, 16, 16)
VOXEL = 2.0


def _clouds(seed, n=200, m=2000, scale=10.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, (n, 3)).astype(np.float32),
            rng.uniform(-scale, scale, (m, 3)).astype(np.float32))


def _grids(dst, voxel=VOXEL, dims=DIMS, origin=None):
    kw_j = {} if origin is None else dict(origin=jnp.asarray(origin))
    kw_t = {} if origin is None else dict(origin=torch.from_numpy(origin))
    return (j_build(jnp.asarray(dst), voxel, dims, **kw_j),
            t_build(torch.from_numpy(dst), voxel, dims, **kw_t))


def _clump(seed=2):
    """500 points inside one 2 m cell of a 4^3 lattice (cells overflow)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (500, 3)).astype(np.float32)


# name: (src, dst, voxel, dims, origin, max_per_cell, rings)
def _case(name):
    if name == "dense":
        src, dst = _clouds(0)
        return src, dst, VOXEL, DIMS, None, 64, 1
    if name == "rings2":
        src, dst = _clouds(6, m=3000)
        return src, dst, VOXEL / 2, (32, 32, 32), None, 32, 2
    if name == "overflow":
        dst = _clump()
        src = np.random.default_rng(3).uniform(0.2, 0.8, (50, 3)).astype(
            np.float32)
        return src, dst, 2.0, (4, 4, 4), np.zeros(3, np.float32), 8, 1
    if name == "out_of_lattice":
        src, dst = _clouds(11, n=64, m=1200)
        src = src.copy()
        src[::2] += np.float32([200.0, 0.0, 0.0])  # past the 32 m lattice
        src[1] = [1e6, 1e6, 1e6]                    # a pad-sentinel query
        return src, dst, VOXEL, DIMS, None, 64, 1
    raise KeyError(name)


CASES = ("dense", "rings2", "overflow", "out_of_lattice")


@pytest.mark.parametrize("name", CASES)
def test_gather_candidates_identical(name):
    src, dst, voxel, dims, origin, k, rings = _case(name)
    gj, gt = _grids(dst, voxel, dims, origin)
    pj, ij, vj = jg.gather_candidates(jnp.asarray(src), gj, k, rings)
    pt, it, vt = tg.gather_candidates(torch.from_numpy(src), gt, k, rings)
    assert pt.shape == (len(src), (2 * rings + 1) ** 3 * k, 3)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("name", CASES)
def test_nn_search_grid_matches_reference(name):
    src, dst, voxel, dims, origin, k, rings = _case(name)
    gj, gt = _grids(dst, voxel, dims, origin)
    d2j, idxj, ptsj, sj = jg.nn_search_grid(
        jnp.asarray(src), gj, max_per_cell=k, rings=rings,
        return_points=True, with_stats=True)
    d2t, idxt, ptst, st = tg.nn_search_grid(
        torch.from_numpy(src), gt, max_per_cell=k, rings=rings,
        return_points=True, with_stats=True)
    np.testing.assert_array_equal(idxt.numpy(), np.asarray(idxj))
    np.testing.assert_allclose(d2t.numpy(), np.asarray(d2j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(ptst.numpy(), np.asarray(ptsj))
    for a, b in zip(st, sj):
        assert float(a) == float(b)
    if name == "out_of_lattice":
        assert bool(torch.isinf(d2t[::2]).all())
        assert float(st.out_of_lattice) > 0.5
    if name == "overflow":
        assert float(st.overflow_frac) == 1.0


@pytest.mark.parametrize("name", CASES)
def test_neighborhood_stats_identical(name):
    src, dst, voxel, dims, origin, k, rings = _case(name)
    gj, gt = _grids(dst, voxel, dims, origin)
    sj = jg.neighborhood_stats(jnp.asarray(src), gj, k, rings)
    st = tg.neighborhood_stats(torch.from_numpy(src), gt, k, rings)
    for f in tg.GridQueryStats._fields:
        assert float(getattr(st, f)) == float(getattr(sj, f)), f


def test_exact_fallback_matches_reference():
    rng = np.random.default_rng(1)
    dst = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    src = np.concatenate([dst[:4] + 0.01, np.full((2, 3), 25.0, np.float32)])
    origin = np.full(3, -2.0, np.float32)
    gj, gt = _grids(dst, 1.0, (32, 32, 32), origin)
    d2j, idxj = jg.nn_search_grid(jnp.asarray(src), gj, max_per_cell=16,
                                  exact_fallback=True, dst=jnp.asarray(dst),
                                  chunk=64)
    d2t, idxt = tg.nn_search_grid(torch.from_numpy(src), gt, max_per_cell=16,
                                  exact_fallback=True,
                                  dst=torch.from_numpy(dst), chunk=64)
    np.testing.assert_array_equal(idxt.numpy(), np.asarray(idxj))
    np.testing.assert_allclose(d2t.numpy(), np.asarray(d2j), rtol=1e-5,
                               atol=1e-5)
    assert bool(torch.isfinite(d2t).all())
    with pytest.raises(ValueError, match="dst"):
        tg.nn_search_grid(torch.from_numpy(src), gt, exact_fallback=True)


def test_batched_search_equals_per_lane():
    pairs = [_clouds(20 + k, n=n, m=m)
             for k, (n, m) in enumerate([(120, 900), (150, 1100)])]
    src = torch.from_numpy(np.stack([s[:120] for s, _ in pairs]))
    dst = torch.from_numpy(np.stack([d[:900] for _, d in pairs]))
    g = t_build(dst, VOXEL, DIMS)
    d2, idx, pts = tg.nn_search_grid(src, g, max_per_cell=64,
                                     return_points=True)
    for b in range(2):
        one = tg.nn_search_grid(src[b], t_build(dst[b], VOXEL, DIMS),
                                max_per_cell=64, return_points=True)
        for x, y in zip((d2[b], idx[b], pts[b]), one):
            assert torch.equal(x, y)


def test_kernel_wrapper_matches_pallas_interpret():
    """``nn_search_grid`` on CPU tensors (the kernel wrapper's plain sweep)
    against the reference's Pallas wrapper in interpret mode."""
    src, dst = _clouds(4, n=150, m=2000)
    gj, gt = _grids(dst)
    d2j, idxj = nn_search_grid_pallas(jnp.asarray(src), gj, max_per_cell=64,
                                      bn=64, bc=128, interpret=True)
    before = tk.candidate_sweep_kernel.launches
    d2t, idxt, pts = tg.nn_search_grid(torch.from_numpy(src), gt,
                                       max_per_cell=64, return_points=True)
    assert tk.candidate_sweep_kernel.launches == before  # plain: no launch
    np.testing.assert_array_equal(idxt.numpy(), np.asarray(idxj))
    np.testing.assert_allclose(d2t.numpy(), np.asarray(d2j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(pts.numpy(), dst[idxt.numpy()])
    nn_fn = tg.grid_nn_fn(gt, max_per_cell=64)
    for x, y in zip(nn_fn(torch.from_numpy(src)), (d2t, idxt, pts)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", CASES)
def test_winner_row_equals_gathered_index(name):
    """The searcher maps only the winning slot back to its target row
    (``start[c] + k``); that row is the one ``gather_candidates`` lists in
    the slot, and the points-only gather equals the full gather's."""
    src, dst, voxel, dims, origin, k, rings = _case(name)
    _, gt = _grids(dst, voxel, dims, origin)
    q = torch.from_numpy(src)
    pts, idx, valid = tg.gather_candidates(q, gt, k, rings)
    assert torch.equal(tg.gather_candidate_points(q, gt, k, rings), pts)
    _, slot = tk.candidate_sweep_kernel(q, pts)
    has = valid.any(-1)
    d2, best = tg.nn_search_grid(q, gt, max_per_cell=k, rings=rings)
    assert torch.equal(best, torch.where(has, tg.take_slot(idx, slot), 0))
    assert torch.equal(torch.isinf(d2), ~has)


def test_candidate_sweep_first_slot_wins_ties():
    """A candidate row holding the same point four times: the first copy's
    slot wins, as in the reference's strict < and argmin."""
    rng = np.random.default_rng(5)
    base = rng.uniform(-3, 3, (40, 3)).astype(np.float32)
    cand = np.concatenate([base] * 4)[None].repeat(8, 0)  # (8, 160, 3)
    q = base[:8] + np.float32(0.01)
    d2, slot = tk.candidate_sweep_kernel(torch.from_numpy(q),
                                         torch.from_numpy(cand))
    np.testing.assert_array_equal(slot.numpy(), np.arange(8))
    assert slot.dtype == torch.int32
    with pytest.raises(ValueError):
        tk.candidate_sweep_kernel(torch.from_numpy(q),
                                  torch.from_numpy(cand[:, :, :2]))
    with pytest.raises(TypeError):
        tk.candidate_sweep_kernel(torch.from_numpy(q).double(),
                                  torch.from_numpy(cand))
