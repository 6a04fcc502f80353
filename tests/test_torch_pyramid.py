"""Port vs reference: the coarse-to-fine pyramid and its engine.

Seeded numpy pairs and ``small_scene`` go through ``repro.core.pyramid``
(JAX, CPU, its XLA path) and ``repro_torch.core.pyramid`` (PyTorch, CPU:
the kernel wrappers' plain versions). Transforms agree within 1e-3 rotation
and translation, iteration counts within +-1; ``polish_stats`` is equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FppsICP as JFppsICP
from repro.core.icp import ICPParams as JParams
from repro.core.pyramid import PyramidEngine as JPyramidEngine
from repro.core.pyramid import icp_pyramid as j_icp_pyramid
from repro.core.pyramid import polish_stats as j_polish_stats
from repro_torch.core import (FppsICP, ICPParams, PyramidEngine,
                              available_engines, get_engine, icp,
                              icp_pyramid, polish_stats, result_to_numpy)
from repro_torch.data.collate import collate_pairs
from repro_torch.kernels.fused_icp import fused_moment_sweep
from repro_torch.kernels.nn_search import nn_search_kernel
from repro_torch.kernels.nn_search_grid import candidate_sweep_kernel

PARITY = 1e-3
PARAMS = ICPParams(max_iterations=30, chunk=512)
# Small-scene pyramid config of tests/test_pyramid.py: one 2 m coarse
# level, a 32^3 lattice.
SMALL = dict(levels=((2.0, 6, 1024),), grid_dims=(32, 32, 32))


def rt_diff(Ta, Tb):
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    # ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2): well conditioned near 0.
    chord = np.linalg.norm(Ta[:3, :3] - Tb[:3, :3]) / (2.0 * np.sqrt(2.0))
    return (float(2.0 * np.arcsin(min(chord, 1.0))),
            float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])))


def assert_parity(Tt, Tj):
    rot, trans = rt_diff(Tt, Tj)
    assert rot <= PARITY and trans <= PARITY, (rot, trans)


def _pair(seed, n=400, m=3000, scale=10.0, max_angle=0.1, max_t=0.3):
    rng = np.random.default_rng(seed)
    dst = rng.uniform(-scale, scale, (m, 3)).astype(np.float32)
    a = rng.uniform(-max_angle, max_angle)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]])
    t = rng.uniform(-max_t, max_t, 3)
    src = (dst[:n] - t) @ R + 0.002 * rng.normal(size=(n, 3))
    return src.astype(np.float32), dst


def _jparams(p):
    return JParams(**p._asdict())


@pytest.mark.parametrize("fixed", [False, True])
def test_icp_pyramid_matches_reference(fixed):
    src, dst = _pair(0)
    rj = j_icp_pyramid(jnp.asarray(src), jnp.asarray(dst), _jparams(PARAMS),
                       fixed=fixed, **SMALL)
    rt = result_to_numpy(icp_pyramid(torch.from_numpy(src),
                                     torch.from_numpy(dst), PARAMS,
                                     fixed=fixed, **SMALL))
    assert_parity(rt.T, rj.T)
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 1
    assert float(rt.rmse) == pytest.approx(float(rj.rmse), abs=PARITY)
    assert bool(rt.converged) == bool(rj.converged)


def test_engine_register_and_batch_match_reference():
    sizes = [(180, 900), (220, 1100), (150, 800)]
    pairs = [_pair(10 + i, n=n, m=m) for i, (n, m) in enumerate(sizes)]
    j_eng = JPyramidEngine(chunk=512, **SMALL)
    t_eng = PyramidEngine(chunk=512, device="cpu", **SMALL)
    res_t, batch = t_eng.register_pairs(pairs, PARAMS)
    res_j = j_eng.register_batch(batch.src, batch.dst, _jparams(PARAMS),
                                 src_valid=batch.src_valid,
                                 dst_valid=batch.dst_valid)
    assert res_t.T.shape == (3, 4, 4)
    for k, (s, d) in enumerate(pairs):
        assert_parity(res_t.T[k].numpy(), np.asarray(res_j.T[k]))
        assert float(res_t.inlier_frac[k]) == pytest.approx(
            float(res_j.inlier_frac[k]), abs=1e-3)
        single_t = t_eng.register(s, d, PARAMS)  # bucketed on the device
        single_j = j_eng.register(s, d, _jparams(PARAMS))
        assert_parity(single_t.T.numpy(), np.asarray(single_j.T))
        # the batch lane equals the stop-early single run
        np.testing.assert_allclose(res_t.T[k].numpy(), single_t.T.numpy(),
                                   atol=1e-5)


def test_recovers_beyond_gate_perturbation():
    """A translation several gates beyond the 1 m gate: brute ICP stalls,
    a two-level coarse schedule recovers it (tests/test_pyramid.py)."""
    rng = np.random.default_rng(3)
    dst = rng.uniform(-12, 12, (4000, 3)).astype(np.float32)
    src = dst[:1000] + 0.01 * rng.normal(size=(1000, 3)).astype(np.float32)
    shift = np.float32([2.5, 1.0, 0.5])
    s, d = torch.from_numpy(src - shift), torch.from_numpy(dst)
    params = ICPParams(max_iterations=60, chunk=1024)
    brute = icp(s, d, params)
    pyr = icp_pyramid(s, d, params, levels=((6.0, 12, 1024),
                                            (2.0, 10, 4096)),
                      grid_dims=(32, 32, 32))
    assert float((brute.T[:3, 3] - torch.from_numpy(shift)).norm()) > 1.0
    assert float((pyr.T[:3, 3] - torch.from_numpy(shift)).norm()) < 0.05


def test_polish_stats_equal_reference():
    src, dst = _pair(9, n=64, m=2000)
    src = src.copy()
    src[:8] += np.float32([80.0, 0.0, 0.0])  # out of the 32 m lattice
    for kw in (dict(), dict(max_per_cell=2)):
        sj = j_polish_stats(jnp.asarray(src), jnp.asarray(dst),
                            _jparams(PARAMS), grid_dims=(32, 32, 32), **kw)
        st = polish_stats(torch.from_numpy(src), torch.from_numpy(dst),
                          PARAMS, grid_dims=(32, 32, 32), **kw)
        for a, b in zip(st, sj):
            assert float(a) == float(b)
    eng = PyramidEngine(device="cpu", grid_dims=(32, 32, 32), max_per_cell=2)
    st = eng.polish_stats(src, dst)
    assert float(st.dropped_frac) > 0.0 and float(st.out_of_lattice) > 0.0


def test_named_engines_are_shared_singletons():
    assert "pyramid" in available_engines()
    a = get_engine("pyramid", device="cpu", levels=((2.0, 6, 1024),),
                   grid_dims=(32, 32, 32))
    b = get_engine("pyramid", device="cpu", levels=((2.0, 6, 1024),),
                   grid_dims=(32, 32, 32))
    assert a is b and isinstance(a, PyramidEngine)
    assert get_engine("pyramid", device="cpu") is not a


@pytest.mark.parametrize("fused", [False, True])
def test_fppsicp_pyramid_matches_reference(small_scene, fused):
    """Table-I surface on the default levels and lattice; the fused polish
    against the reference's fused pyramid."""
    src, dst, T_gt = small_scene
    params = ICPParams(max_iterations=20, fused=fused)
    before = (nn_search_kernel.launches, candidate_sweep_kernel.launches,
              fused_moment_sweep.launches)
    if fused:
        rj = JFppsICP(engine="pyramid").engine.register(src, dst,
                                                        _jparams(params))
        rt = get_engine("pyramid", device="cpu").register(src, dst, params)
        T_t, T_j = rt.T.numpy(), np.asarray(rj.T)
    else:
        regs = (FppsICP(engine="pyramid", device="cpu"),
                JFppsICP(engine="pyramid"))
        for reg in regs:
            reg.setInputSource(src)
            reg.setInputTarget(dst)
            reg.setMaxIterationCount(20)
        T_t, T_j = regs[0].align(), regs[1].align()
        assert abs(int(regs[0].last_result.iterations)
                   - int(regs[1].last_result.iterations)) <= 1
    assert_parity(T_t, T_j)
    rot, trans = rt_diff(T_t, T_gt)
    assert rot < 0.01 and trans < 0.05
    # CPU tensors: every wrapper ran its plain version, no launch counted
    assert (nn_search_kernel.launches, candidate_sweep_kernel.launches,
            fused_moment_sweep.launches) == before


def test_register_pairs_fused_matches_unfused():
    pairs = [_pair(30 + k, n=200, m=1200) for k in range(2)]
    eng = PyramidEngine(device="cpu", **SMALL)
    ru, _ = eng.register_pairs(pairs, PARAMS)
    rf, _ = eng.register_pairs(pairs, PARAMS._replace(fused=True))
    assert float((ru.T - rf.T).abs().max()) <= PARITY
    batch = collate_pairs(pairs)
    assert ru.iterations.shape == (len(batch.src_sizes),)


def _plane_scene(seed, n=500, m=4000):
    """A pair on planar structure (ground, two walls): the point-to-plane
    minimiser's case, with a small rigid offset."""
    rng = np.random.default_rng(seed)
    k = m // 3
    ground = np.column_stack([rng.uniform(-12, 12, (k, 2)),
                              rng.normal(-1.5, 0.01, k)])
    wall_x = np.column_stack([rng.normal(8.0, 0.01, k),
                              rng.uniform(-12, 12, k), rng.uniform(-1.5, 3, k)])
    wall_y = np.column_stack([rng.uniform(-12, 12, m - 2 * k),
                              rng.normal(-9.0, 0.01, m - 2 * k),
                              rng.uniform(-1.5, 3, m - 2 * k)])
    dst = np.concatenate([ground, wall_x, wall_y]).astype(np.float32)
    a = rng.uniform(-0.05, 0.05)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]])
    t = rng.uniform(-0.3, 0.3, 3)
    src = (dst[rng.choice(m, n, replace=False)] - t) @ R
    return src.astype(np.float32), dst


@pytest.mark.parametrize("fused", [False, True])
def test_plane_pyramid_matches_reference(fused):
    """The plane polish (knn normals over the resident grid; coarse levels
    point-to-point), unfused through the grid searcher and fused through
    the 45-plane pass, against the reference's pyramid."""
    src, dst = _plane_scene(40)
    p = PARAMS._replace(minimizer="point_to_plane", fused=fused,
                        max_iterations=15)
    rj = j_icp_pyramid(jnp.asarray(src), jnp.asarray(dst), _jparams(p),
                       interpret=True, **SMALL)
    rt = result_to_numpy(icp_pyramid(torch.from_numpy(src),
                                     torch.from_numpy(dst), p, **SMALL))
    assert_parity(rt.T, rj.T)
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 1
    assert bool(rt.converged) == bool(rj.converged)


def test_plane_register_pairs_fused_matches_unfused_and_fppsicp():
    pairs = [_plane_scene(41 + k, n=300, m=2400) for k in range(2)]
    eng = PyramidEngine(device="cpu", **SMALL)
    p = PARAMS._replace(minimizer="point_to_plane", max_iterations=12)
    ru, _ = eng.register_pairs(pairs, p)
    rf, _ = eng.register_pairs(pairs, p._replace(fused=True))
    assert float((ru.T - rf.T).abs().max()) <= PARITY
    reg = FppsICP(engine=eng)
    reg.setMinimizer("point_to_plane")
    reg.setInputSource(pairs[0][0])
    reg.setInputTarget(pairs[0][1])
    reg.setMaxIterationCount(12)
    assert_parity(reg.align(), ru.T[0].numpy())
