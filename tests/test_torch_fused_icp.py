"""Port vs reference: the fused point-to-point ICP pass and iteration.

Seeded numpy candidate rows go through ``repro.kernels.fused_icp`` (JAX,
Pallas in interpret mode, at <= 256 queries) and
``repro_torch.kernels.fused_icp`` (PyTorch, CPU: the kernel wrapper's plain
version). The 18 moment sums agree within 2e-5 relative (the bar of
``tests/test_fused_icp.py``); fused ICP matches unfused ICP in the port and
the reference's fused ICP within 1e-3 rotation and translation; the
degenerate freeze is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import icp_fixed_iterations as j_icp_fixed
from repro.core.icp import ICPParams as JParams
from repro.kernels.fused_icp import fused_moment_sweep as j_sweep
from repro_torch.core import (ICPParams, get_engine, icp,
                              icp_fixed_iterations, result_to_numpy)
from repro_torch.core.nn_search_grid import _MASK_COORD
from repro_torch.data.voxelize import build_voxel_grid
from repro_torch.kernels import fused_icp as tf
from repro_torch.kernels import ref

PARITY = 1e-3


def rt_diff(Ta, Tb):
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    # ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2): well conditioned near 0.
    chord = np.linalg.norm(Ta[:3, :3] - Tb[:3, :3]) / (2.0 * np.sqrt(2.0))
    return (float(2.0 * np.arcsin(min(chord, 1.0))),
            float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])))


def _rows(seed, n=120, ck=50, scale=3.0):
    """Per-query candidate rows; rows 0 mod 7 are empty hoods (sentinel
    only), and a random third of the slots elsewhere is masked."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    cand = (q[:, None, :] + rng.normal(0, 0.8, (n, ck, 3))).astype(np.float32)
    cand[rng.uniform(size=(n, ck)) < 0.33] = _MASK_COORD
    cand[::7] = _MASK_COORD
    sv = (np.arange(n) % 5 != 1).astype(np.float32)
    return q, cand, sv


@pytest.mark.parametrize("robust,scale", [("none", 0.5), ("huber", 0.3),
                                          ("tukey", 0.8)])
def test_moment_sums_match_reference(robust, scale):
    q, cand, sv = _rows(0)
    got = tf.fused_moment_sweep(torch.from_numpy(q), torch.from_numpy(cand),
                                torch.from_numpy(sv), gate=1.0,
                                robust_kernel=robust, robust_scale=scale)
    want = j_sweep(jnp.asarray(q), jnp.asarray(cand), jnp.asarray(sv),
                   gate=1.0, robust_kernel=robust, robust_scale=scale,
                   bn=32, bc=16, interpret=True)
    assert tuple(got) == tf.P2P_MOMENTS == tuple(tf.moment_names(False))
    assert float(got["w"]) > 10.0  # the gate keeps a good share
    for name in tf.P2P_MOMENTS:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=2e-5, atol=2e-5, err_msg=name)


def test_masked_and_empty_rows_contribute_exactly_zero():
    q, cand, sv = _rows(1)
    planes = ref.fused_moment_planes(torch.from_numpy(q),
                                     torch.from_numpy(cand),
                                     torch.from_numpy(sv), gate=1.0,
                                     robust_kernel="huber", robust_scale=0.3)
    assert planes.shape == (len(tf.P2P_MOMENTS), len(q))
    assert bool((planes[:, ::7] == 0).all())        # empty hoods
    assert bool((planes[:, 1::5] == 0).all())       # src_valid = 0
    # an all-sentinel batch gives exactly zero sums
    empty = np.full_like(cand, _MASK_COORD)
    s = tf.fused_moment_sweep(torch.from_numpy(q), torch.from_numpy(empty),
                              gate=1.0)
    assert all(float(v) == 0.0 for v in s.values())


def test_batched_sweep_equals_per_lane():
    rows = [_rows(10 + k, n=64) for k in range(3)]
    q = torch.from_numpy(np.stack([r[0] for r in rows]))
    cand = torch.from_numpy(np.stack([r[1] for r in rows]))
    sv = torch.from_numpy(np.stack([r[2] for r in rows]))
    s = tf.fused_moment_sweep(q, cand, sv, gate=1.0, robust_kernel="tukey")
    for b in range(3):
        one = tf.fused_moment_sweep(q[b], cand[b], sv[b], gate=1.0,
                                    robust_kernel="tukey")
        for name in tf.P2P_MOMENTS:
            assert torch.equal(s[name][b], one[name]), name
    m = tf._assemble(s)
    assert m.sp.shape == (3, 3) and m.spq.shape == (3, 3, 3)
    assert torch.equal(m.spq[1, 2, 0], s["pq20"][1])


@pytest.mark.parametrize("robust", ["none", "huber"])
def test_fused_matches_unfused_in_port(small_scene, robust):
    src, dst, _ = small_scene
    p = ICPParams(max_iterations=12, robust_kernel=robust, robust_scale=0.3)
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    ru = result_to_numpy(icp_fixed_iterations(s, d, p))
    rf = result_to_numpy(icp_fixed_iterations(s, d, p._replace(fused=True)))
    rot, trans = rt_diff(rf.T, ru.T)
    assert rot <= PARITY and trans <= PARITY, (rot, trans)
    assert int(rf.iterations) == int(ru.iterations)
    # rmse from uncentred fp32 moments: within the k-d tree's 0.01 m band
    assert abs(float(rf.rmse) - float(ru.rmse)) <= 0.01


def test_fused_icp_matches_reference(small_scene):
    src, dst, _ = small_scene
    p = ICPParams(max_iterations=8, fused=True)
    rj = j_icp_fixed(jnp.asarray(src), jnp.asarray(dst),
                     JParams(**p._asdict()))
    rt = result_to_numpy(icp_fixed_iterations(torch.from_numpy(src),
                                              torch.from_numpy(dst), p))
    rot, trans = rt_diff(rt.T, rj.T)
    assert rot <= PARITY and trans <= PARITY, (rot, trans)
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 1
    assert float(rt.rmse) == pytest.approx(float(rj.rmse), abs=PARITY)
    assert float(rt.inlier_frac) == pytest.approx(float(rj.inlier_frac),
                                                  abs=1e-3)


def test_fused_degenerate_freeze_is_exact(small_scene):
    """Target entirely out of gate range: identity, rmse inf, degenerate,
    one iteration, as the unfused zero-inlier path."""
    src, _, _ = small_scene
    s = torch.from_numpy(src)
    res = result_to_numpy(icp(s, s + 500.0, ICPParams(max_iterations=3,
                                                       fused=True)))
    np.testing.assert_array_equal(res.T, np.eye(4, dtype=np.float32))
    assert np.isinf(res.rmse) and bool(res.degenerate)
    assert not bool(res.converged) and float(res.inlier_frac) == 0.0
    assert int(res.iterations) == 1


def test_kernel_engine_fused_single_and_batch(small_scene):
    src, dst, _ = small_scene
    params = ICPParams(max_iterations=10)
    eng = get_engine("cuda", device="cpu")
    before = tf.fused_moment_sweep.launches
    ru = eng.register(src, dst, params)
    rf = eng.register(src, dst, params._replace(fused=True))
    assert tf.fused_moment_sweep.launches == before  # plain on the CPU
    assert float((rf.T - ru.T).abs().max()) <= PARITY
    rb = eng.register_batch(np.stack([src] * 2), np.stack([dst] * 2),
                            params._replace(fused=True))
    assert rb.T.shape == (2, 4, 4)
    for lane in range(2):
        assert float((rb.T[lane] - rf.T).abs().max()) <= PARITY


def test_plane_and_prune_raise_naming_slice_3(small_scene):
    src, dst, _ = small_scene
    grid = build_voxel_grid(torch.from_numpy(dst), 1.0, (64, 64, 16))
    with pytest.raises(NotImplementedError, match="slice 3"):
        tf.make_fused_fn(grid, ICPParams(minimizer="point_to_plane"))
    with pytest.raises(NotImplementedError, match="slice 3"):
        tf.make_fused_fn(grid, ICPParams(), prune=True)
    q = torch.zeros(4, 3)
    cand = torch.zeros(4, 8, 3)
    with pytest.raises(NotImplementedError, match="slice 3"):
        tf.fused_moment_sweep(q, cand, gate=1.0, prune=True)
    with pytest.raises(NotImplementedError, match="slice 3"):
        tf.fused_moment_sweep(q, cand, cand_normals=cand, gate=1.0)
    with pytest.raises(NotImplementedError, match="slice 3"):
        icp(torch.from_numpy(src), torch.from_numpy(dst),
            ICPParams(fused=True, minimizer="point_to_plane"))
