"""Port vs reference: the fused ICP pass and iteration, point-to-point and
point-to-plane, with and without the bf16 prune.

Seeded numpy candidate rows go through ``repro.kernels.fused_icp`` (JAX,
Pallas in interpret mode, at <= 256 queries) and
``repro_torch.kernels.fused_icp`` (PyTorch, CPU: the kernel wrapper's plain
version). The 18 and 45 moment sums agree within 2e-5 relative (the bar of
``tests/test_fused_icp.py``); the planes with ``prune=True`` are the same
bits as without; fused ICP matches unfused ICP in the port and the
reference's fused ICP within 1e-3 rotation and translation; the degenerate
freeze is exact.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.core import icp_fixed_iterations as j_icp_fixed
from repro.core.icp import ICPParams as JParams
from repro.kernels.fused_icp import fused_moment_sweep as j_sweep
from repro_torch.core import (ICPParams, get_engine, icp,
                              icp_fixed_iterations, result_to_numpy)
from repro_torch.core.nn_search_grid import _MASK_COORD
from repro_torch.data.normals import default_target_normals
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


def _normals(seed, cand):
    """Unit candidate normals, zero on masked slots and on a tenth of the
    others (invalid normals)."""
    rng = np.random.default_rng(seed)
    n = rng.normal(size=cand.shape)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[rng.uniform(size=cand.shape[:-1]) < 0.1] = 0.0
    n[cand[..., 0] == _MASK_COORD] = 0.0
    return n.astype(np.float32)


@pytest.mark.parametrize("robust,scale", [("none", 0.5), ("huber", 0.3),
                                          ("tukey", 0.8)])
def test_plane_moment_sums_match_reference(robust, scale):
    q, cand, sv = _rows(3)
    cn = _normals(3, cand)
    got = tf.fused_moment_sweep(torch.from_numpy(q), torch.from_numpy(cand),
                                torch.from_numpy(sv), torch.from_numpy(cn),
                                gate=1.0, robust_kernel=robust,
                                robust_scale=scale)
    want = j_sweep(jnp.asarray(q), jnp.asarray(cand), jnp.asarray(sv),
                   jnp.asarray(cn), gate=1.0, robust_kernel=robust,
                   robust_scale=scale, bn=32, bc=16, interpret=True)
    assert tuple(got) == tf.P2PLANE_MOMENTS == tuple(tf.moment_names(True))
    assert float(got["w"]) > 10.0
    for name in tf.P2PLANE_MOMENTS:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=2e-5, atol=2e-5, err_msg=name)
    m = tf._assemble(got, plane=True)
    assert torch.equal(m.A, m.A.mT) and torch.equal(m.A[1, 4], got["a14"])
    assert torch.equal(m.b[2], -got["ra2"])


def _near_gate_rows(seed, n=256, ck=48, lo=30.0, hi=60.0):
    """Scene-scale queries whose nearest candidate sits 0.9-1.0 m away in a
    random direction, the rest farther out: the case where rounding raw
    coordinates to bf16 (0.25 m steps at 32-64 m) would screen inliers."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, ck, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dist = rng.uniform(0.9, 3.0, (n, ck, 1))
    dist[:, 0] = rng.uniform(0.9, 1.0, (n, 1))
    cand = (q[:, None, :] + dist * dirs).astype(np.float32)
    cand[::11] = _MASK_COORD
    return q, cand


@pytest.mark.parametrize("plane", [False, True])
@pytest.mark.parametrize("robust,scale", [("none", 0.5), ("huber", 0.3),
                                          ("tukey", 1.2)])
def test_prune_is_bit_identical(plane, robust, scale):
    """With and without the bf16 screen the planes are the same bits, on
    near-gate scene-scale rows, on the rows of ``_rows`` and on empty
    neighbourhoods (all planes exactly +0)."""
    for q, cand in (_near_gate_rows(5), _rows(6)[:2]):
        sv = torch.ones(len(q))
        cn = torch.from_numpy(_normals(7, cand)) if plane else None
        kw = dict(gate=1.0, robust_kernel=robust, robust_scale=scale)
        qt, ct = torch.from_numpy(q), torch.from_numpy(cand)
        off = tf.moment_planes(qt, ct, sv, cn, **kw)
        on = tf.moment_planes(qt, ct, sv, cn, prune=True, **kw)
        assert torch.equal(on.view(torch.int32), off.view(torch.int32))
        assert float(off[0].sum()) > 10.0
    empty = torch.full_like(ct, _MASK_COORD)
    en = torch.zeros_like(ct) if plane else None
    on = tf.moment_planes(qt, empty, sv, en, prune=True, **kw)
    assert torch.equal(on.view(torch.int32), torch.zeros_like(on).view(
        torch.int32))


@pytest.mark.parametrize("plane", [False, True])
def test_pruned_sums_match_pruned_reference(plane):
    """The port's screen (bf16 offsets) against the reference's (bf16
    coordinates) at the reference's default margin, on small-coordinate rows
    where the reference's screen keeps every within-gate winner."""
    assert (inspect.signature(j_sweep).parameters["prune_margin"].default
            == ref.PRUNE_MARGIN)
    q, cand, sv = _rows(8)
    cn = _normals(9, cand) if plane else None
    got = tf.fused_moment_sweep(
        torch.from_numpy(q), torch.from_numpy(cand), torch.from_numpy(sv),
        None if cn is None else torch.from_numpy(cn), gate=1.0,
        robust_kernel="huber", robust_scale=0.3, prune=True)
    want = j_sweep(jnp.asarray(q), jnp.asarray(cand), jnp.asarray(sv),
                   None if cn is None else jnp.asarray(cn), gate=1.0,
                   robust_kernel="huber", robust_scale=0.3, bn=32, bc=16,
                   prune=True, interpret=True)
    assert tuple(got) == tf.moment_names(plane)
    assert float(got["w"]) > 10.0
    for name in tf.moment_names(plane):
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=2e-5, atol=2e-5, err_msg=name)


def test_plane_fused_icp_matches_reference_and_unfused(small_scene):
    src, dst, _ = small_scene
    p = ICPParams(max_iterations=8, fused=True, minimizer="point_to_plane")
    rj = j_icp_fixed(jnp.asarray(src), jnp.asarray(dst),
                     JParams(**p._asdict()))
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    rt = result_to_numpy(icp_fixed_iterations(s, d, p))
    rot, trans = rt_diff(rt.T, rj.T)
    assert rot <= PARITY and trans <= PARITY, (rot, trans)
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 1
    assert float(rt.inlier_frac) == pytest.approx(float(rj.inlier_frac),
                                                  abs=1e-3)
    ru = result_to_numpy(icp_fixed_iterations(s, d, p._replace(fused=False)))
    rot, trans = rt_diff(rt.T, ru.T)
    assert rot <= PARITY and trans <= PARITY, (rot, trans)


def test_fused_plane_needs_normals_and_prune_runs(small_scene):
    src, dst, _ = small_scene
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    grid = build_voxel_grid(d, 1.0, (64, 64, 16))
    plane = ICPParams(minimizer="point_to_plane", max_iterations=6)
    with pytest.raises(ValueError, match="target_normals"):
        tf.make_fused_fn(grid, plane)
    for p in (ICPParams(max_iterations=6), plane):
        normals = (default_target_normals(d)
                   if p.minimizer == "point_to_plane" else None)
        fns = [tf.make_fused_fn(grid, p, normals,
                                config=tf.FusedConfig(prune=prune))
               for prune in (False, True)]
        r0, r1 = (icp_fixed_iterations(s, None, p._replace(fused=True),
                                       fused_fn=f) for f in fns)
        for a, b in zip(r0, r1):
            assert torch.equal(a, b)
