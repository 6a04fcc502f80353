"""Port vs reference: the ICP loop and its contracts.

``small_scene`` (1024 sampled source points, 3774 target points) and
seeded numpy clouds go through ``repro.core.icp`` (JAX, CPU) and
``repro_torch.core.icp`` (PyTorch, CPU). Rotation (angle between R_j and R_t) and
translation agree within 1e-3, iteration counts within ±1; the degenerate
freeze is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import icp as j_icp
from repro.core import icp_batch as j_icp_batch
from repro.core import icp_fixed_iterations as j_icp_fixed
from repro.core.icp import ICPParams as JParams
from repro.core.point_to_plane import robust_weights as j_robust_weights
from repro.data.collate import collate_pairs
from repro_torch.core.icp import (ICPParams, icp, icp_batch,
                                  icp_fixed_iterations, params_from_reference,
                                  result_to_numpy, scrub_nonfinite)
from repro_torch.core.point_to_plane import robust_weights

PARITY = 1e-3
PARAMS = ICPParams(max_iterations=20, chunk=1024)


def rt_diff(Ta, Tb):
    """(rotation angle between the two, translation distance)."""
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    # ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2): well conditioned near 0,
    # unlike arccos of the trace.
    chord = np.linalg.norm(Ta[:3, :3] - Tb[:3, :3]) / (2.0 * np.sqrt(2.0))
    return (float(2.0 * np.arcsin(min(chord, 1.0))),
            float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])))


def assert_parity(res_t, res_j, iters_tol=1):
    rot, trans = rt_diff(res_t.T, res_j.T)
    assert rot <= PARITY and trans <= PARITY, (rot, trans)
    assert abs(int(res_t.iterations) - int(res_j.iterations)) <= iters_tol
    assert float(res_t.rmse) == pytest.approx(float(res_j.rmse), abs=PARITY)


def _jparams(p: ICPParams) -> JParams:
    return JParams(**p._asdict())


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


# Tukey's cutoff stays at the 1 m gate: below the scene's 0.8 m initial
# offset it keeps a few dozen inliers and both sides stall near epsilon.
@pytest.mark.parametrize("robust,scale", [("none", 0.5), ("huber", 0.3),
                                          ("tukey", 1.0)])
def test_icp_matches_reference(small_scene, robust, scale):
    src, dst, T_gt = small_scene
    p = PARAMS._replace(robust_kernel=robust, robust_scale=scale)
    res_j = j_icp(jnp.asarray(src), jnp.asarray(dst), _jparams(p))
    res_t = result_to_numpy(icp(_t(src), _t(dst), p))
    assert_parity(res_t, res_j)
    assert bool(res_t.converged) == bool(res_j.converged)
    assert float(res_t.inlier_frac) == pytest.approx(
        float(res_j.inlier_frac), abs=1e-3)
    rot, trans = rt_diff(res_t.T, T_gt)
    assert rot < 0.01 and trans < 0.05


def test_icp_fixed_iterations_matches_reference_and_icp(small_scene):
    src, dst, _ = small_scene
    res_j = j_icp_fixed(jnp.asarray(src), jnp.asarray(dst), _jparams(PARAMS))
    res_t = result_to_numpy(icp_fixed_iterations(_t(src), _t(dst), PARAMS))
    assert_parity(res_t, res_j)
    # The freeze mask keeps the early-stopped state: same as the while loop.
    res_w = result_to_numpy(icp(_t(src), _t(dst), PARAMS))
    np.testing.assert_array_equal(res_t.T, res_w.T)
    assert int(res_t.iterations) == int(res_w.iterations)


def test_icp_batch_matches_reference(small_scene):
    """A padded batch of two pairs (the scene and a cropped, offset copy)
    against the reference's vmapped fixed-iteration loop."""
    src, dst, _ = small_scene
    rng = np.random.default_rng(0)
    src2 = src[rng.choice(len(src), 700, replace=False)] + np.float32(0.2)
    dst2 = dst[:3000]
    batch = collate_pairs([(src, dst), (src2, dst2)])
    T0 = np.stack([np.eye(4, dtype=np.float32)] * 2)
    res_j = j_icp_batch(jnp.asarray(batch.src), jnp.asarray(batch.dst),
                        _jparams(PARAMS), jnp.asarray(T0),
                        src_valid=jnp.asarray(batch.src_valid),
                        dst_valid=jnp.asarray(batch.dst_valid))
    res_t = result_to_numpy(icp_batch(
        _t(batch.src), _t(batch.dst), PARAMS, _t(T0),
        src_valid=_t(batch.src_valid), dst_valid=_t(batch.dst_valid)))
    assert res_t.T.shape == (2, 4, 4) and res_t.iterations.shape == (2,)
    for k in range(2):
        one_t = type(res_t)(*(x[k] for x in res_t))
        one_j = type(res_t)(*(np.asarray(x)[k] for x in res_j))
        assert_parity(one_t, one_j)


def test_degenerate_freeze_is_exact():
    """Disjoint clouds: nothing passes the gate. Identity step, rmse=inf,
    degenerate set, inlier fraction 0, exactly as in the reference."""
    rng = np.random.default_rng(1)
    src = rng.uniform(-1, 1, size=(64, 3)).astype(np.float32)
    dst = src + np.float32([100.0, 0.0, 0.0])
    p = ICPParams(max_iterations=10, chunk=32)
    res = result_to_numpy(icp(_t(src), _t(dst), p))
    ref = j_icp(jnp.asarray(src), jnp.asarray(dst), _jparams(p))
    np.testing.assert_array_equal(res.T, np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(res.T, np.asarray(ref.T))
    assert np.isinf(res.rmse) and np.isinf(float(ref.rmse))
    assert bool(res.degenerate) and bool(ref.degenerate)
    assert not bool(res.converged)
    assert float(res.inlier_frac) == 0.0
    assert int(res.iterations) == int(ref.iterations) == 1
    fixed = result_to_numpy(icp_fixed_iterations(_t(src), _t(dst), p))
    np.testing.assert_array_equal(fixed.T, np.eye(4, dtype=np.float32))
    assert bool(fixed.degenerate) and int(fixed.iterations) == 1


def test_scrub_nonfinite_one_nan_row(small_scene):
    """One NaN source row changes the inlier denominator, never the
    transform: the result equals the run without that row."""
    src, dst, _ = small_scene
    pts, valid = scrub_nonfinite(torch.tensor([[1.0, 2.0, 3.0],
                                               [float("nan"), 0.0, 0.0]]))
    assert valid.tolist() == [True, False]
    assert pts[1].tolist() == [1e6, 1e6, 1e6]
    dirty = src.copy()
    dirty[5, 1] = np.nan
    res_d = result_to_numpy(icp(_t(dirty), _t(dst), PARAMS))
    res_c = result_to_numpy(icp(_t(np.delete(src, 5, 0)), _t(dst), PARAMS))
    rot, trans = rt_diff(res_d.T, res_c.T)
    assert rot <= 1e-5 and trans <= 1e-5
    assert np.all(np.isfinite(res_d.T))
    res_j = j_icp(jnp.asarray(dirty), jnp.asarray(dst), _jparams(PARAMS))
    assert_parity(res_d, res_j)


def test_padded_src_valid_equals_unpadded(small_scene):
    src, dst, _ = small_scene
    n, m = len(src), len(dst)
    src_p = np.concatenate([src, np.full((200, 3), 1e6, np.float32)])
    dst_p = np.concatenate([dst, np.full((300, 3), 1e6, np.float32)])
    sv = np.arange(n + 200) < n
    dv = np.arange(m + 300) < m
    res_p = result_to_numpy(icp(_t(src_p), _t(dst_p), PARAMS,
                                src_valid=_t(sv), dst_valid=_t(dv)))
    res_u = result_to_numpy(icp(_t(src), _t(dst), PARAMS))
    np.testing.assert_allclose(res_p.T, res_u.T, atol=1e-5)
    assert float(res_p.inlier_frac) == pytest.approx(
        float(res_u.inlier_frac), abs=1e-6)
    assert int(res_p.iterations) == int(res_u.iterations)


@pytest.mark.parametrize("kind", ["none", "huber", "tukey"])
def test_robust_weights_match_reference(kind):
    r = np.random.default_rng(2).uniform(0, 2, size=500).astype(np.float32)
    r[0] = 0.0
    w_j = np.asarray(j_robust_weights(jnp.asarray(r), kind, 0.5))
    w_t = robust_weights(_t(r), kind, 0.5).numpy()
    np.testing.assert_allclose(w_t, w_j, atol=1e-6)


def test_params_from_reference():
    ref = JParams(max_iterations=7, robust_kernel="huber", chunk=512)
    assert params_from_reference(ref._asdict()) == ICPParams(
        max_iterations=7, robust_kernel="huber", chunk=512)
    assert params_from_reference(JParams()._asdict()) == ICPParams()
    plane = JParams(minimizer="point_to_plane", fused=True)
    assert params_from_reference(plane._asdict()) == ICPParams(
        minimizer="point_to_plane", fused=True)
    with pytest.raises(ValueError, match="new_knob"):
        params_from_reference({**JParams()._asdict(), "new_knob": 1})


def test_unknown_settings_raise():
    pts = torch.zeros(8, 3)
    with pytest.raises(ValueError):
        icp(pts, pts, ICPParams(minimizer="bogus"))
    with pytest.raises(ValueError):
        icp(pts, pts, ICPParams(robust_kernel="bogus"))
