"""Port vs reference: the point-to-plane minimiser and its ICP paths.

Seeded numpy systems and ``small_scene`` (1024 sampled source points, 3774
target points) go through ``repro.core`` (JAX, CPU) and ``repro_torch.core``
(PyTorch, CPU: the kernel wrappers' plain versions). The 6x6 solve agrees
within 1e-5; every plane ICP path (unfused, ``icp_batch``, the engines and
``FppsICP.setMinimizer("point_to_plane")``) within 1e-3 rotation and
translation.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FppsICP as JFppsICP
from repro.core import icp as j_icp
from repro.core import icp_batch as j_icp_batch
from repro.core.engine import PallasEngine
from repro.core.icp import ICPParams as JParams
from repro.core.point_to_plane import point_to_plane_rmse as j_rmse
from repro.core.point_to_plane import solve_normal_equations as j_solve_ne
from repro.core.point_to_plane import solve_point_to_plane as j_solve_p2pl
from repro.data.collate import collate_pairs
from repro.data.normals import NormalParams as JNormalParams
from repro.kernels.normals import estimate_normals_pallas
from repro_torch.core import (FppsICP, ICPParams, get_engine, icp, icp_batch,
                              result_to_numpy, solve_normal_equations,
                              solve_point_to_plane)
from repro_torch.core.point_to_plane import point_to_plane_rmse
from repro_torch.data.normals import NormalParams
from repro_torch.kernels.normals import estimate_normals_radius, moment_sweep

PARITY = 1e-3
SOLVE_TOL = 1e-5
PLANE = ICPParams(max_iterations=20, chunk=1024, minimizer="point_to_plane")


def rt_diff(Ta, Tb):
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    # ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2): well conditioned near 0.
    chord = np.linalg.norm(Ta[:3, :3] - Tb[:3, :3]) / (2.0 * np.sqrt(2.0))
    return (float(2.0 * np.arcsin(min(chord, 1.0))),
            float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])))


def assert_parity(Tt, Tj):
    rot, trans = rt_diff(Tt, Tj)
    assert rot <= PARITY and trans <= PARITY, (rot, trans)


def _jparams(p: ICPParams) -> JParams:
    return JParams(**p._asdict())


def _correspondences(seed, n=400):
    """Matched points on a few planes, their unit normals (a tenth zero,
    as invalid normals are) and weights, moved by a small rigid step."""
    rng = np.random.default_rng(seed)
    dst = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    normals = rng.normal(size=(n, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    normals[::10] = 0.0
    src = dst + rng.normal(0, 0.05, (n, 3)) + np.float32([0.1, -0.05, 0.02])
    w = rng.uniform(0.2, 1.0, n)
    return (src.astype(np.float32), dst, normals.astype(np.float32),
            w.astype(np.float32))


def test_solve_normal_equations_matches_reference():
    rng = np.random.default_rng(0)
    J = rng.normal(size=(3, 40, 6)).astype(np.float32)
    A = np.einsum("bni,bnj->bij", J, J)
    b = rng.normal(size=(3, 6)).astype(np.float32) * 0.1
    got = solve_normal_equations(torch.from_numpy(A), torch.from_numpy(b))
    assert got.shape == (3, 4, 4)
    for k in range(3):
        want = np.asarray(j_solve_ne(jnp.asarray(A[k]), jnp.asarray(b[k])))
        np.testing.assert_allclose(got[k].numpy(), want, atol=SOLVE_TOL)
        # batched lanes equal single solves
        one = solve_normal_equations(torch.from_numpy(A[k]),
                                     torch.from_numpy(b[k]))
        np.testing.assert_allclose(one.numpy(), got[k].numpy(), atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
def test_solve_point_to_plane_matches_reference(weighted):
    src, dst, n, w = _correspondences(1)
    w_t = torch.from_numpy(w) if weighted else None
    w_j = jnp.asarray(w) if weighted else None
    got = solve_point_to_plane(torch.from_numpy(src), torch.from_numpy(dst),
                               torch.from_numpy(n), w_t)
    want = j_solve_p2pl(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(n),
                        w_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SOLVE_TOL)
    got_r = point_to_plane_rmse(torch.from_numpy(src), torch.from_numpy(dst),
                                torch.from_numpy(n), w_t)
    want_r = j_rmse(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(n), w_j)
    assert float(got_r) == pytest.approx(float(want_r), rel=1e-5)


def test_zero_normals_are_ignored():
    """A pair with a zero normal has a zero Jacobian row and residual: adding
    such rows (with any weight) leaves the step unchanged."""
    src, dst, n, w = _correspondences(2)
    keep = np.any(n != 0, axis=1)
    full = solve_point_to_plane(torch.from_numpy(src), torch.from_numpy(dst),
                                torch.from_numpy(n), torch.from_numpy(w))
    kept = solve_point_to_plane(torch.from_numpy(src[keep]),
                                torch.from_numpy(dst[keep]),
                                torch.from_numpy(n[keep]),
                                torch.from_numpy(w[keep]))
    np.testing.assert_allclose(full.numpy(), kept.numpy(), atol=1e-6)
    batched = solve_point_to_plane(torch.from_numpy(np.stack([src, src])),
                                   torch.from_numpy(np.stack([dst, dst])),
                                   torch.from_numpy(np.stack([n, n])))
    assert batched.shape == (2, 4, 4)
    assert torch.equal(batched[0], batched[1])


@pytest.mark.parametrize("robust,scale", [("none", 0.5), ("huber", 0.3)])
def test_plane_icp_matches_reference(small_scene, robust, scale):
    src, dst, T_gt = small_scene
    p = PLANE._replace(robust_kernel=robust, robust_scale=scale)
    rj = j_icp(jnp.asarray(src), jnp.asarray(dst), _jparams(p))
    rt = result_to_numpy(icp(torch.from_numpy(src), torch.from_numpy(dst), p))
    assert_parity(rt.T, rj.T)
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 1
    assert float(rt.rmse) == pytest.approx(float(rj.rmse), abs=PARITY)
    assert float(rt.inlier_frac) == pytest.approx(float(rj.inlier_frac),
                                                  abs=1e-3)
    rot, trans = rt_diff(rt.T, T_gt)
    assert rot < 0.01 and trans < 0.05


def test_plane_icp_batch_matches_reference(small_scene):
    """A padded batch of two pairs, normals estimated for the whole batch
    at once, against the reference's vmapped loop."""
    src, dst, _ = small_scene
    rng = np.random.default_rng(0)
    src2 = src[rng.choice(len(src), 700, replace=False)] + np.float32(0.2)
    batch = collate_pairs([(src, dst), (src2, dst[:3000])])
    p = PLANE._replace(max_iterations=12)
    rj = j_icp_batch(jnp.asarray(batch.src), jnp.asarray(batch.dst),
                     _jparams(p), src_valid=jnp.asarray(batch.src_valid),
                     dst_valid=jnp.asarray(batch.dst_valid))
    rt = result_to_numpy(icp_batch(
        torch.from_numpy(batch.src), torch.from_numpy(batch.dst), p,
        src_valid=torch.from_numpy(batch.src_valid),
        dst_valid=torch.from_numpy(batch.dst_valid)))
    for k in range(2):
        assert_parity(rt.T[k], np.asarray(rj.T)[k])
        assert abs(int(rt.iterations[k]) - int(rj.iterations[k])) <= 1


def test_plane_icp_with_radius_normals_matches_reference(small_scene):
    """The moment sweep's normals drive a registration: the port's
    ``estimate_normals_radius`` against the reference's
    ``estimate_normals_pallas`` (interpret mode) as ``target_normals``."""
    src, dst, T_gt = small_scene
    params = NormalParams(neighborhood="radius", radius=1.0,
                          grid_dims=(64, 64, 16))
    before = moment_sweep.launches
    n_t, v_t = estimate_normals_radius(torch.from_numpy(dst), params)
    assert moment_sweep.launches == before  # plain version on the CPU
    n_j, v_j = estimate_normals_pallas(
        jnp.asarray(dst), JNormalParams(**params._asdict()), interpret=True)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    rt = result_to_numpy(icp(torch.from_numpy(src), torch.from_numpy(dst),
                             PLANE, target_normals=n_t))
    rj = j_icp(jnp.asarray(src), jnp.asarray(dst), _jparams(PLANE),
               target_normals=n_j)
    assert_parity(rt.T, rj.T)
    rot, trans = rt_diff(rt.T, T_gt)
    assert rot < 0.01 and trans < 0.05


def _align(reg, src, dst, iters=20):
    reg.setInputSource(src)
    reg.setInputTarget(dst)
    reg.setMaxCorrespondenceDistance(1.0)
    reg.setMaxIterationCount(iters)
    reg.setTransformationEpsilon(1e-5)
    reg.setMinimizer("point_to_plane")
    return reg.align()


@pytest.mark.parametrize("port_engine,ref_engine", [
    ("torch", "xla"), ("cuda", "pallas-interpret")])
def test_fppsicp_plane_matches_reference(small_scene, port_engine,
                                         ref_engine):
    src, dst, T_gt = small_scene
    ref = (JFppsICP(engine=PallasEngine(interpret=True))
           if ref_engine == "pallas-interpret" else JFppsICP(engine="xla"))
    T_j = _align(ref, src, dst)
    port = FppsICP(engine=port_engine, device="cpu")
    T_t = _align(port, src, dst)
    assert_parity(T_t, T_j)
    assert abs(int(port.last_result.iterations)
               - int(ref.last_result.iterations)) <= 1
    assert port.hasConverged() == ref.hasConverged()
    rot, trans = rt_diff(T_t, T_gt)
    assert rot < 0.01 and trans < 0.05


def test_kernel_engine_plane_batch_matches_torch_engine(small_scene):
    """The ``"cuda"`` engine estimates normals before it moves padded
    target rows to the sentinel: its batch equals the ``"torch"`` engine's,
    which masks natively, fused and not."""
    src, dst, _ = small_scene
    pairs = [(src, dst), (src[:800], dst[:3200])]
    p = PLANE._replace(max_iterations=10)
    rt, _ = get_engine("torch", device="cpu").register_pairs(pairs, p)
    rk, _ = get_engine("cuda", device="cpu").register_pairs(pairs, p)
    torch.testing.assert_close(rk.T, rt.T, atol=1e-5, rtol=0)
    rf, _ = get_engine("cuda", device="cpu").register_pairs(
        pairs, p._replace(fused=True))
    assert float((rf.T - rt.T).abs().max()) <= PARITY
