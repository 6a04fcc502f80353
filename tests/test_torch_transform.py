"""Port vs reference: 3x3 Jacobi SVD and the Kabsch/moment transforms.

The same numpy inputs (seeded) go through ``repro.core`` (JAX, CPU) and
``repro_torch.core`` (PyTorch, CPU). Tolerance 1e-5: both sides run the same
fp32 algorithm and differ only in the order of a few sums.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

import repro.core.transform as j_tf
import repro_torch.core.transform as t_tf
from repro.core.svd3x3 import svd3x3 as j_svd3x3
from repro_torch.core.svd3x3 import svd3x3 as t_svd3x3

TOL = 1e-5


def _rot(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def _matrices():
    rng = np.random.default_rng(0)
    cases = {f"random{k}": rng.normal(size=(3, 3)) for k in range(4)}
    # Reflection with distinct singular values: det < 0.
    cases["reflection"] = _rot(rng) @ np.diag([3.0, 2.0, -1.0]) @ _rot(rng).T
    # Exactly rank-deficient (zero columns): the U repair path, rank 2 / 1 / 0.
    cases["rank2"] = np.column_stack([rng.normal(size=3), rng.normal(size=3),
                                      np.zeros(3)])
    cases["rank1"] = np.column_stack([np.zeros(3), rng.normal(size=3),
                                      np.zeros(3)])
    cases["zero"] = np.zeros((3, 3))
    return {k: v.astype(np.float32) for k, v in cases.items()}


MATRICES = _matrices()


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_svd3x3_matches_reference(name):
    M = MATRICES[name]
    U_j, S_j, Vt_j = (np.asarray(x) for x in j_svd3x3(jnp.asarray(M)))
    U_t, S_t, Vt_t = (x.numpy() for x in t_svd3x3(torch.from_numpy(M)))
    np.testing.assert_allclose(S_t, S_j, atol=TOL)
    np.testing.assert_allclose(U_t, U_j, atol=TOL)
    np.testing.assert_allclose(Vt_t, Vt_j, atol=TOL)
    np.testing.assert_allclose(U_t @ np.diag(S_t) @ Vt_t, M, atol=1e-5)


def test_svd3x3_generic_rank1_reconstructs():
    """A generic rank-1 matrix leaves fp32 noise in the null space, so U's
    last columns are arbitrary on both sides: hold S and the product."""
    rng = np.random.default_rng(1)
    M = np.outer(rng.normal(size=3), rng.normal(size=3)).astype(np.float32)
    _, S_j, _ = j_svd3x3(jnp.asarray(M))
    U, S, Vt = t_svd3x3(torch.from_numpy(M))
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j), atol=TOL)
    np.testing.assert_allclose((U @ torch.diag(S) @ Vt).numpy(), M, atol=TOL)


def test_svd3x3_batched_equals_per_matrix():
    names = sorted(MATRICES)
    stack = torch.from_numpy(np.stack([MATRICES[k] for k in names]))
    U, S, Vt = t_svd3x3(stack)
    for i, k in enumerate(names):
        u, s, vt = t_svd3x3(torch.from_numpy(MATRICES[k]))
        np.testing.assert_allclose(U[i].numpy(), u.numpy(), atol=1e-6)
        np.testing.assert_allclose(S[i].numpy(), s.numpy(), atol=1e-6)
        np.testing.assert_allclose(Vt[i].numpy(), vt.numpy(), atol=1e-6)


def _correspondences(seed, n=200, scale=20.0, noise=0.01):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32)
    R = _rot(rng)
    dst = (src @ R.T + rng.normal(size=3)
           + noise * rng.normal(size=(n, 3))).astype(np.float32)
    w = (rng.uniform(size=n) > 0.3).astype(np.float32)
    return src, dst, w


@pytest.mark.parametrize("weighted", [False, True])
def test_estimate_rigid_transform_matches_reference(weighted):
    src, dst, w = _correspondences(2)
    w_j = jnp.asarray(w) if weighted else None
    w_t = torch.from_numpy(w) if weighted else None
    T_j = np.asarray(j_tf.estimate_rigid_transform(jnp.asarray(src),
                                                   jnp.asarray(dst), w_j))
    T_t = t_tf.estimate_rigid_transform(torch.from_numpy(src),
                                        torch.from_numpy(dst), w_t).numpy()
    np.testing.assert_allclose(T_t, T_j, atol=TOL)


def test_estimate_rigid_transform_batched():
    """A leading batch axis gives each lane its own Kabsch solve."""
    pairs = [_correspondences(s, n=150) for s in (3, 4, 5)]
    src = torch.from_numpy(np.stack([p[0] for p in pairs]))
    dst = torch.from_numpy(np.stack([p[1] for p in pairs]))
    w = torch.from_numpy(np.stack([p[2] for p in pairs]))
    T_b = t_tf.estimate_rigid_transform(src, dst, w)
    for i, (s, d, wi) in enumerate(pairs):
        T_j = np.asarray(j_tf.estimate_rigid_transform(
            jnp.asarray(s), jnp.asarray(d), jnp.asarray(wi)))
        np.testing.assert_allclose(T_b[i].numpy(), T_j, atol=TOL)


def _moments(src, dst, w):
    sw = w.sum()
    sp = (src * w[:, None]).sum(0)
    sq = (dst * w[:, None]).sum(0)
    spq = (src * w[:, None]).T @ dst
    spp = (w * (src * src).sum(1)).sum()
    sqq = (w * (dst * dst).sum(1)).sum()
    return [np.float32(x) if np.ndim(x) == 0 else x.astype(np.float32)
            for x in (sw, sp, sq, spq, spp, sqq)]


def test_estimate_and_rmse_from_moments_match_reference():
    # Metre-scale centred clouds: the fp32 moment expansion cancels badly
    # at scene scale, on both sides alike.
    src, dst, w = _correspondences(6, scale=1.0, noise=0.05)
    src, dst = src - src.mean(0), dst - dst.mean(0)
    sw, sp, sq, spq, spp, sqq = _moments(src.astype(np.float64),
                                         dst.astype(np.float64), w)
    T_j = np.asarray(j_tf.estimate_from_moments(*(jnp.asarray(x) for x in
                                                  (sw, sp, sq, spq))))
    T_t = t_tf.estimate_from_moments(*(torch.as_tensor(x) for x in
                                       (sw, sp, sq, spq))).numpy()
    np.testing.assert_allclose(T_t, T_j, atol=TOL)
    args = (sw, sp, sq, spq, spp, sqq)
    r_j = float(j_tf.rmse_from_moments(jnp.asarray(T_j),
                                       *(jnp.asarray(x) for x in args)))
    r_t = float(t_tf.rmse_from_moments(torch.from_numpy(T_t),
                                       *(torch.as_tensor(x) for x in args)))
    assert r_t == pytest.approx(r_j, abs=TOL)
    # ... and equals the rmse of the transformed pairs.
    moved = t_tf.transform_points(torch.from_numpy(T_t), torch.from_numpy(src))
    direct = float(t_tf.rmse(moved, torch.from_numpy(dst),
                             torch.from_numpy(w)))
    assert r_t == pytest.approx(direct, abs=1e-3)


def test_transform_delta_rmse_and_points_match_reference():
    rng = np.random.default_rng(7)
    axis = rng.normal(size=3).astype(np.float32)
    R_j = j_tf.rotation_from_axis_angle(jnp.asarray(axis), 0.3)
    R_t = t_tf.rotation_from_axis_angle(torch.from_numpy(axis), 0.3)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=TOL)
    t = rng.normal(size=3).astype(np.float32)
    T_j = j_tf.make_transform(R_j, jnp.asarray(t))
    T_t = t_tf.make_transform(R_t, torch.from_numpy(t))
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=TOL)
    assert float(t_tf.transform_delta(T_t)) == pytest.approx(
        float(j_tf.transform_delta(T_j)), abs=TOL)
    pts = rng.uniform(-30, 30, size=(50, 3)).astype(np.float32)
    p_j = np.asarray(j_tf.transform_points(T_j, jnp.asarray(pts)))
    p_t = t_tf.transform_points(T_t, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(p_t, p_j, atol=1e-4)  # 30 m coordinates
    q = pts + 0.1
    w = (rng.uniform(size=50) > 0.5).astype(np.float32)
    assert float(t_tf.rmse(torch.from_numpy(pts), torch.from_numpy(q),
                           torch.from_numpy(w))) == pytest.approx(
        float(j_tf.rmse(jnp.asarray(pts), jnp.asarray(q), jnp.asarray(w))),
        abs=TOL)
