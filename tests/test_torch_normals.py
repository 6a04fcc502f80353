"""Port vs reference: surface normals and the normals moment sweep.

Seeded numpy clouds go through ``repro.data.normals`` (JAX, CPU, its XLA
path), ``repro.kernels.normals.estimate_normals_pallas`` (Pallas in
interpret mode) and ``repro_torch.data.normals`` (PyTorch, CPU: the moment
sweep's plain version). Normals agree within 1e-4 on rows valid in both,
with equal validity masks (the bar of ``tests/test_normals.py`` for the
reference's kernel against its XLA path); the moment sums within 1e-5
relative to their magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (imports repro.data.normals in order)
from repro.data.normals import NormalParams as JNormalParams
from repro.data.normals import estimate_normals as j_estimate
from repro.data.normals import estimate_normals_batch as j_estimate_batch
from repro.kernels.normals import estimate_normals_pallas, moment_sweep_kernel
from repro_torch.core.nn_search_grid import _MASK_COORD
from repro_torch.data.collate import PAD_SENTINEL
from repro_torch.data.normals import (NormalParams, estimate_normals,
                                      knn_slots,
                                      moments_to_normals,
                                      normal_params_from_reference,
                                      split_moments)
from repro_torch.kernels import ref
from repro_torch.kernels.normals import estimate_normals_radius, moment_sweep

GRID = dict(voxel_size=1.0, grid_dims=(32, 32, 16), chunk=512)
NORMAL_TOL = 1e-4


def _plane_cloud(n=1500, seed=0, normal=(0.3, -0.2, 1.0), z0=4.0,
                 noise=0.01):
    """Points near the plane n·x = n_z·z0 in a 20 m square patch."""
    rng = np.random.default_rng(seed)
    nv = np.asarray(normal, np.float64)
    nv = nv / np.linalg.norm(nv)
    xy = rng.uniform(-10, 10, (n, 2))
    z = z0 - (nv[0] * xy[:, 0] + nv[1] * xy[:, 1]) / nv[2]
    pts = np.column_stack([xy, z]) + rng.normal(0, noise, (n, 3))
    return pts.astype(np.float32), nv.astype(np.float32)


def _both(params: NormalParams):
    return params, JNormalParams(**params._asdict())


def assert_normals_match(got, want):
    """Equal validity masks; normals within NORMAL_TOL where valid."""
    (n_t, v_t), (n_j, v_j) = got, want
    n_t, v_t = n_t.numpy(), v_t.numpy()
    n_j, v_j = np.asarray(n_j), np.asarray(v_j)
    np.testing.assert_array_equal(v_t, v_j)
    assert v_t.mean() > 0.5
    np.testing.assert_allclose(n_t[v_t], n_j[v_t], atol=NORMAL_TOL)
    np.testing.assert_array_equal(n_t[~v_t], 0.0)


@pytest.mark.parametrize("neighborhood", ["knn", "radius"])
def test_normals_match_reference(neighborhood):
    pts, n_true = _plane_cloud()
    params, jparams = _both(NormalParams(neighborhood=neighborhood, k=16,
                                         radius=0.8, **GRID))
    got = estimate_normals(torch.from_numpy(pts), params)
    assert_normals_match(got, j_estimate(jnp.asarray(pts), jparams))
    dots = np.abs(got[0].numpy()[got[1].numpy()] @ n_true)
    assert np.median(dots) > 0.999


def test_radius_normals_match_pallas_interpret():
    """The radius path (the moment sweep's plain version) against the
    reference's kernel, whose epilogue is shared with its XLA path."""
    pts, _ = _plane_cloud(seed=3)
    params, jparams = _both(NormalParams(neighborhood="radius", radius=0.8,
                                         **GRID))
    got = estimate_normals_radius(torch.from_numpy(pts), params)
    want = jax.jit(lambda p: estimate_normals_pallas(
        p, jparams, interpret=True))(jnp.asarray(pts))
    assert_normals_match(got, want)


def test_estimate_normals_radius_requires_radius_mode():
    pts, _ = _plane_cloud(n=200)
    with pytest.raises(ValueError, match="radius-mode"):
        estimate_normals_radius(torch.from_numpy(pts),
                                NormalParams(neighborhood="knn", **GRID))
    with pytest.raises(ValueError, match="unknown neighborhood"):
        estimate_normals(torch.from_numpy(pts),
                         NormalParams(neighborhood="ball", **GRID))


def _candidate_rows(seed, n=200, ck=96):
    """Per-query candidate rows at scene-scale coordinates; rows 0 mod 9
    are empty (sentinel only) and a quarter of the other slots masked."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    cand = (q[:, None, :] + rng.normal(0, 0.7, (n, ck, 3))).astype(np.float32)
    cand[rng.uniform(size=(n, ck)) < 0.25] = _MASK_COORD
    cand[::9] = _MASK_COORD
    return q, cand


def test_moment_sums_match_pallas_interpret():
    q, cand = _candidate_rows(0, n=256, ck=128)
    m = moment_sweep(torch.from_numpy(q), torch.from_numpy(cand), 0.9)
    assert m.shape == (256, 10)
    cnt_j, s_j, ss_j = moment_sweep_kernel(jnp.asarray(q), jnp.asarray(cand),
                                           0.9, bn=128, bc=64,
                                           interpret=True)
    cnt, s, ss = split_moments(m)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    for got, want in ((s, s_j), (ss, ss_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    # empty neighbourhoods: the count and all ten sums exactly 0
    assert bool((m[::9] == 0).all())


def test_moment_sweep_lane_order_against_plain_sums():
    """The plain version adds in the kernel's lane order; against a
    straight sum over the candidate axis it differs only by rounding
    (1e-5 relative), and a ragged CK (not a multiple of 32) is padded
    with exact zeros."""
    q, cand = _candidate_rows(1, n=120, ck=75)
    qt, ct = torch.from_numpy(q), torch.from_numpy(cand)
    m = ref.normal_moments(qt, ct, 1.0)
    d = (ct - qt[:, None, :]).double()
    w = ((d * d).sum(-1) <= 1.0).double()
    dx, dy, dz = d.unbind(-1)
    plain = torch.stack([w, w * dx, w * dy, w * dz, w * dx * dx, w * dy * dy,
                         w * dz * dz, w * dx * dy, w * dx * dz, w * dy * dz],
                        -1).sum(-2)
    torch.testing.assert_close(m.double(), plain, rtol=1e-5,
                               atol=1e-5 * float(plain.abs().max()))
    # batched rows equal per-lane rows, bit for bit
    mb = ref.normal_moments(qt.view(2, 60, 3), ct.view(2, 60, 75, 3), 1.0)
    assert torch.equal(mb.view(120, 10), m)


def test_knn_slots_keep_lower_slot_first_on_ties():
    """torch.topk promises no order on ties; the port's stable sort gives
    lax.top_k(-d2, k)'s order: equal distances, lower slot first."""
    rng = np.random.default_rng(4)
    d2 = rng.integers(0, 4, (64, 40)).astype(np.float32)  # many ties
    got = knn_slots(torch.from_numpy(d2), 9).numpy()
    _, want = jax.lax.top_k(-jnp.asarray(d2), 9)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_knn_normals_with_duplicated_points_match_reference():
    """Every point three times: each query has three candidates at exactly
    d² = 0 and every neighbour ties with its copies."""
    pts, _ = _plane_cloud(n=500, seed=5)
    dup = np.concatenate([pts] * 3)
    params, jparams = _both(NormalParams(k=16, **GRID))
    got = estimate_normals(torch.from_numpy(dup), params)
    assert_normals_match(got, j_estimate(jnp.asarray(dup), jparams))
    # the copies of a point get the same normal
    n = got[0].numpy()
    np.testing.assert_array_equal(n[:500], n[500:1000])


def test_padded_rows_masked_and_harmless():
    pts, _ = _plane_cloud(n=500)
    padded = np.concatenate([pts, np.full((100, 3), PAD_SENTINEL,
                                          np.float32)])
    valid = np.concatenate([np.ones(500, bool), np.zeros(100, bool)])
    params, jparams = _both(NormalParams(**GRID))
    got = estimate_normals(torch.from_numpy(padded), params,
                           valid=torch.from_numpy(valid))
    assert_normals_match(got, j_estimate(jnp.asarray(padded), jparams,
                                         valid=jnp.asarray(valid)))
    assert not bool(got[1][500:].any())
    alone = estimate_normals(torch.from_numpy(pts), params)
    both = got[1][:500] & alone[1]
    np.testing.assert_allclose(got[0][:500][both].numpy(),
                               alone[0][both].numpy(), atol=NORMAL_TOL)


def test_sparse_patch_within_the_references_own_spread():
    """At 600 points a few 3-point neighbourhoods are nearly collinear (the
    middle singular value just above the 1e-5 validity bar), and their
    normals move by more than the 1e-4 bar between summation orders: the
    reference's own XLA and Pallas paths differ by more than it. There the
    port's radius path, the Pallas kernel's counterpart, is held to be no
    farther from the Pallas path than the XLA path is."""
    pts, _ = _plane_cloud(n=600, seed=2, normal=(0.0, 0.4, 1.0))
    params, jparams = _both(NormalParams(neighborhood="radius", radius=0.8,
                                         **GRID))
    n_t, v_t = estimate_normals(torch.from_numpy(pts), params)
    n_x, v_x = j_estimate(jnp.asarray(pts), jparams)
    n_p, v_p = estimate_normals_pallas(jnp.asarray(pts), jparams,
                                       interpret=True)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_x))
    np.testing.assert_array_equal(np.asarray(v_p), np.asarray(v_x))
    spread = float(np.abs(np.asarray(n_x) - np.asarray(n_p)).max())
    assert spread > NORMAL_TOL
    assert float(np.abs(n_t.numpy() - np.asarray(n_p)).max()) <= spread


@pytest.mark.parametrize("neighborhood", ["knn", "radius"])
def test_batch_equals_per_frame_and_reference(neighborhood):
    """At the reference's parity density (1,500 points); sparser patches
    are ill-conditioned in both packages (the test above)."""
    a, _ = _plane_cloud(n=1500, seed=1)
    b, _ = _plane_cloud(n=1500, seed=2, normal=(0.0, 0.4, 1.0))
    batch = np.stack([a, b])
    params, jparams = _both(NormalParams(neighborhood=neighborhood,
                                         radius=0.8, **GRID))
    n_b, v_b = estimate_normals(torch.from_numpy(batch), params)
    want = j_estimate_batch(jnp.asarray(batch), jparams)
    for i, cloud in enumerate((a, b)):
        n_1, v_1 = estimate_normals(torch.from_numpy(cloud), params)
        assert torch.equal(v_b[i], v_1)
        torch.testing.assert_close(n_b[i], n_1, atol=1e-6, rtol=0)
        assert_normals_match((n_b[i], v_b[i]),
                             (np.asarray(want[0][i]), np.asarray(want[1][i])))


def test_degenerate_line_and_empty_moments_are_invalid():
    t = np.linspace(0, 5, 64, dtype=np.float32)
    line = np.stack([t, 0.3 * t, 0.1 * t], axis=1)
    normals, valid = estimate_normals(torch.from_numpy(line),
                                      NormalParams(k=8, **GRID))
    assert not bool(valid.any())
    assert bool((normals == 0).all())
    normals, valid = moments_to_normals(torch.zeros(4), torch.zeros(4, 3),
                                        torch.zeros(4, 3, 3))
    assert not bool(valid.any()) and bool((normals == 0).all())


def test_orientation_toward_viewpoint():
    pts, n_true = _plane_cloud(z0=5.0, n=800)
    normals, valid = estimate_normals(torch.from_numpy(pts),
                                      NormalParams(**GRID))
    assert (normals[valid].numpy() @ n_true < 0).mean() > 0.99
    up, _ = estimate_normals(torch.from_numpy(pts), NormalParams(**GRID),
                             viewpoint=torch.tensor([0.0, 0.0, 100.0]))
    assert (up[valid].numpy() @ n_true > 0).mean() > 0.99


def test_normal_params_from_reference():
    jp = JNormalParams(k=8, neighborhood="radius", grid_dims=[64, 64, 16])
    assert normal_params_from_reference(jp._asdict()) == NormalParams(
        k=8, neighborhood="radius", grid_dims=(64, 64, 16))
    assert normal_params_from_reference(JNormalParams()._asdict()) \
        == NormalParams()
    with pytest.raises(ValueError, match="new_knob"):
        normal_params_from_reference({**JNormalParams()._asdict(),
                                      "new_knob": 1})
