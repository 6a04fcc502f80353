"""Port vs reference: registration-health verdicts.

``assess_registration`` runs on the port's ``ICPResult`` (CPU tensors) and
on the reference's (JAX arrays) built from the same values; the
``RegistrationHealth`` must be equal in every field, ``reasons`` included.
Each signal is driven at, just under and just over each of its thresholds.
``pose_jump``, ``plane_normal_matrix`` and ``normal_equation_condition``
must give the same bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.core import health as jh
from repro.core.icp import ICPResult as JResult
from repro_torch.core import health as th
from repro_torch.core.icp import ICPResult, result_to_numpy

T_DEF = th.HealthThresholds()


def _results(T=None, rmse=0.05, inlier_frac=0.9, degenerate=False):
    T = np.eye(4, dtype=np.float32) if T is None else np.asarray(T,
                                                                 np.float32)
    vals = dict(T=T, rmse=np.float32(rmse), iterations=np.int32(7),
                converged=np.bool_(not degenerate),
                inlier_frac=np.float32(inlier_frac),
                degenerate=np.bool_(degenerate))
    port = ICPResult(**{k: torch.as_tensor(v) for k, v in vals.items()})
    ref = JResult(**{k: jnp.asarray(v) for k, v in vals.items()})
    return port, ref


def _same_health(a, b):
    assert a._fields == b._fields
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, float) and np.isnan(x):
            assert isinstance(y, float) and np.isnan(y), name
        else:
            assert x == y and type(x) is type(y), (name, x, y)


def _around(t, dtype=np.float64):
    """``t`` (in ``dtype``) and its two neighbours."""
    t = dtype(t)
    return (np.nextafter(t, dtype(-np.inf)), t,
            np.nextafter(t, dtype(np.inf)))


def _translation(x):
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = x
    return T


def _rotation(angle):
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(angle), np.sin(angle)
    T[:2, :2] = [[c, -s], [s, c]]
    return T


def _cases():
    cases = [("clean", {}, {}), ("degenerate", dict(degenerate=True), {}),
             ("rmse_inf", dict(rmse=np.inf), {}),
             ("rmse_nan", dict(rmse=np.nan), {}),
             ("nonfinite_pose", dict(T=np.full((4, 4), np.nan)), {}),
             ("no_prediction", {}, dict(predicted=None))]
    for level in ("suspect", "failed"):
        for name in ("inlier_frac", "rmse"):
            t = getattr(T_DEF, f"{level}_{name}")
            for k, v in enumerate(_around(t, np.float32)):
                cases.append((f"{level}_{name}_{k}", {name: v}, {}))
        t = getattr(T_DEF, f"{level}_pose_jump")
        for k, v in enumerate(_around(t, np.float32)):
            cases.append((f"{level}_pose_jump_{k}",
                          dict(T=_translation(v)), {}))
        t = getattr(T_DEF, f"{level}_rot_jump")
        for k, v in enumerate((t * (1 - 1e-4), t, t * (1 + 1e-4))):
            cases.append((f"{level}_rot_jump_{k}", dict(T=_rotation(v)),
                          {}))
        for name in ("out_of_lattice", "condition"):
            t = getattr(T_DEF, f"{level}_{name}")
            if np.isfinite(t):
                for k, v in enumerate(_around(t)):
                    cases.append((f"{level}_{name}_{k}", {},
                                  {name: float(v)}))
    cases.append(("condition_inf", {}, dict(condition=float("inf"))))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name,res_kw,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_assess_matches_reference(name, res_kw, kw):
    port, ref = _results(**res_kw)
    kw = dict(dict(predicted=np.eye(4)), **kw)
    _same_health(th.assess_registration(port, **kw),
                 jh.assess_registration(ref, **kw))


def test_custom_thresholds_from_reference():
    jt = jh.HealthThresholds(suspect_rmse=0.3, failed_condition=1e5,
                             suspect_inlier_frac=0.5)
    tt = th.health_thresholds_from_reference(jt._asdict())
    assert tuple(tt) == tuple(jt)
    port, ref = _results(rmse=0.4, inlier_frac=0.45)
    kw = dict(predicted=_translation(0.5), condition=2e5,
              out_of_lattice=0.3)
    _same_health(th.assess_registration(port, thresholds=tt, **kw),
                 jh.assess_registration(ref, thresholds=jt, **kw))
    with pytest.raises(ValueError):
        th.health_thresholds_from_reference(dict(jt._asdict(), bogus=1.0))


def test_host_result_keeps_bits_and_dtypes():
    port, _ = _results(T=_rotation(0.3), rmse=0.123456789,
                       inlier_frac=0.3333333)
    host = th.host_result(port)
    want = result_to_numpy(port)
    assert type(host) is ICPResult
    for a, b in zip(host, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    fake = object()
    assert th.host_result(fake) is fake


def test_helpers_bit_identical():
    rng = np.random.default_rng(0)
    for _ in range(5):
        A = _rotation(rng.uniform(-1, 1)) @ _translation(rng.uniform(-3, 3))
        B = _rotation(rng.uniform(-1, 1))
        assert th.pose_jump(A, B) == jh.pose_jump(A, B)
    p = rng.uniform(-10, 10, (200, 3)).astype(np.float32)
    n = rng.normal(size=(200, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    valid = rng.random(200) < 0.8
    w = rng.random(200).astype(np.float32)
    for kw in ({}, dict(valid=valid), dict(valid=valid, weights=w)):
        At = th.plane_normal_matrix(p, n, **kw)
        Aj = jh.plane_normal_matrix(p, n, **kw)
        assert np.array_equal(At, Aj)
        assert th.normal_equation_condition(At) == \
            jh.normal_equation_condition(Aj)
