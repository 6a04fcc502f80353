"""Slice 7 of the port against the reference, on the CPU at small sizes: the
public functions the drivers need (``random_rigid_transform``,
``pairwise_sq_dists``, ``estimate_normals_batch``, ``make_frame_engine``),
the fused kernel's cost and resource models, the three examples
(``repro_torch.examples``) and the fused kernel's autotune tool
(``repro_torch.tools.autotune_fused``). Both packages run in this process on
the same numpy inputs.

``random_rigid_transform`` draws from a torch generator, so it is held to
the reference's contract (a rotation within the angle, a translation within
the bound, one draw per seed), not to its JAX draws. Tolerances:
``pairwise_sq_dists`` rtol 1e-5, atol 1e-3 (the matmul
expansion's fp32 noise at 30 m); normals 1e-4 where valid in both, at 1,500
points (the reference's parity density); ``make_frame_engine``'s d² 1e-4,
its indices equal except where the two candidates' d² lie within 1e-4 (a
near-tie); the quickstart's and the fleet's T within 1e-3 of the
reference's (the convergence parity bar); odometry's per-frame positions
within 0.05 m of the reference example's (the odometry band of PERF.md §2);
the cost models equal term for term where the port does the reference's
work. The autotune sweep runs its plain version here, where the launch
setting does not apply: its parity gate, winner rule, report and exit code
are what is checked.
"""
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

import repro.core as jcore
from repro.data.normals import NormalParams as JNormalParams
from repro.data.normals import estimate_normals_batch as j_normals_batch
from repro.data.pointcloud import SceneConfig as JSceneConfig
from repro.data.pointcloud import frame_pair as j_frame_pair
from repro.kernels.fused_icp import fused_cost_model as j_cost_model
from repro.kernels.ops import make_frame_engine as j_frame_engine
from repro_torch.core import pairwise_sq_dists, random_rigid_transform
from repro_torch.data.normals import NormalParams, estimate_normals_batch
from repro_torch.examples import fleet_registration, odometry, quickstart
from repro_torch.kernels import fused_icp
from repro_torch.kernels.ops import make_frame_engine, nn_search_cuda
from repro_torch.tools import autotune_fused

ROOT = pathlib.Path(__file__).resolve().parents[1]
T_TOL = 1e-3        # BENCH_convergence.json parity bar
ODOM_BAND_M = 0.05  # port vs reference positions (PERF.md §2)
NEAR_TIE = 1e-4


def _reference_example(name):
    """The reference's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rigid(rng, max_angle=0.3, max_translation=2.0):
    """A numpy float32 rigid transform (Rodrigues)."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = rng.uniform(-max_angle, max_angle)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
    T[:3, 3] = rng.uniform(-max_translation, max_translation, 3)
    return T.astype(np.float32)


# -- the missing public functions --------------------------------------------

@pytest.mark.parametrize("max_angle,max_translation", [(0.5, 1.0),
                                                       (0.1, 0.3)])
def test_random_rigid_transform(max_angle, max_translation):
    kw = dict(max_angle=max_angle, max_translation=max_translation)
    draws = [random_rigid_transform(
        generator=torch.Generator().manual_seed(s), **kw) for s in range(40)]
    again = random_rigid_transform(generator=torch.Generator().manual_seed(3),
                                   **kw)
    assert torch.equal(again, draws[3])            # the same draw per seed
    assert not torch.equal(draws[0], draws[1])
    for T in draws:
        assert T.shape == (4, 4) and T.dtype == torch.float32
        R = T[:3, :3].double()
        torch.testing.assert_close(R @ R.T, torch.eye(3, dtype=torch.float64),
                                   atol=1e-5, rtol=0)
        assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-5
        angle = float(torch.arccos(((R.trace() - 1) / 2).clamp(-1, 1)))
        assert angle <= max_angle + 1e-4
        assert float(T[:3, 3].abs().max()) <= max_translation
        assert torch.equal(T[3], torch.tensor([0.0, 0.0, 0.0, 1.0]))


def test_pairwise_sq_dists_matches_reference():
    rng = np.random.default_rng(1)
    src = rng.uniform(-30, 30, (300, 3)).astype(np.float32)
    dst = rng.uniform(-30, 30, (500, 3)).astype(np.float32)
    got = pairwise_sq_dists(torch.from_numpy(src), torch.from_numpy(dst))
    want = np.asarray(jcore.pairwise_sq_dists(jnp.asarray(src),
                                              jnp.asarray(dst)))
    assert got.shape == (300, 500) and float(got.min()) >= 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    batched = pairwise_sq_dists(torch.from_numpy(np.stack([src, src])),
                                torch.from_numpy(np.stack([dst, dst])))
    assert torch.equal(batched[1], got)


def test_estimate_normals_batch_matches_reference():
    rng = np.random.default_rng(2)
    clouds = []
    for normal in ((0.3, -0.2, 1.0), (-0.1, 0.4, 1.0)):
        nv = np.asarray(normal) / np.linalg.norm(normal)
        xy = rng.uniform(-10, 10, (1500, 2))
        z = 4.0 - (nv[0] * xy[:, 0] + nv[1] * xy[:, 1]) / nv[2]
        clouds.append(np.column_stack([xy, z]) + rng.normal(0, 0.01,
                                                           (1500, 3)))
    batch = np.stack(clouds).astype(np.float32)
    params = NormalParams(voxel_size=1.0, grid_dims=(32, 32, 16), chunk=512)
    normals, valid = estimate_normals_batch(torch.from_numpy(batch), params)
    j_n, j_v = j_normals_batch(jnp.asarray(batch),
                               JNormalParams(**params._asdict()))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_v))
    assert valid.numpy().mean() > 0.5
    v = valid.numpy()
    np.testing.assert_allclose(normals.numpy()[v], np.asarray(j_n)[v],
                               atol=1e-4)
    with pytest.raises(ValueError, match="B, N, 3"):
        estimate_normals_batch(torch.from_numpy(batch[0]), params)


def test_make_frame_engine_matches_reference():
    rng = np.random.default_rng(9)
    src = rng.uniform(-10, 10, (200, 3)).astype(np.float32)
    dst = rng.uniform(-10, 10, (700, 3)).astype(np.float32)
    T = _rigid(rng)
    nn_fn = make_frame_engine(torch.from_numpy(dst))
    d2, idx = nn_fn(torch.from_numpy(src), torch.from_numpy(T))
    j_d2, j_idx = j_frame_engine(jnp.asarray(dst), bn=128, bm=256,
                                 interpret=True)(jnp.asarray(src),
                                                 jnp.asarray(T))
    j_d2, j_idx = np.asarray(j_d2), np.asarray(j_idx)
    assert d2.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_allclose(d2.numpy(), j_d2, rtol=0, atol=1e-4)
    moved = src @ T[:3, :3].T + T[:3, 3]
    diff = idx.numpy() != j_idx
    gap = np.abs(((moved[diff] - dst[idx.numpy()[diff]]) ** 2).sum(-1)
                 - ((moved[diff] - dst[j_idx[diff]]) ** 2).sum(-1))
    assert np.all(gap <= NEAR_TIE), gap
    # The one-shot wrapper is the same search: the same bits.
    d2_o, idx_o = nn_search_cuda(torch.from_numpy(src), torch.from_numpy(dst),
                                 torch.from_numpy(T))
    assert torch.equal(d2, d2_o) and torch.equal(idx, idx_o)


# -- the fused kernel's cost and resource models -----------------------------

@pytest.mark.parametrize("plane", [False, True])
def test_fused_cost_model_matches_reference(plane):
    n, ck = 4096, 864
    got = fused_icp.fused_cost_model(n, ck, plane=plane)
    want = j_cost_model(n, ck, plane=plane)
    planes = len(fused_icp.moment_names(plane))
    f, c = got["fused"], got["chain"]
    ft, fb, cb = f["flops_terms"], f["bytes_terms"], c["bytes_terms"]
    # The reference's one-hot selects are the only FLOP it counts that the
    # port does not do; the port's torch.sum of the planes the only one it
    # adds.
    select = (2 + (6 if plane else 3)) * n * ck
    assert f["flops"] - ft["plane_sum"] == want["fused"]["flops"] - select
    assert ft["plane_sum"] == planes * n
    # Bytes: the same gather write, queries and plane write; the port's
    # kernel reads the coordinates (and one normal a query), and re-reads
    # the planes for the sum.
    assert (f["hbm_bytes"] - fb["plane_sum"] - fb["candidate_read"]
            + fb["gather_write"]) == want["fused"]["hbm_bytes"]
    if not plane:
        assert f["hbm_bytes"] - fb["plane_sum"] == want["fused"]["hbm_bytes"]
    # The chain: the same FLOP; bytes equal but for the gather and the
    # winner gather.
    assert c["flops"] == want["chain"]["flops"]
    cand = (6 if plane else 3) * n * ck * 4
    assert (c["hbm_bytes"] - cb["gather_write"] - cb["candidate_read"]
            - cb["winner_gather"]) == want["chain"]["hbm_bytes"] - 3 * cand
    for d in (f, c):
        assert d["flop_per_byte"] == d["flops"] / d["hbm_bytes"]
    assert got["hbm_ratio"] == c["hbm_bytes"] / f["hbm_bytes"]

    res = fused_icp.fused_resources(plane=plane, ck=ck)
    assert res["planes"] == planes and res["threads_per_block"] == 256
    assert res["read_bytes_per_query"] == 12 * ck + 16 + (12 if plane else 0)
    assert res["write_bytes_per_query"] == 4 * planes
    assert "card" not in res
    with pytest.raises(ValueError, match="CUDA device"):
        fused_icp.fused_resources(device="cpu")
    with pytest.raises(ValueError, match="warps_per_block"):
        fused_icp.fused_resources(fused_icp.FusedConfig(warps_per_block=3))


# -- the examples ------------------------------------------------------------

def test_quickstart_matches_reference_api():
    T = quickstart.main(["--device", "cpu"])
    cfg = JSceneConfig(n_ground=9000, n_walls=6000, n_poles=1800,
                       n_clutter=1700, extent=40.0, sensor_range=45.0)
    source, target, _ = j_frame_pair(seq=0, frame=3, cfg=cfg,
                                     n_source_samples=2048)
    icp = jcore.FppsICP()
    icp.setInputSource(source)
    icp.setInputTarget(target)
    icp.setMaxCorrespondenceDistance(1.0)
    icp.setMaxIterationCount(50)
    icp.setTransformationEpsilon(1e-5)
    T_ref = np.asarray(icp.align())
    assert np.abs(T - T_ref).max() <= T_TOL


def _spy(monkeypatch, module, seen):
    """Keep the poses of ``module``'s pipeline runs and the transforms of
    its engines' ``register_pairs``."""
    if hasattr(module, "OdometryPipeline"):
        class Pipeline(module.OdometryPipeline):
            def run(self, scans):
                poses, diags = super().run(scans)
                seen["poses"] = np.asarray(poses, np.float64)
                return poses, diags
        monkeypatch.setattr(module, "OdometryPipeline", Pipeline)
    get_engine = module.get_engine

    class Engine:
        def __init__(self, engine):
            self._engine = engine

        def __getattr__(self, name):
            return getattr(self._engine, name)

        def register_pairs(self, *a, **kw):
            res, batch = self._engine.register_pairs(*a, **kw)
            seen["T"] = np.asarray(res.T, np.float64)
            return res, batch
    monkeypatch.setattr(module, "get_engine",
                        lambda *a, **kw: Engine(get_engine(*a, **kw)))


def _positions(seen):
    """Per-frame positions of frames 1..F in frame-0 coordinates."""
    if "poses" in seen:
        return seen["poses"][1:, :3, 3]
    pose, out = np.eye(4), []
    for T in seen["T"]:
        pose = pose @ np.linalg.inv(T)
        out.append(pose[:3, 3])
    return np.stack(out)


@pytest.mark.parametrize("mode", ["scan_to_map", "frame_to_frame"])
def test_odometry_matches_reference_example(monkeypatch, mode):
    argv = ["--frames", "3", "--samples", "512", "--mode", mode]
    got, want = {}, {}
    _spy(monkeypatch, odometry, got)
    drift = odometry.main(argv + ["--device", "cpu"])
    reference = _reference_example("odometry")
    _spy(monkeypatch, reference, want)
    reference.main(argv)
    assert drift.shape == (3,)
    pos, pos_ref = _positions(got), _positions(want)
    assert pos.shape == pos_ref.shape == (3, 3)
    gap = np.linalg.norm(pos - pos_ref, axis=1)
    assert gap.max() <= ODOM_BAND_M, gap


@pytest.mark.parametrize("engine", ["cuda", "distributed"])
def test_fleet_matches_reference_xla(monkeypatch, engine):
    got = {}
    _spy(monkeypatch, fleet_registration, got)
    errs = fleet_registration.main(["--frames", "3", "--points", "384",
                                    "--engine", engine, "--device", "cpu"])
    pairs, gts = fleet_registration.fleet_pairs(3, 384)
    assert [len(d) for _, d in pairs] == [384, 347, 310]
    res, _ = jcore.get_engine("xla", chunk=256).register_pairs(
        pairs, jcore.ICPParams(max_iterations=25, chunk=256))
    T_ref = np.asarray(res.T)
    assert np.abs(got["T"] - T_ref).max() <= T_TOL
    assert errs == [float(np.abs(got["T"][i] - gts[i]).max())
                    for i in range(3)]
    assert max(errs) < 0.05


def test_entry_points_default_to_cuda():
    """Without a card every driver raises rather than fall back to the
    CPU (``--device cpu`` asks for the plain path)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    runs = ((quickstart.main, []),
            (odometry.main, ["--frames", "1"]),
            (odometry.main, ["--frames", "1", "--mode", "frame_to_frame"]),
            (fleet_registration.main, ["--frames", "1", "--points", "64"]),
            (autotune_fused.main, ["--m", "64", "--samples", "32"]))
    for main, argv in runs:
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)


# -- the autotune sweep --------------------------------------------------------

SMALL = ["--m", "2048", "--samples", "256", "--device", "cpu"]


def _fake_times(fast):
    """A ``time_setting`` that gives the setting ``fast`` 0.001 ms and every
    other 1 ms (settings are timed in ``settings()`` order)."""
    order = iter(autotune_fused.settings())

    def time_setting(iteration, planes, device):
        t = 0.001 if next(order) == fast else 1.0
        return {f"{k}{s}": t for k in ("iter_ms", "pass_ms")
                for s in ("", "_min", "_max")} | dict(
            iter_device_only=False, pass_device_only=False)
    return time_setting


def test_autotune_report_on_cpu(tmp_path):
    out = tmp_path / "autotune.json"
    assert autotune_fused.main(SMALL + ["--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["device"] == "cpu" and report["card"] is None
    assert report["times_rank_nothing"] is True
    assert (report["n"], report["m"], report["ck"]) == (256, 2048, 864)
    assert report["default"] == {"warps_per_block": 8, "prune": False}
    rows = report["configs"]
    assert [(r["warps_per_block"], r["prune"]) for r in rows] == [
        (w, p) for w in (2, 4, 8, 16) for p in (False, True)]
    for r in rows:
        assert r["parity_ok"] and r["planes_bit_equal"] and r["T_bit_equal"]
        assert r["transform_diff"] == 0.0
        assert r["iter_ms"] > 0 and r["pass_ms"] > 0
        assert r["resources"]["threads_per_block"] == 32 * r[
            "warps_per_block"]
    assert set(report["best"]) == {"warps_per_block", "prune", "iter_ms",
                                   "pass_ms"}
    with pytest.raises(ValueError, match="committed"):
        autotune_fused.sweep(2048, 256, device="cpu",
                             out_json=tmp_path / "BENCH_fused_autotune.json")


def test_autotune_refuses_a_differing_setting(monkeypatch, tmp_path):
    bad = fused_icp.FusedConfig(warps_per_block=4, prune=False)
    planes = fused_icp.moment_planes

    def differing(*a, warps_per_block, **kw):
        out = planes(*a, warps_per_block=warps_per_block, **kw)
        if warps_per_block == bad.warps_per_block and not kw["prune"]:
            out = out.clone()
            out[..., 0] += 1.0
        return out
    monkeypatch.setattr(fused_icp, "moment_planes", differing)
    monkeypatch.setattr(autotune_fused, "time_setting", _fake_times(bad))
    report = autotune_fused.sweep(2048, 256, device="cpu",
                                  out_json=tmp_path / "r.json")
    row = next(r for r in report["configs"]
               if (r["warps_per_block"], r["prune"]) == tuple(bad))
    assert not (row["parity_ok"] or row["planes_bit_equal"]
                or row["T_bit_equal"])
    assert row["iter_ms"] == 0.001   # the fastest, and it cannot win
    assert (report["best"]["warps_per_block"], report["best"]["prune"]) != \
        tuple(bad)
    assert sum(not r["parity_ok"] for r in report["configs"]) == 1

    def every(*a, **kw):
        out = planes(*a, **kw).clone()
        out[..., 0] += 1.0
        return out
    monkeypatch.setattr(fused_icp, "moment_planes", every)
    monkeypatch.setattr(autotune_fused, "time_setting", _fake_times(bad))
    with pytest.raises(RuntimeError, match="every setting failed"):
        autotune_fused.sweep(2048, 256, device="cpu")


@pytest.mark.parametrize("fast,rc", [(fused_icp.DEFAULT_CONFIG, 0),
                                     (fused_icp.FusedConfig(16, True), 1)])
def test_autotune_apply_exit_code(monkeypatch, tmp_path, fast, rc):
    monkeypatch.setattr(autotune_fused, "time_setting", _fake_times(fast))
    out = tmp_path / "r.json"
    assert autotune_fused.main(SMALL + ["--out", str(out), "--apply"]) == rc
    report = json.loads(out.read_text())
    assert report["default_is_best"] is (rc == 0)
    assert (report["best"]["warps_per_block"], report["best"]["prune"]) == \
        tuple(fast)
