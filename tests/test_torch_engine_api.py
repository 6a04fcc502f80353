"""Port vs reference: engines, the Table-I API, the device rule and the
package boundary.

``FppsICP(engine="torch", device="cpu")`` is held to the reference's
``FppsICP("xla")`` and ``FppsICP(engine="cuda", device="cpu")`` (the kernel
wrapper's plain path) to the reference's Pallas engine in interpret mode,
both on ``small_scene`` at <= 20 iterations: rotation and translation
within 1e-3.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.data.collate as j_collate
import repro.data.pointcloud as j_pointcloud
import repro_torch.data.collate as t_collate
import repro_torch.data.pointcloud as t_pointcloud
from repro.core import FppsICP as JFppsICP
from repro.core.baseline import kdtree_icp as j_kdtree_icp
from repro.core.engine import PallasEngine
from repro_torch.core import FppsICP, ICPParams, get_engine, icp
from repro_torch.core.baseline import kdtree_icp
from repro_torch.core.engine import KernelEngine, TorchEngine
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.nn_search import nn_search_kernel

ROOT = pathlib.Path(__file__).resolve().parent.parent
PARITY = 1e-3


def rt_diff(Ta, Tb):
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    # ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2): well conditioned near 0,
    # unlike arccos of the trace.
    chord = np.linalg.norm(Ta[:3, :3] - Tb[:3, :3]) / (2.0 * np.sqrt(2.0))
    return (float(2.0 * np.arcsin(min(chord, 1.0))),
            float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])))


def _align(reg, src, dst, iters=20):
    reg.setInputSource(src)
    reg.setInputTarget(dst)
    reg.setMaxCorrespondenceDistance(1.0)
    reg.setMaxIterationCount(iters)
    reg.setTransformationEpsilon(1e-5)
    return reg.align()


@pytest.mark.parametrize("port_engine,ref_engine", [
    ("torch", "xla"),
    ("cuda", "pallas-interpret"),
])
def test_fppsicp_align_matches_reference(small_scene, port_engine,
                                         ref_engine):
    src, dst, T_gt = small_scene
    ref = (JFppsICP(engine=PallasEngine(interpret=True))
           if ref_engine == "pallas-interpret" else JFppsICP(engine="xla"))
    T_j = _align(ref, src, dst)
    port = FppsICP(engine=port_engine, device="cpu")
    before = nn_search_kernel.launches
    T_t = _align(port, src, dst)
    rot, trans = rt_diff(T_t, T_j)
    assert rot <= PARITY and trans <= PARITY, (rot, trans)
    assert isinstance(T_t, np.ndarray) and T_t.dtype == np.float32
    assert port.hasConverged() == ref.hasConverged()
    assert port.getFitnessScore() == pytest.approx(ref.getFitnessScore(),
                                                   abs=PARITY)
    assert abs(int(port.last_result.iterations)
               - int(ref.last_result.iterations)) <= 1
    rot, trans = rt_diff(T_t, T_gt)
    assert rot < 0.01 and trans < 0.05
    assert nn_search_kernel.launches == before  # no card: no launches


def test_fppsicp_warm_start_and_settings(small_scene):
    src, dst, T_gt = small_scene
    reg = FppsICP(engine="torch", device="cpu")
    reg.setTransformationMatrix(T_gt.astype(np.float64))
    reg.setRobustKernel("huber", 0.3)
    T = _align(reg, src, dst, iters=5)
    rot, trans = rt_diff(T, T_gt)
    assert rot < 0.01 and trans < 0.05
    assert reg.engine.device == torch.device("cpu")
    with pytest.raises(ValueError):
        reg.setMinimizer("bogus")
    with pytest.raises(ValueError):
        reg.setRobustKernel("bogus")
    reg.setMinimizer("point_to_plane")  # registers from the warm start
    T = _align(reg, src, dst, iters=5)
    rot, trans = rt_diff(T, T_gt)
    assert rot < 0.01 and trans < 0.05
    assert reg.hasConverged()
    with pytest.raises(ValueError):
        FppsICP(engine="torch", device="cpu").align()


def _pair(seed, n, m):
    rng = np.random.default_rng(seed)
    dst = rng.uniform(-10, 10, size=(m, 3)).astype(np.float32)
    a = rng.uniform(-0.1, 0.1)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]])
    t = rng.uniform(-0.3, 0.3, size=3)
    sel = rng.choice(m, size=n, replace=False)
    src = ((dst[sel] - t) @ R + 0.005 * rng.normal(size=(n, 3)))
    return src.astype(np.float32), dst


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_register_pairs_mixed_sizes_matches_per_pair(engine):
    """Collated, padded, one batch vs the unpadded per-pair loop."""
    sizes = [(180, 300), (220, 340), (150, 260)]
    pairs = [_pair(k, n, m) for k, (n, m) in enumerate(sizes)]
    eng = get_engine(engine, device="cpu", chunk=256)
    params = ICPParams(max_iterations=20, chunk=256)
    res, batch = eng.register_pairs(pairs, params)
    assert batch.src_sizes == (180, 220, 150)
    assert res.T.shape == (3, 4, 4)
    for i, (s, d) in enumerate(pairs):
        one = icp(torch.from_numpy(s), torch.from_numpy(d), params)
        np.testing.assert_allclose(res.T[i].numpy(), one.T.numpy(), atol=1e-4)
        assert float(res.inlier_frac[i]) == pytest.approx(
            float(one.inlier_frac), abs=1e-5)
        single = eng.register(s, d, params)  # bucketed on the device
        np.testing.assert_allclose(single.T.numpy(), one.T.numpy(),
                                   atol=1e-4)


def test_register_batch_warm_start_is_pinned_to_f32():
    pairs = [_pair(k, 200, 300) for k in (7, 8)]
    eng = TorchEngine(chunk=256, device="cpu")
    params = ICPParams(max_iterations=20, chunk=256)
    cold, _ = eng.register_pairs(pairs, params)
    warm, _ = eng.register_pairs(pairs, params,
                                 initial_transforms=cold.T.double().numpy())
    assert warm.T.dtype == torch.float32
    assert int(warm.iterations.sum()) < int(cold.iterations.sum())
    np.testing.assert_allclose(warm.T.numpy(), cold.T.numpy(), atol=1e-2)


def test_kernel_engine_masks_nan_target_rows(small_scene):
    src, dst, _ = small_scene
    dirty = dst.copy()
    dirty[::50] = np.nan
    eng = KernelEngine(device="cpu")
    params = ICPParams(max_iterations=20)
    res = eng.register(src, dirty, params)
    clean = eng.register(src, np.delete(dst, np.s_[::50], 0), params)
    assert torch.isfinite(res.T).all()
    rot, trans = rt_diff(res.T.numpy(), clean.T.numpy())
    assert rot <= 1e-5 and trans <= 1e-5


# -- the device rule ---------------------------------------------------------

def test_default_device_without_cuda_raises(monkeypatch):
    """Every public entry point defaults to CUDA and refuses to move to the
    CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        FppsICP()
    with pytest.raises(RuntimeError, match="cuda"):
        get_engine("torch")
    with pytest.raises(RuntimeError, match="cuda"):
        KernelEngine()
    eng = TorchEngine(device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        eng.register(np.zeros((4, 3)), np.zeros((4, 3)), device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_engine_registry():
    assert get_engine("torch", device="cpu") is get_engine("torch",
                                                           device="cpu")
    assert isinstance(get_engine("cuda", device="cpu"), KernelEngine)
    assert get_engine("pyramid", device="cpu").name == "pyramid"
    for name in ("distributed", "slots", "sharded-slots"):
        with pytest.raises(NotImplementedError, match="slice"):
            get_engine(name, device="cpu")
    with pytest.raises(ValueError):
        get_engine("bogus", device="cpu")
    with pytest.raises(TypeError):
        get_engine(3, device="cpu")
    eng = get_engine(lambda s, d: (torch.zeros(s.shape[:-1]),
                                   torch.zeros(s.shape[:-1], dtype=torch.int32)),
                     device="cpu")
    assert eng.name == "callable"


def test_kernel_build_needs_nvcc(monkeypatch):
    """No nvcc, no kernel: the build raises instead of falling back."""
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()
    path = build.library_path("nn_search")
    assert path.parent == ROOT / "build" / "kernels"
    assert path.name.startswith("nn_search-") and path.suffix == ".so"


# -- copies kept in the port -------------------------------------------------

def test_scene_and_collate_copies_match_reference():
    cfg_kw = dict(n_ground=3000, n_walls=2100, n_poles=600, n_clutter=700,
                  extent=30.0, sensor_range=35.0)
    a = j_pointcloud.frame_pair(0, 2, j_pointcloud.SceneConfig(**cfg_kw), 256)
    b = t_pointcloud.frame_pair(0, 2, t_pointcloud.SceneConfig(**cfg_kw), 256)
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()
    scans_j = j_pointcloud.sequence_scans(
        3, 2, j_pointcloud.SceneConfig(**cfg_kw))
    scans_t = t_pointcloud.sequence_scans(
        3, 2, t_pointcloud.SceneConfig(**cfg_kw))
    assert all(x.tobytes() == y.tobytes() for x, y in zip(scans_j, scans_t))
    assert np.array_equal(j_pointcloud.gt_pose(1)(4), t_pointcloud.gt_pose(1)(4))
    assert t_collate.PAD_SENTINEL == j_collate.PAD_SENTINEL == 1e6
    assert t_collate.DEFAULT_BUCKETS == j_collate.DEFAULT_BUCKETS
    pairs = [(a[0], a[1]), (a[0][:100], a[1][:500])]
    cb_j, cb_t = j_collate.collate_pairs(pairs), t_collate.collate_pairs(pairs)
    for x, y in zip(cb_j, cb_t):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_kdtree_baseline_copy_matches_reference(small_scene):
    src, dst, _ = small_scene
    a = j_kdtree_icp(src, dst, 20, 1.0, 1e-5)
    b = kdtree_icp(src, dst, 20, 1.0, 1e-5)
    np.testing.assert_array_equal(a.T, b.T)
    assert (a.rmse, a.iterations) == (b.rmse, b.iterations)


# -- the package boundary ----------------------------------------------------

def test_import_leaves_jax_and_repro_out():
    code = ("import sys\n"
            "import repro_torch, repro_torch.core, repro_torch.kernels.ops\n"
            "import repro_torch.kernels.build, repro_torch.core.baseline\n"
            "import repro_torch.kernels.fused_icp, repro_torch.core.pyramid\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_never_import_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        bad = {r for r in _imported_roots(f) if r in ("jax", "jaxlib",
                                                      "repro")}
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"

