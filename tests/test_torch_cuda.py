"""The port's CUDA kernels on the card, held to their plain versions.

Every test here is marked ``cuda`` and skips without a CUDA device: a CUDA
kernel has no CPU mode. This file imports no JAX, so it also runs on a
machine with only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the brute-force kernel gives its plain version's bits on the
constructed cases (duplicates, equal five-term scores, ragged batches); on
random clouds indices agree except on near-ties (plain scores of the two
candidates within 1e-3, the fp32 expanded-form noise at <= 60 m), scores
within 1e-3; exact ties go to the first index. The grid sweep, the
fused pass and the normals moment sweep keep the plain version's rounding
and summation order (no FMA contraction): slots, d², moment planes and
moment sums are bit-equal, and the fused planes with the bf16 prune are the
same bits as without.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ICPParams, get_engine
from repro_torch.kernels import ops, ref
from repro_torch.kernels.nn_search import (BLOCK_N, TILE_M,
                                           nn_search_kernel, num_splits)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _uniform(rng, shape, dev, scale=60.0):
    x = rng.uniform(-scale, scale, size=shape).astype(np.float32)
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("b,n,m", [(1, 300, 1000), (2, 4096, 20000),
                                   (3, 128, 1024)])
def test_kernel_matches_plain_on_card(cuda_device, b, n, m):
    rng = np.random.default_rng(n + m)
    src = _uniform(rng, (b, n, 3), cuda_device)
    dst = _uniform(rng, (b, m, 3), cuda_device)
    src_aug = ref.augment_source(src, pad_to=n + (-n) % BLOCK_N)
    dst_aug = ref.augment_target(dst, pad_to=m + (-m) % TILE_M)
    before = nn_search_kernel.launches
    d2_k, idx_k = nn_search_kernel(src_aug, dst_aug)
    torch.cuda.synchronize()
    assert nn_search_kernel.launches == before + 1
    d2_p, idx_p = ref.blocked_argmin(src_aug, dst_aug)
    assert (d2_k - d2_p).abs().max().item() <= 1e-3
    diff = idx_k != idx_p
    if diff.any():  # only near-ties may pick another index
        picked = dst_aug.gather(-1, idx_k.long()[:, None].expand(-1, 8, -1))
        s_k = (src_aug * picked).sum(1)
        assert (s_k - d2_p)[diff].abs().max().item() < 1e-3
    assert (idx_k[:, :n] < m).all()


def test_kernel_ties_go_to_first_index_on_card(cuda_device):
    rng = np.random.default_rng(1)
    base = rng.uniform(-20, 20, size=(3000, 3)).astype(np.float32)
    dst = torch.from_numpy(np.concatenate([base] * 4)).to(cuda_device)
    src = torch.from_numpy(base[::3] + 0.01).to(cuda_device)
    _, idx = ops.nn_search_cuda(src, dst)
    np.testing.assert_array_equal(idx.cpu().numpy(), np.arange(0, 3000, 3))


def _same_as_plain(src_aug, dst_aug):
    """Kernel result, asserted to be the plain version's bits."""
    d2_k, idx_k = nn_search_kernel(src_aug, dst_aug)
    torch.cuda.synchronize()
    d2_p, idx_p = ref.blocked_argmin(src_aug, dst_aug)
    assert torch.equal(idx_k, idx_p)
    assert torch.equal(d2_k, d2_p)
    return d2_k, idx_k


@pytest.mark.parametrize("gap", [1, 6, 130, 259, 4100])
def test_kernel_first_copy_wins_across_groups_tiles_splits(cuda_device, gap):
    """Each of 512 targets appears twice, ``gap`` columns apart: in one
    compare group (1), the next group (6), the next tile (130), the next
    split range (259: 512 queries over 16384 targets split into ranges of
    at most 256 columns) or a far one (4100). The rest are filler 500 m
    away. The first copy must win."""
    assert num_splits(1, BLOCK_N, 16384, 132) * 256 >= 16384
    rng = np.random.default_rng(gap)
    m, k = 16384, 512
    base = rng.uniform(-40, 40, (k, 3)).astype(np.float32)
    dst = rng.uniform(-40, 40, (m, 3)).astype(np.float32)
    dst[:, 2] += 500.0
    first = np.arange(k) * 16
    dst[first] = base
    dst[first + gap] = base
    src = torch.from_numpy(base + np.float32(0.01)).to(cuda_device)
    dst = torch.from_numpy(dst).to(cuda_device)
    src_aug = ref.augment_source(src, pad_to=BLOCK_N)[None]
    dst_aug = ref.augment_target(dst, pad_to=m)[None]
    _, idx = _same_as_plain(src_aug, dst_aug)
    np.testing.assert_array_equal(idx[0, :k].cpu().numpy(), first)


@pytest.mark.parametrize("gap", [1, 6, 130, 300])
def test_kernel_equal_final_scores_take_smaller_four_term_sum(cuda_device,
                                                              gap):
    """Two columns whose four-term sums differ (1 and 1 - 2^-20) but whose
    five-term scores round to the same 4097 once |p'|² = 4096 is added. The
    search runs on the four-term sum, so the later column, whose sum is
    smaller, wins, in the kernel and its plain version alike, with the
    five-term score's bits."""
    n, m = BLOCK_N, 4096
    src_aug = torch.zeros(1, 8, n, device=cuda_device)
    src_aug[0, 3] = 1.0
    src_aug[0, 4] = 4096.0
    dst_aug = torch.zeros(1, 8, m, device=cuda_device)
    dst_aug[0, 3] = 100.0
    dst_aug[0, 4] = 1.0
    a = 200
    dst_aug[0, 3, a] = 1.0
    dst_aug[0, 3, a + gap] = 1.0 - 2.0 ** -20
    assert float(torch.tensor(4096.0) + (1.0 - 2.0 ** -20)) == 4097.0
    d2, idx = _same_as_plain(src_aug, dst_aug)
    assert bool((idx == a + gap).all())
    assert bool((d2 == 4097.0).all())


def test_kernel_batch_of_8_with_ragged_m_on_card(cuda_device):
    rng = np.random.default_rng(8)
    src = _uniform(rng, (8, 1000, 3), cuda_device)
    dst = _uniform(rng, (8, 5001, 3), cuda_device)
    src_aug = ref.augment_source(src, pad_to=1000 + (-1000) % BLOCK_N)
    dst_aug = ref.augment_target(dst, pad_to=5001 + (-5001) % TILE_M)
    _, idx = _same_as_plain(src_aug, dst_aug)
    assert bool((idx[:, :1000] < 5001).all())


@pytest.mark.parametrize("m", [TILE_M, 2 * TILE_M, 40 * TILE_M])
def test_kernel_one_query_tile_on_card(cuda_device, m):
    """N = BLOCK_N exactly (one query tile), from one target tile (one
    split, no merge) to many; two calls give the same bits, so the merge
    counters are back at zero after each."""
    rng = np.random.default_rng(m)
    src_aug = ref.augment_source(_uniform(rng, (1, BLOCK_N, 3), cuda_device))
    dst_aug = ref.augment_target(_uniform(rng, (1, m, 3), cuda_device))
    d2, idx = _same_as_plain(src_aug, dst_aug)
    d2_2, idx_2 = nn_search_kernel(src_aug, dst_aug)
    assert torch.equal(idx_2, idx) and torch.equal(d2_2, d2)


def test_kernel_leaves_merge_state_empty_on_card(cuda_device):
    """A call that splits the target axis merges through per-query keys and
    per-tile tickets, and leaves them as it found them (keys all ones,
    tickets zero), so the next call needs no reset kernel."""
    from repro_torch.kernels import nn_search as nn_mod
    rng = np.random.default_rng(21)
    src_aug = ref.augment_source(_uniform(rng, (2, 2 * BLOCK_N, 3),
                                          cuda_device))
    dst_aug = ref.augment_target(_uniform(rng, (2, 64 * TILE_M, 3),
                                          cuda_device))
    props = torch.cuda.get_device_properties(cuda_device)
    assert num_splits(2, 2 * BLOCK_N, 64 * TILE_M,
                      props.multi_processor_count) > 1
    for _ in range(3):
        _same_as_plain(src_aug, dst_aug)
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    keys, tickets = nn_mod._merge_state[(cuda_device.index or 0, stream)]
    assert bool((keys == -1).all()) and bool((tickets == 0).all())


def test_kernel_engine_matches_torch_engine_on_card(cuda_device,
                                                    small_scene):
    src, dst, T_gt = small_scene
    params = ICPParams(max_iterations=30)
    before = nn_search_kernel.launches
    res_k = get_engine("cuda").register(src, dst, params)
    res_t = get_engine("torch").register(src, dst, params)
    assert nn_search_kernel.launches - before == int(res_k.iterations)
    np.testing.assert_allclose(res_k.T.cpu().numpy(), res_t.T.cpu().numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(res_k.T.cpu().numpy(), T_gt, atol=0.05)


# -- slice 2: the grid candidate sweep and the fused moment pass -------------

def _candidate_rows(rng, dev, n, ck, masked=0.3):
    q = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    cand = (q[:, None] + rng.normal(0, 1.0, (n, ck, 3))).astype(np.float32)
    cand[rng.uniform(size=(n, ck)) < masked] = 1e15
    cand[::9] = 1e15  # empty neighbourhoods
    return torch.from_numpy(q).to(dev), torch.from_numpy(cand).to(dev)


@pytest.mark.parametrize("n,ck", [(4096, 864), (3000, 50), (17, 3)])
def test_candidate_sweep_matches_plain_on_card(cuda_device, n, ck):
    from repro_torch.kernels.nn_search_grid import candidate_sweep_kernel
    q, cand = _candidate_rows(np.random.default_rng(n), cuda_device, n, ck)
    before = candidate_sweep_kernel.launches
    d2_k, slot_k = candidate_sweep_kernel(q, cand)
    torch.cuda.synchronize()
    assert candidate_sweep_kernel.launches == before + 1
    d2_p, slot_p = ref.candidate_sweep(q, cand)
    # The kernel keeps the plain rounding (no FMA): the same bits.
    assert torch.equal(slot_k, slot_p)
    assert torch.equal(d2_k, d2_p)


def test_candidate_sweep_first_slot_tie_on_card(cuda_device):
    from repro_torch.kernels.nn_search_grid import candidate_sweep_kernel
    rng = np.random.default_rng(3)
    base = rng.uniform(-3, 3, (40, 3)).astype(np.float32)
    cand = torch.from_numpy(np.concatenate([base] * 4)[None].repeat(
        40, 0)).to(cuda_device)                       # (40, 160, 3)
    q = torch.from_numpy(base + np.float32(0.01)).to(cuda_device)
    _, slot = candidate_sweep_kernel(q, cand)
    np.testing.assert_array_equal(slot.cpu().numpy(), np.arange(40))


@pytest.mark.parametrize("robust", ["none", "huber", "tukey"])
def test_fused_planes_match_plain_on_card(cuda_device, robust):
    from repro_torch.kernels.fused_icp import (fused_moment_sweep,
                                               moment_planes)
    rng = np.random.default_rng(7)
    q, cand = _candidate_rows(rng, cuda_device, 2 * 1500, 64)
    q, cand = q.view(2, 1500, 3), cand.view(2, 1500, 64, 3)
    sv = torch.from_numpy((rng.uniform(size=(2, 1500)) > 0.1).astype(
        np.float32)).to(cuda_device)
    kw = dict(gate=1.0, robust_kernel=robust, robust_scale=0.6)
    before = fused_moment_sweep.launches
    planes_k = moment_planes(q, cand, sv, **kw)
    torch.cuda.synchronize()
    assert fused_moment_sweep.launches == before + 1
    planes_p = ref.fused_moment_planes(q, cand, sv, **kw)
    assert planes_k.shape == (2, 18, 1500)
    torch.testing.assert_close(planes_k, planes_p, rtol=1e-6, atol=1e-6)
    empty = (cand == 1e15).all(-1).all(-1)             # (2, 1500)
    assert bool(empty.any())
    assert bool((planes_k.mT[empty] == 0).all())  # empty hoods weigh 0


def test_pyramid_engine_launch_counts_on_card(cuda_device, small_scene):
    from repro_torch.kernels.fused_icp import fused_moment_sweep
    from repro_torch.kernels.nn_search_grid import candidate_sweep_kernel
    src, dst, T_gt = small_scene
    eng = get_engine("pyramid")
    params = ICPParams(max_iterations=30)
    for fused in (False, True):
        counts = (nn_search_kernel, candidate_sweep_kernel,
                  fused_moment_sweep)
        before = [f.launches for f in counts]
        res = eng.register(src, dst, params._replace(fused=fused))
        got = [f.launches - b for f, b in zip(counts, before)]
        iters = int(res.iterations)
        assert got == [6, 0 if fused else iters, iters if fused else 0]
        np.testing.assert_allclose(res.T.cpu().numpy(), T_gt, atol=0.05)


def test_fused_cuda_engine_matches_unfused_on_card(cuda_device, small_scene):
    src, dst, _ = small_scene
    params = ICPParams(max_iterations=30)
    eng = get_engine("cuda")
    ru = eng.register(src, dst, params)
    rf = eng.register(src, dst, params._replace(fused=True))
    np.testing.assert_allclose(rf.T.cpu().numpy(), ru.T.cpu().numpy(),
                               atol=1e-3)


# -- slice 3: the normals moment sweep, the 45-plane pass and the prune ------

def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("n,ck", [(4096, 864), (3000, 50), (17, 3)])
def test_moment_sweep_matches_plain_on_card(cuda_device, n, ck):
    from repro_torch.kernels.normals import moment_sweep
    q, cand = _candidate_rows(np.random.default_rng(n + 1), cuda_device, n,
                              ck)
    before = moment_sweep.launches
    m_k = moment_sweep(q, cand, 1.0)
    torch.cuda.synchronize()
    assert moment_sweep.launches == before + 1
    m_p = ref.normal_moments(q, cand, 1.0)
    assert m_k.shape == (n, 10)
    assert torch.equal(_bits(m_k), _bits(m_p))  # same order, same bits
    assert torch.equal(_bits(moment_sweep(q, cand, 1.0)), _bits(m_k))
    assert bool((m_k[::9] == 0).all())  # empty neighbourhoods


@pytest.mark.parametrize("robust", ["none", "huber", "tukey"])
def test_fused_plane_planes_match_plain_on_card(cuda_device, robust):
    from repro_torch.kernels.fused_icp import moment_planes
    rng = np.random.default_rng(11)
    q, cand = _candidate_rows(rng, cuda_device, 2 * 1500, 64)
    q, cand = q.view(2, 1500, 3), cand.view(2, 1500, 64, 3)
    cn = torch.nn.functional.normalize(torch.randn(
        cand.shape, generator=torch.Generator().manual_seed(0)), dim=-1)
    cn = torch.where(cand == 1e15, 0.0, cn.to(cuda_device))
    sv = torch.ones(2, 1500, device=cuda_device)
    kw = dict(gate=1.0, robust_kernel=robust, robust_scale=0.6)
    planes_k = moment_planes(q, cand, sv, cn, **kw)
    torch.cuda.synchronize()
    planes_p = ref.fused_moment_planes(q, cand, sv, cn, **kw)
    assert planes_k.shape == (2, 45, 1500)
    assert torch.equal(_bits(planes_k), _bits(planes_p))


@pytest.mark.parametrize("plane", [False, True])
def test_fused_prune_is_bit_identical_on_card(cuda_device, plane):
    from repro_torch.kernels.fused_icp import moment_planes
    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.uniform(30, 60, (4096, 3)).astype(
        np.float32)).to(cuda_device)
    dirs = torch.nn.functional.normalize(torch.from_numpy(rng.normal(
        size=(4096, 96, 3)).astype(np.float32)), dim=-1).to(cuda_device)
    dist = torch.from_numpy(rng.uniform(0.9, 3.0, (4096, 96, 1)).astype(
        np.float32)).to(cuda_device)
    cand = q[:, None, :] + dist * dirs  # winners 0.9-1.0 m: near the gate
    cand[::13] = 1e15
    cn = torch.where(cand == 1e15, 0.0, dirs) if plane else None
    sv = torch.ones(4096, device=cuda_device)
    for robust in ("none", "huber", "tukey"):
        kw = dict(gate=1.0, robust_kernel=robust, robust_scale=1.2)
        off = moment_planes(q, cand, sv, cn, **kw)
        on = moment_planes(q, cand, sv, cn, prune=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(_bits(on), _bits(off))
        assert torch.equal(_bits(on), _bits(ref.fused_moment_planes(
            q, cand, sv, cn, prune=True, **kw)))
        assert float(off[0].sum()) > 100.0


def test_plane_cuda_engine_matches_torch_engine_on_card(cuda_device,
                                                       small_scene):
    from repro_torch.kernels.fused_icp import fused_moment_sweep
    src, dst, T_gt = small_scene
    params = ICPParams(max_iterations=30, minimizer="point_to_plane")
    before = nn_search_kernel.launches
    res_k = get_engine("cuda").register(src, dst, params)
    assert nn_search_kernel.launches - before == int(res_k.iterations)
    res_t = get_engine("torch").register(src, dst, params)
    np.testing.assert_allclose(res_k.T.cpu().numpy(), res_t.T.cpu().numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(res_k.T.cpu().numpy(), T_gt, atol=0.05)
    before = fused_moment_sweep.launches
    res_f = get_engine("cuda").register(src, dst,
                                        params._replace(fused=True))
    assert fused_moment_sweep.launches - before == int(res_f.iterations)
    np.testing.assert_allclose(res_f.T.cpu().numpy(), res_t.T.cpu().numpy(),
                               atol=1e-3)


def test_odometry_stream_on_card_matches_cpu(cuda_device):
    """A 5-frame small-scene stream through ``OdometryPipeline`` on the card
    (the default pyramid engine: its polish is the candidate-sweep kernel)
    against the same stream through the port on the CPU: poses within 1e-3,
    the same tiers; one sweep launch per polish iteration; two card runs
    the same bits."""
    from repro_torch.core.odometry import OdometryConfig, OdometryPipeline
    from repro_torch.data.pointcloud import SceneConfig, sequence_scans
    from repro_torch.data.submap import SubmapParams
    from repro_torch.kernels.nn_search_grid import candidate_sweep_kernel
    scene = SceneConfig(n_ground=800, n_walls=600, n_poles=150,
                        n_clutter=150, extent=15.0, sensor_range=20.0)
    cfg = OdometryConfig(scan_budget=1024, submap=SubmapParams(
        voxel_size=0.75, capacity=4096, dims=(64, 64, 24),
        evict_radius=20.0))
    scans = sequence_scans(2, 5, scene)
    cpu_poses, cpu_diags = OdometryPipeline(cfg, device="cpu").run(scans)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        before = candidate_sweep_kernel.launches
        poses, diags = OdometryPipeline(cfg, device=cuda_device).run(scans)
        torch.cuda.synchronize()
        runs.append((poses, diags, candidate_sweep_kernel.launches - before))
    (p1, d1, n1), (p2, d2, n2) = runs
    assert np.array_equal(p1, p2)
    assert [repr(tuple(d)) for d in d1] == [repr(tuple(d)) for d in d2]
    assert np.abs(p1 - cpu_poses).max() <= 1e-3
    tiers = [d.recovery_tier for d in d1]
    assert tiers == [d.recovery_tier for d in cpu_diags]
    assert tiers == [0] * 5  # one (primary) registration a frame
    assert n1 == n2 == sum(d.iterations for d in d1)


# -- slice 5: lane independence under the multi-stream service ---------------

FLEET = 8


def _fleet_lanes(dev, seqs=range(FLEET)):
    """Frame 0 of each sequence (default scene, ~30-37k points), padded to
    the service's 49,152-row staging capacity: (8, 49152, 3) and masks."""
    from repro_torch.data.collate import pad_cloud
    from repro_torch.data.pointcloud import sequence_scans
    staged = [pad_cloud(sequence_scans(s, 1)[0], 49152) for s in seqs]
    pts = torch.from_numpy(np.stack([p for p, _ in staged])).to(dev)
    valid = torch.from_numpy(np.stack([v for _, v in staged])).to(dev)
    return pts, valid


def _poses(rng, n):
    from repro_torch.core.transform import make_transform
    from repro_torch.core.transform import rotation_from_axis_angle as rot
    R = rot(torch.tensor([0.0, 0.0, 1.0]), torch.tensor(
        rng.uniform(-0.2, 0.2, n), dtype=torch.float32))
    t = torch.tensor(rng.uniform(-3, 3, (n, 3)), dtype=torch.float32)
    return make_transform(R, t)


@pytest.mark.parametrize("storage", ["fp32", "fp16"])
def test_batched_prepare_probe_fuse_lane_bits_on_card(cuda_device, storage):
    """The service's batched scrub + downsample, lattice probe and fuse over
    8 full-size lanes give each lane the bits of the standalone pipeline's
    one-lane calls (``prepare_frame``'s downsample, ``out_of_lattice_frac``
    on one frame, ``Submap.insert`` of the transformed scan), twice over so
    the second fuse meets a non-empty map."""
    from repro_torch.core.odometry import OdometryConfig, out_of_lattice_frac
    from repro_torch.core.transform import transform_points
    from repro_torch.data.submap import Submap, empty_state
    from repro_torch.serve.registration_service import (_fuse_batch,
                                                        _prepare_batch)
    cfg = OdometryConfig(scan_budget=16384)
    params = cfg.submap._replace(storage=storage)
    pts, valid = _fleet_lanes(cuda_device)
    src_b, sv_b, nv_b = _prepare_batch(pts, valid, cfg.scan_voxel,
                                       cfg.scan_budget)
    lanes = [_prepare_lane(pts[k], valid[k], cfg) for k in range(FLEET)]
    for k, (src, sv) in enumerate(lanes):
        assert torch.equal(src, src_b[k]) and torch.equal(sv, sv_b[k])
        assert int(sv.sum()) == int(nv_b[k])
    rng = np.random.default_rng(5)
    state_b = empty_state(params, cuda_device, batch=(FLEET,))
    maps = [Submap(params, device=cuda_device) for _ in range(FLEET)]
    accept = torch.ones(FLEET, dtype=torch.bool, device=cuda_device)
    for _ in range(2):
        pose_b = _poses(rng, FLEET).to(cuda_device)
        lat_b = out_of_lattice_frac(pose_b, src_b, sv_b, state_b[-1], params)
        state_b, occ_b, drop_b = _fuse_batch(state_b, src_b, sv_b, pose_b,
                                             accept, params)
        for k, (src, sv) in enumerate(lanes):
            lat = out_of_lattice_frac(pose_b[k], src, sv, maps[k].origin,
                                      params)
            assert torch.equal(lat, lat_b[k])
            maps[k].insert(transform_points(pose_b[k], src),
                           center=pose_b[k, :3, 3], valid=sv)
            for leaf, leaf_b in zip(maps[k].state, state_b):
                assert torch.equal(leaf, leaf_b[k]), (k, storage)
            assert maps[k].size == int(occ_b[k])
            assert maps[k].dropped_cells == int(drop_b[k]) == 0


def _prepare_lane(pts, valid, cfg):
    """``OdometryPipeline.prepare_frame``'s scrub and downsample of one
    staged scan."""
    from repro_torch.core.icp import scrub_nonfinite
    from repro_torch.data.voxelize import voxel_downsample
    pts, valid = scrub_nonfinite(pts, valid)
    return voxel_downsample(pts, cfg.scan_voxel, max_points=cfg.scan_budget,
                            valid=valid)


def test_nn_kernel_lane_bits_at_service_shape_on_card(cuda_device):
    """The NN kernel at the service's shape (B=8, 16,384 sources against
    24,576 map rows): each lane's d² and index bits are the same with the
    lanes permuted and with the other lanes replaced by sentinel lanes (the
    operands of idle and non-registering lanes)."""
    from repro_torch.data.collate import PAD_SENTINEL
    from repro_torch.kernels.ops import resident_nn_fn
    rng = np.random.default_rng(8)
    src = _uniform(rng, (FLEET, 16384, 3), cuda_device)
    dst = _uniform(rng, (FLEET, 24576, 3), cuda_device)
    d2, idx = resident_nn_fn(dst)(src)
    perm = [5, 2, 7, 0, 1, 6, 3, 4]
    d2_p, idx_p = resident_nn_fn(dst[perm])(src[perm])
    lone = torch.arange(FLEET, device=cuda_device) == 3
    d2_s, idx_s = resident_nn_fn(torch.where(lone[:, None, None], dst,
                                             PAD_SENTINEL))(
        torch.where(lone[:, None, None], src, PAD_SENTINEL))
    torch.cuda.synchronize()
    assert torch.equal(d2_p, d2[perm]) and torch.equal(idx_p, idx[perm])
    assert torch.equal(d2_s[3], d2[3]) and torch.equal(idx_s[3], idx[3])


def test_kabsch_lane_bits_on_card(cuda_device):
    """``estimate_rigid_transform`` over (8, 16384, 3): a lane's T is the
    same bits whatever the other lanes hold and wherever it sits."""
    from repro_torch.core.transform import estimate_rigid_transform
    rng = np.random.default_rng(9)
    src = _uniform(rng, (FLEET, 16384, 3), cuda_device)
    dst = src + _uniform(rng, (FLEET, 16384, 3), cuda_device, scale=0.3)
    w = torch.from_numpy(rng.uniform(0, 1, (FLEET, 16384)).astype(
        np.float32)).to(cuda_device)
    T = estimate_rigid_transform(src, dst, w)
    perm = [7, 6, 5, 4, 3, 2, 1, 0]
    T_p = estimate_rigid_transform(src[perm], dst[perm], w[perm])
    other = _uniform(rng, (FLEET, 16384, 3), cuda_device)
    keep = (torch.arange(FLEET, device=cuda_device) == 2)[:, None, None]
    T_o = estimate_rigid_transform(torch.where(keep, src, other),
                                   torch.where(keep, dst, other * 1.01),
                                   torch.where(keep[..., 0], w, 0.5))
    torch.cuda.synchronize()
    assert torch.equal(T_p, T[perm])
    assert torch.equal(T_o[2], T[2])


def test_service_matches_standalone_on_card(cuda_device):
    """A 3-stream small-scene fleet through the service on the card gives
    the bits of standalone ``OdometryPipeline(svc.stream_config)`` replays
    of its staged frames, poses and diagnostics; every registration
    launched the NN kernel."""
    from repro_torch.core.icp import ICPParams as Params
    from repro_torch.core.odometry import OdometryConfig, OdometryPipeline
    from repro_torch.data.pointcloud import SceneConfig, sequence_scans
    from repro_torch.data.submap import SubmapParams
    from repro_torch.serve import RegistrationService, ServiceConfig
    scene = SceneConfig(n_ground=300, n_walls=220, n_poles=60, n_clutter=70,
                        extent=12.0, sensor_range=16.0)
    odo = OdometryConfig(
        params=Params(max_iterations=6, chunk=512, robust_kernel="huber",
                      robust_scale=0.3),
        submap=SubmapParams(voxel_size=0.75, capacity=1024, dims=(48, 48, 16),
                            evict_radius=12.0),
        scan_budget=256, recovery=False)
    svc = RegistrationService(ServiceConfig(slots=4, scan_capacity=1024,
                                            odometry=odo), device=cuda_device)
    fleet = {f"veh{s}": sequence_scans(s, 5, scene) for s in range(3)}
    for sid in fleet:
        svc.admit(sid)
    out = {sid: [] for sid in fleet}
    before = nn_search_kernel.launches
    for f in range(5):
        for sid, scans in fleet.items():
            svc.submit(sid, scans[f])
        for sid, res in svc.step().items():
            out[sid].append(res)
    assert nn_search_kernel.launches - before >= 4  # frames 1-4 register
    for sid, scans in fleet.items():
        ref = OdometryPipeline(svc.stream_config, device=cuda_device)
        for f, scan in enumerate(scans):
            pose, diag = ref.process(*svc.stage_scan(scan))
            assert np.array_equal(pose, out[sid][f][0]), (sid, f)
            assert repr(tuple(diag)) == repr(tuple(out[sid][f][1])), (sid, f)


# -- slice 6: stream-sharded and point-sharded registration --------------------
# D > 1 blocks on one card: the mesh repeats cuda:0, as chip_smoke.py's
# phase 10 does.

def _small_service_config():
    from repro_torch.core.icp import ICPParams as Params
    from repro_torch.core.odometry import OdometryConfig
    from repro_torch.data.submap import SubmapParams
    return OdometryConfig(
        params=Params(max_iterations=6, chunk=512, robust_kernel="huber",
                      robust_scale=0.3),
        submap=SubmapParams(voxel_size=0.75, capacity=1024, dims=(48, 48, 16),
                            evict_radius=12.0),
        scan_budget=256, recovery=False)


def test_sharded_service_two_blocks_on_card(cuda_device):
    """A 3-stream small-scene fleet through the sharded service, two
    blocks of two lanes on one card: each stream gives the bits of its
    standalone ``OdometryPipeline(svc.stream_config)`` replay and of a
    one-block fleet of the same width; the fleet's NN launches are the
    blocks' loop steps (at least one a registering round)."""
    from repro_torch.core.odometry import OdometryPipeline
    from repro_torch.data.pointcloud import SceneConfig, sequence_scans
    from repro_torch.serve import RegistrationService, ServiceConfig
    scene = SceneConfig(n_ground=300, n_walls=220, n_poles=60, n_clutter=70,
                        extent=12.0, sensor_range=16.0)
    odo = _small_service_config()
    fleet = {f"veh{s}": sequence_scans(s, 5, scene) for s in range(3)}

    def drive(devices, slots, sids):
        svc = RegistrationService(
            ServiceConfig(slots=slots, scan_capacity=1024, odometry=odo,
                          devices=devices),
            device=[str(cuda_device)] * devices)
        for sid in sids:
            svc.admit(sid)
        out = {sid: [] for sid in sids}
        for f in range(5):
            for sid in sids:
                svc.submit(sid, fleet[sid][f])
            for sid, res in svc.step().items():
                out[sid].append(res)
        return svc, out

    before = nn_search_kernel.launches
    svc, out = drive(2, 4, list(fleet))
    assert nn_search_kernel.launches - before >= 4
    _, out1 = drive(1, 2, ["veh0", "veh2"])
    for sid, scans in fleet.items():
        ref = OdometryPipeline(svc.stream_config, device=cuda_device)
        for f, scan in enumerate(scans):
            pose, diag = ref.process(*svc.stage_scan(scan))
            assert np.array_equal(pose, out[sid][f][0]), (sid, f)
            assert repr(tuple(diag)) == repr(tuple(out[sid][f][1])), (sid, f)
            if sid in out1:
                assert np.array_equal(out1[sid][f][0], out[sid][f][0])


def test_sharded_slots_one_block_matches_slots_on_card(cuda_device):
    """``"sharded-slots"`` at D=1, L=4 runs the ``"slots"`` engine's calls
    at ``slots=4``: the same bits; at D=2 over one card each block gives
    its one-block bits."""
    from repro_torch.core.engine import ShardedSlotEngine, SlotEngine
    rng = np.random.default_rng(10)
    src = _uniform(rng, (8, 512, 3), cuda_device, scale=20.0)
    dst = src.repeat(1, 4, 1) + _uniform(rng, (8, 2048, 3), cuda_device,
                                        scale=0.2)
    T0 = torch.eye(4, device=cuda_device).repeat(8, 1, 1)
    T0[:, 0, 3] = torch.linspace(0.0, 0.5, 8, device=cuda_device)
    params = ICPParams(max_iterations=20)
    slots = SlotEngine(slots=4, device=cuda_device)
    one = ShardedSlotEngine(lanes_per_device=4, devices=[str(cuda_device)])
    two = ShardedSlotEngine(lanes_per_device=4,
                            devices=[str(cuda_device)] * 2)
    r2 = two.register_batch(src, dst, params, initial_transforms=T0)
    for blk in (slice(0, 4), slice(4, 8)):
        ra = slots.register_batch(src[blk], dst[blk], params,
                                  initial_transforms=T0[blk])
        rb = one.register_batch(src[blk], dst[blk], params,
                                initial_transforms=T0[blk])
        for a, b, c in zip(ra, rb, r2):
            assert torch.equal(a, b) and torch.equal(a, c[blk])


def test_distributed_nn_search_on_card_matches_one_kernel_call(cuda_device):
    """Four target shards on one card: d² and indices are the bits of one
    NN-kernel call over the whole target (each pair's score does not
    depend on the shard; the combine keeps the lower shard on ties)."""
    from repro_torch.core import distributed as dist
    rng = np.random.default_rng(11)
    src = _uniform(rng, (4096, 3), cuda_device)
    dst = _uniform(rng, (32768, 3), cuda_device)
    dst[100] = dst[30000]
    src[0] = dst[30000]
    mesh = dist.Mesh(np.array([str(cuda_device)] * 4, dtype=object),
                     ("model",))
    d2, idx = dist.distributed_nn_search(mesh, src, dst)
    d2_1, idx_1 = ops.nn_search_cuda(src, dst)
    torch.cuda.synchronize()
    assert torch.equal(d2, d2_1) and torch.equal(idx, idx_1)
    assert int(idx[0]) == 100
    # two copies a few micrometres apart, one per shard, both clamping to
    # d2 = 0: the kernel's four-term scores decide, as in one search
    pts = _uniform(rng, (4096, 3), cuda_device, scale=30.0)
    dup = torch.cat([pts + 3e-6, pts])
    two = dist.Mesh(np.array([str(cuda_device)] * 2, dtype=object),
                    ("model",))
    d2, idx = dist.distributed_nn_search(two, pts, dup)
    d2_1, idx_1 = ops.nn_search_cuda(pts, dup)
    torch.cuda.synchronize()
    assert torch.equal(d2, d2_1) and torch.equal(idx, idx_1)


# -- slice 7: the fused kernel's launch settings, resources, frame engine ----

@pytest.mark.parametrize("plane", [False, True])
def test_fused_settings_give_plain_bits_on_card(cuda_device, plane):
    """Every warps-per-block setting, prune on and off, both minimisers:
    the plain version's bits (a query's arithmetic does not depend on its
    block)."""
    from repro_torch.kernels.fused_icp import (WARPS_PER_BLOCK,
                                               fused_moment_sweep,
                                               moment_planes)
    rng = np.random.default_rng(21)
    q, cand = _candidate_rows(rng, cuda_device, 2 * 1001, 96)
    q, cand = q.view(2, 1001, 3), cand.view(2, 1001, 96, 3)
    cn = None
    if plane:
        cn = torch.nn.functional.normalize(torch.randn(
            cand.shape, generator=torch.Generator().manual_seed(1)), dim=-1)
        cn = torch.where(cand == 1e15, 0.0, cn.to(cuda_device))
    sv = torch.from_numpy((rng.uniform(size=(2, 1001)) > 0.1).astype(
        np.float32)).to(cuda_device)
    for robust in ("none", "huber"):
        kw = dict(gate=1.0, robust_kernel=robust, robust_scale=0.6)
        plain = ref.fused_moment_planes(q, cand, sv, cn, **kw)
        for warps in WARPS_PER_BLOCK:
            for prune in (False, True):
                before = fused_moment_sweep.launches
                got = moment_planes(q, cand, sv, cn, prune=prune,
                                    warps_per_block=warps, **kw)
                torch.cuda.synchronize()
                assert fused_moment_sweep.launches == before + 1
                assert torch.equal(_bits(got), _bits(plain)), (warps, prune)
    with pytest.raises(ValueError, match="warps_per_block"):
        moment_planes(q, cand, sv, cn, gate=1.0, warps_per_block=32)


def test_kernel_resources_on_card(cuda_device):
    from repro_torch.kernels.fused_icp import (DEFAULT_CONFIG, FusedConfig,
                                               fused_resources)
    from repro_torch.kernels.nn_search import smem_bytes
    nn = smem_bytes(cuda_device)
    card = nn["card"]
    assert card["registers"] > 0 and card["blocks_per_sm"] >= 1
    assert card["static_shared_bytes"] == nn["total"]
    assert card["max_threads_per_block"] >= nn["threads_per_block"]
    assert 0.0 < card["occupancy"] <= 1.0
    for warps in (2, 16):
        for plane in (False, True):
            res = fused_resources(FusedConfig(warps, True), plane=plane,
                                  device=cuda_device)
            c = res["card"]
            assert 0 < c["registers"] <= 255
            assert c["static_shared_bytes"] == res["static_shared_bytes"]
            assert c["max_threads_per_block"] >= res["threads_per_block"]
            assert c["blocks_per_sm"] >= 1 and 0.0 < c["occupancy"] <= 1.0
    assert fused_resources(DEFAULT_CONFIG,
                           device=cuda_device)["card"]["local_bytes"] == 0


def test_make_frame_engine_gives_kernel_bits_on_card(cuda_device):
    from repro_torch.kernels.nn_search import nn_search_kernel
    rng = np.random.default_rng(22)
    src = _uniform(rng, (2, 3000, 3), cuda_device, scale=30.0)
    dst = _uniform(rng, (2, 20001, 3), cuda_device, scale=30.0)
    T = torch.eye(4, device=cuda_device).repeat(2, 1, 1)
    T[:, :3, 3] = torch.tensor([0.5, -0.3, 0.1], device=cuda_device)
    nn_fn = ops.make_frame_engine(dst)
    before = nn_search_kernel.launches
    d2, idx = nn_fn(src, T)
    torch.cuda.synchronize()
    assert nn_search_kernel.launches == before + 1
    d2_1, idx_1 = ops.nn_search_cuda(src, dst, T)
    assert torch.equal(d2, d2_1) and torch.equal(idx, idx_1)


# -- slice 8: the LM serving path ---------------------------------------------

def test_smoke_lm_on_card_matches_cpu(cuda_device):
    """qwen2-0.5b's smoke config on the card against the same weights on the
    CPU: logits within 1e-2 (the reference's decode tolerance) with the
    argmax equal where the CPU's top-2 gap exceeds it; the card's greedy
    tokens are its own forward's teacher-forced argmax."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine
    cfg = get_smoke("qwen2-0.5b")
    tree = lm.init_params_numpy(cfg, seed=0)
    card = lm.params_from_reference(tree, cfg, cuda_device)
    cpu = lm.params_from_reference(tree, cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 40), dtype=np.int32))
    got, _ = lm.forward(card, cfg, tokens=toks.to(cuda_device))
    want, _ = lm.forward(cpu, cfg, tokens=toks)
    got = got.cpu()
    assert (got - want).abs().max().item() <= 1e-2
    top2 = want.topk(2, dim=-1).values
    decided = top2[..., 0] - top2[..., 1] > 1e-2
    assert torch.equal(got.argmax(-1)[decided], want.argmax(-1)[decided])
    out = Engine(cfg, card, max_len=40, device=cuda_device).generate(
        toks[:, :24], 16)
    logits, _ = lm.forward(card, cfg, tokens=torch.cat(
        [toks[:, :24].to(cuda_device), out], dim=1))
    assert torch.equal(logits[:, 23:-1].argmax(-1).to(torch.int32), out)


def test_vq_encode_3d_on_card_gives_plain_bits(cuda_device):
    from repro_torch.device import round_up
    from repro_torch.kernels.nn_search import nn_search_kernel
    from repro_torch.serve import modality
    book, lat = modality.stub_normals(5, (3000, 3), (2, 5000, 3),
                                      device=cuda_device)
    before = nn_search_kernel.launches
    codes, quant = modality.vq_encode(lat, book, use_kernel=True)
    torch.cuda.synchronize()
    assert nn_search_kernel.launches == before + 1
    flat = lat.reshape(-1, 3)
    _, idx = ref.blocked_argmin(
        ref.augment_source(flat, pad_to=round_up(len(flat), BLOCK_N)),
        ref.augment_target(book, pad_to=round_up(len(book), TILE_M)))
    assert torch.equal(codes, idx[:len(flat)].reshape(2, 5000))
    assert torch.equal(quant, book[codes.long()])


# -- slice 9: the recurrent block kinds --------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_recurrent_smoke_lm_on_card_matches_cpu(cuda_device, arch):
    """The arch's smoke config on the card against the same weights on the
    CPU: forward, prefill and four decode steps (past mamba2's 16-token
    chunk and recurrentgemma's 16-slot ring) with logits within three bf16
    ulps of the CPU's largest (the bar the CPU tests hold the port to the
    reference with), the argmax equal where the CPU's top-2 gap exceeds
    it, every decode state in the CPU's layout and dtypes; the card's
    greedy tokens are its own forward's teacher-forced argmax except on
    near-ties within that bar."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine
    cfg = get_smoke(arch)
    tree = lm.init_params_numpy(cfg, seed=0)
    card = lm.params_from_reference(tree, cfg, cuda_device)
    cpu = lm.params_from_reference(tree, cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 44), dtype=np.int32))

    def hold(got, want):
        got = got.cpu()
        tol = 3 * 2.0 ** -7 * want.abs().max().item()
        assert (got - want).abs().max().item() <= tol
        top2 = want.topk(2, dim=-1).values
        decided = top2[..., 0] - top2[..., 1] > tol
        assert torch.equal(got.argmax(-1)[decided], want.argmax(-1)[decided])
        return tol

    hold(lm.forward(card, cfg, tokens=toks.to(cuda_device))[0],
         lm.forward(cpu, cfg, tokens=toks)[0])
    got, gc = lm.prefill(card, cfg, tokens=toks[:, :40].to(cuda_device),
                         max_len=44)
    want, wc = lm.prefill(cpu, cfg, tokens=toks[:, :40], max_len=44)
    hold(got, want)
    for i in range(40, 44):
        got, gc = lm.decode_step(card, cfg, i, gc,
                                 token=toks[:, i].to(cuda_device))
        want, wc = lm.decode_step(cpu, cfg, i, wc, token=toks[:, i])
        tol = hold(got, want)
    for g, w in zip(gc, wc):
        g, w = (list(c.values()) if isinstance(c, dict) else c
                for c in (g, w))
        assert [(t.shape, t.dtype) for t in g] == [(t.shape, t.dtype)
                                                   for t in w]
    out = Engine(cfg, card, max_len=40, device=cuda_device).generate(
        toks[:, :24], 16)
    logits, _ = lm.forward(card, cfg, tokens=torch.cat(
        [toks[:, :24].to(cuda_device), out], dim=1))
    tf = logits[:, 23:-1]
    top2 = tf.topk(2, dim=-1).values
    off = tf.argmax(-1).to(torch.int32) != out
    assert bool(((top2[..., 0] - top2[..., 1])[off] <= tol).all())


def test_linear_scan_on_card_matches_sequential(cuda_device):
    """The RG-LRU's log-depth scan at S = 1024 on the card: the CPU's bits
    (one IEEE product or sum at a time, in the same tree) and within 32
    fp32 ulps of the largest h of the sequential recurrence."""
    from repro_torch.models import ssm
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.uniform(0.9, 0.999, (2, 1024, 256))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 1024, 256))
                         .astype(np.float32))
    ga, gb = ssm.linear_scan(a.to(cuda_device), b.to(cuda_device))
    ca, cb = ssm.linear_scan(a, b)
    assert torch.equal(ga.cpu(), ca) and torch.equal(gb.cpu(), cb)
    seq = ssm.linear_scan_naive(a.to(cuda_device), b.to(cuda_device))
    assert (gb - seq).abs().max().item() <= (32 * 2.0 ** -23
                                             * seq.abs().max().item())


# -- slice 10: MLA and the MoE FFN --------------------------------------------

@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-moe-16b",
                                  "qwen3-moe-235b-a22b"])
def test_mla_moe_smoke_lm_on_card_matches_cpu(cuda_device, arch):
    """The arch's smoke config on the card against the same weights on the
    CPU: forward (logits within 1e-2, the argmax equal where the CPU's
    top-2 gap exceeds it; the MoE aux within 2e-4 relative), prefill and
    four decode steps (MLA's absorbed decode on the latent cache), each
    cache in the CPU's layout and dtypes; the card's greedy tokens are its
    own forward's teacher-forced argmax except on near-ties within 1e-2."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine
    cfg = get_smoke(arch)
    tree = lm.init_params_numpy(cfg, seed=0)
    card = lm.params_from_reference(tree, cfg, cuda_device)
    cpu = lm.params_from_reference(tree, cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 44), dtype=np.int32))

    def hold(got, want, tol=1e-2):
        got = got.cpu()
        assert (got - want).abs().max().item() <= tol
        top2 = want.topk(2, dim=-1).values
        decided = top2[..., 0] - top2[..., 1] > tol
        assert torch.equal(got.argmax(-1)[decided], want.argmax(-1)[decided])

    got, got_aux = lm.forward(card, cfg, tokens=toks.to(cuda_device))
    want, want_aux = lm.forward(cpu, cfg, tokens=toks)
    hold(got, want)
    assert abs(got_aux.item() - want_aux.item()) <= 2e-4 * want_aux.item()
    got, gc = lm.prefill(card, cfg, tokens=toks[:, :40].to(cuda_device),
                         max_len=44)
    want, wc = lm.prefill(cpu, cfg, tokens=toks[:, :40], max_len=44)
    hold(got, want)
    for i in range(40, 44):
        got, gc = lm.decode_step(card, cfg, i, gc,
                                 token=toks[:, i].to(cuda_device))
        want, wc = lm.decode_step(cpu, cfg, i, wc, token=toks[:, i])
        hold(got, want)
    for g, w in zip(gc, wc):
        assert sorted(g) == sorted(w)
        assert [(g[k].shape, g[k].dtype) for k in sorted(g)] == [
            (w[k].shape, w[k].dtype) for k in sorted(w)]
        assert torch.equal(g["pos"].cpu(), w["pos"])
    out = Engine(cfg, card, max_len=40, device=cuda_device).generate(
        toks[:, :24], 16)
    logits, _ = lm.forward(card, cfg, tokens=torch.cat(
        [toks[:, :24].to(cuda_device), out], dim=1))
    tf = logits[:, 23:-1]
    top2 = tf.topk(2, dim=-1).values
    off = tf.argmax(-1).to(torch.int32) != out
    assert bool(((top2[..., 0] - top2[..., 1])[off] <= 1e-2).all())


def test_moe_routing_and_combine_on_card_give_cpu_bits(cuda_device):
    """Tied router probabilities take the lower expert first on the card
    (a stable sort), the capacity drops the same pairs, and the combine
    gives the CPU's bits (a fixed order of bf16 adds, no atomics)."""
    from repro_torch.models import moe
    cfg = moe.MoEConfig(d_model=64, n_experts=16, top_k=4, d_expert=32,
                        capacity_factor=0.75)
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.integers(0, 3, (512, 16)).astype(
        np.float32))
    w_card, i_card, _ = moe.route(logits.to(cuda_device), cfg)
    w_cpu, i_cpu, _ = moe.route(logits, cfg)
    assert torch.equal(i_card.cpu(), i_cpu)
    c = moe.capacity(512, cfg)
    got = moe.dispatch(i_card, c, cfg.n_experts)
    want = moe.dispatch(i_cpu, c, cfg.n_experts)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert not bool(want[-1].all())
    scale = torch.from_numpy(10.0 ** rng.integers(-3, 3, (512 * 4, 1)))
    rows = (torch.from_numpy(rng.standard_normal((512 * 4, 64))) * scale
            ).bfloat16()
    _, st_tok, se, _, _ = want
    out_cpu = moe.combine(rows, st_tok, se, 512, 16)
    out_card = moe.combine(rows.to(cuda_device), st_tok.to(cuda_device),
                           se.to(cuda_device), 512, 16)
    assert torch.equal(out_card.cpu(), out_cpu)


def test_moe_router_and_mla_decode_refuse_tf32_on_card(cuda_device):
    """The MoE router product and MLA's absorbed decode are fp32 products:
    on the card they raise while TF32 is on, rather than rank experts or
    scores on a 10-bit mantissa."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        for arch in ("deepseek-moe-16b", "minicpm3-4b"):
            cfg = get_smoke(arch)
            model = lm.init_params(cfg, 0, device=cuda_device)
            toks = torch.zeros((1, 4), dtype=torch.int32,
                               device=cuda_device)
            with pytest.raises(RuntimeError, match="IEEE fp32"):
                if arch == "minicpm3-4b":
                    _, cache = lm.prefill(model, cfg, tokens=toks,
                                          max_len=8)
                    lm.decode_step(model, cfg, 4, cache, token=toks[:, 0])
                else:
                    lm.forward(model, cfg, tokens=toks)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# -- slice 11: the training path ---------------------------------------------

def _train_smoke(arch, name, device, remat="none", steps=3):
    """``steps`` train steps of ``arch``'s smoke config from
    ``init_params_numpy(cfg, 0)`` on one seeded 2 x 32 batch: -> (losses,
    step 1's global gradient norm, every parameter and optimizer tensor
    on the host)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm
    from repro_torch.optim import (adafactor, adamw, clip_by_global_norm,
                                   cosine_schedule)
    from repro_torch.train import train_step as ts
    cfg = get_smoke(arch)
    opt = {"adamw": adamw, "adafactor": adafactor}[name](
        cosine_schedule(1e-3, 2, 50))
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (2, 33), dtype=np.int32)
    batch = {"labels": torch.from_numpy(toks[:, 1:]).to(device)}
    if cfg.embed_inputs:
        batch["tokens"] = torch.from_numpy(toks[:, :-1]).to(device)
    else:
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (2, 32, cfg.d_model)).astype(np.float32) * 0.1).to(device)
    state = ts.init_state(0, cfg, opt, device)
    step = ts.make_train_step(cfg, opt, remat=remat)
    losses, gnorm = [], None
    for i in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if i == 0:
            gnorm = float(clip_by_global_norm(
                {n: p.grad for n, p in state.params.named_parameters()},
                1.0)[1])
    tensors = {f"p:{n}": p.detach().cpu() for n, p in
               state.params.named_parameters()}
    tensors.update({f"g:{n}": p.grad.cpu() for n, p in
                    state.params.named_parameters()})
    inner = state.opt_state.inner
    for key, v in inner.items():
        for n, t in v.items():
            tensors[f"s:{key}:{n}"] = t.cpu()
    return losses, gnorm, tensors


def _same_bits(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k].view(torch.int32), b[k].view(torch.int32)), k


@pytest.mark.parametrize("arch,name", [
    ("qwen2-0.5b", "adamw"), ("mamba2-780m", "adamw"),
    ("recurrentgemma-9b", "adamw"), ("minicpm3-4b", "adamw"),
    ("deepseek-moe-16b", "adamw"), ("qwen3-moe-235b-a22b", "adafactor"),
    ("musicgen-medium", "adamw")])
def test_train_step_on_card_matches_cpu(cuda_device, arch, name):
    """Three steps of each block kind at smoke size: the losses within
    2e-3 and step 1's gradient norm within 2e-3 relative of the CPU
    path's (the CPU tests' bars against the reference); a second card run
    and ``remat="full"`` / ``"dots"`` give the same bits."""
    cpu = _train_smoke(arch, name, torch.device("cpu"))
    card = _train_smoke(arch, name, cuda_device)
    assert max(abs(a - b) for a, b in zip(cpu[0], card[0])) <= 2e-3
    assert abs(cpu[1] - card[1]) <= 2e-3 * cpu[1]
    _same_bits(card[2], _train_smoke(arch, name, cuda_device)[2])
    for remat in ("full", "dots"):
        _same_bits(card[2], _train_smoke(arch, name, cuda_device, remat)[2])


def test_checkpoint_resume_on_card_gives_uninterrupted_bits(cuda_device,
                                                            tmp_path):
    """Save after step 2 on the card, restore onto the abstract state on
    the card: step 3 gives the uninterrupted step 3's bits."""
    from repro_torch.configs import get_smoke
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import train_step as ts
    cfg = get_smoke("deepseek-moe-16b")
    opt = adamw(cosine_schedule(1e-3, 2, 50))
    step = ts.make_train_step(cfg, opt)
    rng = np.random.default_rng(5)
    batches = [{k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 16), dtype=np.int32)).to(cuda_device)
        for k in ("tokens", "labels")} for _ in range(3)]
    state = ts.init_state(0, cfg, opt, cuda_device)
    for i, b in enumerate(batches):
        state, _ = step(state, b)
        if i == 1:
            ckpt.save(tmp_path, state, step=2)
    restored, at, _ = ckpt.restore(tmp_path, ts.abstract_state(cfg, opt),
                                   device=cuda_device)
    assert at == 2
    resumed, _ = step(restored, batches[2])
    for (n, p), (_, q) in zip(state.params.named_parameters(),
                              resumed.params.named_parameters()):
        assert torch.equal(p, q), n
