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
