"""The port's CUDA kernels on the card, held to their plain versions.

Every test here is marked ``cuda`` and skips without a CUDA device: a CUDA
kernel has no CPU mode. This file imports no JAX, so it also runs on a
machine with only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: brute-force indices agree except on near-ties (plain scores of
the two candidates within 1e-3, the fp32 expanded-form noise at <= 60 m),
scores within 1e-3; exact ties go to the first index. The grid sweep, the
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
from repro_torch.kernels.nn_search import BLOCK_N, TILE_M, nn_search_kernel

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
