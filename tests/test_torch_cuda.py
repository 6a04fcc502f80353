"""The port's CUDA kernel on the card, held to its plain version.

Every test here is marked ``cuda`` and skips without a CUDA device: a CUDA
kernel has no CPU mode. This file imports no JAX, so it also runs on a
machine with only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: indices agree except on near-ties (plain scores of the two
candidates within 1e-3, the fp32 expanded-form noise at <= 60 m), scores
within 1e-3; exact ties go to the first index.
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
