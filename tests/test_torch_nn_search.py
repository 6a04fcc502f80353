"""Port vs reference: the plain brute-force NN search and the kernel wrapper.

Inputs are seeded numpy. Sources sit a few centimetres from distinct targets
that lie metres apart, so every query has a unique nearest neighbour and
indices must agree exactly. d² tolerances: 1e-5 after the exact-d² epilogue
of ``core.nn_search``; 1e-3 for the kernel's expanded-form scores (fp32
cancellation of ||p||² + ||q||² - 2p·q within the 55 m sensor range).

On the CPU the kernel wrapper runs its plain version (``ref.blocked_argmin``);
``tests/test_torch_cuda.py`` holds the CUDA kernel to it on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.core.nn_search import nn_search as j_nn_search
from repro.kernels.ops import nn_search_pallas
from repro_torch.core.nn_search import nn_search
from repro_torch.data.collate import DEFAULT_BUCKETS
from repro_torch.kernels import ops, ref
from repro_torch.kernels.nn_search import (BLOCK_N, TILE_M,
                                           check_kernel_shapes,
                                           nn_search_kernel, num_splits)


def _rigid(rng, angle=0.3, shift=2.0):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, rng.uniform(-shift, shift, size=3)
    return T.astype(np.float32)


def _unique_nn_case(seed, n, m, scale=30.0, T=None):
    """dst uniform in ±scale (default: within 52 m of the origin, inside the
    scenes' 55 m sensor range); src = T⁻¹(dst[sel] + 2 cm noise), so T(src)
    lies next to a distinct target."""
    rng = np.random.default_rng(seed)
    dst = rng.uniform(-scale, scale, size=(m, 3)).astype(np.float32)
    sel = rng.choice(m, size=n, replace=False)
    near = dst[sel] + 0.02 * rng.normal(size=(n, 3))
    if T is not None:
        Ti = np.linalg.inv(T.astype(np.float64))
        near = near @ Ti[:3, :3].T + Ti[:3, 3]
    return near.astype(np.float32), dst, sel


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


# -- core.nn_search (the "torch" engine's searcher) -------------------------

@pytest.mark.parametrize("m,chunk", [(1000, 256), (1024, 256), (700, 2048)])
@pytest.mark.parametrize("masked", [False, True])
def test_nn_search_matches_reference(m, chunk, masked):
    """Chunk padding (M not a multiple of chunk), dst_valid masking and
    return_points against ``repro.core.nn_search``."""
    src, dst, sel = _unique_nn_case(m + chunk, 300, m)
    valid = None
    if masked:
        valid = np.ones(m, bool)
        valid[sel[::3]] = False  # hide a third of the true neighbours
    d2_j, idx_j, pts_j = j_nn_search(_j(src), _j(dst), chunk=chunk,
                                     dst_valid=_j(valid), return_points=True)
    d2_t, idx_t, pts_t = nn_search(_t(src), _t(dst), chunk=chunk,
                                   dst_valid=_t(valid), return_points=True)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), atol=1e-5)
    np.testing.assert_array_equal(pts_t.numpy(), np.asarray(pts_j))
    assert idx_t.dtype == torch.int32 and d2_t.dtype == torch.float32
    if masked:
        assert valid[idx_t.numpy()].all()
    else:
        np.testing.assert_array_equal(idx_t.numpy(), sel)


def test_nn_search_bf16_scores_match_reference():
    """bf16 score tiles on a metre lattice (well inside bf16's resolution
    there): the same winners as the reference, d² exact after the
    epilogue."""
    g = np.arange(-2.0, 3.0)
    dst = np.stack(np.meshgrid(g, g, g), -1).reshape(-1, 3).astype(np.float32)
    rng = np.random.default_rng(1)
    sel = rng.choice(len(dst), size=60, replace=False)
    src = (dst[sel] + rng.uniform(-0.1, 0.1, size=(60, 3))).astype(np.float32)
    d2_j, idx_j = j_nn_search(_j(src), _j(dst), chunk=32, score_dtype="bf16")
    d2_t, idx_t = nn_search(_t(src), _t(dst), chunk=32, score_dtype="bf16")
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(idx_t.numpy(), sel)
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), atol=1e-5)


def test_nn_search_batched_equals_per_frame():
    cases = [_unique_nn_case(s, 128, 500) for s in (5, 6)]
    src = _t(np.stack([c[0] for c in cases]))
    dst = _t(np.stack([c[1] for c in cases]))
    d2_b, idx_b = nn_search(src, dst, chunk=128)
    for i, (s, d, sel) in enumerate(cases):
        d2, idx = nn_search(_t(s), _t(d), chunk=128)
        np.testing.assert_array_equal(idx_b[i].numpy(), idx.numpy())
        np.testing.assert_array_equal(d2_b[i].numpy(), d2.numpy())
        np.testing.assert_array_equal(idx.numpy(), sel)


def test_nn_search_all_invalid_gives_inf():
    src = torch.zeros(4, 3)
    dst = torch.ones(10, 3)
    d2, idx = nn_search(src, dst, chunk=4, dst_valid=torch.zeros(10,
                                                                 dtype=bool))
    assert torch.isinf(d2).all() and (idx == 0).all()


# -- kernel wrapper (plain path on CPU) vs the Pallas kernel ----------------

@pytest.mark.parametrize("with_T", [False, True])
def test_kernel_wrapper_matches_pallas_interpret(with_T):
    """N=300, M=1000 (both ragged) against ``nn_search_pallas`` with
    bn=128, bm=256 in interpret mode."""
    T = _rigid(np.random.default_rng(2)) if with_T else None
    src, dst, sel = _unique_nn_case(3, 300, 1000, T=T)
    d2_j, idx_j = nn_search_pallas(_j(src), _j(dst), _j(T), bn=128, bm=256,
                                   interpret=True)
    d2_t, idx_t = ops.nn_search_cuda(_t(src), _t(dst), _t(T))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(idx_t.numpy(), sel)
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), atol=1e-3)
    assert (d2_t >= 0).all()


def test_kernel_wrapper_on_augmented_operands_matches_ref_blocked():
    """The wrapper's contract on pre-augmented (B, 8, N)/(B, 8, M) operands:
    unclamped scores equal to the plain blocked search, batched."""
    rng = np.random.default_rng(4)
    src = _t(rng.uniform(-10, 10, size=(2, 200, 3)).astype(np.float32))
    dst = _t(rng.uniform(-10, 10, size=(2, 1500, 3)).astype(np.float32))
    src_aug = ref.augment_source(src, pad_to=256)
    dst_aug = ref.augment_target(dst, pad_to=2048)
    assert src_aug.shape == (2, 8, 256) and dst_aug.shape == (2, 8, 2048)
    d2, idx = nn_search_kernel(src_aug, dst_aug)
    d2_r, idx_r = ref.nn_search_ref_blocked(src, dst, bn=BLOCK_N, bm=TILE_M)
    np.testing.assert_array_equal(idx[:, :200].numpy(), idx_r.numpy())
    np.testing.assert_allclose(d2[:, :200].clamp_min(0).numpy(),
                               d2_r.numpy(), atol=1e-4)
    d2_full, idx_full = ref.nn_search_ref(src, dst)
    np.testing.assert_array_equal(idx_full.numpy(), idx_r.numpy())
    d2_one, idx_one = nn_search_kernel(src_aug[1], dst_aug[1])  # unbatched
    np.testing.assert_array_equal(idx_one.numpy(), idx[1].numpy())


def test_duplicated_targets_resolve_to_first_index():
    """Exact ties across tiles: every copy scores the same, the earliest
    index wins, in the port's wrapper, its plain search and the reference."""
    rng = np.random.default_rng(5)
    base = rng.uniform(-20, 20, size=(700, 3)).astype(np.float32)
    dst = np.concatenate([base, base, base])  # copies 700 / 1400 apart
    src = (base[::7] + 0.01).astype(np.float32)
    _, idx_t = ops.nn_search_cuda(_t(src), _t(dst))
    _, idx_j = nn_search_pallas(_j(src), _j(dst), bn=128, bm=256,
                                interpret=True)
    _, idx_p = nn_search(_t(src), _t(dst), chunk=256)
    want = np.arange(0, 700, 7)
    np.testing.assert_array_equal(idx_t.numpy(), want)
    np.testing.assert_array_equal(np.asarray(idx_j), want)
    np.testing.assert_array_equal(idx_p.numpy(), want)


def test_padded_targets_never_win():
    """All real targets far away, padding near in index: the argmin still
    lands on a real point (the +1e30 bias of padded columns)."""
    src = torch.zeros(128, 3)
    dst = torch.full((100, 3), 50.0)  # padded to one 1024-column tile
    d2, idx = ops.nn_search_cuda(src, dst)
    assert (idx < 100).all()
    np.testing.assert_allclose(d2.numpy(), 7500.0, rtol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), 0)


def test_resident_nn_fn_matches_one_shot():
    src, dst, sel = _unique_nn_case(6, 200, 700, scale=10.0)
    nn_fn = ops.resident_nn_fn(_t(dst))
    d2_r, idx_r = nn_fn(_t(src))
    d2_o, idx_o = ops.nn_search_cuda(_t(src), _t(dst))
    np.testing.assert_array_equal(idx_r.numpy(), idx_o.numpy())
    np.testing.assert_array_equal(d2_r.numpy(), d2_o.numpy())
    np.testing.assert_array_equal(idx_r.numpy(), sel)


def test_augmentation_matches_reference():
    from repro.kernels import ref as j_ref
    rng = np.random.default_rng(7)
    src = rng.normal(size=(50, 3)).astype(np.float32)
    dst = rng.normal(size=(70, 3)).astype(np.float32)
    T = _rigid(rng)
    np.testing.assert_allclose(
        ref.augment_source(_t(src), _t(T), pad_to=64).numpy(),
        np.asarray(j_ref.augment_source(_j(src), _j(T), pad_to=64)),
        atol=1e-5)
    np.testing.assert_array_equal(
        ref.augment_target(_t(dst), pad_to=128).numpy(),
        np.asarray(j_ref.augment_target(_j(dst), pad_to=128)))


def test_wrapper_rejects_bad_operands():
    good = torch.zeros(1, 8, 128)
    with pytest.raises(TypeError):
        nn_search_kernel(good.double(), good)
    with pytest.raises(ValueError):
        nn_search_kernel(torch.zeros(1, 5, 128), good)
    with pytest.raises(ValueError):
        nn_search_kernel(good, torch.zeros(2, 8, 1024))
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no plain path
        nn_search_kernel(good.to("meta"), good.to("meta"))


def test_num_splits_fills_the_card():
    """One 4096-point frame gives 8 query blocks: the target axis is split
    so that the grid holds ~2 blocks per SM on 132 SMs (one wave). A batch
    of 8 fills the card by itself and is split into ranges of at most 16
    tiles; no range is shorter than 2 tiles."""
    assert num_splits(1, 4096, 32768, 132) == 33    # 264 blocks
    assert num_splits(8, 4096, 32768, 132) == 16    # 256 tiles / 16
    assert num_splits(1, 4096, 131072, 132) == 64   # 1024 tiles / 16
    assert num_splits(1, 3072, 20096, 132) == 44    # 6 query blocks
    assert num_splits(1, 4096, 2 * TILE_M, 132) == 1
    assert num_splits(1, 4096, TILE_M, 132) == 1    # never 0
    for b, n, m in [(1, 4096, 32768), (8, 4096, 32768), (1, 512, 1024)]:
        s = num_splits(b, n, m, 132)
        assert m // TILE_M // s >= 2


@pytest.mark.parametrize("n,m,ok", [
    (BLOCK_N, TILE_M, True), (3 * BLOCK_N, 7 * TILE_M, True),
    (BLOCK_N + 128, TILE_M, False), (BLOCK_N // 2, TILE_M, False),
    (BLOCK_N, TILE_M + 64, False), (BLOCK_N, TILE_M // 2, False)])
def test_kernel_shape_checks(n, m, ok):
    """N must be whole query tiles (``BLOCK_N``) and M whole target tiles
    (``TILE_M``) before the kernel is called."""
    src, dst = torch.zeros(2, 8, n), torch.zeros(2, 8, m)
    if ok:
        check_kernel_shapes(src, dst)
    else:
        with pytest.raises(ValueError, match="multiple"):
            check_kernel_shapes(src, dst)


def test_kernel_layout_checks():
    """Contiguous and 16-byte aligned: the target tiles are bulk copies."""
    src, dst = torch.zeros(1, 8, BLOCK_N), torch.zeros(1, 8, TILE_M)
    with pytest.raises(ValueError, match="contiguous"):
        check_kernel_shapes(src, torch.zeros(1, 8, 2 * TILE_M)[..., ::2])
    shifted = torch.zeros(8 * TILE_M + 1)[1:].view(1, 8, TILE_M)
    assert shifted.is_contiguous()
    with pytest.raises(ValueError, match="aligned"):
        check_kernel_shapes(src, shifted)


def test_engine_buckets_are_whole_target_tiles():
    """Every collate bucket is a whole number of target tiles, so a bucketed
    target reaches the kernel without more padding."""
    assert all(b % TILE_M == 0 for b in DEFAULT_BUCKETS)
    assert 4096 % BLOCK_N == 0  # the Table-I source sample
